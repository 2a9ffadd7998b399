"""L1 merit function over candidate steps x + alpha dz (array form).

Port of gato_tpu/ops/merit.py (the reference's merit.cuh:16-92) on the
rigid-body algorithms, batched over leading dimensions; the solver routes
evaluate the same merit through the channel trace (ops/merit_fast.py) or
the merit kernels.

merit(alpha) = sum_k cost_k(xu_k + alpha dz_k)
             + mu * [ sum_{k<N-1} |e_k|_1 + |x_0 + alpha dz_0 - x_s|_1 ]
with e_k the integrator defect at the stepped candidate (merit.cuh:67-83).
"""

from __future__ import annotations

import torch

from ..dynamics.algorithms import fd, fk, joint_transforms
from ..robots.model import RobotModel
from .cost import CostParams, barrier, effective_limits, knot_cost
from .integrators import integrate


def _knot_cost_and_defect(model, cp, x, u, x_next, ref6, f_ext, dt,
                          integrator_type):
    """A knot's cost and |defect|_1, the tracking cost's FK and the defect's
    forward dynamics sharing one set of joint transforms."""
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    E, r, R_link = joint_transforms(model, q)
    _, ps = fk(model, q, R_link=R_link)
    (jlo, jhi), (vlo, vhi), (clo, chi) = effective_limits(model)
    err = ps[..., -1, :] - ref6[..., :3]
    cost = 0.5 * cp.q_cost * (err * err).sum(-1)
    cost = cost + 0.5 * cp.qd_cost * (qd * qd).sum(-1)
    cost = cost + cp.q_lim_cost * barrier(q, jlo, jhi).sum(-1)
    cost = cost + cp.vel_lim_cost * barrier(qd, vlo, vhi).sum(-1)
    cost = cost + 0.5 * cp.u_cost * (u * u).sum(-1)
    cost = cost + cp.ctrl_lim_cost * barrier(u, clo, chi).sum(-1)
    qdd = fd(model, q, qd, u, f_ext=f_ext, transforms=(E, r))
    q_n, qd_n = integrate(q, qd, qdd, dt, integrator_type)
    return cost, (x_next - torch.cat([q_n, qd_n], -1)).abs().sum(-1)


def merit_value(model: RobotModel, cp: CostParams, X, U, x_s, ref, f_ext, mu,
                dt, integrator_type: int = 2):
    """X (..., N, nx), U (..., N-1, nu), x_s (..., nx), ref (..., N, >=3),
    f_ext (..., 6), mu (...) -> merit (...)."""
    costs, defects = _knot_cost_and_defect(
        model, cp, X[..., :-1, :], U, X[..., 1:, :], ref[..., :-1, :],
        f_ext[..., None, :], dt, integrator_type)
    cost_N = knot_cost(model, cp, X[..., -1, :], None, ref[..., -1, :], terminal=True)
    constraint = defects.sum(-1) + (X[..., 0, :] - x_s).abs().sum(-1)
    return costs.sum(-1) + cost_N + mu * constraint


def merit_alphas(model: RobotModel, cp: CostParams, X, U, dZX, dZU, x_s, ref,
                 f_ext, mu, dt, alphas, integrator_type: int = 2):
    """The merit at X + alpha dZX, U + alpha dZU for each alpha (A,):
    (..., A)."""
    a = alphas[:, None, None]

    def lift(t):
        return t[..., None, :]

    return merit_value(model, cp, X[..., None, :, :] + a * dZX[..., None, :, :],
                       U[..., None, :, :] + a * dZU[..., None, :, :], lift(x_s),
                       ref[..., None, :, :], lift(f_ext),
                       torch.as_tensor(mu, dtype=X.dtype, device=X.device)[..., None],
                       dt, integrator_type)


def default_alphas(num_alphas: int = 8, dtype=torch.float32, device="cpu"):
    """alpha_j = 2^-j (merit.cuh:40)."""
    return 0.5 ** torch.arange(num_alphas, dtype=dtype, device=device)
