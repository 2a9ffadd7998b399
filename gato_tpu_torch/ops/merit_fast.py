"""Codegen-style merit sweep over (lane, alpha, knot) work items.

Port of gato_tpu/ops/merit_fast.py: the reference's computeMeritBatched
(merit.cuh:16-92) on the channelized dynamics trace. The per-knot body
`_knot_parts` is also what dynamics/codegen.py traces into the CUDA
`knot_merit` function.

The sum over knots follows the whole-solve kernel (pallas_solve.py
merit_channels + _segsum): each knot's term `cost + mu * penalty` is clamped
to 1e30 before the sum, so a diverged lane's merit stays finite and huge
and never wins a line search.
"""

from __future__ import annotations

import functools

import torch

from ..dynamics import mathshim as ms
from ..dynamics.channelized import ChannelizedDynamics, chadd
from ..robots.model import RobotModel, get_parsed
from .cost import LIMIT_MARGIN, CostParams

MERIT_CLAMP = 1e30


@functools.lru_cache(maxsize=None)
def _get_cd(key: str) -> ChannelizedDynamics:
    return ChannelizedDynamics(get_parsed(key))


def _limits(cd_key: str):
    p = get_parsed(cd_key)
    jl = (p.joint_limits[:, 0] + LIMIT_MARGIN, p.joint_limits[:, 1] - LIMIT_MARGIN)
    vl = (p.velocity_limits[:, 0] + LIMIT_MARGIN, p.velocity_limits[:, 1] - LIMIT_MARGIN)
    cl = (p.effort_limits[:, 0] + LIMIT_MARGIN, p.effort_limits[:, 1] - LIMIT_MARGIN)
    return jl, vl, cl


def _barrier_sum(xs, lo, hi):
    """Sum_i -log(clamp(x_i-lo_i) * clamp(hi_i-x_i)); limits python floats."""
    total = None
    for i, x in enumerate(xs):
        d1 = ms.maximum(x - float(lo[i]), 1e-10)
        d2 = ms.maximum(float(hi[i]) - x, 1e-10)
        total = chadd(total, -ms.log(d1 * d2))
    return total


def _sq_sum(xs):
    total = None
    for x in xs:
        total = chadd(total, x * x)
    return total


def _knot_parts(cd, key, cp: CostParams, q, qd, u, xn, r3, fe, dt,
                integrator_type, w_track):
    """Merit parts of one knot work item: (state cost with tracking weight
    w_track, control cost, L1 dynamics defect to xn). With u None (the
    terminal knot) only the state cost is computed."""
    (jlo, jhi), (vlo, vhi), (clo, chi) = _limits(key)
    cs = [ms.cos(x) for x in q]
    ss = [ms.sin(x) for x in q]

    p_ee, _, _ = cd.fk_ee(cs, ss)
    err = [p_ee[k] - r3[k] for k in range(3)]
    cost = 0.5 * w_track * _sq_sum(err)
    cost = cost + 0.5 * cp.qd_cost * _sq_sum(qd)
    cost = cost + cp.q_lim_cost * _barrier_sum(q, jlo, jhi)
    cost = cost + cp.vel_lim_cost * _barrier_sum(qd, vlo, vhi)
    if u is None:
        return cost
    ucost = (0.5 * cp.u_cost * _sq_sum(u)
             + cp.ctrl_lim_cost * _barrier_sum(u, clo, chi))

    qdd = cd.fd(cs, ss, qd, u, f_ext=fe)
    nq = cd.nq
    defect = None
    for i in range(nq):
        if integrator_type == 0:
            q_n = q[i] + dt * qd[i]
            qd_n = qd[i] + dt * qdd[i]
        elif integrator_type == 1:
            qd_n = qd[i] + dt * qdd[i]
            q_n = q[i] + dt * qd_n
        else:
            qd_n = qd[i] + dt * qdd[i]
            q_n = q[i] + dt * qd[i] + (0.5 * dt * dt) * qdd[i]
        defect = chadd(defect, ms.abs(xn[i] - q_n))
        defect = chadd(defect, ms.abs(xn[nq + i] - qd_n))
    return cost, ucost, defect


def _terminal_cost(cd, key, cp: CostParams, q, qd, r3):
    return _knot_parts(cd, key, cp, q, qd, None, None, r3, None, None, None,
                       cp.N_cost)


def merit_alphas_batched(model: RobotModel, cp: CostParams, X, U, dZX, dZU,
                         x_s, ref, f_ext, mu, dt, alphas,
                         integrator_type: int = 2):
    """Merit at X + alpha dZX for every (lane, alpha): returns (B, A).

    Shapes: X (B,N,nx), U (B,N-1,nu), x_s (B,nx), ref (B,N,>=3), f_ext
    (B,6), mu (B,); alphas a sequence of floats. An alpha of 0 evaluates
    X, U themselves (never X + 0 dZX, which a non-finite step would poison).
    """
    cd = _get_cd(model.key)
    nq = cd.nq
    B, N, nx = X.shape
    A = len(alphas)

    Xc = torch.stack([X if a == 0.0 else X + a * dZX for a in alphas], 1)
    Uc = torch.stack([U if a == 0.0 else U + a * dZU for a in alphas], 1)

    M = B * A * (N - 1)
    xk = Xc[:, :, :-1].reshape(M, nx)
    xn = Xc[:, :, 1:].reshape(M, nx)
    uk = Uc.reshape(M, nq)
    r3 = ref[:, None, :-1, :3].expand(B, A, N - 1, 3).reshape(M, 3)
    fe = f_ext[:, None, None, :].expand(B, A, N - 1, 6).reshape(M, 6)

    cost, ucost, defect = _knot_parts(
        cd, model.key, cp, [xk[:, i] for i in range(nq)],
        [xk[:, nq + i] for i in range(nq)], [uk[:, i] for i in range(nq)],
        [xn[:, i] for i in range(nx)], [r3[:, i] for i in range(3)],
        [fe[:, i] for i in range(6)], dt, integrator_type, cp.q_cost)

    xT = Xc[:, :, -1].reshape(B * A, nx)
    rT = ref[:, None, -1, :3].expand(B, A, 3).reshape(B * A, 3)
    costT = _terminal_cost(cd, model.key, cp, [xT[:, i] for i in range(nq)],
                           [xT[:, nq + i] for i in range(nq)],
                           [rT[:, i] for i in range(3)]).reshape(B, A, 1)

    # initial-state violation, charged at knot 0 (merit.cuh:74-83)
    init_viol = (Xc[:, :, 0] - x_s[:, None, :]).abs().sum(-1)
    pen = defect.reshape(B, A, N - 1)
    pen = torch.cat([pen[..., :1] + init_viol[..., None], pen[..., 1:]], -1)
    knots = (cost + ucost).reshape(B, A, N - 1) + mu[:, None, None] * pen
    terms = torch.cat([knots, costT], -1)
    terms = torch.where(terms.abs() <= MERIT_CLAMP, terms, MERIT_CLAMP)
    return terms.sum(-1)
