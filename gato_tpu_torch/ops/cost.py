"""EE-tracking cost: weights, limit margin, log barriers, per-knot cost.

Port of gato_tpu/ops/cost.py. The solver routes evaluate the per-knot
cost, its gradient and its Hessian through the channel traces
(ops/merit_fast.py, ops/kkt_fast.py) and the kernels; `knot_cost` and
`knot_cost_grad_hess` here are the array forms on the rigid-body
algorithms, batched over leading dimensions, for the array KKT setup and
merit (ops/kkt.py, ops/merit.py). The reference narrows every joint,
velocity and torque limit by JOINT_LIMIT_MARGIN = 0.1.
"""

from __future__ import annotations

from dataclasses import astuple, dataclass

import torch

from ..dynamics.algorithms import ee_position, ee_position_and_jacobian
from ..dynamics.spatial import mtv
from ..robots.model import RobotModel

LIMIT_MARGIN = 0.1


@dataclass(frozen=True)
class CostParams:
    """The seven cost weights every reference kernel launch takes. Floats:
    they are the same for every problem of a batch."""

    q_cost: float = 2.0
    qd_cost: float = 1e-4
    u_cost: float = 1e-6
    N_cost: float = 50.0
    q_lim_cost: float = 1e-3
    vel_lim_cost: float = 0.0
    ctrl_lim_cost: float = 0.0

    def weights(self) -> tuple[float, ...]:
        """The weights in the order the CUDA kernels take them."""
        return astuple(self)


def effective_limits(model: RobotModel):
    """(lo, hi) tensor pairs for q, qd, u with the reference margin applied."""
    def pair(lim):
        return lim[:, 0] + LIMIT_MARGIN, lim[:, 1] - LIMIT_MARGIN

    return (pair(model.joint_limits), pair(model.velocity_limits),
            pair(model.effort_limits))


def barrier(x, lo, hi):
    """-log(x - lo) - log(hi - x), distances clamped at 1e-10
    (indy7_plant.cuh:130-138), as -log(d_min * d_max)."""
    return -torch.log(torch.clamp(x - lo, min=1e-10) * torch.clamp(hi - x, min=1e-10))


def barrier_grad(x, lo, hi):
    """d/dx barrier, distances clamped at 1e-6 (indy7_plant.cuh:140-148)."""
    return -1.0 / torch.clamp(x - lo, min=1e-6) + 1.0 / torch.clamp(hi - x, min=1e-6)


def knot_cost(model: RobotModel, cp: CostParams, x, u, ref6, terminal: bool):
    """One knot's tracking cost (indy7_plant.cuh:266-323), (...): x (..., nx),
    u (..., nu) (None at a terminal knot), ref6 (..., >=3). A terminal knot
    swaps q_cost for N_cost and drops the control terms."""
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    (jlo, jhi), (vlo, vhi), (clo, chi) = effective_limits(model)
    err = ee_position(model, q)[..., :3] - ref6[..., :3]
    w_track = cp.N_cost if terminal else cp.q_cost
    cost = 0.5 * w_track * (err * err).sum(-1)
    cost = cost + 0.5 * cp.qd_cost * (qd * qd).sum(-1)
    cost = cost + cp.q_lim_cost * barrier(q, jlo, jhi).sum(-1)
    cost = cost + cp.vel_lim_cost * barrier(qd, vlo, vhi).sum(-1)
    if not terminal:
        cost = cost + 0.5 * cp.u_cost * (u * u).sum(-1)
        cost = cost + cp.ctrl_lim_cost * barrier(u, clo, chi).sum(-1)
    return cost


def knot_cost_grad_hess(model: RobotModel, cp: CostParams, x, u, ref6,
                        terminal: bool):
    """Gradient and Hessian of one knot's cost: (Q (..., nx, nx), q (..., nx))
    and, off the terminal knot, (R (..., nu, nu), r (..., nu)); None, None
    at it. As trackingCostGradientAndHessian (indy7_plant.cuh:325-421),
    quirks included: the tracking Hessian is w g g^T with g = J^T (ee -
    ref), the weight applied once; the q barrier adds q_lim_cost bg bg^T to
    the whole qq block; the qd and u blocks are diagonal."""
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    (jlo, jhi), (vlo, vhi), (clo, chi) = effective_limits(model)
    ee, J = ee_position_and_jacobian(model, q)
    w_track = cp.N_cost if terminal else cp.q_cost
    g = mtv(J, ee - ref6[..., :3])
    bg_q = barrier_grad(q, jlo, jhi)
    bg_qd = barrier_grad(qd, vlo, vhi)
    qv = torch.cat([w_track * g + cp.q_lim_cost * bg_q,
                    cp.qd_cost * qd + cp.vel_lim_cost * bg_qd], -1)
    Qqq = (w_track * g[..., :, None] * g[..., None, :]
           + cp.q_lim_cost * bg_q[..., :, None] * bg_q[..., None, :])
    Qdd = torch.diag_embed(cp.qd_cost + cp.vel_lim_cost * bg_qd * bg_qd)
    zero = torch.zeros_like(Qqq)
    Q = torch.cat([torch.cat([Qqq, zero], -1), torch.cat([zero, Qdd], -1)], -2)
    if terminal:
        return Q, qv, None, None
    bg_u = barrier_grad(u, clo, chi)
    R = torch.diag_embed(cp.u_cost + cp.ctrl_lim_cost * bg_u * bg_u)
    return Q, qv, R, cp.u_cost * u + cp.ctrl_lim_cost * bg_u
