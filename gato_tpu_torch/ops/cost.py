"""EE-tracking cost weights and the limit margin.

Port of gato_tpu/ops/cost.py (the contract only: the per-knot cost, its
gradient and its Hessian are evaluated by the channel traces in
ops/merit_fast.py and ops/kkt_fast.py). The reference narrows every joint,
velocity and torque limit by JOINT_LIMIT_MARGIN = 0.1.
"""

from __future__ import annotations

from dataclasses import astuple, dataclass

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
