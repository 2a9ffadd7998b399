"""Explicit integrators, defects and the analytic linearisation (A, B).

Port of gato_tpu/ops/integrators.py (the reference's
gato/dynamics/integrator.cuh:20-257) on the rigid-body algorithms, batched
over leading dimensions: x (..., nx), u (..., nu), f_ext (..., 6) or None.
Integrator types as in the reference: 0 Euler, 1 semi-implicit Euler, 2
trapezoidal (the default everywhere). ANGLE_WRAP is there for parity and
off by default, as in the reference.
"""

from __future__ import annotations

import torch

from ..dynamics.algorithms import fd, fd_and_grad
from ..robots.model import RobotModel


def _angle_wrap(q):
    """The reference's angle_wrap (integrator.cuh:11-18), pi cut to 3.14159."""
    pi = 3.14159
    q = torch.where(q > pi, -(q - pi), q)
    return torch.where(q < -pi, -(q + pi), q)


def integrate(q, qd, qdd, dt, integrator_type: int = 2, angle_wrap: bool = False):
    """One explicit step (integrator.cuh:20-45): (q_next, qd_next)."""
    if integrator_type == 0:
        q_next, qd_next = q + dt * qd, qd + dt * qdd
    elif integrator_type == 1:
        qd_next = qd + dt * qdd
        q_next = q + dt * qd_next
    elif integrator_type == 2:
        qd_next = qd + dt * qdd
        q_next = q + dt * qd + 0.5 * qdd * dt * dt
    else:
        raise ValueError(f"unknown integrator type {integrator_type}")
    if angle_wrap:
        q_next = _angle_wrap(q_next)
    return q_next, qd_next


def sim_step(model: RobotModel, x, u, dt, f_ext=None, integrator_type: int = 2):
    """Forward-dynamics step x_{k+1} = f(x_k, u_k) (integrator.cuh:190-209)."""
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    q_n, qd_n = integrate(q, qd, fd(model, q, qd, u, f_ext=f_ext), dt, integrator_type)
    return torch.cat([q_n, qd_n], -1)


def defect(model: RobotModel, x, u, x_next, dt, f_ext=None, integrator_type: int = 2):
    """Signed integrator defect e_k = x_{k+1} - f(x_k, u_k)
    (integrator.cuh:48-62 with ABSVAL false, the KKT's c vector)."""
    return x_next - sim_step(model, x, u, dt, f_ext, integrator_type)


def linearize(model: RobotModel, x, u, dt, f_ext=None, integrator_type: int = 2):
    """qdd (..., nq) and the discrete dynamics Jacobians A = dx'/dx
    (..., nx, nx), B = dx'/du (..., nx, nu) (integrator_gradient_inner,
    integrator.cuh:65-188); for the trapezoidal default
      A = [[I + dt^2/2 dqdd_dq,  dt I + dt^2/2 dqdd_dqd],
           [dt dqdd_dq,          I + dt dqdd_dqd       ]]
      B = [[dt^2/2 dqdd_du], [dt dqdd_du]]."""
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    qdd, dq, dqd, dtau = fd_and_grad(model, q, qd, u, f_ext=f_ext)
    eye = torch.eye(nq, dtype=x.dtype, device=x.device).expand(dq.shape)
    if integrator_type == 0:
        a11, a12, b1 = eye, dt * eye, torch.zeros_like(dtau)
    elif integrator_type == 1:
        a11, a12, b1 = eye + dt * dt * dq, dt * eye + dt * dt * dqd, dt * dt * dtau
    elif integrator_type == 2:
        h = 0.5 * dt * dt
        a11, a12, b1 = eye + h * dq, dt * eye + h * dqd, h * dtau
    else:
        raise ValueError(f"unknown integrator type {integrator_type}")
    A = torch.cat([torch.cat([a11, a12], -1),
                   torch.cat([dt * dq, eye + dt * dqd], -1)], -2)
    return qdd, A, torch.cat([b1, dt * dtau], -2)
