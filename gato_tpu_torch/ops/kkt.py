"""The KKT system: its container and the array setup (port of
gato_tpu/ops/kkt.py). The solver routes assemble it from the channel trace
(ops/kkt_fast.py) or the kkt kernel; `setup_kkt` is the JAX package's array
form on the rigid-body algorithms, batched over leading dimensions.

Conventions (setup_kkt.cuh:52-101), batched over B problems:
  c[0]   = x_0 - x_s                     (initial-state residual)
  c[k+1] = x_{k+1} - f(x_k, u_k)         (signed integrator defect)
  A_k, B_k: discrete dynamics Jacobians at knot k (k = 0..N-2)
  Q_k, q_k: cost Hessian/gradient at knots 0..N-1 (terminal uses N_cost)
  R_k, r_k: control cost at knots 0..N-2
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..robots.model import RobotModel
from .cost import CostParams, knot_cost_grad_hess
from .integrators import integrate, linearize


@dataclass(frozen=True)
class KKTSystem:
    Q: torch.Tensor  # (B, N, nx, nx)
    q: torch.Tensor  # (B, N, nx)
    R: torch.Tensor  # (B, N-1, nu, nu)
    r: torch.Tensor  # (B, N-1, nu)
    A: torch.Tensor  # (B, N-1, nx, nx)
    B: torch.Tensor  # (B, N-1, nx, nu)
    c: torch.Tensor  # (B, N, nx)


def setup_kkt(model: RobotModel, cp: CostParams, X, U, x_s, ref, f_ext, dt,
              integrator_type: int = 2) -> KKTSystem:
    """Linearise the dynamics and quadraticise the cost at every knot:
    X (..., N, nx), U (..., N-1, nu), x_s (..., nx), ref (..., N, >=3),
    f_ext (..., 6) EE-frame wrench -> KKTSystem with the same leading
    dimensions."""
    nq = model.nq
    x, xn = X[..., :-1, :], X[..., 1:, :]
    fe = f_ext[..., None, :]
    qdd, A, B = linearize(model, x, U, dt, f_ext=fe, integrator_type=integrator_type)
    q_n, qd_n = integrate(x[..., :nq], x[..., nq:], qdd, dt, integrator_type)
    defects = xn - torch.cat([q_n, qd_n], -1)
    Q, q, R, r = knot_cost_grad_hess(model, cp, x, U, ref[..., :-1, :], terminal=False)
    QN, qN, _, _ = knot_cost_grad_hess(model, cp, X[..., -1, :], None, ref[..., -1, :],
                                       terminal=True)
    c = torch.cat([(X[..., 0, :] - x_s)[..., None, :], defects], -2)
    return KKTSystem(Q=torch.cat([Q, QN[..., None, :, :]], -3),
                     q=torch.cat([q, qN[..., None, :]], -2), R=R, r=r, A=A, B=B, c=c)
