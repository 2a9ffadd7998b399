"""The KKT system container (port of the contract in gato_tpu/ops/kkt.py).

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


@dataclass(frozen=True)
class KKTSystem:
    Q: torch.Tensor  # (B, N, nx, nx)
    q: torch.Tensor  # (B, N, nx)
    R: torch.Tensor  # (B, N-1, nu, nu)
    r: torch.Tensor  # (B, N-1, nu)
    A: torch.Tensor  # (B, N-1, nx, nx)
    B: torch.Tensor  # (B, N-1, nx, nu)
    c: torch.Tensor  # (B, N, nx)
