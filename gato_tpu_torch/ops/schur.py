"""Schur-complement condensation of the block-tridiagonal KKT system, the
symmetric-stair (SS) preconditioner, and primal step recovery.

Port of gato_tpu/ops/schur.py (gato/bsqp/kernels/schur_linsys.cuh), batched
over B problems. Math, for lambda ordered as one nx-block per knot (block 0
= initial-condition row, block k+1 = dynamics row k):

  Qr_k    = Q_k + rho * I~      (I~ adds rho ONLY to the first nq diagonal
                                 entries: the reference's addScaledIdentity
                                 quirk, linalg.cuh:84-96; R gets no rho)
  phi_k   = A_k Qr_k^-1
  theta_k = A_k Qr_k^-1 A_k^T + B_k R_k^-1 B_k^T + Qr_{k+1}^-1
  S       = blocktridiag(main_0 = -Qr_0^-1, main_{k+1} = -theta_k,
                         lower_{k+1,k} = phi_k, upper = lower^T)
  gamma_0     = c_0 - Qr_0^-1 q_0
  gamma_{k+1} = c_{k+1} + phi_k q_k + B_k R_k^-1 r_k - Qr_{k+1}^-1 q_{k+1}

  Preconditioner P^-1 (schur_linsys.cuh:150-164, 181-188, 213-260):
    main_0     = -Qr_0          (NOT its inverse: a preserved reference quirk)
    main_{k+1} = -(theta_k + rho * I~)^-1
    lower_{k+1,k} = -(main_{k+1} @ phi_k @ main_k),  upper = lower^T
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from .kkt import KKTSystem

RHO_INIT = 1e-3  # settings.h:18
RHO_FACTOR = 1.2  # settings.h:19
RHO_MIN = 1e-8  # settings.h:20
RHO_MAX = 10.0  # settings.h:21


@dataclass(frozen=True)
class SchurSystem:
    S_main: torch.Tensor  # (B, N, nx, nx)
    S_lower: torch.Tensor  # (B, N-1, nx, nx) block (k+1, k)
    gamma: torch.Tensor  # (B, N, nx)
    P_main: torch.Tensor  # (B, N, nx, nx)
    P_lower: torch.Tensor  # (B, N-1, nx, nx)
    Q_inv: torch.Tensor  # (B, N, nx, nx)
    R_inv: torch.Tensor  # (B, N-1, nu, nu)


def mv(a, x):
    """(..., m, n) @ (..., n) -> (..., m)."""
    return (a @ x.unsqueeze(-1)).squeeze(-1)


# spd_inv's inverse from the Cholesky factor: torch.cholesky_inverse, or
# within capturable_inverse() two triangular solves against the identity
_TRIANGULAR = [False]


@contextlib.contextmanager
def capturable_inverse():
    """Inside the block spd_inv inverts by two triangular solves against
    the identity (the JAX package's chol_inv form), which a CUDA graph can
    capture: on the card torch.cholesky_inverse of a batch takes MAGMA's
    batched potrs, which a graph cannot. The two forms round differently,
    so a graph captured within the block equals the eager cycles run within
    it (examples/mixed_fleet.py::device_cycle_time); outside, every route
    keeps cholesky_inverse."""
    taken = _TRIANGULAR[0]
    _TRIANGULAR[0] = True
    try:
        yield
    finally:
        _TRIANGULAR[0] = taken


def spd_inv(M):
    """Inverse of SPD blocks by Cholesky. A block that is not positive
    definite (a diverged problem) does not raise: its own inverse is
    meaningless, so it is NaN, as the JAX package's Cholesky gives it (the
    identity stands in for its factor, on which torch.cholesky_inverse
    raises on the CPU), and the other blocks keep theirs, so one problem
    cannot stop the batch."""
    L, info = torch.linalg.cholesky_ex(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    if not _TRIANGULAR[0]:
        failed = (info != 0)[..., None, None]
        return torch.where(failed, torch.nan, torch.cholesky_inverse(torch.where(failed, eye, L)))
    y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _halfdiag(n, nq, like):
    return torch.diag((torch.arange(n, device=like.device) < nq).to(like.dtype))


def build_schur(kkt: KKTSystem, rho, nq: int) -> SchurSystem:
    """rho: (B,) per-problem regularization."""
    Bsz, N, nx, _ = kkt.Q.shape
    rho4 = rho[:, None, None, None]
    I_half = _halfdiag(nx, nq, kkt.Q)

    # Q~ is block-diagonal: dense rank-2 + rho I qq block, diagonal qd block
    Q_inv = torch.zeros_like(kkt.Q)
    Q_inv[..., :nq, :nq] = spd_inv(
        kkt.Q[..., :nq, :nq] + rho4 * torch.eye(nq, dtype=kkt.Q.dtype,
                                               device=kkt.Q.device))
    Q_inv[..., nq:, nq:] = torch.diag_embed(
        1.0 / torch.diagonal(kkt.Q[..., nq:, nq:], dim1=-2, dim2=-1))
    R_inv = torch.diag_embed(1.0 / torch.diagonal(kkt.R, dim1=-2, dim2=-1))

    A, Bm = kkt.A, kkt.B
    phi = A @ Q_inv[:, :-1]
    BRinv = Bm @ R_inv
    theta = phi @ A.transpose(-1, -2) + BRinv @ Bm.transpose(-1, -2) + Q_inv[:, 1:]

    S_main = torch.cat([-Q_inv[:, :1], -theta], 1)
    g0 = kkt.c[:, 0] - mv(Q_inv[:, 0], kkt.q[:, 0])
    g_rest = (kkt.c[:, 1:] + mv(phi, kkt.q[:, :-1]) + mv(BRinv, kkt.r)
              - mv(Q_inv[:, 1:], kkt.q[:, 1:]))
    gamma = torch.cat([g0[:, None], g_rest], 1)

    Qr0 = kkt.Q[:, 0] + rho[:, None, None] * I_half
    P_main = torch.cat([-Qr0[:, None], -spd_inv(theta + rho4 * I_half)], 1)
    P_lower = -(P_main[:, 1:] @ phi @ P_main[:, :-1])
    return SchurSystem(S_main=S_main, S_lower=phi, gamma=gamma,
                       P_main=P_main, P_lower=P_lower, Q_inv=Q_inv,
                       R_inv=R_inv)


def btd_matvec(main, lower, x):
    """Symmetric block-tridiagonal mat-vec, batched: main (B,N,nx,nx),
    lower (B,N-1,nx,nx) at blocks (k+1, k), x (B,N,nx)."""
    y = mv(main, x)
    y[:, 1:] += mv(lower, x[:, :-1])
    y[:, :-1] += mv(lower.transpose(-1, -2), x[:, 1:])
    return y


def compute_dz(kkt: KKTSystem, schur: SchurSystem, lam):
    """Primal step from duals (schur_linsys.cuh:312-431):
      dz_x_k = -Qr_k^-1 (q_k - lambda_k + A_k^T lambda_{k+1})
      dz_u_k = -R_k^-1  (r_k + B_k^T lambda_{k+1})"""
    lam_next = lam[:, 1:]
    res_q = kkt.q - lam
    res_q[:, :-1] += mv(kkt.A.transpose(-1, -2), lam_next)
    dzx = -mv(schur.Q_inv, res_q)
    dzu = -mv(schur.R_inv, kkt.r + mv(kkt.B.transpose(-1, -2), lam_next))
    return dzx, dzu
