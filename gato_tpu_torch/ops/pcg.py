"""Batched preconditioned conjugate gradient on block-tridiagonal systems.

Port of gato_tpu/ops/pcg.py with the semantics of the whole-solve kernel's
Krylov loop (gato_tpu/ops/pallas_pcg.py::pcg_channels, which the CUDA
kernel csrc/bsqp_iter.cu runs per thread block):
  - exit test |r^T z| < PCG_ABS_TOL + epsilon * |r0^T z0| (pcg.cuh:85-92),
  - the iteration counter increments before the check, and the converging
    iteration's lam/r updates are applied,
  - pAp == 0 and rho == 0 divide by 1 instead,
  - dot products clamp each knot's partial sum to 1e30 before the sum over
    knots, as pcg_channels' _dot does,
  - a lane whose warm-started residual r0 or preconditioned residual z0
    holds a non-finite entry does not iterate and reports max_iters (the
    reference's NaN exit test burns all its iterations),
  - skipped lanes (converged in an earlier SQP iteration) report 0.
Updates are selects on the active mask, so a frozen lane's values are never
touched by another lane's arithmetic.
"""

from __future__ import annotations

import torch

from .schur import btd_matvec

PCG_ABS_TOL = 1e-6  # pcg.cuh:26
DOT_CLAMP = 1e30


def _dot(a, b):
    part = (a * b).sum(-1)  # (B, N): one partial sum per knot
    part = torch.where(part.abs() <= DOT_CLAMP, part, DOT_CLAMP)
    return part.sum(-1)


def pcg_solve_batched(S_main, S_lower, P_main, P_lower, gamma, lam0,
                      epsilon, max_iters: int, skip):
    """S/P main (B,N,nx,nx), lower (B,N-1,nx,nx), gamma/lam0 (B,N,nx),
    epsilon (B,), skip (B,) bool. Returns (lam, iterations (B,) int32)."""
    r = gamma - btd_matvec(S_main, S_lower, lam0)
    z = btd_matvec(P_main, P_lower, r)
    p = z
    rho = _dot(r, z)
    rho_init = rho.abs()
    bad = ~(torch.isfinite(r).all((1, 2)) & torch.isfinite(z).all((1, 2)))
    dead0 = ~skip & bad
    active = ~skip & ~dead0 & (rho.abs() >= PCG_ABS_TOL)
    iters = torch.zeros(gamma.shape[0], dtype=torch.int32, device=gamma.device)
    lam = lam0

    it = 0
    while it < max_iters and bool(active.any()):
        iters = iters + active.to(torch.int32)
        Ap = btd_matvec(S_main, S_lower, p)
        pAp = _dot(p, Ap)
        alpha = rho / torch.where(pAp == 0, 1.0, pAp)
        a3 = active[:, None, None]
        lam = torch.where(a3, lam + alpha[:, None, None] * p, lam)
        r = torch.where(a3, r - alpha[:, None, None] * Ap, r)

        z = btd_matvec(P_main, P_lower, r)
        rho_new = _dot(r, z)
        converged = rho_new.abs() < (PCG_ABS_TOL + epsilon * rho_init)
        beta = rho_new / torch.where(rho == 0, 1.0, rho)
        keep = active & ~converged
        p = torch.where(keep[:, None, None], z + beta[:, None, None] * p, p)
        rho = torch.where(keep, rho_new, rho)
        active = keep
        it += 1
    iters = torch.where(dead0, max_iters, iters).to(torch.int32)
    return lam, iters
