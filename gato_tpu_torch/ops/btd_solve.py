"""Direct block-tridiagonal solve of the Schur dual system.

Port of gato_tpu/ops/btd_solve.py, batched over problems: a block-Thomas
factorisation, sequential over the knots, in place of PCG
(`linear_solver="btd"`). It gives exact duals where PCG stops at its
tolerance; the JAX package runs it outside any Pallas kernel, and so does
the port, on either device (solver/bsqp.py takes the staged route with it).

Factorisation (block LU without pivoting, upper blocks = lower^T):
  Dhat_0 = main_0
  L_k    = lower_{k-1} Dhat_{k-1}^-1
  Dhat_k = main_k - L_k lower_{k-1}^T
  ghat_k = gamma_k - L_k ghat_{k-1}
  lambda_{N-1} = Dhat_{N-1}^-1 ghat_{N-1}
  lambda_k     = Dhat_k^-1 (ghat_k - lower_k^T lambda_{k+1})
"""

from __future__ import annotations

import torch

from .pcg import PCG_ABS_TOL
from .schur import btd_matvec, mv


def _inv(M):
    """Batched inverse; inv_ex leaves a singular block non-finite instead of
    raising, and never waits on the device for the status."""
    return torch.linalg.inv_ex(M)[0]


def btd_solve(main, lower, gamma):
    """Solve the symmetric block-tridiagonal system: main (..., N, n, n),
    lower (..., N-1, n, n) at blocks (k+1, k), gamma (..., N, n)."""
    N = main.shape[-3]
    Dinv = [_inv(main[..., 0, :, :])]
    ghat = [gamma[..., 0, :]]
    for k in range(1, N):
        low = lower[..., k - 1, :, :]
        Lk = low @ Dinv[-1]
        Dinv.append(_inv(main[..., k, :, :] - Lk @ low.mT))
        ghat.append(gamma[..., k, :] - mv(Lk, ghat[-1]))
    lam = [None] * N
    lam[-1] = mv(Dinv[-1], ghat[-1])
    for k in reversed(range(N - 1)):
        lam[k] = mv(Dinv[k], ghat[k] - mv(lower[..., k, :, :].mT, lam[k + 1]))
    return torch.stack(lam, -2)


def btd_solve_batched(S_main, S_lower, gamma, lam_prev, skip):
    """The direct solve with PCG's bookkeeping: a problem whose warm-started
    duals already satisfy the system (|r^T r| below PCG's absolute
    tolerance, pcg.cuh:85-89) reports 0 iterations, the signal the SQP
    driver's convergence flags read, and skipped problems keep their duals.
    A non-finite warm-start residual counts as unsatisfied: the solve never
    reads lam_prev, so such a problem recovers.

    S_main (B, N, n, n), S_lower (B, N-1, n, n), gamma (B, N, n), lam_prev
    (B, N, n), skip (B,) bool. Returns (lam, iterations (B,) int32)."""
    r0 = gamma - btd_matvec(S_main, S_lower, lam_prev)
    rho0 = (r0 * r0).sum((-2, -1))
    active = ~skip & (~torch.isfinite(rho0) | (rho0.abs() >= PCG_ABS_TOL))
    lam = torch.where(active[:, None, None], btd_solve(S_main, S_lower, gamma), lam_prev)
    return lam, active.to(torch.int32)
