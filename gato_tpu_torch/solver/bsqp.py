"""Batched SQP (BSQP) solve.

Port of gato_tpu/solver/bsqp.py::solve_batched (the reference's
BSQP<T,B>::solve, gato/bsqp/bsqp.cuh:103-197) with the same return
contract. The route follows the device of the tensors: CUDA tensors go
through the hand-written kernel (one launch per SQP iteration,
ops/cuda_solve.py::sqp_iter_cuda); CPU tensors through its plain PyTorch
version (sqp_iter_reference). Both run under the same per-iteration loop
(sqp_solve_chained), which carries the reference's whole-batch solve_ratio
exit.
"""

from __future__ import annotations

import torch

from ..ops.cost import CostParams
from ..ops.cuda_solve import sqp_iter_cuda, sqp_iter_reference, sqp_solve_chained
from ..robots.model import RobotModel
from .types import BSQPSettings, HyperParams, SQPStats


def solve_batched(model: RobotModel, settings: BSQPSettings, cp: CostParams,
                  hp: HyperParams, X, U, lam, x_s, ref, f_ext, dt: float):
    """X (B,N,nx), U (B,N-1,nu), lam (B,N,nx) warm-started duals, x_s
    (B,nx), ref (B,N,6), f_ext (B,6) per-problem EE-frame wrench
    hypotheses, dt a float. Returns (X, U, lam, hp_out, stats)."""
    if settings.linear_solver != "pcg":
        raise NotImplementedError(
            f"linear_solver={settings.linear_solver!r}: only 'pcg' is ported "
            "(ROADMAP Queue 1, btd_solve)")
    iter_fn = sqp_iter_cuda if X.is_cuda else sqp_iter_reference
    (Xo, Uo, lam_o, rho_o, _drho, conv, merit0, merit_f, sqp_iters, pcg_it,
     ls_merit, ls_step) = sqp_solve_chained(
        iter_fn, model, cp, settings, X, U, lam, x_s, ref, f_ext, hp.rho,
        hp.drho, hp.mu, hp.pcg_tol, dt)
    # drho resets to its init after every solve (bsqp.cuh:189)
    hp_out = HyperParams(rho=rho_o, drho=hp.drho, mu=hp.mu, pcg_tol=hp.pcg_tol)
    sqp_iters = sqp_iters.to(torch.int32)
    stats = SQPStats(
        sqp_iters=sqp_iters, kkt_converged=conv.to(torch.int32),
        pcg_iters=pcg_it, ls_min_merit=ls_merit, ls_step_size=ls_step,
        initial_merit=merit0, final_merit=merit_f,
        num_iters_run=sqp_iters.max())
    return Xo, Uo, lam_o, hp_out, stats
