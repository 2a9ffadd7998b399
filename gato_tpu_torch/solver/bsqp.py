"""Batched SQP (BSQP) solve.

Port of gato_tpu/solver/bsqp.py::solve_batched (the reference's
BSQP<T,B>::solve, gato/bsqp/bsqp.cuh:103-197) with the same return
contract. `select_route` maps the settings' gates and the horizon to one of
three per-iteration routes (ops/cuda_solve.py):

  "solve"   the whole iteration in one kernel (bsqp_iter), N <= 128;
  "iter"    KKT + Schur + PCG + dz in one kernel (iter), then the merit
            kernel and the line search, N <= 128;
  "staged"  the kkt, pcg and merit kernels with the Schur condensation, dz
            and the line search in torch: every N the pcg kernel takes
            (N <= 1024), the only route past N = 128.

With linear_solver="btd" every N takes the staged route with the direct
block-tridiagonal solve (ops/btd_solve.py) in place of the pcg kernel
("btd"). Every route runs under the chained driver (sqp_solve_chained),
which carries the reference's whole-batch solve_ratio exit. On CPU tensors
each route runs the plain PyTorch versions of its kernels. With a `mesh`
(parallel/sharding.py) the solve is one rank's share of a batch split over
processes: the exit reads the global converged count.
"""

from __future__ import annotations

import torch

from ..ops.cost import CostParams
from ..ops.cuda_iter import MAX_KNOTS
from ..ops.cuda_solve import (sqp_iter_btd, sqp_iter_cuda, sqp_iter_fused,
                              sqp_iter_staged, sqp_solve_chained)
from ..ops.integrators import sim_step
from ..robots.model import RobotModel
from .types import KERNEL_GATES, BSQPSettings, HyperParams, SQPStats

ITER_FNS = {"solve": sqp_iter_cuda, "iter": sqp_iter_fused,
            "staged": sqp_iter_staged, "btd": sqp_iter_btd}
LINEAR_SOLVERS = ("pcg", "btd")


def select_route(solve_kernel: str, iter_kernel: str, N: int,
                 on_cuda: bool) -> str:
    """The route of one solve: "solve", "iter" or "staged".

    "auto" takes a fused kernel where its one-thread-per-knot block holds
    the horizon (N <= 128), solve before iter; "fused" forces it, and raises
    for a CUDA solve past N = 128; "off" skips it. Past N = 128 "auto" falls
    through to the staged route."""
    gates = (("solve", solve_kernel), ("iter", iter_kernel))
    for route, gate in gates:
        if gate not in KERNEL_GATES:
            raise ValueError(f"{route}_kernel={gate!r}: expected one of "
                             f"{KERNEL_GATES}")
    fits = N <= MAX_KNOTS
    for route, gate in gates:
        if gate == "fused" and on_cuda and not fits:
            raise ValueError(
                f"{route}_kernel='fused' at N={N}: the {route} kernel takes "
                f"N <= {MAX_KNOTS}; use {route}_kernel='auto' or 'off' (the "
                "staged route)")
        if gate == "fused" or (gate == "auto" and fits):
            return route
    return "staged"


def solve_batched(model: RobotModel, settings: BSQPSettings, cp: CostParams,
                  hp: HyperParams, X, U, lam, x_s, ref, f_ext, dt: float,
                  device_exit: bool = False, mesh=None):
    """X (B,N,nx), U (B,N-1,nu), lam (B,N,nx) warm-started duals, x_s
    (B,nx), ref (B,N,6), f_ext (B,6) per-problem EE-frame wrench
    hypotheses, dt a float. Returns (X, U, lam, hp_out, stats).
    device_exit=True keeps the whole-batch exit on the device (every
    iteration runs, those after the exit are discarded; equal bit for bit),
    so that a CUDA graph can hold the solve (api/rollout.py). `mesh` (a
    parallel/sharding.py Mesh) makes these B lanes one rank's share: the
    exit counts every rank's converged lanes and num_iters_run is the most
    over the ranks (gato_tpu/solver/bsqp.py:110-111, 281-289); None solves
    the B lanes alone."""
    if settings.linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"linear_solver={settings.linear_solver!r}: expected "
                         f"one of {LINEAR_SOLVERS}")
    route = ("btd" if settings.linear_solver == "btd" else
             select_route(settings.solve_kernel, settings.iter_kernel,
                          X.shape[1], X.is_cuda))
    (Xo, Uo, lam_o, rho_o, _drho, conv, merit0, merit_f, sqp_iters, pcg_it,
     ls_merit, ls_step) = sqp_solve_chained(
        ITER_FNS[route], model, cp, settings, X, U, lam, x_s, ref, f_ext,
        hp.rho, hp.drho, hp.mu, hp.pcg_tol, dt, device_exit=device_exit, mesh=mesh)
    # drho resets to its init after every solve (bsqp.cuh:189)
    hp_out = HyperParams(rho=rho_o, drho=hp.drho, mu=hp.mu, pcg_tol=hp.pcg_tol)
    sqp_iters = sqp_iters.to(torch.int32)
    iters_run = sqp_iters.max()
    if mesh is not None:
        iters_run = mesh.all_reduce(iters_run, "max")
    stats = SQPStats(
        sqp_iters=sqp_iters, kkt_converged=conv.to(torch.int32),
        pcg_iters=pcg_it, ls_min_merit=ls_merit, ls_step_size=ls_step,
        initial_merit=merit0, final_merit=merit_f,
        num_iters_run=iters_run)
    return Xo, Uo, lam_o, hp_out, stats


# the JAX package's jitted entry point; one function here
solve_batched_jit = solve_batched


def sim_forward_batched(model: RobotModel, x, u, f_ext_B, dt,
                        integrator_type: int = 2):
    """One dynamics step of a shared state x (nx,) under control u (nu,)
    for each problem's EE-frame wrench hypothesis f_ext_B (B, 6), in one
    batched call: (B, nx). The force estimator's scoring step (the
    reference's simForwardBatched, gato/bsqp/kernels/sim.cuh:14-86)."""
    B = f_ext_B.shape[0]
    return sim_step(model, x.expand(B, -1), u.expand(B, -1), dt, f_ext_B,
                    integrator_type)
