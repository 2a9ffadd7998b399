"""The batched SQP solve, one SQP iteration at a time, on three routes.

Port of gato_tpu/ops/pallas_solve.py in its chained form
(sqp_solve_pallas_chained) and of the staged body of
gato_tpu/solver/bsqp.py::solve_batched. One SQP iteration is

  sqp_iter_reference  the plain PyTorch version of one launch of the TPU
                      `_solve_kernel` in chained mode: KKT setup, Schur
                      condensation, PCG, dz recovery, step_ok scrub, merit
                      at alpha in {0, 2^-j}, line search and rho schedule;
  sqp_iter_cuda       the whole iteration in one kernel: csrc/bsqp_iter.cu
                      on a CUDA tensor, the plain version on a CPU tensor;
  sqp_iter_fused      KKT + Schur + PCG + dz in one kernel (csrc/iter.cu),
                      then the step_ok scrub, the merit kernel
                      (csrc/merit.cu) and the line search in torch;
  sqp_iter_staged     the KKT kernel (csrc/kkt.cu), the Schur condensation
                      in torch, the PCG kernel (csrc/pcg.cu), dz in torch,
                      the step_ok scrub, the merit kernel and the line
                      search: the reference GATO's launch sequence;
  sqp_iter_btd        sqp_iter_staged with the direct block-tridiagonal
                      solve (ops/btd_solve.py, torch) in place of the pcg
                      kernel: linear_solver="btd".

The kernel wrappers take their plain versions on CPU tensors, so every
route runs in plain PyTorch on the CPU. All run under

  sqp_solve_chained   the per-iteration loop: the whole-batch solve_ratio
                      exit is decided between iterations, and the exiting
                      iteration's line-search effects are reverted (the
                      reference breaks after PCG/dz, before the merit
                      kernel: bsqp.cuh:133-165). With device_exit=True the
                      exit stays on the device (the JAX package's
                      lax.while_loop): every iteration runs and those after
                      the exit are discarded, so a CUDA graph can hold the
                      solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..robots.model import RobotModel
from ..solver.types import BSQPSettings
from .btd_solve import btd_solve_batched
from .cost import CostParams
from .cuda_iter import launch_iteration, sqp_iter_core_cuda
from .cuda_kkt import setup_kkt_batched_cuda
from .cuda_merit import merit_alphas_batched_cuda
from .cuda_pcg import pcg_solve_batched_cuda
from .cuda_sim import check_cuda, require_cuda_robot
from .kkt_fast import setup_kkt_batched
from .linesearch import line_search_update
from .merit_fast import merit_alphas_batched
from .pcg import pcg_solve_batched
from .schur import build_schur, compute_dz


class Problem(NamedTuple):
    """What stays fixed over one solve: x_s (B,nx), ref (B,N,>=3), f_ext
    (B,6), mu and pcg_tol (B,), dt."""

    x_s: torch.Tensor
    ref: torch.Tensor
    f_ext: torch.Tensor
    mu: torch.Tensor
    pcg_tol: torch.Tensor
    dt: float


class IterState(NamedTuple):
    """What one iteration hands the next: the trajectory, duals and rho
    schedule, the baseline merit (mbase) and warm-start merit (merit0), and
    per-problem flags as floats: conv (1 once PCG needed 0 iterations) and
    sqp (iterations counted until convergence)."""

    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    rho: torch.Tensor
    drho: torch.Tensor
    mbase: torch.Tensor
    merit0: torch.Tensor
    conv: torch.Tensor
    sqp: torch.Tensor


class IterStats(NamedTuple):
    pcg_iters: torch.Tensor  # (B,) int32
    ls_merit: torch.Tensor  # (B,)
    ls_step: torch.Tensor  # (B,) accepted alpha, or -1


def _line_search(merit_fn, model: RobotModel, cp: CostParams,
                 prob: Problem, st: IterState, settings: BSQPSettings,
                 seeded: bool, dzx, dzu, lam, pcg_it):
    """The tail of one iteration after dz: the step_ok scrub, the
    convergence flags, the merit sweep (merit_fn) at alpha in {0, 2^-j}, the
    line search and the rho schedule."""
    X, U = st.X, st.U
    # a diverged step is zeroed for the whole problem: every candidate then
    # equals X and the line search fails with the trajectory untouched
    step_ok = (torch.isfinite(dzx).all((1, 2))
               & torch.isfinite(dzu).all((1, 2)))[:, None, None]
    dzx = torch.where(step_ok, dzx, 0.0)
    dzu = torch.where(step_ok, dzu, 0.0)

    sqp = torch.where(st.conv > 0.5, st.sqp, st.sqp + 1.0)
    conv = torch.maximum(st.conv, (pcg_it == 0).to(X.dtype))

    # alpha = 0 (the baseline: the merit of X itself), then 2^-j (merit.cuh:40)
    alphas = [0.0] + [0.5 ** j for j in range(settings.num_alphas)]
    merits = merit_fn(model, cp, X, U, dzx, dzu, prob.x_s, prob.ref,
                      prob.f_ext, prob.mu, prob.dt, alphas,
                      settings.integrator_type)
    if seeded:
        mbase, merit0 = st.mbase, st.merit0
    else:
        mbase = merit0 = merits[:, 0]
    # 2^-j built on the device, exactly (no host-to-device copy)
    steps = 1.0 / torch.pow(2, torch.arange(settings.num_alphas,
                                            device=X.device)).to(X.dtype)
    X, U, m_n, step, rho, drho = line_search_update(
        merits[:, 1:], mbase, steps, X, U, dzx, dzu, st.rho, st.drho,
        settings.adapt_rho)
    return (IterState(X, U, lam, rho, drho, m_n, merit0, conv, sqp),
            IterStats(pcg_it, m_n, step))


def _staged(kkt_fn, pcg_fn, merit_fn, model, cp, prob, st, settings, seeded):
    kkt = kkt_fn(model, cp, st.X, st.U, prob.x_s, prob.ref, prob.f_ext,
                 prob.dt, settings.integrator_type)
    schur = build_schur(kkt, st.rho, model.nq)
    lam, pcg_it = pcg_fn(
        schur.S_main, schur.S_lower, schur.P_main, schur.P_lower, schur.gamma,
        st.lam, prob.pcg_tol, settings.max_pcg_iters, skip=st.conv > 0.5)
    dzx, dzu = compute_dz(kkt, schur, lam)
    return _line_search(merit_fn, model, cp, prob, st, settings, seeded, dzx,
                        dzu, lam, pcg_it)


def sqp_iter_reference(model: RobotModel, cp: CostParams, prob: Problem,
                       st: IterState, settings: BSQPSettings,
                       seeded: bool) -> tuple[IterState, IterStats]:
    """One SQP iteration in plain PyTorch, any device. `seeded` False seeds
    the baseline and warm-start merits from the alpha = 0 merit."""
    return _staged(setup_kkt_batched, pcg_solve_batched, merit_alphas_batched,
                   model, cp, prob, st, settings, seeded)


def sqp_iter_staged(model: RobotModel, cp: CostParams, prob: Problem,
                    st: IterState, settings: BSQPSettings,
                    seeded: bool) -> tuple[IterState, IterStats]:
    """sqp_iter_reference's contract through the kkt, pcg and merit kernels
    (N <= 1024; the Schur condensation and dz stay torch, as the JAX package
    leaves them to XLA)."""
    return _staged(setup_kkt_batched_cuda, pcg_solve_batched_cuda,
                   merit_alphas_batched_cuda, model, cp, prob, st, settings,
                   seeded)


def _btd(S_main, S_lower, P_main, P_lower, gamma, lam, pcg_tol, max_pcg_iters,
         skip):
    """btd_solve_batched in pcg_solve_batched's signature (no
    preconditioner, tolerance or cap)."""
    return btd_solve_batched(S_main, S_lower, gamma, lam, skip)


def sqp_iter_btd(model: RobotModel, cp: CostParams, prob: Problem,
                 st: IterState, settings: BSQPSettings,
                 seeded: bool) -> tuple[IterState, IterStats]:
    """sqp_iter_staged's contract with the direct block-tridiagonal solve
    in place of PCG: the JAX package computes it outside any Pallas kernel
    (gato_tpu/solver/bsqp.py:246-249), so it is torch here on both devices."""
    return _staged(setup_kkt_batched_cuda, _btd, merit_alphas_batched_cuda,
                   model, cp, prob, st, settings, seeded)


def sqp_iter_fused(model: RobotModel, cp: CostParams, prob: Problem,
                   st: IterState, settings: BSQPSettings,
                   seeded: bool) -> tuple[IterState, IterStats]:
    """sqp_iter_reference's contract through the iter kernel (KKT + Schur +
    PCG + dz, N <= 128) and the merit kernel."""
    dzx, dzu, lam, pcg_it = sqp_iter_core_cuda(
        model, cp, st.X, st.U, prob.x_s, prob.ref, prob.f_ext, st.lam, st.rho,
        prob.pcg_tol, st.conv > 0.5, prob.dt, settings.max_pcg_iters,
        settings.integrator_type)
    return _line_search(merit_alphas_batched_cuda, model, cp, prob, st,
                        settings, seeded, dzx, dzu, lam, pcg_it)


MAX_ALPHAS = 15  # merit slots in shared memory, alpha = 0 included


def sqp_iter_cuda(model: RobotModel, cp: CostParams, prob: Problem,
                  st: IterState, settings: BSQPSettings,
                  seeded: bool, *, variant: tuple[str, int] | None = None,
                  phase_a: str | None = None) -> tuple[IterState, IterStats]:
    """One SQP iteration: csrc/bsqp_iter.cu on CUDA tensors (float32), the
    plain version on CPU tensors. `variant` and `phase_a` name the kernel
    variant for a measurement (ops/cuda_iter.py::launch_iteration); None
    lets N decide.

    The kernel replaces gato_tpu/ops/pallas_solve.py::_solve_kernel as
    launched by sqp_solve_pallas_chained: one thread block per problem
    (N <= 128), one thread per knot outside phase A's KKT and the PCG loop.
    Built for indy7 and iiwa14 (another plant raises). Up to N = 64 the
    per-knot Schur and preconditioner blocks move into shared memory for
    the loop, which G threads per knot share, so the loop's traffic stays
    on the SM, at the residency that the shared memory leaves (2 problems
    per SM at N = 32 for indy7); indy7's four threads of a knot share the
    KKT in stages (csrc/kkt_stages.cuh). Past N = 64, and for iiwa14 at
    every N, one thread per knot runs the whole generated KKT code (it
    spills); past N = 64 the loop re-reads the blocks from an element-major
    global scratch.
    """
    if st.X.device.type == "cpu":
        return sqp_iter_reference(model, cp, prob, st, settings, seeded)
    require_cuda_robot(model, "bsqp_iter")
    B = st.X.shape[0]
    if settings.num_alphas > MAX_ALPHAS:
        raise ValueError(f"bsqp_iter kernel takes num_alphas <= {MAX_ALPHAS},"
                         f" got {settings.num_alphas}")
    for name, t in (("rho", st.rho), ("drho", st.drho), ("mu", prob.mu),
                    ("pcg_tol", prob.pcg_tol), ("mbase", st.mbase),
                    ("merit0", st.merit0), ("conv", st.conv),
                    ("sqp", st.sqp)):
        check_cuda(name, t, (B,))

    def vec():
        return torch.empty(B, dtype=torch.float32, device=st.X.device)

    out = IterState(torch.empty_like(st.X), torch.empty_like(st.U),
                    torch.empty_like(st.lam), vec(), vec(), vec(), vec(),
                    vec(), vec())
    stats = IterStats(torch.empty(B, dtype=torch.int32, device=st.X.device),
                      vec(), vec())
    launch_iteration(
        "bsqp_iter", model, cp, settings.integrator_type, prob.dt,
        dict(X=st.X, U=st.U, lam=st.lam, xs=prob.x_s, ref=prob.ref,
             fe=prob.f_ext, rho=st.rho, drho=st.drho, mu=prob.mu,
             eps=prob.pcg_tol, mbase=st.mbase, merit0=st.merit0, conv=st.conv,
             sqp=st.sqp, X_o=out.X, U_o=out.U, lam_o=out.lam, rho_o=out.rho,
             drho_o=out.drho, mbase_o=out.mbase, merit0_o=out.merit0,
             conv_o=out.conv, sqp_o=out.sqp, ls_merit=stats.ls_merit,
             ls_step=stats.ls_step, pcg_iters=stats.pcg_iters),
        max_pcg_iters=settings.max_pcg_iters, num_alphas=settings.num_alphas,
        adapt_rho=settings.adapt_rho, seeded=seeded, variant=variant,
        phase_a=phase_a)
    sqp_iter_cuda.launches += 1
    return out, stats


sqp_iter_cuda.launches = 0


def _select(carry: IterState, new: IterState, exit_now, it0: bool):
    """The exit fired on this iteration: revert the line-search effects
    (trajectory, rho schedule, baseline merit) but keep the dual update and
    the convergence flags (pallas_solve.py:609-632)."""
    keep = ~exit_now

    def sel(a, b):
        return torch.where(keep, b, a)

    mbase = torch.where(keep, new.mbase, new.merit0 if it0 else carry.mbase)
    return IterState(sel(carry.X, new.X), sel(carry.U, new.U), new.lam,
                     sel(carry.rho, new.rho), sel(carry.drho, new.drho),
                     mbase, new.merit0, new.conv, new.sqp)


def sqp_solve_chained(iter_fn, model: RobotModel, cp: CostParams,
                      settings: BSQPSettings, X, U, lam, x_s, ref, f_ext,
                      rho, drho, mu, pcg_tol, dt: float, device_exit: bool = False,
                      mesh=None):
    """Run up to settings.max_sqp_iters iterations of `iter_fn` (one of the
    sqp_iter_* functions above) with the whole-batch exit:
    after each iteration, once the number of converged problems reaches
    B * solve_ratio, that iteration's line search is reverted and the solve
    stops. Iteration 0 seeds the baseline merit from the alpha = 0 merit.

    Returns (X, U, lam, rho, drho, conv, merit0, merit_final, sqp_iters (B,),
    pcg_iters (iters, B) int32, ls_merit (iters, B), ls_step (iters, B)).
    The exit test reads the device only between two iterations, never after
    the last one. With device_exit=True it reads nothing: all
    max_sqp_iters iterations run, a sticky flag on the device marks the
    exit, and every iteration after it is discarded by torch.where; the
    outputs equal the host-exit form's bit for bit.

    With a `mesh` (parallel/sharding.py::Mesh) the B problems are one
    rank's share of mesh.world x B: the converged count is all-reduced over
    the ranks after every iteration and the threshold is the global
    batch's, so every rank exits at the same iteration (the JAX package's
    psum, gato_tpu/solver/bsqp.py:281-289). device_exit then needs a
    collective that stays on the device (ValueError otherwise)."""
    if mesh is not None and device_exit and not mesh.reduces_on_device(X.device):
        raise ValueError("device_exit=True with a gloo mesh on the card: gloo takes the "
                         "converged count through host memory, which reads the device; "
                         "use NCCL (a card per rank) or the host exit")
    B = X.shape[0]
    iters = settings.max_sqp_iters
    zero = torch.zeros(B, dtype=X.dtype, device=X.device)
    prob = Problem(x_s, ref, f_ext, mu, pcg_tol, dt)
    carry = IterState(X, U, lam, rho, drho, zero, zero, zero, zero)
    pcg_all = torch.zeros(iters, B, dtype=torch.int32, device=X.device)
    lsm_all = torch.zeros(iters, B, dtype=X.dtype, device=X.device)
    lss_all = torch.zeros(iters, B, dtype=X.dtype, device=X.device)
    thresh = (B if mesh is None else B * mesh.world) * settings.solve_ratio
    exited = torch.zeros((), dtype=torch.bool, device=X.device)
    for it in range(iters):
        new, stats = iter_fn(model, cp, prob, carry, settings, seeded=it > 0)
        solved = new.conv.sum()
        if mesh is not None:
            solved = mesh.all_reduce(solved, "sum")
        exit_now = solved >= thresh
        selected = _select(carry, new, exit_now, it0=it == 0)
        pcg = stats.pcg_iters
        if device_exit:
            carry = IterState(*(torch.where(exited, a, b) for a, b in zip(carry, selected)))
            pcg = torch.where(exited, 0, pcg)
            exit_now = exited = exit_now | exited
        else:
            carry = selected
        pcg_all[it] = pcg
        lsm_all[it] = torch.where(exit_now, 0.0, stats.ls_merit)
        lss_all[it] = torch.where(exit_now, 0.0, stats.ls_step)
        if not device_exit and it + 1 < iters and bool(exit_now):
            break
    return (carry.X, carry.U, carry.lam, carry.rho, carry.drho, carry.conv,
            carry.merit0, carry.mbase, carry.sqp, pcg_all, lsm_all, lss_all)
