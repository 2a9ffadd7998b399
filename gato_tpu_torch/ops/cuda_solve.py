"""The batched SQP solve, one launch per SQP iteration.

Port of gato_tpu/ops/pallas_solve.py in its chained form
(sqp_solve_pallas_chained, the route the TPU headline takes):

  sqp_iter_reference  the plain PyTorch version of one launch of the TPU
                      `_solve_kernel` in chained mode: KKT setup, Schur
                      condensation, PCG, dz recovery, step_ok scrub, merit
                      at alpha in {0, 2^-j}, line search and rho schedule;
  sqp_iter_cuda       the kernel wrapper: csrc/bsqp_iter.cu on a CUDA tensor,
                      the plain version on a CPU tensor;
  sqp_solve_chained   the per-iteration loop shared by both: the
                      whole-batch solve_ratio exit is decided between
                      iterations, and the exiting iteration's line-search
                      effects are reverted (the reference breaks after
                      PCG/dz, before the merit kernel: bsqp.cuh:133-165).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import load_library
from ..robots.model import RobotModel
from ..solver.types import BSQPSettings
from .cost import CostParams
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


def sqp_iter_reference(model: RobotModel, cp: CostParams, prob: Problem,
                       st: IterState, settings: BSQPSettings,
                       seeded: bool) -> tuple[IterState, IterStats]:
    """One SQP iteration in plain PyTorch, any device. `seeded` False seeds
    the baseline and warm-start merits from the alpha = 0 merit."""
    X, U = st.X, st.U
    kkt = setup_kkt_batched(model, cp, X, U, prob.x_s, prob.ref, prob.f_ext,
                            prob.dt, settings.integrator_type)
    schur = build_schur(kkt, st.rho, model.nq)
    lam, pcg_it = pcg_solve_batched(
        schur.S_main, schur.S_lower, schur.P_main, schur.P_lower, schur.gamma,
        st.lam, prob.pcg_tol, settings.max_pcg_iters, skip=st.conv > 0.5)
    dzx, dzu = compute_dz(kkt, schur, lam)
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
    merits = merit_alphas_batched(model, cp, X, U, dzx, dzu, prob.x_s,
                                  prob.ref, prob.f_ext, prob.mu, prob.dt,
                                  alphas, settings.integrator_type)
    if seeded:
        mbase, merit0 = st.mbase, st.merit0
    else:
        mbase = merit0 = merits[:, 0]
    X, U, m_n, step, rho, drho = line_search_update(
        merits[:, 1:], mbase, torch.tensor(alphas[1:], dtype=X.dtype,
                                           device=X.device),
        X, U, dzx, dzu, st.rho, st.drho, settings.adapt_rho)
    return (IterState(X, U, lam, rho, drho, m_n, merit0, conv, sqp),
            IterStats(pcg_it, m_n, step))


class _IterArgs(ctypes.Structure):
    """Mirror of IterArgs in csrc/bsqp_iter.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "X", "U", "lam", "xs", "ref", "fe", "rho", "drho", "mu", "eps",
        "mbase", "merit0", "conv", "sqp", "X_o", "U_o", "lam_o", "rho_o",
        "drho_o", "mbase_o", "merit0_o", "conv_o", "sqp_o", "ls_merit",
        "ls_step", "pcg_iters", "scratch")]
        + [(n, ctypes.c_int) for n in (
            "B", "N", "ref_stride", "max_pcg_iters", "num_alphas",
            "adapt_rho", "seeded")]
        + [("dt", ctypes.c_float), ("w", ctypes.c_float * 7)])


MAX_KNOTS = 128  # one thread per knot, __launch_bounds__(128)
MAX_ALPHAS = 15  # merit slots in shared memory, alpha = 0 included


def sqp_iter_cuda(model: RobotModel, cp: CostParams, prob: Problem,
                  st: IterState, settings: BSQPSettings,
                  seeded: bool) -> tuple[IterState, IterStats]:
    """One SQP iteration: csrc/bsqp_iter.cu on CUDA tensors (float32), the
    plain version on CPU tensors.

    The kernel replaces gato_tpu/ops/pallas_solve.py::_solve_kernel as
    launched by sqp_solve_pallas_chained: one thread block per problem, one
    thread per knot. On this card it is bound by registers in the generated
    per-knot code (which spills) and by the PCG loop's reads of the per-knot
    12x12 Schur and preconditioner blocks; the blocks live in an
    element-major global scratch so that neighbouring threads read
    neighbouring addresses, and only the PCG vectors live in shared memory.
    """
    if st.X.device.type == "cpu":
        return sqp_iter_reference(model, cp, prob, st, settings, seeded)
    require_cuda_robot(model)
    if settings.integrator_type != 2:
        raise NotImplementedError("the CUDA kernels are generated for the "
                                  "trapezoidal integrator (integrator_type=2)")
    B, N, nx = st.X.shape
    nu = model.nu
    if not 2 <= N <= MAX_KNOTS or settings.num_alphas > MAX_ALPHAS:
        raise ValueError(f"bsqp_iter kernel takes 2 <= N <= {MAX_KNOTS} and "
                         f"num_alphas <= {MAX_ALPHAS}, got N={N}, "
                         f"num_alphas={settings.num_alphas}")
    for name, t, shape in (
            ("X", st.X, (B, N, nx)), ("U", st.U, (B, N - 1, nu)),
            ("lam", st.lam, (B, N, nx)), ("x_s", prob.x_s, (B, nx)),
            ("ref", prob.ref, (B, N, prob.ref.shape[-1])),
            ("f_ext", prob.f_ext, (B, 6)), ("rho", st.rho, (B,)),
            ("drho", st.drho, (B,)), ("mu", prob.mu, (B,)),
            ("pcg_tol", prob.pcg_tol, (B,)), ("mbase", st.mbase, (B,)),
            ("merit0", st.merit0, (B,)), ("conv", st.conv, (B,)),
            ("sqp", st.sqp, (B,))):
        check_cuda(name, t, shape)
    if prob.ref.shape[-1] < 3:
        raise ValueError("ref needs the EE xyz in its first 3 columns")

    lib = load_library("bsqp_iter")
    lib.gato_bsqp_knot_floats.restype = ctypes.c_int
    fn = lib.gato_bsqp_iter_indy7
    fn.argtypes = [ctypes.POINTER(_IterArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def vec():
        return torch.empty(B, dtype=torch.float32, device=st.X.device)

    out = IterState(torch.empty_like(st.X), torch.empty_like(st.U),
                    torch.empty_like(st.lam), vec(), vec(), vec(), vec(),
                    vec(), vec())
    stats = IterStats(torch.empty(B, dtype=torch.int32, device=st.X.device),
                      vec(), vec())
    scratch = torch.empty(lib.gato_bsqp_knot_floats() * B * N,
                          dtype=torch.float32, device=st.X.device)
    ins = (st.X, st.U, st.lam, prob.x_s, prob.ref, prob.f_ext, st.rho,
           st.drho, prob.mu, prob.pcg_tol, st.mbase, st.merit0, st.conv,
           st.sqp)
    outs = (out.X, out.U, out.lam, out.rho, out.drho, out.mbase, out.merit0,
            out.conv, out.sqp, stats.ls_merit, stats.ls_step,
            stats.pcg_iters, scratch)
    args = _IterArgs(*[t.data_ptr() for t in ins + outs],
                     B, N, prob.ref.shape[-1], settings.max_pcg_iters,
                     settings.num_alphas, int(settings.adapt_rho),
                     int(seeded), prob.dt,
                     (ctypes.c_float * 7)(*cp.weights()))
    err = fn(ctypes.byref(args),
             torch.cuda.current_stream(st.X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bsqp_iter kernel launch failed: CUDA error {err}")
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
                      rho, drho, mu, pcg_tol, dt: float):
    """Run up to settings.max_sqp_iters iterations of `iter_fn`
    (sqp_iter_cuda or sqp_iter_reference) with the whole-batch exit:
    after each iteration, once the number of converged problems reaches
    B * solve_ratio, that iteration's line search is reverted and the solve
    stops. Iteration 0 seeds the baseline merit from the alpha = 0 merit.

    Returns (X, U, lam, rho, drho, conv, merit0, merit_final, sqp_iters (B,),
    pcg_iters (iters, B) int32, ls_merit (iters, B), ls_step (iters, B)).
    The exit test reads the device only between two iterations, never after
    the last one."""
    B = X.shape[0]
    iters = settings.max_sqp_iters
    zero = torch.zeros(B, dtype=X.dtype, device=X.device)
    prob = Problem(x_s, ref, f_ext, mu, pcg_tol, dt)
    carry = IterState(X, U, lam, rho, drho, zero, zero, zero, zero)
    pcg_all = torch.zeros(iters, B, dtype=torch.int32, device=X.device)
    lsm_all = torch.zeros(iters, B, dtype=X.dtype, device=X.device)
    lss_all = torch.zeros(iters, B, dtype=X.dtype, device=X.device)
    thresh = B * settings.solve_ratio
    for it in range(iters):
        new, stats = iter_fn(model, cp, prob, carry, settings, seeded=it > 0)
        exit_now = new.conv.sum() >= thresh
        carry = _select(carry, new, exit_now, it0=it == 0)
        pcg_all[it] = stats.pcg_iters
        lsm_all[it] = torch.where(exit_now, 0.0, stats.ls_merit)
        lss_all[it] = torch.where(exit_now, 0.0, stats.ls_step)
        if it + 1 < iters and bool(exit_now):
            break
    return (carry.X, carry.U, carry.lam, carry.rho, carry.drho, carry.conv,
            carry.merit0, carry.mbase, carry.sqp, pcg_all, lsm_all, lss_all)
