"""The fused core of one SQP iteration (KKT + Schur + PCG + dz) in one
launch, and the launch plumbing of the two iteration kernels.

Port of gato_tpu/ops/pallas_iter.py:

  sqp_iter_core_reference  the plain PyTorch version: setup_kkt_batched ->
                           build_schur -> pcg_solve_batched -> compute_dz;
  sqp_iter_core_cuda       the kernel wrapper: csrc/iter.cu on a CUDA
                           tensor (one block per problem, one thread per
                           knot, N <= 128), the plain version on a CPU
                           tensor;
  launch_iteration         builds the IterArgs of csrc/sqp_iter.cuh and
                           launches csrc/iter.cu or csrc/bsqp_iter.cu.

Like the TPU kernel, the core does not scrub non-finite steps: the caller
does (ops/cuda_solve.py::sqp_iter_fused).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..robots.model import RobotModel
from .cost import CostParams
from .cuda_sim import check_cuda, require_cuda_robot
from .kkt_fast import setup_kkt_batched
from .pcg import pcg_solve_batched
from .schur import build_schur, compute_dz

MAX_KNOTS = 128  # one thread per knot, __launch_bounds__(128)


class _IterArgs(ctypes.Structure):
    """Mirror of IterArgs in csrc/sqp_iter.cuh."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "X", "U", "lam", "xs", "ref", "fe", "rho", "drho", "mu", "eps",
        "mbase", "merit0", "conv", "sqp", "X_o", "U_o", "lam_o", "rho_o",
        "drho_o", "mbase_o", "merit0_o", "conv_o", "sqp_o", "ls_merit",
        "ls_step", "pcg_iters", "scratch", "dzx_o", "dzu_o")]
        + [(n, ctypes.c_int) for n in (
            "B", "N", "ref_stride", "max_pcg_iters", "num_alphas",
            "adapt_rho", "seeded")]
        + [("dt", ctypes.c_float), ("w", ctypes.c_float * 7)])


def launch_iteration(name: str, model: RobotModel, cp: CostParams,
                     integrator_type: int, dt: float, tensors: dict, *,
                     max_pcg_iters: int, num_alphas: int = 0,
                     adapt_rho: bool = False, seeded: bool = False):
    """Launch csrc/<name>.cu (bsqp_iter or iter) on `tensors`, {IterArgs
    field: CUDA tensor}; fields left out are null. X, U, lam, xs, ref, fe
    are checked here, the caller checks the rest."""
    require_cuda_robot(model)
    if integrator_type != 2:
        raise NotImplementedError("the CUDA kernels are generated for the "
                                  "trapezoidal integrator (integrator_type=2)")
    X = tensors["X"]
    B, N, nx = X.shape
    if not 2 <= N <= MAX_KNOTS:
        raise ValueError(f"{name} kernel takes 2 <= N <= {MAX_KNOTS} (one "
                         f"thread per knot), got N={N}")
    ref = tensors["ref"]
    for field, shape in (("X", (B, N, nx)), ("U", (B, N - 1, model.nu)),
                         ("lam", (B, N, nx)), ("xs", (B, nx)),
                         ("ref", (B, N, ref.shape[-1])), ("fe", (B, 6))):
        check_cuda(field, tensors[field], shape)
    if ref.shape[-1] < 3:
        raise ValueError("ref needs the EE xyz in its first 3 columns")

    lib = load_library(name)
    knot_floats = getattr(lib, f"gato_{name}_knot_floats")
    knot_floats.restype = ctypes.c_int
    fn = getattr(lib, f"gato_{name}_indy7")
    fn.argtypes = [ctypes.POINTER(_IterArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = torch.empty(knot_floats() * B * N, dtype=torch.float32,
                          device=X.device)
    args = _IterArgs(scratch=scratch.data_ptr(),
                     **{f: t.data_ptr() for f, t in tensors.items()},
                     B=B, N=N, ref_stride=ref.shape[-1],
                     max_pcg_iters=max_pcg_iters, num_alphas=num_alphas,
                     adapt_rho=int(adapt_rho), seeded=int(seeded), dt=dt,
                     w=(ctypes.c_float * 7)(*cp.weights()))
    err = fn(ctypes.byref(args), torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def sqp_iter_core_reference(model: RobotModel, cp: CostParams, X, U, x_s,
                            ref, f_ext, lam, rho, pcg_tol, skip, dt: float,
                            max_pcg_iters: int, integrator_type: int = 2):
    """KKT + Schur + PCG + dz in plain PyTorch, any device. X (B,N,nx),
    U (B,N-1,nu), x_s (B,nx), ref (B,N,>=3), f_ext (B,6), lam (B,N,nx),
    rho/pcg_tol (B,), skip (B,) bool. Returns (dZX, dZU, lam, pcg_iters
    (B,) int32)."""
    kkt = setup_kkt_batched(model, cp, X, U, x_s, ref, f_ext, dt,
                            integrator_type)
    schur = build_schur(kkt, rho, model.nq)
    lam, iters = pcg_solve_batched(
        schur.S_main, schur.S_lower, schur.P_main, schur.P_lower, schur.gamma,
        lam, pcg_tol, max_pcg_iters, skip=skip)
    dzx, dzu = compute_dz(kkt, schur, lam)
    return dzx, dzu, lam, iters


def sqp_iter_core_cuda(model: RobotModel, cp: CostParams, X, U, x_s, ref,
                       f_ext, lam, rho, pcg_tol, skip, dt: float,
                       max_pcg_iters: int, integrator_type: int = 2):
    """sqp_iter_core_reference's contract: csrc/iter.cu on CUDA tensors
    (float32, N <= 128), the plain version on CPU tensors.

    The kernel replaces gato_tpu/ops/pallas_iter.py::_iter_kernel with
    phases A-E of csrc/bsqp_iter.cu (csrc/sqp_iter.cuh). Like them it is
    bound by the generated per-knot KKT code's registers (it spills) and by
    the PCG loop re-reading each knot's four 12x12 blocks from an
    element-major global scratch."""
    if X.device.type == "cpu":
        return sqp_iter_core_reference(model, cp, X, U, x_s, ref, f_ext, lam,
                                       rho, pcg_tol, skip, dt, max_pcg_iters,
                                       integrator_type)
    B, N, nx = X.shape
    for name, t in (("rho", rho), ("pcg_tol", pcg_tol)):
        check_cuda(name, t, (B,))
    if not (skip.is_cuda and skip.dtype == torch.bool and skip.shape == (B,)):
        raise ValueError("skip: expected a (B,) bool CUDA tensor")
    dzx = torch.empty_like(X)
    dzu = torch.empty_like(U)
    lam_o = torch.empty_like(lam)
    iters = torch.empty(B, dtype=torch.int32, device=X.device)
    launch_iteration(
        "iter", model, cp, integrator_type, dt,
        dict(X=X, U=U, lam=lam, xs=x_s, ref=ref, fe=f_ext, rho=rho,
             eps=pcg_tol, conv=skip.to(torch.float32), lam_o=lam_o,
             pcg_iters=iters, dzx_o=dzx, dzu_o=dzu),
        max_pcg_iters=max_pcg_iters)
    sqp_iter_core_cuda.launches += 1
    return dzx, dzu, lam_o, iters


sqp_iter_core_cuda.launches = 0
