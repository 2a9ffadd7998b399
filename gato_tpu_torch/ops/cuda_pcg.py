"""The whole batched PCG loop on an assembled block-tridiagonal system, in
one launch.

Port of gato_tpu/ops/pallas_pcg.py. The plain version is
ops/pcg.py::pcg_solve_batched; `pcg_solve_batched_cuda` launches
csrc/pcg.cu on a CUDA tensor and runs the plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .cuda_sim import check_cuda
from .pcg import pcg_solve_batched

MAX_KNOTS = 1024  # one thread per knot, one block per problem
NX = 12  # compiled for indy7's state size


class _PcgArgs(ctypes.Structure):
    """Mirror of PcgArgs in csrc/pcg.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "S_main", "S_lower", "P_main", "P_lower", "gamma", "lam0", "eps",
        "skip", "lam", "iters", "scratch")]
        + [(n, ctypes.c_int) for n in ("B", "N", "max_iters")])


def pcg_solve_batched_cuda(S_main, S_lower, P_main, P_lower, gamma, lam0,
                           epsilon, max_iters: int, skip):
    """pcg_solve_batched's contract: S/P main (B,N,nx,nx), lower
    (B,N-1,nx,nx), gamma/lam0 (B,N,nx), epsilon (B,), skip (B,) bool.
    Returns (lam, iterations (B,) int32).

    CUDA kernel: csrc/pcg.cu, replacing gato_tpu/ops/pallas_pcg.py::
    _pcg_kernel; one block per problem and one thread per knot (N <= 1024).
    Bound by re-reading each knot's four blocks in every iteration; the
    kernel first copies them into an element-major scratch so that a warp
    reads consecutive addresses."""
    if gamma.device.type == "cpu":
        return pcg_solve_batched(S_main, S_lower, P_main, P_lower, gamma,
                                 lam0, epsilon, max_iters, skip)
    B, N, nx = gamma.shape
    if not 1 <= N <= MAX_KNOTS or nx != NX:
        raise ValueError(f"pcg kernel takes 1 <= N <= {MAX_KNOTS} and nx = "
                         f"{NX}, got N={N}, nx={nx}")
    for name, t, shape in (
            ("S_main", S_main, (B, N, nx, nx)),
            ("S_lower", S_lower, (B, N - 1, nx, nx)),
            ("P_main", P_main, (B, N, nx, nx)),
            ("P_lower", P_lower, (B, N - 1, nx, nx)),
            ("gamma", gamma, (B, N, nx)), ("lam0", lam0, (B, N, nx)),
            ("epsilon", epsilon, (B,))):
        check_cuda(name, t, shape)
    if not (skip.is_cuda and skip.dtype == torch.bool and skip.shape == (B,)
            and skip.is_contiguous()):
        raise ValueError("skip: expected a contiguous (B,) bool CUDA tensor")
    lam = torch.empty_like(lam0)
    iters = torch.empty(B, dtype=torch.int32, device=gamma.device)
    scratch = torch.empty(B * 4 * nx * nx * N, dtype=torch.float32,
                          device=gamma.device)
    lib = load_library("pcg")
    fn = lib.gato_pcg
    fn.argtypes = [ctypes.POINTER(_PcgArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _PcgArgs(*[t.data_ptr() for t in (
        S_main, S_lower, P_main, P_lower, gamma, lam0, epsilon, skip, lam,
        iters, scratch)], B, N, max_iters)
    err = fn(ctypes.byref(args), nx,
             torch.cuda.current_stream(gamma.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pcg kernel launch failed: CUDA error {err}")
    pcg_solve_batched_cuda.launches += 1
    return lam, iters


pcg_solve_batched_cuda.launches = 0
