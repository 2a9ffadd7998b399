"""The line-search merit sweep over (problem, alpha) in one launch.

Port of gato_tpu/ops/pallas_merit.py. The plain version is
ops/merit_fast.py::merit_alphas_batched; `merit_alphas_batched_cuda`
launches csrc/merit.cu on a CUDA tensor and runs the plain version on a
CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..robots.model import RobotModel
from .cost import CostParams
from .cuda_sim import check_cuda, require_cuda_robot
from .merit_fast import merit_alphas_batched

MAX_ALPHAS = 16  # alphas passed by value in MeritArgs


class _MeritArgs(ctypes.Structure):
    """Mirror of MeritArgs in csrc/merit.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "X", "U", "dZX", "dZU", "xs", "ref", "fe", "mu", "out")]
        + [(n, ctypes.c_int) for n in ("B", "N", "A", "ref_stride")]
        + [("dt", ctypes.c_float), ("w", ctypes.c_float * 7),
           ("alphas", ctypes.c_float * MAX_ALPHAS)])


def merit_alphas_batched_cuda(model: RobotModel, cp: CostParams, X, U, dZX,
                              dZU, x_s, ref, f_ext, mu, dt: float, alphas,
                              integrator_type: int = 2):
    """merit_alphas_batched's contract: the merit at X + alpha dZX,
    U + alpha dZU for every (lane, alpha), (B, A); alphas a sequence of
    floats, an alpha of 0 evaluating X, U themselves.

    CUDA kernel: csrc/merit.cu, replacing gato_tpu/ops/pallas_merit.py::
    _merit_knot_kernel; one block per (problem, alpha), one thread per
    knot, the candidate formed in registers. Bound by the generated
    straight-line knot_merit each thread runs."""
    if X.device.type == "cpu":
        return merit_alphas_batched(model, cp, X, U, dZX, dZU, x_s, ref,
                                    f_ext, mu, dt, alphas, integrator_type)
    require_cuda_robot(model)
    if integrator_type != 2:
        raise NotImplementedError("the CUDA kernels are generated for the "
                                  "trapezoidal integrator (integrator_type=2)")
    B, N, nx = X.shape
    A = len(alphas)
    if N < 2 or not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"merit kernel takes N >= 2 and 1 <= len(alphas) <= "
                         f"{MAX_ALPHAS}, got N={N}, {A} alphas")
    for name, t, shape in (
            ("X", X, (B, N, nx)), ("U", U, (B, N - 1, model.nu)),
            ("dZX", dZX, (B, N, nx)), ("dZU", dZU, (B, N - 1, model.nu)),
            ("x_s", x_s, (B, nx)), ("ref", ref, (B, N, ref.shape[-1])),
            ("f_ext", f_ext, (B, 6)), ("mu", mu, (B,))):
        check_cuda(name, t, shape)
    if ref.shape[-1] < 3:
        raise ValueError("ref needs the EE xyz in its first 3 columns")
    out = torch.empty(B, A, dtype=torch.float32, device=X.device)
    lib = load_library("merit")
    fn = lib.gato_merit_indy7
    fn.argtypes = [ctypes.POINTER(_MeritArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _MeritArgs(*[t.data_ptr() for t in (
        X, U, dZX, dZU, x_s, ref, f_ext, mu, out)], B, N, A, ref.shape[-1],
        dt, (ctypes.c_float * 7)(*cp.weights()),
        (ctypes.c_float * MAX_ALPHAS)(*alphas))
    err = fn(ctypes.byref(args), torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merit kernel launch failed: CUDA error {err}")
    merit_alphas_batched_cuda.launches += 1
    return out


merit_alphas_batched_cuda.launches = 0
