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
# the merit kernel's variants (csrc/merit.cu): "warps", the default, holds
# WARPS_PER_CTA (problem, alpha) pairs a CTA, a warp each; "one" is the
# earlier kernel (a block per pair), taken only when forced
DEFAULT = "warps"
VARIANTS = ("warps", "one")
WARPS_PER_CTA = 4


class _MeritArgs(ctypes.Structure):
    """Mirror of MeritArgs in csrc/merit.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "X", "U", "dZX", "dZU", "xs", "ref", "fe", "mu", "out")]
        + [(n, ctypes.c_int) for n in ("B", "N", "A", "ref_stride")]
        + [("dt", ctypes.c_float), ("w", ctypes.c_float * 7),
           ("alphas", ctypes.c_float * MAX_ALPHAS)])


def _variant_code(variant) -> int:
    """csrc/merit.cu's variant argument: 1 for "warps", 0 for "one"."""
    if variant not in VARIANTS:
        raise ValueError(f"merit kernel variant {variant!r} is not compiled; "
                         f"one of {VARIANTS}")
    return int(variant == "warps")


def blocks_per_sm(variant, robot: str = "indy7") -> int:
    """Resident CTAs per SM of a variant built for `robot`, as the library
    reports them (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = load_library("merit", robot).gato_merit_blocks_per_sm
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(_variant_code(variant))


def merit_alphas_batched_cuda(model: RobotModel, cp: CostParams, X, U, dZX,
                              dZU, x_s, ref, f_ext, mu, dt: float, alphas,
                              integrator_type: int = 2, *,
                              variant: str | None = None):
    """merit_alphas_batched's contract: the merit at X + alpha dZX,
    U + alpha dZU for every (lane, alpha), (B, A); alphas a sequence of
    floats, an alpha of 0 evaluating X, U themselves.

    CUDA kernel: csrc/merit.cu, replacing gato_tpu/ops/pallas_merit.py::
    _merit_knot_kernel, the candidates formed in registers, a thread a
    knot. Built for indy7 and iiwa14 (another plant raises). Bound by the
    generated straight-line knot_merit of every (problem, alpha, knot). By default (DEFAULT, "warps") a CTA holds
    WARPS_PER_CTA pairs, a warp each; `variant="one"` forces the earlier
    kernel (a block a pair), for measurements only."""
    if X.device.type == "cpu":
        return merit_alphas_batched(model, cp, X, U, dZX, dZU, x_s, ref,
                                    f_ext, mu, dt, alphas, integrator_type)
    variant = variant or DEFAULT
    code = _variant_code(variant)
    plant = require_cuda_robot(model, "merit")
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
    fn = getattr(load_library("merit", plant), f"gato_merit_{plant}")
    fn.argtypes = [ctypes.POINTER(_MeritArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _MeritArgs(*[t.data_ptr() for t in (
        X, U, dZX, dZU, x_s, ref, f_ext, mu, out)], B, N, A, ref.shape[-1],
        dt, (ctypes.c_float * 7)(*cp.weights()),
        (ctypes.c_float * MAX_ALPHAS)(*alphas))
    err = fn(ctypes.byref(args), code,
             torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merit kernel launch ({variant}) failed: CUDA error {err}")
    merit_alphas_batched_cuda.launches += 1
    return out


merit_alphas_batched_cuda.launches = 0
