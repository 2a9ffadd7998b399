"""The batched KKT setup (per-knot linearization and quadraticization) in
one launch.

Port of gato_tpu/ops/pallas_kkt.py. The plain version is
ops/kkt_fast.py::setup_kkt_batched; `setup_kkt_batched_cuda` launches
csrc/kkt.cu on a CUDA tensor and runs the plain version on a CPU tensor.
The kernel is built for indy7 and iiwa14, one library each
(_build.KERNELS); the staged variant only for indy7, whose generated header
has the staged KKT (dynamics/codegen.py KKT_SPLITS).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..robots.model import RobotModel
from .cost import CostParams
from .cuda_sim import check_cuda, require_cuda_robot
from .kkt import KKTSystem
from .kkt_fast import setup_kkt_batched

# threads per knot of the staged kernel (csrc/kkt.cu's KKT_GROUPS), one of
# the header's splits (dynamics/codegen.py::KKT_SPLITS): the fastest of G =
# 2, 4, 6 on the card (PERF.md): at G = 2 a CTA of 32 knots fits 4 to an
# SM, so a batch of 16,384 knots runs in one wave
KKT_GROUPS = 2
ONE = ("one", 1)
# (layout, G) compiled for each plant: the staged kernel where the plant's
# header has the staged KKT (indy7), and the one-thread kernel ONE
VARIANTS = {"indy7": (("staged", KKT_GROUPS), ONE), "iiwa14": (ONE,)}
# the variant each plant takes: indy7 the staged kernel (ONE only when
# forced, for measurements), iiwa14 the one-thread kernel (a staged KKT
# for it is later work, ROADMAP)
DEFAULT = {"indy7": ("staged", KKT_GROUPS), "iiwa14": ONE}


class _KktArgs(ctypes.Structure):
    """Mirror of KktArgs in csrc/kkt.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "X", "U", "ref", "fe", "Q", "q", "R", "r", "A", "Bm", "c", "sink")]
        + [(n, ctypes.c_int) for n in ("B", "N", "ref_stride")]
        + [("dt", ctypes.c_float), ("w", ctypes.c_float * 7)])


def _variant_code(variant, plant: str) -> int:
    """csrc/kkt.cu's variant argument: 0 for "one", G for ("staged", G)."""
    layout, groups = variant
    if (layout, groups) not in VARIANTS[plant]:
        raise ValueError(f"kkt kernel variant {variant} is not compiled for {plant}; "
                         f"one of {VARIANTS[plant]}")
    return 0 if layout == "one" else groups


def variant_resources(variant, plant: str) -> tuple[int, int]:
    """(dynamic shared-memory bytes, resident CTAs per SM) of a variant of
    the plant's library, as it reports them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    code = _variant_code(variant, plant)
    lib = load_library("kkt", plant)
    nbytes, per_sm = lib.gato_kkt_smem_bytes, lib.gato_kkt_blocks_per_sm
    for f, res in ((nbytes, ctypes.c_longlong), (per_sm, ctypes.c_int)):
        f.argtypes = [ctypes.c_int]
        f.restype = res
    return nbytes(code), per_sm(code)


def sink_floats(plant: str) -> int:
    """Floats a problem of the one-thread variant's sink holds (the last
    knot's unused A, B, c, R diagonal and r), as the plant's library
    reports them."""
    fn = load_library("kkt", plant).gato_kkt_sink_floats
    fn.restype = ctypes.c_int
    return fn()


def setup_kkt_batched_cuda(model: RobotModel, cp: CostParams, X, U, x_s,
                           ref, f_ext, dt: float,
                           integrator_type: int = 2, *,
                           variant: tuple[str, int] | None = None) -> KKTSystem:
    """setup_kkt_batched's contract: X (B,N,nx), U (B,N-1,nu), x_s (B,nx),
    ref (B,N,>=3), f_ext (B,6) -> KKTSystem with (B, ...) leading axes.

    CUDA kernel: csrc/kkt.cu, replacing gato_tpu/ops/pallas_kkt.py::
    _kkt_kernel, from the library of the model's plant
    (cuda_sim.require_cuda_robot: indy7, iiwa14). The plant's DEFAULT
    variant at every N: for indy7 KKT_GROUPS threads per knot share the
    generated knot_kkt in stages (a primal, then a part of the dual RNEA's
    tangent columns each), the outputs staged in shared memory and stored
    coalesced; for iiwa14 one thread per knot runs all of knot_kkt (and
    spills). `variant=("one", 1)` forces that kernel on indy7, for
    measurements only. c_0 = x_0 - x_s is set here."""
    if X.device.type == "cpu":
        return setup_kkt_batched(model, cp, X, U, x_s, ref, f_ext, dt,
                                 integrator_type)
    plant = require_cuda_robot(model, "kkt")
    if integrator_type != 2:
        raise NotImplementedError("the CUDA kernels are generated for the "
                                  "trapezoidal integrator (integrator_type=2)")
    B, N, nx = X.shape
    nu = model.nu
    if N < 2:
        raise ValueError(f"kkt kernel takes N >= 2, got N={N}")
    for name, t, shape in (
            ("X", X, (B, N, nx)), ("U", U, (B, N - 1, nu)),
            ("x_s", x_s, (B, nx)), ("ref", ref, (B, N, ref.shape[-1])),
            ("f_ext", f_ext, (B, 6))):
        check_cuda(name, t, shape)
    if ref.shape[-1] < 3:
        raise ValueError("ref needs the EE xyz in its first 3 columns")
    variant = variant or DEFAULT[plant]
    code = _variant_code(variant, plant)

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=X.device)

    kkt = KKTSystem(Q=empty(B, N, nx, nx), q=empty(B, N, nx),
                    R=empty(B, N - 1, nu, nu), r=empty(B, N - 1, nu),
                    A=empty(B, N - 1, nx, nx), B=empty(B, N - 1, nx, nu),
                    c=empty(B, N, nx))
    lib = load_library("kkt", plant)
    sink = None
    if code == 0:
        sink = empty(B, sink_floats(plant))
    fn = getattr(lib, f"gato_kkt_{plant}")
    fn.argtypes = [ctypes.POINTER(_KktArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _KktArgs(*[t.data_ptr() for t in (
        X, U, ref, f_ext, kkt.Q, kkt.q, kkt.R, kkt.r, kkt.A, kkt.B, kkt.c)],
        None if sink is None else sink.data_ptr(), B, N, ref.shape[-1], dt,
        (ctypes.c_float * 7)(*cp.weights()))
    err = fn(ctypes.byref(args), code,
             torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kkt kernel launch ({variant}) failed: CUDA error {err}")
    setup_kkt_batched_cuda.launches += 1
    torch.sub(X[:, 0], x_s, out=kkt.c[:, 0])
    return kkt


setup_kkt_batched_cuda.launches = 0
