"""The batched KKT setup (per-knot linearization and quadraticization) in
one launch.

Port of gato_tpu/ops/pallas_kkt.py. The plain version is
ops/kkt_fast.py::setup_kkt_batched; `setup_kkt_batched_cuda` launches
csrc/kkt.cu on a CUDA tensor and runs the plain version on a CPU tensor.
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


class _KktArgs(ctypes.Structure):
    """Mirror of KktArgs in csrc/kkt.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "X", "U", "ref", "fe", "Q", "q", "R", "r", "A", "Bm", "c", "sink")]
        + [(n, ctypes.c_int) for n in ("B", "N", "ref_stride")]
        + [("dt", ctypes.c_float), ("w", ctypes.c_float * 7)])


def setup_kkt_batched_cuda(model: RobotModel, cp: CostParams, X, U, x_s,
                           ref, f_ext, dt: float,
                           integrator_type: int = 2) -> KKTSystem:
    """setup_kkt_batched's contract: X (B,N,nx), U (B,N-1,nu), x_s (B,nx),
    ref (B,N,>=3), f_ext (B,6) -> KKTSystem with (B, ...) leading axes.

    CUDA kernel: csrc/kkt.cu, replacing gato_tpu/ops/pallas_kkt.py::
    _kkt_kernel; one thread per (problem, knot) runs the generated knot_kkt,
    the last knot with the terminal tracking weight. Bound by that
    straight-line code's registers (it spills). c_0 = x_0 - x_s is set
    here."""
    if X.device.type == "cpu":
        return setup_kkt_batched(model, cp, X, U, x_s, ref, f_ext, dt,
                                 integrator_type)
    require_cuda_robot(model)
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

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=X.device)

    kkt = KKTSystem(Q=empty(B, N, nx, nx), q=empty(B, N, nx),
                    R=empty(B, N - 1, nu, nu), r=empty(B, N - 1, nu),
                    A=empty(B, N - 1, nx, nx), B=empty(B, N - 1, nx, nu),
                    c=empty(B, N, nx))
    lib = load_library("kkt")
    sink_floats = lib.gato_kkt_sink_floats
    sink_floats.restype = ctypes.c_int
    sink = empty(B, sink_floats())
    fn = lib.gato_kkt_indy7
    fn.argtypes = [ctypes.POINTER(_KktArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _KktArgs(*[t.data_ptr() for t in (
        X, U, ref, f_ext, kkt.Q, kkt.q, kkt.R, kkt.r, kkt.A, kkt.B, kkt.c,
        sink)], B, N, ref.shape[-1], dt, (ctypes.c_float * 7)(*cp.weights()))
    err = fn(ctypes.byref(args), torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kkt kernel launch failed: CUDA error {err}")
    setup_kkt_batched_cuda.launches += 1
    torch.sub(X[:, 0], x_s, out=kkt.c[:, 0])
    return kkt


setup_kkt_batched_cuda.launches = 0
