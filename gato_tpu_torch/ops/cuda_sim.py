"""Batched RK4 plant step: the CUDA kernel csrc/rk4.cu and its plain version.

Port of gato_tpu/ops/pallas_sim.py. `rk4_channels` is the plain PyTorch
version (the same channel trace the TPU kernel body runs; `rk4_plain` runs
it on a tensor's columns);
`rk4_step_batched` is the kernel wrapper: on a CUDA tensor it launches
csrc/rk4.cu, on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build import KERNELS, load_library, register_plant
from ..dynamics import mathshim as ms
from ..robots.model import RobotModel

# the plants with a committed header that each kernel is built for,
# {kernel: plants}: every kernel for indy7 and iiwa14 (_build.KERNELS)
CUDA_ROBOTS = KERNELS
# the kernels that also serve a plant built by api/mpc.py::add_pendulum from
# one of their plants, from a header generated at first use
# (require_cuda_robot)
PENDULUM_KERNELS = ("rk4",)
ROADMAP_ITEM = "ROADMAP Queue 2: no library of this kernel is built for the plant"
# the rk4 kernel's variants (csrc/rk4.cu): "one", the default, one thread
# per problem; "crba", only when forced, spreads each forward dynamics call
# over two warps (CRBA beside the RNEA bias, fd's own expressions): about
# 2.7x faster at B = 1 on an H100, but its closed loop fails
# chip_smoke.py's tracking gate (PERF.md), so the default stays the
# earlier kernel
DEFAULT = "one"
VARIANTS = ("one", "crba")
# each variant's code in csrc/rk4.cu's gato_rk4_<plant>
CODES = {"one": 0, "crba": 1}


def _numpy_cos(x):
    return torch.cos(torch.from_numpy(np.asarray(x))).numpy()[()]


def _numpy_sin(x):
    return torch.sin(torch.from_numpy(np.asarray(x))).numpy()[()]


def rk4_channels(fd, q, qd, u, fe, dt, substeps, cos=ms.cos, sin=ms.sin):
    """RK4 integration on dynamics channels: q/qd/u are nq-length channel
    lists, fe a 6-length channel list or None, fd(cs, ss, qd, u, fe) -> qdd
    the forward dynamics (a ChannelizedDynamics' fd, or its straight-line
    program, dynamics/codegen.py::fd_program), cos and sin a channel's."""
    nq = len(q)
    h = dt / substeps

    def deriv(q, qd):
        qdd = fd([cos(x) for x in q], [sin(x) for x in q], qd, u, fe)
        return qd, qdd

    def axpy(x, a, y):
        return [x[i] + a * y[i] for i in range(len(x))]

    for _ in range(substeps):
        k1q, k1qd = deriv(q, qd)
        k2q, k2qd = deriv(axpy(q, 0.5 * h, k1q), axpy(qd, 0.5 * h, k1qd))
        k3q, k3qd = deriv(axpy(q, 0.5 * h, k2q), axpy(qd, 0.5 * h, k2qd))
        k4q, k4qd = deriv(axpy(q, h, k3q), axpy(qd, h, k3qd))
        q = [q[i] + (h / 6.0) * (k1q[i] + 2 * k2q[i] + 2 * k3q[i] + k4q[i])
             for i in range(nq)]
        qd = [qd[i] + (h / 6.0) * (k1qd[i] + 2 * k2qd[i] + 2 * k3qd[i]
                                   + k4qd[i])
              for i in range(nq)]
    return q, qd


def rk4_plain(model: RobotModel, x, u, dt: float, f_ext=None,
              substeps: int = 1):
    """rk4_channels on the columns of x (B, nx), u (B, nu), f_ext (B, 6),
    the forward dynamics the channel trace's straight-line program
    (dynamics/codegen.py::fd_program). On the CPU the channels are numpy
    views of the columns (of one lane numpy scalars, on which numpy's cost
    an operation is several times lower than on one-element arrays), cos
    and sin still torch's: the same operations on the same float type, so
    the values equal torch channels' bit for bit, without torch's cost a
    call on these small columns."""
    from ..dynamics.codegen import fd_program

    fd = fd_program(model.key, f_ext is not None)
    nq = model.nq
    if x.device.type == "cpu":
        lanes = slice(None) if x.shape[0] > 1 else 0

        def col(t, i):
            return t.numpy()[lanes, i]
        trig = dict(cos=_numpy_cos, sin=_numpy_sin)
    else:
        def col(t, i):
            return t[:, i]
        trig = {}
    fe = None if f_ext is None else [col(f_ext, i) for i in range(6)]
    q, qd = rk4_channels(fd, [col(x, i) for i in range(nq)],
                         [col(x, nq + i) for i in range(nq)],
                         [col(u, i) for i in range(nq)], fe, dt, substeps, **trig)
    if x.device.type == "cpu":
        return torch.from_numpy(np.stack(q + qd, -1).reshape(x.shape[0], -1))
    return torch.stack(q + qd, 1)


def check_cuda(name, t, shape):
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
            and tuple(t.shape) == tuple(shape)):
        raise ValueError(f"{name}: expected a contiguous float32 CUDA tensor "
                         f"of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _is_pendulum_plant(model: RobotModel, kernel: str) -> bool:
    """Whether add_pendulum built `model` from one of `kernel`'s plants (its
    name "<base>+pendulum") and `kernel` serves such plants."""
    base, _, rest = model.name.partition("+")
    return kernel in PENDULUM_KERNELS and rest == "pendulum" and base in CUDA_ROBOTS[kernel]


def has_cuda_kernel(model: RobotModel, kernel: str) -> bool:
    """Whether `kernel` serves the plant `model`: a plant of its row in
    CUDA_ROBOTS, or for rk4 also a pendulum-augmented one of them."""
    return model.name in CUDA_ROBOTS[kernel] or _is_pendulum_plant(model, kernel)


@functools.lru_cache(maxsize=None)
def _generated_plant(name: str, key: str) -> str:
    """Generate the header of the plant registered under `key` and register
    it with _build (once a process): returns its slug, which names the
    header, its namespace, its libraries and their entry points."""
    from ..dynamics.codegen import generate_plant, plant_slug

    slug = plant_slug(name, key)
    register_plant(slug, generate_plant(key, slug), PENDULUM_KERNELS)
    return slug


def require_cuda_robot(model: RobotModel, kernel: str) -> str:
    """The plant whose `kernel` library serves `model`: its name for a plant
    of CUDA_ROBOTS; for a pendulum-augmented one (rk4) the slug of its
    generated header, which hashes the registered constants, so another
    mass or length gets a library of its own. Raises NotImplementedError,
    naming the kernel and the ROADMAP item, for a plant that `kernel` does
    not serve: the pendulum-augmented plants on every kernel but rk4, any
    other plant (a URDF path) on every kernel."""
    if model.name in CUDA_ROBOTS[kernel]:
        return model.name
    if _is_pendulum_plant(model, kernel):
        return _generated_plant(model.name, model.key)
    raise NotImplementedError(
        f"the {kernel} kernel is not built for {model.name!r}, only for "
        f"{CUDA_ROBOTS[kernel]}"
        + (" and their pendulum-augmented plants" if kernel in PENDULUM_KERNELS else "")
        + f" ({ROADMAP_ITEM})")


def rk4_step_batched(model: RobotModel, x, u, dt: float, f_ext=None,
                     substeps: int = 1, *, variant: str | None = None):
    """Batched RK4 step: x (B, nx), u (B, nu), optional EE-frame wrench
    f_ext (B, 6) -> (B, nx).

    CUDA kernel: csrc/rk4.cu, replacing gato_tpu/ops/pallas_sim.py::
    _rk4_kernel, built for indy7, iiwa14 and the plants add_pendulum makes
    of them (require_cuda_robot: their header generated and their library built at
    the first call; another plant raises). By default (DEFAULT, "one") a thread per problem runs
    the 4 x substeps forward dynamics calls in series. `variant="crba"`
    forces the two-warp kernel (a CTA per problem: the mass matrix by CRBA
    beside the RNEA bias, then the Cholesky solve on every thread), whose
    latency at B = 1 is the shorter chain of dependent operations."""
    if x.device.type == "cpu":
        return rk4_plain(model, x, u, dt, f_ext, substeps)
    variant = variant or DEFAULT
    if variant not in VARIANTS:
        raise ValueError(f"rk4 kernel variant {variant!r} is not compiled; one of {VARIANTS}")
    plant = require_cuda_robot(model, "rk4")
    B, nx = x.shape
    check_cuda("x", x, (B, model.nx))
    check_cuda("u", u, (B, model.nu))
    if f_ext is not None:
        check_cuda("f_ext", f_ext, (B, 6))
    out = torch.empty_like(x)
    fn = getattr(load_library("rk4", plant), f"gato_rk4_{plant}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), u.data_ptr(),
             None if f_ext is None else f_ext.data_ptr(), out.data_ptr(), B,
             dt / substeps, substeps, CODES[variant],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rk4 kernel launch ({variant}) failed: CUDA error {err}")
    rk4_step_batched.launches += 1
    return out


rk4_step_batched.launches = 0
