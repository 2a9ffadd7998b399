"""The fused core of one SQP iteration (KKT + Schur + PCG + dz) in one
launch, and the launch plumbing of the two iteration kernels.

Port of gato_tpu/ops/pallas_iter.py:

  sqp_iter_core_reference  the plain PyTorch version: setup_kkt_batched ->
                           build_schur -> pcg_solve_batched -> compute_dz;
  sqp_iter_core_cuda       the kernel wrapper: csrc/iter.cu on a CUDA
                           tensor (one block per problem, N <= 128), the
                           plain version on a CPU tensor;
  iteration_variant        the kernel variant that N and the plant take: the
                           PCG blocks in shared memory with G threads per
                           knot up to N = 64, in the global scratch past
                           that;
  phase_a_default          phase A's KKT in the variant: staged over the
                           G = 4 threads of a knot (csrc/kkt_stages.cuh) in
                           indy7's shared layout at G = 4, one thread per
                           knot running the whole knot_kkt elsewhere (every
                           iiwa14 variant: its header has no staged KKT);
  launch_iteration         builds the IterArgs of csrc/sqp_iter.cuh and
                           launches csrc/iter.cu or csrc/bsqp_iter.cu.

Like the TPU kernel, the core does not scrub non-finite steps: the caller
does (ops/cuda_solve.py::sqp_iter_fused). Both kernels are built for indy7
and iiwa14 (_build.KERNELS); the sizes follow the plant's nx and nu
(nx = 2 nu).
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

MAX_KNOTS = 128  # one thread per knot in group 0, __launch_bounds__(128)
MERIT_SLOTS = 16  # merits in shared memory
SMEM_LIMIT = 232_448  # dynamic shared memory of one block on sm_90
MAX_THREADS = 256  # G W threads at 255 registers each fill an SM's 65,536
LAYOUTS = {"global": 0, "shared": 1}
# the shared layout's last N, both plants: every N of the bench grid but
# 128. It is the last N that iiwa14's fits (nx = 14: 230,600 bytes at G = 2,
# 234,696 at N = 65); indy7's would fit up to N = 86.
SHARED_MAX_N = 64
# threads per knot (G) in the shared layout by the plant's nx, both
# kernels, from the G compiled for it (csrc/sqp_iter.cuh::shared_variant:
# those that divide nx). indy7 (12): the fastest of G in {1, 2, 4} in
# chip_smoke.py's timings at N=32, B=512 (PERF.md); at N=64 bsqp_iter's
# G=2 is within 3 % of it. iiwa14 (14): the fastest of G in {1, 2, 7}
# there (PERF.md); G W stays within MAX_THREADS up to N = 64.
SHARED_GROUPS = {12: 4, 14: 2}
COMPILED_GROUPS = {12: (1, 2, 4), 14: (1, 2, 7)}
# the one variant with the staged phase A, for the plant with a staged KKT
# (indy7, nx = 12): G = 4 groups, one part each
STAGED_A = {12: ("shared", 4)}
PHASE_A = ("one", "staged")
# the state size of each plant the iteration kernels are built for
PLANT_NX = {"indy7": 12, "iiwa14": 14}


def warp_threads(N: int) -> int:
    """W, the threads of one group: N rounded up to a warp."""
    return 32 * ((N + 31) // 32)


def smem_bytes(N: int, layout: str, groups: int, nx: int = 12) -> int:
    """Dynamic shared memory of one block for a plant of state size nx
    (nu = nx / 2), the formula of csrc/sqp_iter.cuh::smem_bytes: X, U, lam,
    r, p, z, Ap, dz, 32 warp partials, the merits, the line search's two
    words; the shared layout adds the four nx x nx blocks of every knot and
    two buffers of one dot partial per thread."""
    nu = nx // 2
    floats = N * (7 * nx + 2 * nu) + 32 + MERIT_SLOTS + 2
    if layout == "shared":
        floats += 4 * nx * nx * N + 2 * groups * warp_threads(N)
    return 4 * floats


def iteration_variant(N: int, nx: int = 12) -> tuple[str, int]:
    """(layout, G) of both iteration kernels (csrc/bsqp_iter.cu,
    csrc/iter.cu) at horizon N for a plant of state size nx: the blocks in
    shared memory with SHARED_GROUPS[nx] threads per knot up to
    SHARED_MAX_N, the global scratch with one thread per knot past it.
    Not a user setting: N and the plant decide."""
    if nx not in SHARED_GROUPS:
        raise ValueError(f"no iteration kernel is built for nx = {nx}")
    if N <= SHARED_MAX_N:
        return "shared", SHARED_GROUPS[nx]
    return "global", 1


def phase_a_default(layout: str, groups: int, nx: int) -> str:
    """Phase A's KKT in a variant: "staged" (the G threads of a knot share
    knot_kkt's stages) where the variant is the plant's STAGED_A, else
    "one" (thread k of group 0 runs all of knot_kkt). "one" at STAGED_A is
    compiled too, as the comparison arm for measurements."""
    return "staged" if (layout, groups) == STAGED_A.get(nx) else "one"


def _phase_a_code(layout: str, groups: int, phase_a: str | None, nx: int) -> int:
    phase_a = phase_a or phase_a_default(layout, groups, nx)
    if phase_a not in PHASE_A or (phase_a != "one"
                                  and (layout, groups) != STAGED_A.get(nx)):
        raise ValueError(f"phase A {phase_a!r} is not compiled for the "
                         f"{layout} layout at G={groups} (nx = {nx})")
    return PHASE_A.index(phase_a)


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
                     adapt_rho: bool = False, seeded: bool = False,
                     variant: tuple[str, int] | None = None,
                     phase_a: str | None = None):
    """Launch csrc/<name>.cu (bsqp_iter or iter) on `tensors`, {IterArgs
    field: CUDA tensor}; fields left out are null. X, U, lam, xs, ref, fe
    are checked here, the caller checks the rest. `variant` (layout, G)
    and `phase_a` ("staged" or "one") name the kernel variant for a
    measurement; None takes iteration_variant(N) and phase_a_default. A
    launch that the card refuses raises."""
    require_cuda_robot(model, name)
    if integrator_type != 2:
        raise NotImplementedError("the CUDA kernels are generated for the "
                                  "trapezoidal integrator (integrator_type=2)")
    X = tensors["X"]
    B, N = X.shape[:2]
    nx = model.nx
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

    lib = load_library(name, model.name)
    knot_floats = getattr(lib, f"gato_{name}_knot_floats")
    knot_floats.restype = ctypes.c_int
    fn = getattr(lib, f"gato_{name}_{model.name}")
    fn.argtypes = [ctypes.POINTER(_IterArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    layout, groups = variant or iteration_variant(N, nx)
    staged = _phase_a_code(layout, groups, phase_a, nx)
    scratch = torch.empty(knot_floats() * B * N, dtype=torch.float32,
                          device=X.device)
    args = _IterArgs(scratch=scratch.data_ptr(),
                     **{f: t.data_ptr() for f, t in tensors.items()},
                     B=B, N=N, ref_stride=ref.shape[-1],
                     max_pcg_iters=max_pcg_iters, num_alphas=num_alphas,
                     adapt_rho=int(adapt_rho), seeded=int(seeded), dt=dt,
                     w=(ctypes.c_float * 7)(*cp.weights()))
    err = fn(ctypes.byref(args), LAYOUTS[layout], groups, staged,
             torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch ({model.name}, {layout} layout, "
                           f"G={groups}, phase A {PHASE_A[staged]}, N={N}) failed: "
                           f"CUDA error {err}")


def variant_resources(name: str, N: int, layout: str, groups: int,
                      phase_a: str | None = None, robot: str = "indy7"):
    """(shared-memory bytes, resident blocks per SM) of a variant of
    csrc/<name>.cu for `robot` at horizon N, as the library reports them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = load_library(name, robot)
    nbytes = getattr(lib, f"gato_{name}_smem_bytes")
    per_sm = getattr(lib, f"gato_{name}_blocks_per_sm")
    nbytes.argtypes = [ctypes.c_int] * 3
    nbytes.restype = ctypes.c_longlong
    per_sm.argtypes = [ctypes.c_int] * 4
    per_sm.restype = ctypes.c_int
    staged = _phase_a_code(layout, groups, phase_a, PLANT_NX[robot])
    return (nbytes(N, LAYOUTS[layout], groups),
            per_sm(N, LAYOUTS[layout], groups, staged))


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
                       max_pcg_iters: int, integrator_type: int = 2, *,
                       variant: tuple[str, int] | None = None,
                       phase_a: str | None = None):
    """sqp_iter_core_reference's contract: csrc/iter.cu on CUDA tensors
    (float32, N <= 128), the plain version on CPU tensors. `variant` and
    `phase_a` name the kernel variant for a measurement
    (launch_iteration).

    The kernel replaces gato_tpu/ops/pallas_iter.py::_iter_kernel with
    phases A-E of csrc/bsqp_iter.cu (csrc/sqp_iter.cuh), built for indy7
    and iiwa14 (another plant raises). Up to N = 64 the PCG loop reads each
    knot's four nx x nx blocks from shared memory, G threads per knot
    (iteration_variant), so its traffic stays on the SM, and indy7's four
    threads of a knot share phase A's KKT in stages; past N = 64, and for
    iiwa14 at every N, one thread per knot runs the whole generated KKT
    code (it spills), and past N = 64 the loop re-reads the blocks from an
    element-major global scratch."""
    if X.device.type == "cpu":
        return sqp_iter_core_reference(model, cp, X, U, x_s, ref, f_ext, lam,
                                       rho, pcg_tol, skip, dt, max_pcg_iters,
                                       integrator_type)
    require_cuda_robot(model, "iter")
    B = X.shape[0]
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
        max_pcg_iters=max_pcg_iters, variant=variant, phase_a=phase_a)
    sqp_iter_core_cuda.launches += 1
    return dzx, dzu, lam_o, iters


sqp_iter_core_cuda.launches = 0
