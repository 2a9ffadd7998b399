"""The whole batched PCG loop on an assembled block-tridiagonal system, in
one launch.

Port of gato_tpu/ops/pallas_pcg.py. The plain version is
ops/pcg.py::pcg_solve_batched; `pcg_solve_batched_cuda` launches
csrc/pcg.cu on a CUDA tensor and runs the plain version on a CPU tensor.

The kernel is built for indy7 (nx = 12) and iiwa14 (nx = 14), one library
each (_build.KERNELS); the wrapper has no model and takes the library of
the plant whose nx the system has (PLANT_OF_NX). It comes in three
variants, (layout, G, C) with G threads per knot and C thread blocks (CTAs)
per problem; `pcg_variant(N, nx)` picks one:

  shared   one CTA per problem, its blocks in shared memory, N <=
           SHARED_MAX_N[nx];
  cluster  one thread-block cluster of C CTAs per problem, each CTA holding
           a contiguous range of knots and the lower blocks of the knot
           before it (the halo), past SHARED_MAX_N[nx];
  global   one CTA per problem, one thread per knot, the blocks in a global
           scratch (the earlier design, the comparison arm of chip_smoke.py).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .cuda_sim import ROADMAP_ITEM, check_cuda
from .pcg import pcg_solve_batched

MAX_KNOTS = 1024  # the global variant: one thread per knot, one CTA a problem
# the plant whose library serves a system of state size nx
PLANT_OF_NX = {12: "indy7", 14: "iiwa14"}
SMEM_LIMIT = 232_448  # dynamic shared memory of one CTA on sm_90
SMEM_THREADS = 384  # csrc/pcg.cu's __launch_bounds__ of the shared and cluster variants
LAYOUTS = {"global": 0, "shared": 1, "cluster": 2}
# G compiled for the shared and cluster variants, by nx: those of 1, 2, 4,
# 7 that divide it (csrc/pcg.cu::smem_kernel)
GROUPS = {12: (1, 2, 4), 14: (1, 2, 7)}
CLUSTER_SIZES = (2, 4, 8, 16)  # C of the cluster variant; 16 is not portable
PORTABLE_CLUSTER = 8
# by nx: the shared variant's last N (the last that fits at its G) and its
# G; the cluster variant's G. indy7's are the fastest in chip_smoke.py's
# timings (PERF.md section 6); iiwa14's take the same rule (G = 2, as its
# iteration kernels' shared layout), each cut where it stops fitting
SHARED_MAX_N = {12: 95, 14: 71}
SHARED_GROUPS = {12: 4, 14: 2}
CLUSTER_GROUPS = {12: 4, 14: 2}
# the last N of the 4-CTA clusters (8 CTAs past it while their knots fit,
# then 16), both plants
CLUSTER4_MAX_N = 128


def warp_threads(n: int) -> int:
    """n rounded up to a warp."""
    return 32 * ((n + 31) // 32)


def cta_knots(N: int, C: int) -> int:
    """Knots of one CTA: ceil(N / C)."""
    return -(-N // C)


def cta_ranges(N: int, C: int) -> list[tuple[int, int, bool]]:
    """(first knot, knots, holds the halo) of each CTA rank of a problem,
    as csrc/pcg.cu cuts it: rank j takes [j n, min((j + 1) n, N)), n =
    ceil(N / C); in a cluster every rank but 0 also holds the lower blocks
    of knot j n - 1."""
    n = cta_knots(N, C)
    return [(j * n, min(n, N - j * n), C > 1 and j > 0) for j in range(C)]


def slot_stride(N: int, C: int) -> int:
    """Slots of one CTA, element-major stride: its knots and, in a cluster,
    the halo slot; made odd (csrc/pcg.cu::slot_stride)."""
    return (cta_knots(N, C) + (2 if C > 1 else 0)) | 1


def smem_bytes(N: int, layout: str, groups: int = 1, cluster: int = 1, *,
               nx: int) -> int:
    """Dynamic shared memory of one CTA for a system of state size nx, the
    formula of csrc/pcg.cu::smem_bytes: the four nx x nx blocks (S_main,
    S_lower, P_main, P_lower) and r, p in every slot, two buffers of one dot
    partial per thread, 8 totals for the cluster sums and 4 nx floats of
    halo rows; the global variant holds lam, r and p of every knot and 32
    warp partials."""
    if layout == "global":
        return 4 * (3 * N * nx + 32)
    S = slot_stride(N, cluster)
    return 4 * ((4 * nx * nx + 2 * nx) * S
                + 2 * groups * warp_threads(cta_knots(N, cluster)) + 8 + 4 * nx)


def threads(N: int, layout: str, groups: int = 1, cluster: int = 1) -> int:
    """Threads of one CTA."""
    if layout == "global":
        return warp_threads(N)
    return groups * warp_threads(cta_knots(N, cluster))


def fits(N: int, layout: str, groups: int = 1, cluster: int = 1, *, nx: int) -> bool:
    """Whether a variant can run at horizon N for a system of state size
    nx: its G compiled for nx, its shared memory within SMEM_LIMIT, its G W
    threads within SMEM_THREADS, and in a cluster every CTA holding at least
    one knot."""
    if layout == "global":
        return 1 <= N <= MAX_KNOTS
    if groups not in GROUPS[nx] or (layout == "shared" and cluster != 1):
        return False
    if layout == "cluster" and (cluster not in CLUSTER_SIZES
                                or (cluster - 1) * cta_knots(N, cluster) >= N):
        return False
    return (smem_bytes(N, layout, groups, cluster, nx=nx) <= SMEM_LIMIT
            and threads(N, layout, groups, cluster) <= SMEM_THREADS)


def _plant(nx: int) -> str:
    """The plant whose pcg library serves a system of state size nx;
    NotImplementedError naming the ROADMAP item for any other nx."""
    if nx not in PLANT_OF_NX:
        raise NotImplementedError(f"the pcg kernel is built for nx in {tuple(PLANT_OF_NX)} "
                                  f"({', '.join(PLANT_OF_NX.values())}), got nx={nx} "
                                  f"({ROADMAP_ITEM})")
    return PLANT_OF_NX[nx]


def pcg_variant(N: int, nx: int) -> tuple[str, int, int]:
    """(layout, G, C) of the pcg kernel at horizon N <= MAX_KNOTS for a
    system of state size nx: the shared variant up to SHARED_MAX_N[nx]; past
    it a cluster of 4 CTAs up to CLUSTER4_MAX_N, of 8 while their knots fit
    a CTA, of 16 past that. Not a user setting: N and the plant decide."""
    _plant(nx)
    if N <= SHARED_MAX_N[nx]:
        return "shared", SHARED_GROUPS[nx], 1
    g = CLUSTER_GROUPS[nx]
    if N <= CLUSTER4_MAX_N:
        return "cluster", g, 4
    return "cluster", g, 8 if fits(N, "cluster", g, 8, nx=nx) else 16


class _PcgArgs(ctypes.Structure):
    """Mirror of PcgArgs in csrc/pcg.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "S_main", "S_lower", "P_main", "P_lower", "gamma", "lam0", "eps",
        "skip", "lam", "iters", "scratch")]
        + [(n, ctypes.c_int) for n in (
            "B", "N", "max_iters", "layout", "groups", "cluster")])


def _library(nx: int):
    """(the library of the plant of state size nx, its launch entry)."""
    plant = _plant(nx)
    lib = load_library("pcg", plant)
    entry = getattr(lib, f"gato_pcg_{plant}")
    entry.argtypes = [ctypes.POINTER(_PcgArgs), ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    lib.gato_pcg_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.gato_pcg_smem_bytes.restype = ctypes.c_longlong
    lib.gato_pcg_occupancy.argtypes = ([ctypes.c_int] * 5
                                       + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.gato_pcg_occupancy.restype = ctypes.c_int
    return lib, entry


def library_smem_bytes(N: int, layout: str, groups: int = 1,
                       cluster: int = 1, *, nx: int) -> int:
    """smem_bytes as the compiled library of the plant of state size nx
    computes it."""
    return _library(nx)[0].gato_pcg_smem_bytes(N, LAYOUTS[layout], groups, cluster)


def variant_resources(N: int, B: int, layout: str, groups: int = 1,
                      cluster: int = 1, *, nx: int):
    """(shared-memory bytes of one CTA, resident CTAs per SM, clusters the
    card holds at once or -1 outside the cluster variant) of a variant at
    horizon N, batch B, for a system of state size nx, as the library
    reports them (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    cudaOccupancyMaxActiveClusters). Raises on a CUDA error."""
    lib = _library(nx)[0]
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.gato_pcg_occupancy(N, B, LAYOUTS[layout], groups, cluster,
                                 ctypes.byref(per_sm), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"pcg {layout} G={groups} C={cluster} at N={N}: "
                           f"CUDA error {err}")
    return library_smem_bytes(N, layout, groups, cluster, nx=nx), per_sm.value, clusters.value


def pcg_solve_batched_cuda(S_main, S_lower, P_main, P_lower, gamma, lam0,
                           epsilon, max_iters: int, skip, *,
                           variant: tuple[str, int, int] | None = None):
    """pcg_solve_batched's contract: S/P main (B,N,nx,nx), lower
    (B,N-1,nx,nx), gamma/lam0 (B,N,nx), epsilon (B,), skip (B,) bool.
    Returns (lam, iterations (B,) int32).

    CUDA kernel: csrc/pcg.cu, replacing gato_tpu/ops/pallas_pcg.py::
    _pcg_kernel, from the library of the plant whose state size is gamma's
    nx (12: indy7, 14: iiwa14; another nx raises NotImplementedError).
    Each Krylov iteration reads three nx x nx blocks a knot; the shared and
    cluster variants hold the blocks in shared memory, G threads per knot,
    so the loop's traffic stays on the SM (see the module docstring).
    `variant` (layout, G, C) names the variant for a measurement; None
    takes pcg_variant(N, nx). A variant that the card refuses raises."""
    if gamma.device.type == "cpu":
        return pcg_solve_batched(S_main, S_lower, P_main, P_lower, gamma,
                                 lam0, epsilon, max_iters, skip)
    B, N, nx = gamma.shape
    _plant(nx)
    if not 1 <= N <= MAX_KNOTS:
        raise ValueError(f"pcg kernel takes 1 <= N <= {MAX_KNOTS}, got N={N}")
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
    layout, groups, cluster = variant or pcg_variant(N, nx)
    lam = torch.empty_like(lam0)
    iters = torch.empty(B, dtype=torch.int32, device=gamma.device)
    scratch = (torch.empty(B * 4 * nx * nx * N, dtype=torch.float32,
                           device=gamma.device) if layout == "global" else None)
    entry = _library(nx)[1]
    args = _PcgArgs(*[None if t is None else t.data_ptr() for t in (
        S_main, S_lower, P_main, P_lower, gamma, lam0, epsilon, skip, lam,
        iters, scratch)], B, N, max_iters, LAYOUTS[layout], groups, cluster)
    err = entry(ctypes.byref(args), nx, torch.cuda.current_stream(gamma.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pcg kernel launch ({layout}, G={groups}, "
                           f"C={cluster}, N={N}) failed: CUDA error {err}")
    pcg_solve_batched_cuda.launches += 1
    return lam, iters


pcg_solve_batched_cuda.launches = 0
