"""The port's routes and its kernels' variants, on the CPU (no JAX):

- solver/bsqp.py::select_route;
- ops/cuda_iter.py::iteration_variant, the iteration kernels' layout by N
  for each plant (indy7, iiwa14), and the variants of the staged KKT
  (ops/cuda_kkt.py, phase A; indy7 only);
- the kkt and pcg kernels built for both plants: the libraries the
  wrappers load (_build.KERNELS, their entry points in csrc/), each plant's
  variant tables, and indy7's pcg variant at every N as before iiwa14's
  was added.
"""

import re

import pytest
import torch

from gato_tpu_torch import _build
from gato_tpu_torch.dynamics import codegen
from gato_tpu_torch.ops import cuda_iter, cuda_kkt, cuda_pcg, cuda_sim, schur
from gato_tpu_torch.ops.cuda_iter import (COMPILED_GROUPS, MAX_THREADS,
                                          SHARED_GROUPS, SHARED_MAX_N,
                                          SMEM_LIMIT, iteration_variant,
                                          phase_a_default, smem_bytes,
                                          warp_threads)
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import select_route
from gato_tpu_torch.solver.types import BSQPSettings


def test_route_selector():
    """(solve_kernel, iter_kernel, N, on CUDA) -> route, as the JAX
    package's gates read on the card: N alone decides "auto"."""
    for on_cuda in (False, True):
        for N in (2, 32, 128):
            assert select_route("auto", "auto", N, on_cuda) == "solve"
            assert select_route("fused", "off", N, on_cuda) == "solve"
            assert select_route("off", "auto", N, on_cuda) == "iter"
            assert select_route("off", "fused", N, on_cuda) == "iter"
            assert select_route("off", "off", N, on_cuda) == "staged"
        for N in (129, 256, 1024):
            for gates in (("auto", "auto"), ("off", "auto"), ("auto", "off"),
                          ("off", "off")):
                assert select_route(*gates, N, on_cuda) == "staged"
    # "fused" past 128 knots: the plain route on the CPU, refused on the card
    assert select_route("fused", "auto", 256, False) == "solve"
    assert select_route("off", "fused", 256, False) == "iter"
    for gates in (("fused", "auto"), ("off", "fused"), ("auto", "fused")):
        with pytest.raises(ValueError, match="fused"):
            select_route(*gates, 129, True)
    for gates in (("on", "auto"), ("auto", "pallas")):
        with pytest.raises(ValueError, match="expected one of"):
            select_route(*gates, 32, False)
        with pytest.raises(ValueError, match="expected one of"):
            BSQPSettings(solve_kernel=gates[0], iter_kernel=gates[1])


SHARED_FITS = {12: (86, ((32, 12_488), (64, 24_776), (128, 49_352))),
               14: (64, ((32, 14_536), (64, 28_872), (128, 57_544)))}


def test_iteration_variant_takes_shared_memory_where_it_fits():
    """For every N from 2 to 128 the iteration kernels' (layout, G) for a
    plant of state size nx (indy7 12, iiwa14 14): the four blocks in shared
    memory up to N = 64, where smem_bytes fits the 232,448 bytes a block may
    use (at G = 1 indy7's would up to N = 86; iiwa14's fits no further than
    64 at any compiled G) and G W <= 256 threads, G = SHARED_GROUPS[nx],
    one of the compiled G, which divide nx; the global scratch with G = 1
    past N = 64. smem_bytes is csrc/sqp_iter.cuh's
    formula: today's buffers (N (7 nx + nx) + 50 floats), plus 4 nx^2
    floats a knot and 2 G W partials."""
    for nx, (fits_to, bases) in SHARED_FITS.items():
        _variant_rule(nx, fits_to, bases)


def _variant_rule(nx, fits_to, bases):
    shared = []
    for N in range(2, 129):
        layout, g = iteration_variant(N, nx)
        W = warp_threads(N)
        assert W % 32 == 0 and N <= W < N + 32
        assert smem_bytes(N, layout, g, nx) <= SMEM_LIMIT and g * W <= MAX_THREADS
        assert (smem_bytes(N, "shared", 1, nx) <= SMEM_LIMIT) == (N <= fits_to)
        if layout == "shared":
            shared.append(N)
            assert g == SHARED_GROUPS[nx] and g in COMPILED_GROUPS[nx] and nx % g == 0
        else:
            assert (layout, g) == ("global", 1)
    assert shared == list(range(2, SHARED_MAX_N + 1))
    # the shared layout's last N is the last that a compiled G fits
    assert all(smem_bytes(SHARED_MAX_N + 1, "shared", g, nx) > SMEM_LIMIT
               for g in COMPILED_GROUPS[nx]) == (nx == 14)
    for N, base in bases:
        assert smem_bytes(N, "global", 1, nx) == base
        for g in COMPILED_GROUPS[nx]:
            assert (smem_bytes(N, "shared", g, nx)
                    == base + 16 * nx * nx * N + 8 * g * warp_threads(N))


def test_staged_kkt_variants():
    """The staged KKT's variants: the kkt kernel's G is one of the splits
    that the generated header carries (KKT_DIRS_G<G>), as is the iteration
    kernels' 4; phase A of the iteration kernels is staged exactly where
    indy7's shared layout has G = 4 groups, one per part of the header's
    4-way split (every N up to 64), and never for iiwa14, whose header has
    no staged KKT; a variant that is not compiled raises before any
    launch."""
    splits = codegen.KKT_SPLITS["indy7"]
    assert cuda_kkt.KKT_GROUPS in splits and SHARED_GROUPS[12] in splits
    assert cuda_kkt.VARIANTS["indy7"] == (("staged", cuda_kkt.KKT_GROUPS), ("one", 1))
    with open(codegen.header_path("indy7")) as f:
        header = f.read()
    for g in splits:
        assert f"constexpr int KKT_DIRS_G{g}[{g}][NX]" in header
    assert "#define GATO_KKT_STAGES 1" in header
    with open(codegen.header_path("iiwa14")) as f:
        header = f.read()
    assert codegen.KKT_SPLITS["iiwa14"] == ()
    assert "KKT_DIRS_G" not in header and "GATO_KKT_STAGES" not in header
    assert cuda_kkt._variant_code(("one", 1), "indy7") == 0
    assert cuda_kkt._variant_code(("staged", 2), "indy7") == 2
    for bad in (("staged", 4), ("staged", 6), ("one", 4), ("global", 1)):
        with pytest.raises(ValueError, match="not compiled"):
            cuda_kkt._variant_code(bad, "indy7")
    for N in range(2, 129):
        staged = phase_a_default(*iteration_variant(N), 12) == "staged"
        assert staged == (N <= 64)
        assert phase_a_default(*iteration_variant(N, 14), 14) == "one"
    assert cuda_iter.STAGED_A == {12: ("shared", 4)} and SHARED_GROUPS[12] == 4
    assert cuda_iter._phase_a_code("shared", 4, "one", 12) == 0
    for layout, g, nx in (("shared", 2, 12), ("global", 1, 12), ("shared", 7, 14),
                          ("shared", 2, 14)):
        with pytest.raises(ValueError, match="not compiled"):
            cuda_iter._phase_a_code(layout, g, "staged", nx)


def _indy7_pcg_variant_before(N):
    """indy7's pcg variant rule as it stood when the kernel served indy7
    alone: shared at G = 4 up to N = 95, clusters of 4 (G = 4) up to 128,
    of 8 while they fit, of 16 past."""
    if N <= 95:
        return "shared", 4, 1
    if N <= 128:
        return "cluster", 4, 4
    return "cluster", 4, 8 if cuda_pcg.smem_bytes(N, "cluster", 4, 8, nx=12) <= SMEM_LIMIT else 16


def test_kkt_and_pcg_serve_both_plants():
    """The kkt and pcg kernels are built for indy7 and iiwa14: each wrapper
    loads its plant's library (_build.KERNELS; the pcg wrapper by the
    system's nx) and calls its entry point gato_<kernel>_<plant>, which
    csrc/robot.cuh's GATO_ENTRY names; iiwa14 takes the one-thread kkt (its
    header has no staged KKT), indy7 the staged one; pcg's shared variant
    runs to the last N that fits a CTA at the plant's G (csrc/pcg.cu's
    smem_bytes), the G compiled are those that divide nx; another nx
    raises, naming the ROADMAP item; indy7's variant is the one it had at
    every N."""
    for kernel in ("kkt", "pcg"):
        assert _build.KERNELS[kernel] == ("indy7", "iiwa14")
        assert (kernel, "iiwa14") in _build.LIBRARIES
        with open(f"{_build.CSRC_DIR}/{kernel}.cu") as f:
            src = f.read()
        assert f"GATO_ENTRY(gato_{kernel})" in src and '#include "robot.cuh"' in src
        assert not re.search(r"gato::(indy7|iiwa14)\b", src)
    for robot in ("indy7", "iiwa14"):
        m = load_robot(robot, device="cpu")
        assert cuda_sim.require_cuda_robot(m, "kkt") == robot
        assert cuda_pcg.PLANT_OF_NX[m.nx] == robot
    assert tuple(cuda_pcg.PLANT_OF_NX.values()) == _build.KERNELS["pcg"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        cuda_pcg.pcg_variant(32, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        cuda_pcg._plant(16)
    # kkt: the variants each library compiles, the default each plant takes
    assert cuda_kkt.DEFAULT == {"indy7": ("staged", cuda_kkt.KKT_GROUPS), "iiwa14": ("one", 1)}
    assert cuda_kkt.VARIANTS["iiwa14"] == (("one", 1),)
    assert cuda_kkt._variant_code(("one", 1), "iiwa14") == 0
    with pytest.raises(ValueError, match="not compiled for iiwa14"):
        cuda_kkt._variant_code(("staged", 2), "iiwa14")
    # pcg: the G each library compiles, the shared variant's last N
    assert cuda_pcg.GROUPS == {12: (1, 2, 4), 14: (1, 2, 7)}
    for nx, groups in cuda_pcg.GROUPS.items():
        assert all(nx % g == 0 for g in groups)
        assert cuda_pcg.SHARED_GROUPS[nx] in groups and cuda_pcg.CLUSTER_GROUPS[nx] in groups
        last = cuda_pcg.SHARED_MAX_N[nx]
        g = cuda_pcg.SHARED_GROUPS[nx]
        assert cuda_pcg.fits(last, "shared", g, 1, nx=nx)
        assert not cuda_pcg.fits(last + 1, "shared", g, 1, nx=nx)
    assert cuda_pcg.SHARED_MAX_N == {12: 95, 14: 71}
    assert not cuda_pcg.fits(32, "shared", 4, 1, nx=14) and not cuda_pcg.fits(32, "shared", 7, 1, nx=12)
    # csrc/pcg.cu's smem_bytes at 14 x 14 blocks: 812 floats a slot, two
    # partials a thread, 8 totals and 56 floats of halo rows
    for N, layout, g, c, nbytes in ((32, "shared", 2, 1, 107_952),
                                    (71, "shared", 2, 1, 232_400),
                                    (256, "cluster", 2, 8, 114_448),
                                    (256, "cluster", 1, 16, 62_224),
                                    (256, "global", 1, 1, 43_136)):
        assert cuda_pcg.smem_bytes(N, layout, g, c, nx=14) == nbytes
    for N in range(1, cuda_pcg.MAX_KNOTS + 1):
        indy7 = cuda_pcg.pcg_variant(N, 12)
        assert indy7 == _indy7_pcg_variant_before(N)
        layout, g, c = cuda_pcg.pcg_variant(N, 14)
        assert cuda_pcg.fits(N, layout, g, c, nx=14)
        assert (layout, c) == (("shared", 1) if N <= 71 else ("cluster", 4) if N <= 128
                               else ("cluster", 8) if N <= 552 else ("cluster", 16))


def test_capturable_inverse_matches_cholesky_inverse():
    """ops/schur.py::spd_inv inside capturable_inverse (two triangular
    solves, the form a CUDA graph captures) against its default
    (torch.cholesky_inverse) on SPD blocks of both plants' sizes, float64;
    outside the block the default is taken again."""
    gen = torch.Generator().manual_seed(0)
    for n in (6, 7, 12, 14):
        A = torch.randn(5, 3, n, n, dtype=torch.float64, generator=gen)
        M = A @ A.mT + n * torch.eye(n, dtype=torch.float64)
        want = schur.spd_inv(M)
        with schur.capturable_inverse():
            got = schur.spd_inv(M)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(got @ M, torch.eye(n, dtype=torch.float64).expand_as(M),
                                   rtol=0, atol=1e-12)
        assert torch.equal(schur.spd_inv(M), want)
