"""The plain versions behind the port's staged and fused-iteration routes
against the JAX package, float64 on the CPU, on identical numpy inputs:

- ops/cuda_iter.py::sqp_iter_core_reference (the plain version of the iter
  kernel) against pallas_iter.iter_channels, the TPU kernel's body, run on
  plain arrays as tests/test_pallas_iter.py runs it;
- ops/pcg.py::pcg_solve_batched (the plain version of the pcg kernel) at a
  horizon past 128 knots against pallas_pcg.pcg_channels;
- the KKT assembly against the array-based gato_tpu.ops.kkt.setup_kkt,
  including the terminal knot as the kkt kernel forms it (the per-knot
  trace with the terminal tracking weight);
- solver/bsqp.py::select_route, and the entry points' default device;
- ops/cuda_iter.py::iteration_variant, the iteration kernels' layout by N
  for each plant (indy7, iiwa14), and the variants of the staged KKT
  (ops/cuda_kkt.py, phase A; indy7 only).

PCG runs to 1e-10 here, so the two Krylov loops stop at the same count and
their iterates agree to the tolerance-implied level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.ops import kkt as jkkt
from gato_tpu.ops.kkt_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_iter import iter_channels
from gato_tpu.ops.pallas_pcg import pcg_channels
from gato_tpu_torch.dynamics import codegen
from gato_tpu_torch.interop import model_from_numpy, state_from_numpy
from gato_tpu_torch.ops import cuda_iter, cuda_kkt
from gato_tpu_torch.ops.cuda_iter import (COMPILED_GROUPS, MAX_THREADS,
                                          SHARED_GROUPS, SHARED_MAX_N,
                                          SMEM_LIMIT, iteration_variant,
                                          phase_a_default, smem_bytes,
                                          sqp_iter_core_reference,
                                          warp_threads)
from gato_tpu_torch.ops.kkt_fast import (_mat, _vec,
                                         kkt_knot_channels_structured,
                                         setup_kkt_batched)
from gato_tpu_torch.ops.merit_fast import _get_cd
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from gato_tpu_torch.ops.schur import build_schur
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import select_route
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams
from torch_port_helpers import (DEFAULT_COST, _bcast_chan, _to_chan, costs,
                                jit_per_sample, models, t64)

B, DT, TOL = 3, 0.01, 1e-10


def _problem(N, seed):
    rng = np.random.default_rng(seed)
    return dict(X=rng.uniform(-0.3, 0.3, (B, N, 12)),
                U=rng.uniform(-5, 5, (B, N - 1, 6)),
                x_s=rng.uniform(-0.3, 0.3, (B, 12)),
                ref=rng.uniform(-0.5, 0.5, (B, N, 6)),
                f_ext=rng.uniform(-3, 3, (B, 6)),
                lam=rng.uniform(-0.1, 0.1, (B, N, 12)),
                rho=np.array([1e-3, 3e-2, 1e-1]))


@pytest.fixture(scope="module")
def pair():
    jm, tm = models("indy7")
    jcp, tcp = costs(**DEFAULT_COST)
    return jm, tm, jcp, tcp


def _unchan(chs, knots):
    """list of (S, L) channels -> (B, knots, C) numpy."""
    return np.stack([np.asarray(c) for c in chs], -1)[:B, :knots]


def test_iter_core_matches_iter_channels(pair):
    """dZX, dZU, lam and the PCG counts of one fused-iteration core; lane 1
    is skipped (keeps its warm-start duals, 0 iterations)."""
    jm, tm, jcp, tcp = pair
    N = 12
    p = _problem(N, 3)
    S, L = B + 1, N + 5
    skip = np.array([False, True, False])
    tol = np.full(B, TOL)
    dzx_j, dzu_j, lam_j, it_j = iter_channels(
        jax_get_cd(jm.key), jm.key, jcp, N, 500, 2, jnp.asarray(DT),
        _to_chan(p["X"], S, L), _to_chan(p["U"], S, L),
        _bcast_chan(p["x_s"], S, L), _to_chan(p["ref"][:, :, :3], S, L),
        _bcast_chan(p["f_ext"], S, L), _to_chan(p["lam"], S, L),
        _bcast_chan(p["rho"][:, None], S, L)[0],
        _bcast_chan(tol[:, None], S, L)[0],
        _bcast_chan(skip[:, None].astype(np.float64), S, L)[0],
        _to_chan(p["X"], S, L)[0])
    dzx, dzu, lam, iters = sqp_iter_core_reference(
        tm, tcp, *(t64(p[k]) for k in ("X", "U", "x_s", "ref", "f_ext", "lam",
                                       "rho")),
        t64(tol), torch.tensor(skip), DT, 500)
    np.testing.assert_array_equal(iters.numpy(),
                                  np.asarray(it_j[0])[:B, 0].astype(int))
    assert iters[1] == 0 and (iters[[0, 2]] > 0).all()
    np.testing.assert_array_equal(lam.numpy()[1], p["lam"][1])
    for port, jax_ch, knots in ((dzx, dzx_j, N), (dzu, dzu_j, N - 1),
                                (lam, lam_j, N)):
        ref = _unchan(jax_ch, knots)
        scale = max(1.0, np.abs(ref).max())
        assert np.abs(port.numpy() - ref).max() / scale < 1e-8


def test_pcg_past_128_knots_matches_pcg_channels(pair):
    """N = 130, past the fused kernels' horizon: a real Schur system from
    the plain KKT; lane 0's warm start holds a NaN (no iterations, reports
    max_iters, keeps its warm start), lane 2 is skipped."""
    jm, tm, jcp, tcp = pair
    N, nx, max_iters = 130, 12, 400
    p = _problem(N, 5)
    kkt = setup_kkt_batched(tm, tcp, *(t64(p[k]) for k in (
        "X", "U", "x_s", "ref", "f_ext")), DT)
    sch = build_schur(kkt, t64(p["rho"]), 6)
    mats = [getattr(sch, f).numpy() for f in ("S_main", "S_lower", "P_main",
                                              "P_lower")]
    gamma = sch.gamma.numpy()
    lam0 = p["lam"].copy()
    lam0[0, 77, 4] = np.nan
    skip = np.array([False, False, True])
    eps = np.full(B, TOL)

    lam, iters = pcg_solve_batched(*(t64(m) for m in mats), t64(gamma),
                                   t64(lam0), t64(eps), max_iters,
                                   torch.tensor(skip))

    S, L = B + 1, N + 6
    valid = np.zeros((S, L))
    valid[:, :N] = 1.0

    def chans(m):
        return _to_chan(m.reshape(B, m.shape[1], nx * nx), S, L)

    lam_j, it_j = jax.jit(lambda *a: pcg_channels(nx, max_iters, *a))(
        *(chans(m) for m in mats), _to_chan(gamma, S, L), _to_chan(lam0, S, L),
        _bcast_chan(eps[:, None], S, L)[0],
        _bcast_chan(skip[:, None].astype(np.float64), S, L)[0],
        jnp.asarray(valid))
    it_j = np.asarray(it_j)[:B, 0].astype(int)
    np.testing.assert_array_equal(iters.numpy(), it_j)
    assert iters[0] == max_iters and iters[2] == 0 and 0 < iters[1] < max_iters
    lam_j = _unchan(lam_j, N)
    np.testing.assert_array_equal(lam.numpy()[[0, 2]], lam0[[0, 2]])
    scale = max(1.0, np.abs(lam_j[1]).max())
    assert np.abs(lam.numpy()[1] - lam_j[1]).max() / scale < 1e-8


def test_kkt_assembly_and_terminal_fold_match_setup_kkt(pair):
    """The plain KKT setup against the array path, every tensor; and the
    terminal knot formed as the kkt kernel forms it (the non-terminal trace
    with tracking weight N_cost, zero control and successor) against the
    array path's terminal Q and q."""
    jm, tm, jcp, tcp = pair
    N = 9
    p = _problem(N, 7)
    jk = jit_per_sample(lambda X, U, xs, r, fe: jkkt.setup_kkt(
        jm, jcp, X, U, xs, r, fe, DT))(*(jnp.asarray(p[k]) for k in (
            "X", "U", "x_s", "ref", "f_ext")))
    tk = setup_kkt_batched(tm, tcp, *(t64(p[k]) for k in (
        "X", "U", "x_s", "ref", "f_ext")), DT)
    # the array path differentiates the dynamics with jax.jacfwd, the
    # trace with sparse duals: float64 roundoff, scaled by each tensor
    for f in ("Q", "q", "R", "r", "A", "B", "c"):
        ref = np.asarray(getattr(jk, f))
        np.testing.assert_allclose(getattr(tk, f).numpy(), ref, rtol=1e-7,
                                   atol=1e-8 * np.abs(ref).max(), err_msg=f)

    xT = t64(p["X"][:, -1])
    zeros = [torch.zeros(B, dtype=torch.float64)] * 12
    _, _, _, Q, qv, _, _ = kkt_knot_channels_structured(
        _get_cd(tm.key), tm.key, tcp, [xT[:, i] for i in range(6)],
        [xT[:, 6 + i] for i in range(6)], zeros[:6], zeros,
        [t64(p["ref"][:, -1, i]) for i in range(3)],
        [t64(p["f_ext"][:, i]) for i in range(6)], DT, 2, xT[:, 0],
        w_track=tcp.N_cost)
    for port, ref in ((_mat(Q, xT[:, 0]), jk.Q[:, -1]),
                      (_vec(qv, xT[:, 0]), jk.q[:, -1])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())


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


def test_entry_points_default_to_the_card():
    """Without a device argument the entry points build CUDA tensors; with
    no card they raise and say how to ask for the CPU, never returning CPU
    tensors that would quietly take the plain route."""
    jm, _ = models("indy7")
    arrays = {f: np.asarray(getattr(jm, f)) for f in (
        "R_tree", "p_tree", "axis", "inertia", "joint_limits",
        "velocity_limits", "effort_limits", "R_ee", "p_ee", "gravity")}
    state = [np.zeros((1, 4, 12))] * 3 + [np.zeros((1, 12))] * 3 + [np.ones(1)] * 4
    calls = (lambda: load_robot("indy7").R_tree,
             lambda: HyperParams.create(4).rho,
             lambda: model_from_numpy("indy7", arrays).R_tree,
             lambda: state_from_numpy(*state)[0])
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    assert load_robot("indy7", device="cpu").R_tree.device.type == "cpu"


# per plant state size nx: the last N where the shared layout fits at
# G = 1, and the global layout's bytes at N = 32, 64, 128
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
    assert cuda_kkt.VARIANTS == (("staged", cuda_kkt.KKT_GROUPS), ("one", 1))
    with open(codegen.header_path("indy7")) as f:
        header = f.read()
    for g in splits:
        assert f"constexpr int KKT_DIRS_G{g}[{g}][NX]" in header
    assert "#define GATO_KKT_STAGES 1" in header
    with open(codegen.header_path("iiwa14")) as f:
        header = f.read()
    assert codegen.KKT_SPLITS["iiwa14"] == ()
    assert "KKT_DIRS_G" not in header and "GATO_KKT_STAGES" not in header
    assert cuda_kkt._variant_code(("one", 1)) == 0
    assert cuda_kkt._variant_code(("staged", 2)) == 2
    for bad in (("staged", 4), ("staged", 6), ("one", 4), ("global", 1)):
        with pytest.raises(ValueError, match="not compiled"):
            cuda_kkt._variant_code(bad)
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
