"""The plain versions behind the port's staged and fused-iteration routes
against the JAX package, float64 on the CPU, on identical numpy inputs:

- ops/cuda_iter.py::sqp_iter_core_reference (the plain version of the iter
  kernel) against pallas_iter.iter_channels, the TPU kernel's body, run on
  plain arrays as tests/test_pallas_iter.py runs it;
- ops/pcg.py::pcg_solve_batched (the plain version of the pcg kernel) at a
  horizon past 128 knots against pallas_pcg.pcg_channels, for each plant
  the pcg kernel is built for (indy7, iiwa14);
- the KKT assembly against the array-based gato_tpu.ops.kkt.setup_kkt,
  including the terminal knot as the kkt kernel forms it (the per-knot
  trace with the terminal tracking weight), for each plant;
- the entry points' default device (the solver's, and the estimator's and
  the merit's).

The routes and the kernels' variants, which need no JAX, are held in
tests/test_torch_variants.py.

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
from gato_tpu_torch.api.force_estimator_device import fe_init
from gato_tpu_torch.interop import model_from_numpy, state_from_numpy
from gato_tpu_torch.ops.cuda_iter import sqp_iter_core_reference
from gato_tpu_torch.ops.kkt_fast import (_mat, _vec,
                                         kkt_knot_channels_structured,
                                         setup_kkt_batched)
from gato_tpu_torch.ops.merit import default_alphas
from gato_tpu_torch.ops.merit_fast import _get_cd
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from gato_tpu_torch.ops.schur import build_schur
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.types import HyperParams
from torch_port_helpers import (DEFAULT_COST, _bcast_chan, _to_chan, costs,
                                jax_kkt_in_pieces, jit_per_sample, models, t64)

B, DT, TOL = 3, 0.01, 1e-10
PLANTS = ("indy7", "iiwa14")


def _problem(N, seed, nq=6):
    nx = 2 * nq
    rng = np.random.default_rng(seed)
    return dict(X=rng.uniform(-0.3, 0.3, (B, N, nx)),
                U=rng.uniform(-5, 5, (B, N - 1, nq)),
                x_s=rng.uniform(-0.3, 0.3, (B, nx)),
                ref=rng.uniform(-0.5, 0.5, (B, N, 6)),
                f_ext=rng.uniform(-3, 3, (B, 6)),
                lam=rng.uniform(-0.1, 0.1, (B, N, nx)),
                rho=np.array([1e-3, 3e-2, 1e-1]))


@pytest.fixture(scope="module")
def pairs():
    """{plant: (JAX model, port model, JAX costs, port costs)}, each made
    when a test first asks."""
    cache = {}

    def get(robot):
        if robot not in cache:
            cache[robot] = models(robot) + costs(**DEFAULT_COST)
        return cache[robot]
    return get


@pytest.fixture(scope="module")
def pair(pairs):
    return pairs("indy7")


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


@pytest.mark.parametrize("robot", PLANTS)
def test_pcg_past_128_knots_matches_pcg_channels(pairs, robot):
    """N = 130, past the fused kernels' horizon, for each plant the pcg
    kernel is built for (nx = 12, 14): a real Schur system from the plain
    KKT; lane 0's warm start holds a NaN (no iterations, reports max_iters,
    keeps its warm start), lane 2 is skipped."""
    jm, tm, jcp, tcp = pairs(robot)
    N, nq, max_iters = 130, tm.nq, 400
    nx = 2 * nq
    p = _problem(N, 5, nq)
    kkt = setup_kkt_batched(tm, tcp, *(t64(p[k]) for k in (
        "X", "U", "x_s", "ref", "f_ext")), DT)
    sch = build_schur(kkt, t64(p["rho"]), nq)
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


@pytest.mark.parametrize("robot", PLANTS)
def test_kkt_assembly_and_terminal_fold_match_setup_kkt(pairs, robot, monkeypatch):
    """The plain KKT setup against the array path, every tensor; and the
    terminal knot formed as the kkt kernel forms it (the non-terminal trace
    with tracking weight N_cost, zero control and successor) against the
    array path's terminal Q and q; for each plant the kkt kernel is built
    for. The array path's per-knot pieces are compiled once each
    (jax_kkt_in_pieces)."""
    jax_kkt_in_pieces(monkeypatch)
    jm, tm, jcp, tcp = pairs(robot)
    N, nq = 9, tm.nq
    p = _problem(N, 7, nq)
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
    zeros = [torch.zeros(B, dtype=torch.float64)] * (2 * nq)
    _, _, _, Q, qv, _, _ = kkt_knot_channels_structured(
        _get_cd(tm.key), tm.key, tcp, [xT[:, i] for i in range(nq)],
        [xT[:, nq + i] for i in range(nq)], zeros[:nq], zeros,
        [t64(p["ref"][:, -1, i]) for i in range(3)],
        [t64(p["f_ext"][:, i]) for i in range(6)], DT, 2, xT[:, 0],
        w_track=tcp.N_cost)
    for port, ref in ((_mat(Q, xT[:, 0]), jk.Q[:, -1]),
                      (_vec(qv, xT[:, 0]), jk.q[:, -1])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())


def _solver_entry_points():
    jm, _ = models("indy7")
    arrays = {f: np.asarray(getattr(jm, f)) for f in (
        "R_tree", "p_tree", "axis", "inertia", "joint_limits",
        "velocity_limits", "effort_limits", "R_ee", "p_ee", "gravity")}
    state = [np.zeros((1, 4, 12))] * 3 + [np.zeros((1, 12))] * 3 + [np.ones(1)] * 4
    return ((lambda: load_robot("indy7").R_tree,
             lambda: HyperParams.create(4).rho,
             lambda: model_from_numpy("indy7", arrays).R_tree,
             lambda: state_from_numpy(*state)[0]),
            lambda: load_robot("indy7", device="cpu").R_tree)


def _estimator_entry_points():
    return ((lambda: fe_init(10.0).estimate, lambda: default_alphas(8)),
            lambda: fe_init(10.0, device="cpu").rotation)


@pytest.mark.parametrize("calls", (_solver_entry_points, _estimator_entry_points),
                         ids=("solver", "estimator"))
def test_entry_points_default_to_the_card(calls):
    """Without a device argument the entry points build CUDA tensors; with
    no card they raise and say how to ask for the CPU, never returning CPU
    tensors that would quietly take the plain route: the solver's
    (load_robot, HyperParams.create, interop) and the wrench estimator's
    and the merit's (fe_init, default_alphas)."""
    defaults, on_cpu = calls()
    for call in defaults:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    assert on_cpu().device.type == "cpu"
