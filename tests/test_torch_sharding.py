"""The port's batch sharding (gato_tpu_torch/parallel/sharding.py) and
solve_fleet(mesh=...) on the CPU, against the port's unsharded solve and the
JAX package's (gato_tpu/parallel/sharding.py's contract: the sharded solve
equals the unsharded one of the whole batch).

Two ranks over gloo, spawned once for the file with torch.multiprocessing
from tests/torch_shard_worker.py (no worker imports jax), each take their
half of the same global inputs, made here with numpy from a seed; rank 0
gathers. While they run, this process solves the whole batch with the
port and with the JAX package (float64; the JAX solve's KKT and merit in
pieces, tests/torch_port_helpers.py::jax_kkt_in_pieces). The shape is
tests/test_sharding.py's: indy7, N=8, B=16, 2 SQP iterations, PCG <= 25,
with distinct warm starts, wrenches and rho a lane (__graft_entry__.py:80-97).

- the gathered lanes equal the unsharded solve's bit for bit on routes
  "solve" and "iter" (the plain versions on the CPU), and that solve meets
  the JAX solve at tests/test_torch_solve_xla.py's tolerances;
- an exit that fires on the global count where the ranks' local counts
  would decide differently (tests/test_sharding.py's scenario: rank 0's
  lanes enter converged, rank 1's are hard): iterations and stats equal the
  JAX package's unsharded solve of the whole batch;
- best_lane with a NaN lane on rank 1 equals the JAX best_lane;
- shard_solve_args' lanes, and its raise where the ranks do not divide B;
- solve_fleet(mesh=...) of an indy7 and an iiwa14 member equals the
  unsharded fleet, and its report is the JAX fleet_report of the whole
  batch.
"""

import os
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_shard_worker as worker
from gato_tpu.parallel import fleet as jfleet
from gato_tpu.parallel.sharding import best_lane as jax_best_lane
from gato_tpu.solver.bsqp import solve_batched_jit
from gato_tpu.solver.types import BSQPSettings as JSettings
from gato_tpu.solver.types import HyperParams as JHyperParams
from gato_tpu_torch.parallel import fleet
from gato_tpu_torch.parallel.sharding import Mesh, free_port, shard_solve_args
from gato_tpu_torch.robots.model import load_robot
from torch_port_helpers import DEFAULT_COST, costs, jax_kkt_in_pieces, models

WORLD, B, N = 2, 16, 8
Q0 = (-1.0966, -0.099, 0.8313, -0.109, 0.497, 0.015)
JOIN_TIMEOUT = 300


def _problem(rng=None):
    """tests/test_sharding.py's problem at B, N (float64): every lane at Q0
    at rest, PCG to 1e-4; with rng, __graft_entry__.py's distinct lanes
    (perturbed warm starts, wrenches and rho), PCG to 1e-12."""
    x0 = np.concatenate([Q0, np.zeros(6)])
    a = dict(X=np.tile(x0, (B, N, 1)), U=np.zeros((B, N - 1, 6)), lam=np.zeros((B, N, 12)),
             x_s=np.tile(x0, (B, 1)), ref=np.tile([-0.3, 0.3, 0.95, 0, 0, 0], (B, N, 1)),
             f_ext=np.zeros((B, 6)), rho=np.full(B, 0.01), drho=np.ones(B),
             mu=np.full(B, 10.0), pcg_tol=np.full(B, 1e-4))
    if rng is not None:
        # PCG to 1e-12 (tests/test_torch_solve_xla.py): the Krylov loops of
        # the two packages then stop within 2 iterations of each other
        a["pcg_tol"] = np.full(B, 1e-12)
        a["rho"] = rng.uniform(1e-3, 1e-1, B)
        a["X"] = a["X"] + rng.uniform(-0.05, 0.05, a["X"].shape)
        a["X"][:, 0] = a["x_s"]
        a["f_ext"] = rng.uniform(-5, 5, (B, 6))
    return a


def _case(arrays, max_sqp_iters, max_pcg_iters, solve_ratio=1.0):
    return dict(arrays=arrays, max_sqp_iters=max_sqp_iters, max_pcg_iters=max_pcg_iters,
                solve_ratio=solve_ratio)


def _exit_case(model):
    """tests/test_sharding.py's exit scenario: the first half of the lanes
    pre-solved to the KKT point (the rho schedule carried; 40 iterations in
    float64, where the JAX test's 24 in float32 leave PCG work) so they
    enter converged, the second half under strong wrenches; the exit at
    solve_ratio 0.5."""
    a = _problem()
    warm = worker.solved(model, worker.settings(_case(a, 40, 100)), worker.tensors(a))
    half = B // 2
    for k in ("X", "U", "lam", "rho"):
        a[k][:half] = warm[k][:half]
    a["X"][:, 0] = a["x_s"]
    a["f_ext"][half:] = np.random.default_rng(5).uniform(-40, 40, (B - half, 6))
    return _case(a, 3, 100, solve_ratio=0.5)


def _fleet_cases():
    """{plant: case} of two members, B=4 each (test_torch_fleet.py's inputs)."""
    out = {}
    for seed, (plant, nq) in enumerate((("indy7", 6), ("iiwa14", 7))):
        nx, b = 2 * nq, 4
        rng = np.random.default_rng(seed)
        a = dict(X=rng.uniform(-0.3, 0.3, (b, N, nx)), U=rng.uniform(-5, 5, (b, N - 1, nq)),
                 lam=rng.uniform(-0.1, 0.1, (b, N, nx)), x_s=rng.uniform(-0.3, 0.3, (b, nx)),
                 ref=rng.uniform(-0.5, 0.5, (b, N, 6)), f_ext=rng.uniform(-3, 3, (b, 6)),
                 rho=np.full(b, 0.01), drho=np.ones(b), mu=np.full(b, 10.0),
                 pcg_tol=np.full(b, 1e-4))
        out[plant] = _case(a, 2, 25)
    return out


def _jax_solve(case, jm, jcp):
    a = case["arrays"]
    st = JSettings(N=N, max_sqp_iters=case["max_sqp_iters"],
                   max_pcg_iters=case["max_pcg_iters"], solve_ratio=case["solve_ratio"])
    hp = JHyperParams(*(jnp.asarray(a[k]) for k in ("rho", "drho", "mu", "pcg_tol")))
    Xo, Uo, lam_o, hpo, stats = solve_batched_jit(
        jm, st, jcp, hp, *(jnp.asarray(a[k]) for k in ("X", "U", "lam", "x_s", "ref", "f_ext")),
        jnp.float64(worker.DT))
    out = {k: np.asarray(v) for k, v in dict(X=Xo, U=Uo, lam=lam_o, rho=hpo.rho).items()}
    out.update({k: np.asarray(getattr(stats, k)) for k in worker.STATS})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' gathered outputs, the port's unsharded solves and the
    JAX solves of the same inputs."""
    model = load_robot("indy7", torch.float64, "cpu")
    inputs = dict(main=_case(_problem(np.random.default_rng(3)), 2, 25),
                  exit=_exit_case(model), fleet=_fleet_cases(),
                  # rank 1's lane 5 (NaN) would win if NaN were not masked
                  best=np.array([2.0, 1.5, 2.5, 3.5, 4.0, np.nan, 3.0, 1.75]))
    path = str(tmp_path_factory.mktemp("sharded") / "rank0.pt")
    ctx = mp.start_processes(worker.run, args=(WORLD, free_port(), inputs, path),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        port = {"main": {route: worker.solved(model, worker.settings(inputs["main"], gates),
                                              worker.tensors(inputs["main"]["arrays"]))
                         for route, gates in worker.GATES.items()},
                "exit": worker.solved(model, worker.settings(inputs["exit"]),
                                      worker.tensors(inputs["exit"]["arrays"]))}
        members, stats = fleet.solve_fleet(worker.fleet_members(inputs["fleet"]))
        port["fleet"], port["fleet_report"] = worker.fleet_outputs(members, stats)
        jm, _ = models("indy7")
        jcp, _ = costs(**DEFAULT_COST)
        with pytest.MonkeyPatch.context() as mpatch:
            jax_kkt_in_pieces(mpatch)
            jax = {k: _jax_solve(inputs[k], jm, jcp) for k in ("main", "exit")}
        deadline = time.monotonic() + JOIN_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish in {JOIN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert os.path.exists(path), "rank 0 saved nothing"
    sharded = torch.load(path, weights_only=False)  # this file's own worker wrote it
    return inputs, sharded, port, jax


def _equal(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("route", tuple(worker.GATES))
def test_sharded_solve_equals_unsharded(runs, route):
    """Two ranks' gathered lanes equal the unsharded solve of the whole
    batch bit for bit: the lanes are independent, and the exit and the
    iterations run are the global ones."""
    _, sharded, port, _ = runs
    got, want = sharded["main"][route], port["main"][route]
    _equal(got, want, ("X", "U", "lam", "rho") + worker.STATS)
    assert np.isfinite(got["X"]).all() and (got["pcg_iters"] > 0).any()


def test_unsharded_solve_meets_the_jax_solve(runs):
    """The port's solve of the whole batch (route "solve") against the
    JAX package's on the same inputs, with test_torch_solve_xla.py's
    tolerances, but for the merits after the second iteration: 1e-7, not
    1e-8. With u_cost 2e-6 the KKT system is ill-conditioned, and the
    trajectories already differ by about 3e-9 after the first iteration
    with equal PCG counts on every lane; the merit's defect term (mu = 10
    times an L1 norm) carries that into the final merits at about 5e-8
    relative, the same with the JAX solve inlined (not in pieces)."""
    _, _, port, jax = runs
    p, j = port["main"]["solve"], jax["main"]
    np.testing.assert_allclose(p["X"], j["X"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(p["U"], j["U"], rtol=1e-6, atol=1e-6)
    assert np.abs(p["lam"] - j["lam"]).max() / max(1.0, np.abs(j["lam"]).max()) < 1e-6
    np.testing.assert_allclose(p["rho"], j["rho"], rtol=1e-12)
    np.testing.assert_allclose(p["initial_merit"], j["initial_merit"], rtol=1e-8)
    np.testing.assert_allclose(p["ls_min_merit"][0], j["ls_min_merit"][0], rtol=1e-8)
    np.testing.assert_allclose(p["final_merit"], j["final_merit"], rtol=1e-7)
    np.testing.assert_allclose(p["ls_min_merit"], j["ls_min_merit"], rtol=1e-7)
    _equal(p, j, ("kkt_converged", "sqp_iters", "ls_step_size", "num_iters_run"))
    assert np.abs(p["pcg_iters"] - j["pcg_iters"]).max() <= 2


def test_exit_on_the_global_count(runs):
    """The exit fires on the global converged count: rank 0's lanes enter
    converged and alone would exit at once, rank 1's alone would run on;
    the sharded solve stops where the JAX package's unsharded solve of the
    whole batch does, with its statistics."""
    inputs, sharded, port, jax = runs
    got, j = sharded["exit"], jax["exit"]
    case = inputs["exit"]
    assert int(j["num_iters_run"]) < case["max_sqp_iters"]
    assert int(j["kkt_converged"].sum()) < B
    # rank 1's lanes alone would decide otherwise
    half = {k: v[B // 2:] for k, v in case["arrays"].items()}
    alone = worker.solved(load_robot("indy7", torch.float64, "cpu"),
                          worker.settings(dict(case, arrays=half)), worker.tensors(half))
    assert int(alone["num_iters_run"]) > int(got["num_iters_run"])
    _equal(got, port["exit"], ("X", "U", "lam", "rho") + worker.STATS)
    _equal(got, j, ("num_iters_run", "sqp_iters", "kkt_converged", "ls_step_size"))
    np.testing.assert_allclose(got["X"], j["X"], rtol=1e-6, atol=1e-8)
    for k in ("initial_merit", "final_merit"):
        np.testing.assert_allclose(got[k], j[k], rtol=1e-8, err_msg=k)


def test_best_lane_masks_a_nan_lane_on_rank_1(runs):
    """best_lane over both ranks' merits, rank 1 holding a NaN lane that
    an unmasked argmin would pick, equals the JAX best_lane on the same
    merits."""
    inputs, sharded, _, _ = runs
    want = int(jax_best_lane(jnp.asarray(inputs["best"])))
    assert sharded["best"] == want == 1


def test_shard_solve_args_lanes_and_raise():
    """Rank r of W takes lanes [r B/W, (r+1) B/W) of every batch-leading
    argument and of the hyperparameters; W must divide B."""
    args = worker.tensors(_problem(np.random.default_rng(0)))
    for r in range(4):
        mesh = Mesh(group=None, rank=r, world=4, device=torch.device("cpu"))
        got = shard_solve_args(mesh, *args)
        lo = r * B // 4
        for g, a in zip(got[:6], args[:6]):
            assert torch.equal(g, a[lo:lo + B // 4]) and g.is_contiguous()
        for name in ("rho", "drho", "mu", "pcg_tol"):
            assert torch.equal(getattr(got[6], name), getattr(args[6], name)[lo:lo + B // 4])
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        shard_solve_args(Mesh(None, 0, 3, torch.device("cpu")), *args)


def test_solve_fleet_on_a_mesh(runs):
    """solve_fleet(mesh=...) of an indy7 and an iiwa14 member over two
    ranks equals the unsharded fleet bit for bit, member by member, and
    its report (every lane gathered) is the JAX fleet_report of the whole
    batch's statistics, the winner with it."""
    _, sharded, port, _ = runs
    for plant in ("indy7", "iiwa14"):
        _equal(sharded["fleet"][plant], port["fleet"][plant],
               ("X", "U", "lam", "rho") + worker.STATS)
    names = [SimpleNamespace(name=plant) for plant in ("indy7", "iiwa14")]
    jstats = [SimpleNamespace(**{k: jnp.asarray(port["fleet"][n.name][k]) for k in (
        "final_merit", "kkt_converged", "sqp_iters")}) for n in names]
    want = jfleet.fleet_report(names, jstats)
    assert sharded["fleet_report"] == port["fleet_report"] == want
