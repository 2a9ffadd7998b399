"""The port's mixed-plant fleet (gato_tpu_torch/parallel/fleet.py) and its
example (gato_tpu_torch/examples/mixed_fleet.py) against the JAX package's
(gato_tpu/parallel/fleet.py), on the CPU:

- solve_fleet on identical numpy inputs, float64, an indy7 and an iiwa14
  member at B=2: at N=8 (route "solve", its plain version on the CPU; the
  XLA solver on the JAX side) and at N=130, past the fused kernels'
  horizon, where both members take the staged route (the kkt, pcg and
  merit kernels' plain versions): the whole slice. X, U, lam, rho and the
  statistics with test_torch_solve_xla.py's tolerances (PCG to 1e-12, so
  the Krylov loops stop within 2 iterations of each other);
- fleet_report equal to the JAX package's on the same statistics, with
  the would-be winner's merit poisoned, and with every lane dead;
- the example's main on the CPU at N=8 and past 128 knots;
- solve_fleet(mesh=...) over an in-process gloo group of one rank, and the
  example's --mesh on the CPU (tests/test_torch_sharding.py splits the
  fleet over two ranks).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gato_tpu.parallel import fleet as jfleet
from gato_tpu.solver.types import BSQPSettings as JSettings
from gato_tpu.solver.types import HyperParams as JHyperParams
from gato_tpu_torch.examples import mixed_fleet
from gato_tpu_torch.parallel import fleet
from gato_tpu_torch.parallel.sharding import free_port, make_mesh
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams
from torch_port_helpers import DEFAULT_COST, costs, jax_kkt_in_pieces, models, t64

B, DT, MAX_SQP, MAX_PCG, TOL = 2, 0.01, 2, 1000, 1e-12
PLANTS = ("indy7", "iiwa14")
# the JAX package's gates: its iter_kernel="auto" reads the fused-iteration
# kernel's capacity table, which stops at 128 knots (gato_tpu/ops/
# pallas_iter.py:294 raises past it, gato_tpu/solver/bsqp.py:171), so past
# 128 knots its settings name the route that "auto" takes on the CPU at
# every N, the XLA one: iter_kernel="off"
JAX_GATES = {8: {}, 130: dict(iter_kernel="off")}
STATS = ("sqp_iters", "kkt_converged", "initial_merit", "final_merit", "pcg_iters",
         "ls_min_merit", "ls_step_size")


def _inputs(nq, N, seed):
    nx = 2 * nq
    rng = np.random.default_rng(seed)
    return dict(X=rng.uniform(-0.3, 0.3, (B, N, nx)), U=rng.uniform(-5, 5, (B, N - 1, nq)),
                lam=rng.uniform(-0.1, 0.1, (B, N, nx)), x_s=rng.uniform(-0.3, 0.3, (B, nx)),
                ref=rng.uniform(-0.5, 0.5, (B, N, 6)), f_ext=rng.uniform(-3, 3, (B, 6)))


def _fleets(N):
    """(JAX members, port members) of the same plants and numpy inputs."""
    jmembers, tmembers = [], []
    jcp, tcp = costs(**DEFAULT_COST)
    for seed, robot in enumerate(PLANTS):
        jm, tm = models(robot)
        a = _inputs(tm.nq, N, seed)
        kw = dict(rho=0.01, mu=10.0, pcg_tol=TOL)
        jmembers.append(jfleet.FleetMember(
            name=robot, model=jm, cp=jcp,
            settings=JSettings(N=N, max_sqp_iters=MAX_SQP, max_pcg_iters=MAX_PCG, **JAX_GATES[N]),
            hp=JHyperParams.create(B, dtype=jnp.float64, **kw),
            dt=jnp.float64(DT), **{k: jnp.asarray(v) for k, v in a.items()}))
        tmembers.append(fleet.FleetMember(
            name=robot, model=tm, cp=tcp,
            settings=BSQPSettings(N=N, max_sqp_iters=MAX_SQP, max_pcg_iters=MAX_PCG),
            hp=HyperParams.create(B, dtype=torch.float64, device="cpu", **kw),
            dt=DT, **{k: t64(v) for k, v in a.items()}))
    return jmembers, tmembers


@pytest.mark.parametrize("N", (8, 130))
def test_solve_fleet_matches_the_jax_fleet(N, monkeypatch):
    """Both members' solves, output by output: the port's solve_fleet
    against the JAX package's on identical inputs (float64; the JAX
    solves' per-knot KKT compiled once a plant, jax_kkt_in_pieces)."""
    jax_kkt_in_pieces(monkeypatch)
    jmembers, tmembers = _fleets(N)
    jout, jstats = jfleet.solve_fleet(jmembers)
    tout, tstats = fleet.solve_fleet(tmembers)
    assert [m.name for m in tout] == list(PLANTS)
    for jm, tm, js, ts in zip(jout, tout, jstats, tstats):
        X, U, lam = (getattr(tm, k).numpy() for k in ("X", "U", "lam"))
        np.testing.assert_allclose(X, np.asarray(jm.X), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(U, np.asarray(jm.U), rtol=1e-6, atol=1e-6)
        scale = max(1.0, np.abs(np.asarray(jm.lam)).max())
        assert np.abs(lam - np.asarray(jm.lam)).max() / scale < 1e-6
        np.testing.assert_allclose(tm.hp.rho.numpy(), np.asarray(jm.hp.rho), rtol=1e-12)
        j, t = ({k: np.asarray(getattr(s, k)) for k in STATS} for s in (js, ts))
        for k in ("sqp_iters", "kkt_converged", "ls_step_size"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{tm.name} {k}")
        for k in ("initial_merit", "final_merit", "ls_min_merit"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-8, atol=1e-12,
                                       err_msg=f"{tm.name} {k}")
        assert np.abs(t["pcg_iters"] - j["pcg_iters"]).max() <= 2
        assert (t["pcg_iters"] > 0).all()


@pytest.mark.parametrize("dead", (False, True), ids=("nan_winner", "all_dead"))
def test_fleet_report_matches_the_jax_report(dead):
    """fleet_report on the same statistics as the JAX package's: a fleet
    of two members whose would-be winner's merit is NaN (masked out of
    every argmin), or one whose members' lanes all died (best_merit None,
    the winner's merit None)."""
    # iiwa14's lane 0 (NaN) would win if NaN were not masked
    merits = {"indy7": np.array([2.0, 1.5, 2.5, 3.5]), "iiwa14": np.array([np.nan, 3.0, 4.0])}
    if dead:
        merits = {n: np.full_like(m, np.nan) for n, m in merits.items()}
        merits["iiwa14"][1] = np.inf
    names = [SimpleNamespace(name=n) for n in merits]
    conv = {n: (np.arange(m.size) % 2).astype(np.int32) for n, m in merits.items()}
    iters = {n: np.arange(m.size, dtype=np.int32) + 1 for n, m in merits.items()}
    jstats = [SimpleNamespace(final_merit=jnp.asarray(merits[n]),
                              kkt_converged=jnp.asarray(conv[n]),
                              sqp_iters=jnp.asarray(iters[n])) for n in merits]
    tstats = [SimpleNamespace(final_merit=torch.tensor(merits[n]),
                              kkt_converged=torch.tensor(conv[n]),
                              sqp_iters=torch.tensor(iters[n])) for n in merits]
    want = jfleet.fleet_report(names, jstats)
    got = fleet.fleet_report(names, tstats)
    assert got == want
    assert (got["winner"]["merit"] is None) == dead
    assert got["members"]["indy7"]["all_lanes_dead"] == dead
    if not dead:
        assert (got["winner"]["member"], got["winner"]["lane"]) == ("indy7", 1)


@pytest.mark.parametrize("N", (8, 130))
def test_example_runs_on_the_cpu(N):
    """The example's main (3 cycles, B=2, the plain route on the CPU) at
    its default N=8 and past 128 knots (both members' staged route): both
    members reported with finite merits, finite tracking errors; the
    fleet's CUDA graph asks for the card."""
    out = mixed_fleet.main(cycles=3, B=2, N=N, device="cpu")
    rep = out["final_report"]
    assert set(rep["members"]) == set(PLANTS) and rep["total_lanes"] == 4
    for name in PLANTS:
        assert rep["members"][name]["lanes"] == 2
        assert np.isfinite(rep["members"][name]["best_merit"])
        assert all(np.isfinite(v) for v in out["tracking_err_m"][name].values())
    members = [mixed_fleet.make_member(n, n, q0, off, 2, N, 0.01, 0, amp, device="cpu")
               for n, q0, off, amp in mixed_fleet.SPECS]
    with pytest.raises(ValueError, match="on the card"):
        mixed_fleet.device_cycle_time([m for m, _ in members],
                                      {m.name: t for m, t in members}, N)


def test_mesh_of_one_rank():
    """solve_fleet over a mesh of one gloo rank (its collectives run on a
    group of one) equals the unsharded fleet bit for bit, members placed on
    it; the example's --mesh runs on the CPU in a group of one that it
    makes and leaves."""
    _, tmembers = _fleets(8)
    want, want_stats = fleet.solve_fleet(tmembers)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cpu")
        got, got_stats = fleet.solve_fleet(tmembers, mesh=mesh)
        report = fleet.fleet_report(got, got_stats)
    finally:
        dist.destroy_process_group()
    for w, g, ws, gs in zip(want, got, want_stats, got_stats):
        assert g.mesh == mesh
        for k in ("X", "U", "lam"):
            assert torch.equal(getattr(g, k), getattr(w, k)), k
        assert torch.equal(g.hp.rho, w.hp.rho)
        for k in STATS + ("num_iters_run",):
            assert torch.equal(getattr(gs, k), getattr(ws, k)), k
    assert report == fleet.fleet_report(want, want_stats)
    out = mixed_fleet.cli(["--mesh", "--cycles", "2", "--B", "2", "--device", "cpu"])
    assert out["mesh"] == 1 and not dist.is_initialized()
    assert set(out["final_report"]["members"]) == set(PLANTS)
