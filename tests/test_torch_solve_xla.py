"""The port's batched SQP solve (CPU route) against the JAX XLA solver path,
gato_tpu.solver.bsqp.solve_batched_jit, float64, at the fixture of
tests/test_pallas_solve.py (B=3, N=12), with that test's tolerances.

Each test runs on the port's three routes (solver/bsqp.py::select_route:
the whole-iteration kernel's, the fused-iteration and the staged one), which
run their kernels' plain versions on the CPU. One XLA compile serves every
indy7 case: the 3-iteration solve is compared output by output, and its
first iteration's statistics are compared with the port's 1-iteration solve
(the merit after one accepted step, the PCG count, the step and the
warm-start merit). The 3-iteration comparison also runs iiwa14 on the
fused-iteration route (solve_kernel="off", the iter and merit kernels'
plain versions; a second XLA compile, the solve for iiwa14).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu.solver.bsqp import solve_batched_jit
from gato_tpu.solver.types import BSQPSettings as JSettings
from gato_tpu.solver.types import HyperParams as JHyperParams
from gato_tpu_torch.interop import state_from_numpy
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings
from torch_port_helpers import DEFAULT_COST, costs, models

B, N, DT, MAX_PCG = 3, 12, 0.01, 500
# (solve_kernel, iter_kernel) of the routes "solve", "iter" and "staged"
ROUTES = [("auto", "auto"), ("off", "auto"), ("off", "off")]
# (plant, route) of the 3-iteration comparison
CASES = [("indy7", g) for g in ROUTES] + [("iiwa14", ("off", "auto"))]


@pytest.fixture(scope="module")
def solved():
    """{plant: (the XLA solver's 3-iteration outputs, port(max_sqp_iters,
    gates))}, each plant's solve compiled when a test first asks."""
    cache = {}

    def get(robot):
        if robot not in cache:
            cache[robot] = _solved(robot)
        return cache[robot]
    return get


def _solved(robot):
    jm, tm = models(robot)
    nq = jm.nq
    jcp, tcp = costs(**DEFAULT_COST)
    rng = np.random.default_rng(7)
    a = dict(
        X=rng.uniform(-0.3, 0.3, (B, N, 2 * nq)), U=rng.uniform(-5, 5, (B, N - 1, nq)),
        x_s=rng.uniform(-0.3, 0.3, (B, 2 * nq)), ref=rng.uniform(-0.5, 0.5, (B, N, 6)),
        f_ext=rng.uniform(-3, 3, (B, 6)), lam=rng.uniform(-0.1, 0.1, (B, N, 2 * nq)))
    hp = JHyperParams.create(B, rho=0.01, mu=10.0, pcg_tol=1e-12,
                             dtype=jnp.float64)
    Xo, Uo, lam_o, hpo, stats = solve_batched_jit(
        jm, JSettings(N=N, max_sqp_iters=3, max_pcg_iters=MAX_PCG), jcp, hp,
        *(jnp.asarray(a[k]) for k in ("X", "U", "lam", "x_s", "ref", "f_ext")),
        jnp.float64(DT))
    xla = dict(X=Xo, U=Uo, lam=lam_o, rho=hpo.rho, conv=stats.kkt_converged,
               merit0=stats.initial_merit, merit_final=stats.final_merit,
               sqp_iters=stats.sqp_iters, pcg_iters=stats.pcg_iters,
               ls_merit=stats.ls_min_merit, ls_step=stats.ls_step_size)
    xla = {k: np.asarray(v) for k, v in xla.items()}

    def port(max_sqp_iters, gates):
        X, U, lam, x_s, ref, fe, thp = state_from_numpy(
            a["X"], a["U"], a["lam"], a["x_s"], a["ref"], a["f_ext"],
            np.asarray(hp.rho), np.asarray(hp.drho), np.asarray(hp.mu),
            np.asarray(hp.pcg_tol), device="cpu")
        st = BSQPSettings(N=N, max_sqp_iters=max_sqp_iters,
                          max_pcg_iters=MAX_PCG, solve_kernel=gates[0],
                          iter_kernel=gates[1])
        Xo, Uo, lam_o, hpo, stats = solve_batched(tm, st, tcp, thp, X, U, lam,
                                                  x_s, ref, fe, DT)
        return dict(X=Xo, U=Uo, lam=lam_o, rho=hpo.rho,
                    conv=stats.kkt_converged, merit0=stats.initial_merit,
                    merit_final=stats.final_merit, sqp_iters=stats.sqp_iters,
                    pcg_iters=stats.pcg_iters, ls_merit=stats.ls_min_merit,
                    ls_step=stats.ls_step_size)

    return xla, port


@pytest.mark.parametrize("robot,gates", CASES)
def test_solve_matches_xla_solver_3_iterations(solved, robot, gates):
    xla, port = solved(robot)
    p = {k: v.numpy() for k, v in port(3, gates).items()}
    np.testing.assert_allclose(p["X"], xla["X"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(p["U"], xla["U"], rtol=1e-6, atol=1e-6)
    scale = max(1.0, np.abs(xla["lam"]).max())
    assert np.abs(p["lam"] - xla["lam"]).max() / scale < 1e-6
    np.testing.assert_allclose(p["rho"], xla["rho"], rtol=1e-12)
    np.testing.assert_allclose(p["merit0"], xla["merit0"], rtol=1e-8)
    np.testing.assert_allclose(p["merit_final"], xla["merit_final"], rtol=1e-8)
    np.testing.assert_array_equal(p["conv"], xla["conv"])
    np.testing.assert_array_equal(p["sqp_iters"], xla["sqp_iters"])
    assert np.abs(p["pcg_iters"] - xla["pcg_iters"]).max() <= 2
    np.testing.assert_allclose(p["ls_merit"], xla["ls_merit"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_array_equal(p["ls_step"], xla["ls_step"])


@pytest.mark.parametrize("gates", ROUTES)
def test_solve_1_iteration_matches_xla_first_iteration(solved, gates):
    xla, port = solved("indy7")
    p = {k: v.numpy() for k, v in port(1, gates).items()}
    np.testing.assert_allclose(p["merit0"], xla["merit0"], rtol=1e-8)
    # one accepted step: the final merit is the first line search's merit
    np.testing.assert_allclose(p["merit_final"], xla["ls_merit"][0], rtol=1e-8)
    np.testing.assert_allclose(p["ls_merit"][0], xla["ls_merit"][0], rtol=1e-8)
    np.testing.assert_array_equal(p["ls_step"][0], xla["ls_step"][0])
    assert np.abs(p["pcg_iters"][0] - xla["pcg_iters"][0]).max() <= 2
    np.testing.assert_array_equal(p["sqp_iters"], np.ones(B))
