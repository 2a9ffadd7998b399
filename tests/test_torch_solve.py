"""The port's batched SQP solve on the CPU route (sqp_solve_chained over
sqp_iter_reference, through solver.bsqp.solve_batched) against the JAX
whole-solve kernel body gato_tpu.ops.pallas_solve.solve_channels on plain
arrays, float64, at the fixture of tests/test_pallas_solve.py (B=3, N=12).
Tolerances are those of tests/test_pallas_solve.py: PCG runs to 1e-12, so
the dual solves agree to roundoff and the line searches pick identical
alphas. The CUDA kernel csrc/bsqp_iter.cu is held to its plain version in
tests/test_torch_cuda.py, on the card.
"""

import numpy as np
import pytest
import torch

from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
from gato_tpu_torch.ops.schur import build_schur
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings
from gato_tpu_torch.interop import state_from_numpy
from torch_port_helpers import DEFAULT_COST, costs, models, run_solve_channels

B, N, DT = 3, 12, 0.01
MAX_PCG = 500


@pytest.fixture(scope="module")
def problem():
    jm, tm = models("indy7")
    jcp, tcp = costs(**DEFAULT_COST)
    rng = np.random.default_rng(7)
    arrays = dict(
        X=rng.uniform(-0.3, 0.3, (B, N, 12)), U=rng.uniform(-5, 5, (B, N - 1, 6)),
        x_s=rng.uniform(-0.3, 0.3, (B, 12)), ref=rng.uniform(-0.5, 0.5, (B, N, 6)),
        f_ext=rng.uniform(-3, 3, (B, 6)), lam=rng.uniform(-0.1, 0.1, (B, N, 12)),
        rho=np.full(B, 0.01), drho=np.ones(B), mu=np.full(B, 10.0),
        pcg_tol=np.full(B, 1e-12))
    return jm, tm, jcp, tcp, arrays


def _solve_both(problem, max_sqp_iters, solve_ratio=1.0, **override):
    jm, tm, jcp, tcp, a = problem
    a = dict(a, **override)
    jax_out = run_solve_channels(jm, jcp, a["X"], a["U"], a["lam"], a["x_s"],
                                 a["ref"], a["f_ext"], a["rho"], a["drho"],
                                 a["mu"], a["pcg_tol"], max_sqp_iters, MAX_PCG,
                                 solve_ratio)
    X, U, lam, x_s, ref, fe, hp = state_from_numpy(
        a["X"], a["U"], a["lam"], a["x_s"], a["ref"], a["f_ext"], a["rho"],
        a["drho"], a["mu"], a["pcg_tol"])
    st = BSQPSettings(N=N, max_sqp_iters=max_sqp_iters, max_pcg_iters=MAX_PCG,
                      solve_ratio=solve_ratio)
    Xo, Uo, lam_o, hpo, stats = solve_batched(tm, st, tcp, hp, X, U, lam, x_s,
                                              ref, fe, DT)
    port = dict(X=Xo.numpy(), U=Uo.numpy(), lam=lam_o.numpy(),
                rho=hpo.rho.numpy(), drho=hpo.drho.numpy(),
                conv=stats.kkt_converged.numpy(),
                merit0=stats.initial_merit.numpy(),
                merit_final=stats.final_merit.numpy(),
                sqp_iters=stats.sqp_iters.numpy(),
                pcg_iters=stats.pcg_iters.numpy(),
                ls_merit=stats.ls_min_merit.numpy(),
                ls_step=stats.ls_step_size.numpy())
    return jax_out, port, a


@pytest.mark.parametrize("max_sqp_iters", [1, 3])
def test_solve_matches_solve_channels(problem, max_sqp_iters):
    j, p, _ = _solve_both(problem, max_sqp_iters)
    np.testing.assert_allclose(p["X"], j["X"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(p["U"], j["U"], rtol=1e-6, atol=1e-6)
    scale = max(1.0, np.abs(j["lam"]).max())
    assert np.abs(p["lam"] - j["lam"]).max() / scale < 1e-6
    np.testing.assert_allclose(p["rho"], j["rho"], rtol=1e-12)
    np.testing.assert_array_equal(p["drho"], np.ones(B))  # reset per solve
    np.testing.assert_allclose(p["merit0"], j["merit0"], rtol=1e-8)
    np.testing.assert_allclose(p["merit_final"], j["merit_final"], rtol=1e-8)
    np.testing.assert_array_equal(p["conv"], j["conv"].astype(int))
    np.testing.assert_array_equal(p["sqp_iters"], j["sqp_iters"].astype(int))
    assert np.abs(p["pcg_iters"] - j["pcg_iters"]).max() <= 2
    np.testing.assert_allclose(p["ls_merit"], j["ls_merit"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_array_equal(p["ls_step"], j["ls_step"])


def test_solve_nan_warmstart(problem):
    """A problem entering with NaN duals (a diverged earlier solve) comes
    out with its trajectory untouched and finite, a finite merit, not
    converged, and PCG reporting max_pcg_iters; the others are unaffected."""
    lam = problem[4]["lam"].copy()
    lam[0] = np.nan
    j, p, a = _solve_both(problem, 2, lam=lam)
    for out in (p, j):
        assert np.isfinite(out["X"]).all()
        assert np.isfinite(out["merit_final"]).all()
        np.testing.assert_array_equal(out["X"][0], a["X"][0])
        assert out["conv"][0] == 0 and out["pcg_iters"][0, 0] == MAX_PCG
    np.testing.assert_allclose(p["X"][1:], j["X"][1:], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(p["merit_final"][1:], j["merit_final"][1:],
                               rtol=1e-8)
    np.testing.assert_array_equal(p["ls_step"], j["ls_step"])


def test_solve_ratio_half_exits_before_the_line_search(problem):
    """Problems 0 and 1 are warm-started at their converged duals, so their
    PCG needs 0 iterations: 2 of 3 reach solve_ratio 0.5 on iteration 0. The
    whole-batch exit then keeps the dual update but reverts the line search
    (the reference's break before the merit kernel, bsqp.cuh:133-165)."""
    jm, tm, jcp, tcp, a = problem
    X, U, lam, x_s, ref, fe, hp = state_from_numpy(
        a["X"], a["U"], a["lam"], a["x_s"], a["ref"], a["f_ext"], a["rho"],
        a["drho"], a["mu"], a["pcg_tol"])
    kkt = setup_kkt_batched(tm, tcp, X, U, x_s, ref, fe, DT)
    sch = build_schur(kkt, hp.rho, tm.nq)
    # the Schur system solved directly: its residual is far below PCG_ABS_TOL
    nx = tm.nx
    S = torch.zeros(B, N * nx, N * nx, dtype=X.dtype)
    for k in range(N):
        S[:, k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = sch.S_main[:, k]
        if k < N - 1:
            S[:, (k + 1) * nx:(k + 2) * nx, k * nx:(k + 1) * nx] = sch.S_lower[:, k]
            S[:, k * nx:(k + 1) * nx, (k + 1) * nx:(k + 2) * nx] = (
                sch.S_lower[:, k].transpose(-1, -2))
    lam_star = torch.linalg.solve(S, sch.gamma.reshape(B, N * nx))
    lam0 = a["lam"].copy()
    lam0[:2] = lam_star[:2].reshape(2, N, nx).numpy()

    j, p, _ = _solve_both(problem, 3, solve_ratio=0.5, lam=lam0)
    for out in (p, j):
        np.testing.assert_array_equal(out["X"], a["X"])
        np.testing.assert_array_equal(out["rho"], a["rho"])
        np.testing.assert_array_equal(np.asarray(out["conv"]).astype(int), [1, 1, 0])
        np.testing.assert_array_equal(np.asarray(out["sqp_iters"]).astype(int), np.ones(B))
        assert (out["ls_step"] == 0).all() and (out["ls_merit"] == 0).all()
        np.testing.assert_array_equal(out["pcg_iters"][:, :2], 0)
        assert np.abs(out["lam"][2] - a["lam"][2]).max() > 1e-3
    np.testing.assert_allclose(p["lam"], j["lam"], rtol=1e-6, atol=1e-8)
    assert abs(int(p["pcg_iters"][0, 2]) - int(j["pcg_iters"][0, 2])) <= 2
    np.testing.assert_allclose(p["merit0"], j["merit0"], rtol=1e-8)
    np.testing.assert_allclose(p["merit_final"], j["merit0"], rtol=1e-8)
