"""The port's API layer (gato_tpu_torch.api) against the JAX package's
(gato_tpu.api), on the CPU.

- BSQP(device="cpu", precision="double") against gato_tpu.api.BSQP
  (precision="double"), B=4 N=8 max_sqp_iters=2, the JAX facade's state
  after one solve carried over by interop.bsqp_state_from_numpy, with
  tests/test_torch_solve_xla.py's tolerances: the trajectory rtol 1e-6
  (atol 1e-8 on X, 1e-6 on U), the duals normwise 1e-6, the statistics
  (float32 in both facades) rtol 1e-6, the counts and steps exactly;
- the facade's stats surface, as tests/test_api.py holds the JAX one;
- world_wrench_to_ee_frame and rk4_step under a world wrench, float64,
  rtol 1e-10 (the same algorithms; the wrench re-expressed at each stage);
- ForceEstimator: the same batches from the same seed, exactly;
- add_pendulum: the augmented model's arrays and mass against JAX.

The closed-loop runs (MPC_GATO) are in tests/test_torch_mpc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.api.common import rk4_step as jax_rk4_step
from gato_tpu.api.common import world_wrench_to_ee_frame as jax_world_wrench
from gato_tpu.api.force_estimator import ForceEstimator as JForceEstimator
from gato_tpu.api.interface import BSQP as JBSQP
from gato_tpu.api.mpc import add_pendulum as jax_add_pendulum
from gato_tpu_torch.api import BSQP, ForceEstimator, add_pendulum, rk4_step
from gato_tpu_torch.api.common import world_wrench_to_ee_frame
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import INDY7_START_CONFIGS
from gato_tpu_torch.interop import MODEL_FIELDS, bsqp_state_from_numpy
from torch_port_helpers import jax_in_pieces, models, t64

B, N = 4, 8
FACADE = dict(plant_type="indy7", batch_size=B, N=N, dt=0.01, max_sqp_iters=2,
              max_pcg_iters=100, pcg_tol=P["pcg_tol"], mu=P["mu"],
              q_cost=P["q_cost"], qd_cost=P["qd_cost"], u_cost=P["u_cost"],
              N_cost=P["N_cost"], q_lim_cost=P["q_lim_cost"], rho=P["rho"])


def _problem(seed):
    """(xcur_B, eepos_goals_B, XU_B, f_ext_B) near the 'ready' start."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)])
    x = x0 + rng.uniform(-0.05, 0.05, (B, 12))
    ee = np.array([0.12, 0.45, 0.55])
    ref = np.tile(np.concatenate([ee, np.zeros(3)]), (B, N)) + rng.uniform(-0.05, 0.05, (B, 6 * N))
    XU = np.tile(np.concatenate([np.concatenate([x0, np.zeros(6)])] * (N - 1) + [x0]), (B, 1))
    return x, ref, XU + rng.uniform(-0.01, 0.01, XU.shape), rng.uniform(-3, 3, (B, 6))


def test_bsqp_matches_jax_facade_in_double():
    x, ref, XU, fe = _problem(41)
    jb = JBSQP(**FACADE, precision="double")
    jb.set_f_ext_B(fe)
    jb.solve(x, ref, XU)  # the state to carry: duals, rho, warm start
    tb = BSQP(**FACADE, precision="double", device="cpu")
    bsqp_state_from_numpy(
        tb, jb.XU_B, np.asarray(jb.lam),
        [np.asarray(getattr(jb.hp, f)) for f in ("rho", "drho", "mu", "pcg_tol")],
        [np.asarray(getattr(jb._hp_init, f)) for f in ("rho", "drho", "mu", "pcg_tol")],
        np.asarray(jb.f_ext_B))
    jb.reset_rho()
    tb.reset_rho()
    XU_j, _ = jb.solve(x, ref)
    XU_t, _ = tb.solve(x, ref)
    assert XU_t.dtype == np.float64
    X_j, U_j = (np.asarray(a) for a in jb._unflatten(XU_j))
    X_t, U_t = (a.numpy() for a in tb._unflatten(XU_t))
    np.testing.assert_allclose(X_t, X_j, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(U_t, U_j, rtol=1e-6, atol=1e-6)
    lam_j = np.asarray(jb.lam)
    assert np.abs(tb.lam.numpy() - lam_j).max() / max(1.0, np.abs(lam_j).max()) < 1e-6
    np.testing.assert_allclose(tb.hp.rho.numpy(), np.asarray(jb.hp.rho), rtol=1e-12)
    sj, st = jb.stats, tb.stats
    assert set(st) == set(sj)
    for k in ("sqp_iters", "kkt_converged", "ls_num_iters", "step_size"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert np.abs(st["pcg_iters"] - sj["pcg_iters"]).max() <= 2
    for k in ("final_merit", "initial_merit", "best_initial_merit", "min_merit",
              "best_merit_per_iter", "best_merit_per_iter_normalized", "best_merit_iter1"):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-6, err_msg=k)
    # one step of the shared state under each problem's wrench hypothesis
    np.testing.assert_allclose(tb.sim_forward(x[0], np.ones(6), 0.01),
                               jb.sim_forward(x[0], np.ones(6), 0.01), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tb.ee_pos(x[0, :6]), jb.ee_pos(x[0, :6]), rtol=1e-12)


def test_bsqp_interface_stats_surface():
    """tests/test_api.py:68-101's checks on the port's facade (float32)."""
    x, ref, XU0, _ = _problem(42)
    solver = BSQP(**FACADE, device="cpu")
    XU, t_us = solver.solve(x, ref, XU0)
    assert XU.shape == (B, N * 18 - 6) and XU.dtype == np.float32 and t_us > 0
    s = solver.get_stats()
    for key in ("sqp_time_us", "sqp_time_us_device", "sqp_iters", "kkt_converged",
                "final_merit", "initial_merit", "pcg_iters", "min_merit", "step_size",
                "best_merit_per_iter", "best_merit_per_iter_normalized"):
        assert key in s, key
    assert s["sqp_time_us_device"] is None  # CUDA events only on the card
    assert s["sqp_iters"].shape == (B,)
    assert s["pcg_iters"].shape == (s["ls_num_iters"], B)
    # the warm start's first state is pinned to the measured one
    XU0[:, :12] = 0.0
    XU_pinned, _ = BSQP(**FACADE, device="cpu").solve(x, ref, XU0)
    np.testing.assert_array_equal(XU_pinned, XU)
    assert XU.flags.writeable and XU.flags.owndata  # callers mutate it

    f = np.zeros((B, 6), np.float32)
    f[1, 3] = -30.0
    solver.set_f_ext_B(f)
    xn = solver.sim_forward(x[0], np.ones(6, np.float32), 0.01)
    assert xn.shape == (B, 12)
    assert np.abs(xn[0] - xn[1]).max() > 1e-7

    solver.set_rho_penalty_batch(np.full(B, 0.5))
    solver.set_mu_batch(np.full(B, 3.0))
    solver.reset_rho()
    np.testing.assert_array_equal(solver.hp.rho.numpy(), np.full(B, 0.5, np.float32))
    solver.reset()
    assert float(solver.lam.abs().max()) == 0.0
    assert float(solver.f_ext_B.abs().max()) == 0.0 and not solver.XU_B.any()
    with pytest.raises(ValueError):
        BSQP(precision="half", device="cpu")


def test_world_wrench_and_rk4_step_match_jax(monkeypatch):
    """The wrench [force; torque] in the EE frame for a batch of
    configurations, and rk4_step under a world wrench (the rigid-body
    algorithms path: the JAX package's XLA rk4_step; iiwa14's is held to
    the native runtime in tests/test_torch_algorithms.py). The JAX
    rk4_step's forward dynamics is compiled once (jax_in_pieces)."""
    jax_in_pieces(monkeypatch)
    rng = np.random.default_rng(43)
    jm, tm = models("indy7")
    q = rng.uniform(-1.5, 1.5, (5, jm.nq))
    w = rng.uniform(-60, 60, (5, 6))
    ref = jax.jit(jax.vmap(lambda a, b: jax_world_wrench(jm, a, b)))(jnp.asarray(q),
                                                                   jnp.asarray(w))
    np.testing.assert_allclose(world_wrench_to_ee_frame(tm, t64(q), t64(w)).numpy(),
                               np.asarray(ref), rtol=1e-10, atol=1e-10)
    x = np.concatenate([q[0], rng.uniform(-1, 1, jm.nq)])
    u = rng.uniform(-20, 20, jm.nq)
    ref = jax_rk4_step(jm, jnp.asarray(x), jnp.asarray(u), 0.01,
                       f_ext_world=jnp.asarray(w[0]), substeps=2)
    out = rk4_step(tm, t64(x), t64(u), 0.01, f_ext_world=t64(w[0]), substeps=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_force_estimator_batches_equal_for_a_seed():
    errors = np.random.default_rng(44).uniform(0.1, 1.0, (6, 8))
    a, b = ForceEstimator(batch_size=8, seed=3), JForceEstimator(batch_size=8, seed=3)
    for e in errors:
        np.testing.assert_array_equal(a.generate_batch(), b.generate_batch())
        a.update(int(np.argmin(e)), e)
        b.update(int(np.argmin(e)), e)
    np.testing.assert_array_equal(a.estimate, b.estimate)
    assert a.radius == b.radius
    with pytest.raises(ValueError):
        ForceEstimator(batch_size=3)


def test_add_pendulum_matches_jax():
    """The 3R gimbal payload: nine joints on indy7, the bob's mass and every
    array as the JAX package builds them; the augmented plant steps."""
    jm, tm = models("indy7")
    jaug, taug = jax_add_pendulum(jm, mass=15.0, length=0.3), add_pendulum(tm, mass=15.0, length=0.3)
    assert taug.nq == tm.nq + 3 == 9
    assert float(taug.inertia[-1][5, 5]) == pytest.approx(15.0)
    for f in MODEL_FIELDS:
        np.testing.assert_allclose(getattr(taug, f).numpy(), np.asarray(getattr(jaug, f)),
                                   rtol=1e-7, atol=1e-7, err_msg=f)
    xn = rk4_step(taug, torch.zeros(18, dtype=torch.float64),
                  torch.zeros(9, dtype=torch.float64), 0.001)
    assert torch.isfinite(xn).all()
