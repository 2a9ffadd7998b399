"""The port's on-device rollouts (gato_tpu_torch.api.rollout) against the
JAX package's (gato_tpu.api.rollout) on the CPU, float64, inputs made once
with numpy from a seed: closed_loop_rollout (N=4, B=4, 3 cycles,
max_sqp_iters=2, per-lane wrench hypotheses; indy7, and iiwa14 as solver
and plant, whose plant step is the rk4 kernel's plain version) and
closed_loop_rollout_goals (2 goals, 4 cycles, the sphere estimator over
the batch; indy7 as solver and plant at control_dt 0.01, and
examples/pickplace.py's device loop: iiwa14 as solver, iiwa14 + 15 kg
pendulum as plant, control_dt 2 ms, its costs, RK4-substepped hypothesis
scoring), with the JAX key's own uniform draws handed to the port. Every
cycle's state and EE position agree within RTOL of the trajectory's
largest value; the chosen lanes, goal indices and outcomes are identical.
The capturable chained solve (device_exit=True) equals the host-exit one
bit for bit.

RTOL is 1e-6, not 1e-8: the JAX package's own goals rollout and the same
warm-up solve and plant step jitted apart from it already differ by more
than 1e-8 of the state after one cycle (at a far goal, where the controls
are large: the PCG at tol 1e-4 carries each rounding difference into the
step), so the JAX package does not reproduce itself to 1e-8 across
compilations.

The JAX goals rollout keeps its estimator state in float32 (fe_init), which
a float64 loop's scan carry cannot hold, so its fe_init is replaced for the
call by one in float64, the dtype the port's rollouts take from their
inputs.

The JAX rollouts call their solve and dynamics compiled once each
(torch_port_helpers.jax_in_pieces, the `pieces` fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu.api.force_estimator_device as jfed
from gato_tpu.api.mpc import add_pendulum as jax_add_pendulum
from gato_tpu.api.rollout import closed_loop_rollout as jax_rollout
from gato_tpu.api.rollout import closed_loop_rollout_goals as jax_rollout_goals
from gato_tpu.solver.types import BSQPSettings as JSettings
from gato_tpu.solver.types import HyperParams as JHyperParams
from gato_tpu_torch.api import rollout as R
from gato_tpu_torch.api.mpc import add_pendulum
from gato_tpu_torch.interop import hyper_from_numpy
from gato_tpu_torch.ops.cuda_solve import sqp_iter_reference, sqp_solve_chained
from gato_tpu_torch.solver.types import BSQPSettings
from torch_port_helpers import DEFAULT_COST, costs, jax_in_pieces, models, t64

N, B, DT = 4, 4, 0.01
RTOL = 1e-6
# each plant's start and a point near its start's EE: indy7's ready pose,
# iiwa14's elbow-bent one (examples/mixed_fleet.py:130)
Q0 = dict(indy7=np.array([-1.0966, -0.099, 0.8313, -0.109, 0.497, 0.015]),
          iiwa14=np.array([0.0, 0.7, 0.0, -1.6, 0.0, 1.0, 0.0]))
EE0 = dict(indy7=np.array([-0.3226, 0.2416, 1.0508]), iiwa14=np.array([0.556, 0.0, 0.335]))
X0 = np.concatenate([Q0["indy7"], np.zeros(6)])  # indy7 at rest (the estimator tests)
HP = [np.full(B, 0.01), np.ones(B), np.full(B, 10.0), np.full(B, 1e-4)]
# examples/pickplace.py's device loop: PICKPLACE_SOLVER_PARAMS' costs and
# hyperparameters, the 15 kg pendulum (PENDULUM_DEFAULT_PARAMS), 2 ms cycles
PICKPLACE_COST = dict(q_cost=5.0, qd_cost=1e-2, u_cost=5e-7, N_cost=50.0, q_lim_cost=0.0)
PICKPLACE_HP = [np.full(B, 1e-3), np.ones(B), np.full(B, 10.0), np.full(B, 1e-6)]


@pytest.fixture(scope="module")
def setup():
    """{robot: (JAX model, port model)}, and the default costs."""
    jcp, tcp = costs(**DEFAULT_COST)
    return {robot: models(robot) for robot in Q0}, jcp, tcp


@pytest.fixture
def pieces(monkeypatch):
    jax_in_pieces(monkeypatch)


def jax_uniforms(seed, n):
    """The (n, 3) draws the JAX rollouts make from PRNGKey(seed), in the
    order of their jax.random.split."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (3,))))
    return np.stack(out)


def f64_fe_init(initial_radius=10.0):
    z6 = jnp.zeros(6)
    return jfed.FEState(estimate=z6, momentum=z6, smoothed=z6,
                        radius=jnp.asarray(initial_radius, jnp.float64),
                        confidence=jnp.asarray(0.0), err_hist=jnp.zeros(5),
                        err_count=jnp.asarray(0, jnp.int32),
                        rotation=jnp.eye(3, dtype=jnp.float32))


def close(got, want, msg):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    assert np.isfinite(got).all(), msg
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= RTOL * scale, f"{msg}: {err:.3e} against the largest value {scale:.3e}"


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_closed_loop_rollout_matches_jax(setup, pieces, robot):
    (jm, tm), jcp, tcp = setup[0][robot], setup[1], setup[2]
    x0 = np.concatenate([Q0[robot], np.zeros(jm.nq)])
    rng = np.random.default_rng(5)
    f_ext = rng.uniform(-5.0, 5.0, (B, 6))
    f_ext[0] = 0.0
    goal = EE0[robot] + np.array([0.06, -0.04, 0.05]) + rng.uniform(-0.01, 0.01, 3)
    refs = np.tile(np.concatenate([goal, np.zeros(3)]), (3, N, 1))
    js = JSettings(N=N, max_sqp_iters=2, max_pcg_iters=40)
    xs, ees, us = jax_rollout(jm, jm, js, jcp, JHyperParams(*map(jnp.asarray, HP)),
                              jnp.asarray(x0), jnp.asarray(refs), jnp.asarray(f_ext),
                              jnp.float64(DT), jnp.float64(DT), sim_substeps=2)
    ts = BSQPSettings(N=N, max_sqp_iters=2, max_pcg_iters=40)
    txs, tees, tus = R.closed_loop_rollout(
        tm, tm, ts, tcp, hyper_from_numpy(*HP, device="cpu"), t64(x0), t64(refs),
        t64(f_ext), DT, DT, sim_substeps=2)
    close(txs, xs, "x_sim")
    close(tees, ees, "ee")
    close(tus, us, "u")


@pytest.mark.parametrize("plant", ["indy7", "iiwa14+pendulum"])
def test_goals_rollout_matches_jax(setup, pieces, monkeypatch, plant):
    """indy7 as solver and plant; or pickplace's loop: iiwa14 as solver and
    iiwa14 + 15 kg pendulum (swung 0.3 rad) as plant, damping 0.4, 2 ms
    cycles, its costs, RK4-substepped scoring (score_substeps=2)."""
    robot = plant.split("+")[0]
    jm, tm = setup[0][robot]
    x0 = np.concatenate([Q0[robot], np.zeros(jm.nq)])
    rng = np.random.default_rng(6)
    # goal 0 where the arm rests (reached at once), goal 1 a few cm away
    # (its timeout fires): both outcomes
    goals = EE0[robot] + np.array([[0.0, 0.0, 0.0], [0.06, -0.04, 0.05]]) + rng.uniform(
        -0.005, 0.005, (2, 3))
    n_steps = 4
    draws = jax_uniforms(1, n_steps)
    js = JSettings(N=N, max_sqp_iters=2, max_pcg_iters=40)
    ts = BSQPSettings(N=N, max_sqp_iters=2, max_pcg_iters=40)
    monkeypatch.setattr(jfed, "fe_init", f64_fe_init)
    if plant == "indy7":
        jcp, tcp = setup[1], setup[2]
        hp, jsim, tsim, x_sim0 = HP, jm, tm, x0
        kw = dict(goal_timeout=0.02, sim_substeps=2)
        control_dt = float(np.float32(DT))
    else:
        jcp, tcp = costs(**PICKPLACE_COST)
        hp = PICKPLACE_HP
        jsim, tsim = jax_add_pendulum(jm, mass=15.0, length=0.3), add_pendulum(
            tm, mass=15.0, length=0.3)
        x_sim0 = np.zeros(2 * tsim.nq)
        x_sim0[:jm.nq] = Q0[robot]
        x_sim0[jm.nq:jm.nq + 3] = [0.3, 0.0, 0.0]
        # goal 1's timeout fires on the fourth cycle
        kw = dict(goal_timeout=0.005, sim_substeps=2, pendulum_damping=0.4, score_substeps=2)
        control_dt = float(np.float32(0.002))
    want = jax_rollout_goals(jm, jsim, js, jcp, JHyperParams(*map(jnp.asarray, hp)),
                             jnp.asarray(x_sim0), jnp.asarray(goals), jnp.float64(DT),
                             jnp.float32(control_dt), jax.random.PRNGKey(1),
                             batch_size=B, n_steps=n_steps, **kw)
    got = R.closed_loop_rollout_goals(
        tm, tsim, ts, tcp, hyper_from_numpy(*hp, device="cpu"), t64(x_sim0), t64(goals), DT,
        control_dt, t64(draws), B, n_steps, **kw)
    names = ("x_sim", "ee", "dist", "goal_idx", "best", "outcomes", "reached_t",
             "smoothed", "radius")
    for name, g, w in zip(names, got, want):
        if name in ("goal_idx", "best", "outcomes"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            close(g, w, name)


@pytest.mark.parametrize("solve_ratio", [0.5, 1.0])
def test_device_exit_equals_host_exit(solve_ratio):
    """The chained solve with the exit kept on the device (what the
    rollouts' CUDA graphs hold) against the host-exit form, bit for bit,
    at max_sqp_iters=3 on the plain route in float64. Lanes 0 and 1 start
    at their Schur system's solution, so their PCG needs no iteration:
    at solve_ratio 0.5 the exit fires after the first iteration (and the
    device form discards the next two); at 1.0 it never fires."""
    from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
    from gato_tpu_torch.ops.schur import build_schur
    from gato_tpu_torch.robots.model import load_robot

    tm = load_robot("indy7", torch.float64, device="cpu")
    tcp = costs(**DEFAULT_COST)[1]
    rng = np.random.default_rng(7)
    X, x_s = t64(rng.uniform(-0.3, 0.3, (B, N, 12))), t64(rng.uniform(-0.3, 0.3, (B, 12)))
    U, ref = t64(rng.uniform(-5, 5, (B, N - 1, 6))), t64(rng.uniform(-0.5, 0.5, (B, N, 6)))
    f_ext, lam = t64(rng.uniform(-3, 3, (B, 6))), t64(rng.uniform(-0.1, 0.1, (B, N, 12)))
    rho = torch.full((B,), 0.01, dtype=torch.float64)
    sch = build_schur(setup_kkt_batched(tm, tcp, X, U, x_s, ref, f_ext, DT), rho, 6)
    S = torch.zeros(B, N * 12, N * 12, dtype=torch.float64)
    for k in range(N):
        S[:, 12 * k:12 * k + 12, 12 * k:12 * k + 12] = sch.S_main[:, k]
        if k < N - 1:
            S[:, 12 * k + 12:12 * k + 24, 12 * k:12 * k + 12] = sch.S_lower[:, k]
            S[:, 12 * k:12 * k + 12, 12 * k + 12:12 * k + 24] = sch.S_lower[:, k].mT
    lam[:2] = torch.linalg.solve(S, sch.gamma.reshape(B, -1))[:2].reshape(2, N, 12)
    settings = BSQPSettings(N=N, max_sqp_iters=3, max_pcg_iters=300, solve_ratio=solve_ratio)
    args = (sqp_iter_reference, tm, tcp, settings, X, U, lam, x_s, ref, f_ext, rho,
            torch.ones(B, dtype=torch.float64), torch.full((B,), 10.0, dtype=torch.float64),
            torch.full((B,), 1e-12, dtype=torch.float64), DT)
    host = sqp_solve_chained(*args)
    device = sqp_solve_chained(*args, device_exit=True)
    for h, d in zip(host, device):
        assert h.dtype == d.dtype and torch.equal(h, d)
    pcg, step = host[9], host[11]
    if solve_ratio == 0.5:
        assert (pcg[0, :2] == 0).all() and (pcg[1:] == 0).all() and (step == 0).all()
    else:
        assert (pcg[1:, 2:] > 0).all() and (step[0, 2:] != 0).all()
