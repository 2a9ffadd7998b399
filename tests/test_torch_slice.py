"""The steady-state closed-loop fig-8 MPC cycle of bench.py, port against
JAX, at a small size: indy7, N=8, B=4, DEFAULT_SOLVER_PARAMS, 4 cycles of
solve -> RK4 plant step of lane 0 under U[0, 0] (2 substeps) -> roll the
reference window. Float64 on both sides, inputs made once with numpy.

JAX side: the XLA solver path and the RK4 kernel's body (rk4_channels), as
the TPU headline runs them. Port side: gato_tpu_torch.solver.bsqp.
solve_batched and gato_tpu_torch.api.common.rk4_step, the entry points
chip_smoke.py drives on the card.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gato_tpu.api.common import figure8 as jax_figure8
from gato_tpu.api.config import DEFAULT_SOLVER_PARAMS as JAX_PARAMS
from gato_tpu.ops.merit_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_sim import rk4_channels as jax_rk4_channels
from gato_tpu.solver.bsqp import solve_batched_jit
from gato_tpu.solver.types import BSQPSettings as JSettings
from gato_tpu.solver.types import HyperParams as JHyperParams
from gato_tpu_torch.api.common import figure8, rk4_step
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS, INDY7_START_CONFIGS
from gato_tpu_torch.interop import state_from_numpy
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings
from torch_port_helpers import costs, models

N, B, DT, CYCLES = 8, 4, 0.01, 4
P = DEFAULT_SOLVER_PARAMS


def test_config_copies_match_jax_package():
    from gato_tpu.api import config as jax_config
    from gato_tpu_torch.api import config as port_config

    assert P == JAX_PARAMS
    for name in ("STANDARD_BATCH_SIZES", "EXPERIMENT_BATCH_SIZES", "FIG8_DEFAULT_PARAMS"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    for k, v in jax_config.PENDULUM_DEFAULT_PARAMS.items():
        np.testing.assert_array_equal(port_config.PENDULUM_DEFAULT_PARAMS[k], v)
    for name in ("PICKPLACE_SOLVER_PARAMS", "PICKPLACE_MPC_DEFAULTS"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    np.testing.assert_array_equal(np.stack(port_config.PICKPLACE_DEFAULT_GOALS),
                                  np.stack(jax_config.PICKPLACE_DEFAULT_GOALS))
    np.testing.assert_array_equal(figure8(DT), jax_figure8(DT))


def test_fig8_cycle_matches_jax():
    jm, tm = models("indy7")
    jcp, tcp = costs(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost",
                                          "N_cost", "q_lim_cost",
                                          "vel_lim_cost", "ctrl_lim_cost")})
    traj = figure8(DT).reshape(-1, 6)
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)])
    rng = np.random.default_rng(0)
    f_ext = rng.uniform(-5.0, 5.0, (B, 6))
    f_ext[0] = 0.0
    X0, U0, lam0 = np.tile(x0, (B, N, 1)), np.zeros((B, N - 1, 6)), np.zeros((B, N, 12))
    xs0 = np.tile(x0, (B, 1))
    hp_np = [np.full(B, P["rho"]), np.ones(B), np.full(B, P["mu"]),
             np.full(B, P["pcg_tol"])]

    # JAX
    js = JSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                   max_pcg_iters=P["max_pcg_iters"])
    jhp = JHyperParams(*(jnp.asarray(v) for v in hp_np))
    jcd = jax_get_cd(jm.key)
    X, U, lam, x_s, fe = (jnp.asarray(v) for v in (X0, U0, lam0, xs0, f_ext))
    jax_stats = []
    for i in range(CYCLES):
        ref = jnp.asarray(np.tile(traj[i:i + N], (B, 1, 1)))
        X, U, lam, _, st = solve_batched_jit(jm, js, jcp, jhp, X, U, lam, x_s,
                                             ref, fe, jnp.float64(DT))
        q, qd = jax_rk4_channels(jcd, [x_s[:1, k] for k in range(6)],
                                 [x_s[:1, 6 + k] for k in range(6)],
                                 [U[:1, 0, k] for k in range(6)], None, DT, 2)
        x_s = jnp.tile(jnp.stack(q + qd, 1), (B, 1))
        X = X.at[:, 0].set(x_s)
        jax_stats.append((np.asarray(st.pcg_iters[0]), np.asarray(st.ls_step_size[0])))

    # port
    ts = BSQPSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                      max_pcg_iters=P["max_pcg_iters"])
    tX, tU, tlam, txs, _, tfe, thp = state_from_numpy(
        X0, U0, lam0, xs0, np.zeros((B, N, 6)), f_ext, *hp_np, device="cpu")
    port_stats, track = [], []
    for i in range(CYCLES):
        tref = torch.tensor(np.tile(traj[i:i + N], (B, 1, 1)))
        tX, tU, tlam, _, st = solve_batched(tm, ts, tcp, thp, tX, tU, tlam,
                                            txs, tref, tfe, DT)
        x1 = rk4_step(tm, txs[0], tU[0, 0], DT, substeps=2)
        txs = x1[None].repeat(B, 1)
        tX = tX.clone()
        tX[:, 0] = txs
        port_stats.append((st.pcg_iters[0].numpy(), st.ls_step_size[0].numpy()))

    for (jp, jst), (tp, tst) in zip(jax_stats, port_stats):
        assert np.abs(tp - jp).max() <= 2
        np.testing.assert_array_equal(tst, jst)
        assert (tst > 0).all()  # real accepted steps, not the failure path
    np.testing.assert_allclose(tX.numpy(), np.asarray(X), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tU.numpy(), np.asarray(U), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(txs.numpy(), np.asarray(x_s), rtol=1e-6, atol=1e-9)
