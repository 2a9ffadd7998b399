"""The port's force-adaptive rollout (gato_tpu_torch.api.rollout.
closed_loop_rollout_estimator) against the JAX package's on the CPU,
float64, in both estimator modes: indy7, N=4, B=4, 3 cycles of one RK4
substep, max_sqp_iters=2, a true world wrench [12, -8, 5, 0, 0, 0] N, inputs made
with numpy from a seed and the JAX key's own uniform draws. As in
tests/test_torch_rollout.py, the JAX rollout's fe_init is replaced for the
call by a float64 one, since its float32 estimator state cannot ride a
float64 scan carry; the float32 sphere directions and rotation stay; its
solve and dynamics are compiled once each (torch_port_helpers.
jax_in_pieces). Then MPC_GATO(estimator="observer", device="cpu")
against the JAX package's MPC_GATO(estimator="observer") over three
cycles in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu.api.force_estimator_device as jfed
import gato_tpu.ops.integrators as jint
from gato_tpu.api.common import figure8 as jax_figure8
from gato_tpu.api.mpc import MPC_GATO as JMPC_GATO
from gato_tpu.api.rollout import closed_loop_rollout_estimator as jax_rollout
from gato_tpu.solver.types import BSQPSettings as JSettings
from gato_tpu.solver.types import HyperParams as JHyperParams
from gato_tpu_torch.api import MPC_GATO, figure8
from gato_tpu_torch.api import rollout as R
from gato_tpu_torch.api.common import world_wrench_to_ee_frame
from gato_tpu_torch.api.config import INDY7_START_CONFIGS
from gato_tpu_torch.interop import hyper_from_numpy
from gato_tpu_torch.solver.types import BSQPSettings
from test_torch_rollout import (EE0, HP, X0, B, DT, N, close, f64_fe_init,  # noqa: F401
                                pieces, jax_uniforms)
from torch_port_helpers import DEFAULT_COST, costs, jax_in_pieces, models, t64

STEPS = 3
TRUE_W = np.array([12.0, -8.0, 5.0, 0.0, 0.0, 0.0])
OBS_W_ATOL, OBS_Q_ATOL, OBS_LANE_RTOL = 5e-4, 5e-4, 1e-3


@pytest.mark.parametrize("estimator", ["sphere", "observer"])
def test_estimator_rollout_matches_jax(estimator, pieces, monkeypatch):
    jm, tm = models("indy7")
    jcp, tcp = costs(**DEFAULT_COST)
    rng = np.random.default_rng(8)
    hold = EE0["indy7"] + rng.uniform(-0.005, 0.005, 3)
    refs = np.tile(np.concatenate([hold, np.zeros(3)]), (STEPS, N, 1))
    monkeypatch.setattr(jfed, "fe_init", f64_fe_init)
    want = jax_rollout(jm, JSettings(N=N, max_sqp_iters=2, max_pcg_iters=40), jcp,
                       JHyperParams(*map(jnp.asarray, HP)), jnp.asarray(X0),
                       jnp.asarray(refs), jnp.asarray(TRUE_W), jnp.float64(DT),
                       jnp.float64(DT), B, jax.random.PRNGKey(2), sim_substeps=1,
                       estimator=estimator)
    got = R.closed_loop_rollout_estimator(
        tm, BSQPSettings(N=N, max_sqp_iters=2, max_pcg_iters=40), tcp,
        hyper_from_numpy(*HP, device="cpu"), t64(X0), t64(refs), t64(TRUE_W), DT, DT, B,
        t64(jax_uniforms(2, STEPS)), sim_substeps=1, estimator=estimator)
    for name, g, w in zip(("x_sim", "ee", "smoothed", "err"), got, want):
        close(g, w, name)
    if estimator == "observer":
        # the observer identifies the wrench within the three cycles
        assert np.abs(got[2][-1].numpy() - TRUE_W).max() < 0.1


def _record(obj, name, to_numpy):
    """Wrap obj.name to keep every output, as numpy."""
    seen, fn = [], getattr(obj, name)

    def call(*args):
        out = fn(*args)
        seen.append(to_numpy(out))
        return out

    setattr(obj, name, call)
    return seen


def test_mpc_observer_matches_jax(monkeypatch):
    """MPC_GATO(estimator="observer", device="cpu") against the JAX
    package's MPC_GATO(estimator="observer"), both float32, in
    tests/test_api.py's observer configuration (indy7, N=8, B=4, world
    wrench [10, -6, 4] N, control_dt 0.01, sim_dt 0.005) over three cycles:
    each cycle's observer estimate within OBS_W_ATOL N and joint positions
    within OBS_Q_ATOL rad, the last solve's EE-frame lanes within
    OBS_LANE_RTOL of their largest value, and the lanes' layout: lane 0
    the estimate, lane 1 zero, the rest copies of lane 0. The JAX side's
    rk4_step and its facade's sim_forward (gato_tpu.ops.integrators) call
    the forward dynamics compiled in pieces (jax_in_pieces). The two
    float32 solves stop their PCG at the same tolerance (1e-4) by different
    orders of operations; on these inputs the estimates differ by up to
    9e-5 N, the joint positions by 1.2e-4 rad, the lanes by 1.3e-4 of their
    largest."""
    jax_in_pieces(monkeypatch, jint)
    true_f = np.array([10.0, -6.0, 4.0, 0.0, 0.0, 0.0], np.float32)
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)
    kw = dict(plant_type="indy7", N=8, dt=0.01, batch_size=4, constant_f_ext=true_f,
              estimator="observer", control_dt=0.01)
    jmpc, tmpc = JMPC_GATO(**kw), MPC_GATO(**kw, device="cpu")
    w_jax = _record(jmpc, "_obs_step", np.asarray)
    w_port = _record(tmpc, "_observe", lambda t: t.numpy())
    _, want = jmpc.run_mpc_fig8(x0, jax_figure8(0.01), sim_time=0.03, sim_dt=0.005)
    _, got = tmpc.run_mpc_fig8(x0, figure8(0.01), sim_time=0.03, sim_dt=0.005)
    assert len(w_port) == len(w_jax) == len(got["timestamps"]) == 3
    np.testing.assert_allclose(np.stack(w_port), np.stack(w_jax), rtol=0, atol=OBS_W_ATOL)
    np.testing.assert_array_equal(tmpc._w_obs, w_port[-1])
    np.testing.assert_allclose(got["joint_positions"], want["joint_positions"], rtol=0,
                               atol=OBS_Q_ATOL)
    lanes, lanes_jax = tmpc.solver.f_ext_B.numpy(), np.asarray(jmpc.solver.f_ext_B)
    assert np.abs(lanes - lanes_jax).max() <= OBS_LANE_RTOL * np.abs(lanes_jax).max()
    # the last solve's lanes: the estimate of the cycle before, then zero
    q = torch.tensor(got["joint_positions"][-1])
    want_lanes = world_wrench_to_ee_frame(tmpc.solver_model, q, torch.tensor(
        np.stack([w_port[-2], np.zeros(6, np.float32)])))
    np.testing.assert_allclose(lanes[:2], want_lanes.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(lanes[2:], np.tile(lanes[:1], (2, 1)))
