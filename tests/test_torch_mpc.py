"""The port's closed-loop MPC (gato_tpu_torch.api.MPC_GATO) on the CPU,
float32, the plain PyTorch route, and the entry points' device rule.

The fig-8 run is tests/test_api.py:104-118's workload (indy7, N=8, B=1,
max_pcg_iters=50, sim_dt 1e-3, 1 s) with its bounds: the second half's
mean EE error below 0.055 m and its largest below 0.09 m. The goals run is
that file's smoke (one goal 5 cm from the start, control_dt 0.004). The
same loops run on the card in chip_smoke.py's [mpc] and [goals] phases.
"""

import numpy as np
import pytest
import torch

from gato_tpu_torch.api import BSQP, MPC_GATO, figure8
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS, INDY7_START_CONFIGS

X0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)


def test_mpc_fig8_tracks_on_cpu():
    mpc = MPC_GATO(plant_type="indy7", N=8, dt=0.01, batch_size=1, device="cpu",
                   solver_params=dict(DEFAULT_SOLVER_PARAMS, max_pcg_iters=50))
    _, stats = mpc.run_mpc_fig8(X0, figure8(0.01, cycles=1), sim_dt=0.001, sim_time=1.0)
    assert len(stats["timestamps"]) > 50
    assert np.isfinite(stats["joint_positions"]).all()
    tail = np.asarray(stats["goal_distances"])[len(stats["timestamps"]) // 2:]
    assert tail.mean() < 0.055
    assert tail.max() < 0.09


def test_mpc_goals_smoke_on_cpu():
    mpc = MPC_GATO(plant_type="indy7", N=8, dt=0.01, batch_size=1, control_dt=0.004,
                   device="cpu",
                   solver_params=dict(DEFAULT_SOLVER_PARAMS, max_sqp_iters=2,
                                      max_pcg_iters=50))
    goals = [mpc.solver.ee_pos(X0[:6]) + np.array([0.05, 0.0, 0.0])]
    _, stats = mpc.run_mpc_goals(X0, goals, sim_dt=0.001, goal_timeout=1.5,
                                 goal_threshold=0.04, velocity_threshold=2.0)
    assert stats["goal_outcomes"][0] in ("reached", "timeout")
    assert len(stats["timestamps"]) > 0
    assert np.isfinite(stats["joint_positions"]).all()


def test_entry_points_default_to_the_card():
    """BSQP and MPC_GATO build on the card unless told device="cpu"; without
    a card they raise instead of quietly taking the CPU route. float64 is
    the CPU's; the estimator is "sphere" or "observer" and nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points build there")
    with pytest.raises(RuntimeError, match="is_available"):
        BSQP()
    with pytest.raises(RuntimeError, match="is_available"):
        MPC_GATO(N=8, dt=0.01)
    with pytest.raises(RuntimeError, match="is_available"):
        BSQP(precision="double")
    assert MPC_GATO(N=8, dt=0.01, batch_size=4, estimator="observer", device="cpu")._observer
    with pytest.raises(ValueError, match="observer"):
        MPC_GATO(N=8, dt=0.01, batch_size=4, estimator="kalman", device="cpu")
