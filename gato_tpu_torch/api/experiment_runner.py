"""Batch-size sweep of the fig-8 MPC task.

Port of gato_tpu/api/experiment_runner.py (the reference's
python/bsqp/experiment_runner.py): runs MPC_GATO's fig-8 loop once per
batch size, aggregates the tracking error and the solve times, and pickles
the results for plotting. The solve times are the facade's: device time by
CUDA events on the card, wall time on the CPU.
"""

from __future__ import annotations

import pickle
import time

import numpy as np

from .common import figure8
from .config import (DEFAULT_SOLVER_PARAMS, EXPERIMENT_BATCH_SIZES,
                     FIG8_DEFAULT_PARAMS, INDY7_START_CONFIGS)
from .mpc import MPC_GATO


class ExperimentRunner:
    def __init__(self, plant_type="indy7", N=32, dt=0.01,
                 batch_sizes=None, solver_params=None,
                 constant_f_ext=None, sim_time=5.0, sim_dt=0.001,
                 fig8_params=None, device="cuda"):
        self.plant_type = plant_type
        self.N = N
        self.dt = dt
        self.batch_sizes = batch_sizes or list(EXPERIMENT_BATCH_SIZES)
        self.solver_params = dict(DEFAULT_SOLVER_PARAMS)
        if solver_params:
            self.solver_params.update(solver_params)
        self.constant_f_ext = constant_f_ext
        self.sim_time = sim_time
        self.sim_dt = sim_dt
        self.fig8_params = dict(FIG8_DEFAULT_PARAMS)
        if fig8_params:
            self.fig8_params.update(fig8_params)
        self.device = device
        self.results = {}

    def _start_state(self):
        q0 = INDY7_START_CONFIGS["ready"] if self.plant_type == "indy7" else np.zeros(7)
        return np.concatenate([q0, np.zeros_like(q0)]).astype(np.float32)

    def run_batch_experiments(self, verbose=True):
        traj = figure8(self.dt, **{k: v for k, v in self.fig8_params.items()
                                   if k != "cycles"},
                       cycles=self.fig8_params.get("cycles", 5))
        x0 = self._start_state()
        for B in self.batch_sizes:
            if verbose:
                print(f"== batch size {B} ==")
            mpc = MPC_GATO(plant_type=self.plant_type, N=self.N, dt=self.dt,
                           batch_size=B, constant_f_ext=self.constant_f_ext,
                           solver_params=self.solver_params, device=self.device)
            t0 = time.perf_counter()
            _, stats = mpc.run_mpc_fig8(x0, traj, sim_dt=self.sim_dt, sim_time=self.sim_time)
            wall = time.perf_counter() - t0
            dist, solve = np.asarray(stats["goal_distances"]), np.asarray(stats["solve_times"])
            self.results[B] = {
                "stats": stats,
                "wall_time_s": wall,
                "avg_error_m": float(dist.mean()) if dist.size else float("nan"),
                "avg_solve_ms": float(solve.mean()) if solve.size else float("nan"),
            }
        return self.results

    def summary(self):
        rows = []
        base = None
        for B in self.batch_sizes:
            if B not in self.results:
                continue
            r = self.results[B]
            if base is None:
                base = r["avg_solve_ms"]
            rows.append({
                "batch_size": B,
                "avg_error_m": r["avg_error_m"],
                "avg_solve_ms": r["avg_solve_ms"],
                "throughput_solves_per_s": B / (r["avg_solve_ms"] / 1000.0)
                if r["avg_solve_ms"] else float("nan"),
                "speedup_vs_b1": base / r["avg_solve_ms"] * B
                if r["avg_solve_ms"] else float("nan"),
            })
        return rows

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump({"results": self.results, "batch_sizes": self.batch_sizes,
                         "N": self.N, "dt": self.dt, "plant_type": self.plant_type}, f)

    @staticmethod
    def load(path):
        with open(path, "rb") as f:
            return pickle.load(f)


def run_standard_benchmark(plant_type="indy7", N=32, batch_sizes=None,
                           sim_time=5.0, save_path=None, device="cuda"):
    """The reference's experiment_runner.py:175-208."""
    runner = ExperimentRunner(plant_type=plant_type, N=N, batch_sizes=batch_sizes,
                              sim_time=sim_time, device=device)
    runner.run_batch_experiments()
    if save_path:
        runner.save(save_path)
    return runner
