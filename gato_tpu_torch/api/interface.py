"""BSQP solver facade: the user-facing API, surface-compatible with the
reference's Python interface (python/bsqp/interface.py).

Port of gato_tpu/api/interface.py: the same constructor, flat XU layout,
lazily materialised stats with the same keys (bindings.cu:96-147,
interface.py:97-208), sim_forward, ee_pos and every setter and reset. The
solve is solver/bsqp.py::solve_batched on the card (`device="cuda"`, the
default; it raises without one) or on the CPU (`device="cpu"`, the plain
PyTorch route). The JAX package's calibrate_device_time exists for its
tunneled runtime and is not ported: stats["sqp_time_us_device"] is each
solve's device time by CUDA events on the card, None on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..dynamics.algorithms import ee_position
from ..ops.cost import CostParams
from ..robots.model import RobotModel, check_device, load_robot
from ..solver.bsqp import sim_forward_batched, solve_batched_jit
from ..solver.types import BSQPSettings, HyperParams

DTYPES = {"float": (torch.float32, np.float32), "double": (torch.float64, np.float64)}


class BSQP:
    """Batched SQP solver for EE-tracking MPC.

    The reference constructor's signature (interface.py:7-32) plus
    `device`; `model_path` is a URDF path or a built-in plant name.
    precision "double" (float64, the reference's BSQP_{B}_double) needs
    device="cpu": the card runs the float32 kernels."""

    def __init__(
        self,
        model_path=None,
        batch_size=1,
        N=32,
        dt=0.01,
        max_sqp_iters=10,
        kkt_tol=1e-4,
        max_pcg_iters=100,
        pcg_tol=1e-4,
        solve_ratio=1.0,
        mu=1.0,
        q_cost=2.0,
        qd_cost=1e-4,
        u_cost=1e-6,
        N_cost=50.0,
        q_lim_cost=1e-3,
        vel_lim_cost=0.0,
        ctrl_lim_cost=0.0,
        rho=0.0,
        rho_batch=None,
        mu_batch=None,
        pcg_tol_batch=None,
        adapt_rho=True,
        plant_type="indy7",
        f_ext_in_ee_frame=True,
        precision="float",
        device="cuda",
    ):
        if precision not in DTYPES:
            raise ValueError(f"precision must be 'float'|'double', got {precision!r}")
        device = check_device(device)
        if precision == "double" and device.type != "cpu":
            raise RuntimeError(
                "precision='double' needs device='cpu': on the card the solve "
                "runs the float32 kernels")
        self.precision = precision
        self.device = device
        self._dtype, self._np_dtype = DTYPES[precision]
        if plant_type is None:
            plant_type = "iiwa14" if (model_path and "iiwa" in str(model_path).lower()) else "indy7"
        self.plant_type = plant_type
        source = model_path if model_path else plant_type
        try:
            self.model: RobotModel = load_robot(source, self._dtype, device)
        except FileNotFoundError:
            self.model = load_robot(plant_type, self._dtype, device)

        self.batch_size = B = int(batch_size)
        self.N = int(N)
        self.dt = float(dt)
        self.nq = self.model.nq
        self.nv = self.model.nv
        self.nx = self.model.nx
        self.nu = self.model.nu

        self.settings = BSQPSettings(
            N=self.N, max_sqp_iters=int(max_sqp_iters),
            max_pcg_iters=int(max_pcg_iters), solve_ratio=float(solve_ratio),
            adapt_rho=bool(adapt_rho), kkt_tol=float(kkt_tol))
        self.cost_params = CostParams(
            q_cost=float(q_cost), qd_cost=float(qd_cost), u_cost=float(u_cost),
            N_cost=float(N_cost), q_lim_cost=float(q_lim_cost),
            vel_lim_cost=float(vel_lim_cost), ctrl_lim_cost=float(ctrl_lim_cost))
        hp = HyperParams.create(B, rho=rho, mu=mu, pcg_tol=pcg_tol,
                                dtype=self._dtype, device=device)
        if rho_batch is not None:
            hp = dataclasses.replace(hp, rho=self._batch(rho_batch))
        if mu_batch is not None:
            hp = dataclasses.replace(hp, mu=self._batch(mu_batch))
        if pcg_tol_batch is not None:
            hp = dataclasses.replace(hp, pcg_tol=self._batch(pcg_tol_batch))
        self._hp_init = self.hp = hp

        self.lam = torch.zeros(B, self.N, self.nx, dtype=self._dtype, device=device)
        self.f_ext_B = torch.zeros(B, 6, dtype=self._dtype, device=device)
        self._f_ext_in_ee_frame = f_ext_in_ee_frame
        self.XU_B = np.zeros((B, self.N * (self.nx + self.nu) - self.nu),
                             dtype=self._np_dtype)
        self._stats = {}
        self._stats_raw = None
        # the last solve's device time (us) by CUDA events; None on the CPU
        self.device_solve_time_us = None

    def _tensor(self, a, shape):
        return torch.tensor(np.asarray(a, self._np_dtype).reshape(shape),
                            device=self.device)

    def _batch(self, values):
        """(B,) hyperparameter values as a tensor on the solver's device."""
        return self._tensor(values, self.batch_size)

    # ---- trajectory layout (the reference's flat XU, constants.h:22:
    # [x_0, u_0, x_1, u_1, ..., x_{N-1}]) ----

    def _unflatten(self, XU_B):
        B, N, nx, nu = self.batch_size, self.N, self.nx, self.nu
        XU = np.asarray(XU_B, self._np_dtype).reshape(B, -1)
        full = np.concatenate([XU, np.zeros((B, nu), XU.dtype)], 1).reshape(B, N, nx + nu)
        return (self._tensor(np.ascontiguousarray(full[:, :, :nx]), (B, N, nx)),
                self._tensor(np.ascontiguousarray(full[:, :-1, nx:]), (B, N - 1, nu)))

    def _flatten(self, X, U):
        """The flat layout as an owned numpy array (callers mutate it), read
        from the device in one copy."""
        B, N, nx, nu = self.batch_size, self.N, self.nx, self.nu
        full = torch.cat([X, torch.cat([U, U.new_zeros(B, 1, nu)], 1)], 2)
        return full.reshape(B, N * (nx + nu))[:, :N * (nx + nu) - nu].cpu().numpy().astype(
            self._np_dtype)

    # ---- main entry points ----

    def solve(self, xcur_B, eepos_goals_B, XU_B=None):
        """One batched BSQP solve (interface.py:122-210). Returns
        (XU_B, solve_time_us), the wall time, and fills `self.stats`."""
        B = self.batch_size
        xcur = np.asarray(xcur_B, self._np_dtype).reshape(B, self.nx)
        XU_B = np.array(self.XU_B if XU_B is None else XU_B,
                        self._np_dtype).reshape(B, -1)
        XU_B[:, :self.nx] = xcur  # pin the warm start to the measured state
        X, U = self._unflatten(XU_B)
        x_s = self._tensor(xcur, (B, self.nx))
        ref = self._tensor(eepos_goals_B, (B, self.N, 6))
        on_card = self.device.type == "cuda"
        if on_card:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        if on_card:
            events[0].record()
        Xo, Uo, lam, hp, st = solve_batched_jit(
            self.model, self.settings, self.cost_params, self.hp, X, U,
            self.lam, x_s, ref, self.f_ext_B, self.dt)
        if on_card:
            events[1].record()
        self.XU_B = self._flatten(Xo, Uo)
        solve_time_us = int((time.perf_counter() - t0) * 1e6)
        if on_card:
            self.device_solve_time_us = events[0].elapsed_time(events[1]) * 1e3
        self.lam, self.hp = lam, hp
        # materialised when read (MPC loops read stats only with
        # track_full_stats)
        self._stats_raw = (st, solve_time_us, self.device_solve_time_us)
        return self.XU_B, solve_time_us

    @property
    def stats(self):
        if self._stats_raw is not None:
            self._stats = self._materialize_stats(*self._stats_raw)
            self._stats_raw = None
        return self._stats

    @stats.setter
    def stats(self, value):
        self._stats = value
        self._stats_raw = None

    def _materialize_stats(self, st, solve_time_us, device_us):
        n_run = int(st.num_iters_run)
        pcg_iters = st.pcg_iters[:n_run].cpu().numpy()
        min_merit = st.ls_min_merit[:n_run].cpu().numpy()
        step_size = st.ls_step_size[:n_run].cpu().numpy()
        initial_merit = st.initial_merit.cpu().numpy()
        stats = {
            "sqp_time_us": solve_time_us,
            "sqp_time_us_device": device_us,
            "sqp_iters": st.sqp_iters.cpu().numpy().astype(np.int32),
            "kkt_converged": st.kkt_converged.cpu().numpy().astype(np.int32),
            "final_merit": st.final_merit.cpu().numpy().astype(np.float32),
            "initial_merit": initial_merit.astype(np.float32),
            "best_initial_merit": float(initial_merit.min()) if initial_merit.size else np.array([]),
            "ls_num_iters": n_run,
            "pcg_iters": pcg_iters.astype(np.int32),
            # zeros by contract: the reference hardcodes PCG stage time to 0
            # too (its cudaEvent pair is commented out, bsqp.cuh:125-138)
            "pcg_times_us": np.zeros(n_run, np.float32),
            "min_merit": min_merit.astype(np.float32),
            "step_size": step_size.astype(np.float32),
        }
        best_per_iter = min_merit.min(axis=1) if min_merit.size else np.array([], np.float32)
        stats["best_merit_per_iter"] = best_per_iter
        stats["best_merit_iter1"] = float(best_per_iter[0]) if best_per_iter.size else float("nan")
        denom = stats["best_initial_merit"]
        if np.size(denom) and denom:
            stats["best_merit_per_iter_normalized"] = best_per_iter / float(denom)
        else:
            stats["best_merit_per_iter_normalized"] = best_per_iter
        return stats

    def sim_forward(self, xk, uk, sim_dt):
        """One dynamics step of (xk, uk) under each problem's wrench
        hypothesis (interface.py:221-224): (B, nx) numpy."""
        out = sim_forward_batched(self.model, self._tensor(xk, self.nx),
                                  self._tensor(uk, self.nu), self.f_ext_B, float(sim_dt))
        return out.cpu().numpy()

    def ee_pos(self, q):
        """EE xyz of configuration q by the port's own FK (the reference
        used Pinocchio here, interface.py:212-214)."""
        return ee_position(self.model, self._tensor(q, self.nq))[:3].cpu().numpy()

    # ---- state management (interface.py:216-234, bsqp.cuh:63-89) ----

    def set_rho_penalty_batch(self, rho_batch, set_as_reset_default=True):
        arr = self._batch(rho_batch)
        self.hp = dataclasses.replace(self.hp, rho=arr)
        if set_as_reset_default:
            self._hp_init = dataclasses.replace(self._hp_init, rho=arr)

    def set_drho_batch(self, drho_batch, set_as_reset_default=True):
        arr = self._batch(drho_batch)
        self.hp = dataclasses.replace(self.hp, drho=arr)
        if set_as_reset_default:
            self._hp_init = dataclasses.replace(self._hp_init, drho=arr)

    def set_mu_batch(self, mu_batch):
        self.hp = dataclasses.replace(self.hp, mu=self._batch(mu_batch))

    def set_pcg_tol_batch(self, pcg_tol_batch):
        self.hp = dataclasses.replace(self.hp, pcg_tol=self._batch(pcg_tol_batch))

    def set_rho_adaptation(self, enabled: bool):
        """Toggle the line search's rho adaptation (set_rho_adaptation,
        bsqp.cuh:89)."""
        self.settings = dataclasses.replace(self.settings, adapt_rho=bool(enabled))

    def set_f_ext_B(self, f_ext_B):
        """Each problem's EE-frame wrench hypothesis, (B, 6): numpy, or a
        tensor on the solver's device (kept there)."""
        if isinstance(f_ext_B, torch.Tensor):
            self.f_ext_B = f_ext_B.to(self.device, self._dtype).reshape(self.batch_size, 6)
        else:
            self.f_ext_B = self._tensor(f_ext_B, (self.batch_size, 6))

    def reset_rho(self):
        self.hp = dataclasses.replace(self.hp, rho=self._hp_init.rho,
                                      drho=self._hp_init.drho)

    def reset_dual(self):
        self.lam = torch.zeros_like(self.lam)

    def reset(self):
        self.reset_dual()
        self.set_f_ext_B(np.zeros((self.batch_size, 6)))
        self.XU_B = np.zeros_like(self.XU_B)

    def get_stats(self):
        return self.stats
