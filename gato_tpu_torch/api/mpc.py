"""Closed-loop MPC: figure-8 tracking, goal sequences, batched force-
hypothesis selection, and the pendulum-payload plant.

Port of gato_tpu/api/mpc.py (the reference's python/bsqp/mpc_controller.py,
MPC_GATO). As in the JAX package, the simulator is the port's own RK4
(api/common.rk4_step) instead of Pinocchio, the pendulum payload is a
3-revolute gimbal at the EE, and a constant world-frame wrench is
re-expressed in the EE link frame at every stage evaluation. The plant
state stays on the solver's device; the host reads it once a cycle.

The simulation advances each cycle by the solve's measured time when
`realtime=True` (the reference's emulation, mpc_controller.py:189-216: on
the card the solve's device time by CUDA events, else its wall time), or
else by `control_dt` seconds, which defaults to `dt`.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ..ops.cuda_sim import has_cuda_kernel
from ..robots.model import RobotModel, register_parsed
from ..robots.urdf import ParsedRobot, spatial_inertia
from .common import rk4_step, world_wrench_to_ee_frame
from .config import DEFAULT_SOLVER_PARAMS
from .force_estimator import ForceEstimator
from .force_estimator_device import observer_update
from .interface import BSQP


class _GraphedStep:
    """One plant step on the rigid-body algorithms, captured in a CUDA
    graph: x and u are copied into the graph's inputs and the state it
    writes is returned. The step launches several thousand small kernels
    (a few hundred per forward dynamics call, four calls a substep); a
    replay issues them without the host's cost per launch. The JAX package
    gets the same from jax.jit with a static substep count."""

    def __init__(self, step, x, u):
        self.x, self.u = x.clone(), u.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # library handles and workspaces first
            step(self.x, self.u)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = step(self.x, self.u)

    def __call__(self, x, u):
        self.x.copy_(x)
        self.u.copy_(u)
        self.graph.replay()
        return self.out.clone()


def add_pendulum(model: RobotModel, mass=15.0, length=0.3):
    """Append a spherical-pendulum payload as a 3-revolute (x, y, z) gimbal
    at the EE (the reference's _add_pendulum_to_model,
    mpc_controller.py:340-359; a simulation model only, the solver keeps
    the robot). A small armature inertia on the massless gimbal links keeps
    the mass matrix nonsingular at gimbal lock, which the reference's
    spherical joint does not have.

    The augmented plant's constants are registered under its key, as the
    JAX package registers them (gato_tpu/api/mpc.py:72-83): the channel
    trace (the rk4 kernel's plain version) and the code generator read
    them there, and the rk4 kernel's library for the plant is generated
    from them (ops/cuda_sim.py::require_cuda_robot)."""
    eye = np.eye(3)
    bob = spatial_inertia(mass, np.array([0.0, 0.0, -length]), np.diag([1e-3] * 3))
    armature = np.zeros((6, 6))
    armature[:3, :3] = eye * 5e-3
    wide = np.tile([-1e3, 1e3], (3, 1))

    def cat(a, b):
        return torch.cat([a, torch.as_tensor(np.asarray(b), dtype=a.dtype, device=a.device)])

    aug = replace(
        model,
        R_tree=cat(model.R_tree, np.tile(eye, (3, 1, 1))),
        p_tree=cat(model.p_tree, np.zeros((3, 3))),
        axis=cat(model.axis, eye),
        inertia=cat(model.inertia, np.stack([armature, armature, bob])),
        joint_limits=cat(model.joint_limits, wide),
        velocity_limits=cat(model.velocity_limits, wide),
        effort_limits=cat(model.effort_limits, wide),
        key=f"{model.key}+pendulum(m={mass},l={length})",
        name=f"{model.name}+pendulum")

    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    register_parsed(aug.key, ParsedRobot(
        name=aug.key, nq=aug.nq, joint_names=[], R_tree=f64(aug.R_tree),
        p_tree=f64(aug.p_tree), axis=f64(aug.axis), inertia=f64(aug.inertia),
        joint_limits=f64(aug.joint_limits), velocity_limits=f64(aug.velocity_limits),
        effort_limits=f64(aug.effort_limits), R_ee=f64(aug.R_ee), p_ee=f64(aug.p_ee)))
    return aug


class MPC_GATO:
    """Closed-loop MPC controller (mpc_controller.py:17-599 analogue), on
    the card unless `device="cpu"`."""

    def __init__(
        self,
        model=None,
        model_path=None,
        N=32,
        dt=0.03125,
        batch_size=1,
        constant_f_ext=None,
        track_full_stats=False,
        plant_type="indy7",
        pendulum_config=None,
        solver_params=None,
        realtime=False,
        control_dt=None,
        seed=0,
        estimator="sphere",
        device="cuda",
    ):
        if estimator not in ("sphere", "observer"):
            raise ValueError(f"estimator={estimator!r}: expected 'sphere' or 'observer'")
        cfg = dict(DEFAULT_SOLVER_PARAMS)
        if solver_params:
            cfg.update(solver_params)
        self.solver = BSQP(
            model_path=model_path, batch_size=batch_size, N=N, dt=dt,
            plant_type=plant_type, device=device,
            **{k: cfg[k] for k in (
                "max_sqp_iters", "kkt_tol", "max_pcg_iters", "pcg_tol",
                "solve_ratio", "mu", "q_cost", "qd_cost", "u_cost", "N_cost",
                "q_lim_cost", "vel_lim_cost", "ctrl_lim_cost", "rho")})
        self.solver_params = cfg
        self.solver_model = self.solver.model
        self.device = self.solver.device

        self.pendulum_config = pendulum_config
        self.has_pendulum = pendulum_config is not None
        self.sim_model = (add_pendulum(self.solver_model,
                                       mass=pendulum_config.get("mass", 15.0),
                                       length=pendulum_config.get("length", 0.3))
                          if self.has_pendulum else self.solver_model)

        self.nq_robot = self.solver_model.nq
        self.nv_robot = self.solver_model.nv
        self.nq_sim = self.sim_model.nq
        self.nx = self.solver.nx
        self.nu = self.solver.nu
        self.N = N
        self.dt = dt
        self.batch_size = batch_size
        self.track_full_stats = track_full_stats
        self.realtime = realtime
        self.control_dt = control_dt
        self.rng = np.random.default_rng(seed)

        self.constant_f_ext_world = (np.asarray(constant_f_ext, np.float32)
                                     if constant_f_ext is not None
                                     else np.zeros(6, np.float32))
        self._sim_fext = (self._tensor(self.constant_f_ext_world)
                          if np.any(self.constant_f_ext_world) else None)
        # on the card, a plant step that takes the rigid-body algorithms (a
        # world wrench, or a plant the rk4 kernel does not serve) is
        # replayed from a CUDA graph per (substeps, step length); the RK4
        # kernel is one launch and needs none
        self._graphs = ({} if self.device.type == "cuda" and (
            self._sim_fext is not None or not has_cuda_kernel(self.sim_model, "rk4"))
            else None)
        # estimator="sphere": the reference's random-search ForceEstimator;
        # "observer": the Gauss-Newton wrench observer
        # (api/force_estimator_device.py), fed the previous cycle's
        # transition under rk4_step's world-wrench path. Both need B > 1.
        self.estimator_mode = estimator
        self._w_obs = np.zeros(6, np.float32)
        self.force_estimator = (ForceEstimator(
            batch_size=batch_size, initial_radius=5.0, min_radius=2.0,
            max_radius=20.0, smoothing_factor=0.5, seed=seed)
            if batch_size > 1 and estimator == "sphere" else None)
        self._observer = batch_size > 1 and estimator == "observer"

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ---- helpers ----

    def _sim_step(self, x, u, h, substeps=1):
        def step(x, u):
            return rk4_step(self.sim_model, x, u, h, f_ext_world=self._sim_fext,
                            substeps=substeps)

        if self._graphs is None:
            return step(x, u)
        key = (substeps, h)
        if key not in self._graphs:
            self._graphs[key] = _GraphedStep(step, x, u)
        return self._graphs[key](x, u)

    def _sim_control(self, u_robot, xsim):
        """Robot torques plus the pendulum's damping torques
        (mpc_controller.py:472-479)."""
        if not self.has_pendulum:
            return u_robot
        damping = self.pendulum_config.get("damping", 0.4)
        return torch.cat([u_robot, -damping * xsim[self.nq_sim + self.nv_robot:]])

    def _robot_state(self, xsim):
        """The robot's [q; qd] on the host: one read of the plant state."""
        x = xsim.cpu().numpy()
        return np.concatenate([x[:self.nq_robot],
                               x[self.nq_sim:self.nq_sim + self.nv_robot]])

    def _initial_sim_state(self, x_start):
        if not self.has_pendulum:
            return self._tensor(x_start)
        nqs = self.nq_sim
        x = np.zeros(nqs + self.sim_model.nv, np.float32)
        x[:self.nq_robot] = x_start[:self.nq_robot]
        x[self.nq_robot:self.nq_robot + 3] = self.pendulum_config.get(
            "initial_angle", np.array([0.3, 0.0, 0.0]))
        x[nqs:nqs + self.nv_robot] = x_start[self.nq_robot:]
        return self._tensor(x)

    def update_force_batch(self, q):
        """Hand the solver the estimator's wrench hypotheses, expressed in
        the EE frame (mpc_controller.py:279-292). The observer's batch: lane
        0 its estimate, lane 1 zero (the safe hypothesis), the rest copies."""
        if self._observer:
            batch = np.tile(self._w_obs, (self.batch_size, 1))
            batch[1] = 0.0
        elif self.force_estimator is None:
            return
        else:
            batch = self.force_estimator.generate_batch()
        self.solver.set_f_ext_B(world_wrench_to_ee_frame(
            self.solver_model, self._tensor(q[:self.nq_robot]), self._tensor(batch)))

    def _observe(self, w, x_last, u_last, x_meas, dt_cycle):
        """One observer step on the transition (x_last, u_last) -> x_meas:
        the prediction is rk4_step under the world wrench hypothesis, two
        substeps over the cycle."""
        def pred(wh):
            return rk4_step(self.solver_model, x_last, u_last, dt_cycle, f_ext_world=wh,
                            substeps=2)
        return observer_update(pred, w, x_meas)

    def transform_force_to_gato_frame(self, q, f_world):
        """World wrench -> the solver's EE-frame [n; f] spatial force
        (mpc_controller.py:311-338 analogue, by the port's own FK)."""
        return world_wrench_to_ee_frame(self.solver_model, self._tensor(q[:self.nq_robot]),
                                        self._tensor(f_world)).cpu().numpy()

    def evaluate_best_trajectory(self, x_last, u_last, x_curr, dt):
        """The hypothesis whose one-step rollout best matches the measured
        state (mpc_controller.py:294-309)."""
        if self.force_estimator is None and not self._observer:
            return 0
        x_next = self.solver.sim_forward(x_last, u_last, dt)
        errors = np.linalg.norm(x_next - np.asarray(x_curr)[None, :], axis=1)
        # a dead lane (a diverged solve) predicts NaN, which np.argmin would
        # select: non-finite errors are out of the competition
        errors = np.where(np.isfinite(errors), errors, np.inf)
        best = int(np.argmin(errors))
        if self._observer:
            self._w_obs = self._observe(
                self._tensor(self._w_obs), self._tensor(x_last), self._tensor(u_last),
                self._tensor(x_curr), float(np.float32(dt))).cpu().numpy()
        else:
            self.force_estimator.update(best, errors, alpha=0.6, beta=0.5)
        return best

    def _cycle_timestep(self, solve_time):
        """Seconds the plant advances in one MPC cycle."""
        if not self.realtime:
            return self.control_dt or self.dt
        dev = self.solver.device_solve_time_us
        return dev * 1e-6 if dev else solve_time

    def _simulate(self, xsim, XU_best, timestep, sim_dt):
        """Advance the plant by `timestep`, stepping controls along the plan.
        Consecutive substeps under the same plan control go in one call
        (rk4_step over their total time); the pendulum's damping torques
        are refreshed per call."""
        nsteps = max(1, int(round(timestep / sim_dt)))
        i = 0
        while i < nsteps:
            offset = int(i / (self.dt / sim_dt))
            j = i + 1
            while j < nsteps and int(j / (self.dt / sim_dt)) == offset:
                j += 1
            u_idx = self.nx + (self.nx + self.nu) * min(offset, self.N - 1)
            u = self._tensor(XU_best[u_idx:u_idx + self.nu])
            xsim = self._sim_step(xsim, self._sim_control(u, xsim),
                                  float(np.float32((j - i) * sim_dt)), substeps=j - i)
            i = j
        return xsim, nsteps * sim_dt

    def _start(self, x_start, ee_g):
        """The plant's start state, the warm start tiled over the batch and
        the first solve."""
        B, N = self.batch_size, self.N
        xsim = self._initial_sim_state(np.asarray(x_start, np.float32))
        x_curr = self._robot_state(xsim)
        ee_g_batch = np.tile(ee_g, (B, 1))
        XU = np.zeros(N * (self.nx + self.nu) - self.nu, np.float32)
        for i in range(N):
            XU[i * (self.nx + self.nu): i * (self.nx + self.nu) + self.nx] = x_curr
        XU_batch = np.tile(XU, (B, 1))
        self.solver.reset_dual()
        self.update_force_batch(x_curr[:self.nq_robot])
        XU_batch, _ = self.solver.solve(np.tile(x_curr, (B, 1)), ee_g_batch, XU_batch)
        return xsim, x_curr, ee_g_batch, XU_batch

    def _control(self, x_last, XU_best, x_curr, ee_g_batch, XU_batch, timestep,
                 sim_dt):
        """One cycle's solve from the measured state and the choice of the
        best hypothesis: (XU_best, XU_batch, best, solve_time, gpu_us)."""
        B = self.batch_size
        u_last = XU_best[self.nx:self.nx + self.nu]
        XU_batch[:, :self.nx] = x_curr
        self.update_force_batch(x_curr[:self.nq_robot])
        self.solver.reset_rho()
        t0 = time.perf_counter()
        XU_batch_new, gpu_us = self.solver.solve(np.tile(x_curr, (B, 1)), ee_g_batch,
                                                 XU_batch)
        solve_time = time.perf_counter() - t0
        best = self.evaluate_best_trajectory(
            x_last, u_last, x_curr, max(sim_dt, round(timestep / sim_dt) * sim_dt))
        XU_best = XU_batch_new[best]
        XU_batch[:, :] = XU_best
        return XU_best, XU_batch, best, solve_time, gpu_us

    # ---- main entry points ----

    def run_mpc_fig8(self, x_start, fig8_traj, sim_dt=0.001, sim_time=5.0):
        """Figure-8 tracking MPC (mpc_controller.py:136-277). Returns
        (None, stats) like the reference."""
        stats = {"timestamps": [], "solve_times": [], "goal_distances": [],
                 "ee_actual": [], "joint_positions": [], "joint_velocities": []}
        if self.track_full_stats:
            stats["sqp_iters"] = []
        fig8_traj = np.asarray(fig8_traj, np.float32).reshape(-1)
        N = self.N
        total_sim_time = 0.0
        xsim, x_curr, ee_g_batch, XU_batch = self._start(x_start, fig8_traj[:6 * N])
        XU_best = XU_batch[0]
        solve_time = self.dt
        while total_sim_time < sim_time:
            x_last = x_curr
            timestep = self._cycle_timestep(solve_time)
            xsim, advanced = self._simulate(xsim, XU_best, timestep, sim_dt)
            total_sim_time += advanced
            x_curr = self._robot_state(xsim)
            eepos_offset = int(total_sim_time / self.dt)
            if eepos_offset >= len(fig8_traj) / 6 - 6 * N:
                break
            ee_g = fig8_traj[6 * eepos_offset: 6 * (eepos_offset + N)]
            ee_g_batch[:, :] = ee_g
            XU_best, XU_batch, _, solve_time, gpu_us = self._control(
                x_last, XU_best, x_curr, ee_g_batch, XU_batch, timestep, sim_dt)
            ee = self.solver.ee_pos(x_curr[:self.nq_robot])
            stats["timestamps"].append(total_sim_time)
            stats["solve_times"].append(gpu_us / 1000.0)
            stats["goal_distances"].append(float(np.linalg.norm(ee - ee_g[6:9])))
            stats["ee_actual"].append(ee.copy())
            stats["joint_positions"].append(x_curr[:self.nq_robot].copy())
            stats["joint_velocities"].append(x_curr[self.nq_robot:].copy())
            if self.track_full_stats:
                stats["sqp_iters"].append(int(self.solver.stats["sqp_iters"][0]))
        for k in stats:
            if isinstance(stats[k], list) and stats[k]:
                stats[k] = np.array(stats[k])
        if len(np.atleast_1d(stats["goal_distances"])):
            print(f"Avg error: {np.mean(stats['goal_distances']):.4f}m")
            print(f"Avg solve time: {np.mean(stats['solve_times']):.3f}ms")
        return None, stats

    def run_mpc_goals(self, x_start, goals, sim_dt=0.001, goal_timeout=5.0,
                      goal_threshold=0.05, velocity_threshold=1.0):
        """Waypoint-sequence MPC with reached/timeout outcomes
        (mpc_controller.py:361-599)."""
        N = self.N
        stats = {
            "timestamps": [], "solve_times": [], "goal_distances": [],
            "ee_actual": [], "joint_positions": [], "joint_velocities": [],
            "best_trajectory_id": [],
            "goal_outcomes": ["not_reached"] * len(goals),
            "goal_reached_times": [None] * len(goals),
            "time_to_all_reached": None,
        }
        if self.track_full_stats:
            stats["sqp_iters"] = []
            stats["pcg_iters"] = []

        def goal_ref(i):
            goal = np.asarray(goals[i], np.float32)
            return goal, np.tile(np.concatenate([goal, np.zeros(3, np.float32)]), N)

        total_sim_time = 0.0
        goal_idx = 0
        goal, ee_g = goal_ref(goal_idx)
        xsim, x_curr, ee_g_batch, XU_batch = self._start(x_start, ee_g)
        XU_best = XU_batch[0]
        goal_start_time = total_sim_time
        solve_time = self.dt
        while total_sim_time < goal_timeout * len(goals):
            x_last = x_curr
            timestep = self._cycle_timestep(solve_time)
            xsim, advanced = self._simulate(xsim, XU_best, timestep, sim_dt)
            total_sim_time += advanced
            x_curr = self._robot_state(xsim)

            ee = self.solver.ee_pos(x_curr[:self.nq_robot])
            dist = float(np.linalg.norm(ee - goal))
            vel = float(np.linalg.norm(x_curr[self.nq_robot:], ord=1))
            reached = dist < goal_threshold and vel < velocity_threshold
            if reached or (total_sim_time - goal_start_time) >= goal_timeout:
                stats["goal_outcomes"][goal_idx] = "reached" if reached else "timeout"
                if reached:
                    stats["goal_reached_times"][goal_idx] = total_sim_time
                goal_idx += 1
                if goal_idx >= len(goals):
                    break
                goal, ee_g = goal_ref(goal_idx)
                goal_start_time = total_sim_time
                self.solver.reset_rho()

            ee_g_batch[:, :] = ee_g
            XU_best, XU_batch, best, solve_time, gpu_us = self._control(
                x_last, XU_best, x_curr, ee_g_batch, XU_batch, timestep, sim_dt)
            stats["timestamps"].append(total_sim_time)
            stats["solve_times"].append(gpu_us / 1000.0)
            stats["goal_distances"].append(dist)
            stats["ee_actual"].append(ee.copy())
            stats["joint_positions"].append(x_curr[:self.nq_robot].copy())
            stats["joint_velocities"].append(x_curr[self.nq_robot:].copy())
            stats["best_trajectory_id"].append(best)
            if self.track_full_stats:
                stats["sqp_iters"].append(int(self.solver.stats["sqp_iters"][0]))
                pcg = self.solver.stats.get("pcg_iters", np.zeros((0, 0)))
                stats["pcg_iters"].append(int(pcg[0, 0]) if pcg.size else 0)

        for k, v in stats.items():
            if isinstance(v, list) and v and k not in (
                    "goal_outcomes", "goal_reached_times", "time_to_all_reached"):
                try:
                    stats[k] = np.array(v)
                except (ValueError, TypeError):
                    pass
        if all(o == "reached" for o in stats["goal_outcomes"]):
            ts = [t for t in stats["goal_reached_times"] if t is not None]
            if len(ts) == len(goals):
                stats["time_to_all_reached"] = float(np.max(ts))
        reached_n = sum(1 for o in stats["goal_outcomes"] if o == "reached")
        print(f"Goals reached: {reached_n}/{len(goals)}")
        return None, stats
