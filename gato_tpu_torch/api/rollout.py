"""On-device closed-loop MPC rollouts.

Port of gato_tpu/api/rollout.py. The whole closed loop (the batched solve,
the best lane's choice, the plant step, optionally on another plant such
as the pendulum-augmented one, the wrench estimator and the warm start)
runs on the solver's device with no read on the host inside the loop:

  closed_loop_rollout            fixed per-lane wrench hypotheses, the lane
                                 chosen by its one-step prediction;
  closed_loop_rollout_goals      a goal sequence (pick-and-place) with the
                                 sphere-search estimator;
  closed_loop_rollout_estimator  force-adaptive MPC under a true world
                                 wrench: the sphere search or the
                                 Gauss-Newton observer (estimator="observer").

Each takes the JAX function's arguments and returns its outputs, but for
the random draws: the JAX `key` becomes `uniforms`, a tensor of the
estimator's (n_steps, 3) uniform draws or a torch.Generator that draws them
before the loop, so the loop holds no random number generator.

One cycle is a function of a state of tensors. On the card (graph=None or
True) one cycle is captured once into a torch.cuda.CUDAGraph, after one
cycle run eagerly to warm up, and replayed n_steps times: before each
replay the cycle's reference window and draws are copied into the graph's
inputs, after it its outputs into (n_steps, ...) tensors. The solve is
solve_batched with the exit kept on the device (bsqp_iter, max_sqp_iters
launches a cycle at N <= 128). The plant step follows the JAX package's TPU
branch: rk4_step_batched (csrc/rk4.cu on the card) over sim_substeps in one
launch, with the estimator loop's EE-frame wrench, for every plant the
kernel serves: indy7, iiwa14 and the pendulum-augmented plants add_pendulum
makes of them, whose library is generated and built at the first call,
in the warm-up cycle before the capture. The predictions that score the
lanes follow the JAX code: the solver's integrator
(ops/integrators.py::sim_step) or RK4 on the rigid-body algorithms (the
JAX package's _rk4, outside any Pallas kernel).

`graph=False` runs the same cycles eagerly (the CPU's only mode).
`last_capture` describes the last graph: "launches", the kernel launches
its one cycle holds, and "events", CUDA events recorded around its
n_steps replays (read them after a sync).
"""

from __future__ import annotations

import math
from dataclasses import fields, replace

import torch

from ..dynamics.algorithms import fk
from ..ops.cuda_sim import has_cuda_kernel, rk4_step_batched
from ..ops.cuda_solve import sqp_iter_cuda
from ..ops.integrators import sim_step
from ..solver.bsqp import solve_batched
from .common import _rk4_algorithms, world_wrench_to_ee_frame
from .force_estimator_device import (FEState, fe_generate, fe_init, fe_update,
                                     fibonacci_sphere, observer_update)

last_capture: dict = {}
_COUNTED = {"bsqp_iter": sqp_iter_cuda, "rk4": rk4_step_batched}


def _launch_counts():
    return {name: w.launches for name, w in _COUNTED.items()}


def _run(cycle, state: dict, per_step: dict, n_steps: int, graph):
    """n_steps cycles of cycle(state, inputs) -> (state, outputs), inputs
    the k-th rows of per_step. Returns (final state, outputs stacked over
    the cycles)."""
    cuda = next(iter(state.values())).is_cuda
    if graph is None:
        graph = cuda
    if graph and not cuda:
        raise ValueError("graph=True needs the rollout's tensors on the card")
    if not graph:
        outs = []
        for k in range(n_steps):
            state, out = cycle(state, {n: v[k] for n, v in per_step.items()})
            outs.append(out)
        return state, {n: torch.stack([o[n] for o in outs]) for n in outs[0]}

    static = {n: v.clone() for n, v in state.items()}
    inputs = {n: v[0].clone() for n, v in per_step.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # library handles and workspaces first
        cycle(static, inputs)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = _launch_counts()
    with torch.cuda.graph(g):
        new, out = cycle(static, inputs)
        # new values may alias the old state: copy each out first
        new = {n: v.clone() for n, v in new.items()}
        out = {n: v.clone() for n, v in out.items()}
        for n, v in new.items():
            if v.dtype != static[n].dtype or v.shape != static[n].shape:
                raise TypeError(f"rollout state {n!r} changes from {static[n].dtype} "
                                f"{tuple(static[n].shape)} to {v.dtype} {tuple(v.shape)}")
            static[n].copy_(v)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    last_capture.clear()
    last_capture.update(launches={n: c - before[n] for n, c in _launch_counts().items()},
                        events=events)
    outs = {n: v.new_empty((n_steps,) + v.shape) for n, v in out.items()}
    events[0].record()
    for k in range(n_steps):
        for n, v in per_step.items():
            inputs[n].copy_(v[k])
        g.replay()
        for n, v in out.items():
            outs[n][k].copy_(v)
    events[1].record()
    return static, outs


def _check_devices(model, *tensors):
    dev = model.R_tree.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"the model is on {dev}, an input on {t.device}: "
                             "move the inputs to the model's device")


def _draws(uniforms, n_steps, dtype, device):
    """The estimator's (n_steps, 3) uniform draws: given, or drawn from a
    torch.Generator before the loop."""
    if isinstance(uniforms, torch.Generator):
        return torch.rand(n_steps, 3, generator=uniforms, dtype=dtype,
                          device=uniforms.device).to(device)
    if uniforms.shape != (n_steps, 3):
        raise ValueError(f"uniforms: expected ({n_steps}, 3), got {tuple(uniforms.shape)}")
    return uniforms


def _plant_step(sim_model, x, u, control_dt, substeps, f_ext=None):
    """sim_substeps RK4 substeps of the plant over control_dt: the rk4
    kernel for a plant it serves (indy7, iiwa14 and their pendulum plants;
    its plain version on the CPU), as the JAX package's TPU branch. The
    rigid-body algorithms only for a plant loaded from another URDF path,
    which the JAX package's TPU branch would trace into its kernel and the
    port builds no library for (ROADMAP Queue 2). A failed build or launch
    raises. f_ext: EE-frame wrench (6,)."""
    if has_cuda_kernel(sim_model, "rk4"):
        fe = None if f_ext is None else f_ext[None].contiguous()
        return rk4_step_batched(sim_model, x[None].contiguous(), u[None].contiguous(),
                                control_dt, fe, substeps)[0]
    return _rk4_algorithms(sim_model, x, u, control_dt, None, substeps, f_ext=f_ext)


def _argmin_finite(errs):
    """The lane of the smallest finite error (a dead lane's NaN must not
    win) and the masked errors."""
    errs = torch.where(torch.isfinite(errs), errs, math.inf)
    return torch.argmin(errs), errs


def _tile_best(T, best):
    return T.index_select(0, best.reshape(1)).expand_as(T).contiguous()


def _fe_dict(fe: FEState):
    return {"fe_" + f.name: getattr(fe, f.name) for f in fields(FEState)}


def _fe_from(state):
    return FEState(**{f.name: state["fe_" + f.name] for f in fields(FEState)})


def closed_loop_rollout(model, sim_model, settings, cp, hp, x_sim0, refs, f_ext,
                        dt, control_dt, sim_substeps: int = 4,
                        pendulum_damping: float | None = None, graph=None):
    """Returns (x_sim trajectory (n_steps, nx_sim), EE positions (n_steps,
    3), chosen controls (n_steps, nu)). refs: (n_steps, N, 6) reference
    windows, f_ext: (B, 6) per-lane EE-frame wrench hypotheses."""
    _check_devices(model, x_sim0, refs, f_ext)
    B, N = f_ext.shape[0], settings.N
    nq, nx, nu = model.nq, model.nx, model.nu
    nq_s = sim_model.nq
    dt, control_dt = float(dt), float(control_dt)

    def robot_state(x_sim):
        return torch.cat([x_sim[:nq], x_sim[nq_s:nq_s + nq]])

    x0 = robot_state(x_sim0)

    def cycle(s, inp):
        x_sim = s["x_sim"]
        x_cur = robot_state(x_sim)
        x_s = x_cur.expand(B, nx).contiguous()
        X = torch.cat([x_s[:, None], s["X"][:, 1:]], 1)
        Xo, Uo, lam, _, _ = solve_batched(
            model, settings, cp, hp, X, s["U"], s["lam"], x_s,
            inp["ref"].expand(B, N, inp["ref"].shape[-1]).contiguous(), f_ext, dt,
            device_exit=True)
        if B > 1:
            # the reference's evaluate_best_trajectory: the lane whose
            # one-step rollout of the previous (state, control) explains the
            # state just measured, not the lowest merit
            pred = sim_step(model, s["x_last"].expand(B, nx), s["u_last"].expand(B, nu),
                            control_dt, f_ext, settings.integrator_type)
            best = _argmin_finite(torch.linalg.vector_norm(pred - x_cur, dim=1))[0]
        else:
            best = torch.zeros((), dtype=torch.long, device=x_sim.device)
        u0 = Uo.index_select(0, best.reshape(1))[0, 0]
        u_sim = (u0 if pendulum_damping is None else
                 torch.cat([u0, -pendulum_damping * x_sim[nq_s + nq:]]))
        x_sim = _plant_step(sim_model, x_sim, u_sim, control_dt, sim_substeps)
        ee = fk(model, robot_state(x_sim)[:nq])[1][-1]
        return (dict(x_sim=x_sim, X=_tile_best(Xo, best), U=_tile_best(Uo, best),
                     lam=lam, x_last=x_cur, u_last=u0),
                dict(x=x_sim, ee=ee, u=u0))

    state = dict(x_sim=x_sim0, X=x0.expand(B, N, nx).contiguous(),
                 U=x0.new_zeros(B, N - 1, nu), lam=x0.new_zeros(B, N, nx),
                 x_last=x0, u_last=x0.new_zeros(nu))
    _, out = _run(cycle, state, {"ref": refs}, refs.shape[0], graph)
    return out["x"], out["ee"], out["u"]


def closed_loop_rollout_goals(model, sim_model, settings, cp, hp, x_sim0, goals,
                              dt, control_dt, uniforms, batch_size: int,
                              n_steps: int, goal_timeout: float = 5.0,
                              goal_threshold: float = 0.05,
                              velocity_threshold: float = 1.0,
                              sim_substeps: int = 2,
                              pendulum_damping: float | None = None,
                              initial_radius: float = 5.0,
                              score_substeps: int = 0, graph=None):
    """Goal-sequence (pick-and-place) MPC on the device: MPC_GATO.run_mpc_goals'
    host loop cycle for cycle (simulate under the best plan's first control,
    measure, test reached (distance < goal_threshold and |qd|_1 <
    velocity_threshold) or timeout, advance the goal, generate hypotheses,
    solve, score the batch on the transition just observed, select, update
    the estimator with alpha=0.6, beta=0.5, radius in [2, 20], smoothing
    0.5). goals: (G, 3); n_steps >= goal_timeout * G / control_dt lets every
    goal resolve.

    Returns (x_sim trajectory (n_steps, nx_sim), EE (n_steps, 3), distance
    to the goal (n_steps,), goal index per cycle (n_steps,), best lane per
    cycle (n_steps,), outcomes (G,) int32 [0 pending / 1 reached / 2
    timeout], reached times (G,) [-1 if not reached], smoothed estimates
    (n_steps, 6), radii (n_steps,)). Time and reached times are float32, as
    in the JAX package."""
    _check_devices(model, x_sim0, goals)
    B, N, G = batch_size, settings.N, goals.shape[0]
    nq, nx, nu = model.nq, model.nx, model.nu
    nq_s = sim_model.nq
    dev, dtype = x_sim0.device, x_sim0.dtype
    dt, control_dt = float(dt), float(control_dt)
    draws = _draws(uniforms, n_steps, dtype, dev)

    def robot_state(x_sim):
        return torch.cat([x_sim[:nq], x_sim[nq_s:nq_s + nq]])

    x0 = robot_state(x_sim0)
    use_est = B > 3
    dirs = torch.tensor(fibonacci_sphere(max(B - 3, 0)), device=dev)
    lanes = torch.arange(G, device=dev)

    def ref_for(goal):
        return goal[None, None, :].expand(B, N, 3).contiguous()

    def hyps(fe, q):
        W = fe_generate(fe, dirs) if use_est else x0.new_zeros(B, 6)
        return world_wrench_to_ee_frame(model, q, W)

    fe0 = fe_init(initial_radius, dtype=dtype, device=dev)
    # the warm-up solve at goal 0, once, outside the loop (the host loop's
    # solve before its first cycle)
    Xo, Uo, lam, _, _ = solve_batched(
        model, settings, cp, hp, x0.expand(B, N, nx).contiguous(),
        x0.new_zeros(B, N - 1, nu), x0.new_zeros(B, N, nx),
        x0.expand(B, nx).contiguous(), ref_for(goals[0]), hyps(fe0, x0[:nq]), dt,
        device_exit=True)
    zero = torch.zeros((), dtype=torch.long, device=dev)

    def cycle(s, inp):
        x_sim, fe = s["x_sim"], _fe_from(s)
        x_last = robot_state(x_sim)
        u_last = s["U"][0, 0]
        u_sim = (u_last if pendulum_damping is None else
                 torch.cat([u_last, -pendulum_damping * x_sim[nq_s + nq:]]))
        x_sim = _plant_step(sim_model, x_sim, u_sim, control_dt, sim_substeps)
        t = s["t"] + control_dt
        x_cur = robot_state(x_sim)

        ee = fk(model, x_cur[:nq])[1][-1]
        goal_idx = s["goal_idx"]
        dist = torch.linalg.vector_norm(ee - goals.index_select(0, goal_idx.reshape(1))[0])
        vel = x_cur[nq:].abs().sum()
        reached = (dist < goal_threshold) & (vel < velocity_threshold)
        timeout = (t - s["goal_start"]) >= goal_timeout
        fire = (reached | timeout) & ~s["done"]
        at = (lanes == goal_idx) & fire
        code = torch.where(reached, 1, 2).to(torch.int32)
        outcomes = torch.where(at, code, s["outcomes"])
        reached_t = torch.where(at & reached, t, s["reached_t"])
        goal_idx = torch.where(fire, goal_idx + 1, goal_idx)
        done = s["done"] | (goal_idx >= G)
        goal_idx = torch.clamp(goal_idx, 0, G - 1)
        goal_start = torch.where(fire, t, s["goal_start"])
        goal = goals.index_select(0, goal_idx.reshape(1))[0]

        batch = hyps(fe, x_cur[:nq])
        x_s = x_cur.expand(B, nx).contiguous()
        X = torch.cat([x_s[:, None], s["X"][:, 1:]], 1)
        Xo, Uo, lam, _, _ = solve_batched(model, settings, cp, hp, X, s["U"], s["lam"],
                                          x_s, ref_for(goal), batch, dt, device_exit=True)
        if use_est:
            # score the fresh batch on the transition just observed: the
            # solver's integrator over the cycle (score_substeps=0, the host
            # loop's evaluate_best_trajectory) or the plant's RK4
            if score_substeps > 0:
                pred = _rk4_algorithms(model, x_last.expand(B, nx), u_last.expand(B, nu),
                                       control_dt, None, score_substeps, f_ext=batch)
            else:
                pred = sim_step(model, x_last.expand(B, nx), u_last.expand(B, nu),
                                control_dt, batch, settings.integrator_type)
            best, errs = _argmin_finite(torch.linalg.vector_norm(pred - x_cur, dim=1))
            fe = fe_update(fe, dirs, best, errs, inp["u"], alpha=0.6, beta=0.5,
                           min_radius=2.0, max_radius=20.0, smoothing_factor=0.5)
        else:
            best = zero
        new = dict(x_sim=x_sim, X=_tile_best(Xo, best), U=_tile_best(Uo, best), lam=lam,
                   goal_idx=goal_idx, goal_start=goal_start, t=t, outcomes=outcomes,
                   reached_t=reached_t, done=done, **_fe_dict(fe))
        return new, dict(x=x_sim, ee=ee, dist=dist, goal_idx=goal_idx, best=best,
                         smoothed=fe.smoothed, radius=fe.radius)

    f32 = dict(dtype=torch.float32, device=dev)
    state = dict(x_sim=x_sim0, X=Xo[0].expand(B, N, nx).contiguous(),
                 U=Uo[0].expand(B, N - 1, nu).contiguous(), lam=lam,
                 goal_idx=torch.zeros((), dtype=torch.int32, device=dev),
                 goal_start=torch.zeros((), **f32), t=torch.zeros((), **f32),
                 outcomes=torch.zeros(G, dtype=torch.int32, device=dev),
                 reached_t=torch.full((G,), -1.0, **f32),
                 done=torch.zeros((), dtype=torch.bool, device=dev), **_fe_dict(fe0))
    final, out = _run(cycle, state, {"u": draws}, n_steps, graph)
    return (out["x"], out["ee"], out["dist"], out["goal_idx"], out["best"],
            final["outcomes"], final["reached_t"], out["smoothed"], out["radius"])


def closed_loop_rollout_estimator(model, settings, cp, hp, x_sim0, refs, true_f_ext,
                                  dt, control_dt, batch_size: int, uniforms,
                                  sim_substeps: int = 4, initial_radius: float = 10.0,
                                  estimator: str = "sphere", graph=None):
    """Force-adaptive MPC on the device: each cycle generates the wrench
    hypotheses from the estimator state, solves, picks the lane whose
    prediction best explains the measured state, steps the true plant under
    `true_f_ext` (a constant WORLD-frame wrench [force; torque] at the EE,
    re-expressed in the EE frame once a cycle) and updates the estimator:
    the sphere search, or estimator="observer", the Gauss-Newton observer
    (lane 0 its estimate, lane 1 zero). The predictions use the plant's own
    RK4 substepping (on the rigid-body algorithms). Returns (x_sim
    trajectory, EE trajectory, smoothed estimates (n_steps, 6), per-cycle
    least prediction errors (n_steps,))."""
    if estimator not in ("sphere", "observer"):
        raise ValueError(f"estimator={estimator!r}: expected 'sphere' or 'observer'")
    _check_devices(model, x_sim0, refs, true_f_ext)
    B, N, n_steps = batch_size, settings.N, refs.shape[0]
    nq, nx, nu = model.nq, model.nx, model.nu
    dev, dtype = x_sim0.device, x_sim0.dtype
    dt, control_dt = float(dt), float(control_dt)
    draws = _draws(uniforms, n_steps, dtype, dev)
    dirs = torch.tensor(fibonacci_sphere(B - 3), device=dev)
    x0 = x_sim0[:nx]
    fe0 = fe_init(initial_radius, dtype=dtype, device=dev)

    def rk4(x, u, fe):
        return _rk4_algorithms(model, x, u, control_dt, None, sim_substeps, f_ext=fe)

    def cycle(s, inp):
        x_sim, fe = s["x_sim"], _fe_from(s)
        x_last, u_last = s["x_last"], s["u_last"]
        x_s = x_sim.expand(B, nx).contiguous()
        X = torch.cat([x_s[:, None], s["X"][:, 1:]], 1)
        # hypotheses in the WORLD frame (the estimator's [force; torque]),
        # handed to the solver in the EE frame as [n; f]
        if estimator == "observer":
            w = fe.estimate
            batch_w = torch.cat([w[None], torch.zeros_like(w)[None],
                                 w[None].expand(B - 2, 6)])
        else:
            batch_w = fe_generate(fe, dirs)
        batch = world_wrench_to_ee_frame(model, x_sim[:nq], batch_w)
        Xo, Uo, lam, _, _ = solve_batched(
            model, settings, cp, hp, X, s["U"], s["lam"], x_s,
            inp["ref"].expand(B, N, inp["ref"].shape[-1]).contiguous(), batch, dt,
            device_exit=True)
        # score the previous cycle's hypotheses on the state they predicted,
        # with the plant's own RK4 substepping
        pred = rk4(x_last.expand(B, nx), u_last.expand(B, nu), s["batch_last"])
        best, errs = _argmin_finite(torch.linalg.vector_norm(pred - x_sim, dim=1))
        if estimator == "observer":
            def pred_w(w):
                return rk4(x_last, u_last, world_wrench_to_ee_frame(model, x_last[:nq], w))

            w_new = observer_update(pred_w, fe.estimate, x_sim)
            # no transition to learn from before the first control
            w_new = torch.where(fe.err_count > 0, w_new, fe.estimate)
            fe = replace(fe, estimate=w_new, smoothed=w_new,
                         err_hist=torch.cat([fe.err_hist[1:], errs.min()[None]]),
                         err_count=fe.err_count + 1)
        else:
            fe = fe_update(fe, dirs, best, errs, inp["u"], alpha=0.6, beta=0.5,
                           min_radius=1.0, max_radius=100.0)
        u0 = Uo.index_select(0, best.reshape(1))[0, 0]
        # the true wrench is constant in the world frame: re-expressed at the
        # cycle's start configuration
        fe_loc = world_wrench_to_ee_frame(model, x_sim[:nq], true_f_ext)
        x_new = _plant_step(model, x_sim, u0, control_dt, sim_substeps, f_ext=fe_loc)
        ee = fk(model, x_new[:nq])[1][-1]
        new = dict(x_sim=x_new, X=_tile_best(Xo, best), U=_tile_best(Uo, best), lam=lam,
                   x_last=x_sim, u_last=u0, batch_last=batch, **_fe_dict(fe))
        return new, dict(x=x_new, ee=ee, smoothed=fe.smoothed, err=errs.min())

    state = dict(x_sim=x_sim0, X=x0.expand(B, N, nx).contiguous(),
                 U=x0.new_zeros(B, N - 1, nu), lam=x0.new_zeros(B, N, nx),
                 x_last=x0, u_last=x0.new_zeros(nu), batch_last=fe_generate(fe0, dirs),
                 **_fe_dict(fe0))
    _, out = _run(cycle, state, {"ref": refs, "u": draws}, n_steps, graph)
    return out["x"], out["ee"], out["smoothed"], out["err"]
