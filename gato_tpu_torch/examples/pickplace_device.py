"""Pick-and-place with a swinging pendulum payload on the card:
examples/pickplace.py's device loop (main_device) on the port.

iiwa14 is the solver's plant; the simulated plant is iiwa14 with a 15 kg
3R pendulum on its EE (add_pendulum, PENDULUM_DEFAULT_PARAMS), which the
solver does not see. The five PICKPLACE_DEFAULT_GOALS come in turn, each
reached (EE within 5 cm, |qd|_1 < 1) or timed out after 5 s; the sphere
estimator's wrench hypotheses fill the batch, scored each cycle by RK4 at
the plant's cadence (score_substeps=2, on the rigid-body algorithms, as
the JAX package scores them outside any Pallas kernel). Every cycle (the
plant step, the goal bookkeeping, the hypotheses, the solve with
PICKPLACE_SOLVER_PARAMS' five SQP iterations, the scoring and the
estimator) is one CUDA graph replay of
api/rollout.py::closed_loop_rollout_goals: five bsqp_iter launches and
one rk4 launch a cycle, the pendulum plant on the rk4 kernel built for it
(its header generated from the plant's constants at the first call).

Defaults are main_device's: N=32, dt=0.03125 (a 1 s horizon), control_dt
2 ms, batch sizes 1, 8, 32 and 128, ceil(5 goals x 5 s / 2 ms) + 2 =
12,502 cycles each, the estimator's draws from seed 0. The reference
notebook's own working point is --N 16 --dt 0.01. With several --seeds each
batch size past 3 (the ones with an estimator) runs once a seed and its
outcomes are summed up as the JAX package's sweeps are (min, median, max
goals reached). Rows go into a JSON file named for the card
(PICKPLACE_RESULTS_<card>.json unless --out says otherwise) under the JAX
package's record keys (N<N>_B<B>[_dt<dt>][_seed_sweep]), merged into what
the file holds, with the card's name and power limit beside them.

    python -m gato_tpu_torch.examples.pickplace_device
    python -m gato_tpu_torch.examples.pickplace_device --N 16 --dt 0.01 \
        --batch-sizes 32 128 --seeds 0 1 2 3 --out PATH
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from ..api.config import (PENDULUM_DEFAULT_PARAMS, PICKPLACE_DEFAULT_GOALS,
                          PICKPLACE_MPC_DEFAULTS, PICKPLACE_SOLVER_PARAMS)
from ..api.mpc import add_pendulum
from ..api import rollout
from ..ops.cost import CostParams
from ..robots.model import load_robot
from ..solver.types import BSQPSettings, HyperParams

OUTCOMES = {0: "not_reached", 1: "reached", 2: "timeout"}
BATCH_SIZES = (1, 8, 32, 128)


def n_cycles(n_goals: int, goal_timeout: float, control_dt: float) -> int:
    """Cycles enough for every goal to resolve (main_device's count)."""
    return int(np.ceil(goal_timeout * n_goals / control_dt)) + 2


def pickplace_setup(batch_size: int, N: int = 32, device="cuda", goals=None):
    """(solver model, plant model, settings, cost, hyperparameters, x_sim0,
    goals (G, 3)) of main_device's loop in float32: the robot at its zero
    pose, the pendulum swung by PENDULUM_DEFAULT_PARAMS' initial angle."""
    p, pend = PICKPLACE_SOLVER_PARAMS, PENDULUM_DEFAULT_PARAMS
    model = load_robot("iiwa14", torch.float32, device)
    sim = add_pendulum(model, mass=pend["mass"], length=pend["length"])
    x_sim0 = torch.zeros(2 * sim.nq, device=device)
    x_sim0[model.nq:model.nq + 3] = torch.tensor(pend["initial_angle"], dtype=torch.float32)
    settings = BSQPSettings(N=N, max_sqp_iters=p["max_sqp_iters"],
                            max_pcg_iters=p["max_pcg_iters"], kkt_tol=p["kkt_tol"])
    cp = CostParams(q_cost=p["q_cost"], qd_cost=p["qd_cost"], u_cost=p["u_cost"],
                    N_cost=p["N_cost"], q_lim_cost=p["q_lim_cost"])
    hp = HyperParams.create(batch_size, rho=p["rho"], mu=p["mu"], pcg_tol=p["pcg_tol"],
                            device=device)
    goals = torch.tensor(np.stack(goals or PICKPLACE_DEFAULT_GOALS), dtype=torch.float32,
                         device=device)
    return model, sim, settings, cp, hp, x_sim0, goals


def run(batch_size: int, N: int = 32, goals=None, goal_timeout=None, control_dt=0.002,
        dt=0.03125, seed: int = 0, score_substeps: int = 2, n_steps=None,
        device="cuda", graph=None):
    """One batch size of main_device's loop. Returns (the JSON row, the
    rollout's outputs)."""
    goal_timeout = goal_timeout or PICKPLACE_MPC_DEFAULTS["goal_timeout"]
    model, sim, settings, cp, hp, x_sim0, goals_t = pickplace_setup(batch_size, N, device,
                                                                    goals)
    n_steps = n_steps or n_cycles(goals_t.shape[0], goal_timeout, control_dt)
    draws = torch.rand(n_steps, 3, generator=torch.Generator().manual_seed(seed)).to(device)
    out = rollout.closed_loop_rollout_goals(
        model, sim, settings, cp, hp, x_sim0, goals_t, dt, control_dt, draws, batch_size,
        n_steps, goal_timeout=float(goal_timeout),
        goal_threshold=float(PICKPLACE_MPC_DEFAULTS["goal_threshold"]),
        velocity_threshold=float(PICKPLACE_MPC_DEFAULTS["velocity_threshold"]),
        sim_substeps=2, pendulum_damping=float(PENDULUM_DEFAULT_PARAMS["damping"]),
        score_substeps=score_substeps, graph=graph)
    dists, outcomes, reached_t, smoothed = out[2], out[5], out[6], out[7]
    oc = outcomes.tolist()
    row = {
        "goal_outcomes": [OUTCOMES[c] for c in oc],
        "goal_reached_times": [round(t, 3) if t >= 0 else None for t in reached_t.tolist()],
        "goals_reached": sum(c == 1 for c in oc),
        "final_dist_m": round(dists[-1].item(), 4),
        "score_substeps": score_substeps,
        "seed": seed,
        "force_estimate_end_N": [round(v, 1) for v in smoothed[-1, :3].tolist()],
        "cycles": n_steps,
    }
    return row, out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=list(BATCH_SIZES))
    ap.add_argument("--N", type=int, default=32, help="horizon knots (the notebook's: 16)")
    ap.add_argument("--dt", type=float, default=0.03125,
                    help="solver discretization in s (the notebook's: 0.01)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="the estimator's seeds, each a run of every batch size past 3")
    ap.add_argument("--out", help="the JSON file (default PICKPLACE_RESULTS_<card>.json)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pickplace_device needs a CUDA GPU: torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    out = args.out or "PICKPLACE_RESULTS_" + re.sub(r"\W+", "_", kind).strip("_") + ".json"
    rec = {}
    if os.path.exists(out):
        with open(out) as f:
            rec = json.load(f)
    for B in args.batch_sizes:
        seeds = args.seeds if B > 3 else args.seeds[:1]
        rows = []
        for seed in seeds:
            t0 = time.perf_counter()
            row, _ = run(B, N=args.N, dt=args.dt, seed=seed)
            torch.cuda.synchronize()
            ev = rollout.last_capture["events"]
            row.update(N=args.N, dt=args.dt, card=card,
                       ms_per_cycle=round(ev[0].elapsed_time(ev[1]) / row["cycles"], 4),
                       wall_s=round(time.perf_counter() - t0, 1))
            rows.append(row)
            print(f"N={args.N} dt={args.dt:g} B={B:4d} seed {seed}: {row['goals_reached']}/"
                  f"{len(row['goal_outcomes'])} goals {row['goal_outcomes']} at "
                  f"{row['goal_reached_times']} s, {row['ms_per_cycle']} ms a cycle ({card})",
                  flush=True)
        # the JAX package's record key (examples/pickplace.py::main_device)
        key = f"N{args.N}_B{B}" + ("" if args.dt == 0.03125 else f"_dt{args.dt:g}")
        rec[key] = rows[0]
        if len(rows) > 1:
            reached = [r["goals_reached"] for r in rows]
            gs = sorted(reached)
            rec[f"{key}_seed_sweep"] = {
                "seeds": seeds, "goals_reached_per_seed": reached, "min": gs[0],
                "median": gs[len(gs) // 2], "max": gs[-1], "N": args.N, "dt": args.dt,
                "rows": rows}
            print(f"N={args.N} dt={args.dt:g} B={B:4d} sweep over seeds {seeds}: goals "
                  f"min/median/max {gs[0]}/{gs[len(gs) // 2]}/{gs[-1]}", flush=True)
    rec["meta"] = {
        "workload": ("iiwa14 + 15 kg pendulum payload (the plant only, stepped on the rk4 "
                     "kernel), the 5-goal pick-and-place sequence, PICKPLACE_SOLVER_PARAMS "
                     "(5 SQP iterations), control_dt 0.002, the sphere estimator's "
                     "hypotheses scored by RK4 on the rigid-body algorithms at the "
                     "plant's cadence (score_substeps=2); each row carries its N, dt, "
                     "seed and card; examples/pickplace.py::main_device on gato_tpu_torch, "
                     "under the JAX package's record keys (PICKPLACE_RESULTS.json)"),
        "card": card, "device": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda}
    with open(out, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
