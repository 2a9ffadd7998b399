"""Closed-loop fig-8 tracking-error grid: tools/parity_fig8.py on the port.

Runs the reference workload (figure-8 EE tracking MPC on indy7,
DEFAULT_SOLVER_PARAMS, dt 0.01, the "ready" start) through the port's
on-device closed loop (api/rollout.py::closed_loop_rollout: on the card each
cycle is one CUDA graph of bsqp_iter and rk4) for a grid of (N, B), and
records the average and largest EE tracking error. After each cycle's
plant step the EE is compared with knot 1 of the window that cycle
tracked; the first quarter of the run is transient and left out of the
steady-state average. Lane 0 carries the zero wrench hypothesis and drives
the plant; the other lanes' hypotheses are uniform in [-5, 5] N from the
seed.

--realtime emulates the reference benchmark's real time
(mpc_controller.py:189-216): the plant advances by the solve's time a
cycle, m = round(dt / t_solve) solves a knot (at most 100), each cycle's
window m fine samples on from the last. t_solve is the port's own: one
solve at (N, B) on the default route from the fig-8 loop's steady state,
timed by CUDA events around CUDA-graph replays (solve_seconds,
utils/timing.py), where the JAX tool takes bench.py's bench_solve.

    python -m gato_tpu_torch.examples.parity_fig8 [--cells N8_B1,N32_B1,...]
        [--cycles 400] [--sqp-iters K] [--realtime] [--out PATH] [--device cpu]

The record (by default PARITY_RESULTS_<card name>.json at the repository's
root) keeps the JAX record's keys: cells N<N>_B<B>[_sqp<K>][_rt] with
cycles, avg_err_m, max_err_m, avg_err_all_m (and t_solve_ms,
solves_per_knot), each with "card", the card's name and power limit, where
the JAX record has "backend". Cells merge into an existing record.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from . import card_line
from ..api import rollout
from ..api.common import figure8, rk4_step
from ..api.config import DEFAULT_SOLVER_PARAMS, INDY7_START_CONFIGS
from ..ops.cost import CostParams
from ..robots.model import check_device, load_robot
from ..solver.bsqp import solve_batched
from ..solver.types import BSQPSettings, HyperParams
from ..utils.timing import time_fn

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DT = 0.01
WORKLOAD = ("indy7 fig-8 closed loop, DEFAULT params, dt=0.01, control_dt=dt, "
            "zero-wrench lane drives; error vs knot-1 goal, steady state = last "
            "3/4 of run")
# solve_seconds: warm-up cycles of the fig-8 loop (bench.py's steady state),
# then the solve timed over k calls a replay
WARMUP, TIMED_CALLS = 6, 20


def default_out(device) -> str:
    """PARITY_RESULTS_<the card's name>.json at the repository's root
    (PARITY_RESULTS_cpu.json on the CPU)."""
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    return os.path.join(ROOT, "PARITY_RESULTS_" + re.sub(r"[^0-9A-Za-z]+", "_", name) + ".json")


def _problem(N, B, sqp_iters, seed, device):
    """(model, settings, cp, hp, f_ext) of a cell: indy7 in float32 on
    `device`, DEFAULT_SOLVER_PARAMS, B wrench hypotheses (numpy) uniform in
    [-5, 5] from `seed` with lane 0 zero."""
    p = DEFAULT_SOLVER_PARAMS
    model = load_robot("indy7", torch.float32, device)
    settings = BSQPSettings(N=N, max_sqp_iters=sqp_iters or p["max_sqp_iters"],
                            max_pcg_iters=p["max_pcg_iters"])
    cp = CostParams(q_cost=p["q_cost"], qd_cost=p["qd_cost"], u_cost=p["u_cost"],
                    N_cost=p["N_cost"], q_lim_cost=p["q_lim_cost"])
    hp = HyperParams.create(B, rho=p["rho"], mu=p["mu"], pcg_tol=p["pcg_tol"],
                            device=model.R_tree.device)
    rng = np.random.default_rng(seed)
    f_ext = rng.uniform(-5.0, 5.0, (B, 6)).astype(np.float32)
    f_ext[0] = 0.0  # the estimator always carries the zero hypothesis
    return model, settings, cp, hp, f_ext


def solve_seconds(N, B, sqp_iters=None, seed=0, device="cuda"):
    """Seconds of one solve of the cell at (N, B) on the default route:
    WARMUP cycles of the fig-8 loop from the ready start (solve, a 10-substep
    RK4 step of lane 0, the next window: bench.py's steady state), then the
    next window's solve timed by utils/timing.py::time_fn, TIMED_CALLS calls
    of the same problem a run; on the card the calls are one CUDA graph
    replayed between CUDA events (the device's time), on the CPU the host
    clock."""
    model, settings, cp, hp, f_ext = _problem(N, B, sqp_iters, seed, device)
    dev = model.R_tree.device
    traj = torch.tensor(figure8(DT).reshape(-1, 6), dtype=torch.float32, device=dev)
    x0 = torch.tensor(np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]),
                      dtype=torch.float32, device=dev)
    fe = torch.tensor(f_ext, device=dev)
    X, x_s = x0.expand(B, N, 12).contiguous(), x0.expand(B, 12).contiguous()
    U, lam = x0.new_zeros(B, N - 1, 6), x0.new_zeros(B, N, 12)

    def ref(i):
        return traj[i:i + N][None].expand(B, N, 6).contiguous()

    for i in range(WARMUP):
        X, U, lam, _, _ = solve_batched(model, settings, cp, hp, X, U, lam, x_s, ref(i), fe, DT)
        x_s = rk4_step(model, x_s[0], U[0, 0], DT, substeps=10)[None].expand(B, 12).contiguous()
        X[:, 0] = x_s
    window = ref(WARMUP)

    def solve(X, U, lam):
        return solve_batched(model, settings, cp, hp, X, U, lam, x_s, window, fe, DT,
                             device_exit=True)[:3]

    return time_fn(solve, (X, U, lam), k=TIMED_CALLS, graph=dev.type == "cuda")


def cell_inputs(N, B, cycles, seed=0, sqp_iters=None, realtime=False, device="cuda"):
    """The cell's closed loop as the JAX tool builds it: dict(args, kw) of
    closed_loop_rollout, refs (numpy, the windows), extra (the real-time
    cell's t_solve_ms and solves_per_knot)."""
    model, settings, cp, hp, f_ext = _problem(N, B, sqp_iters, seed, device)
    dev = model.R_tree.device
    dt = DT
    extra = {}
    if realtime:
        t_solve = solve_seconds(N, B, sqp_iters, seed, device)
        # solves per knot, like the reference's sim-by-solve-time loop
        # (whole sub-knot fractions; at most 100 a knot)
        m = int(max(1, min(100, round(dt / t_solve))))
        control_dt = dt / m
        extra = {"t_solve_ms": round(t_solve * 1e3, 4), "solves_per_knot": m}
    else:
        m, control_dt = 1, dt

    # fine-resolution reference: window k starts at sample k (control_dt
    # apart); its N knots stride m samples (dt apart)
    n_steps = cycles * m
    need = n_steps + N * m + 2
    period_samples = int(6 / control_dt)
    reps = need // period_samples + 2
    traj = figure8(control_dt, cycles=reps).reshape(-1, 6).astype(np.float32)
    n_steps = min(n_steps, traj.shape[0] - N * m - 2)
    idx = np.arange(n_steps)[:, None] + np.arange(N)[None, :] * m
    refs = traj[idx]
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)

    def t(a):
        return torch.tensor(a, device=dev)

    # dt as the JAX tool's jnp.float32(dt)
    args = (model, model, settings, cp, hp, t(x0), t(refs), t(f_ext), float(np.float32(dt)))
    kw = dict(control_dt=control_dt, sim_substeps=max(1, 4 // m) if realtime else 4)
    return dict(args=args, kw=kw, refs=refs, extra=extra)


def cell_record(cell, ees) -> dict:
    """The JAX tool's record of a cell from its EE positions ((n_steps, 3)
    numpy): the error against each cycle's knot-1 goal over the last three
    quarters and over the whole run."""
    refs = cell["refs"]
    n_steps = refs.shape[0]
    goals = refs[:, 1, :3]  # knot-1 goal of the window each cycle tracked
    errs = np.linalg.norm(ees - goals, axis=1)
    tail = errs[n_steps // 4:]
    out = {
        "cycles": int(n_steps),
        "avg_err_m": round(float(tail.mean()), 5),
        "max_err_m": round(float(tail.max()), 5),
        "avg_err_all_m": round(float(errs.mean()), 5),
    }
    out.update(cell["extra"])
    return out


def run_cell(N, B, cycles, seed=0, sqp_iters=None, realtime=False, device="cuda"):
    """One cell's record (cell_record) from its closed loop on `device`."""
    cell = cell_inputs(N, B, cycles, seed, sqp_iters, realtime, device)
    ees = rollout.closed_loop_rollout(*cell["args"], **cell["kw"])[1]
    return cell_record(cell, ees.cpu().numpy())


def parse_cells(spec):
    """"N8_B1,N32_B1" -> [(8, 1), (32, 1)]; "" -> N in {8, 32, 128} x B in
    {1, 32, 128}."""
    if not spec:
        return [(N, B) for N in (8, 32, 128) for B in (1, 32, 128)]
    cells = []
    for c in spec.split(","):
        n, b = c.strip().split("_")
        cells.append((int(n[1:]), int(b[1:])))
    return cells


def cell_key(N, B, sqp_iters=None, realtime=False) -> str:
    return (f"N{N}_B{B}" + (f"_sqp{sqp_iters}" if sqp_iters else "")
            + ("_rt" if realtime else ""))


def main(argv=None):
    """The JAX tool's command line, --device in place of --platform.
    Returns the record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--cycles", type=int, default=400)
    ap.add_argument("--out", default=None,
                    help="the record (default: PARITY_RESULTS_<card name>.json at the "
                         "repository's root)")
    ap.add_argument("--sqp-iters", type=int, default=None,
                    help="override max_sqp_iters (cells get a _sqpK suffix)")
    ap.add_argument("--realtime", action="store_true",
                    help="real-time emulation: the plant advances by the solve's time a "
                         "cycle (cells get an _rt suffix)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu: the plain PyTorch route")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    out = args.out or default_out(device)
    cells = parse_cells(args.cells)

    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.setdefault("meta", {})
    results["meta"]["workload"] = WORKLOAD
    card = card_line(device)
    for N, B in cells:
        key = cell_key(N, B, args.sqp_iters, args.realtime)
        r = run_cell(N, B, args.cycles, sqp_iters=args.sqp_iters, realtime=args.realtime,
                     device=device)
        r["card"] = card
        results[key] = r
        print(f"{key}: avg {r['avg_err_m']*100:.2f} cm  "
              f"max {r['max_err_m']*100:.2f} cm  ({r['cycles']} cycles)")
        with open(out, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
    print(json.dumps({"written": out}))
    return results


if __name__ == "__main__":
    main()
