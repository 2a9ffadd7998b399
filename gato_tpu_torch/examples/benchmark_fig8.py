"""Figure-8 MPC benchmark across batch sizes: examples/benchmark_fig8.py on
the port.

Runs MPC_GATO's closed-loop fig-8 task (indy7, DEFAULT_SOLVER_PARAMS) per
batch size and reports the tracking error, the solve time and solves/s; on
the card the solve is the whole-iteration kernel (bsqp_iter) and, without
a wrench, the plant step the rk4 kernel. --save pickles the results in the
JAX example's layout ({"N", "results"}).

    python -m gato_tpu_torch.examples.benchmark_fig8 [--N 32]
        [--batch-sizes 1 32 128 512] [--sim-time 5] [--fz 0] [--save PATH]
        [--device cpu]

The solve times are the facade's device times (CUDA events) on the card,
its wall times on the CPU; the card's name and power limit print first.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from . import card_line
from ..api.common import figure8
from ..api.config import DEFAULT_SOLVER_PARAMS, INDY7_START_CONFIGS
from ..api.mpc import MPC_GATO
from ..robots.model import check_device


def run(N, batch_sizes, sim_time, f_ext=None, plant="indy7", dt=0.01,
        sim_dt=0.001, save=None, device="cuda"):
    """Returns {B: dict(avg_error_m, avg_solve_ms, stats)}."""
    device = check_device(device)
    print(f"card: {card_line(device)}")
    traj = figure8(dt)
    q0 = INDY7_START_CONFIGS["ready"] if plant == "indy7" else np.zeros(7)
    x0 = np.concatenate([q0, np.zeros_like(q0)]).astype(np.float32)

    results = {}
    for B in batch_sizes:
        print(f"\n=== N={N} batch={B} ===")
        mpc = MPC_GATO(plant_type=plant, N=N, dt=dt, batch_size=B,
                       constant_f_ext=f_ext, solver_params=DEFAULT_SOLVER_PARAMS,
                       device=device)
        _, stats = mpc.run_mpc_fig8(x0, traj, sim_dt=sim_dt, sim_time=sim_time)
        results[B] = {
            "avg_error_m": float(np.mean(stats["goal_distances"])),
            "avg_solve_ms": float(np.mean(stats["solve_times"])),
            "stats": {k: v for k, v in stats.items()
                      if k in ("timestamps", "goal_distances", "solve_times")},
        }

    print(f"\n{'B':>6} {'err (m)':>10} {'solve (ms)':>12} {'solves/s':>12}")
    for B in batch_sizes:
        r = results[B]
        sps = B / (r["avg_solve_ms"] / 1e3) if r["avg_solve_ms"] else float("nan")
        print(f"{B:>6} {r['avg_error_m']:>10.4f} {r['avg_solve_ms']:>12.3f} "
              f"{sps:>12.0f}")

    if save:
        with open(save, "wb") as f:
            pickle.dump({"N": N, "results": results}, f)
        print(f"saved -> {save}")
    return results


def cli(argv=None):
    """The JAX example's command line, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 32, 128, 512])
    ap.add_argument("--sim-time", type=float, default=5.0)
    ap.add_argument("--fz", type=float, default=0.0,
                    help="constant world z-force on the EE (N)")
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu: the plain PyTorch route")
    args = ap.parse_args(argv)
    f_ext = np.array([0, 0, args.fz, 0, 0, 0]) if args.fz else None
    return run(args.N, args.batch_sizes, args.sim_time, f_ext=f_ext, save=args.save,
               device=args.device)


if __name__ == "__main__":
    cli()
