"""Figure-8 tracking under a constant external disturbance with batched
force-hypothesis estimation: examples/fig8_tracking.py on the port.

Runs MPC_GATO (indy7, DEFAULT_SOLVER_PARAMS, N=32) at B in {1, 32, 128}
under a -60 N world-z EE force on the simulated plant, and reports how
batching plus the sphere ForceEstimator improves tracking (the reference
notebook gato_fig8_tracking.ipynb's headline result). On the card the
solve runs the whole-iteration kernel (bsqp_iter); the plant step under a
world wrench runs on the rigid-body algorithms, replayed from a CUDA graph.

    python -m gato_tpu_torch.examples.fig8_tracking [--batch-sizes 1 32 128]
        [--fz -60] [--N 32] [--sim-time 5] [--save PATH] [--device cpu]

--save writes the JSON record of the JAX example, with "card" (the card's
name and power limit) where it has "backend".
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import card_line
from ..api.common import figure8
from ..api.config import DEFAULT_SOLVER_PARAMS, INDY7_START_CONFIGS
from ..api.mpc import MPC_GATO
from ..robots.model import check_device


def main(batch_sizes=(1, 32, 128), fz=-60.0, N=32, sim_time=5.0, save=None, device="cuda"):
    """Returns {B: mean EE tracking error (m) over the run}."""
    device = check_device(device)
    traj = figure8(0.01)
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)
    f_ext = np.array([0.0, 0.0, fz, 0.0, 0.0, 0.0])

    summary = {}
    detail = {}
    for B in batch_sizes:
        print(f"\n=== batch {B}, f_ext z = {fz} N ===", flush=True)
        mpc = MPC_GATO(plant_type="indy7", N=N, dt=0.01, batch_size=B,
                       constant_f_ext=f_ext, solver_params=DEFAULT_SOLVER_PARAMS,
                       device=device)
        _, stats = mpc.run_mpc_fig8(x0, traj, sim_dt=0.001, sim_time=sim_time)
        d = np.asarray(stats["goal_distances"])
        summary[B] = float(np.mean(d))
        tail = d[len(d) // 4:]
        detail[str(B)] = {
            "mean_err_m": round(float(np.mean(d)), 5),
            "steady_err_m": round(float(np.mean(tail)), 5),
            "max_err_m": round(float(np.max(d)), 5),
            "cycles": int(len(d)),
        }

    print("\nmean tracking error under disturbance:")
    for B, e in summary.items():
        print(f"  B={B:4d}: {e:.4f} m")
    if save:
        rec = {
            "meta": {
                "workload": f"indy7 fig-8 MPC, DEFAULT params, constant "
                            f"{fz} N world-z EE force on the sim plant, "
                            f"sphere ForceEstimator hypotheses at B>1 "
                            f"(gato_fig8_tracking.ipynb headline sweep), "
                            f"N={N}, sim_time={sim_time}s",
                "card": card_line(device),
            },
            "cells": detail,
        }
        with open(save, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        print(f"saved -> {save}")
    return summary


def cli(argv=None):
    """The JAX example's command line, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 32, 128])
    ap.add_argument("--fz", type=float, default=-60.0)
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--sim-time", type=float, default=5.0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu: the plain PyTorch route")
    args = ap.parse_args(argv)
    return main(tuple(args.batch_sizes), args.fz, N=args.N, sim_time=args.sim_time,
                save=args.save, device=args.device)


if __name__ == "__main__":
    cli()
