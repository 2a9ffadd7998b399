"""Weak-scaling benchmark of the sharded solve (the multi-host scaling target
of BASELINE.md: >= 80 % efficiency to 2+ hosts).

Port of gato_tpu/parallel/scaling_bench.py. The batch per rank is fixed
and the whole batch grows with the ranks: in one process group of W ranks
the sharded solve (sharding.py::solve_batched_sharded, indy7,
DEFAULT_SOLVER_PARAMS, bench.py's problem) runs on the first n ranks for
each n in {1, 2, W/2, W}, in a group of those ranks, while the others wait.
Each n's time is a solve warm-started from the last one, k of them back to
back between CUDA events (utils/timing.py::time_fn), the most over its
ranks. Efficiency is n ranks' solves/s over n times one rank's. Rank 0
prints one JSON document (and writes it with --out).

Ranks sharing one card (gloo: NCCL refuses two ranks on one GPU) measure
what the sharded program costs, the collectives through host memory
included, not hardware scaling; that needs a card a rank (NCCL).

    torchrun --nproc-per-node <ranks> -m gato_tpu_torch.parallel.scaling_bench \\
        [--per-rank-batch 64] [--N 32] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.distributed as dist

from ..api.config import DEFAULT_SOLVER_PARAMS as P
from ..ops.cost import CostParams
from ..robots.model import load_robot
from ..solver.types import BSQPSettings, HyperParams
from ..utils.timing import time_fn
from .sharding import init_from_env, make_mesh, shard_solve_args, solve_batched_sharded

Q0 = (-1.0966, -0.099, 0.8313, -0.109, 0.497, 0.015)
REF = (-0.3, 0.3, 0.95, 0.0, 0.0, 0.0)


def _problem(B, N, model, device):
    """bench.py's problem of the JAX scaling benchmark: every lane at Q0 at
    rest, a fixed EE target, no wrench (float32)."""
    x0 = torch.tensor(np.concatenate([Q0, np.zeros(6)]), dtype=torch.float32, device=device)
    return (x0.expand(B, N, 12).contiguous(), torch.zeros(B, N - 1, model.nu, device=device),
            torch.zeros(B, N, model.nx, device=device), x0.expand(B, 12).contiguous(),
            torch.tensor(REF, dtype=torch.float32, device=device).expand(B, N, 6).contiguous(),
            torch.zeros(B, 6, device=device))


def card_line() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def run(per_rank_batch=64, N=32, device=None, k=10, out=None):
    """The weak-scaling table on the current process group; every rank
    calls it. Returns {n: {batch, ms, solves_per_s, efficiency}} (ms a
    solve) on every rank."""
    mesh = make_mesh(device=device)
    model = load_robot("indy7", torch.float32, mesh.device)
    settings = BSQPSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                            max_pcg_iters=P["max_pcg_iters"])
    cp = CostParams(q_cost=P["q_cost"], qd_cost=P["qd_cost"], u_cost=P["u_cost"],
                    N_cost=P["N_cost"], q_lim_cost=P["q_lim_cost"])
    W = mesh.world
    counts = sorted({1, 2, W // 2 or 1, W} & set(range(1, W + 1)))
    results, base = {}, None
    for n in counts:
        group = dist.new_group(list(range(n)))  # every rank takes part in making it
        secs = 0.0
        if mesh.rank < n:
            sub = make_mesh(group=group, device=mesh.device)
            B = per_rank_batch * n
            hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                                    device=mesh.device)
            X, U, lam, x_s, ref, fe, hp_s = shard_solve_args(
                sub, *_problem(B, N, model, mesh.device), hp)

            def solve(X, U, lam):
                return solve_batched_sharded(model, settings, cp, hp_s, X, U, lam, x_s, ref,
                                             fe, 0.01, mesh=sub)

            secs = time_fn(solve, (X, U, lam), chain=lambda a, o: (o[0], o[1], o[2]), k=k)
        # the slowest rank's time, on every rank (the others give 0)
        secs = float(mesh.all_reduce(torch.tensor(secs, dtype=torch.float64,
                                                  device=mesh.device), "max"))
        B = per_rank_batch * n
        thr = B / secs
        base = base or thr / n
        results[n] = {"batch": B, "ms": secs * 1e3, "solves_per_s": thr,
                      "efficiency": thr / (base * n)}
        if mesh.rank == 0:
            print(f"ranks={n:3d} B={B:5d}: {secs * 1e3:8.3f} ms  {thr:10.0f} solves/s"
                  f"  efficiency {thr / (base * n) * 100:5.1f}%", flush=True)
    on_card = mesh.device.type == "cuda"
    doc = {"metric": "scaling", "value": results, "unit": "solves/s", "vs_baseline": None,
           "meta": {"backend": dist.get_backend(), "ranks": W, "N": N,
                    "per_rank_batch": per_rank_batch, "solves_timed": k,
                    "device": torch.cuda.get_device_name(mesh.device) if on_card else "cpu",
                    "cards": torch.cuda.device_count() if on_card else 0,
                    "card": card_line() if on_card and mesh.rank == 0 else None,
                    "note": ("weak scaling, batch per rank fixed; ms a solve: k solves, each "
                             "warm-started from the last, between CUDA events (the host "
                             "clock on the CPU), the most over the ranks. Ranks that share "
                             "a card (gloo) or the CPU measure the sharded program's "
                             "overhead, not hardware scaling, which needs a card a rank "
                             "(NCCL).")}}
    if mesh.rank == 0:
        print(json.dumps(doc), flush=True)
        if out:
            with open(out, "w") as f:
                json.dump(doc, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-rank-batch", type=int, default=64)
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--k", type=int, default=10, help="solves timed back to back")
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu (gloo)")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    a = ap.parse_args(argv)
    made = init_from_env(a.device)
    try:
        return run(a.per_rank_batch, a.N, device=a.device, k=a.k, out=a.out)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
