"""Mixed-plant fleets: several (plant, N, B) solves in one process on one
card, with merged fleet statistics.

Port of gato_tpu/parallel/fleet.py. Each member is its own batched solve
(solver/bsqp.py::solve_batched, its plant's kernel libraries: different nq
means different shapes, so the members cannot share a launch), issued back
to back on the current CUDA stream, as the JAX package dispatches its
jitted programs one after the other on its one device stream. The batch
sharding over a mesh (gato_tpu/parallel/sharding.py) is not ported:
`mesh` raises.

Merit values are per-plant objectives, so the fleet "winner" is reported
per member and fleet-wide; the fleet-wide argmin is only meaningful when
the members share a cost scale. The report carries both.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops.cost import CostParams
from ..robots.model import RobotModel
from ..solver.bsqp import solve_batched
from ..solver.types import BSQPSettings, HyperParams

SHARDING_ITEM = "ROADMAP Queue 1, parallel/sharding.py"


@dataclass
class FleetMember:
    """One plant's batch of MPC subproblems and its warm-started solver
    state, tensors on one device: X (B,N,nx), U (B,N-1,nu), lam (B,N,nx),
    x_s (B,nx), ref (B,N,>=3), f_ext (B,6); dt a float."""

    name: str
    model: RobotModel
    settings: BSQPSettings
    cp: CostParams
    hp: HyperParams
    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    x_s: torch.Tensor
    ref: torch.Tensor
    f_ext: torch.Tensor
    dt: float


def solve_fleet(members, mesh=None, device_exit: bool = False):
    """One batched solve per member, back to back on the current stream.
    Returns (new_members, stats_list): new_members carry the solved X, U,
    lam and the updated hyperparameters as the next cycle's warm start.
    device_exit=True keeps each solve's exit on the device
    (solve_batched), so that a CUDA graph can hold the fleet's cycle. A
    mesh raises NotImplementedError: the sharding is not ported."""
    if mesh is not None:
        raise NotImplementedError(f"solve_fleet(mesh=...) shards each member's batch over "
                                  f"devices, which is not ported ({SHARDING_ITEM})")
    new_members, stats_list = [], []
    for m in members:
        Xo, Uo, lam_o, hp_out, stats = solve_batched(
            m.model, m.settings, m.cp, m.hp, m.X, m.U, m.lam, m.x_s, m.ref, m.f_ext, m.dt,
            device_exit=device_exit)
        new_members.append(replace(m, X=Xo, U=Uo, lam=lam_o, hp=hp_out))
        stats_list.append(stats)
    return new_members, stats_list


def _numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def fleet_report(members, stats_list):
    """Merged fleet statistics: per-member convergence and best lane plus
    the fleet-wide totals and winner, as the JAX package's fleet_report
    gives them (numpy, JSON-safe). Non-finite merits (dead lanes) are
    masked out of every argmin; with every lane of a member dead its
    best_merit is None and all_lanes_dead True."""
    per_member = {}
    all_merits, owners = [], []  # owners[i] = (member name, local lane)
    for m, st in zip(members, stats_list):
        merits = _numpy(st.final_merit).astype(np.float64)
        safe = np.where(np.isfinite(merits), merits, np.inf)
        best = int(np.argmin(safe))
        best_finite = np.isfinite(safe[best])
        per_member[m.name] = {
            "lanes": int(merits.shape[0]),
            "converged": int(_numpy(st.kkt_converged).sum()),
            "best_lane": best,
            "best_merit": float(safe[best]) if best_finite else None,
            "all_lanes_dead": not bool(best_finite),
            "sqp_iters_mean": float(_numpy(st.sqp_iters).mean()),
        }
        all_merits.append(safe)
        owners.extend((m.name, i) for i in range(merits.shape[0]))
    merged = np.concatenate(all_merits)
    win = int(np.argmin(merged))
    win_merit = float(merged[win]) if np.isfinite(merged[win]) else None
    return {
        "members": per_member,
        "total_lanes": int(merged.shape[0]),
        "total_converged": sum(v["converged"] for v in per_member.values()),
        "winner": {"member": owners[win][0], "lane": owners[win][1],
                   "merit": win_merit},
    }
