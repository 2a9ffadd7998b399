"""Mixed-plant fleets: several (plant, N, B) solves in one process on one
card, with merged fleet statistics.

Port of gato_tpu/parallel/fleet.py. Each member is its own batched solve
(solver/bsqp.py::solve_batched, its plant's kernel libraries: different nq
means different shapes, so the members cannot share a launch), issued back
to back on the current CUDA stream, as the JAX package dispatches its
jitted programs one after the other on its one device stream. With a mesh
(parallel/sharding.py) every member's batch is split over the same ranks,
one process a card: each rank holds its share of every member's lanes
(place_member) and solves them with the exit on the member's global count;
fleet_report gathers the lanes it reports on.

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
from .sharding import Mesh, gather_batch, shard_solve_args


@dataclass
class FleetMember:
    """One plant's batch of MPC subproblems and its warm-started solver
    state, tensors on one device: X (B,N,nx), U (B,N-1,nu), lam (B,N,nx),
    x_s (B,nx), ref (B,N,>=3), f_ext (B,6); dt a float. `mesh`: the
    Mesh whose rank's share of the lanes the tensors hold (place_member),
    None for the whole batch."""

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
    mesh: Mesh | None = None


def place_member(member: FleetMember, mesh: Mesh) -> FleetMember:
    """The member with this rank's share of its batch on the rank's device
    (sharding.py::shard_solve_args; the mesh's world must divide the
    member's B). A member placed on this mesh already is returned as it
    is."""
    if member.mesh is not None:
        if member.mesh != mesh:
            raise ValueError(f"member {member.name!r} is placed on another mesh")
        return member
    X, U, lam, x_s, ref, f_ext, hp = shard_solve_args(
        mesh, member.X, member.U, member.lam, member.x_s, member.ref, member.f_ext, member.hp)
    return replace(member, X=X, U=U, lam=lam, x_s=x_s, ref=ref, f_ext=f_ext, hp=hp,
                   mesh=mesh)


def solve_fleet(members, mesh=None, device_exit: bool = False):
    """One batched solve per member, back to back on the current stream.
    Returns (new_members, stats_list): new_members carry the solved X, U,
    lam and the updated hyperparameters as the next cycle's warm start.
    device_exit=True keeps each solve's exit on the device
    (solve_batched), so that a CUDA graph can hold the fleet's cycle. With
    a mesh each member is placed on it first (place_member) and every rank
    must call this; the stats are the rank's lanes' (num_iters_run the
    member's global one)."""
    if mesh is not None:
        members = [place_member(m, mesh) for m in members]
    new_members, stats_list = [], []
    for m in members:
        Xo, Uo, lam_o, hp_out, stats = solve_batched(
            m.model, m.settings, m.cp, m.hp, m.X, m.U, m.lam, m.x_s, m.ref, m.f_ext, m.dt,
            device_exit=device_exit, mesh=m.mesh)
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
    best_merit is None and all_lanes_dead True. Members placed on a mesh
    report their whole batch: their lanes are gathered from every rank
    (every rank must call this), and lane numbers are global."""
    per_member = {}
    all_merits, owners = [], []  # owners[i] = (member name, lane of the member)
    for m, st in zip(members, stats_list):
        mesh = getattr(m, "mesh", None)
        merits = _numpy(gather_batch(mesh, st.final_merit)).astype(np.float64)
        safe = np.where(np.isfinite(merits), merits, np.inf)
        best = int(np.argmin(safe))
        best_finite = np.isfinite(safe[best])
        per_member[m.name] = {
            "lanes": int(merits.shape[0]),
            "converged": int(_numpy(gather_batch(mesh, st.kkt_converged)).sum()),
            "best_lane": best,
            "best_merit": float(safe[best]) if best_finite else None,
            "all_lanes_dead": not bool(best_finite),
            "sqp_iters_mean": float(_numpy(gather_batch(mesh, st.sqp_iters)).mean()),
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
