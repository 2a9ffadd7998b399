"""The solve batch split over processes: one process (rank) per GPU, each
holding its own contiguous lanes.

Port of gato_tpu/parallel/sharding.py in torch.distributed's idiom. The JAX
package builds one global array with a NamedSharding and lets shard_map run
the single-chip solve on each chip's lanes; here each rank holds only its
lanes [r B/W, (r+1) B/W) (shard_solve_args) and runs the single-card solve
on them (solver/bsqp.py::solve_batched with the rank's Mesh). Lanes are
independent, so the only cross-rank traffic of the whole solve is the
JAX package's (docs/DESIGN.md:62-65):

  - the converged count of the whole-batch solve_ratio exit, all-reduced
    (SUM) after every SQP iteration, so every rank takes the exit on the
    global count at the same iteration, as one card would
    (gato_tpu/solver/bsqp.py:281-289), and the iterations run (MAX,
    :110-111);
  - the best-lane argmin over every rank's merits (best_lane, an
    all-gather).

gather_batch and gather_stats bring the ranks' lanes together for reports
and tests. Backends: NCCL where each rank has a card of its own; gloo on
the CPU and where several ranks share one card (NCCL refuses two ranks on
one GPU). With gloo a CUDA tensor goes through host memory for each
collective, so the host waits on the device there.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from ..robots.model import check_device
from ..solver.bsqp import solve_batched
from ..solver.types import HyperParams, SQPStats

BATCH_AXIS = "batch"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Mesh:
    """The batch axis over the ranks of a process group: `group` (None: the
    default group), this process's `rank` in it, the `world` size and the
    `device` that holds this rank's lanes."""

    group: object
    rank: int
    world: int
    device: torch.device

    def _via_host(self, t: torch.Tensor) -> bool:
        """gloo takes CUDA tensors through host memory: copy there, and back."""
        return t.is_cuda and dist.get_backend(self.group) != "nccl"

    def reduces_on_device(self, device: torch.device) -> bool:
        """Whether a collective on a tensor on `device` stays on it (NCCL on
        the card, gloo on the CPU), so that nothing reads the device."""
        return device.type == "cpu" or dist.get_backend(self.group) == "nccl"

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """t reduced over the ranks by op ("sum" or "max"), on t's device."""
        host = self._via_host(t)
        buf = t.cpu() if host else t.clone()
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        return buf.to(t.device) if host else buf

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t, concatenated along dim in rank order."""
        host = self._via_host(t)
        src = (t.cpu() if host else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim)
        return out.to(t.device) if host else out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank src's t on every rank (t a buffer of its shape elsewhere)."""
        host = self._via_host(t)
        buf = (t.cpu() if host else t).contiguous().clone()
        dist.broadcast(buf, dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        return buf.to(t.device) if host else buf


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL where every rank of this host has a card of its own, gloo on the
    CPU and where ranks share a card."""
    device = torch.device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None):
    """Join a process group of num_processes ranks as rank process_id, the
    rendezvous at coordinator_address ("host:port"), over `backend`
    (default_backend of the card when None). Call once per process before
    make_mesh; a no-op for one process (gato_tpu/parallel/sharding.py:35-44)."""
    if num_processes is None or num_processes <= 1:
        return
    backend = backend or default_backend("cuda" if torch.cuda.is_available() else "cpu")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def init_from_env(device="cuda") -> bool:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or without one a group of this
    process alone on a free localhost port, over default_backend(device).
    Returns True if this call made the group (the caller then destroys it:
    torch.distributed.destroy_process_group), False if one was there."""
    if dist.is_initialized():
        return False
    backend = default_backend(device)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        init_distributed(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                         world, int(os.environ["RANK"]), backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    return True


def make_mesh(group=None, device=None) -> Mesh:
    """The Mesh of this rank in `group` (None: the default group, which
    init_distributed or torch.distributed.init_process_group made). Its
    device: `device`, or by default the card of this rank's local index
    (LOCAL_RANK, else the rank) modulo the cards (several ranks may share
    one); no card raises (check_device): CPU ranks pass device="cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed, "
                           "init_from_env or torch.distributed.init_process_group first")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None or torch.device(device) == torch.device("cuda"):
        check_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = check_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if device.type == "cpu" and dist.get_backend(group) == "nccl":
        raise ValueError("an NCCL group reduces CUDA tensors only: use gloo for CPU ranks")
    return Mesh(group=group, rank=rank, world=world, device=device)


def lanes(mesh: Mesh, batch: int) -> slice:
    """This rank's contiguous lanes of a batch of `batch`: [r B/W, (r+1) B/W).
    The mesh's world must divide the batch (gato_tpu/parallel/fleet.py:50-52)."""
    if batch % mesh.world:
        raise ValueError(f"the batch of {batch} does not split over {mesh.world} ranks: "
                         "each rank takes an equal share of the lanes")
    n = batch // mesh.world
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_solve_args(mesh: Mesh, X, U, lam, x_s, ref, f_ext, hp: HyperParams):
    """The rank's lanes of the batch-leading arguments (the whole batch on
    every rank), on the rank's device, ready for solve_batched_sharded."""
    s = lanes(mesh, X.shape[0])

    def take(t):
        return t[s].to(mesh.device).contiguous()

    hp_s = HyperParams(take(hp.rho), take(hp.drho), take(hp.mu), take(hp.pcg_tol))
    return (take(X), take(U), take(lam), take(x_s), take(ref), take(f_ext), hp_s)


def solve_batched_sharded(model, settings, cp, hp, X, U, lam, x_s, ref, f_ext, dt,
                          mesh: Mesh | None = None, device_exit: bool = False):
    """solve_batched on this rank's lanes (shard_solve_args) with the
    whole-batch exit on the global converged count and num_iters_run the
    most over the ranks; every rank must call it. The lanes' outputs equal
    the same lanes of the unsharded solve. Without a mesh, the unsharded
    solve_batched (as the JAX package falls back on unsharded inputs).
    device_exit with a mesh needs a collective that stays on the device
    (NCCL on the card, gloo on the CPU): else ValueError."""
    if mesh is not None and X.device != mesh.device:
        raise ValueError(f"the lanes lie on {X.device}, the mesh's rank on {mesh.device}: "
                         "place them with shard_solve_args")
    return solve_batched(model, settings, cp, hp, X, U, lam, x_s, ref, f_ext, dt,
                         device_exit=device_exit, mesh=mesh)


def gather_batch(mesh: Mesh | None, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's lanes of t (batch along dim) in global order, on every
    rank; t itself without a mesh."""
    return t if mesh is None else mesh.all_gather(t, dim)


def gather_stats(mesh: Mesh | None, stats: SQPStats) -> SQPStats:
    """SQPStats of the whole batch from each rank's: the per-lane fields
    gathered (the per-iteration ones along their batch axis, 1);
    num_iters_run is already global."""
    if mesh is None:
        return stats
    per_iter = ("pcg_iters", "ls_min_merit", "ls_step_size")
    return replace(stats, **{
        name: gather_batch(mesh, getattr(stats, name), 1 if name in per_iter else 0)
        for name in ("sqp_iters", "kkt_converged", "pcg_iters", "ls_min_merit",
                     "ls_step_size", "initial_merit", "final_merit")})


def best_lane(final_merit: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Global argmin over every rank's per-lane final merits (an
    all-gather), as a 0-d tensor on this rank's device. Non-finite merits
    (a dead lane whose solve diverged) are masked to +inf: an argmin would
    otherwise select the NaN lane (gato_tpu/parallel/sharding.py:105-111)."""
    m = gather_batch(mesh, final_merit)
    return torch.argmin(torch.where(torch.isfinite(m), m, torch.inf))
