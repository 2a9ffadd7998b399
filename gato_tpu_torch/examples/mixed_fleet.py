"""Mixed indy7 + iiwa14 fleet in one process: examples/mixed_fleet.py on
the port.

Two plants with different DOF counts cannot share one launch, so the fleet
runs as two batched solves (parallel/fleet.py::solve_fleet), issued back to
back on the card's current stream each MPC cycle, each on its own plant's
kernel libraries. Each member tracks a figure-8 EE reference sized to its
own workspace, carries per-lane external wrench hypotheses (lane 0 = zero,
the hypothesis driving the simulation), and the merged fleet report
combines convergence counts and the per-member and fleet-wide best lanes.
Each member's lane-0 plant steps through api/common.py::rk4_step (4
substeps: the rk4 kernel on the card).

At the default N=8 every solve takes the whole-iteration kernel
(bsqp_iter) of its plant; past N = 128 (--N 256) the staged route: the
kkt, pcg and merit kernels of its plant. --device-time also measures the
fleet's cycle (both solves with the exit kept on the device, each member's
lane-0 rk4 step with 2 substeps, the rolled reference windows) captured
once into a CUDA graph and replayed: ms a cycle from CUDA events around the
replays, after the replays are held equal bit for bit to the same cycles
run eagerly.

    python -m gato_tpu_torch.examples.mixed_fleet [--cycles 60] [--B 8] [--N 8]
        [--device-time] [--save PATH] [--device cpu]
    torchrun --nproc-per-node <ranks> -m gato_tpu_torch.examples.mixed_fleet --mesh ...

--save merges the run into the JSON record at PATH under the key
N<N>_B<B>, with the card's name and power limit. --mesh splits every
member's batch over the ranks of torchrun's process group
(parallel/sharding.py; without torchrun a group of this process alone): one
card a rank over NCCL, or gloo where ranks share a card or run on the CPU;
each member's B must split evenly over the ranks. Rank 0 holds lane 0,
steps each member's plant and sends the new state to the other ranks; it
alone prints and saves, with "mesh": the number of ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..api.common import figure8, rk4_step
from ..api.config import DEFAULT_SOLVER_PARAMS, INDY7_START_CONFIGS
from ..dynamics.algorithms import ee_position
from ..ops.cost import CostParams
from ..ops.cuda_iter import sqp_iter_core_cuda
from ..ops.cuda_kkt import setup_kkt_batched_cuda
from ..ops.cuda_merit import merit_alphas_batched_cuda
from ..ops.cuda_pcg import pcg_solve_batched_cuda
from ..ops.cuda_sim import rk4_step_batched
from ..ops.cuda_solve import sqp_iter_cuda
from ..ops.schur import capturable_inverse
from ..parallel.fleet import FleetMember, fleet_report, solve_fleet
from ..parallel.sharding import init_from_env, make_mesh
from ..robots.model import load_robot
from ..solver.types import BSQPSettings, HyperParams

# (name, start q, fig-8 offset, fig-8 amplitude) of each member, as the JAX
# example's: iiwa14's fig-8 is centred on its start EE and sized to stay
# inside its workspace
SPECS = (
    ("indy7", INDY7_START_CONFIGS["ready"].astype(np.float32), (0.0, 0.5, 0.6), 0.4),
    ("iiwa14", np.asarray([0.0, 0.7, 0.0, -1.6, 0.0, 1.0, 0.0], np.float32),
     (0.393, -0.393, 0.21), 0.25),
)
# the kernel wrappers whose launches a captured cycle counts
WRAPPERS = dict(bsqp_iter=sqp_iter_cuda, iter=sqp_iter_core_cuda, kkt=setup_kkt_batched_cuda,
                pcg=pcg_solve_batched_cuda, merit=merit_alphas_batched_cuda,
                rk4=rk4_step_batched)


def launch_counts() -> dict:
    """{kernel: launches so far} of every kernel wrapper."""
    return {name: w.launches for name, w in WRAPPERS.items()}


def make_member(name, plant, q0, fig8_offset, B, N, dt, seed, amp=0.4, device="cuda"):
    """A FleetMember of `plant` at (B, N) resting at q0, with its fig-8
    reference (the whole trajectory, (T, 6) numpy) and B wrench hypotheses
    uniform in [-5, 5] from `seed`, lane 0 zero. float32 on `device`."""
    p = DEFAULT_SOLVER_PARAMS
    model = load_robot(plant, torch.float32, device)
    dev = model.R_tree.device
    settings = BSQPSettings(N=N, max_sqp_iters=p["max_sqp_iters"],
                            max_pcg_iters=p["max_pcg_iters"])
    cp = CostParams(q_cost=p["q_cost"], qd_cost=p["qd_cost"], u_cost=p["u_cost"],
                    N_cost=p["N_cost"], q_lim_cost=p["q_lim_cost"])
    hp = HyperParams.create(B, rho=p["rho"], mu=p["mu"], pcg_tol=p["pcg_tol"], device=dev)
    x0 = np.concatenate([q0, np.zeros_like(q0)]).astype(np.float32)
    traj = figure8(dt, A_x=amp, A_z=amp, offset=fig8_offset).reshape(-1, 6)
    rng = np.random.default_rng(seed)
    f_ext = rng.uniform(-5.0, 5.0, (B, 6)).astype(np.float32)
    f_ext[0] = 0.0  # the zero hypothesis drives the simulation

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    member = FleetMember(
        name=name, model=model, settings=settings, cp=cp, hp=hp,
        X=t(np.tile(x0, (B, N, 1))), U=torch.zeros(B, N - 1, model.nu, device=dev),
        lam=torch.zeros(B, N, model.nx, device=dev), x_s=t(np.tile(x0, (B, 1))),
        ref=t(np.tile(traj[:N], (B, 1, 1))), f_ext=t(f_ext), dt=dt)
    return member, traj


def fleet_cycle(members, trajs, N):
    """The fleet's cycle as a function of tensors, for a CUDA graph: (i,
    states) -> (i + 1, states), i a 0-d int64 tensor, states each member's
    (X, U, lam, x_s). Each member's reference window starts at i mod (T -
    N) of its trajectory (trajs: (T, 6) tensors on the card); both solves
    keep their exit on the device; each member's lane-0 plant takes one
    rk4_step of 2 substeps under U[0, 0] and warm-starts X[:, 0]."""
    ar = torch.arange(N, device=trajs[0].device)

    def cycle(i, states):
        now = []
        for m, td, (X, U, lam, x_s) in zip(members, trajs, states):
            idx = torch.remainder(i, td.shape[0] - N) + ar
            ref = td.index_select(0, idx)[None].expand(X.shape[0], N, 6).contiguous()
            now.append(replace(m, X=X, U=U, lam=lam, x_s=x_s, ref=ref))
        solved, _ = solve_fleet(now, device_exit=True)
        out = []
        for m in solved:
            xs1 = rk4_step(m.model, m.x_s[0], m.U[0, 0], m.dt, substeps=2)
            xsn = xs1[None].expand_as(m.x_s).contiguous()
            m.X[:, 0] = xsn
            out.append((m.X, m.U, m.lam, xsn))
        return i + 1, out
    return cycle


def _flat(i, states):
    return [i] + [t for st in states for t in st]


def device_cycle_time(members, trajs, N, reps=50, same_cycles=4):
    """The fleet's cycle (fleet_cycle, from the members' state at window
    index 1) captured once into a CUDA graph, after one eager cycle on a
    side stream, and replayed. Held: `same_cycles` replays equal the same
    cycles run eagerly bit for bit. The eager cycles and the capture run
    within ops/schur.py::capturable_inverse: past N = 128 the staged
    route's Schur inverse by triangular solves, which a graph can capture.
    Returns dict(ms: ms a cycle over `reps` replays between CUDA events,
    launches: the captured cycle's kernel launches, same_as_eager: True)."""
    dev = members[0].X.device
    if dev.type != "cuda":
        raise ValueError("device_cycle_time captures a CUDA graph: the members' tensors "
                         "must be on the card")
    cycle = fleet_cycle(members, [torch.tensor(trajs[m.name], dtype=torch.float32,
                                               device=dev) for m in members], N)
    i0 = torch.ones((), dtype=torch.int64, device=dev)
    start = [(m.X, m.U, m.lam, m.x_s) for m in members]

    def fresh():
        return i0.clone(), [tuple(t.clone() for t in st) for st in start]

    with capturable_inverse():  # the staged route's Schur inverse (ops/schur.py)
        # the eager cycles
        i, states = fresh()
        eager = []
        for _ in range(same_cycles):
            i, states = cycle(i, states)
            eager.append([t.clone() for t in _flat(i, states)])
        # warm-up on a side stream, then the capture
        i, states = fresh()
        static = _flat(i, states)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            cycle(i, states)
        torch.cuda.current_stream().wait_stream(side)
        for s, t in zip(static, _flat(i0, start)):
            s.copy_(t)
        g = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(g):
            new = [t.clone() for t in _flat(*cycle(i, states))]  # new may alias the state
            for s, t in zip(static, new):
                s.copy_(t)
        launches = {n: c - before[n] for n, c in launch_counts().items()}
    for k in range(same_cycles):
        g.replay()
        if not all(torch.equal(s, e) for s, e in zip(static, eager[k])):
            raise RuntimeError(f"the fleet's graphed cycle {k} differs from the eager one")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    del g
    return dict(ms=ms, launches=launches, same_as_eager=True)


def main(cycles=60, B=8, N=8, dt=0.01, save=None, device_time=False, device="cuda",
         use_mesh=False):
    """`cycles` closed-loop cycles of the fleet (solve_fleet, fleet_report,
    each member's lane-0 plant step, the next reference window), as the JAX
    example's main. Returns its record: the last cycle's fleet report, each
    member's EE tracking error over the last three quarters of the cycles
    and, with device_time, the graphed cycle's time (device_cycle_time).
    use_mesh: every member's batch split over the ranks of the process
    group (make_mesh on `device`; every rank calls this and gets the
    record, rank 0 prints and saves it)."""
    mesh = None
    if use_mesh:
        mesh = make_mesh(device=device)
        device = mesh.device
        if B % mesh.world:
            raise ValueError(f"--mesh: each member's B={B} must split evenly over the "
                             f"{mesh.world} ranks")
        if device_time:
            raise ValueError("--device-time captures the fleet's cycle into one CUDA graph "
                             "on one card: not with --mesh")
    members, trajs, errs = [], {}, {}
    for name, q0, off, amp in SPECS:
        m, traj = make_member(name, name, q0, off, B, N, dt, seed=0, amp=amp, device=device)
        members.append(m)
        trajs[name] = traj
        errs[name] = []
    report = None
    for k in range(cycles):
        members, stats = solve_fleet(members, mesh=mesh)
        report = fleet_report(members, stats)
        nxt = []
        for m in members:
            traj = trajs[m.name]
            # lane 0 (the zero-wrench hypothesis) controls the simulated arm;
            # under a mesh it is rank 0's, which sends the plant's new state
            if mesh is None or mesh.rank == 0:
                x1 = rk4_step(m.model, m.x_s[0], m.U[0, 0], dt, substeps=4)
            else:
                x1 = torch.empty_like(m.x_s[0])
            if mesh is not None:
                x1 = mesh.broadcast(x1, 0)
            ee = ee_position(m.model, x1[:m.model.nq])[:3]
            goal = torch.tensor(traj[k + 1, :3], dtype=ee.dtype, device=ee.device)
            errs[m.name].append(float(torch.linalg.norm(ee - goal)))
            B_m = m.X.shape[0]
            x_s = x1[None].expand(B_m, -1).contiguous()
            ref = torch.tensor(np.tile(traj[k + 1:k + 1 + N], (B_m, 1, 1)),
                               dtype=torch.float32, device=x1.device)
            m.X[:, 0] = x_s
            nxt.append(replace(m, x_s=x_s, ref=ref))
        members = nxt

    steady = cycles // 4
    out = {"cycles": cycles, "B_per_member": B, "N": N,
           "total_lanes": B * len(members), "mesh": None if mesh is None else mesh.world,
           "final_report": report,
           "tracking_err_m": {
               n: {"mean": round(float(np.mean(e[steady:])), 4),
                   "max": round(float(np.max(e[steady:])), 4)}
               for n, e in errs.items()}}
    if device_time:
        # from the loop's last state, as the JAX example's chained loop
        t = device_cycle_time(members, trajs, N)
        out["per_cycle_device_us"] = round(t["ms"] * 1e3, 1)
        out["lane_solves_per_s"] = round(B * len(members) / (t["ms"] * 1e-3), 1)
        out["graph"] = dict(ms_per_cycle=t["ms"], launches_per_cycle=t["launches"],
                            equal_to_eager=t["same_as_eager"])
        print(f"fleet per-cycle device time: {t['ms'] * 1e3:.1f} us "
              f"({out['lane_solves_per_s']:.0f} lane-solves/s)")
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out, indent=1))
        if save:
            _save(save, out)
            print(f"saved -> {save}")
    return out


def _save(path, out):
    """Merge `out` into the JSON record at path under N<N>_B<B>, with the
    card's name and power limit."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rec = {}
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    rec[f"N{out['N']}_B{out['B_per_member']}"] = dict(out, card=card)
    rec["meta"] = {
        "workload": ("the mixed indy7 + iiwa14 fleet of examples/mixed_fleet.py on "
                     "gato_tpu_torch: DEFAULT_SOLVER_PARAMS, fig-8 tracking, wrench "
                     "hypotheses from seed 0 with lane 0 zero driving each plant (rk4, 4 "
                     "substeps); per_cycle_device_us: the fleet's cycle (both solves, "
                     "lane-0 rk4 steps of 2 substeps, the rolled windows) as one CUDA graph, "
                     "from the loop's last state, 50 replays"),
        "device": torch.cuda.get_device_name(0), "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)


def cli(argv=None):
    """The command line: the JAX example's flags, and --device. With --mesh
    it joins torchrun's process group (init_from_env), or makes a group of
    this process alone, and leaves the group it made."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=60)
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--N", type=int, default=8)
    ap.add_argument("--mesh", action="store_true",
                    help="split every member's batch over the ranks (torchrun's process group)")
    ap.add_argument("--device-time", action="store_true",
                    help="also measure the fleet's cycle as one CUDA graph (device_cycle_time)")
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu: the plain route, gloo ranks")
    a = ap.parse_args(argv)
    made = a.mesh and init_from_env(a.device)
    try:
        return main(cycles=a.cycles, B=a.B, N=a.N, save=a.save, device_time=a.device_time,
                    device=a.device, use_mesh=a.mesh)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
