"""One rank of tests/test_torch_sharding.py's two-rank gloo world on the CPU.

Imports torch and the port, never jax: torch.multiprocessing spawns each
rank from this module. `run(rank, world, port, inputs, out_path)` joins
the group at tcp://127.0.0.1:<port>, takes its lanes of the test's global
inputs (numpy, float64) and runs every case on them:

  main   the sharded solve (indy7) on routes "solve" and "iter";
  exit   the sharded solve whose exit fires on the global count;
  best   best_lane over this rank's merits;
  fleet  solve_fleet(mesh=...) of an indy7 and an iiwa14 member, and
         fleet_report of it.

Rank 0 gathers each case's outputs (gather_batch, gather_stats) and saves
them as numpy arrays with torch.save at out_path.
"""

import torch
import torch.distributed as dist

from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.parallel import fleet
from gato_tpu_torch.parallel.sharding import (best_lane, gather_batch, gather_stats,
                                              lanes, make_mesh, shard_solve_args,
                                              solve_batched_sharded)
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams

DT = 0.01
COST = dict(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0, q_lim_cost=0.01)
STATS = ("sqp_iters", "kkt_converged", "pcg_iters", "ls_min_merit", "ls_step_size",
         "initial_merit", "final_merit", "num_iters_run")
# each route's gates (solve_kernel, iter_kernel)
GATES = {"solve": ("auto", "auto"), "iter": ("off", "auto")}


def tensors(a: dict):
    """(X, U, lam, x_s, ref, f_ext, HyperParams) of the whole batch from
    numpy arrays (rho, drho, mu, pcg_tol among them), float64 on the CPU."""
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in a.items()}
    return (t["X"], t["U"], t["lam"], t["x_s"], t["ref"], t["f_ext"],
            HyperParams(t["rho"], t["drho"], t["mu"], t["pcg_tol"]))


def settings(case: dict, gates=("auto", "auto")):
    return BSQPSettings(N=case["arrays"]["X"].shape[1], max_sqp_iters=case["max_sqp_iters"],
                        max_pcg_iters=case["max_pcg_iters"], solve_ratio=case["solve_ratio"],
                        solve_kernel=gates[0], iter_kernel=gates[1])


def solved(model, st, args, dt=DT, mesh=None):
    """solve_batched (sharded with a mesh) of args: {X, U, lam, rho, stats}
    as numpy, the lanes gathered from every rank."""
    X, U, lam, x_s, ref, f_ext, hp = args
    if mesh is not None:
        X, U, lam, x_s, ref, f_ext, hp = shard_solve_args(mesh, X, U, lam, x_s, ref, f_ext, hp)
    Xo, Uo, lam_o, hp_o, stats = solve_batched_sharded(
        model, st, CostParams(**COST), hp, X, U, lam, x_s, ref, f_ext, dt, mesh=mesh)
    stats = gather_stats(mesh, stats)
    out = {k: gather_batch(mesh, v).numpy() for k, v in
           dict(X=Xo, U=Uo, lam=lam_o, rho=hp_o.rho).items()}
    out.update({k: getattr(stats, k).numpy() for k in STATS})
    return out


def fleet_members(cases: dict):
    """A FleetMember of each plant of cases ({plant: case}), the whole batch."""
    members = []
    for plant, case in cases.items():
        X, U, lam, x_s, ref, f_ext, hp = tensors(case["arrays"])
        members.append(fleet.FleetMember(
            name=plant, model=load_robot(plant, torch.float64, "cpu"), settings=settings(case),
            cp=CostParams(**COST), hp=hp, X=X, U=U, lam=lam, x_s=x_s, ref=ref, f_ext=f_ext,
            dt=DT))
    return members


def fleet_outputs(members, stats_list, mesh=None):
    """{plant: {X, U, lam, rho, stats}} as numpy, gathered from every rank,
    and the fleet report."""
    out = {}
    for m, st in zip(members, stats_list):
        st = gather_stats(mesh, st)
        o = {k: gather_batch(mesh, v).numpy() for k, v in
             dict(X=m.X, U=m.U, lam=m.lam, rho=m.hp.rho).items()}
        o.update({k: getattr(st, k).numpy() for k in STATS})
        out[m.name] = o
    return out, fleet.fleet_report(members, stats_list)


def run(rank, world, port, inputs, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(device="cpu")
        model = load_robot("indy7", torch.float64, "cpu")
        out = {}
        out["main"] = {route: solved(model, settings(inputs["main"], gates),
                                     tensors(inputs["main"]["arrays"]), mesh=mesh)
                       for route, gates in GATES.items()}
        out["exit"] = solved(model, settings(inputs["exit"]), tensors(inputs["exit"]["arrays"]),
                             mesh=mesh)
        merits = torch.tensor(inputs["best"])
        out["best"] = int(best_lane(merits[lanes(mesh, merits.shape[0])], mesh))
        members, stats_list = fleet.solve_fleet(fleet_members(inputs["fleet"]), mesh=mesh)
        out["fleet"], out["fleet_report"] = fleet_outputs(members, stats_list, mesh)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
