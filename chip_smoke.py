"""Smoke run of the PyTorch + CUDA port (gato_tpu_torch) on one NVIDIA GPU.

Drives the port's solve routes through their entry point
(gato_tpu_torch.solver.bsqp.solve_batched) in the steady-state closed-loop
fig-8 MPC cycle of bench.py (indy7, DEFAULT_SOLVER_PARAMS): one batched
solve, an RK4 plant step of lane 0 under U[0, 0] (2 substeps,
gato_tpu_torch.api.common.rk4_step) and a roll of the reference window per
cycle.

  main path     N=32, B=512, the default route (bsqp_iter + rk4), K=50
                cycles, and K_GATE=200 on the plain PyTorch route;
  fused route   solve_kernel="off": the iter and merit kernels, K=50 cycles;
  staged route  solve_kernel="off", iter_kernel="off": the kkt, pcg and
                merit kernels, K=50 cycles;
  N=32 gate     each of the three routes and the plain route over K_GATE
                cycles from the run's warm-up, read as four disjoint windows
                of 50 (held: each window's mean EE error below 0.1 m, each
                kernel route's first window within 10 % of the plain
                route's; read: the mean over the windows within 10 %), and
                the same read with rk4's other variant;
  API           the BSQP facade at N=32 B=512 from the steady state
                (`[facade]`: equal bit for bit to a direct solve_batched
                call, one bsqp_iter launch a solve; at max_sqp_iters=5 held
                against the float64 plain version, each iteration's device
                time and the host's read of the exit between launches;
                sim_forward and ee_pos against float64), MPC_GATO's fig-8
                loop (`[mpc]`: the README's quick start, N=32 B=32 under a
                -60 N world-z wrench for 5 s, and B=1 without a wrench for
                2 s, where rk4 launches once per plant-step call) and goal
                loop (`[goals]`: N=32 B=1, one goal 5 cm away);
  long horizon  N=256, B=64, where "auto" takes the staged route by itself:
                6 warm-up and 10 timed cycles;
  rollouts      the on-device closed loops (gato_tpu_torch.api.rollout),
                each cycle captured once into a CUDA graph and replayed,
                equal bit for bit to the same cycles run eagerly:
                `[rollout]` (closed_loop_rollout on the main path's shape,
                200 cycles), `[rollout-estimator]` (the sphere search and
                the Gauss-Newton observer at examples/force_adaptive.py's
                working point and at N=32 B=512), `[rollout-goals]` (three
                goals with the indy7 + 15 kg pendulum plant on its
                generated rk4 library, the cycle split into its parts)
                and `[runner]`
                (ExperimentRunner at B = 1, 32, 128, 512). rk4's wrench
                branch is held against its plain version first (`[compare]
                rk4 ... with a wrench`);
  second plant  iiwa14 (nq = 7), every kernel built for it, and rk4 for
                the pendulum plants (indy7 and
                iiwa14 + 15 kg at 0.3 m, nq = 9 and 10: their headers
                generated from the registered constants and built with
                the other libraries; iiwa14_phases): `[iiwa14-kernels]`
                (bsqp_iter held to its plain version as indy7's is at N=32
                with B=128 and 512, at the shared layout's last N and at
                N=128, B=512; iter and merit at N=32 B=512 as indy7's; rk4
                in both variants at B=1 and 512 with and without a wrench,
                on each pendulum plant at B=1 and 128; each shared-layout
                G timed), `[bench-iiwa14]` (the fig-8 cycle at N=32 B=512,
                bench.py --plant iiwa14, on the default route and on the
                fused-iteration route), `[iiwa14-staged]` (kkt and pcg held
                and timed as indy7's at N=32 B=512 and N=256 B=64, pcg's
                variants timed at iiwa14's cut points, the staged route at
                both shapes launching kkt, pcg, merit and rk4 and nothing
                else, N=256 tracking within 10 % of the plain route),
                `[rollout-iiwa14]` (closed_loop_rollout toward a goal 8.8
                cm away, held below 0.03 m) and `[rollout-goals-iiwa14]`
                (examples/pickplace.py's device loop on the port,
                gato_tpu_torch.examples.pickplace_device: iiwa14 + 15 kg
                pendulum, five goals, 12,502 cycles at B=128, the plant on
                rk4; outcomes printed, not held; the cycle split into its
                parts);
  fleet         `[fleet]`: the mixed indy7 + iiwa14 fleet through its
                example (gato_tpu_torch.examples.mixed_fleet.main, B=8 each)
                at N=8 (each member's bsqp_iter and rk4) and N=256 (each
                member's kkt, pcg, merit and rk4: the staged route), the
                launches of each member counted and held, every solve
                finite, the fleet's cycle as one CUDA graph equal to the
                eager cycles bit for bit (the report and the tracking
                errors printed, not held);
  sharded       `[sharded]`: the batch split over ranks
                (gato_tpu_torch.parallel.sharding). In this process a world
                of one over NCCL: the sharded solve at the main path's cell
                equal bit for bit to the unsharded one on "solve" and
                "iter", within bsqp_iter's limits on "staged"; an exit
                case (N=8) that fires on the global count; best_lane; the
                collectives' cost in the closed loop at N=32 B=32 and 512
                (tools/shardmap_overhead.py's arms, interleaved). NCCL with
                two ranks on the card (refused: printed). Two ranks
                sharing the card over gloo (torchrun, this script's
                --sharded-worker): each solves its half of the same
                inputs, held bit for bit against this process's unsharded
                solves (the main cell on "solve" and "iter", the exit case
                where the halves alone would decide differently), the
                mixed fleet with --mesh against the unsharded fleet, each
                rank's launches; scaling_bench at one and two ranks.

The pcg kernel comes in variants (layout, G, C): one CTA per problem with
its blocks in shared memory, a thread-block cluster of C CTAs per problem,
the global scratch (ops/cuda_pcg.py::pcg_variant takes one by N). Each
variant's shared memory, CTAs per SM, resident clusters and ptxas line
print as `[variant] pcg` lines; every variant that fits is held against the
plain version and timed (`[pcg]` lines) on the steady-state systems at
N=32 B=512 and N=256 B=64, and timed at PCG_EDGE_HORIZONS (B=512), where
the shared variant meets the 2-CTA cluster; the staged route's cycle runs
with pcg in the variant N takes and in the global one, in turns, at both
shapes.

The kkt kernel comes in two variants (layout, G): staged, G = 2 threads
per knot sharing the generated knot_kkt's stages (indy7's default), and
the earlier one-thread kernel ("one", 1; iiwa14's only variant, its header
has no staged KKT). Each variant's registers, spills, shared
memory and CTAs per SM print as `[variant] kkt` lines; both are held
against the plain version and timed (`[kkt]` lines) at N=32 B=512 and
N=256 B=64. Each route's cycle also runs in turns with a kernel forced
back to its earlier variant (the one-thread phase A, the one-thread kkt,
pcg's global variant), and the routes' cycles are timed once more before
any CUDA graph is captured (`[harness]`).

The rk4 kernel comes in two variants: "one" (the default, the earlier kernel:
a thread a plant) and "crba" (forced only: a CTA of two warps per plant,
the mass matrix's CRBA on one lane beside the RNEA bias on another, the
solve on every thread); the merit kernel in two: "warps" (the default:
four (problem, alpha) pairs a CTA, a warp each) and "one". Each variant
prints a `[variant]` line (registers, spills; merit: CTAs per SM and
rounds), is held against its plain version (rk4 at the plant's B=1, merit
at N=32 B=512 and N=256 B=64) and timed in two rounds (`[rk4]`, `[merit]`
lines); the default route runs in turns with rk4 forced to "crba", the
"iter" and staged routes with merit forced back; the N=32 tracking gate is
also read (not held) with rk4's other variant from its own warm-up
(PERF.md section 6); rk4's bound at B=1 is
the latency of its chain of dependent operations (`[bound] rk4`,
`bound_by: "latency"` in the kernels line). ROADMAP Queue 3's items: the
N=256 pcg witness (`[witness]`: the kernel, the card's and the CPU's
float32 plain versions and float64 on the default route's system and on
one assembled in float64, held on the latter) and the N=256 route's
tracking against the plain route's over the same cycles. Instead of all
that, `--save-capped PATH` saves the N=64 cap lanes' Schur system
(save_capped_schur, tests/test_torch_pcg_capped.py), `--tracking-spread`
reads the N=32 tracking gate (its windows) from nearby warm-ups, and
`--fusion-probe`
compares rk4's variants built with and without multiply-add fusion.

It builds the six CUDA kernels from gato_tpu_torch/csrc/ for their plants
(every kernel for indy7 and iiwa14, rk4 also for the two pendulum plants:
one nvcc each, all at once),
holds each against its plain PyTorch version on the steady-state
input (kkt, pcg and merit at N=256 too; bsqp_iter and iter also at N=64
and 128, B=512, the shared layout's last N and the global layout, where
the limits give way to float32's own measured noise; pcg and kkt in every
variant), prints each iteration-kernel variant's G, phase A (the staged
KKT or the one-thread knot_kkt), shared memory, blocks per SM and ptxas
line, times bsqp_iter and iter in every variant (global layout, shared at
G = 1, 2, 4, and at G = 4 with either phase A) at N=32 and N=64 with and
without the Krylov loop, counts each path's launches with the counts set
to 0 just before it, times every route's cycle with CUDA events, checks
lane 0's fig-8 tracking error on every N=32 route, and computes each
kernel's bound from this run's inputs.

    python3 chip_smoke.py
    python3 chip_smoke.py --save-capped n64_capped_schur.npz
    python3 chip_smoke.py --tracking-spread
    python3 chip_smoke.py --fusion-probe
    python3 chip_smoke.py --iiwa14       # the second plant's phases only
    python3 chip_smoke.py --fleet        # the mixed fleet only
    python3 chip_smoke.py --schur-inverse  # the staged cycle, either Schur inverse
    python3 chip_smoke.py --sharded      # the batch split over ranks only

Needs one CUDA GPU; fails without one. Every failed check raises. The last
two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come on the
line before them.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from gato_tpu_torch import _build
from gato_tpu_torch.api import BSQP, MPC_GATO, ExperimentRunner, add_pendulum
from gato_tpu_torch.api import rollout as rollout_mod
from gato_tpu_torch.api.common import figure8, rk4_step, world_wrench_to_ee_frame
from gato_tpu_torch.api.config import PENDULUM_DEFAULT_PARAMS
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import IIWA14_START_CONFIGS, INDY7_START_CONFIGS
from gato_tpu_torch.dynamics import mathshim as ms
from gato_tpu_torch.dynamics.codegen import header_path, header_stats
from gato_tpu_torch.examples import mixed_fleet
from gato_tpu_torch.ops import cuda_iter, cuda_kkt, cuda_merit, cuda_pcg, cuda_sim
from gato_tpu_torch.ops import schur as schur_mod
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.ops.cuda_iter import (iteration_variant, phase_a_default,
                                          smem_bytes, sqp_iter_core_cuda,
                                          sqp_iter_core_reference,
                                          variant_resources)
from gato_tpu_torch.ops.cuda_kkt import setup_kkt_batched_cuda
from gato_tpu_torch.ops.cuda_kkt import variant_resources as kkt_resources
from gato_tpu_torch.ops.cuda_merit import merit_alphas_batched_cuda
from gato_tpu_torch.ops.cuda_pcg import CLUSTER_SIZES
from gato_tpu_torch.ops.cuda_pcg import GROUPS as PCG_GROUPS
from gato_tpu_torch.ops.cuda_pcg import fits as pcg_fits
from gato_tpu_torch.ops.cuda_pcg import library_smem_bytes as pcg_library_bytes
from gato_tpu_torch.ops.cuda_pcg import pcg_solve_batched_cuda, pcg_variant
from gato_tpu_torch.ops.cuda_pcg import smem_bytes as pcg_smem_bytes
from gato_tpu_torch.ops.cuda_pcg import variant_resources as pcg_resources
from gato_tpu_torch.ops.cuda_sim import rk4_plain, rk4_step_batched
from gato_tpu_torch.ops.integrators import sim_step
from gato_tpu_torch.ops.cuda_solve import (IterState, Problem, sqp_iter_cuda,
                                           sqp_iter_reference,
                                           sqp_solve_chained)
from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
from gato_tpu_torch.ops.merit_fast import _get_cd, merit_alphas_batched
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from gato_tpu_torch.ops.schur import build_schur
from gato_tpu_torch.parallel import scaling_bench, sharding
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.dynamics.algorithms import ee_position, fk
from gato_tpu_torch.solver import bsqp as bsqp_mod
from gato_tpu_torch.solver.bsqp import select_route, sim_forward_batched, solve_batched
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams

N, B, DT, K, WARMUP = 32, 512, 0.01, 50, 6
# each plant's start and fig-8 (bench.py:85-97: iiwa14's elbow-bent start,
# the fig-8 centred on its EE and sized to its workspace)
START = dict(indy7=INDY7_START_CONFIGS["ready"], iiwa14=IIWA14_START_CONFIGS["bent"])
FIG8_SHAPE = dict(indy7={}, iiwa14=dict(A_x=0.25, A_z=0.25, offset=(0.393, -0.393, 0.21)))
N_LONG, B_LONG, K_LONG = 256, 64, 10
# the iteration kernels' variants, (layout, G, phase A): the earlier
# global-scratch layout and the shared layout at 1, 2, 4 threads per knot
# with the one-thread phase A, and at 4 with the staged one; timed at N=32
# and N_WIDE (B=512), and held against their plain versions at
# CHECK_HORIZONS (B=512) in the variant that each N takes: the shared
# layout's last N, the global layout
VARIANTS = (("global", 1, "one"), ("shared", 1, "one"), ("shared", 2, "one"),
            ("shared", 4, "one"), ("shared", 4, "staged"))
# the kkt variant indy7 takes (each plant's: cuda_kkt.DEFAULT)
KKT_DEFAULT = cuda_kkt.DEFAULT["indy7"]
MERIT_DEFAULT = cuda_merit.DEFAULT
N_WIDE, CHECK_HORIZONS = 64, (64, 128)
# where the pcg kernel's shared variant meets the 2-CTA cluster (B=512)
PCG_EDGE_HORIZONS = (64, 80, 95)
# the N_WIDE cap lanes saved by --save-capped: each lane's Schur system is
# about 150 KB in float32, so six stay under 1 MB
CAPPED_LANES = 6
RK4_RTOL = 1e-5
# bsqp_iter against its plain version (float32, identical input): the
# fraction of lanes with the same step and with a PCG count within
# PCG_SLACK; the trajectory (normwise) where step and count agree; the
# warm-start merit, which no PCG touches. The line-search merit depends on
# where float32 PCG at tol 1e-4 stops, which moves with the assembly's
# rounding: it is held against the float64 plain version, where the kernel
# may be at most F64_FACTOR times as far off as the float32 plain version.
STEP_SAME_MIN, TRAJ_RTOL, MERIT_RTOL, MERIT0_RTOL = 0.99, 1e-3, 1e-3, 1e-5
PCG_SLACK, F64_FACTOR = 3, 2.0
# the long horizons' limits (noise_limits): a share of lanes never below
# SHARE_FLOOR, a normwise limit never above NOISE_CAP
SHARE_FLOOR, NOISE_CAP = 0.8, 5 * TRAJ_RTOL
LIMIT_NOTE = {False: "", True: "; the limits: float32's own noise where larger, noise_limits"}
# lane 0's mean EE tracking error over a route's cycles: within TRACK_REL
# of the plain route's from the same state (tracks_like_plain), on every
# route at N=32 and N=256. At N=32 the gate reads K_GATE cycles from one
# warm-up as GATE_WINDOWS disjoint windows of K_GATE / GATE_WINDOWS cycles
# (gate): every window below TRACK_MAX_M on every route, and each kernel
# route's first window within TRACK_REL of the plain route's, are held;
# the mean over the windows within TRACK_REL is read. The closed loop is
# chaotic in float32, and a 1-ulp change upstream moves a window's error by
# up to 35 %, the mean of four by up to 45 % (PERF.md section 6)
TRACK_MAX_M, TRACK_REL = 0.1, 0.10
K_GATE, GATE_WINDOWS = 200, 4
# [facade]: the BSQP facade's stats keys (gato_tpu/api/interface.py:224-256)
# with their shapes, n the iterations run; sim_forward and ee_pos in
# float32 against the float64 algorithms on the CPU, normwise (float32 fd
# carries about 1e-5 of |qdd| on these plants, scaled by dt in a step)
FACADE_SHAPES = dict(
    sqp_time_us=None, sqp_time_us_device=None, sqp_iters=("B",), kkt_converged=("B",),
    final_merit=("B",), initial_merit=("B",), best_initial_merit=None,
    ls_num_iters=None, pcg_iters=("n", "B"), pcg_times_us=("n",), min_merit=("n", "B"),
    step_size=("n", "B"), best_merit_per_iter=("n",), best_merit_iter1=None,
    best_merit_per_iter_normalized=("n",))
FACADE_ITERS, SIM_RTOL, EE_RTOL = 5, 1e-4, 1e-5
# [mpc]: the README's quick start (MPC_GATO N=32, B=32, -60 N world z,
# sim_dt 1e-3, 5 s); and B=1 without a wrench for MPC_B1_TIME s
MPC_WRENCH, MPC_TIME, MPC_B1_TIME = (0.0, 0.0, -60.0, 0.0, 0.0, 0.0), 5.0, 2.0
# the on-device rollouts (gato_tpu_torch.api.rollout), each cycle one CUDA
# graph: [rollout] closed_loop_rollout on the main path's shape over
# ROLLOUT_STEPS cycles (mean EE error below TRACK_MAX_M; with every
# hypothesis zero, each window below TRACK_MAX_M); every rollout's
# graph replays equal its eager cycles bit for bit over the first
# ROLLOUT_SAME. [rollout-estimator]: examples/force_adaptive.py's working
# point (indy7, EST_N, EST_B, EST_STEPS cycles under EST_WRENCH, the
# observer's final force error below OBSERVER_FORCE_MAX N, the EE hold over
# the last 10 cycles below HOLD_MAX m in both modes), then at N=32 B=512.
# [rollout-goals]: the pendulum plant, GOALS in metres from the start EE,
# GOAL_TIMEOUT s each. [runner]: ExperimentRunner at RUNNER_BATCHES.
ROLLOUT_STEPS, ROLLOUT_SAME = K_GATE, 20
EST_N, EST_B, EST_STEPS, EST_PCG = 8, 16, 150, 30
EST_WRENCH = (12.0, -8.0, 5.0, 0.0, 0.0, 0.0)
EST_Q0 = (-1.0966, -0.099, 0.8313, -0.109, 0.497, 0.015)
OBSERVER_FORCE_MAX, HOLD_MAX = 0.1, 0.05
GOALS = ((0.05, 0.0, 0.0), (0.0, 0.07, -0.03), (-0.06, 0.03, 0.05))
GOALS_B, GOAL_TIMEOUT, GOALS_CONTROL_DT = 32, 2.0, 0.002
RUNNER_BATCHES, RUNNER_TIME = (1, 32, 128, 512), 1.0
# kkt: each KKTSystem tensor within KKT_RTOL of its largest |value|
# (identical float32 inputs; only the order of operations differs).
# merit: each (lane, alpha) merit within MERIT_ALPHA_RTOL, relative (the
# order of the sum over knots is the only difference).
# pcg: on the identical assembled system, identical counts on at least
# PCG_SAME_MIN of the lanes, lam normwise within LAM_RTOL where they agree.
KKT_RTOL, MERIT_ALPHA_RTOL, PCG_SAME_MIN, LAM_RTOL = 1e-4, 1e-5, 0.99, 1e-3
# H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def plant_ops(nq):
    """Operations per knot outside the generated functions for a plant of
    nq joints (nx = 2 nq = 2 nu), counted from the kernels' loops
    (csrc/sqp_iter.cuh, csrc/pcg.cu, csrc/rk4.cu): a Cholesky inverse of an
    n x n block is about 7 n^3 / 3; phi nx (2 nq^2 + nq), theta's upper
    triangle nx (nx + 1) / 2 entries of 2 nx + 3 nu + 2, gamma nx (2 nq +
    2 nx + 3 nu + 3), P_lower 2 x 2 x nx^3 (indy7: 936, 3,432, 684 and 2 x
    2 x 12^3); dz recovery nx (2 nx + 2) + 2 nq^2 + nq + nu (2 nx + 3)
    (about 550); a block-tridiagonal matvec three nx x nx blocks of
    multiply-adds; a PCG iteration two matvecs, two dots and three vector
    updates; an RK4 substep's stage states and update 13 nx; a merit
    knot's candidate x, x_next, u 2 nx + nu multiply-adds."""
    nx, nu = 2 * nq, nq
    matvec = 3 * nx * nx * 2
    return dict(
        schur=(7 * nq ** 3 // 3 + nx * (2 * nq * nq + nq) + nx * (nx + 1) // 2
               * (2 * nx + 3 * nu + 2) + nx * (2 * nq + 2 * nx + 3 * nu + 3)
               + 7 * nx ** 3 // 3 + 4 * nx ** 3),
        dz=nx * (2 * nx + 2) + 2 * nq * nq + nq + nu * (2 * nx + 3),
        matvec=matvec, pcg_setup=2 * matvec + nx + 2 * nx,
        pcg_iter=2 * matvec + 2 * 2 * nx + 3 * 2 * nx, rk4_axpy=13 * nx,
        candidate=2 * (2 * nx + nu))


_INDY7_OPS = plant_ops(6)
SCHUR_OPS, DZ_OPS, MATVEC_OPS = _INDY7_OPS["schur"], _INDY7_OPS["dz"], _INDY7_OPS["matvec"]
PCG_SETUP_OPS, PCG_ITER_OPS = _INDY7_OPS["pcg_setup"], _INDY7_OPS["pcg_iter"]
RK4_SUBSTEP_AXPY_OPS = _INDY7_OPS["rk4_axpy"]
# rk4's latency bound at B = 1 (the main path): each of the 4 x 2 stages
# runs one forward dynamics call (fd's depth in the one variant; the deeper
# of fd_crba and fd_bias, then fd_solve, in the crba variant: the depths
# the generator writes into csrc/generated/indy7.cuh) and the stage's
# point q + c k (a product, then a sum), every operation one FP32 FMA
# latency at the SM's maximum clock
RK4_SUBSTEPS, RK4_AXPY_DEPTH, FMA_CYCLES = 2, 2, 4
CANDIDATE_OPS = _INDY7_OPS["candidate"]
WRAPPERS = dict(bsqp_iter=sqp_iter_cuda, rk4=rk4_step_batched,
                iter=sqp_iter_core_cuda, kkt=setup_kkt_batched_cuda,
                pcg=pcg_solve_batched_cuda, merit=merit_alphas_batched_cuda)


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def event_ms(fn, reps):
    """Mean ms per call of fn over reps back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps):
    """Device ms per call of fn: reps calls captured in one CUDA graph,
    replayed three times between CUDA events, so the host's time to enqueue
    a call (about 0.1 ms of Python and ctypes a wrapper call) does not
    count. The wrappers allocate their outputs, which the capture takes
    from the graph's own pool."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (3 * reps)
    del g
    torch.cuda.empty_cache()
    return ms


def reset_launches():
    for w in WRAPPERS.values():
        w.launches = 0


def launches():
    return {name: w.launches for name, w in WRAPPERS.items()}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(ops, n_bytes):
    """(bound_ms, bound_by): the larger of the operations over the FP32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def generated_stats(robot="indy7"):
    """{function: (operations, dependency depth)} of the generated
    functions, as dynamics/codegen.py writes them above each function of
    csrc/generated/<robot>.cuh: every binary + - * / and every sqrt, sin,
    cos, log, abs and max call counts as one operation; a negation, which
    compiles into its user's operand, counts as none and adds no link."""
    with open(header_path(robot)) as f:
        return header_stats(f.read())


def sm_max_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def rk4_latency_bound(stats, mhz, variant):
    """(ms, depth of one stage): the chain of dependent operations of the
    main path's plant step (B = 1, RK4_SUBSTEPS substeps) in `variant`,
    FMA_CYCLES a link at `mhz`."""
    fd_depth = (stats["fd"][1] if variant == "one" else
                max(stats["fd_crba"][1], stats["fd_bias"][1]) + stats["fd_solve"][1])
    depth = fd_depth + RK4_AXPY_DEPTH
    return 4 * RK4_SUBSTEPS * depth * FMA_CYCLES / (mhz * 1e3), depth


def taken_variant(n, nx=12):
    """(layout, G, phase A) of the iteration kernels at horizon n for a
    plant of state size nx."""
    layout, g = iteration_variant(n, nx)
    return layout, g, phase_a_default(layout, g, nx)


def variant_name(n, nx=12):
    layout, g, phase_a = taken_variant(n, nx)
    return f"{layout} layout, G={g}, phase A {phase_a}"


def ptxas_lines(name, pattern, key_of, robot="indy7"):
    """{key_of(match): ptxas' register and spill lines} of the kernels of
    csrc/<name>.cu built for `robot` whose mangled name matches `pattern`."""
    out, key = {}, None
    for line in _build.ptxas_report(name, robot).splitlines():
        m = re.search(pattern, line)
        if m:
            key = key_of(m)
            out[key] = []
        elif "Compiling entry" in line:
            key = None
        elif key is not None:
            out[key].append(line.strip())
    return {k: "; ".join(v) for k, v in out.items()}


def ptxas_variants(name, robot="indy7"):
    """{(layout, G, phase A): ptxas' register and spill lines} of the
    iteration kernel variants compiled in csrc/<name>.cu for `robot`."""
    return ptxas_lines(
        name, r"iteration_kernelILb[01]ELNS_6BlocksE(\d)ELi(\d)ELb([01])E",
        lambda m: (("global", "shared")[int(m.group(1))], int(m.group(2)),
                   ("one", "staged")[int(m.group(3))]), robot)


def ptxas_kkt(robot):
    """{kkt variant: ptxas' register and spill lines} of `robot`'s library."""
    return ptxas_lines("kkt", r"kkt_(one_kernel|staged_kernelILi(\d)E)",
                       lambda m: ("staged", int(m.group(2))) if m.group(2) else ("one", 1),
                       robot)


def spill_bytes(ptxas):
    """The spill stores that a ptxas line reports, in bytes."""
    m = re.search(r"(\d+) bytes spill stores", ptxas)
    if m is None:
        raise RuntimeError(f"no spill count in the ptxas line {ptxas!r}")
    return int(m.group(1))


def report_variants():
    """Each variant's G, shared memory, resident blocks per SM and ptxas
    line at N=32 and N_WIDE; and the library's shared-memory byte count
    against its Python mirror (ops/cuda_iter.py::smem_bytes) at every N."""
    for name in ("bsqp_iter", "iter"):
        bad = [(n, v) for n in range(2, 129) for v in VARIANTS
               if variant_resources(name, n, *v)[0] != smem_bytes(n, *v[:2])]
        if bad:
            raise RuntimeError(f"{name}: smem_bytes differs from the library at {bad[:4]}")
        px = ptxas_variants(name)
        for n in (N, N_WIDE):
            for v in VARIANTS:
                nb, per_sm = variant_resources(name, n, *v)
                taken = " (the variant N takes)" if taken_variant(n) == v else ""
                log(f"[variant] {name} N={n} {v[0]} layout G={v[1]} phase A {v[2]}{taken}: "
                    f"{nb} bytes of shared memory, {per_sm} blocks per SM "
                    f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
                    f"{v[1] * 32 * ((n + 31) // 32)} threads; ptxas: {px[v]}")
    log("[variant] bytes of shared memory equal ops/cuda_iter.py::smem_bytes "
        "for every variant at N = 2..128")


def time_variants(f, state, i, card):
    """Device ms per launch (graph_ms) of bsqp_iter and iter in every
    variant on one steady-state input, and each with max_pcg_iters=0:
    phases A-C, D's set-up and E-G without the Krylov loop, so the loop's
    share is the difference (the phase split by a runtime argument, no
    measurement build). Two rounds in opposite orders, their mean."""
    X, U, lam, x_s = state
    zero = torch.zeros(f.B, device=f.dev)
    prob = Problem(x_s, f.ref(i), f.f_ext, f.hp.mu, f.hp.pcg_tol, DT)
    s0 = IterState(X, U, lam, f.hp.rho, f.hp.drho, zero, zero, zero, zero)
    no_loop = dataclasses.replace(f.settings, max_pcg_iters=0)
    skip = torch.zeros(f.B, dtype=torch.bool, device=f.dev)
    core = (X, U, x_s, f.ref(i), f.f_ext, lam, f.hp.rho, f.hp.pcg_tol, skip, DT)

    def calls(v):
        kw = dict(variant=v[:2], phase_a=v[2])
        return dict(
            bsqp_iter=lambda: sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings,
                                            seeded=False, **kw),
            bsqp_iter_no_loop=lambda: sqp_iter_cuda(f.model, f.cp, prob, s0, no_loop,
                                                    seeded=False, **kw),
            iter=lambda: sqp_iter_core_cuda(f.model, f.cp, *core, P["max_pcg_iters"], **kw),
            iter_no_loop=lambda: sqp_iter_core_cuda(f.model, f.cp, *core, 0, **kw))

    rounds = {v: {} for v in VARIANTS}
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            for k, fn in calls(v).items():
                rounds[v].setdefault(k, []).append(graph_ms(fn, 10))
    ms = {v: {k: statistics.mean(t) for k, t in d.items()} for v, d in rounds.items()}
    for v in VARIANTS:
        m = ms[v]
        taken = " (the variant this N takes)" if taken_variant(f.N) == v else ""
        log(f"[layout] {card}: N={f.N} B={f.B} {v[0]} layout G={v[1]} phase A {v[2]}{taken}: "
            f"bsqp_iter {m['bsqp_iter']:.4f} ms, iter {m['iter']:.4f} ms; split: "
            f"without the Krylov loop {m['bsqp_iter_no_loop']:.4f} ms (iter "
            f"{m['iter_no_loop']:.4f}), so the loop {m['bsqp_iter'] - m['bsqp_iter_no_loop']:.4f} "
            f"ms, F-G {m['bsqp_iter_no_loop'] - m['iter_no_loop']:.4f} ms, A-C + D's "
            f"set-up + E {m['iter_no_loop']:.4f} ms; rounds "
            + json.dumps({k: [round(t, 4) for t in ts] for k, ts in rounds[v].items()}))
    return ms


def same_bits_as_global(f, state, i):
    """At N <= 32 (one warp) the shared layout at G=1 sums every matvec row
    and every dot product in the global layout's order, so bsqp_iter's
    outputs must equal the global layout's bit for bit."""
    X, U, lam, x_s = state
    zero = torch.zeros(f.B, device=f.dev)
    prob = Problem(x_s, f.ref(i), f.f_ext, f.hp.mu, f.hp.pcg_tol, DT)
    s0 = IterState(X, U, lam, f.hp.rho, f.hp.drho, zero, zero, zero, zero)
    outs = [sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings, seeded=False, variant=v)
            for v in (("global", 1), ("shared", 1))]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((*outs[0][0], *outs[0][1]),
                                                 (*outs[1][0], *outs[1][1])))
    log(f"[layout] N={f.N} B={f.B}: bsqp_iter in the shared layout at G=1 equals "
        f"the global layout bit for bit: {same}")
    if not same:
        raise RuntimeError("the shared layout at G=1 differs from the global layout")


def normwise(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


class Fig8:
    """bench.py's closed loop on the port: one route (solve, plant) each,
    for indy7 or iiwa14 (bench.py --plant: START and FIG8_SHAPE)."""

    def __init__(self, dev, n=N, b=B, robot="indy7"):
        self.dev, self.N, self.B = dev, n, b
        self.model = load_robot(robot, torch.float32, dev)
        self.cp = CostParams(**{k: P[k] for k in (
            "q_cost", "qd_cost", "u_cost", "N_cost", "q_lim_cost",
            "vel_lim_cost", "ctrl_lim_cost")})
        self.settings = self.settings_with("auto", "auto")
        self.hp = HyperParams.create(b, rho=P["rho"], mu=P["mu"],
                                     pcg_tol=P["pcg_tol"], device=dev)
        self.traj = torch.tensor(figure8(DT, **FIG8_SHAPE[robot]).reshape(-1, 6),
                                 dtype=torch.float32, device=dev)
        # per-lane wrench hypotheses; lane 0 is the zero hypothesis and drives
        # the plant (bench.py:103-113)
        rng = np.random.default_rng(0)
        f_ext = rng.uniform(-5.0, 5.0, (b, 6)).astype(np.float32)
        f_ext[0] = 0.0
        self.f_ext = torch.tensor(f_ext, device=dev)

    def settings_with(self, solve_kernel, iter_kernel):
        return BSQPSettings(N=self.N, max_sqp_iters=P["max_sqp_iters"],
                            max_pcg_iters=P["max_pcg_iters"],
                            solve_ratio=P["solve_ratio"],
                            solve_kernel=solve_kernel, iter_kernel=iter_kernel)

    def ref(self, i):
        T = self.traj.shape[0]
        j = i % (T - self.N)
        return self.traj[j:j + self.N][None].expand(self.B, self.N, 6).contiguous()

    def solver(self, settings):
        def solve(X, U, lam, x_s, ref):
            Xo, Uo, lamo, _, st = solve_batched(self.model, settings, self.cp,
                                                self.hp, X, U, lam, x_s, ref,
                                                self.f_ext, DT)
            return Xo, Uo, lamo, st.pcg_iters[0], st.ls_step_size[0]
        return solve

    def solve_kernel(self, X, U, lam, x_s, ref):
        return self.solver(self.settings)(X, U, lam, x_s, ref)

    def solve_plain(self, X, U, lam, x_s, ref):
        o = sqp_solve_chained(sqp_iter_reference, self.model, self.cp,
                              self.settings, X, U, lam, x_s, ref, self.f_ext,
                              self.hp.rho, self.hp.drho, self.hp.mu,
                              self.hp.pcg_tol, DT)
        return o[0], o[1], o[2], o[9][0], o[11][0]

    def plant_kernel(self, x, u, substeps):
        return rk4_step(self.model, x, u, DT, substeps=substeps)

    def plant_plain(self, x, u, substeps):
        return rk4_plain(self.model, x[None], u[None], DT, None, substeps)[0]

    def cycle(self, state, i, solve, plant):
        X, U, lam, x_s = state
        Xo, Uo, lamo, pcg, step = solve(X, U, lam, x_s, self.ref(i))
        xs1 = plant(x_s[0], Uo[0, 0], 2)
        x_s = xs1[None].expand(self.B, xs1.shape[0]).contiguous()
        Xo[:, 0] = x_s
        return (Xo, Uo, lamo, x_s), pcg, step

    def steady_state(self, warmup=WARMUP):
        """bench.py:54-130: `warmup` (6) cycles from the plant's START with a
        10-substep RK4 plant, on the default route."""
        nq, nx = self.model.nq, self.model.nx
        x0 = np.concatenate([START[self.model.name], np.zeros(nq)])
        x0 = torch.tensor(x0, dtype=torch.float32, device=self.dev)
        X = x0.expand(self.B, self.N, nx).contiguous()
        U = torch.zeros(self.B, self.N - 1, nq, device=self.dev)
        lam = torch.zeros(self.B, self.N, nx, device=self.dev)
        x_s = x0.expand(self.B, nx).contiguous()
        for step in range(warmup):
            X, U, lam, _, _ = self.solve_kernel(X, U, lam, x_s, self.ref(step))
            x_s = self.plant_kernel(x_s[0], U[0, 0], 10)[None].expand(
                self.B, nx).contiguous()
            X[:, 0] = x_s
        return (X, U, lam, x_s), warmup  # bench.py: cycles start at step + 1

    def run(self, state, i0, solve, plant, k=K):
        """k closed-loop cycles; per-cycle CUDA-event ms, lane 0's EE
        tracking error against the reference knot it should reach next
        (api/mpc.py's goal distance), and the per-cycle work trace."""
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(k)]
        xs_hist, pcgs, steps = [], [], []
        for c in range(k):
            ev[c][0].record()
            xs_hist.append(state[3][0].clone())
            state, pcg, step = self.cycle(state, i0 + c, solve, plant)
            pcgs.append(pcg)
            steps.append(step)
            ev[c][1].record()
        torch.cuda.synchronize()
        ms_cycle = [a.elapsed_time(b) for a, b in ev]
        cd = _get_cd(self.model.key)
        nq = self.model.nq
        q = torch.stack(xs_hist)[:, :nq]
        p_ee = cd.fk_ee([ms.cos(q[:, i]) for i in range(nq)],
                        [ms.sin(q[:, i]) for i in range(nq)])[0]
        p_ee = torch.stack(p_ee, 1)
        goal = torch.stack([self.ref(i0 + c)[0, 1, :3] for c in range(k)])
        err = (p_ee - goal).norm(dim=1)
        return (state, ms_cycle, err,
                torch.stack(pcgs).cpu().numpy(), torch.stack(steps).cpu().numpy())


def work_trace(pcg, step):
    """bench.py:227-243's 8-cycle work trace."""
    return dict(pcg_iters_lane0=pcg[:8, 0].astype(int).tolist(),
                step_lane0=[round(float(s), 4) for s in step[:8, 0]],
                pcg_iters_mean=round(float(pcg[:8].mean()), 2),
                pcg_iters_max=int(pcg[:8].max()),
                steps_accepted_frac=round(float((step[:8] > 0).mean()), 3))


def iteration_arms(f, state, i):
    """One SQP iteration on the identical steady-state input: (problem,
    state, the kernel's (out, stats), the float32 plain version's, the
    float64 plain version's)."""
    X, U, lam, x_s = state
    zero = torch.zeros(f.B, device=f.dev)
    prob = Problem(x_s, f.ref(i), f.f_ext, f.hp.mu, f.hp.pcg_tol, DT)
    s0 = IterState(X, U, lam, f.hp.rho, f.hp.drho, zero, zero, zero, zero)
    kernel = sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings, seeded=False)
    plain = sqp_iter_reference(f.model, f.cp, prob, s0, f.settings, seeded=False)
    m64 = load_robot(f.model.name, torch.float64, f.dev)
    p64 = Problem(*(t.double() for t in prob[:5]), DT)
    f64 = sqp_iter_reference(m64, f.cp, p64, IterState(*(t.double() for t in s0)),
                             f.settings, seeded=False)
    torch.cuda.synchronize()
    return prob, s0, kernel, plain, f64


def compare_iteration(f, state, i, noise_floor=False):
    """One SQP iteration, kernel (the variant that f.N takes) against its
    plain version (and both against the plain version in float64), on the
    identical steady-state input.

    The float64 rule is applied lane by lane, as compare_pcg applies it: on
    a lane where the kernel's step equals the float64 step, its X and merit
    distance from float64 at most F64_FACTOR times the float32 plain
    version's largest distance over the batch (floors TRAJ_RTOL and
    MERIT_RTOL), and on every lane its PCG count within F64_FACTOR times
    plain32's largest count difference (floor PCG_SLACK); it must hold on
    STEP_SAME_MIN of the lanes. A batch maximum fails by chance on one
    sensitive lane, and phase D's dot products sum in another order in the
    shared layout. The other limits are the fixed ones; with noise_floor
    (the long horizons) they give way to float32's own noise where that is
    larger (noise_limits)."""
    prob, s0, (ko, ks), (ro, rs), (o64, s64) = iteration_arms(f, state, i)
    for t in (ko.X, ko.U, ko.lam, ks.ls_merit):
        if not torch.isfinite(t).all():
            raise RuntimeError("bsqp_iter kernel output is not finite")

    pcg_diff = (ks.pcg_iters - rs.pcg_iters).abs()
    same_step = ks.ls_step == rs.ls_step
    same = same_step & (pcg_diff == 0)
    merit_rel = ((ks.ls_merit.double() - rs.ls_merit.double()).abs()
                 / rs.ls_merit.double().abs())[same_step]
    res = dict(
        step_same_frac=same_step.double().mean().item(),
        pcg_max_diff=int(pcg_diff.max()),
        pcg_within_frac=(pcg_diff <= PCG_SLACK).double().mean().item(),
        lanes_compared=int(same.sum()),
        X_rel=normwise(ko.X[same], ro.X[same]),
        U_rel=normwise(ko.U[same], ro.U[same]),
        merit_rel_p99=merit_rel.quantile(0.99).item(),
        merit_rel_max=merit_rel.max().item(),
        merit0_rel_max=((ko.merit0 - ro.merit0).abs() / ro.merit0.abs()).max().item(),
        X_max_abs_err=(ko.X[same_step] - ro.X[same_step]).abs().max().item(),
        kernel_pcg_sum=int(ks.pcg_iters.sum()),
    )
    # the float32 noise floor: each float32 arm against the float64 plain
    # version on the same input, lane by lane
    lanes = {}
    for tag, (oa, sa) in (("kernel", (ko, ks)), ("plain32", (ro, rs))):
        s = sa.ls_step.double() == s64.ls_step
        lanes[tag] = (s, lane_rel(oa.X, o64.X),
                      (sa.ls_merit.double() - s64.ls_merit).abs() / s64.ls_merit.abs(),
                      (sa.pcg_iters - s64.pcg_iters).abs())
        res[f"{tag}_f64_X_rel"] = lanes[tag][1][s].max().item()
        res[f"{tag}_f64_merit_rel_max"] = lanes[tag][2][s].max().item()
        res[f"{tag}_f64_pcg_max_diff"] = int(lanes[tag][3].max())
    ks_, kx, km, kc = lanes["kernel"]
    f64_ok = ((~ks_ | ((kx <= max(TRAJ_RTOL, F64_FACTOR * res["plain32_f64_X_rel"]))
                       & (km <= max(MERIT_RTOL, F64_FACTOR * res["plain32_f64_merit_rel_max"]))))
              & (kc <= max(PCG_SLACK, F64_FACTOR * res["plain32_f64_pcg_max_diff"])))
    res["f64_rule_frac"] = f64_ok.double().mean().item()
    lim = dict(steps=STEP_SAME_MIN, counts=STEP_SAME_MIN, X_rel=TRAJ_RTOL,
               U_rel=TRAJ_RTOL)
    if noise_floor:
        # plain32's own noise on the compared lanes where its step and count
        # match float64's
        quiet = (same & (rs.ls_step.double() == s64.ls_step)
                 & ((rs.pcg_iters - s64.pcg_iters).abs() <= PCG_SLACK))
        lim = noise_limits((rs.ls_step, s64.ls_step), (rs.pcg_iters, s64.pcg_iters),
                           dict(X_rel=(ro.X[quiet], o64.X[quiet]),
                                U_rel=(ro.U[quiet], o64.U[quiet])))
    res["limits"] = lim
    log(f"[compare] bsqp_iter kernel ({f.model.name}, {variant_name(f.N, f.model.nx)}) vs "
        f"sqp_iter_reference (float32, N={f.N} B={f.B}, identical steady-state input):")
    log(f"  identical ls_step on {res['step_same_frac']:.4f} of lanes "
        f"(tolerance >= {lim['steps']:.4f}{LIMIT_NOTE[noise_floor]})")
    log(f"  PCG counts within {PCG_SLACK} on {res['pcg_within_frac']:.4f} of "
        f"lanes (tolerance >= {lim['counts']:.4f}); largest difference "
        f"{res['pcg_max_diff']}")
    log(f"  {res['lanes_compared']} lanes with identical step and PCG count: X "
        f"normwise rel {res['X_rel']:.3e}, U {res['U_rel']:.3e} (tolerance "
        f"{lim['X_rel']:.3e} and {lim['U_rel']:.3e})")
    log(f"  lanes with identical step: merit rel p99 {res['merit_rel_p99']:.3e}, "
        f"max {res['merit_rel_max']:.3e} (reported: held against the float64 "
        f"version below); warm-start merit rel max {res['merit0_rel_max']:.3e} "
        f"(tolerance {MERIT0_RTOL})")
    log(f"  against the float64 plain version, lane by lane (the kernel's step "
        f"equal to float64's, its distances within {F64_FACTOR}x of plain32's "
        f"largest, floors {TRAJ_RTOL}, {MERIT_RTOL} and {PCG_SLACK}): holds on "
        f"{res['f64_rule_frac']:.4f} of lanes (tolerance >= {STEP_SAME_MIN}); "
        f"largest X rel kernel {res['kernel_f64_X_rel']:.3e} / plain32 "
        f"{res['plain32_f64_X_rel']:.3e}; merit rel kernel "
        f"{res['kernel_f64_merit_rel_max']:.3e} / plain32 "
        f"{res['plain32_f64_merit_rel_max']:.3e}; PCG count diff kernel "
        f"{res['kernel_f64_pcg_max_diff']} / plain32 {res['plain32_f64_pcg_max_diff']}")
    ok = (res["step_same_frac"] >= lim["steps"] and res["pcg_within_frac"] >= lim["counts"]
          and res["X_rel"] <= lim["X_rel"] and res["U_rel"] <= lim["U_rel"]
          and res["merit0_rel_max"] <= MERIT0_RTOL
          and res["f64_rule_frac"] >= STEP_SAME_MIN)
    if not ok:
        raise RuntimeError(f"bsqp_iter kernel disagrees with its plain version: {res}")
    return prob, s0, res


def hold_rk4(model, x, u, fe, dt, what=""):
    """rk4 in every variant (the default first) against rk4_plain on one
    input, RK4_SUBSTEPS substeps over dt, held at RK4_RTOL of the largest
    |x|; `what` describes the input. Returns {variant: max abs error}."""
    p = rk4_plain(model, x, u, dt, fe, RK4_SUBSTEPS)
    tol = RK4_RTOL * p.abs().max().item()
    wrench = "with" if fe is not None else "without"
    errs = {}
    for v in (cuda_sim.DEFAULT,) + tuple(v for v in cuda_sim.VARIANTS if v != cuda_sim.DEFAULT):
        k = rk4_step_batched(model, x, u, dt, fe, RK4_SUBSTEPS, variant=v)
        torch.cuda.synchronize()
        errs[v] = (k - p).abs().max().item()
        log(f"[compare] rk4 kernel ({model.name}, {v}"
            f"{', the default' if v == cuda_sim.DEFAULT else ''}) vs rk4_channels {wrench} a "
            f"wrench (B={x.shape[0]}, {RK4_SUBSTEPS} substeps of {dt / RK4_SUBSTEPS:g} s{what}): "
            f"max abs err {errs[v]:.3e}, tolerance {tol:.3e} (rtol {RK4_RTOL} of max |x|)")
        if not (torch.isfinite(k).all() and errs[v] <= tol):
            raise RuntimeError(f"rk4 kernel ({model.name}, {v}) disagrees with its plain "
                               f"version at B={x.shape[0]} {wrench} a wrench")
    return errs


def compare_rk4(f, state):
    """The plant step at the main path's shape (B = 1, 2 substeps), in
    every variant of the kernel (the default first), then with a wrench
    and at B = 512 (hold_rk4). Returns (x, u, the default's max abs
    error at the main path's shape)."""
    x, u = state[3][:1].contiguous(), state[1][:1, 0].contiguous()
    err = hold_rk4(f.model, x, u, None, DT, ", the main path input")[cuda_sim.DEFAULT]
    # the wrench branch (f_ext, the EE-frame wrench the estimator rollout
    # steps its plant under): B = 1 with the rollout's world wrench in the EE
    # frame at this state, B = 512 with per-lane wrenches as f.f_ext's; and
    # B = 512 without one
    g = torch.Generator().manual_seed(5)
    nq, nx = f.model.nq, f.model.nx
    fe1 = world_wrench_to_ee_frame(f.model, x[0, :nq], torch.tensor(
        EST_WRENCH, device=f.dev))[None].contiguous()
    xw = (torch.rand(B, nx, generator=g).to(f.dev) * 2 - 1)
    uw = (torch.rand(B, nq, generator=g).to(f.dev) * 10 - 5)
    few = (torch.rand(B, 6, generator=g).to(f.dev) * 10 - 5)
    for xb, ub, fb, what in (
            (x, u, fe1, f", EE-frame f_ext: the estimator rollout world wrench "
                        f"{list(EST_WRENCH)} N at the state"),
            (xw, uw, few, ", EE-frame f_ext: uniform in +-5 per lane"), (xw, uw, None, "")):
        hold_rk4(f.model, xb, ub, fb, DT, what)
    # crba runs fd's own expressions, split over two warps: against the
    # one-thread kernel it differs only where ptxas fuses a multiply-add in
    # one kernel and not in the other, which depends on the code around it
    # (PERF.md section 6; reported)
    g = torch.Generator().manual_seed(3)
    for b, (xb, ub) in ((1, (x, u)), (B, (torch.rand(B, nx, generator=g).to(f.dev) * 2 - 1,
                                          torch.rand(B, nq, generator=g).to(f.dev) * 10 - 5))):
        outs = [rk4_step_batched(f.model, xb, ub, DT, None, RK4_SUBSTEPS, variant=v)
                for v in ("crba", "one")]
        torch.cuda.synchronize()
        log(f"[compare] rk4 crba against one ({f.model.name}, B={b}"
            f"{', the main path input' if b == 1 else ''}): "
            f"equal bit for bit {torch.equal(*outs)}, max abs difference "
            f"{(outs[0] - outs[1]).abs().max().item():.3e} (reported)")
    return x, u, err


def noise_limits(steps, counts, traj):
    """The limits of compare_iteration and compare_core at the long
    horizons (CHECK_HORIZONS), where float32 rounding alone moves the plain
    version further from the float64 one than the fixed limits allow, for
    the global layout as for the shared one (PERF.md section 6 has
    the readings). Each is the fixed limit, or what the float32 plain
    version shows against float64 on the same input where that is looser,
    bounded:
      steps   (plain32, float64) per lane, or None: the kernel's steps equal
              plain32's on STEP_SAME_MIN of the lanes, or on the share of
              lanes where plain32's equal float64's if that is smaller, and
              on at least SHARE_FLOOR;
      counts  (plain32, float64) per lane: the kernel's counts within
              PCG_SLACK of plain32's on STEP_SAME_MIN of the lanes, or on
              the share where plain32's are within PCG_SLACK of float64's if
              smaller, at least SHARE_FLOOR;
      traj    {name: (plain32, float64) on the compared lanes where
              plain32's step and count agree with float64's}: normwise
              TRAJ_RTOL, or twice plain32's distance from float64 there if
              larger (two float32 results that far from float64 may lie
              twice as far apart), at most NOISE_CAP."""
    def share(p32, p64, slack=0):
        return max(SHARE_FLOOR, min(STEP_SAME_MIN, (
            (p32.double() - p64.double()).abs() <= slack).double().mean().item()))

    out = dict(counts=share(*counts, PCG_SLACK))
    if steps is not None:
        out["steps"] = share(*steps)
    for name, (p32, p64) in traj.items():
        noise = normwise(p32, p64) if p32.numel() else 0.0
        out[name] = min(NOISE_CAP, max(TRAJ_RTOL, 2 * noise))
    return out


def compare_core(f, state, i, noise_floor=False):
    """The iter kernel (the variant that f.N takes) against
    sqp_iter_core_reference (float32) and both against the plain version in
    float64, on the identical steady-state input, in compare_iteration's
    style and limits (the float64 rule lane by lane: dZX and the PCG
    count). With noise_floor (the long horizons) a lane may be non-finite
    in the kernel where a float32 PCG, the kernel's or the plain
    version's, ran to max_pcg_iters without converging (the PCG count rule
    bounds how many lanes' counts differ): the core does not scrub (its
    caller does), and float32 PCG diverges on some lanes there."""
    X, U, lam, x_s = state
    skip = torch.zeros(f.B, dtype=torch.bool, device=f.dev)
    args = (X, U, x_s, f.ref(i), f.f_ext, lam, f.hp.rho, f.hp.pcg_tol)
    mpcg = P["max_pcg_iters"]
    ko = sqp_iter_core_cuda(f.model, f.cp, *args, skip, DT, mpcg)
    ro = sqp_iter_core_reference(f.model, f.cp, *args, skip, DT, mpcg)
    m64 = load_robot(f.model.name, torch.float64, f.dev)
    o64 = sqp_iter_core_reference(m64, f.cp, *(t.double() for t in args), skip,
                                  DT, mpcg)
    torch.cuda.synchronize()

    def diverged(o):
        return ~(torch.isfinite(o[0]).all((1, 2)) & torch.isfinite(o[1]).all((1, 2))
                 & torch.isfinite(o[2]).all((1, 2)))

    kd, pd, d64 = diverged(ko), diverged(ro), diverged(o64)
    stalled = pd | d64 | (ro[3] >= mpcg) | (ko[3] >= mpcg)
    if (kd & ~stalled if noise_floor else kd | pd | d64).any():
        raise RuntimeError(f"iter kernel output is not finite on lanes "
                           f"{torch.nonzero(kd).flatten().tolist()} (plain32 "
                           f"{torch.nonzero(pd).flatten().tolist()}, stalled "
                           f"{torch.nonzero(stalled).flatten().tolist()})")
    fin = ~(kd | pd | d64)
    diff = (ko[3] - ro[3]).abs()
    same = (diff == 0) & fin
    if noise_floor and iteration_variant(f.N, f.model.nx) != ("global", 1):
        # the same input through the global layout: the shared layout's
        # non-finite lanes against the global one's (reported)
        kg = sqp_iter_core_cuda(f.model, f.cp, *args, skip, DT, mpcg, variant=("global", 1))
        torch.cuda.synchronize()
        same_as_global = bool(torch.equal(diverged(kg), kd))
    else:
        same_as_global = None
    res = dict(diverged_lanes=[int(kd.sum()), int(pd.sum()), int(d64.sum())],
               stalled_lanes=int(stalled.sum()), diverged_as_global=same_as_global,
               pcg_within_frac=(diff <= PCG_SLACK).double().mean().item(),
               pcg_max_diff=int(diff.max()), lanes_compared=int(same.sum()),
               dZX_rel=normwise(ko[0][same], ro[0][same]),
               dZU_rel=normwise(ko[1][same], ro[1][same]),
               lam_rel=normwise(ko[2][same], ro[2][same]),
               dZX_max_abs_err=(ko[0][same] - ro[0][same]).abs().max().item(),
               kernel_pcg_sum=int(ko[3].sum()))
    lanes = {}
    for tag, o in (("kernel", ko), ("plain32", ro)):
        lanes[tag] = (lane_rel(o[0], o64[0]), (o[3] - o64[3]).abs())
        res[f"{tag}_f64_dZX_rel"] = lanes[tag][0][fin].max().item()
        res[f"{tag}_f64_pcg_max_diff"] = int(lanes[tag][1].max())
    kx, kc = lanes["kernel"]
    f64_ok = (~fin | ((kx <= max(TRAJ_RTOL, F64_FACTOR * res["plain32_f64_dZX_rel"]))
                      & (kc <= max(PCG_SLACK, F64_FACTOR * res["plain32_f64_pcg_max_diff"]))))
    res["f64_rule_frac"] = f64_ok.double().mean().item()
    names = ("dZX_rel", "dZU_rel", "lam_rel")
    lim = dict(counts=STEP_SAME_MIN, **{n: TRAJ_RTOL for n in names})
    if noise_floor:
        quiet = same & ((ro[3] - o64[3]).abs() <= PCG_SLACK)
        lim = noise_limits(None, (ro[3], o64[3]),
                           {n: (ro[j][quiet], o64[j][quiet]) for j, n in enumerate(names)})
    res["limits"] = lim
    log(f"[compare] iter kernel ({f.model.name}, {variant_name(f.N, f.model.nx)}) vs "
        f"sqp_iter_core_reference "
        f"(float32, N={f.N} B={f.B}, identical steady-state input):")
    log(f"  PCG counts within {PCG_SLACK} on {res['pcg_within_frac']:.4f} of "
        f"lanes (tolerance >= {lim['counts']:.4f}{LIMIT_NOTE[noise_floor]}); "
        f"largest difference {res['pcg_max_diff']}")
    log(f"  lanes whose output is not finite (kernel / plain32 / float64, not "
        f"compared): {res['diverged_lanes']}; a float32 PCG not finite or at the "
        f"cap of {mpcg} on {res['stalled_lanes']}; the kernel's are the global "
        f"layout's on this input: {res['diverged_as_global']} (reported)")
    log(f"  {res['lanes_compared']} lanes with identical PCG count: dZX "
        f"normwise rel {res['dZX_rel']:.3e}, dZU {res['dZU_rel']:.3e}, lam "
        f"{res['lam_rel']:.3e} (tolerance {lim['dZX_rel']:.3e}, "
        f"{lim['dZU_rel']:.3e}, {lim['lam_rel']:.3e})")
    log(f"  against the float64 plain version, lane by lane (the kernel within "
        f"{F64_FACTOR}x of plain32's largest distance, floors {TRAJ_RTOL} and "
        f"{PCG_SLACK}): holds on {res['f64_rule_frac']:.4f} of lanes (tolerance "
        f">= {STEP_SAME_MIN}); largest dZX rel kernel "
        f"{res['kernel_f64_dZX_rel']:.3e} / plain32 {res['plain32_f64_dZX_rel']:.3e}; "
        f"PCG count diff kernel {res['kernel_f64_pcg_max_diff']} / plain32 "
        f"{res['plain32_f64_pcg_max_diff']}")
    ok = (res["pcg_within_frac"] >= lim["counts"]
          and all(res[n] <= lim[n] for n in names)
          and res["f64_rule_frac"] >= STEP_SAME_MIN)
    if not ok:
        raise RuntimeError(f"iter kernel disagrees with its plain version: {res}")
    return args, skip, ro, res


KKT_FIELDS = ("Q", "q", "R", "r", "A", "B", "c")


def compare_kkt(f, X, U, x_s, ref):
    """The kkt kernel of f's plant against setup_kkt_batched on the
    identical input: the plant's default variant first, then every other it
    compiles; and the default's largest difference from the one-thread
    variant (the same SSA expressions, so only FMA contraction may differ:
    reported, not held) where they differ."""
    plant = f.model.name
    default, variants = cuda_kkt.DEFAULT[plant], cuda_kkt.VARIANTS[plant]
    p = setup_kkt_batched(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT)
    outs, worst = {}, {}
    for v in [default] + [v for v in variants if v != default]:
        k = outs[v] = setup_kkt_batched_cuda(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT,
                                             variant=v)
        torch.cuda.synchronize()
        errs = {}
        for name in KKT_FIELDS:
            a, b = getattr(k, name), getattr(p, name)
            if not torch.isfinite(a).all():
                raise RuntimeError(f"kkt kernel ({v}) output {name} is not finite")
            errs[name] = ((a - b).abs().max().item(), KKT_RTOL * b.abs().max().item())
        worst[v] = max(e for e, _ in errs.values())
        log(f"[compare] kkt kernel {plant} ({v[0]}, G={v[1]}"
            f"{', the default' if v == default else ''}) vs setup_kkt_batched "
            f"(N={f.N}, B={f.B}): max abs err / tolerance (rtol {KKT_RTOL} of each "
            "tensor's max |value|): " + ", ".join(
                f"{n} {e:.3e}/{t:.3e}" for n, (e, t) in errs.items()))
        if any(e > t for e, t in errs.values()):
            raise RuntimeError(f"kkt kernel ({v}) disagrees with its plain version: {errs}")
    if default != cuda_kkt.ONE:
        new, old = outs[default], outs[cuda_kkt.ONE]
        diff = {n: (getattr(new, n) - getattr(old, n)).abs().max().item() for n in KKT_FIELDS}
        log(f"[compare] kkt {plant} {default} against the one-thread variant (N={f.N}, "
            f"B={f.B}), max abs difference (reported): "
            + ", ".join(f"{n} {d:.3e}" for n, d in diff.items()))
    return p, worst[default]


def report_kkt_variants(sms, robot):
    """A [variant] kkt line for each variant of `robot`'s library:
    registers and spills (ptxas), shared bytes a CTA, threads, CTAs per SM.
    indy7's default (the staged kernel) must not spill; iiwa14's (the
    one-thread kernel, its header has no staged KKT) does, reported."""
    px = ptxas_kkt(robot)
    default = cuda_kkt.DEFAULT[robot]
    for v in cuda_kkt.VARIANTS[robot]:
        nbytes, per_sm = kkt_resources(v, robot)
        log(f"[variant] kkt {robot} {v[0]} G={v[1]}{' (the default)' if v == default else ''}: "
            f"{nbytes} bytes of shared memory a CTA, {32 * v[1] if v[0] == 'staged' else 128} "
            f"threads a CTA, {per_sm} CTAs per SM on {sms} SMs; ptxas: {px[v]}; spill stores "
            f"{spill_bytes(px[v])} B a thread")
    if default != cuda_kkt.ONE and spill_bytes(px[default]) != 0:
        raise RuntimeError(f"the kkt kernel {default} spills: {px[default]}")


def time_kkt(f, X, U, x_s, ref, card, reps):
    """Device ms per launch of kkt in every variant of f's plant on one
    input (time_in_rounds: two rounds in opposite orders, and ms per
    wrapper call, where the host's time to enqueue a call shows); the
    fastest beside the default. Returns {variant: device ms}."""
    plant = f.model.name
    default = cuda_kkt.DEFAULT[plant]
    ms = {v: t[0] for v, t in time_in_rounds(
        cuda_kkt.VARIANTS[plant],
        lambda v: setup_kkt_batched_cuda(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT, variant=v),
        reps, card, f"kkt {plant} N={f.N} B={f.B}", default).items()}
    fastest = min(ms, key=ms.get)
    log(f"[kkt] {plant} N={f.N} B={f.B}: fastest {fastest} {ms[fastest]:.4f} ms; the default "
        f"{default} {ms[default]:.4f} ms, the one-thread kernel "
        f"{ms[cuda_kkt.ONE]:.4f} ms ({ms[cuda_kkt.ONE] / ms[default]:.2f}x)")
    return ms


def lane_rel(a, b):
    """Per-lane normwise distance of a from b, (B,)."""
    d = (a.double() - b.double()).flatten(1).abs().max(1).values
    return d / b.double().flatten(1).abs().max(1).values


def pcg_variants(n, nx):
    """Every variant (layout, G, C) of the pcg kernel that fits horizon n
    for a system of state size nx: the global one, the shared one at each
    G compiled for nx, the cluster one at each G and C."""
    groups = PCG_GROUPS[nx]
    return ([("global", 1, 1)]
            + [("shared", g, 1) for g in groups if pcg_fits(n, "shared", g, 1, nx=nx)]
            + [("cluster", g, c) for c in CLUSTER_SIZES for g in groups
               if pcg_fits(n, "cluster", g, c, nx=nx)])


def ptxas_pcg(robot):
    """{(layout, G or the global kernel's thread bound): ptxas' register
    and spill lines} of the pcg kernel's compiled variants for `robot`."""
    return ptxas_lines(
        "pcg", r"pcg_smem_kernelILi(\d+)ELb([01])E|pcg_kernelILi(\d+)E",
        lambda m: ((("shared", "cluster")[int(m.group(2))], int(m.group(1))) if m.group(1)
                   else ("global", int(m.group(3)))), robot)


def report_pcg_variants(n, b, sms, nx):
    """A [variant] line for each pcg variant that fits horizon n at batch
    b for a system of state size nx: shared bytes per CTA, C, CTAs per SM,
    clusters resident (cudaOccupancyMaxActiveClusters), the waves that the
    batch takes, the ptxas line."""
    robot = cuda_pcg.PLANT_OF_NX[nx]
    px = ptxas_pcg(robot)
    for v in pcg_variants(n, nx):
        nbytes, per_sm, clusters = pcg_resources(n, b, *v, nx=nx)
        if v[0] == "global":
            key = ("global", next(t for t in (128, 256, 512, 1024) if n <= t))
            waves = -(-b // (per_sm * sms))
        else:
            key = v[:2]
            waves = -(-b // (clusters if v[0] == "cluster" else per_sm * sms))
        taken = " (the variant N takes)" if pcg_variant(n, nx) == v else ""
        log(f"[variant] pcg{'' if nx == 12 else ' ' + robot} N={n} B={b} {v[0]} G={v[1]} "
            f"C={v[2]}{taken}: {nbytes} bytes "
            f"of shared memory a CTA, {per_sm} CTAs per SM, "
            f"{'clusters resident ' + str(clusters) if clusters >= 0 else 'no cluster'}, "
            f"{waves} wave(s) of the batch on {sms} SMs; ptxas: {px[key]}")


def check_pcg_smem_mirror():
    """The library's shared-memory byte count of every pcg variant against
    its Python mirror (ops/cuda_pcg.py::smem_bytes) at every N the kernel
    takes, for each plant's library."""
    for nx, robot in cuda_pcg.PLANT_OF_NX.items():
        bad = [(m, v) for m in range(1, 1025) for v in pcg_variants(m, nx)
               if pcg_library_bytes(m, *v, nx=nx) != pcg_smem_bytes(m, *v, nx=nx)]
        if bad:
            raise RuntimeError(f"pcg smem_bytes ({robot}) differs from the library at {bad[:4]}")
    log("[variant] pcg bytes of shared memory equal ops/cuda_pcg.py::smem_bytes "
        f"for every variant at N = 1..1024, for {', '.join(cuda_pcg.PLANT_OF_NX.values())}")


def compare_pcg(f, kkt, lam0, lam_held=True):
    """The pcg kernel against pcg_solve_batched on the identical assembled
    system (plain build_schur of the plain KKT), and both float32 arms
    against the float64 plain version on that system: the variant that
    f.N takes first, then every other variant that fits, each held to the
    same limits.

    Where float32 rounding alone moves lam by more than LAM_RTOL (the
    float32 plain version's own distance from the float64 one: about 1e-2
    at N=256), the limit on the kernel is that noise floor (the lane
    farthest from the plain version prints with its count and both
    lane-normalised distances). The float64 rule of compare_iteration (the
    kernel at most F64_FACTOR times as far off as the float32 plain
    version) is applied lane by lane against the plain version's largest
    distance over the batch, and must hold on PCG_SAME_MIN of the lanes: a
    lane where float32 PCG at tol 1e-4 stops many iterations away from
    float64 is a chance of rounding for either float32 arm.

    With lam_held=False the lam limit's verdict is printed and not held
    (the counts and the float64 rule still are): the long horizon's
    steady state, see main()."""
    nx = f.model.nx
    sch = build_schur(kkt, f.hp.rho, f.model.nq)
    system = (sch.S_main, sch.S_lower, sch.P_main, sch.P_lower, sch.gamma, lam0,
              f.hp.pcg_tol)
    skip = torch.zeros(f.B, dtype=torch.bool, device=f.dev)
    mpcg = P["max_pcg_iters"]
    lp, ip = pcg_solve_batched(*system, mpcg, skip)
    l64, i64 = pcg_solve_batched(*(t.double() for t in system), mpcg, skip)
    p_rel, p_cnt = lane_rel(lp, l64), (ip - i64).abs()
    taken = pcg_variant(f.N, nx)
    results = {}
    for v in [taken] + [v for v in pcg_variants(f.N, nx) if v != taken]:
        lk, ik = pcg_solve_batched_cuda(*system, mpcg, skip, variant=v)
        torch.cuda.synchronize()
        if not torch.isfinite(lk).all():
            raise RuntimeError(f"pcg kernel output is not finite ({v})")
        same = ik == ip
        k_rel, k_cnt = lane_rel(lk, l64), (ik - i64).abs()
        kp_rel = lane_rel(lk, lp)
        worst = int(kp_rel.argmax())
        f64_ok = ((k_rel <= max(LAM_RTOL, F64_FACTOR * p_rel.max().item()))
                  & (k_cnt <= max(PCG_SLACK, F64_FACTOR * p_cnt.max().item())))
        res = dict(same_frac=same.double().mean().item(),
                   worst_lane=(worst, int(ik[worst]), kp_rel[worst].item(),
                               p_rel[worst].item()),
                   max_diff=int((ik - ip).abs().max()),
                   lam_rel=normwise(lk[same], lp[same]),
                   lam_limit=max(LAM_RTOL, normwise(lp[same], l64[same])),
                   lam_max_abs_err=(lk[same] - lp[same]).abs().max().item(),
                   f64_rule_frac=f64_ok.double().mean().item(),
                   kernel_f64_lam_rel_max=k_rel.max().item(),
                   plain32_f64_lam_rel_max=p_rel.max().item(),
                   kernel_f64_max_diff=int(k_cnt.max()),
                   plain32_f64_max_diff=int(p_cnt.max()),
                   iters_sum=int(ik.sum()), iters_max=int(ik.max()),
                   iters_mean=ik.double().mean().item(),
                   at_cap_frac=(ik == mpcg).double().mean().item())
        log(f"[compare] pcg kernel {f.model.name} ({v[0]}, G={v[1]}, C={v[2]}"
            f"{', the variant N takes' if v == taken else ''}) vs pcg_solve_batched "
            f"(N={f.N}, B={f.B}, identical "
            f"assembled system): identical counts on {res['same_frac']:.4f} of lanes "
            f"(tolerance >= {PCG_SAME_MIN}), largest difference {res['max_diff']}; "
            f"lam normwise rel where counts agree {res['lam_rel']:.3e} (tolerance "
            f"{res['lam_limit']:.3e}: {LAM_RTOL}, or plain32's own distance from "
            f"float64 where larger{'' if lam_held else '; reported, not held'}); the lane "
            f"farthest from plain32, lane-normalised "
            f"(lane, count, kernel to plain32, plain32 to float64): {res['worst_lane']}; "
            f"against the float64 plain version, lane by "
            f"lane (the kernel within {F64_FACTOR}x of plain32's largest distance, "
            f"floors {LAM_RTOL} and {PCG_SLACK}): holds on "
            f"{res['f64_rule_frac']:.4f} of lanes (tolerance "
            f">= {PCG_SAME_MIN}); largest lam rel kernel "
            f"{res['kernel_f64_lam_rel_max']:.3e} / plain32 "
            f"{res['plain32_f64_lam_rel_max']:.3e}, largest count diff kernel "
            f"{res['kernel_f64_max_diff']} / plain32 {res['plain32_f64_max_diff']}; "
            f"iterations sum {res['iters_sum']}, mean {res['iters_mean']:.2f}, max "
            f"{res['iters_max']}, at the cap {res['at_cap_frac']:.4f}")
        ok = (res["same_frac"] >= PCG_SAME_MIN and res["f64_rule_frac"] >= PCG_SAME_MIN
              and (res["lam_rel"] <= res["lam_limit"] or not lam_held))
        if not ok:
            raise RuntimeError(f"pcg kernel ({v}) disagrees with its plain version: {res}")
        results[v] = res
    return system, skip, results[taken]


def time_pcg(n, b, system, skip, card, reps):
    """ms per launch of pcg in every variant that fits horizon n, on one
    system: two rounds in opposite orders, their mean (CUDA events); the
    fastest beside the variant that n takes."""
    mpcg = P["max_pcg_iters"]
    nx = system[4].shape[-1]
    variants = pcg_variants(n, nx)
    rounds = {v: [] for v in variants}
    for order in (variants, variants[::-1]):
        for v in order:
            rounds[v].append(event_ms(
                lambda: pcg_solve_batched_cuda(*system, mpcg, skip, variant=v), reps))
    ms = {v: statistics.mean(t) for v, t in rounds.items()}
    taken, fastest = pcg_variant(n, nx), min(ms, key=ms.get)
    plant = "" if nx == 12 else f" {cuda_pcg.PLANT_OF_NX[nx]}"
    for v in variants:
        log(f"[pcg] {card}:{plant} N={n} B={b} {v[0]} G={v[1]} C={v[2]}"
            f"{' (the variant N takes)' if v == taken else ''}: {ms[v]:.4f} ms per "
            f"launch; rounds {[round(t, 4) for t in rounds[v]]}")
    log(f"[pcg]{plant} N={n} B={b}: fastest {fastest} {ms[fastest]:.4f} ms; the variant N "
        f"takes {taken} {ms[taken]:.4f} ms ({ms[taken] / ms[fastest] - 1:+.2%}; within "
        f"3 %: {ms[taken] <= 1.03 * ms[fastest]})")
    return ms


def pcg_same_bits_as_global(system, skip):
    """At N <= 32 (one warp) the shared variant at G=1 sums every matvec row
    and every dot product in the global variant's order, so its lam and
    counts must equal the global variant's bit for bit."""
    mpcg = P["max_pcg_iters"]
    a, b = (pcg_solve_batched_cuda(*system, mpcg, skip, variant=v)
            for v in (("global", 1, 1), ("shared", 1, 1)))
    torch.cuda.synchronize()
    same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    log(f"[pcg] the shared variant at G=1 equals the global variant bit for bit: {same}")
    if not same:
        raise RuntimeError("pcg: the shared variant at G=1 differs from the global one")


def compare_merit(f, X, U, dzx, dzu, x_s, ref):
    """The merit kernel, every variant (the default first), against
    merit_alphas_batched at alpha in {0, 2^-j}. Returns (the arguments, the
    default's max abs error)."""
    alphas = [0.0] + [0.5 ** j for j in range(8)]
    args = (X, U, dzx, dzu, x_s, ref, f.f_ext, f.hp.mu, DT, alphas)
    mp = merit_alphas_batched(f.model, f.cp, *args)
    errs = {}
    for v in (MERIT_DEFAULT,) + tuple(v for v in cuda_merit.VARIANTS if v != MERIT_DEFAULT):
        mk = merit_alphas_batched_cuda(f.model, f.cp, *args, variant=v)
        torch.cuda.synchronize()
        rel = ((mk.double() - mp.double()).abs() / mp.double().abs()).max().item()
        errs[v] = (mk - mp).abs().max().item()
        log(f"[compare] merit kernel ({f.model.name}, {v}"
            f"{', the default' if v == MERIT_DEFAULT else ''}) vs merit_alphas_batched "
            f"(N={f.N}, B={f.B}, {len(alphas)} alphas): max rel err {rel:.3e} (tolerance "
            f"{MERIT_ALPHA_RTOL}), max abs err {errs[v]:.3e}")
        if not (torch.isfinite(mk).all() and rel <= MERIT_ALPHA_RTOL):
            raise RuntimeError(f"merit kernel ({v}) disagrees with its plain version")
    outs = [merit_alphas_batched_cuda(f.model, f.cp, *args, variant=v)
            for v in cuda_merit.VARIANTS]
    log(f"[compare] merit {' against '.join(cuda_merit.VARIANTS)} ({f.model.name}, N={f.N}, "
        f"B={f.B}): equal "
        f"bit for bit {torch.equal(*outs)} (reported)")
    return args, errs[MERIT_DEFAULT]


def sass_counts(name):
    """{kernel function: SASS instructions} of csrc/<name>.cu's library, by
    cuobjdump (the instructions a thread runs, for straight-line kernels),
    or {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[fn] += 1
    return counts


# the rk4 kernels' mangled names, and the variant of a match
RK4_PATTERN = r"rk4_(split|one)_kernel"


def rk4_variant_of(m):
    return dict(split="crba", one="one")[m.group(1)]


def report_rk4_merit_variants(sms):
    """A [variant] line for each rk4 and merit variant: threads a CTA, CTAs
    per SM and the waves of the main shapes (merit: N=32 B=512, 9 alphas),
    ptxas' registers and spills. No rk4 variant and not the merit default
    may spill."""
    px = ptxas_lines("rk4", RK4_PATTERN, rk4_variant_of)
    sass = {rk4_variant_of(re.search(RK4_PATTERN, fn)): n
            for fn, n in sass_counts("rk4").items() if re.search(RK4_PATTERN, fn)}
    for v in cuda_sim.VARIANTS:
        log(f"[variant] rk4 {v}{' (the default)' if v == cuda_sim.DEFAULT else ''}: "
            f"{128 if v == 'one' else 64} threads a CTA, "
            f"{'a thread a plant' if v == 'one' else 'one CTA a plant'}, "
            f"{sass.get(v, 'not counted')} SASS instructions; ptxas: {px[v]}")
    for v in cuda_sim.VARIANTS:
        if spill_bytes(px[v]) != 0:
            raise RuntimeError(f"the rk4 kernel {v} spills: {px[v]}")
    pm = ptxas_lines("merit", r"merit_(warps|one)_kernel", lambda m: m.group(1))
    sass = {re.search(r"merit_(warps|one)_kernel", fn).group(1): n
            for fn, n in sass_counts("merit").items() if re.search(r"merit_(warps|one)_kernel", fn)}
    pairs = B * (BSQPSettings(N=N).num_alphas + 1)
    for v in cuda_merit.VARIANTS:
        per_sm = cuda_merit.blocks_per_sm(v)
        warps = 1 if v == "one" else cuda_merit.WARPS_PER_CTA
        ctas = -(-pairs // warps)
        log(f"[variant] merit {v}{' (the default)' if v == MERIT_DEFAULT else ''}: "
            f"{32 * warps} threads a CTA at N={N}, {per_sm} CTAs per SM, {ctas} CTAs at "
            f"N={N} B={B}: {ctas / (per_sm * sms):.2f} rounds on {sms} SMs, "
            f"{sass.get(v, 'not counted')} SASS instructions (a thread runs them once a "
            f"knot); ptxas: {pm[v]}")
    if spill_bytes(pm[MERIT_DEFAULT]) != 0:
        raise RuntimeError(f"the merit kernel {MERIT_DEFAULT} spills: {pm[MERIT_DEFAULT]}")


def time_in_rounds(variants, call, reps, card, tag, default):
    """Device ms per launch (graph_ms) of each variant, two rounds in
    opposite orders, their mean; and ms per wrapper call back to back (CUDA
    events). Logs a line per variant; returns {variant: (device, wrapper)}."""
    rounds, wrapped = {v: [] for v in variants}, {v: [] for v in variants}
    for order in (variants, variants[::-1]):
        for v in order:
            rounds[v].append(graph_ms(lambda: call(v), reps))
            wrapped[v].append(event_ms(lambda: call(v), reps))
    ms = {v: (statistics.mean(rounds[v]), statistics.mean(wrapped[v])) for v in variants}
    for v in variants:
        log(f"[{tag}] {card}: {v}{' (the default)' if v == default else ''}: "
            f"{ms[v][0]:.5f} ms per launch on the device; rounds "
            f"{[round(t, 5) for t in rounds[v]]}; per wrapper call {ms[v][1]:.5f} ms")
    return ms


SCHUR_FIELDS = ("S_main", "S_lower", "P_main", "P_lower", "gamma")


def save_capped_schur(dev, path):
    """ROADMAP Queue 3's N=64 B=512 cap lanes: on compare_core's input at
    N_WIDE (the steady state, cycle i0 - 1), the Schur system that the card
    assembles in float32 (setup_kkt_batched and build_schur, as
    sqp_iter_core_reference assembles it), the float32 PCG counts on it
    (the plain version and the pcg kernel) and the float64 plain PCG's on
    the same float32 system; the first CAPPED_LANES lanes where the float32
    plain PCG reaches max_pcg_iters are written to `path` (np.savez_compressed:
    the system, lam0, the tolerance, the counts and each lane's KKT inputs),
    for tests/test_torch_pcg_capped.py to run the JAX package's pcg_channels
    on."""
    fc = Fig8(dev, N_WIDE, B)
    (X, U, lam, x_s), i0 = fc.steady_state()
    ref = fc.ref(i0 - 1)
    kkt = setup_kkt_batched(fc.model, fc.cp, X, U, x_s, ref, fc.f_ext, DT)
    sch = build_schur(kkt, fc.hp.rho, 6)
    system = (*(getattr(sch, n) for n in SCHUR_FIELDS), lam, fc.hp.pcg_tol)
    mpcg = P["max_pcg_iters"]
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    _, ip = pcg_solve_batched(*system, mpcg, skip)
    _, ik = pcg_solve_batched_cuda(*system, mpcg, skip)
    _, i64 = pcg_solve_batched(*(t.double() for t in system), mpcg, skip)
    core = sqp_iter_core_cuda(fc.model, fc.cp, X, U, x_s, ref, fc.f_ext, lam,
                              fc.hp.rho, fc.hp.pcg_tol, skip, DT, mpcg)
    torch.cuda.synchronize()
    finite = torch.stack([torch.isfinite(t).flatten(1).all(1) for t in system[:5]], 1)
    # the cost blocks Q + rho I whose float32 Cholesky fails on the card
    Qr = kkt.Q[..., :6, :6] + fc.hp.rho[:, None, None, None] * torch.eye(6, device=dev)
    failed = torch.nonzero(torch.linalg.cholesky_ex(Qr)[1]).tolist()
    core_finite = torch.isfinite(core[0]).flatten(1).all(1)
    capped = torch.nonzero(ip >= mpcg).flatten()
    lanes = capped[:CAPPED_LANES]
    log(f"[capped] N={N_WIDE} B={B}: float32 plain PCG at the cap of {mpcg} on "
        f"{capped.numel()} lanes, the pcg kernel on {int((ik >= mpcg).sum())}, float64 "
        f"PCG on the same float32 system on {int((i64 >= mpcg).sum())}; the iter "
        f"kernel's dZX not finite on {int((~core_finite).sum())} lanes; a Schur "
        f"block not finite on {int((~finite.all(1)).sum())} lanes; the float32 Cholesky "
        f"of Q + rho I fails at {len(failed)} (lane, knot), knots "
        f"{sorted({k for _, k in failed})}; lanes saved "
        f"{lanes.tolist()}: plain32 counts {ip[lanes].tolist()}, kernel "
        f"{ik[lanes].tolist()}, float64 {i64[lanes].tolist()}, iter kernel finite "
        f"{core_finite[lanes].tolist()}")
    if capped.numel() == 0:
        raise RuntimeError(f"no float32 PCG lane at the cap at N={N_WIDE}: nothing to save")
    sel = lambda t: t[lanes].cpu().numpy()
    np.savez_compressed(
        path, lanes=lanes.cpu().numpy(), max_pcg_iters=mpcg,
        **{n: sel(t) for n, t in zip(SCHUR_FIELDS + ("lam0", "pcg_tol"), system)},
        plain32_iters=sel(ip), kernel_iters=sel(ik), float64_iters=sel(i64),
        X=sel(X), U=sel(U), x_s=sel(x_s), ref=sel(ref), f_ext=sel(fc.f_ext),
        rho=sel(fc.hp.rho), card=card_line())
    log(f"[capped] wrote {path} ({os.path.getsize(path)} bytes)")


def f64_assembled_system(f, X, U, x_s, ref, lam0):
    """The Schur system assembled in float64 (setup_kkt_batched and
    build_schur on the float64 model) from a float32 state, rounded to
    float32 once: a system that no float32 assembly's rounding shaped."""
    m64 = load_robot(f.model.name, torch.float64, f.dev)
    kkt = setup_kkt_batched(m64, f.cp, X.double(), U.double(), x_s.double(),
                            ref.double(), f.f_ext.double(), DT)
    sch = build_schur(kkt, f.hp.rho.double(), f.model.nq)
    return (*(getattr(sch, n).float() for n in SCHUR_FIELDS), lam0, f.hp.pcg_tol)


def pcg_witness(f, system, tag, held):
    """ROADMAP Queue 3's N=256 witness: the pcg kernel (the variant N takes)
    against the float32 plain version on the card, beside a third float32
    arm that no kernel touches, the same plain version on the CPU (another
    summation order), and all three against the float64 plain version, on
    one assembled system. Held, with `held`: identical counts on
    PCG_SAME_MIN of the lanes; lam no farther (normwise) from the card's
    plain version than the CPU's plain version lies from it (at least
    LAM_RTOL); and no farther from float64 than the farther plain arm."""
    mpcg = P["max_pcg_iters"]
    skip = torch.zeros(f.B, dtype=torch.bool, device=f.dev)
    lk, ik = pcg_solve_batched_cuda(*system, mpcg, skip)
    lp, ip = pcg_solve_batched(*system, mpcg, skip)
    lc, ic = pcg_solve_batched(*(t.cpu() for t in system), mpcg, skip.cpu())
    lc, ic = lc.to(f.dev), ic.to(f.dev)
    l64, _ = pcg_solve_batched(*(t.double() for t in system), mpcg, skip)
    torch.cuda.synchronize()
    same, same_c = ik == ip, ic == ip
    res = dict(same_frac=same.double().mean().item(), cpu_same_frac=same_c.double().mean().item(),
               kernel_plain=normwise(lk[same], lp[same]), cpu_plain=normwise(lc[same_c], lp[same_c]),
               kernel_f64=normwise(lk, l64), plain_f64=normwise(lp, l64),
               cpu_f64=normwise(lc, l64))
    ok = (res["same_frac"] >= PCG_SAME_MIN
          and res["kernel_plain"] <= max(LAM_RTOL, res["cpu_plain"])
          and res["kernel_f64"] <= max(res["plain_f64"], res["cpu_f64"]))
    log(f"[witness] pcg at N={f.N} B={f.B}, {tag} ({pcg_variant(f.N, f.model.nx)}): "
        f"identical counts "
        f"with the card's plain32 on {res['same_frac']:.4f} of lanes (the CPU's plain32 "
        f"{res['cpu_same_frac']:.4f}; tolerance >= {PCG_SAME_MIN}); lam normwise from the card's "
        f"plain32: kernel {res['kernel_plain']:.3e}, the CPU's plain32 {res['cpu_plain']:.3e}; "
        f"from float64: kernel {res['kernel_f64']:.3e}, card plain32 {res['plain_f64']:.3e}, "
        f"CPU plain32 {res['cpu_f64']:.3e}; the kernel within the plain arms' spread: {ok}"
        f"{'' if held else ' (reported, not held)'}")
    if held and not ok:
        raise RuntimeError(f"pcg witness ({tag}) failed: {res}")
    return res


def tracks_like_plain(err_kernel, err_plain):
    """A kernel route's lane-0 tracking error within TRACK_REL of the plain
    route's, either way."""
    return abs(err_kernel - err_plain) <= TRACK_REL * err_plain


def windows(err):
    """Lane 0's per-cycle EE errors (K_GATE,) -> each window's mean."""
    return err.reshape(GATE_WINDOWS, -1).mean(1).tolist()


GATE_ROUTES = (("default route", ("auto", "auto")), ("fused-iteration route", ("off", "auto")),
               ("staged route", ("off", "off")))


def gate_windows(f, state, i0):
    """{route: window means} of lane 0's EE error over K_GATE cycles of each
    N=32 route from `state`, with the plant that cuda_sim.DEFAULT names."""
    return {name: windows(f.run(state, i0, f.solver(f.settings_with(*gates)),
                                f.plant_kernel, K_GATE)[2])
            for name, gates in GATE_ROUTES}


def gate(routes, plain):
    """The N=32 tracking gate on windows (lists of GATE_WINDOWS window
    means). Held: every window of every route below TRACK_MAX_M, and each
    kernel route's first window (the earlier single 50-cycle gate)
    within TRACK_REL of the plain route's. Read: each kernel route's mean
    over the windows within TRACK_REL of the plain route's, which does not
    measure (PERF.md section 6: over 200 cycles the plain route from a
    1-ulp-different warm-up fails it against itself from 2 of 4 starts).
    Returns (held, windowed rule, {route: (mean, relative difference)})."""
    ep = statistics.mean(plain)
    read = {name: (statistics.mean(w), (statistics.mean(w) - ep) / ep)
            for name, w in routes.items()}
    held = (max(plain) < TRACK_MAX_M
            and all(max(w) < TRACK_MAX_M and tracks_like_plain(w[0], plain[0])
                    for w in routes.values()))
    return held, all(tracks_like_plain(m, ep) for m, _ in read.values()), read


def gate_line(tag, routes, plain):
    held, windowed, read = gate(routes, plain)
    log(f"{tag}: lane 0's mean EE error in {GATE_WINDOWS} disjoint windows of "
        f"{K_GATE // GATE_WINDOWS} cycles: plain route {[round(e, 5) for e in plain]} m, "
        f"mean {statistics.mean(plain):.5f}; "
        + "; ".join(f"{name} {[round(e, 5) for e in routes[name]]} m, mean {m:.5f} "
                    f"({rel:+.1%}; first window {(routes[name][0] - plain[0]) / plain[0]:+.1%})"
                    for name, (m, rel) in read.items())
        + f". Held: every window < {TRACK_MAX_M} m and each first window within "
        f"{TRACK_REL:.0%} of the plain route's: {held}; read: each mean over the windows "
        f"within {TRACK_REL:.0%} of the plain route's: {windowed}")
    return held, windowed


def tracking_spread(dev, card, warmups=(5, 6, 7, 8), variants=cuda_sim.VARIANTS):
    """The N=32 tracking gate and bsqp_iter's step check on nearby inputs:
    for each warm-up length and each rk4 variant (the plant of the warm-up
    and of the kernel routes), lane 0's EE error over K_GATE cycles on each
    N=32 route (gate_windows) and on the plain route from the same state,
    read by the gate's rule (gate: GATE_WINDOWS disjoint windows), and the
    share of lanes with identical line-search steps, kernel against float32
    plain, kernel against float64, float32 plain against float64
    (compare_iteration's input at each state). Reported, nothing held;
    returns {(warm-up, variant): (held rule, windowed rule)}."""
    passed = {}
    for w in warmups:
        for v in variants:
            with forced(cuda_sim, "DEFAULT", v):
                f = Fig8(dev)
                state, i0 = f.steady_state(w)
                wk = gate_windows(f, state, i0)
            wp = windows(f.run(state, i0, f.solve_plain, f.plant_plain, K_GATE)[2])
            _, _, (_, ks), (_, rs), (_, s64) = iteration_arms(f, state, i0 - 1)
            same = [(a.double() == b.double()).double().mean().item()
                    for a, b in ((ks.ls_step, rs.ls_step), (ks.ls_step, s64.ls_step),
                                 (rs.ls_step, s64.ls_step))]
            passed[w, v] = gate_line(f"[spread] {card}: N={N} B={B}, warm-up {w}, rk4 {v}",
                                     wk, wp)
            log(f"[spread] warm-up {w}, rk4 {v}: identical steps kernel/plain32 "
                f"{same[0]:.4f}, kernel/float64 {same[1]:.4f}, plain32/float64 "
                f"{same[2]:.4f}")
    return passed


# the builds of csrc/rk4.cu that fusion_probe compares: the kernels' own
# flags, with ptxas' multiply-add fusion off, with every fusion off
FUSION_FLAGS = {"as built": (), "ptxas fusion off": ("-Xptxas", "-fmad=false"),
                "fusion off": ("-fmad=false",)}


def fusion_probe(card, n=65536):
    """Why rk4's crba and one differ: csrc/rk4.cu built with each of
    FUSION_FLAGS (one nvcc each, at once), both variants on the same n
    random plants (RK4_SUBSTEPS substeps of DT, without and with a wrench);
    the share of plants whose output differs in any bit, crba against one
    in the same build, and each build's one against the kernels' own.
    Reported, nothing held."""
    procs = {}
    for i, (tag, extra) in enumerate(FUSION_FLAGS.items()):
        out = os.path.join(_build.BUILD_DIR, f"librk4-fusion{i}-{os.getpid()}.so")
        procs[tag] = (subprocess.Popen(_build.nvcc_command("rk4", "indy7", out, extra),
                                       stdout=subprocess.DEVNULL,
                                       stderr=subprocess.STDOUT), out)
    libs = {}
    for tag, (proc, out) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for csrc/rk4.cu ({tag})")
        libs[tag] = ctypes.CDLL(out)
        os.remove(out)
    g = torch.Generator().manual_seed(0)
    q = (torch.rand(n, 6, generator=g) * 2 - 1) * torch.pi
    x = torch.cat([q, torch.randn(n, 6, generator=g) * 1.5], 1).cuda().contiguous()
    u = (torch.randn(n, 6, generator=g) * 30).cuda().contiguous()
    fe = (torch.randn(n, 6, generator=g) * 5).cuda().contiguous()

    def step(lib, variant, f):
        out = torch.empty_like(x)
        fn = lib.gato_rk4_indy7
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(x.data_ptr(), u.data_ptr(), None if f is None else f.data_ptr(),
                 out.data_ptr(), n, DT / RK4_SUBSTEPS, RK4_SUBSTEPS, cuda_sim.CODES[variant],
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"rk4 ({variant}) launch failed: CUDA error {err}")
        return out

    def differ(a, b):
        return f"{(a != b).any(1).double().mean().item():.4f}"

    parts = []
    for tag, lib in libs.items():
        for wrench, f in (("no wrench", None), ("a wrench", fe)):
            one = step(lib, "one", f)
            parts.append(f"{tag}, {wrench}: crba against one {differ(step(lib, 'crba', f), one)}, "
                         f"one against the kernels' own one "
                         f"{differ(one, step(libs['as built'], 'one', f))}")
    log(f"[fusion] {card}: share of {n} random plants whose rk4 step differs in any bit "
        f"({RK4_SUBSTEPS} substeps): " + "; ".join(parts))


def long_tracking(fl, state, i0, errs_kernel):
    """ROADMAP Queue 3's N=256 tracking: the plain route over the same
    K_LONG cycles from the same state as the kernel route's run; lane 0's
    mean EE error of the kernel route within TRACK_REL of the plain
    route's, either way (tracks_like_plain)."""
    t0 = time.perf_counter()
    errs_plain = fl.run(state, i0, fl.solve_plain, fl.plant_plain, K_LONG)[2]
    secs = time.perf_counter() - t0
    err_kernel, err_plain = errs_kernel.mean().item(), errs_plain.mean().item()
    log(f"[tracking] N={fl.N} B={fl.B} lane 0 mean EE error over {K_LONG} cycles: kernel "
        f"route {err_kernel:.5f} m, plain route {err_plain:.5f} m (tolerance: within "
        f"{TRACK_REL:.0%} of the plain route); the plain route's cycles took {secs:.1f} s; "
        f"each cycle's error, kernel {[round(e, 4) for e in errs_kernel.tolist()]}, plain "
        f"{[round(e, 4) for e in errs_plain.tolist()]}")
    if not tracks_like_plain(err_kernel, err_plain):
        raise RuntimeError(f"N=256 tracking: the kernel route is not within {TRACK_REL:.0%} "
                           "of the plain route")


def scrubbed(dzx, dzu):
    """A step zeroed for every problem whose step is not finite (step_ok)."""
    ok = (torch.isfinite(dzx).all((1, 2))
          & torch.isfinite(dzu).all((1, 2)))[:, None, None]
    return torch.where(ok, dzx, 0.0), torch.where(ok, dzu, 0.0)


def dense_btd(main, lower):
    """The dense (N nx)^2 matrix of a symmetric block-tridiagonal system."""
    Bn, n, nx, _ = main.shape
    D = torch.zeros(Bn, n * nx, n * nx, dtype=main.dtype, device=main.device)
    for k in range(n):
        D[:, k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = main[:, k]
    for k in range(n - 1):
        D[:, (k + 1) * nx:(k + 2) * nx, k * nx:(k + 1) * nx] = lower[:, k]
        D[:, k * nx:(k + 1) * nx, (k + 1) * nx:(k + 2) * nx] = lower[:, k].mT
    return D


@contextlib.contextmanager
def forced(module, name, value):
    """module.name is `value` inside the block: a route measured with
    another variant of a kernel than the one it takes (the wrappers read
    pcg_variant, phase_a_default and DEFAULT at each call)."""
    taken = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, taken)


# the other kernels that a route can be forced to, in turns with the taken
# ones: pcg's global variant, the one-thread phase A of bsqp_iter and iter,
# the one-thread kkt and merit kernels (the earlier ones), and rk4's
# two-warp kernel; and the Schur inverse by triangular solves; AB_ROUNDS rounds of the turns, since a host-bound
# route's batches of K cycles spread by up to 1.5x in one run
AB_ROUNDS = 3
FORCED = {
    "pcg in the global variant": lambda: forced(cuda_pcg, "pcg_variant",
                                                lambda n, nx: ("global", 1, 1)),
    "the one-thread phase A": lambda: forced(cuda_iter, "phase_a_default",
                                             lambda layout, g, nx: "one"),
    "the one-thread kkt": lambda: forced(cuda_kkt, "DEFAULT",
                                         {p: cuda_kkt.ONE for p in cuda_kkt.DEFAULT}),
    "the two-warp rk4 (crba)": lambda: forced(cuda_sim, "DEFAULT", "crba"),
    "the one-thread merit": lambda: forced(cuda_merit, "DEFAULT", "one"),
    "spd_inv by triangular solves": schur_mod.capturable_inverse,
}


def route_ab(f, state, i0, card, k, gates, earlier, fixed=False):
    """One route's per-cycle median (k cycles a batch) with the kernels it
    takes and with one forced to another variant (FORCED[earlier]: the
    earlier kernel, or rk4's two-warp one), in turns (taken, earlier, earlier, taken) AB_ROUNDS
    times: a kernel's gain end to end within one run, beside the spread of
    a host-bound route's batches, and each batch's mean PCG count (the two
    arms' trajectories part by rounding, and their work with them). With
    fixed=True every cycle of a batch starts from `state`, so both arms
    solve the identical input."""
    solve = f.solver(f.settings_with(*gates))

    def batch():
        if not fixed:
            out = f.run(state, i0, solve, f.plant_kernel, k)
            return out[1], out[3]
        outs = [f.run(state, i0, solve, f.plant_kernel, 1) for _ in range(k)]
        return [o[1][0] for o in outs], np.concatenate([o[3] for o in outs])

    med, pcg = {"taken": [], "earlier": []}, {"taken": [], "earlier": []}
    for arm in ("taken", "earlier", "earlier", "taken") * AB_ROUNDS:
        with FORCED[earlier]() if arm == "earlier" else contextlib.nullcontext():
            ms_cycle, iters = batch()
        med[arm].append(statistics.median(ms_cycle))
        pcg[arm].append(float(iters.mean()))
    log(f"[timing] {card}: route {gates} N={f.N} B={f.B}"
        f"{', every cycle from the same state' if fixed else ''}, per-cycle median of each "
        f"batch of {k} cycles, the kernels it takes {[round(t, 3) for t in med['taken']]} ms "
        f"against {earlier} {[round(t, 3) for t in med['earlier']]} ms (in turns: taken, "
        f"earlier, earlier, taken, {AB_ROUNDS} times); medians "
        f"{statistics.median(med['taken']):.3f} against "
        f"{statistics.median(med['earlier']):.3f} ms, means "
        f"{statistics.mean(med['taken']):.3f} against {statistics.mean(med['earlier']):.3f}; "
        f"the taken arm faster in {sum(a < b for a, b in zip(med['taken'], med['earlier']))} "
        f"of {len(med['taken'])} pairs; "
        f"PCG iterations a lane, each batch's mean: {[round(t, 2) for t in pcg['taken']]} "
        f"against {[round(t, 2) for t in pcg['earlier']]}")


def schur_inverse_phase(dev, card):
    """[schur-inverse]: the staged route's cycle (kkt, pcg, merit and rk4,
    the Schur build between them in PyTorch) with ops/schur.py::spd_inv as
    the routes take it (torch.cholesky_inverse) and in the form the fleet's
    CUDA graph captures (two triangular solves, capturable_inverse), in
    turns (route_ab), for indy7 and iiwa14 at N=32 B=512 and N=256 B=64,
    each from its fig-8 steady state."""
    for robot in ("indy7", IIWA):
        for n, b in ((N, B), (N_LONG, B_LONG)):
            fx = Fig8(dev, n, b, robot)
            state, i0 = fx.steady_state()
            route_ab(fx, state, i0, f"{card}; {robot}", K, ("off", "off"),
                     "spd_inv by triangular solves")
            del fx, state


def route_run(f, state, i0, gates, expect, card):
    """K cycles on one route with the launches counted; checks the counts
    against `expect` (every other kernel but rk4 launched 0 times); returns
    (the counts, the cycle's median ms)."""
    reset_launches()
    out = f.run(state, i0, f.solver(f.settings_with(*gates)), f.plant_kernel)
    got = launches()
    want = {name: expect.get(name, 0) for name in WRAPPERS}
    log(f"[route {gates}] launches over {K} cycles: {got}")
    if got != want:
        raise RuntimeError(f"route {gates} launched {got}, expected {want}")
    _, ms_cycle, _, pcg, step = out
    med = statistics.median(ms_cycle)
    log(f"[timing] {card}: route {gates} per-cycle median {med:.3f} ms "
        f"({f.B / (med / 1e3):.1f} solves/s); CUDA events over {K} cycles, "
        f"{f.model.name} N={f.N} B={f.B}")
    log(f"[work] route {gates} 8-cycle trace: {json.dumps(work_trace(pcg, step))}")
    return got, med


@contextlib.contextmanager
def iteration_marks(marks):
    """Around each launch of the whole-iteration route's iteration that a
    solve_batched call makes: (host time at the launch, CUDA events before
    and after), appended to `marks`."""
    taken = bsqp_mod.ITER_FNS["solve"]

    def timed(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        e0.record()
        out = taken(*a, **kw)
        e1.record()
        marks.append((t, e0, e1))
        return out

    bsqp_mod.ITER_FNS["solve"] = timed
    try:
        yield
    finally:
        bsqp_mod.ITER_FNS["solve"] = taken


def facade(f, **params):
    """The BSQP facade at f's shape with DEFAULT_SOLVER_PARAMS (updated by
    params), its warm start, duals and wrench hypotheses set to the steady
    state's."""
    cfg = dict(P, **params)
    fac = BSQP(plant_type="indy7", batch_size=f.B, N=f.N, dt=DT, **{k: cfg[k] for k in (
        "max_sqp_iters", "kkt_tol", "max_pcg_iters", "pcg_tol", "solve_ratio", "mu",
        "q_cost", "qd_cost", "u_cost", "N_cost", "q_lim_cost", "vel_lim_cost",
        "ctrl_lim_cost", "rho")})
    fac.set_f_ext_B(f.f_ext)
    return fac


def facade_phase(f, state, i0, card):
    """[facade]: the BSQP facade at indy7 N=32 B=512 from the fig-8 steady
    state. Held: its XU_B, lam and stats equal bit for bit a direct
    solve_batched call on the same inputs; one bsqp_iter launch per solve
    and no other; every stats key with the JAX facade's shapes. Then at
    max_sqp_iters=FACADE_ITERS, solve_ratio 1: held against the float64
    plain version by compare_iteration's float64 rule, with float32's own
    noise (the float32 plain version's distance from float64, times
    F64_FACTOR) where that is larger, each iteration's device time and the
    host time between launches printed
    (the chained driver reads the whole-batch exit on the host in between);
    sim_forward over the B wrench hypotheses and ee_pos against the
    float64 algorithms on the CPU."""
    X, U, lam, x_s = state
    xcur, ref = x_s.cpu().numpy(), f.ref(i0).cpu().numpy()
    fac = facade(f)
    fac.XU_B, fac.lam = fac._flatten(X, U), lam.clone()
    XU_in = fac.XU_B.copy()
    XU_in[:, :12] = xcur
    hp0, lam0 = fac.hp, fac.lam
    reset_launches()
    XU, wall_us = fac.solve(xcur, ref)
    got = launches()
    stats = fac.stats
    want = {name: int(name == "bsqp_iter") for name in WRAPPERS}
    Xd, Ud = fac._unflatten(XU_in)
    Xo, Uo, lamo, hpo, st = solve_batched(
        fac.model, fac.settings, fac.cost_params, hp0, Xd, Ud, lam0,
        torch.tensor(xcur, device=f.dev), torch.tensor(ref, device=f.dev), fac.f_ext_B, DT)
    fac.stats = fac._materialize_stats(st, wall_us, fac.device_solve_time_us)
    direct = fac.stats
    same = (np.array_equal(XU, fac._flatten(Xo, Uo)) and torch.equal(fac.lam, lamo)
            and torch.equal(fac.hp.rho, hpo.rho)
            and all(np.array_equal(stats[k], direct[k]) for k in stats
                    if k not in ("sqp_time_us", "sqp_time_us_device")))
    n = stats["ls_num_iters"]
    dims = dict(B=f.B, n=n)
    shapes_ok = set(stats) == set(FACADE_SHAPES) and all(
        shape is None or np.shape(stats[k]) == tuple(dims[d] for d in shape)
        for k, shape in FACADE_SHAPES.items())
    log(f"[facade] {card}: BSQP(indy7, B={f.B}, N={f.N}, DEFAULT_SOLVER_PARAMS) from the "
        f"fig-8 steady state: equal bit for bit to a direct solve_batched call {same}; "
        f"launches {got}; stats keys and shapes as the JAX facade's {shapes_ok}; wall "
        f"{wall_us} us, device {fac.device_solve_time_us:.1f} us (CUDA events)")
    if not (same and got == want and shapes_ok):
        raise RuntimeError("[facade] the facade does not match the direct solve")

    # FACADE_ITERS iterations against the plain versions in float32 and float64
    fac5 = facade(f, max_sqp_iters=FACADE_ITERS, solve_ratio=1.0)
    fac5.XU_B, fac5.lam = fac._flatten(X, U), lam.clone()
    marks = []
    with iteration_marks(marks):
        fac5.solve(xcur, ref)
    s5 = fac5.stats
    dev_ms = [a.elapsed_time(b) for _, a, b in marks]
    between = [(t1 - t0) * 1e3 for (t0, _, _), (t1, _, _) in zip(marks, marks[1:])]
    log(f"[facade] {card}: max_sqp_iters={FACADE_ITERS}, solve_ratio 1.0: {len(marks)} "
        f"bsqp_iter launches, iterations run {s5['ls_num_iters']}; device ms per "
        f"iteration {[round(t, 4) for t in dev_ms]}; host ms from one launch to the next "
        f"(the iteration, then the host's read of the exit) {[round(t, 4) for t in between]}; "
        f"so the read and the glue: {[round(b - d, 4) for b, d in zip(between, dev_ms)]} ms; "
        f"whole solve {s5['sqp_time_us']} us wall, {fac5.device_solve_time_us:.1f} us "
        f"between its CUDA events")
    m64 = load_robot(f.model.name, torch.float64, f.dev)
    arms = {}
    for tag, model, dt in (("plain32", f.model, torch.float32), ("float64", m64, torch.float64)):
        Xa, Ua = (t.to(dt) for t in fac._unflatten(XU_in))
        hp = HyperParams(*(t.to(dt) for t in (hp0.rho, hp0.drho, hp0.mu, hp0.pcg_tol)))
        arms[tag] = sqp_solve_chained(
            sqp_iter_reference, model, f.cp, fac5.settings, Xa, Ua, lam0.to(dt),
            torch.tensor(xcur, device=f.dev, dtype=dt), torch.tensor(ref, device=f.dev, dtype=dt),
            fac5.f_ext_B.to(dt), hp.rho, hp.drho, hp.mu, hp.pcg_tol, DT)
    Xk, _ = fac5._unflatten(fac5.XU_B)
    p32, p64 = arms["plain32"], arms["float64"]
    n5 = s5["ls_num_iters"]
    step64, pcg64 = p64[11][:n5], p64[9][:n5]
    res, lanes = dict(iters=(n5, int(p32[8].max()), int(p64[8].max()))), {}
    # each float32 arm against float64 over the iterations run: the share of
    # (iteration, lane) with the same step and with a PCG count within
    # PCG_SLACK; per lane, every step equal to float64's, X's distance and
    # the largest count difference (compare_iteration's float64 rule)
    for tag, (X, steps, pcg) in (
            ("kernel", (Xk, torch.tensor(s5["step_size"], device=f.dev),
                        torch.tensor(s5["pcg_iters"], device=f.dev))),
            ("plain32", (p32[0], p32[11][:n5], p32[9][:n5]))):
        diff = (pcg.double() - pcg64.double()).abs()
        res[f"{tag}_steps"] = (steps.double() == step64.double()).double().mean().item()
        res[f"{tag}_counts"] = (diff <= PCG_SLACK).double().mean().item()
        lanes[tag] = ((steps.double() == step64.double()).all(0), lane_rel(X, p64[0]),
                      diff.amax(0))
    ks_, kx, kc = lanes["kernel"]
    ps_, px, pc = lanes["plain32"]
    x_lim = max(TRAJ_RTOL, F64_FACTOR * (px[ps_].max().item() if ps_.any() else 0.0))
    c_lim = max(PCG_SLACK, F64_FACTOR * pc.max().item())
    res["f64_rule_frac"] = ((~ks_ | (kx <= x_lim)) & (kc <= c_lim)).double().mean().item()
    lim = {k: 1 - max(1 - STEP_SAME_MIN, F64_FACTOR * (1 - res[f"plain32_{k}"]))
           for k in ("steps", "counts")}
    log(f"[facade] max_sqp_iters={FACADE_ITERS} against the float64 plain version from the "
        f"same input (iterations run: facade, plain32, float64 {res['iters']}): (iteration, "
        f"lane) steps equal to float64's, kernel {res['kernel_steps']:.4f}, plain32 "
        f"{res['plain32_steps']:.4f} (tolerance: the kernel's share of differing steps at "
        f"most {F64_FACTOR}x plain32's, or {1 - STEP_SAME_MIN:.2f}: >= {lim['steps']:.4f}); "
        f"PCG counts within {PCG_SLACK}, kernel {res['kernel_counts']:.4f}, plain32 "
        f"{res['plain32_counts']:.4f} (>= {lim['counts']:.4f}); lane by lane (every step "
        f"equal to float64's: X within {x_lim:.3e}, {F64_FACTOR}x plain32's largest, floor "
        f"{TRAJ_RTOL}; the largest count difference within {c_lim:.0f}): holds on "
        f"{res['f64_rule_frac']:.4f} of lanes (tolerance >= {STEP_SAME_MIN})")
    if not (res["kernel_steps"] >= lim["steps"] and res["kernel_counts"] >= lim["counts"]
            and res["f64_rule_frac"] >= STEP_SAME_MIN and torch.isfinite(Xk).all()):
        raise RuntimeError(f"[facade] max_sqp_iters={FACADE_ITERS} disagrees: {res}")

    # sim_forward over the B hypotheses and ee_pos, against float64 on the CPU
    x1, u1 = xcur[0], U[0, 0].cpu().numpy()
    xn = fac.sim_forward(x1, u1, DT)
    m64c = load_robot("indy7", torch.float64, "cpu")
    xn64 = sim_forward_batched(m64c, torch.tensor(x1, dtype=torch.float64),
                               torch.tensor(u1, dtype=torch.float64),
                               f.f_ext.cpu().double(), DT).numpy()
    ee = fac.ee_pos(x1[:6])
    ee64 = ee_position(m64c, torch.tensor(x1[:6], dtype=torch.float64))[:3].numpy()
    sim_err = np.abs(xn - xn64).max() / np.abs(xn64).max()
    ee_err = np.abs(ee - ee64).max() / np.abs(ee64).max()
    log(f"[facade] {card}: sim_forward over {f.B} wrench hypotheses against the float64 "
        f"algorithms on the CPU: normwise {sim_err:.3e} (tolerance {SIM_RTOL}); ee_pos "
        f"{ee_err:.3e} (tolerance {EE_RTOL})")
    if not (xn.shape == (f.B, 12) and sim_err <= SIM_RTOL and ee_err <= EE_RTOL):
        raise RuntimeError("[facade] sim_forward or ee_pos disagrees with float64")


def wall_ms(fn, reps):
    """Host ms per call of fn over reps calls ended by a sync (after one
    call to warm up)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def mpc_run(card, x0, batch_size, wrench, sim_time):
    """MPC_GATO.run_mpc_fig8 (indy7, N=32, dt 0.01, sim_dt 1e-3) with the
    launches counted over the run; the solves' device times, the cycles'
    wall times and the plant step's time read around the facade's solve and
    the controller's _simulate (which syncs the card)."""
    mpc = MPC_GATO(plant_type="indy7", N=N, dt=DT, batch_size=batch_size,
                   constant_f_ext=wrench)
    solve, simulate, sim_step = mpc.solver.solve, mpc._simulate, mpc._sim_step
    rec = dict(solves=0, device_us=[], starts=[], plant_s=[], groups=0)

    def timed_solve(*a, **kw):
        out = solve(*a, **kw)
        rec["solves"] += 1
        rec["device_us"].append(mpc.solver.device_solve_time_us)
        return out

    def timed_simulate(*a, **kw):
        t = time.perf_counter()
        rec["starts"].append(t)
        out = simulate(*a, **kw)
        torch.cuda.synchronize()
        rec["plant_s"].append(time.perf_counter() - t)
        return out

    def counted_step(*a, **kw):
        rec["groups"] += 1
        return sim_step(*a, **kw)

    mpc.solver.solve, mpc._simulate, mpc._sim_step = timed_solve, timed_simulate, counted_step
    reset_launches()
    t0 = time.perf_counter()
    _, stats = mpc.run_mpc_fig8(x0, figure8(DT), sim_dt=1e-3, sim_time=sim_time)
    secs = time.perf_counter() - t0
    got = launches()
    err = np.asarray(stats["goal_distances"])
    cycle_ms = np.diff(rec["starts"]) * 1e3
    res = dict(cycles=len(err), err_mean=float(err.mean()),
               err_second_half=float(err[len(err) // 2:].mean()), err_max=float(err.max()),
               solve_device_ms=statistics.median(rec["device_us"]) / 1e3,
               cycle_wall_ms=float(np.median(cycle_ms)),
               plant_ms=statistics.median(rec["plant_s"]) * 1e3,
               finite=bool(np.isfinite(stats["joint_positions"]).all()
                           and np.isfinite(stats["joint_velocities"]).all()),
               launches=got, solves=rec["solves"], groups=rec["groups"], secs=secs)
    res["plant_share"] = res["plant_ms"] / res["cycle_wall_ms"]
    graphed = ""
    if mpc._graphs:
        # the plant step replayed from its CUDA graph against the same step
        # run eagerly, on the graph's last inputs: equal bit for bit, and
        # each one's wall time (host clock to a sync, 3 steps)
        (substeps, h), step = next(iter(mpc._graphs.items()))
        x, u = step.x.clone(), step.u.clone()

        def eager():
            return rk4_step(mpc.sim_model, x, u, h, f_ext_world=mpc._sim_fext,
                            substeps=substeps)

        res["graph_equal"] = torch.equal(eager(), step(x, u))
        res["plant_eager_ms"] = wall_ms(eager, 3)
        res["plant_graph_ms"] = wall_ms(lambda: step(x, u), 3)
        graphed = (f"; the plant step ({substeps} substeps) eager {res['plant_eager_ms']:.3f} "
                   f"ms, from its CUDA graph {res['plant_graph_ms']:.3f} ms, equal bit for "
                   f"bit {res['graph_equal']}")
    log(f"[mpc] {card}: MPC_GATO(indy7, N={N}, B={batch_size}, world wrench "
        f"{list(wrench) if wrench else None}).run_mpc_fig8(sim_dt 1e-3, {sim_time} s): "
        f"{res['cycles']} cycles in {secs:.1f} s; EE error mean {res['err_mean']:.5f} m, "
        f"second half {res['err_second_half']:.5f}, max {res['err_max']:.5f} (limit on the "
        f"mean {TRACK_MAX_M} m); median solve {res['solve_device_ms']:.4f} ms on the device "
        f"(CUDA events), median cycle {res['cycle_wall_ms']:.3f} ms wall, plant step "
        f"{res['plant_ms']:.3f} ms ({res['plant_share']:.3f} of the cycle); launches "
        f"{got} over {rec['solves']} solves and {rec['groups']} plant-step calls; states "
        f"finite {res['finite']}{graphed}")
    return res


def mpc_phase(card):
    """[mpc]: the README's quick start and B=1 without a wrench. Held:
    bsqp_iter launched once per solve and no other kernel, but rk4 once per
    plant-step call at B=1 without a wrench (the world wrench takes the
    rigid-body algorithms, as the JAX package's XLA rk4_step, replayed from
    a CUDA graph: equal bit for bit to the eager step); finite states; the
    mean EE error over the run below TRACK_MAX_M."""
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)
    for b, wrench, sim_time in ((32, MPC_WRENCH, MPC_TIME), (1, None, MPC_B1_TIME)):
        r = mpc_run(card, x0, b, wrench, sim_time)
        want = {name: 0 for name in WRAPPERS}
        want["bsqp_iter"] = r["solves"] * P["max_sqp_iters"]
        want["rk4"] = 0 if wrench else r["groups"]
        if not (r["launches"] == want and r["finite"] and r["err_mean"] < TRACK_MAX_M
                and r.get("graph_equal", True)):
            raise RuntimeError(f"[mpc] B={b} failed: {r} (launches expected {want})")


def goals_phase(card):
    """[goals]: MPC_GATO.run_mpc_goals at N=32 B=1, one goal 5 cm from the
    start, control_dt 0.004 (tests/test_api.py:166-178's shape). Held: the
    outcome is "reached" or "timeout", the states finite, and the solves
    and plant steps went through bsqp_iter and rk4."""
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)
    mpc = MPC_GATO(plant_type="indy7", N=N, dt=DT, batch_size=1, control_dt=0.004,
                   solver_params=dict(P, max_sqp_iters=2, max_pcg_iters=50))
    goals = [mpc.solver.ee_pos(x0[:6]) + np.array([0.05, 0.0, 0.0])]
    reset_launches()
    t0 = time.perf_counter()
    _, stats = mpc.run_mpc_goals(x0, goals, sim_dt=1e-3, goal_timeout=1.5,
                                 goal_threshold=0.04, velocity_threshold=2.0)
    secs = time.perf_counter() - t0
    got = launches()
    finite = bool(np.isfinite(stats["joint_positions"]).all())
    log(f"[goals] {card}: run_mpc_goals(indy7, N={N}, B=1, one goal 5 cm away, control_dt "
        f"0.004): outcome {stats['goal_outcomes']}, reached at "
        f"{stats['goal_reached_times']} s, {len(stats['timestamps'])} cycles in {secs:.1f} s, "
        f"last EE distance {stats['goal_distances'][-1]:.4f} m; launches {got}; states "
        f"finite {finite}")
    if not (stats["goal_outcomes"][0] in ("reached", "timeout") and finite
            and got["bsqp_iter"] > 0 and got["rk4"] > 0
            and all(v == 0 for k, v in got.items() if k not in ("bsqp_iter", "rk4"))):
        raise RuntimeError("[goals] failed")


def ready_state(dev):
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)])
    return torch.tensor(x0, dtype=torch.float32, device=dev)


def graph_against_eager(tag, call, want_launches, card, before_loop=0):
    """call(n_steps, graph) -> the rollout's outputs. Runs the rollout from
    its CUDA graph over its n_steps (launches counted from zero), then
    eagerly over ROLLOUT_SAME cycles. Held: the captured cycle's launches
    equal want_launches and the warm-up cycle and the capture launched
    nothing else (but before_loop bsqp_iter launches of a solve before the
    loop); the first ROLLOUT_SAME cycles equal bit for bit. Returns
    (outputs, replay ms a cycle, eager ms a cycle, launches)."""
    reset_launches()
    out = call(True)
    torch.cuda.synchronize()
    got = launches()
    cap = rollout_mod.last_capture
    n = out[0].shape[0]
    replay_ms = cap["events"][0].elapsed_time(cap["events"][1]) / n
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    eager = call(False)
    e1.record()
    torch.cuda.synchronize()
    eager_ms = e0.elapsed_time(e1) / ROLLOUT_SAME
    pairs = [(i, a[:ROLLOUT_SAME], b) for i, (a, b) in enumerate(zip(out, eager))
             if a.dim() and a.shape[0] == n]
    same = all(torch.equal(a, b) for _, a, b in pairs)
    if not same:
        for i, a, b in pairs:
            d = (a.double() - b.double()).abs().reshape(ROLLOUT_SAME, -1).amax(1)
            first = int(torch.nonzero(d).min()) if bool((d > 0).any()) else None
            log(f"[{tag}] output {i}: first cycle that differs {first}, per-cycle largest "
                f"difference {[float(v) for v in d]}")
    whole = {name: 2 * want_launches.get(name, 0) for name in WRAPPERS}
    whole["bsqp_iter"] += before_loop
    log(f"[{tag}] {card}: the captured cycle holds launches {cap['launches']} (expected "
        f"{want_launches}); warm-up cycle and capture launched {got}; graph replays equal "
        f"the eager cycles bit for bit over the first {ROLLOUT_SAME}: {same}; "
        f"{replay_ms:.4f} ms a cycle over {n} replays (CUDA events), eager "
        f"{eager_ms:.3f} ms a cycle over {ROLLOUT_SAME}")
    if not (cap["launches"] == want_launches and got == whole and same):
        raise RuntimeError(f"[{tag}] the graph's launches or its cycles are not the eager ones")
    return out, replay_ms, eager_ms, got


def rollout_phase(f, card, default_cycle_ms):
    """[rollout]: closed_loop_rollout at the main path's shape (indy7, N=32,
    B=512, DEFAULT_SOLVER_PARAMS, f.f_ext's wrench hypotheses with lane 0
    zero, the fig-8 windows, control_dt 0.01, 2 substeps) over ROLLOUT_STEPS
    cycles from the ready start. Held: graph against eager, one bsqp_iter
    and one rk4 launch a cycle, finite states, the mean EE error against the
    knot each cycle steers to below TRACK_MAX_M. The witness: the same
    rollout with every hypothesis zero, so that every lane plans for the
    true (wrench-free) plant and the one-step prediction cannot pick a
    phantom wrench; held: each of its GATE_WINDOWS windows below
    TRACK_MAX_M, the main path's gate. The hypotheses' windows are printed
    beside it: the late windows' growth is the lane choice's (PERF.md)."""
    refs = torch.stack([f.traj[k:k + f.N] for k in range(ROLLOUT_STEPS)])
    x0 = ready_state(f.dev)

    def call(graph, f_ext=f.f_ext):
        n = ROLLOUT_STEPS if graph else ROLLOUT_SAME
        return rollout_mod.closed_loop_rollout(
            f.model, f.model, f.settings, f.cp, f.hp, x0, refs[:n], f_ext, DT, DT,
            sim_substeps=2, graph=graph)

    (xs, ees, us), replay_ms, eager_ms, _ = graph_against_eager(
        "rollout", call, dict(bsqp_iter=P["max_sqp_iters"], rk4=1), card)
    err = (ees - refs[:, 1, :3]).norm(dim=1)
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(us).all())
    xs0, ees0, _ = call(True, torch.zeros_like(f.f_ext))
    err0 = (ees0 - refs[:, 1, :3]).norm(dim=1)
    win, win0 = windows(err), windows(err0)
    finite0 = bool(torch.isfinite(xs0).all())
    log(f"[rollout] {card}: closed_loop_rollout(indy7, N={f.N}, B={f.B}) over {ROLLOUT_STEPS} "
        f"cycles: EE error mean {err.mean().item():.5f} m, max {err.max().item():.5f}, in "
        f"{GATE_WINDOWS} windows of {ROLLOUT_STEPS // GATE_WINDOWS} cycles "
        f"{[round(e, 5) for e in win]} m (limit on the mean {TRACK_MAX_M} m); states "
        f"finite {finite}; {replay_ms:.4f} ms a cycle from the graph, {eager_ms:.3f} ms "
        f"eager, against the default cycle's {default_cycle_ms:.3f} ms in this run. Witness, "
        f"every hypothesis zero: mean {err0.mean().item():.5f} m, windows "
        f"{[round(e, 5) for e in win0]} m (limit on each {TRACK_MAX_M} m); states finite "
        f"{finite0}")
    if not (finite and err.mean().item() < TRACK_MAX_M and finite0
            and max(win0) < TRACK_MAX_M):
        raise RuntimeError("[rollout] failed")
    return replay_ms


def estimator_setup(dev, n, b, max_pcg_iters):
    """(model, settings, cost, hyperparameters, x0, hold point, true wrench,
    refs, draws) of the estimator rollout at horizon n and batch b: one SQP
    iteration and DEFAULT_SOLVER_PARAMS's costs and hyperparameters, which
    are examples/force_adaptive.py's working point's but for its
    max_pcg_iters (30 there, 200 here)."""
    model = load_robot("indy7", torch.float32, dev)
    cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                         "q_lim_cost", "vel_lim_cost", "ctrl_lim_cost")})
    settings = BSQPSettings(N=n, max_sqp_iters=1, max_pcg_iters=max_pcg_iters)
    hp = HyperParams.create(b, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"], device=dev)
    q0 = torch.tensor(EST_Q0, dtype=torch.float32, device=dev)
    x0 = torch.cat([q0, torch.zeros_like(q0)])
    hold = fk(model, q0)[1][-1]
    refs = torch.cat([hold, torch.zeros(3, device=dev)]).expand(EST_STEPS, n, 6).contiguous()
    draws = torch.rand(EST_STEPS, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    return (model, settings, cp, hp, x0, hold, torch.tensor(EST_WRENCH, device=dev), refs,
            draws)


def estimator_reading(out, hold, true_w):
    """(force error of the last estimate, EE hold error over the last 10
    cycles, states finite) of closed_loop_rollout_estimator's outputs."""
    xs, ees, fests, _ = out
    return ((fests[-1, :3] - true_w[:3]).norm().item(),
            (ees[-10:] - hold).norm(dim=1).mean().item(),
            bool(torch.isfinite(xs).all() and torch.isfinite(fests).all()))


def estimator_phase(dev, card):
    """[rollout-estimator]: closed_loop_rollout_estimator, sphere and
    observer, at examples/force_adaptive.py's working point (indy7 N=8 B=16,
    EST_STEPS cycles, 2 substeps, max_pcg_iters 30), then at N=32 B=512 with
    max_pcg_iters 200 (estimator_setup: DEFAULT_SOLVER_PARAMS in both but
    for max_pcg_iters at N=8). Held: graph against eager at the first shape;
    finite states; the EE hold over the last 10 cycles below HOLD_MAX m; the
    observer's final force error below OBSERVER_FORCE_MAX N at the first
    shape."""
    res = {}
    for n, b, mpcg in ((EST_N, EST_B, EST_PCG), (N, B, P["max_pcg_iters"])):
        model, settings, cp, hp, x0, hold, true_w, refs, draws = estimator_setup(dev, n, b,
                                                                                 mpcg)
        for mode in ("sphere", "observer"):
            def call(graph):
                k = EST_STEPS if graph else ROLLOUT_SAME
                return rollout_mod.closed_loop_rollout_estimator(
                    model, settings, cp, hp, x0, refs[:k], true_w, DT, DT, b, draws[:k],
                    sim_substeps=2, estimator=mode, graph=graph)

            if n == EST_N:
                out, replay_ms, eager_ms, _ = graph_against_eager(
                    f"rollout-estimator {mode} N={n} B={b}", call, dict(bsqp_iter=1, rk4=1),
                    card)
            else:
                reset_launches()
                out = call(True)
                torch.cuda.synchronize()
                cap = rollout_mod.last_capture
                replay_ms = cap["events"][0].elapsed_time(cap["events"][1]) / EST_STEPS
                eager_ms = float("nan")
                if cap["launches"] != dict(bsqp_iter=1, rk4=1):
                    raise RuntimeError(f"[rollout-estimator] captured {cap['launches']}")
            force_err, hold_err, finite = estimator_reading(out, hold, true_w)
            fests, errs = out[2], out[3]
            res[(mode, n)] = dict(force_err=force_err, hold=hold_err, replay_ms=replay_ms)
            log(f"[rollout-estimator] {card}: {mode}, indy7 N={n} B={b}, {EST_STEPS} cycles "
                f"under {list(EST_WRENCH)} N, max_pcg_iters {mpcg}: final estimate "
                f"{[round(v, 4) for v in fests[-1].tolist()]}, "
                f"force error {force_err:.4f} N; EE hold over the last 10 cycles "
                f"{hold_err:.5f} m (limit {HOLD_MAX}); least prediction error, last cycle "
                f"{errs[-1].item():.3e}; states finite {finite}; {replay_ms:.4f} ms a cycle "
                f"from the graph, {eager_ms:.3f} ms eager")
            held = finite and hold_err < HOLD_MAX and (
                mode != "observer" or n != EST_N or force_err < OBSERVER_FORCE_MAX)
            if not held:
                raise RuntimeError(f"[rollout-estimator] {mode} at N={n} B={b} failed")
    return res


def plain_solve(model, settings, cp, hp, X, U, lam, x_s, ref, f_ext, dt, device_exit=False):
    """solve_batched's (X, U, lam, -, -) on the plain route: the chained
    driver over sqp_iter_reference."""
    o = sqp_solve_chained(sqp_iter_reference, model, cp, settings, X, U, lam, x_s, ref,
                          f_ext, hp.rho, hp.drho, hp.mu, hp.pcg_tol, dt)
    return o[0], o[1], o[2], None, None


def estimator_witness(dev, card):
    """--estimator-witness: the sphere search at N=32 B=512 with the working
    point's max_pcg_iters (EST_PCG) on the kernel route (from its CUDA
    graph) and with the solve on the plain route (sqp_iter_reference,
    eager; the plant on the rk4 kernel), and the kernel route again at
    max_pcg_iters 200, over EST_STEPS cycles: each one's EE hold over the
    last 10 cycles, the first cycle whose EE lies HOLD_MAX m or more from
    the hold point, and the force error. Reported, not held."""
    for mpcg, route in ((EST_PCG, "kernel"), (EST_PCG, "plain"),
                        (P["max_pcg_iters"], "kernel")):
        model, settings, cp, hp, x0, hold, true_w, refs, draws = estimator_setup(dev, N, B,
                                                                                 mpcg)
        t0 = time.perf_counter()
        with (mock.patch.object(rollout_mod, "solve_batched", plain_solve)
              if route == "plain" else contextlib.nullcontext()):
            out = rollout_mod.closed_loop_rollout_estimator(
                model, settings, cp, hp, x0, refs, true_w, DT, DT, B, draws,
                sim_substeps=2, estimator="sphere", graph=route == "kernel")
        torch.cuda.synchronize()
        force_err, hold_err, finite = estimator_reading(out, hold, true_w)
        away = torch.nonzero((out[1] - hold).norm(dim=1) >= HOLD_MAX)
        first = int(away[0]) if away.numel() else None
        log(f"[estimator-witness] {card}: sphere, indy7 N={N} B={B}, max_pcg_iters {mpcg}, "
            f"{route} route, {EST_STEPS} cycles in {time.perf_counter() - t0:.1f} s: EE hold "
            f"over the last 10 cycles {hold_err:.5f} m, first cycle {HOLD_MAX} m or more "
            f"from the hold point {first}, force error {force_err:.4f} N, states finite "
            f"{finite}")


def goals_rollout_phase(dev, card):
    """[rollout-goals]: closed_loop_rollout_goals with the indy7 solver
    plant and add_pendulum(indy7) as the plant (PENDULUM_DEFAULT_PARAMS),
    N=32 B=32 (the sphere estimator over 29 exploration lanes), three goals
    5-10 cm from the start EE, GOAL_TIMEOUT s each, enough cycles for every
    goal to resolve, at examples/pickplace.py's control_dt of 2 ms (at 10 ms
    the 15 kg pendulum on indy7 diverges within 12 cycles, on the CPU's plain
    route too, with or without the estimator). Held: graph against eager (one
    bsqp_iter and one rk4 launch a captured cycle: the pendulum plant on its
    generated rk4 library), every goal reached or timed out, finite states.
    Then the cycle's parts (cycle_split). Returns the launches, ms a cycle
    and the parts."""
    model = load_robot("indy7", torch.float32, dev)
    pend = PENDULUM_DEFAULT_PARAMS
    sim = add_pendulum(model, mass=pend["mass"], length=pend["length"])
    x_sim0 = torch.zeros(2 * sim.nq, device=dev)
    x_sim0[:6] = ready_state(dev)[:6]
    x_sim0[6:9] = torch.tensor(pend["initial_angle"], dtype=torch.float32, device=dev)
    goals = fk(model, x_sim0[:6])[1][-1] + torch.tensor(GOALS, device=dev)
    settings = BSQPSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                            max_pcg_iters=P["max_pcg_iters"])
    cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                         "q_lim_cost", "vel_lim_cost", "ctrl_lim_cost")})
    hp = HyperParams.create(GOALS_B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                            device=dev)
    n_steps = int(np.ceil(GOAL_TIMEOUT * len(GOALS) / GOALS_CONTROL_DT)) + 2
    draws = torch.rand(n_steps, 3, generator=torch.Generator().manual_seed(1)).to(dev)

    def call(graph):
        k = n_steps if graph else ROLLOUT_SAME
        return rollout_mod.closed_loop_rollout_goals(
            model, sim, settings, cp, hp, x_sim0, goals, DT, GOALS_CONTROL_DT, draws[:k],
            GOALS_B, k,
            goal_timeout=GOAL_TIMEOUT, sim_substeps=2, pendulum_damping=pend["damping"],
            graph=graph)

    out, replay_ms, eager_ms, got = graph_against_eager(
        "rollout-goals", call, dict(bsqp_iter=P["max_sqp_iters"], rk4=1), card,
        before_loop=P["max_sqp_iters"])
    xs, ees, dists, gidx, bests, outcomes, reached_t = out[:7]
    finite = bool(torch.isfinite(xs).all())
    oc = outcomes.tolist()
    log(f"[rollout-goals] {card}: indy7 + pendulum plant, N={N} B={GOALS_B}, "
        f"{len(GOALS)} goals {[round(float(v), 3) for v in torch.tensor(GOALS).norm(dim=1)]} m "
        f"away, control_dt {GOALS_CONTROL_DT} s, {n_steps} cycles: outcomes {oc} (1 "
        f"reached, 2 timeout), reached at "
        f"{[round(v, 3) for v in reached_t.tolist()]} s, last distance {dists[-1].item():.4f} "
        f"m, lanes chosen other than 0 on {int((bests != 0).sum())} cycles; states finite "
        f"{finite}; {replay_ms:.4f} ms a cycle from the graph, {eager_ms:.3f} ms eager")
    if not (finite and all(o in (1, 2) for o in oc)):
        raise RuntimeError("[rollout-goals] failed")
    return dict(launches=got, ms=replay_ms, split=cycle_split(
        "rollout-goals", model, sim, settings, cp, hp, x_sim0, goals[0], GOALS_B, DT,
        replay_ms, card, 0))


def runner_phase(card):
    """[runner]: ExperimentRunner (the fig-8 loop of MPC_GATO per batch
    size) at RUNNER_BATCHES, N=32, RUNNER_TIME s of simulation, no wrench.
    Held: every row's error and solve time finite."""
    runner = ExperimentRunner(plant_type="indy7", N=N, dt=DT, batch_sizes=list(RUNNER_BATCHES),
                              sim_time=RUNNER_TIME)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        runner.run_batch_experiments(verbose=False)
    rows = runner.summary()
    for r in rows:
        log(f"[runner] {card}: " + ", ".join(
            f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
    log(f"[runner] {len(rows)} batch sizes in {time.perf_counter() - t0:.1f} s")
    if len(rows) != len(RUNNER_BATCHES) or not all(
            np.isfinite(r["avg_error_m"]) and np.isfinite(r["avg_solve_ms"]) for r in rows):
        raise RuntimeError("[runner] failed")
    return rows


def rollout_phases(f, dev, card, default_cycle_ms):
    """The rollouts, each cycle one CUDA graph, and the experiment runner.
    Returns [rollout-goals]' launches, ms a cycle and parts."""
    rollout_phase(f, card, default_cycle_ms)
    estimator_phase(dev, card)
    goals = goals_rollout_phase(dev, card)
    runner_phase(card)
    return goals


IIWA = "iiwa14"
# [iiwa14-kernels]: bsqp_iter for iiwa14 held as indy7's is (compare_iteration)
# at N=32 with B=128 and 512, at the shared layout's last N and at N=128 in
# the global layout (B=512), and timed in every shared-layout G it is
# compiled for and the global layout at N=32 B=512; rk4 for iiwa14 held in
# both variants (compare_rk4) and timed at B=1
IIWA_CHECKS = ((N, 128), (N, B), (cuda_iter.SHARED_MAX_N, B), (128, B))
IIWA_VARIANTS = (("shared", 1), ("shared", 2), ("shared", 7), ("global", 1))
# [iiwa14-staged]: kkt and pcg for iiwa14 at N=32 B=512 and at IIWA_LONG,
# indy7's long-horizon shape; pcg timed in every variant at IIWA_PCG_EDGES
# (B=512), where iiwa14's cut points fall: the shared variant's last N (it
# stops fitting past it), the 4-CTA clusters' last
IIWA_LONG = (N_LONG, B_LONG)
IIWA_PCG_EDGES = (cuda_pcg.SHARED_MAX_N[14], cuda_pcg.CLUSTER4_MAX_N)
# [fleet]: gato_tpu_torch.examples.mixed_fleet (indy7 + iiwa14, B each) at
# (N, B, cycles): the example's default, and a horizon past 128 knots where
# both members take the staged route
FLEET_POINTS = ((8, 8, 60), (N_LONG, 8, 20))
# [rollout-iiwa14]: tests/test_rollout.py::test_rollout_reaches_nearby_goal
# carried to iiwa14 at N=32 B=512: the elbow-bent start
# (examples/mixed_fleet.py:130), a goal REACH_OFFSET m from its EE, that
# test's costs, hyperparameters and settings (2 SQP iterations, PCG <= 40,
# dt 0.01, control_dt 0.004, 2 substeps, REACH_STEPS cycles, no wrench);
# held: the last EE distance below REACH_MAX m, the test's limit (the JAX
# package's own rollout of this setup on the CPU ends at 0.0106 m)
REACH_OFFSET, REACH_STEPS, REACH_MAX, REACH_CONTROL_DT = (0.06, -0.04, 0.05), 60, 0.03, 0.004
REACH_COST = dict(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0, q_lim_cost=0.01)
# [rollout-goals-iiwa14]: examples/pickplace.py::main_device's loop on the
# port (gato_tpu_torch.examples.pickplace_device) at its largest batch
PICKPLACE_B = 128
# the pendulum plants (add_pendulum of indy7 and iiwa14 at
# PENDULUM_DEFAULT_PARAMS' mass and length: the goals rollouts' plants),
# whose rk4 headers are generated and built with the other libraries at
# the run's start; [iiwa14-kernels] holds rk4 on each as compare_rk4 holds
# the others (RK4_RTOL of the largest |x|), at the rollouts' B = 1 and at
# PENDULUM_WIDE_B, over their plant step (GOALS_CONTROL_DT, 2 substeps)
PENDULUM_BASES, PENDULUM_WIDE_B = ("indy7", IIWA), PICKPLACE_B
def pendulum_plants(dev):
    """{base: (add_pendulum(base) at PENDULUM_DEFAULT_PARAMS' mass and
    length, float32 on dev; the slug of its generated rk4 plant)}: the
    header is generated and registered here, before any build."""
    pend = PENDULUM_DEFAULT_PARAMS
    out = {}
    for base in PENDULUM_BASES:
        m = add_pendulum(load_robot(base, torch.float32, dev), mass=pend["mass"],
                         length=pend["length"])
        out[base] = (m, cuda_sim.require_cuda_robot(m, "rk4"))
    return out


def build_kernels(dev):
    """Every library at once (one nvcc process each): the committed
    plants' (_build.LIBRARIES) and rk4 for the pendulum plants. Returns
    (pendulum_plants, every (kernel, plant) built)."""
    pend = pendulum_plants(dev)
    libs = _build.LIBRARIES + tuple(("rk4", slug) for _, slug in pend.values())
    t0 = time.perf_counter()
    secs = _build.build(libs)
    log(f"[build] nvcc seconds per kernel: {secs}; total {time.perf_counter() - t0:.1f} s "
        f"({len(libs)} libraries; the pendulum plants' headers generated at "
        f"{', '.join(_build.GENERATED_DIR + '/' + slug + '.cuh' for _, slug in pend.values())})")
    return pend, libs


def compare_rk4_pendulum(model, dev, seed=7):
    """rk4 for a pendulum plant (its generated library) against rk4_plain
    (hold_rk4), at B = 1 and PENDULUM_WIDE_B, with and without an
    EE-frame wrench (uniform in +-5 per lane), over the goals rollouts'
    plant step: arm joints and rates uniform in +-1, the payload's gimbal
    angles in +-0.5 rad, arm torques in +-20 N m, the gimbal's in +-1 (the
    damping's size). Returns (x, u at B = 1, the default's max abs error
    there without a wrench)."""
    g = torch.Generator().manual_seed(seed)
    nq = model.nq
    scale = torch.ones(nq)
    scale[nq - 3:] = 0.5
    first = None
    for b in (1, PENDULUM_WIDE_B):
        q = (torch.rand(b, nq, generator=g) * 2 - 1) * scale
        qd = torch.rand(b, nq, generator=g) * 2 - 1
        u = (torch.rand(b, nq, generator=g) * 40 - 20) * torch.where(scale < 1, 0.05, 1.0)
        fe = torch.rand(b, 6, generator=g) * 10 - 5
        x, u, fe = torch.cat([q, qd], 1).to(dev), u.to(dev), fe.to(dev)
        errs = {fb is None: hold_rk4(model, x, u, fb, GOALS_CONTROL_DT)[cuda_sim.DEFAULT]
                for fb in (None, fe)}
        first = first or (x, u, errs[True])
    return first


def pendulum_rk4_phase(pend, card):
    """[iiwa14-kernels]' pendulum part: for each pendulum plant its rk4
    library's ptxas lines (registers, spills: recorded, not held; a
    spilling kernel that is right is kept), the holds of
    compare_rk4_pendulum, each variant's device ms at B = 1 (two rounds)
    against the latency bound from its generated header's depths, and the
    wrapper-call and plain ms. Returns {slug: the kernels line's numbers}."""
    out = {}
    mhz = sm_max_clock_mhz()
    for base, (model, slug) in pend.items():
        px = ptxas_lines("rk4", RK4_PATTERN, rk4_variant_of, slug)
        for v in cuda_sim.VARIANTS:
            log(f"[variant] rk4 {model.name} ({slug}) {v}"
                f"{' (the default)' if v == cuda_sim.DEFAULT else ''}: ptxas: {px[v]}; "
                f"spill stores {spill_bytes(px[v])} B a thread")
        x, u, err = compare_rk4_pendulum(model, model.R_tree.device)
        rk4_ms = time_in_rounds(
            cuda_sim.VARIANTS, lambda v: rk4_step_batched(model, x, u, GOALS_CONTROL_DT, None,
                                                          RK4_SUBSTEPS, variant=v),
            200, card, f"rk4 {model.name}", cuda_sim.DEFAULT)
        plain_ms = event_ms(lambda: rk4_plain(model, x, u, GOALS_CONTROL_DT, None,
                                              RK4_SUBSTEPS), 3)
        stats = header_stats(_build.GENERATED[slug][0])
        b = bound(RK4_SUBSTEPS * (4 * stats["fd"][0] + plant_ops(model.nq)["rk4_axpy"]),
                  nbytes(x, u) + nbytes(x))
        lat = {v: rk4_latency_bound(stats, mhz, v) for v in cuda_sim.VARIANTS}
        if lat[cuda_sim.DEFAULT][0] > b[0]:
            b = (lat[cuda_sim.DEFAULT][0], "latency")
        log(f"[bound] rk4 {model.name} ({slug}) at B=1: (operations, depth) of the generated "
            f"functions {stats}; bound {b[0]:.5f} ms by {b[1]}; latency per variant "
            + ", ".join(f"{v} {lat[v][0]:.5f} ms (depth {lat[v][1]}), {rk4_ms[v][0]:.5f} ms on "
                        f"the card, {lat[v][0] / rk4_ms[v][0]:.4f} of it reached"
                        for v in cuda_sim.VARIANTS)
            + f"; per wrapper call {rk4_ms[cuda_sim.DEFAULT][1]:.5f} ms; plain version "
            f"{plain_ms:.3f} ms ({card})")
        out[slug] = dict(plant=model.name, max_abs_err=err, ms=rk4_ms[cuda_sim.DEFAULT][0],
                         crba_ms=rk4_ms["crba"][0], plain_ms=plain_ms, bound_ms=b[0],
                         bound_by=b[1], ptxas={v: px[v] for v in cuda_sim.VARIANTS})
    return out


def cycle_split(tag, model, sim, settings, cp, hp, x_sim0, goal, b, dt, cycle_ms, card,
                score_substeps):
    """The goals rollout's cycle in parts, each timed alone on the device
    (graph_ms) at the loop's shapes and its first state: the plant step
    (one rk4 launch, B = 1), the solve (max_sqp_iters bsqp_iter launches and
    the chained loop around them, device_exit=True; warm-started from one solve
    of that state, as the loop's solves are from the last cycle's), the RK4
    scoring of the b
    hypotheses on the rigid-body algorithms (score_substeps; with 0 the
    solver's integrator, sim_step, over the cycle; none at b <= 3);
    what the cycle (cycle_ms, from the graph's replays) holds besides
    them is the goal bookkeeping and the estimator. Logs and returns
    {part: ms}."""
    nq, nx, nu, N = model.nq, model.nx, model.nu, settings.N
    nq_s = sim.nq
    g = torch.Generator().manual_seed(9)
    dev = x_sim0.device
    x0 = torch.cat([x_sim0[:nq], x_sim0[nq_s:nq_s + nq]])
    u_sim = torch.cat([torch.rand(nq, generator=g).to(dev) * 10 - 5, torch.zeros(3, device=dev)])
    batch = (torch.rand(b, 6, generator=g) * 10 - 5).to(dev)
    X = x0.expand(b, N, nx).contiguous()
    U, lam = torch.zeros(b, N - 1, nu, device=dev), torch.zeros(b, N, nx, device=dev)
    x_s = x0.expand(b, nx).contiguous()
    ref = goal[None, None, :].expand(b, N, 3).contiguous()
    Xo, U, lam, _, _ = solve_batched(model, settings, cp, hp, X, U, lam, x_s, ref, batch, dt,
                                     device_exit=True)
    X = torch.cat([x_s[:, None], Xo[:, 1:]], 1)
    parts = dict(
        plant=graph_ms(lambda: rollout_mod._plant_step(sim, x_sim0, u_sim, GOALS_CONTROL_DT,
                                                       RK4_SUBSTEPS), 50),
        solve=graph_ms(lambda: solve_batched(model, settings, cp, hp, X, U, lam, x_s, ref, batch,
                                             dt, device_exit=True), 5))
    if b > 3 and score_substeps > 0:
        parts["scoring"] = graph_ms(lambda: rollout_mod._rk4_algorithms(
            model, x0.expand(b, nx), U[:, 0], GOALS_CONTROL_DT, None, score_substeps,
            f_ext=batch), 5)
    elif b > 3:
        parts["scoring"] = graph_ms(lambda: sim_step(
            model, x0.expand(b, nx), U[:, 0], GOALS_CONTROL_DT, batch,
            settings.integrator_type), 5)
    parts["rest"] = cycle_ms - sum(parts.values())
    log(f"[{tag}] {card}: the cycle's parts, each alone on the device (graph_ms, the loop's "
        f"first state, the solve warm-started): " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f" (rest: the cycle's {cycle_ms:.4f} ms less the others: goal bookkeeping, the "
        f"estimator, the copies around the replays)")
    return parts


def iiwa14_variants(card, f, prob, s0):
    """[variant] lines of bsqp_iter for iiwa14 (shared memory, blocks per
    SM, ptxas' registers and spills) at N=32 and the shared layout's last
    N, the library's shared-memory count held to ops/cuda_iter.py's at
    every N, and each variant's device ms at f's input (graph_ms, two
    rounds in opposite orders). Returns {variant: ms}."""
    nx = f.model.nx
    bad = [(n, v) for n in range(2, 129) for v in IIWA_VARIANTS
           if v[1] * 32 * ((n + 31) // 32) <= cuda_iter.MAX_THREADS
           and variant_resources("bsqp_iter", n, *v, robot=IIWA)[0] != smem_bytes(n, *v, nx)]
    if bad:
        raise RuntimeError(f"bsqp_iter ({IIWA}): smem_bytes differs from the library at {bad[:4]}")
    px = ptxas_variants("bsqp_iter", IIWA)
    for n in (N, cuda_iter.SHARED_MAX_N):
        for v in IIWA_VARIANTS:
            if v[1] * 32 * ((n + 31) // 32) > cuda_iter.MAX_THREADS:
                continue
            nb, per_sm = variant_resources("bsqp_iter", n, *v, robot=IIWA)
            taken = " (the variant N takes)" if iteration_variant(n, nx) == v else ""
            log(f"[variant] bsqp_iter {IIWA} N={n} {v[0]} layout G={v[1]} phase A one{taken}: "
                f"{nb} bytes of shared memory, {per_sm} blocks per SM, "
                f"{v[1] * 32 * ((n + 31) // 32)} threads; ptxas: {px[v + ('one',)]}")
    rounds = {v: [] for v in IIWA_VARIANTS}
    for order in (IIWA_VARIANTS, IIWA_VARIANTS[::-1]):
        for v in order:
            rounds[v].append(graph_ms(lambda: sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings,
                                                            seeded=False, variant=v), 20))
    ms = {v: statistics.mean(r) for v, r in rounds.items()}
    log(f"[layout] {card}: bsqp_iter {IIWA} N={f.N} B={f.B}, ms per launch on the device "
        f"(graph_ms, two rounds): " + ", ".join(
            f"{v[0]} G={v[1]} {ms[v]:.4f} {[round(t, 4) for t in rounds[v]]}"
            for v in IIWA_VARIANTS)
        + f"; the variant N takes: {iteration_variant(f.N, nx)}")
    return ms


def iiwa14_staged_phase(dev, card, f, state, i0):
    """[iiwa14-staged]: the kkt and pcg kernels built for iiwa14, held as
    indy7's are, at N=32 B=512 (f's fig-8 steady state, [iiwa14-kernels])
    and N=256 B=64 (IIWA_LONG): compare_kkt (iiwa14's one-thread kernel, its
    only variant) and compare_pcg (every variant that fits; the counts
    equal on identical assembled systems, lam within plain32's own distance
    from float64), each variant's [variant] line; device, wrapper-call and
    plain ms with bounds from the run's inputs and pcg's torch.linalg.solve
    yardstick; pcg timed in every variant where iiwa14's cut points fall
    (IIWA_PCG_EDGES). Then the staged route, K_LONG cycles from each steady
    state: iter_kernel="off" at N=32, "auto" at N=256, each cycle launching
    kkt, pcg, merit and rk4 and nothing else (held), and at N=256 lane 0's
    tracking within TRACK_REL of the plain route's (long_tracking). Returns
    the kernels line's iiwa14 numbers of kkt and pcg, at N=32 B=512."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report_kkt_variants(sms, IIWA)
    nq = f.model.nq
    stats, ops = generated_stats(IIWA), plant_ops(nq)
    mpcg = P["max_pcg_iters"]
    fl = Fig8(dev, *IIWA_LONG, IIWA)
    state_l, i0_l = fl.steady_state()
    line = {}
    for fx, (X, U, lam, x_s), i in ((f, state, i0), (fl, state_l, i0_l)):
        ref = fx.ref(i - 1)
        kkt_p, kkt_err = compare_kkt(fx, X, U, x_s, ref)
        report_pcg_variants(fx.N, fx.B, sms, 2 * nq)
        system, skip, res = compare_pcg(fx, kkt_p, lam)
        reps = 20 if fx.N == N else 5
        t = dict(kkt=(lambda: setup_kkt_batched_cuda(fx.model, fx.cp, X, U, x_s, ref,
                                                     fx.f_ext, DT),
                      lambda: setup_kkt_batched(fx.model, fx.cp, X, U, x_s, ref, fx.f_ext, DT)),
                 pcg=(lambda: pcg_solve_batched_cuda(*system, mpcg, skip),
                      lambda: pcg_solve_batched(*system, mpcg, skip)))
        times = {n: (graph_ms(kf, reps), event_ms(kf, reps), event_ms(pf, 1))
                 for n, (kf, pf) in t.items()}
        # the yardstick without its singularity check: at N=256 a lane's
        # dense float32 matrix can come out singular to LU (torch.linalg.
        # solve raises, and would read the device)
        S_dense = dense_btd(system[0], system[1])
        library_ms = event_ms(lambda: torch.linalg.solve_ex(
            S_dense, system[4].reshape(fx.B, -1, 1)), 3)
        del S_dense
        vec = torch.empty(fx.B, device=dev)
        bounds = dict(
            kkt=bound(fx.B * fx.N * stats["knot_kkt"][0],
                      nbytes(X, U, ref[..., :3], fx.f_ext)
                      + nbytes(*(getattr(kkt_p, n) for n in KKT_FIELDS))),
            pcg=bound(fx.B * fx.N * ops["pcg_setup"] + fx.N * ops["pcg_iter"] * res["iters_sum"],
                      nbytes(*system, skip) + nbytes(lam) + nbytes(vec)))
        log(f"[timing] {card}: {IIWA} N={fx.N} B={fx.B}, ms per call, kernel on the device "
            f"(graph_ms) / per wrapper call (CUDA events) / plain version: "
            + ", ".join(f"{n} {d:.4f} / {w:.4f} / {p:.3f}" for n, (d, w, p) in times.items())
            + f"; pcg library yardstick torch.linalg.solve_ex on the dense ({fx.N * 2 * nq})^2 "
            f"Schur matrix {library_ms:.3f} ms; PCG iterations mean {res['iters_mean']:.2f}, "
            f"max {res['iters_max']}, at the cap {res['at_cap_frac']:.4f}")
        taken = dict(kkt=cuda_kkt.DEFAULT[IIWA], pcg=pcg_variant(fx.N, 2 * nq))
        for n in ("kkt", "pcg"):
            log(f"[bound] {n} {IIWA} N={fx.N} B={fx.B} ({taken[n]}): "
                f"{times[n][0]:.4f} ms on the card, bound {bounds[n][0]:.5f} ms by "
                f"{bounds[n][1]} ({bounds[n][0] / times[n][0]:.4f} of the bound reached)")
        if fx is f:
            errs = dict(kkt=kkt_err, pcg=res["lam_max_abs_err"])
            line = {n: dict(max_abs_err=errs[n], ms=times[n][0], wrapper_ms=times[n][1],
                            plain_ms=times[n][2], bound_ms=bounds[n][0], bound_by=bounds[n][1])
                    for n in ("kkt", "pcg")}
            line["pcg"]["library_ms"] = library_ms
    for n in IIWA_PCG_EDGES:
        fe = Fig8(dev, n, B, IIWA)
        (Xe, Ue, lame, xse), i0_e = fe.steady_state()
        kkt_e = setup_kkt_batched(fe.model, fe.cp, Xe, Ue, xse, fe.ref(i0_e - 1), fe.f_ext, DT)
        sch_e = build_schur(kkt_e, fe.hp.rho, nq)
        report_pcg_variants(n, B, sms, 2 * nq)
        time_pcg(n, B, (sch_e.S_main, sch_e.S_lower, sch_e.P_main, sch_e.P_lower, sch_e.gamma,
                        lame, fe.hp.pcg_tol),
                 torch.zeros(B, dtype=torch.bool, device=dev), card, 10)
        del fe, kkt_e, sch_e
    # the staged route, K_LONG cycles from each steady state
    iters = P["max_sqp_iters"]
    want = dict(bsqp_iter=0, iter=0, kkt=K_LONG * iters, pcg=K_LONG * iters,
                merit=K_LONG * iters, rk4=K_LONG)
    for fx, st, i, gates in ((f, state, i0, ("off", "off")),
                             (fl, state_l, i0_l, ("auto", "auto"))):
        if select_route(*gates, fx.N, True) != "staged":
            raise RuntimeError(f"gates {gates} at N={fx.N} did not take the staged route")
        reset_launches()
        st_k, ms_k, err_k, pcg_k, step_k = fx.run(st, i, fx.solver(fx.settings_with(*gates)),
                                                  fx.plant_kernel, K_LONG)
        got = launches()
        finite = bool(torch.isfinite(st_k[0]).all())
        med = statistics.median(ms_k)
        log(f"[iiwa14-staged] {card}: {IIWA} N={fx.N} B={fx.B} route {gates} (staged) over "
            f"{K_LONG} cycles: launches {got}; per-cycle median {med:.3f} ms (CUDA events, "
            f"{fx.B / (med / 1e3):.1f} solves/s); lane 0 mean EE error "
            f"{err_k.mean().item():.5f} m; states finite {finite}; work "
            f"{json.dumps(work_trace(pcg_k, step_k))}")
        if got != want or not finite:
            raise RuntimeError(f"[iiwa14-staged] N={fx.N}: launches {got} (expected {want}) or "
                               "a non-finite trajectory")
        line.setdefault("route_ms", {})[fx.N] = med
    long_tracking(fl, state_l, i0_l, err_k)
    return line


def iiwa14_kernels_phase(dev, card, pend):
    """[iiwa14-kernels]: bsqp_iter, iter, merit and rk4 built for iiwa14,
    each held to its plain version on identical float32 inputs from
    iiwa14's fig-8 steady state (bench.py --plant iiwa14:
    DEFAULT_SOLVER_PARAMS, the elbow-bent start, the fig-8 centred on its
    EE, wrench hypotheses +-5 with lane 0 zero), with indy7's holds:
    compare_iteration at IIWA_CHECKS (the long horizons with noise_limits),
    compare_core and compare_merit at N=32 B=512, compare_rk4 in both
    variants at B=1 and B=512 with and without a wrench; rk4 for the
    pendulum plants (pendulum_rk4_phase). Then the variants' lines and
    times, and each
    kernel's device, wrapper-call and plain ms at N=32 B=512 (rk4 at B=1).
    Returns the numbers of the kernels line."""
    res = {}
    for n, b in IIWA_CHECKS:
        fc = Fig8(dev, n, b, IIWA)
        state_c, i0_c = fc.steady_state()
        res[n, b] = (fc, state_c, i0_c) + tuple(
            compare_iteration(fc, state_c, i0_c - 1, noise_floor=n > N))
        if (n, b) != (N, B):
            del fc, state_c
            res[n, b] = res[n, b][-1]
    f, state, i0, prob, s0, iter_res = res[N, B]
    X, U, lam, x_s = state
    ref = f.ref(i0 - 1)
    core_args, core_skip, core_ref, core_res = compare_core(f, state, i0 - 1)
    dzx, dzu = scrubbed(core_ref[0], core_ref[1])
    merit_args, merit_err = compare_merit(f, X, U, dzx, dzu, x_s, ref)
    xr, ur, rk4_err = compare_rk4(f, state)
    pend_res = pendulum_rk4_phase(pend, card)
    lay = iiwa14_variants(card, f, prob, s0)
    pi = ptxas_variants("iter", IIWA)[taken_variant(N, f.model.nx)]
    log(f"[variant] iter {IIWA} N={N} ({variant_name(N, f.model.nx)}, the variant N takes): "
        f"ptxas: {pi}")
    pm = ptxas_lines("merit", r"merit_(warps|one)_kernel", lambda m: m.group(1), IIWA)
    for v in cuda_merit.VARIANTS:
        log(f"[variant] merit {IIWA} {v}{' (the default)' if v == MERIT_DEFAULT else ''}: "
            f"{cuda_merit.blocks_per_sm(v, IIWA)} CTAs per SM; ptxas: {pm[v]}; spill stores "
            f"{spill_bytes(pm[v])} B a thread")
    px = ptxas_lines("rk4", RK4_PATTERN, rk4_variant_of, IIWA)
    for v in cuda_sim.VARIANTS:
        log(f"[variant] rk4 {IIWA} {v}{' (the default)' if v == cuda_sim.DEFAULT else ''}: "
            f"ptxas: {px[v]}")
    rk4_ms = time_in_rounds(
        cuda_sim.VARIANTS, lambda v: rk4_step_batched(f.model, xr, ur, DT, None, RK4_SUBSTEPS,
                                                      variant=v),
        200, card, f"rk4 {IIWA}", cuda_sim.DEFAULT)
    t = dict(
        bsqp_iter=(lambda: sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings, seeded=False),
                   lambda: sqp_iter_reference(f.model, f.cp, prob, s0, f.settings,
                                              seeded=False), 20),
        rk4=(lambda: rk4_step_batched(f.model, xr, ur, DT, None, RK4_SUBSTEPS),
             lambda: rk4_plain(f.model, xr, ur, DT, None, RK4_SUBSTEPS), 200),
        iter=(lambda: sqp_iter_core_cuda(f.model, f.cp, *core_args, core_skip, DT,
                                         P["max_pcg_iters"]),
              lambda: sqp_iter_core_reference(f.model, f.cp, *core_args, core_skip, DT,
                                              P["max_pcg_iters"]), 20),
        merit=(lambda: merit_alphas_batched_cuda(f.model, f.cp, *merit_args),
               lambda: merit_alphas_batched(f.model, f.cp, *merit_args), 50))
    times = {name: (graph_ms(kf, reps), event_ms(kf, reps), event_ms(pf, 3))
             for name, (kf, pf, reps) in t.items()}
    log(f"[timing] {card}: {IIWA}, ms per call, kernel on the device (graph_ms) / per wrapper "
        f"call (CUDA events) / plain version (N={N}, B={B}; rk4 at B=1): "
        + ", ".join(f"{n} {d:.4f} / {w:.4f} / {p:.3f}" for n, (d, w, p) in times.items()))
    # bounds from this run's inputs, as the main path's
    stats = generated_stats(IIWA)
    ops = plant_ops(f.model.nq)
    vec = torch.empty(B, device=dev)
    A1 = f.settings.num_alphas + 1
    core_ops = B * N * (stats["knot_kkt"][0] + ops["schur"] + ops["dz"] + ops["pcg_setup"])
    merit_ops = B * A1 * N * (stats["knot_merit"][0] + ops["candidate"])
    ref3 = ref[..., :3]
    bounds = dict(
        bsqp_iter=bound(core_ops + N * ops["pcg_iter"] * iter_res["kernel_pcg_sum"] + merit_ops,
                        nbytes(X, U, lam, x_s, prob.ref[..., :3], f.f_ext) + 17 * nbytes(vec)
                        + nbytes(X, U, lam)),
        rk4=bound(RK4_SUBSTEPS * (4 * stats["fd"][0] + ops["rk4_axpy"]),
                  nbytes(xr, ur) + nbytes(xr)),
        iter=bound(core_ops + N * ops["pcg_iter"] * core_res["kernel_pcg_sum"],
                   nbytes(X, U, lam, x_s, ref3, f.f_ext) + 3 * nbytes(vec)
                   + nbytes(X, U, lam) + nbytes(vec)),
        merit=bound(merit_ops, nbytes(X, U, dzx, dzu, x_s, ref3, f.f_ext, vec) + B * A1 * 4))
    mhz = sm_max_clock_mhz()
    lat = {v: rk4_latency_bound(stats, mhz, v) for v in cuda_sim.VARIANTS}
    if lat[cuda_sim.DEFAULT][0] > bounds["rk4"][0]:
        bounds["rk4"] = (lat[cuda_sim.DEFAULT][0], "latency")
    for n in ("bsqp_iter", "rk4", "iter", "merit"):
        log(f"[bound] {n} {IIWA}: {times[n][0]:.4f} ms on the card, bound {bounds[n][0]:.5f} ms "
            f"by {bounds[n][1]} ({bounds[n][0] / times[n][0]:.4f} of the bound reached)"
            + (f"; latency per variant {', '.join(f'{v} {lat[v][0]:.5f} ms' for v in lat)}, "
               f"on the card {', '.join(f'{v} {rk4_ms[v][0]:.5f}' for v in rk4_ms)}"
               if n == "rk4" else ""))
    return f, state, i0, dict(
        errs=dict(bsqp_iter=iter_res["X_max_abs_err"], rk4=rk4_err,
                  iter=core_res["dZX_max_abs_err"], merit=merit_err), times=times,
        bounds=bounds, layouts=lay, pendulum=pend_res)


def rollout_iiwa14_phase(dev, card):
    """[rollout-iiwa14]: closed_loop_rollout with iiwa14 as solver and
    plant at N=32 B=512 toward a constant goal (REACH_*). Held: graph
    against eager over the first ROLLOUT_SAME cycles, the captured cycle's
    max_sqp_iters bsqp_iter and one rk4 launch, finite states, the last EE
    distance below REACH_MAX m."""
    model = load_robot(IIWA, torch.float32, dev)
    settings = BSQPSettings(N=N, max_sqp_iters=2, max_pcg_iters=40)
    cp = CostParams(**REACH_COST)
    hp = HyperParams.create(B, rho=0.01, mu=10.0, pcg_tol=1e-4, device=dev)
    q0 = torch.tensor(START[IIWA], dtype=torch.float32, device=dev)
    x0 = torch.cat([q0, torch.zeros_like(q0)])
    goal = fk(model, q0)[1][-1] + torch.tensor(REACH_OFFSET, device=dev)
    refs = torch.cat([goal, torch.zeros(3, device=dev)]).expand(REACH_STEPS, N, 6).contiguous()
    f_ext = torch.zeros(B, 6, device=dev)

    def call(graph):
        n = REACH_STEPS if graph else ROLLOUT_SAME
        return rollout_mod.closed_loop_rollout(model, model, settings, cp, hp, x0, refs[:n],
                                               f_ext, DT, REACH_CONTROL_DT, sim_substeps=2,
                                               graph=graph)

    (xs, ees, us), replay_ms, eager_ms, got = graph_against_eager(
        "rollout-iiwa14", call, dict(bsqp_iter=2, rk4=1), card)
    d = (ees - goal).norm(dim=1)
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(us).all())
    log(f"[rollout-iiwa14] {card}: closed_loop_rollout({IIWA}, N={N}, B={B}) toward a goal "
        f"{list(REACH_OFFSET)} m from the start EE over {REACH_STEPS} cycles (control_dt "
        f"{REACH_CONTROL_DT} s): EE distance at cycles 20, 40 and the last "
        f"{d[19].item():.5f}, {d[39].item():.5f}, {d[-1].item():.5f} m (limit {REACH_MAX} m on "
        f"the last); states finite {finite}; {replay_ms:.4f} ms a cycle from the graph, "
        f"{eager_ms:.3f} ms eager")
    if not (finite and d[-1].item() < REACH_MAX):
        raise RuntimeError("[rollout-iiwa14] failed")
    return dict(launches=got, ms=replay_ms)


def goals_iiwa14_phase(dev, card):
    """[rollout-goals-iiwa14]: examples/pickplace.py's device loop on the
    port (gato_tpu_torch.examples.pickplace_device: iiwa14 solver, iiwa14 +
    15 kg pendulum plant, the five goals, PICKPLACE_SOLVER_PARAMS, N=32,
    dt 0.03125, control_dt 2 ms, RK4-substepped scoring) at B=PICKPLACE_B
    over its 12,502 cycles. Held: graph against eager (five bsqp_iter
    launches and one rk4 launch a captured cycle: the pendulum plant on its
    generated rk4 library; five more bsqp_iter for the solve before the
    loop), finite states. Printed, not held: each goal's outcome and reach
    time. Then the cycle's parts (cycle_split)."""
    from gato_tpu_torch.examples import pickplace_device as pp

    model, sim, settings, cp, hp, x_sim0, goals = pp.pickplace_setup(PICKPLACE_B, N, dev)
    n_steps = pp.n_cycles(goals.shape[0], pp.PICKPLACE_MPC_DEFAULTS["goal_timeout"], 0.002)
    rows = {}

    def call(graph):
        k = n_steps if graph else ROLLOUT_SAME
        row, out = pp.run(PICKPLACE_B, N=N, n_steps=k, device=dev, graph=graph)
        rows[graph] = row
        return out

    iters = settings.max_sqp_iters
    out, replay_ms, eager_ms, got = graph_against_eager(
        "rollout-goals-iiwa14", call, dict(bsqp_iter=iters, rk4=1), card, before_loop=iters)
    finite = bool(torch.isfinite(out[0]).all())
    row = rows[True]
    log(f"[rollout-goals-iiwa14] {card}: {IIWA} solver, {sim.name} plant (15 kg, 0.3 m), "
        f"N={N} B={PICKPLACE_B}, {goals.shape[0]} goals, {n_steps} cycles at control_dt "
        f"0.002 s: outcomes {row['goal_outcomes']}, reached at {row['goal_reached_times']} s, "
        f"last distance {row['final_dist_m']} m, final force estimate "
        f"{row['force_estimate_end_N']} N; states finite {finite}; {replay_ms:.4f} ms a cycle "
        f"from the graph, {eager_ms:.3f} ms eager")
    if not finite:
        raise RuntimeError("[rollout-goals-iiwa14] failed")
    split = cycle_split("rollout-goals-iiwa14", model, sim, settings, cp, hp, x_sim0, goals[0],
                        PICKPLACE_B, 0.03125, replay_ms, card, 2)
    return dict(launches=got, ms=replay_ms, split=split)


def bench_iiwa14_phase(f, state, i0, card, kernel_times):
    """[bench-iiwa14]: the steady-state fig-8 cycle at iiwa14 N=32 B=512
    (solve, rk4 plant step of lane 0, roll the window: bench.py --plant
    iiwa14, BENCH_GRID_IIWA14.json's cell) over K cycles, launches counted
    from zero. Held: one bsqp_iter and one rk4 launch a cycle, a finite
    trajectory. Printed: cycle ms (median), solves/s, lane 0's tracking
    error and the kernels' device ms (graph_ms, [iiwa14-kernels]). Then
    the same K cycles on the fused-iteration route (solve_kernel="off":
    the iter and merit kernels, route_run), launches held."""
    reset_launches()
    state_k, ms_k, err_k, pcg_k, step_k = f.run(state, i0, f.solve_kernel, f.plant_kernel)
    got = launches()
    med = statistics.median(ms_k)
    log(f"[bench-iiwa14] {card}: {IIWA} N={f.N} B={f.B} fig-8 cycle median {med:.4f} ms "
        f"({f.B / (med / 1e3):.1f} solves/s) over {K} cycles (CUDA events); bsqp_iter "
        f"{kernel_times['bsqp_iter'][0]:.4f} ms and rk4 {kernel_times['rk4'][0]:.4f} ms on the "
        f"device (graph_ms); launches {got}; lane 0 mean EE error {err_k.mean().item():.4f} m; "
        f"work {json.dumps(work_trace(pcg_k, step_k))}")
    want = dict(bsqp_iter=K * P["max_sqp_iters"], rk4=K, iter=0, kkt=0, pcg=0, merit=0)
    if got != want or not torch.isfinite(state_k[0]).all():
        raise RuntimeError(f"[bench-iiwa14] launches {got} (expected {want}) or a non-finite "
                           "trajectory")
    solves = K * P["max_sqp_iters"]
    iter_got, iter_med = route_run(f, state, i0, ("off", "auto"),
                                   dict(iter=solves, merit=solves, rk4=K), card)
    return dict(launches=got, ms=med, iter_launches=iter_got, iter_ms=iter_med)


def iiwa14_phases(dev, card, pend):
    """The second plant and the pendulum plants: the kernels, the fig-8
    cycle on the default and the fused-iteration routes, the kkt and pcg
    kernels and the staged route, the rollouts."""
    f, state, i0, kern = iiwa14_kernels_phase(dev, card, pend)
    bench = bench_iiwa14_phase(f, state, i0, card, kern["times"])
    staged = iiwa14_staged_phase(dev, card, f, state, i0)
    del f, state
    rollout_iiwa14_phase(dev, card)
    goals = goals_iiwa14_phase(dev, card)
    return kern, bench, staged, goals


def fleet_phase(card):
    """[fleet]: the mixed indy7 + iiwa14 fleet through its example's entry
    point (gato_tpu_torch.examples.mixed_fleet.main, device_time=True) at
    each of FLEET_POINTS, the launch counts from 0 before each. Held: each
    member's solves and plant steps of the example's loop launch, a cycle,
    bsqp_iter (N <= 128) or kkt, pcg and merit (past it) of its plant once,
    and rk4 once, and nothing else; every solve's X and U finite; the
    fleet's graphed cycle equal to the eager one bit for bit (the example
    holds it) with both members' launches captured in it. Printed, not
    held: the fleet report and the tracking errors (the loop is chaotic),
    ms a graphed cycle. Returns {N: the example's record, with
    "launches_per_member"}."""
    from gato_tpu_torch.parallel import fleet as fleet_mod

    records = {}
    for n, b, cycles in FLEET_POINTS:
        counting = [True]
        per = {name: dict.fromkeys(WRAPPERS, 0) for name, *_ in mixed_fleet.SPECS}
        finite = []

        def counted(fn):
            def call(model, *a, **kw):
                before = launches()
                out = fn(model, *a, **kw)
                if counting[0]:
                    for k, v in launches().items():
                        per[model.name][k] += v - before[k]
                    if fn is solve_batched:
                        finite.append(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all())
                return out
            return call

        def timed(*a, **kw):  # the graphed cycle's launches are its own count
            counting[0] = False
            return graph_time(*a, **kw)

        graph_time = mixed_fleet.device_cycle_time
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(fleet_mod, "solve_batched", counted(solve_batched)), \
                mock.patch.object(mixed_fleet, "rk4_step", counted(rk4_step)), \
                mock.patch.object(mixed_fleet, "device_cycle_time", timed):
            out = mixed_fleet.main(cycles=cycles, B=b, N=n, device_time=True)
        secs = time.perf_counter() - t0
        route = select_route("auto", "auto", n, True)
        per_cycle = (dict(bsqp_iter=1, rk4=1) if route == "solve"
                     else dict(kkt=1, pcg=1, merit=1, rk4=1))
        want = {name: {k: cycles * per_cycle.get(k, 0) for k in WRAPPERS} for name in per}
        graph_want = {k: len(per) * per_cycle.get(k, 0) for k in WRAPPERS}
        all_finite = bool(torch.stack(finite).all())
        g = out["graph"]
        log(f"[fleet] {card}: indy7 + iiwa14, B={b} each, N={n} (route {route}), {cycles} "
            f"cycles in {secs:.1f} s: launches per member {per}; every solve finite "
            f"{all_finite}; the graphed cycle {g['ms_per_cycle']:.4f} ms "
            f"({out['lane_solves_per_s']} lane-solves/s), equal to the eager one bit for bit "
            f"{g['equal_to_eager']}, its launches {g['launches_per_cycle']}")
        log(f"[fleet] N={n} report (printed, not held): {json.dumps(out['final_report'])}; "
            f"tracking error over the last {cycles - cycles // 4} cycles (m): "
            f"{json.dumps(out['tracking_err_m'])}")
        if per != want or g["launches_per_cycle"] != graph_want or not all_finite:
            raise RuntimeError(f"[fleet] N={n}: launches per member {per} (expected {want}), "
                               f"graphed {g['launches_per_cycle']} (expected {graph_want}) "
                               f"or a non-finite solve")
        records[n] = dict(out, launches_per_member=per)
    return records


# ---- [sharded]: the batch split over ranks (gato_tpu_torch.parallel) ----
# the routes the sharded solve is held on at the main path's cell: "solve"
# and "iter" bit for bit (one CTA per problem, lanes independent; the rest
# of "iter" is elementwise or per-lane torch); "staged" within the
# iteration kernels' limits against their plain versions (STEP_SAME_MIN of
# the lanes with the same step and a PCG count within PCG_SLACK, X
# normwise within TRAJ_RTOL on them): its Schur build and dz are batched
# torch calls (ops/schur.py: batched matmul, Cholesky) whose library
# kernels may pick another algorithm by batch size
SHARD_ROUTES = (("solve", ("auto", "auto")), ("iter", ("off", "auto")),
                ("staged", ("off", "off")))
# the exit case (tests/test_sharding.py's scenario on the card, float32):
# indy7 at EXIT_N, B lanes of scaling_bench's problem under REACH_COST; the
# first half warm-started from the state just before its lanes converge
# (their first PCG then has no work: pcg_iters 0, converged), the second
# half under wrenches uniform in +-40; EXIT_ITERS SQP iterations at
# solve_ratio 0.5, so the exit fires on the global count at iteration 0,
# where the second half's rank alone would run on. The identical lanes
# converge together (exit_problem prints the iteration; past 40 on the
# card), so the probe runs up to EXIT_PROBE_ITERS
EXIT_N, EXIT_ITERS, EXIT_PROBE_ITERS = 8, 5, 80
# the sharded world of one (NCCL) against the plain solve in the closed
# loop, arms interleaved (plain, sharded, sharded, plain) OVERHEAD_ROUNDS
# times, K cycles an arm (tools/shardmap_overhead.py's cells at N=32)
OVERHEAD_CELLS, OVERHEAD_ROUNDS = ((N, 32), (N, B)), 2
# the all-reduce alone: calls timed back to back, and one call behind a
# kernel that spins for ALLREDUCE_SPIN cycles (about 0.1 s)
ALLREDUCE_REPS, ALLREDUCE_SPIN = 200, 200_000_000
# two ranks sharing the card over gloo: each rank's process (torchrun, this
# script's --sharded-worker) within SHARD_TIMEOUT s; the mixed fleet with
# --mesh at (N, B a member, cycles); scaling_bench at SCALING_B a rank
SHARD_RANKS, SHARD_TIMEOUT, NCCL_PROBE_TIMEOUT = 2, 300, 90
FLEET_MESH, SCALING_B, SCALING_K = (8, 8, 10), 256, 10
SOLVE_FIELDS = ("X", "U", "lam", "rho", "sqp_iters", "kkt_converged", "pcg_iters",
                "ls_min_merit", "ls_step_size", "initial_merit", "final_merit",
                "num_iters_run")


def solve_fields(out, mesh=None):
    """A solve's outputs by name, every rank's lanes gathered."""
    X, U, lam, hp, st = out
    st = sharding.gather_stats(mesh, st)
    d = dict(X=X, U=U, lam=lam, rho=hp.rho, **{k: getattr(st, k) for k in SOLVE_FIELDS[4:]})
    return {k: sharding.gather_batch(mesh, v) if k in ("X", "U", "lam", "rho") else v
            for k, v in d.items()}


def sharded_solve(mesh, model, settings, cp, hp, X, U, lam, x_s, ref, f_ext):
    """solve_batched_sharded on this rank's lanes of the whole batch."""
    X, U, lam, x_s, ref, f_ext, hp = sharding.shard_solve_args(mesh, X, U, lam, x_s, ref,
                                                              f_ext, hp)
    return sharding.solve_batched_sharded(model, settings, cp, hp, X, U, lam, x_s, ref, f_ext,
                                          DT, mesh=mesh)


def same_solve(got, want, exact):
    """(held, reading) of a sharded solve against the unsharded one: every
    output equal bit for bit, or (exact False) the staged route's limits."""
    diff = {k: float((got[k].double() - want[k].double()).abs().max()) for k in SOLVE_FIELDS}
    bits = all(torch.equal(got[k], want[k]) for k in SOLVE_FIELDS)
    if exact:
        return bits, f"equal bit for bit {bits}; largest differences {diff}"
    step_same = got["ls_step_size"][0] == want["ls_step_size"][0]
    pcg_near = (got["pcg_iters"][0] - want["pcg_iters"][0]).abs() <= PCG_SLACK
    lanes_ok = step_same & pcg_near
    share = float(lanes_ok.float().mean())
    traj = normwise(got["X"][lanes_ok], want["X"][lanes_ok])
    held = share >= STEP_SAME_MIN and traj <= TRAJ_RTOL
    return held, (f"equal bit for bit {bits}; lanes with the same step and PCG within "
                  f"{PCG_SLACK}: {share:.4f} (limit {STEP_SAME_MIN}), X normwise there "
                  f"{traj:.3e} (limit {TRAJ_RTOL}); largest differences {diff}")


def exit_problem(dev):
    """The exit case's (model, settings, cp, hp, (X, U, lam, x_s, ref,
    f_ext)) on dev (EXIT_N, B; the constants' comment)."""
    model = load_robot("indy7", torch.float32, dev)
    cp = CostParams(**REACH_COST)
    hp = HyperParams.create(B, rho=0.01, mu=10.0, pcg_tol=1e-4, device=dev)
    X, U, lam, x_s, ref, f_ext = scaling_bench._problem(B, EXIT_N, model, dev)
    probe = solve_batched(model, BSQPSettings(N=EXIT_N, max_sqp_iters=EXIT_PROBE_ITERS,
                                              max_pcg_iters=100),
                          cp, hp, X, U, lam, x_s, ref, f_ext, DT)[4]
    if not bool(probe.kkt_converged.all()):
        raise RuntimeError(f"[sharded] the exit case's lanes did not converge in "
                           f"{EXIT_PROBE_ITERS} iterations")
    k = int(probe.sqp_iters[0]) - 1  # the lanes are identical
    log(f"[sharded] the exit case's identical lanes converge at SQP iteration {k + 1} "
        f"(PCG with no work); the first half starts from the state after {k}")
    Xw, Uw, lamw, hpw, _ = solve_batched(model, BSQPSettings(N=EXIT_N, max_sqp_iters=k,
                                                             max_pcg_iters=100),
                                         cp, hp, X, U, lam, x_s, ref, f_ext, DT)
    half = B // 2
    X, U, lam, rho = X.clone(), U.clone(), lam.clone(), hp.rho.clone()
    X[:half], U[:half], lam[:half], rho[:half] = Xw[:half], Uw[:half], lamw[:half], hpw.rho[:half]
    f_ext = f_ext.clone()
    f_ext[half:] = torch.tensor(np.random.default_rng(5).uniform(-40, 40, (B - half, 6)),
                                dtype=torch.float32, device=dev)
    settings = BSQPSettings(N=EXIT_N, max_sqp_iters=EXIT_ITERS, max_pcg_iters=100,
                            solve_ratio=0.5)
    return model, settings, cp, HyperParams(rho, hp.drho, hp.mu, hp.pcg_tol), \
        (X, U, lam, x_s, ref, f_ext)


def overhead(card, dev):
    """tools/shardmap_overhead.py on the card: at each OVERHEAD_CELLS the
    closed loop's cycle with the plain solve and with the sharded solve of
    a world of one (its collectives: the count's and the iterations' all
    reduces), arms interleaved; the per-iteration cost of the collectives
    is the difference of the medians over max_sqp_iters."""
    mesh = sharding.make_mesh()
    # one all-reduce of a scalar (Mesh.all_reduce: a copy and the NCCL call):
    # the host's time a call, back to back and behind a long kernel (does
    # the host wait for the card?), and the card's time a call
    x = torch.ones((), device=dev)
    for _ in range(5):
        mesh.all_reduce(x, "sum")
    torch.cuda.synchronize()
    torch.cuda._sleep(ALLREDUCE_SPIN)
    t0 = time.perf_counter()
    mesh.all_reduce(x, "sum")
    behind_ms = (time.perf_counter() - t0) * 1e3
    still_busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        mesh.all_reduce(x, "sum")
    host_ms = (time.perf_counter() - t0) * 1e3 / ALLREDUCE_REPS
    torch.cuda.synchronize()
    device_ms = event_ms(lambda: mesh.all_reduce(x, "sum"), ALLREDUCE_REPS)
    log(f"[sharded] {card}: one all-reduce of a scalar in the NCCL world of one: "
        f"{host_ms:.4f} ms of host time a call ({ALLREDUCE_REPS} back to back), "
        f"{device_ms:.4f} ms a call on the card (CUDA events); behind a long kernel the call "
        f"returned in {behind_ms:.3f} ms with the kernel still running {still_busy} ("
        + ("the host does not wait for the card)" if still_busy else "the host waited)"))
    rows = {}
    for n, b in OVERHEAD_CELLS:
        fo = Fig8(dev, n, b)
        state, i0 = fo.steady_state()

        def solve_sharded(X, U, lam, x_s, ref, fo=fo):
            Xo, Uo, lamo, _, st = sharded_solve(mesh, fo.model, fo.settings, fo.cp, fo.hp, X,
                                                U, lam, x_s, ref, fo.f_ext)
            return Xo, Uo, lamo, st.pcg_iters[0], st.ls_step_size[0]

        arms = {"plain": fo.solve_kernel, "sharded": solve_sharded}
        meds = {k: [] for k in arms}
        for _ in range(OVERHEAD_ROUNDS):
            for arm in ("plain", "sharded", "sharded", "plain"):
                meds[arm].append(statistics.median(fo.run(state, i0, arms[arm],
                                                          fo.plant_kernel)[1]))
        p, s = statistics.median(meds["plain"]), statistics.median(meds["sharded"])
        per_iter = (s - p) / P["max_sqp_iters"]
        rows[(n, b)] = dict(plain=meds["plain"], sharded=meds["sharded"], per_iter=per_iter)
        log(f"[sharded] {card}: the collectives' cost in the closed loop, indy7 N={n} B={b}, "
            f"NCCL world of one against the plain solve, {OVERHEAD_ROUNDS} rounds of plain / "
            f"sharded / sharded / plain, {K} cycles an arm (CUDA events): median cycle plain "
            f"{p:.4f} ms, sharded {s:.4f} ms; {per_iter * 1e3:.1f} us an SQP iteration "
            f"(per-arm medians: plain {[round(v, 4) for v in meds['plain']]}, sharded "
            f"{[round(v, 4) for v in meds['sharded']]})")
        del fo, state
    return rows


def sharded_world_of_one(f, state, i0, card, dev, exit_case):
    """The sharded solve in a world of one over NCCL, in this process:
    every route at the main path's cell against the unsharded solve, the
    exit case, best_lane, then overhead(). Returns the unsharded solves
    ({route: fields}, the exit case's fields), on the host."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{sharding.free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh()
        X, U, lam, x_s = state
        ref = f.ref(i0)
        plain = {}
        for route, gates in SHARD_ROUTES:
            st = f.settings_with(*gates)
            want = solve_fields(solve_batched(f.model, st, f.cp, f.hp, X, U, lam, x_s, ref,
                                              f.f_ext, DT))
            reset_launches()
            got_out = sharded_solve(mesh, f.model, st, f.cp, f.hp, X, U, lam, x_s, ref, f.f_ext)
            counts = launches()
            got = solve_fields(got_out, mesh)
            held, reading = same_solve(got, want, exact=route != "staged")
            log(f"[sharded] world of one (NCCL), route {route}, indy7 N={N} B={B}: launches "
                f"{counts}; against the unsharded solve: {reading}")
            if not held:
                raise RuntimeError(f"[sharded] route {route}: the sharded solve differs")
            if route == "solve":
                b_got = int(sharding.best_lane(got_out[4].final_merit, mesh))
                m = want["final_merit"]
                b_want = int(torch.argmin(torch.where(torch.isfinite(m), m, torch.inf)))
                log(f"[sharded] best_lane {b_got}, the unsharded merits' argmin {b_want}")
                if b_got != b_want:
                    raise RuntimeError("[sharded] best_lane differs from the unsharded argmin")
            plain[route] = {k: v.cpu() for k, v in want.items()}
        model, st, cp, hp, args = exit_case
        want = solve_fields(solve_batched(model, st, cp, hp, *args, DT))
        reset_launches()
        got = solve_fields(sharded_solve(mesh, model, st, cp, hp, *args), mesh)
        counts = launches()
        held, reading = same_solve(got, want, exact=True)
        fired = int(want["num_iters_run"]) < EXIT_ITERS
        log(f"[sharded] world of one, the exit case (indy7 N={EXIT_N} B={B}, {EXIT_ITERS} SQP "
            f"iterations, solve_ratio 0.5): iterations run {int(got['num_iters_run'])} "
            f"(unsharded {int(want['num_iters_run'])}), converged "
            f"{int(got['kkt_converged'].sum())} of {B}; launches {counts}; {reading}")
        if not (held and fired):
            raise RuntimeError("[sharded] the exit case differs from the unsharded solve, or "
                               "its exit did not fire")
        overhead(card, dev)
    finally:
        dist.destroy_process_group()
    return plain, {k: v.cpu() for k, v in want.items()}


def nccl_two_ranks_probe(card):
    """Two NCCL ranks on the one card (--nccl-probe): NCCL refuses them,
    so the ranks sharing a card take gloo. Printed, not held."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={SHARD_RANKS}", os.path.abspath(__file__), "--nccl-probe"]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=NCCL_PROBE_TIMEOUT)
        what, text = f"exit code {r.returncode}", r.stdout + r.stderr
    except subprocess.TimeoutExpired as e:
        what = f"no end within {NCCL_PROBE_TIMEOUT} s (killed)"
        text = "".join(o.decode(errors="replace") if isinstance(o, bytes) else (o or "")
                       for o in (e.stdout, e.stderr))
    lines = [ln.strip() for ln in text.splitlines() if re.search(
        r"Error|Duplicate|ncclInvalidUsage|probe:", ln)]
    log(f"[sharded] {card}: two NCCL ranks on one card: {what} after "
        f"{time.perf_counter() - t0:.1f} s; {' | '.join(dict.fromkeys(lines))[-1500:]}")


def nccl_probe_rank():
    """One rank of nccl_two_ranks_probe: an NCCL all-reduce with every rank
    on cuda:0."""
    dist.init_process_group("nccl")
    torch.cuda.set_device(0)
    t = torch.ones(1, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"probe: NCCL all-reduce on one card gave {t.item()}", flush=True)
    dist.destroy_process_group()
    return 0


def sharded_worker(path):
    """One rank of the two gloo ranks sharing the card (--sharded-worker,
    under torchrun): the main cell on "solve" and "iter", the exit case,
    the mixed fleet with --mesh and scaling_bench, each rank's launches of
    each counted; rank 0 saves what it gathered to path/out.pt."""
    made = sharding.init_from_env("cuda")
    try:
        mesh = sharding.make_mesh()
        inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
        model = load_robot("indy7", torch.float32, mesh.device)
        dev = mesh.device
        args = [t.to(dev) for t in inp["main"]]
        hp = HyperParams(*(t.to(dev) for t in inp["main_hp"]))
        cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                             "q_lim_cost", "vel_lim_cost", "ctrl_lim_cost")})
        out, counts = {}, {}
        for route, gates in SHARD_ROUTES[:2]:
            st = BSQPSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                              max_pcg_iters=P["max_pcg_iters"], solve_ratio=P["solve_ratio"],
                              solve_kernel=gates[0], iter_kernel=gates[1])
            reset_launches()
            got = solve_fields(sharded_solve(mesh, model, st, cp, hp, *args), mesh)
            counts[route] = launches()
            out[route] = {k: v.cpu() for k, v in got.items()}
        ex = [t.to(dev) for t in inp["exit"]]
        ex_hp = HyperParams(*(t.to(dev) for t in inp["exit_hp"]))
        st = BSQPSettings(N=EXIT_N, max_sqp_iters=EXIT_ITERS, max_pcg_iters=100,
                          solve_ratio=0.5)
        reset_launches()
        got = solve_fields(sharded_solve(mesh, model, st, CostParams(**REACH_COST), ex_hp, *ex),
                           mesh)
        counts["exit"] = launches()
        out["exit"] = {k: v.cpu() for k, v in got.items()}
        n, b, cycles = FLEET_MESH
        reset_launches()
        out["fleet"] = mixed_fleet.cli(["--mesh", "--N", str(n), "--B", str(b),
                                        "--cycles", str(cycles)])
        counts["fleet"] = launches()
        out["scaling"] = scaling_bench.run(per_rank_batch=SCALING_B, N=N, k=SCALING_K)
        every = mesh.all_gather(torch.tensor([[counts[c][w] for c in counts for w in WRAPPERS]],
                                             device=dev))
        out["launches"] = [{c: {w: int(row[i * len(WRAPPERS) + j])
                                for j, w in enumerate(WRAPPERS)}
                            for i, c in enumerate(counts)} for row in every.cpu()]
        out["backend"] = dist.get_backend()
        if mesh.rank == 0:
            torch.save(out, os.path.join(path, "out.pt"))
    finally:
        if made:
            dist.destroy_process_group()
    return 0


def sharded_phase(f, state, i0, card, dev):
    """[sharded]: the batch split over ranks. In this process a world of
    one over NCCL (sharded_world_of_one); NCCL with two ranks on the one
    card (nccl_two_ranks_probe); then two ranks sharing the card over gloo
    (torchrun, sharded_worker), each solving its half of the same global
    inputs, held against this process's unsharded solves: the main path's
    cell on "solve" and "iter" and the exit case bit for bit, the mixed
    fleet with --mesh equal to the unsharded fleet (its report and
    tracking errors), each rank's launches; scaling_bench at one and two
    ranks printed. A rank that fails or does not end in SHARD_TIMEOUT
    fails the phase."""
    t0 = time.perf_counter()
    exit_case = exit_problem(dev)
    model, st, cp, hp, ex_args = exit_case
    plain, plain_exit = sharded_world_of_one(f, state, i0, card, dev, exit_case)
    half = B // 2
    alone = [int(solve_batched(model, st, cp, HyperParams(*(t[s] for t in (
        hp.rho, hp.drho, hp.mu, hp.pcg_tol))), *(a[s] for a in ex_args), DT)[4].num_iters_run)
        for s in (slice(0, half), slice(half, B))]
    log(f"[sharded] the exit case's halves alone: {alone[0]} and {alone[1]} iterations run "
        f"(the whole batch: {int(plain_exit['num_iters_run'])}): the two ranks' local counts "
        f"would decide differently")
    if alone[0] == alone[1]:
        raise RuntimeError("[sharded] the exit case does not tell a global exit from a local one")
    nccl_two_ranks_probe(card)
    n, b, cycles = FLEET_MESH
    fleet_plain = mixed_fleet.main(cycles=cycles, B=b, N=n)
    X, U, lam, x_s = state
    with tempfile.TemporaryDirectory(prefix="gato_sharded_") as tmp:
        torch.save(dict(main=[t.cpu() for t in (X, U, lam, x_s, f.ref(i0), f.f_ext)],
                        main_hp=[t.cpu() for t in (f.hp.rho, f.hp.drho, f.hp.mu, f.hp.pcg_tol)],
                        exit=[t.cpu() for t in ex_args],
                        exit_hp=[t.cpu() for t in (hp.rho, hp.drho, hp.mu, hp.pcg_tol)]),
                   os.path.join(tmp, "inputs.pt"))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={SHARD_RANKS}", os.path.abspath(__file__),
               "--sharded-worker", tmp]
        t1 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=SHARD_TIMEOUT)
        if r.returncode != 0 or not os.path.exists(os.path.join(tmp, "out.pt")):
            log((r.stdout + r.stderr)[-4000:])
            raise RuntimeError(f"[sharded] the two gloo ranks failed (exit code {r.returncode})")
        got = torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
    ranks_s = time.perf_counter() - t1
    log(f"[sharded] two ranks sharing the card over {got['backend']} (torchrun, "
        f"{ranks_s:.1f} s for both processes); launches of each rank: {got['launches']}")
    for route in ("solve", "iter"):
        held, reading = same_solve(got[route], plain[route], exact=True)
        log(f"[sharded] two gloo ranks, route {route}, indy7 N={N} B={B}: against the unsharded "
            f"solve: {reading}")
        if not held:
            raise RuntimeError(f"[sharded] two ranks, route {route}: the lanes differ")
    held, reading = same_solve(got["exit"], plain_exit, exact=True)
    log(f"[sharded] two gloo ranks, the exit case: iterations run "
        f"{int(got['exit']['num_iters_run'])} (unsharded {int(plain_exit['num_iters_run'])}); "
        f"{reading}")
    if not held:
        raise RuntimeError("[sharded] two ranks: the exit case differs from the unsharded solve")
    fl = got["fleet"]
    same_fleet = (fl["final_report"] == fleet_plain["final_report"]
                  and fl["tracking_err_m"] == fleet_plain["tracking_err_m"])
    log(f"[sharded] the mixed fleet with --mesh over two ranks (indy7 + iiwa14, N={n}, B={b} "
        f"each, {cycles} cycles; mesh {fl['mesh']}): report and tracking errors equal to the "
        f"unsharded fleet's {same_fleet}; winner {fl['final_report']['winner']}, tracking "
        f"{fl['tracking_err_m']}")
    # each rank's launches: its solves' kernels; the fleet's plant steps on
    # rank 0 alone, which holds lane 0
    iters = P["max_sqp_iters"]
    want = [dict(solve=dict(bsqp_iter=iters), iter=dict(iter=iters, merit=iters),
                 exit=dict(bsqp_iter=int(plain_exit["num_iters_run"])),
                 fleet=dict(bsqp_iter=2 * cycles * iters, rk4=2 * cycles if rank == 0 else 0))
            for rank in range(SHARD_RANKS)]
    counts_ok = all(got["launches"][rank][case] == {w: want[rank][case].get(w, 0)
                                                    for w in WRAPPERS}
                    for rank in range(SHARD_RANKS) for case in want[rank])
    if not (same_fleet and counts_ok and fl["mesh"] == SHARD_RANKS):
        raise RuntimeError(f"[sharded] the fleet with --mesh differs from the unsharded one, or "
                           f"the ranks' launches {got['launches']} are not {want}")
    sc = got["scaling"]
    log(f"[sharded] {card}: scaling_bench over gloo ranks sharing the card (the sharded "
        f"program's overhead, not hardware scaling), indy7 N={N}, {SCALING_B} lanes a rank, "
        f"{SCALING_K} chained solves: " + "; ".join(
            f"{k} rank(s) B={v['batch']}: {v['ms']:.4f} ms a solve, {v['solves_per_s']:.1f} "
            f"solves/s, efficiency {v['efficiency']:.4f}" for k, v in sc.items()))
    log(f"[sharded] done in {time.perf_counter() - t0:.1f} s")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save-capped", metavar="PATH",
                        help="only build the kernels and save the N=64 cap lanes' Schur "
                             "system to PATH (save_capped_schur), then stop")
    parser.add_argument("--fusion-probe", action="store_true",
                        help="only build csrc/rk4.cu with and without multiply-add "
                             "fusion and print how far its variants differ "
                             "(fusion_probe), then stop")
    parser.add_argument("--rollouts", action="store_true",
                        help="only build the kernels, hold rk4's wrench branch and run the "
                             "rollout, estimator, goals and runner phases, then stop")
    parser.add_argument("--estimator-witness", action="store_true",
                        help="only build the kernels and run the sphere search at N=32 "
                             "B=512 on the kernel and the plain route (estimator_witness), "
                             "then stop")
    parser.add_argument("--iiwa14", action="store_true",
                        help="only build the kernels and run the second plant's phases "
                             "(iiwa14_phases), then stop")
    parser.add_argument("--fleet", action="store_true",
                        help="only build the kernels and run the mixed fleet (fleet_phase), "
                             "then stop")
    parser.add_argument("--schur-inverse", action="store_true",
                        help="only build the kernels and time the staged cycle with the "
                             "Schur inverse in either form (schur_inverse_phase), then stop")
    parser.add_argument("--sharded", action="store_true",
                        help="only build the kernels and run the batch split over ranks "
                             "(sharded_phase), then stop")
    parser.add_argument("--sharded-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--nccl-probe", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tracking-spread", action="store_true",
                        help="only build the kernels and print the N=32 tracking gate "
                             "and step check on nearby inputs (tracking_spread), then stop")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is false")
    if args.sharded_worker:  # one rank of sharded_phase's two, under torchrun
        return sharded_worker(args.sharded_worker)
    if args.nccl_probe:  # one rank of nccl_two_ranks_probe's two
        return nccl_probe_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    if args.fusion_probe:
        fusion_probe(card)
        return 0
    pend, libs = build_kernels(dev)
    if args.save_capped:
        save_capped_schur(dev, args.save_capped)
        return 0
    if args.tracking_spread:
        tracking_spread(dev, card)
        return 0
    if args.estimator_witness:
        estimator_witness(dev, card)
        return 0
    if args.iiwa14:
        iiwa14_phases(dev, card, pend)
        return 0
    if args.fleet:
        fleet_phase(card)
        return 0
    if args.schur_inverse:
        schur_inverse_phase(dev, card)
        return 0
    if args.sharded:
        f = Fig8(dev)
        state, i0 = f.steady_state()
        sharded_phase(f, state, i0, card, dev)
        return 0
    if args.rollouts:
        f = Fig8(dev)
        state, i0 = f.steady_state()
        compare_rk4(f, state)
        rollout_phases(f, dev, card, statistics.median(
            f.run(state, i0, f.solve_kernel, f.plant_kernel)[1]))
        return 0
    for name, robot in libs:
        log(f"[build] ptxas {name} ({robot}):\n{_build.ptxas_report(name, robot).rstrip()}")
    stats = generated_stats()
    ops = {name: n for name, (n, _) in stats.items()}
    log(f"[bound] (operations, dependency depth) of the generated functions: {stats}")
    report_variants()
    check_pcg_smem_mirror()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report_pcg_variants(N, B, sms, 12)
    report_kkt_variants(sms, "indy7")
    report_rk4_merit_variants(sms)

    f = Fig8(dev)
    state, i0 = f.steady_state()
    torch.cuda.synchronize()
    log(f"[steady] {WARMUP} warm-up cycles done (indy7 N={N} B={B})")

    # ---- each kernel against its plain version, N=32 B=512 ----
    prob, s0, iter_res = compare_iteration(f, state, i0 - 1)
    xr, ur, rk4_err = compare_rk4(f, state)
    core_args, core_skip, core_ref, core_res = compare_core(f, state, i0 - 1)
    X, U, lam, x_s = state
    ref = f.ref(i0 - 1)
    kkt_p, kkt_err = compare_kkt(f, X, U, x_s, ref)
    pcg_sys, pcg_skip, pcg_res = compare_pcg(f, kkt_p, lam)
    pcg_same_bits_as_global(pcg_sys, pcg_skip)
    dzx, dzu = scrubbed(core_ref[0], core_ref[1])
    merit_args, merit_err = compare_merit(f, X, U, dzx, dzu, x_s, ref)

    # ---- the routes' cycles before any CUDA graph is captured ----
    harness = {}
    for gates in (("auto", "auto"), ("off", "auto"), ("off", "off")):
        ms_cycle = f.run(state, i0, f.solver(f.settings_with(*gates)), f.plant_kernel)[1]
        harness[gates] = statistics.median(ms_cycle)
    log(f"[harness] {card}: per-cycle median over {K} cycles before any graph_ms call, "
        f"N={N} B={B}: " + ", ".join(f"route {g} {m:.3f} ms" for g, m in harness.items()))

    mpcg = P["max_pcg_iters"]
    t = dict(
        bsqp_iter=(lambda: sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings,
                                         seeded=False),
                   lambda: sqp_iter_reference(f.model, f.cp, prob, s0, f.settings,
                                              seeded=False)),
        rk4=(lambda: rk4_step_batched(f.model, xr, ur, DT, None, 2),
             lambda: rk4_plain(f.model, xr, ur, DT, None, 2)),
        iter=(lambda: sqp_iter_core_cuda(f.model, f.cp, *core_args, core_skip,
                                         DT, mpcg),
              lambda: sqp_iter_core_reference(f.model, f.cp, *core_args, core_skip, DT,
                                              mpcg)),
        kkt=(lambda: setup_kkt_batched_cuda(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT),
             lambda: setup_kkt_batched(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT)),
        pcg=(lambda: pcg_solve_batched_cuda(*pcg_sys, mpcg, pcg_skip),
             lambda: pcg_solve_batched(*pcg_sys, mpcg, pcg_skip)),
        merit=(lambda: merit_alphas_batched_cuda(f.model, f.cp, *merit_args),
               lambda: merit_alphas_batched(f.model, f.cp, *merit_args)),
    )
    kernel_reps = dict(bsqp_iter=20, rk4=200, iter=20, kkt=20, pcg=20, merit=50)
    times = {name: (graph_ms(kf, kernel_reps[name]), event_ms(pf, 3))
             for name, (kf, pf) in t.items()}
    wrapped = {name: event_ms(kf, kernel_reps[name]) for name, (kf, _) in t.items()}
    S_dense = dense_btd(pcg_sys[0], pcg_sys[1])
    g_flat = pcg_sys[4].reshape(B, -1, 1)
    pcg_library_ms = event_ms(lambda: torch.linalg.solve(S_dense, g_flat), 3)
    del S_dense
    log(f"[timing] {card}: ms per call, kernel on the device (graph_ms) / per "
        f"wrapper call (CUDA events) / plain version (N={N}, B={B}; rk4 at B=1): "
        + ", ".join(f"{n} {k:.4f} / {wrapped[n]:.4f} / {p:.3f}" for n, (k, p) in times.items())
        + f"; pcg library yardstick torch.linalg.solve on the dense "
        f"({N * 12})^2 Schur matrix {pcg_library_ms:.3f} ms")

    # ---- the iteration kernels' layouts side by side, N=32 and N_WIDE ----
    same_bits_as_global(f, state, i0 - 1)
    lay = time_variants(f, state, i0 - 1, card)
    taken, one = lay[taken_variant(N)], lay[("shared", 4, "one")]
    log(f"[layout] N={N} B={B}: in the variant N takes ({variant_name(N)}) bsqp_iter "
        f"{taken['bsqp_iter']:.4f} ms against {one['bsqp_iter']:.4f} with the one-thread "
        f"phase A and {lay[('global', 1, 'one')]['bsqp_iter']:.4f} in the global layout in "
        f"this run; iter {taken['iter']:.4f} against {one['iter']:.4f} and "
        f"{lay[('global', 1, 'one')]['iter']:.4f} ms")
    fw = Fig8(dev, N_WIDE, B)
    state_w, i0_w = fw.steady_state()
    time_variants(fw, state_w, i0_w - 1, card)
    del fw, state_w

    # ---- kkt, rk4 and merit in every variant, N=32 B=512 (rk4 at B=1 and 512) ----
    time_kkt(f, X, U, x_s, ref, card, 20)
    x512, u512 = X[:, 0].contiguous(), U[:, 0].contiguous()
    rk4_ms = time_in_rounds(
        cuda_sim.VARIANTS, lambda v: rk4_step_batched(f.model, xr, ur, DT, None, RK4_SUBSTEPS,
                                                      variant=v),
        200, card, "rk4", cuda_sim.DEFAULT)
    time_in_rounds(cuda_sim.VARIANTS,
                   lambda v: rk4_step_batched(f.model, x512, u512, DT, None, RK4_SUBSTEPS,
                                              variant=v),
                   50, card, f"rk4 B={B}", cuda_sim.DEFAULT)
    time_in_rounds(
        cuda_merit.VARIANTS,
        lambda v: merit_alphas_batched_cuda(f.model, f.cp, *merit_args, variant=v),
        50, card, f"merit N={N} B={B}", MERIT_DEFAULT)

    # ---- pcg in every variant: N=32 B=512, and where shared meets cluster ----
    time_pcg(N, B, pcg_sys, pcg_skip, card, 10)
    for n in PCG_EDGE_HORIZONS:
        fe = Fig8(dev, n, B)
        (Xe, Ue, lame, xse), i0_e = fe.steady_state()
        kkt_e = setup_kkt_batched(fe.model, fe.cp, Xe, Ue, xse, fe.ref(i0_e - 1),
                                  fe.f_ext, DT)
        sch_e = build_schur(kkt_e, fe.hp.rho, 6)
        report_pcg_variants(n, B, sms, 12)
        time_pcg(n, B, (sch_e.S_main, sch_e.S_lower, sch_e.P_main, sch_e.P_lower,
                        sch_e.gamma, lame, fe.hp.pcg_tol),
                 torch.zeros(B, dtype=torch.bool, device=dev), card, 10)
        del fe, kkt_e, sch_e

    # ---- the main path: K cycles on the default route, launches counted ----
    reset_launches()
    state_k, ms_k, _, pcg_k, step_k = f.run(state, i0, f.solve_kernel,
                                                f.plant_kernel)
    main_launches = launches()
    solves = K * P["max_sqp_iters"]
    log(f"[main path] launches over {K} cycles: {main_launches} ({solves} solves)")
    if main_launches != dict(bsqp_iter=solves, rk4=K, iter=0, kkt=0, pcg=0, merit=0):
        raise RuntimeError(f"main path did not run through the kernels: {main_launches}")
    Xk = state_k[0]
    if Xk.shape != (B, N, 12) or not torch.isfinite(Xk).all():
        raise RuntimeError("main path produced a non-finite or misshapen trajectory")

    # the plain route over the gate's K_GATE cycles (its timing too)
    _, ms_p, err_p, _, _ = f.run(state, i0, f.solve_plain, f.plant_plain, K_GATE)

    med_k, med_p = statistics.median(ms_k), statistics.median(ms_p)
    log(f"[timing] {card}: per-cycle median {med_k:.3f} ms on the kernel route "
        f"({B / (med_k / 1e3):.1f} solves/s) over {K} cycles, {med_p:.3f} ms on the "
        f"plain route ({B / (med_p / 1e3):.1f} solves/s) over {K_GATE}; CUDA events, "
        f"indy7 N={N} B={B}")
    log(f"[work] 8-cycle trace (bench.py:227-243): {json.dumps(work_trace(pcg_k, step_k))}")

    # ---- the fused-iteration and the staged routes, K cycles each ----
    fused_l = route_run(
        f, state, i0, ("off", "auto"), dict(iter=solves, merit=solves, rk4=K), card)[0]
    staged_l = route_run(
        f, state, i0, ("off", "off"), dict(kkt=solves, pcg=solves, merit=solves, rk4=K),
        card)[0]
    for gates, earlier in ((("auto", "auto"), "the two-warp rk4 (crba)"),
                           (("auto", "auto"), "the one-thread phase A"),
                           (("off", "auto"), "the one-thread phase A"),
                           (("off", "auto"), "the one-thread merit"),
                           (("off", "off"), "the one-thread kkt"),
                           (("off", "off"), "the one-thread merit"),
                           (("off", "off"), "pcg in the global variant")):
        route_ab(f, state, i0, card, K, gates, earlier)
    # ---- the N=32 tracking gate: K_GATE cycles of each route from the
    # run's warm-up, read in GATE_WINDOWS disjoint windows ----
    if not gate_line(f"[tracking] {card}: N={N} B={B}, rk4 {cuda_sim.DEFAULT}, from the "
                     f"run's warm-up", gate_windows(f, state, i0), windows(err_p))[0]:
        raise RuntimeError("fig-8 tracking check failed")
    # the same gate with rk4's other variant as the plant of the warm-up and
    # of the kernel route (reported)
    tracking_spread(dev, card, warmups=(WARMUP,),
                    variants=[v for v in cuda_sim.VARIANTS if v != cuda_sim.DEFAULT])

    # ---- the port's API on the card: the BSQP facade, MPC_GATO's fig-8 and
    # goal loops ----
    facade_phase(f, state, i0, card)
    mpc_phase(card)
    goals_phase(card)
    # ---- the on-device rollouts, each cycle one CUDA graph ----
    goals = rollout_phases(f, dev, card, med_k)
    # ---- the second plant: iiwa14's kernels, rollouts and fig-8 cycle ----
    kern_i, bench_i, staged_i, goals_i = iiwa14_phases(dev, card, pend)
    # ---- the mixed indy7 + iiwa14 fleet, at N=8 and past 128 knots ----
    fleet_i = fleet_phase(card)
    # ---- the batch split over ranks: a world of one, two ranks on the card ----
    sharded_phase(f, state, i0, card, dev)

    # ---- a long horizon: N=256 B=64, where "auto" takes the staged route ----
    if select_route("auto", "auto", N_LONG, True) != "staged":
        raise RuntimeError("solve_kernel='auto' did not take the staged route at N=256")
    fl = Fig8(dev, N_LONG, B_LONG)
    state_l, i0_l = fl.steady_state()
    Xl, Ul, laml, xsl = state_l
    refl = fl.ref(i0_l - 1)
    kkt_pl, kkt_err_l = compare_kkt(fl, Xl, Ul, xsl, refl)
    long_kkt_ms = time_kkt(fl, Xl, Ul, xsl, refl, card, 10)[KKT_DEFAULT]
    long_kkt_plain_ms = event_ms(lambda: setup_kkt_batched(
        fl.model, fl.cp, Xl, Ul, xsl, refl, fl.f_ext, DT), 1)
    long_kkt_bound = bound(B_LONG * N_LONG * ops["knot_kkt"],
                           nbytes(Xl, Ul, refl[..., :3], fl.f_ext)
                           + nbytes(*(getattr(kkt_pl, n) for n in KKT_FIELDS)))
    log(f"[bound] kkt at N={N_LONG} B={B_LONG} ({KKT_DEFAULT}): {long_kkt_ms:.4f} ms on "
        f"the card (graph_ms), bound {long_kkt_bound[0]:.5f} ms by {long_kkt_bound[1]} "
        f"({long_kkt_bound[0] / long_kkt_ms:.4f} of the bound reached); plain version "
        f"{long_kkt_plain_ms:.3f} ms")
    report_pcg_variants(N_LONG, B_LONG, sms, 12)
    # pcg's lam limit is plain32's own distance from float64, one sample of
    # float32 noise: on the default route's steady state the kernel lies
    # farther from plain32 than that, so the limit is printed there and not
    # held (the counts and the float64 rule are); it is held on the steady
    # state reached with the one-thread kkt (the same kernels, summed in
    # another order); the witness says why: the CPU's float32 plain version
    # lies about as far from the card's, and the kernel nearer float64 than
    # the card's plain version (reported here), and on the same state's
    # Schur system assembled in float64 the kernel stays within the plain
    # arms' spread (held; PERF.md section 6)
    pcg_sys_l, pcg_skip_l, pcg_res_l = compare_pcg(fl, kkt_pl, laml, lam_held=False)
    with FORCED["the one-thread kkt"]():
        (Xw, Uw, lamw, xsw), i0_w = fl.steady_state()
    log(f"[compare] pcg at N={N_LONG} B={B_LONG} on the steady state reached with the "
        f"one-thread kkt:")
    compare_pcg(fl, setup_kkt_batched(fl.model, fl.cp, Xw, Uw, xsw, fl.ref(i0_w - 1),
                                      fl.f_ext, DT), lamw)
    del Xw, Uw, lamw, xsw
    pcg_witness(fl, pcg_sys_l, "the default route's steady state", held=False)
    pcg_witness(fl, f64_assembled_system(fl, Xl, Ul, xsl, refl, laml),
                "the same state's Schur system assembled in float64", held=True)
    time_pcg(N_LONG, B_LONG, pcg_sys_l, pcg_skip_l, card, 5)
    core_l = sqp_iter_core_reference(fl.model, fl.cp, Xl, Ul, xsl, refl, fl.f_ext,
                                     laml, fl.hp.rho, fl.hp.pcg_tol, pcg_skip_l,
                                     DT, mpcg)
    merit_args_l, _ = compare_merit(fl, Xl, Ul, *scrubbed(core_l[0], core_l[1]), xsl, refl)
    time_in_rounds(cuda_merit.VARIANTS,
                   lambda v: merit_alphas_batched_cuda(fl.model, fl.cp, *merit_args_l,
                                                       variant=v),
                   20, card, f"merit N={N_LONG} B={B_LONG}", MERIT_DEFAULT)
    long_pcg_ms = event_ms(
        lambda: pcg_solve_batched_cuda(*pcg_sys_l, mpcg, pcg_skip_l), 5)
    long_pcg_device_ms = graph_ms(
        lambda: pcg_solve_batched_cuda(*pcg_sys_l, mpcg, pcg_skip_l), 5)
    long_pcg_plain_ms = event_ms(lambda: pcg_solve_batched(*pcg_sys_l, mpcg, pcg_skip_l), 1)
    S_dense = dense_btd(pcg_sys_l[0], pcg_sys_l[1])
    g_flat = pcg_sys_l[4].reshape(B_LONG, -1, 1)
    long_library_ms = event_ms(lambda: torch.linalg.solve(S_dense, g_flat), 3)
    del S_dense
    long_bound = bound(B_LONG * N_LONG * PCG_SETUP_OPS
                       + N_LONG * PCG_ITER_OPS * pcg_res_l["iters_sum"],
                       nbytes(*pcg_sys_l, pcg_skip_l) + nbytes(laml)
                       + nbytes(torch.empty(B_LONG, device=dev)))
    log(f"[bound] pcg at N={N_LONG} B={B_LONG} ({pcg_variant(N_LONG, 12)}): "
        f"{long_pcg_device_ms:.4f} ms on the device (graph_ms), {long_pcg_ms:.4f} ms per "
        f"wrapper call, bound {long_bound[0]:.5f} ms by "
        f"{long_bound[1]} ({long_bound[0] / long_pcg_device_ms:.4f} of the bound reached); "
        f"plain version {long_pcg_plain_ms:.3f} ms; torch.linalg.solve "
        f"{long_library_ms:.3f} ms; PCG iterations mean "
        f"{pcg_res_l['iters_mean']:.2f}, max {pcg_res_l['iters_max']}, at the cap "
        f"{pcg_res_l['at_cap_frac']:.4f}")
    for earlier in ("pcg in the global variant", "the one-thread kkt"):
        route_ab(fl, state_l, i0_l, card, K, ("off", "off"), earlier)
    route_ab(fl, state_l, i0_l, card, K, ("off", "off"), "the one-thread kkt", fixed=True)
    reset_launches()
    state_l2, ms_l, err_l, pcg_l, step_l = fl.run(state_l, i0_l, fl.solve_kernel,
                                                  fl.plant_kernel, K_LONG)
    long_launches = launches()
    log(f"[long horizon] N={N_LONG} B={B_LONG} launches over {K_LONG} cycles: "
        f"{long_launches}")
    if long_launches != dict(bsqp_iter=0, rk4=K_LONG, iter=0, kkt=K_LONG, pcg=K_LONG,
                             merit=K_LONG):
        raise RuntimeError(
            f"the N={N_LONG} solve did not run through the staged kernels")
    Xl2 = state_l2[0]
    if Xl2.shape != (B_LONG, N_LONG, 12) or not torch.isfinite(Xl2).all():
        raise RuntimeError("the long-horizon trajectory is not finite or misshapen")
    log(f"[long horizon] {card}: per-cycle median {statistics.median(ms_l):.3f} ms "
        f"(CUDA events, {K_LONG} cycles after {WARMUP} warm-up); pcg kernel "
        f"{long_pcg_ms:.3f} ms per call on the steady-state system (torch.linalg."
        f"solve on the dense ({N_LONG * 12})^2 matrix {long_library_ms:.3f} ms); "
        f"lane 0 mean EE "
        f"error {err_l.mean().item():.4f} m; accepted steps "
        f"{float((step_l > 0).mean()):.3f} of (lane, cycle); PCG iterations mean "
        f"{float(pcg_l.mean()):.2f}, max {int(pcg_l.max())}, at the cap of {mpcg} on "
        f"{float((pcg_l == mpcg).mean()):.4f} of (lane, cycle) (reported, not checked)")
    long_tracking(fl, state_l, i0_l, err_l)

    # ---- bsqp_iter and iter at the long horizons, B=512 ----
    for n in CHECK_HORIZONS:
        fc = Fig8(dev, n, B)
        state_c, i0_c = fc.steady_state()
        compare_iteration(fc, state_c, i0_c - 1, noise_floor=True)
        compare_core(fc, state_c, i0_c - 1, noise_floor=True)
        del fc, state_c

    # ---- bounds from this run's inputs ----
    kkt_ops, merit_ops = ops["knot_kkt"], ops["knot_merit"]
    ref3 = ref[..., :3]
    pcg_iters_sum = pcg_res["iters_sum"]
    core_ops = B * N * (kkt_ops + SCHUR_OPS + DZ_OPS + PCG_SETUP_OPS)
    A1 = f.settings.num_alphas + 1
    vec = torch.empty(B, device=dev)
    bounds = dict(
        bsqp_iter=bound(core_ops + N * PCG_ITER_OPS * iter_res["kernel_pcg_sum"]
                        + B * A1 * N * (merit_ops + CANDIDATE_OPS),
                        nbytes(X, U, lam, x_s, ref3, f.f_ext) + 17 * nbytes(vec)
                        + nbytes(X, U, lam)),
        rk4=bound(RK4_SUBSTEPS * (4 * ops["fd"] + RK4_SUBSTEP_AXPY_OPS),
                  nbytes(xr, ur) + nbytes(xr)),
        iter=bound(core_ops + N * PCG_ITER_OPS * core_res["kernel_pcg_sum"],
                   nbytes(X, U, lam, x_s, ref3, f.f_ext) + 3 * nbytes(vec)
                   + nbytes(X, U, lam) + nbytes(vec)),
        kkt=bound(B * N * kkt_ops,
                  nbytes(X, U, ref3, f.f_ext) + nbytes(*(getattr(kkt_p, n) for n in (
                      "Q", "q", "R", "r", "A", "B", "c")))),
        pcg=bound(B * N * PCG_SETUP_OPS + N * PCG_ITER_OPS * pcg_iters_sum,
                  nbytes(*pcg_sys, pcg_skip) + nbytes(lam) + nbytes(vec)),
        merit=bound(B * A1 * N * (merit_ops + CANDIDATE_OPS),
                    nbytes(X, U, dzx, dzu, x_s, ref3, f.f_ext, vec) + B * A1 * 4),
    )
    # rk4 at B = 1: the chain of dependent operations bounds it, far above
    # the operations and bytes; bound_ms is the larger of the two
    mhz = sm_max_clock_mhz()
    lat = {v: rk4_latency_bound(stats, mhz, v) for v in cuda_sim.VARIANTS}
    log(f"[bound] rk4 at B=1: bound by operations and bytes {bounds['rk4'][0]:.7f} ms "
        f"({bounds['rk4'][1]}); latency bound at the SM's maximum clock {mhz:.0f} MHz "
        f"(4 x {RK4_SUBSTEPS} stages x the depth of one stage x {FMA_CYCLES} cycles): "
        + ", ".join(f"{v} {lat[v][0]:.5f} ms (depth {lat[v][1]}), {rk4_ms[v][0]:.5f} ms "
                    f"on the card, {lat[v][0] / rk4_ms[v][0]:.4f} of it reached"
                    for v in cuda_sim.VARIANTS))
    if lat[cuda_sim.DEFAULT][0] > bounds["rk4"][0]:
        bounds["rk4"] = (lat[cuda_sim.DEFAULT][0], "latency")
    main = dict(bsqp_iter=main_launches["bsqp_iter"], rk4=main_launches["rk4"],
                iter=fused_l["iter"], kkt=staged_l["kkt"], pcg=staged_l["pcg"],
                merit=staged_l["merit"])
    errs = dict(bsqp_iter=iter_res["X_max_abs_err"], rk4=rk4_err,
                iter=core_res["dZX_max_abs_err"], kkt=kkt_err,
                pcg=pcg_res["lam_max_abs_err"], merit=merit_err)
    sources = dict(bsqp_iter="gato_tpu/ops/pallas_solve.py:346",
                   rk4="gato_tpu/ops/pallas_sim.py:63",
                   iter="gato_tpu/ops/pallas_iter.py:249",
                   kkt="gato_tpu/ops/pallas_kkt.py:33",
                   pcg="gato_tpu/ops/pallas_pcg.py:199",
                   merit="gato_tpu/ops/pallas_merit.py:44")
    kernels = [dict(name=n, route="cuda", source=f"gato_tpu_torch/csrc/{n}.cu",
                    replaces=sources[n], launches=main[n], max_abs_err=errs[n],
                    ms=times[n][0], plain_ms=times[n][1], bound_ms=bounds[n][0],
                    bound_by=bounds[n][1],
                    library_ms=pcg_library_ms if n == "pcg" else None,
                    plants=list(_build.KERNELS[n]))
               for n in ("bsqp_iter", "rk4", "iter", "kkt", "pcg", "merit")]
    # the second plant's numbers beside the first's: held and timed in
    # [iiwa14-kernels], launched on [bench-iiwa14]'s K cycles (iter and
    # merit: on its fused-iteration route's); the pendulum plants' rk4
    # (their slugs among its plants) held and timed in [iiwa14-kernels],
    # launched by the goals rollouts' warm-up cycle and capture (each
    # replay runs the captured launch, uncounted)
    # kkt and pcg: held and timed at N=32 B=512 in [iiwa14-staged], launched
    # by the fleet's iiwa14 member past 128 knots ([fleet], its own count)
    for k in kernels:
        n = k["name"]
        if n in ("kkt", "pcg"):
            st = staged_i[n]
            k[IIWA] = dict(launches=fleet_i[N_LONG]["launches_per_member"][IIWA][n],
                           max_abs_err=st["max_abs_err"], ms=st["ms"], plain_ms=st["plain_ms"],
                           bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                           library_ms=st.get("library_ms"))
        elif IIWA in k["plants"]:
            run = bench_i["iter_launches"] if n in ("iter", "merit") else bench_i["launches"]
            k[IIWA] = dict(launches=run[n], max_abs_err=kern_i["errs"][n],
                           ms=kern_i["times"][n][0], plain_ms=kern_i["times"][n][2],
                           bound_ms=kern_i["bounds"][n][0], bound_by=kern_i["bounds"][n][1])
        if k["name"] == "rk4":
            rollout_launches = {"indy7+pendulum": goals["launches"]["rk4"],
                                "iiwa14+pendulum": goals_i["launches"]["rk4"]}
            k["pendulum"] = {slug: dict(
                plant=r["plant"], launches=rollout_launches[r["plant"]],
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"])
                for slug, r in kern_i["pendulum"].items()}
            k["plants"] += list(k["pendulum"])
    for k in kernels:
        log(f"[bound] {k['name']}: {k['ms']:.4f} ms on the card, bound "
            f"{k['bound_ms']:.5f} ms by {k['bound_by']} "
            f"({k['bound_ms'] / k['ms']:.4f} of the bound reached)")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
