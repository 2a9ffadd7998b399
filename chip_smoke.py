"""Smoke run of the PyTorch + CUDA port (gato_tpu_torch) on one NVIDIA GPU.

Drives the port's solve routes through their entry point
(gato_tpu_torch.solver.bsqp.solve_batched) in the steady-state closed-loop
fig-8 MPC cycle of bench.py (indy7, DEFAULT_SOLVER_PARAMS): one batched
solve, an RK4 plant step of lane 0 under U[0, 0] (2 substeps,
gato_tpu_torch.api.common.rk4_step) and a roll of the reference window per
cycle.

  main path     N=32, B=512, the default route (bsqp_iter + rk4), K=50
                cycles, and the same cycles on the plain PyTorch route;
  fused route   solve_kernel="off": the iter and merit kernels, K=50 cycles;
  staged route  solve_kernel="off", iter_kernel="off": the kkt, pcg and
                merit kernels, K=50 cycles;
  long horizon  N=256, B=64, where "auto" takes the staged route by itself:
                6 warm-up and 10 timed cycles.

It builds the six CUDA kernels from gato_tpu_torch/csrc/ (one nvcc each, all
at once), holds each against its plain PyTorch version on the steady-state
input (kkt, pcg and merit at N=256 too), counts each path's launches with
the counts set to 0 just before it, times every route's cycle with CUDA
events, checks lane 0's fig-8 tracking error on every N=32 route, and
computes each kernel's bound from this run's inputs.

    python3 chip_smoke.py

Needs one CUDA GPU; fails without one. Every failed check raises. The last
two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come on the
line before them.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gato_tpu_torch import _build
from gato_tpu_torch.api.common import figure8, rk4_step
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import INDY7_START_CONFIGS
from gato_tpu_torch.dynamics import mathshim as ms
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.ops.cuda_iter import (sqp_iter_core_cuda,
                                          sqp_iter_core_reference)
from gato_tpu_torch.ops.cuda_kkt import setup_kkt_batched_cuda
from gato_tpu_torch.ops.cuda_merit import merit_alphas_batched_cuda
from gato_tpu_torch.ops.cuda_pcg import pcg_solve_batched_cuda
from gato_tpu_torch.ops.cuda_sim import rk4_plain, rk4_step_batched
from gato_tpu_torch.ops.cuda_solve import (IterState, Problem, sqp_iter_cuda,
                                           sqp_iter_reference,
                                           sqp_solve_chained)
from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
from gato_tpu_torch.ops.merit_fast import _get_cd, merit_alphas_batched
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from gato_tpu_torch.ops.schur import build_schur
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import select_route, solve_batched
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams

N, B, DT, K, WARMUP = 32, 512, 0.01, 50, 6
N_LONG, B_LONG, K_LONG = 256, 64, 10
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
TRACK_MAX_M, TRACK_REL = 0.1, 0.10
# kkt: each KKTSystem tensor within KKT_RTOL of its largest |value|
# (identical float32 inputs; only the order of operations differs).
# merit: each (lane, alpha) merit within MERIT_ALPHA_RTOL, relative (the
# order of the sum over knots is the only difference).
# pcg: on the identical assembled system, identical counts on at least
# PCG_SAME_MIN of the lanes, lam normwise within LAM_RTOL where they agree.
KKT_RTOL, MERIT_ALPHA_RTOL, PCG_SAME_MIN, LAM_RTOL = 1e-4, 1e-5, 0.99, 1e-3
# H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Operations per knot outside the generated functions, counted from the
# kernels' loops (csrc/sqp_iter.cuh, csrc/pcg.cu): a Cholesky inverse of an
# n x n block is about 7 n^3 / 3; phi 936, theta 3,432, gamma 684 and
# P_lower 2 x 2 x 12^3; dz recovery about 550; a block-tridiagonal matvec
# three 12x12 blocks of multiply-adds; a PCG iteration two matvecs, two
# dots and three vector updates.
SCHUR_OPS = 7 * 6 ** 3 // 3 + 936 + 3432 + 684 + 7 * 12 ** 3 // 3 + 4 * 12 ** 3
DZ_OPS, MATVEC_OPS = 550, 3 * 144 * 2
PCG_SETUP_OPS = 2 * MATVEC_OPS + 12 + 24
PCG_ITER_OPS = 2 * MATVEC_OPS + 2 * 24 + 3 * 24
RK4_SUBSTEP_AXPY_OPS = 156  # csrc/rk4.cu: the stage states and the update
CANDIDATE_OPS = 60  # a merit knot's candidate x, x_next, u: 30 multiply-adds
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


def generated_op_counts():
    """Operations of each generated per-knot function in
    csrc/generated/indy7.cuh: every binary + - * / and every sqrt, sin,
    cos, log, abs and max call counts as one."""
    with open(os.path.join(_build.CSRC_DIR, "generated", "indy7.cuh")) as f:
        src = f.read()
    counts = {}
    for name in ("fd", "knot_kkt", "knot_merit"):
        body = re.search(r"inline void " + name + r"\(.*?\{\n(.*?)\n\}", src,
                         re.S).group(1)
        counts[name] = (sum(body.count(t) for t in (" + ", " - ", " * ", " / "))
                        + len(re.findall(r"\bg(?:sqrt|sin|cos|log|abs|max)\(", body)))
    return counts


def normwise(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


class Fig8:
    """bench.py's closed loop on the port: one route (solve, plant) each."""

    def __init__(self, dev, n=N, b=B):
        self.dev, self.N, self.B = dev, n, b
        self.model = load_robot("indy7", torch.float32, dev)
        self.cp = CostParams(**{k: P[k] for k in (
            "q_cost", "qd_cost", "u_cost", "N_cost", "q_lim_cost",
            "vel_lim_cost", "ctrl_lim_cost")})
        self.settings = self.settings_with("auto", "auto")
        self.hp = HyperParams.create(b, rho=P["rho"], mu=P["mu"],
                                     pcg_tol=P["pcg_tol"], device=dev)
        self.traj = torch.tensor(figure8(DT).reshape(-1, 6), dtype=torch.float32,
                                 device=dev)
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

    def steady_state(self):
        """bench.py:54-130: 6 warm-up cycles from the 'ready' start with a
        10-substep RK4 plant, on the default route."""
        x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)])
        x0 = torch.tensor(x0, dtype=torch.float32, device=self.dev)
        X = x0.expand(self.B, self.N, 12).contiguous()
        U = torch.zeros(self.B, self.N - 1, 6, device=self.dev)
        lam = torch.zeros(self.B, self.N, 12, device=self.dev)
        x_s = x0.expand(self.B, 12).contiguous()
        for step in range(WARMUP):
            X, U, lam, _, _ = self.solve_kernel(X, U, lam, x_s, self.ref(step))
            x_s = self.plant_kernel(x_s[0], U[0, 0], 10)[None].expand(
                self.B, 12).contiguous()
            X[:, 0] = x_s
        return (X, U, lam, x_s), WARMUP  # bench.py: cycles start at step + 1

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
        q = torch.stack(xs_hist)[:, :6]
        p_ee = cd.fk_ee([ms.cos(q[:, i]) for i in range(6)],
                        [ms.sin(q[:, i]) for i in range(6)])[0]
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


def compare_iteration(f, state, i):
    """One SQP iteration, kernel against its plain version (and both against
    the plain version in float64), on the identical steady-state input."""
    X, U, lam, x_s = state
    m = f.model
    zero = torch.zeros(B, device=f.dev)
    prob = Problem(x_s, f.ref(i), f.f_ext, f.hp.mu, f.hp.pcg_tol, DT)
    s0 = IterState(X, U, lam, f.hp.rho, f.hp.drho, zero, zero, zero, zero)
    ko, ks = sqp_iter_cuda(m, f.cp, prob, s0, f.settings, seeded=False)
    ro, rs = sqp_iter_reference(m, f.cp, prob, s0, f.settings, seeded=False)
    m64 = load_robot("indy7", torch.float64, f.dev)
    p64 = Problem(*(t.double() for t in prob[:5]), DT)
    o64, s64 = sqp_iter_reference(m64, f.cp, p64, IterState(*(t.double() for t in s0)),
                                  f.settings, seeded=False)
    torch.cuda.synchronize()
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
    # version on the same input
    for tag, (oa, sa) in (("kernel", (ko, ks)), ("plain32", (ro, rs))):
        s = sa.ls_step.double() == s64.ls_step
        res[f"{tag}_f64_X_rel"] = normwise(oa.X[s], o64.X[s])
        res[f"{tag}_f64_merit_rel_max"] = (
            (sa.ls_merit.double() - s64.ls_merit).abs() / s64.ls_merit.abs())[s].max().item()
        res[f"{tag}_f64_pcg_max_diff"] = int((sa.pcg_iters - s64.pcg_iters).abs().max())
    log("[compare] bsqp_iter kernel vs sqp_iter_reference (float32, identical "
        "steady-state input):")
    log(f"  identical ls_step on {res['step_same_frac']:.4f} of lanes "
        f"(tolerance >= {STEP_SAME_MIN})")
    log(f"  PCG counts within {PCG_SLACK} on {res['pcg_within_frac']:.4f} of "
        f"lanes (tolerance >= {STEP_SAME_MIN}); largest difference "
        f"{res['pcg_max_diff']}")
    log(f"  {res['lanes_compared']} lanes with identical step and PCG count: X "
        f"normwise rel {res['X_rel']:.3e}, U {res['U_rel']:.3e} (tolerance "
        f"{TRAJ_RTOL})")
    log(f"  lanes with identical step: merit rel p99 {res['merit_rel_p99']:.3e}, "
        f"max {res['merit_rel_max']:.3e} (reported: held against the float64 "
        f"version below); warm-start merit rel max {res['merit0_rel_max']:.3e} "
        f"(tolerance {MERIT0_RTOL})")
    log(f"  against the float64 plain version (tolerance: the kernel within "
        f"{F64_FACTOR}x of the float32 plain version, floors {TRAJ_RTOL} and "
        f"{PCG_SLACK}): X rel kernel {res['kernel_f64_X_rel']:.3e} / plain32 "
        f"{res['plain32_f64_X_rel']:.3e}; merit rel max kernel "
        f"{res['kernel_f64_merit_rel_max']:.3e} / plain32 "
        f"{res['plain32_f64_merit_rel_max']:.3e}; PCG max diff kernel "
        f"{res['kernel_f64_pcg_max_diff']} / plain32 {res['plain32_f64_pcg_max_diff']}")

    def within(tag, floor):
        return res[f"kernel_f64_{tag}"] <= max(floor, F64_FACTOR * res[f"plain32_f64_{tag}"])

    ok = (res["step_same_frac"] >= STEP_SAME_MIN
          and res["pcg_within_frac"] >= STEP_SAME_MIN
          and res["X_rel"] <= TRAJ_RTOL and res["U_rel"] <= TRAJ_RTOL
          and res["merit0_rel_max"] <= MERIT0_RTOL
          and within("X_rel", TRAJ_RTOL) and within("merit_rel_max", MERIT_RTOL)
          and within("pcg_max_diff", PCG_SLACK))
    if not ok:
        raise RuntimeError(f"bsqp_iter kernel disagrees with its plain version: {res}")
    return prob, s0, res


def compare_rk4(f, state):
    """The plant step at the main path's shape (B = 1, 2 substeps)."""
    x, u = state[3][:1].contiguous(), state[1][:1, 0].contiguous()
    k = rk4_step_batched(f.model, x, u, DT, None, 2)
    p = rk4_plain(f.model, x, u, DT, None, 2)
    torch.cuda.synchronize()
    err = (k - p).abs().max().item()
    tol = RK4_RTOL * p.abs().max().item()
    log(f"[compare] rk4 kernel vs rk4_channels (B=1, 2 substeps): max abs err "
        f"{err:.3e}, tolerance {tol:.3e} (rtol {RK4_RTOL} of max |x|)")
    if not (torch.isfinite(k).all() and err <= tol):
        raise RuntimeError("rk4 kernel disagrees with its plain version")
    return x, u, err


def compare_core(f, state, i):
    """The iter kernel against sqp_iter_core_reference (float32) and both
    against the plain version in float64, on the identical steady-state
    input, in compare_iteration's style and limits."""
    X, U, lam, x_s = state
    skip = torch.zeros(f.B, dtype=torch.bool, device=f.dev)
    args = (X, U, x_s, f.ref(i), f.f_ext, lam, f.hp.rho, f.hp.pcg_tol)
    mpcg = P["max_pcg_iters"]
    ko = sqp_iter_core_cuda(f.model, f.cp, *args, skip, DT, mpcg)
    ro = sqp_iter_core_reference(f.model, f.cp, *args, skip, DT, mpcg)
    m64 = load_robot("indy7", torch.float64, f.dev)
    o64 = sqp_iter_core_reference(m64, f.cp, *(t.double() for t in args), skip,
                                  DT, mpcg)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in ko[:3]):
        raise RuntimeError("iter kernel output is not finite")
    diff = (ko[3] - ro[3]).abs()
    same = diff == 0
    res = dict(pcg_within_frac=(diff <= PCG_SLACK).double().mean().item(),
               pcg_max_diff=int(diff.max()), lanes_compared=int(same.sum()),
               dZX_rel=normwise(ko[0][same], ro[0][same]),
               dZU_rel=normwise(ko[1][same], ro[1][same]),
               lam_rel=normwise(ko[2][same], ro[2][same]),
               dZX_max_abs_err=(ko[0][same] - ro[0][same]).abs().max().item(),
               kernel_pcg_sum=int(ko[3].sum()))
    for tag, o in (("kernel", ko), ("plain32", ro)):
        res[f"{tag}_f64_dZX_rel"] = normwise(o[0], o64[0])
        res[f"{tag}_f64_pcg_max_diff"] = int((o[3] - o64[3]).abs().max())
    log("[compare] iter kernel vs sqp_iter_core_reference (float32, identical "
        "steady-state input):")
    log(f"  PCG counts within {PCG_SLACK} on {res['pcg_within_frac']:.4f} of "
        f"lanes (tolerance >= {STEP_SAME_MIN}); largest difference "
        f"{res['pcg_max_diff']}")
    log(f"  {res['lanes_compared']} lanes with identical PCG count: dZX "
        f"normwise rel {res['dZX_rel']:.3e}, dZU {res['dZU_rel']:.3e}, lam "
        f"{res['lam_rel']:.3e} (tolerance {TRAJ_RTOL})")
    log(f"  against the float64 plain version (the kernel within {F64_FACTOR}x "
        f"of the float32 plain version, floors {TRAJ_RTOL} and {PCG_SLACK}): "
        f"dZX rel kernel {res['kernel_f64_dZX_rel']:.3e} / plain32 "
        f"{res['plain32_f64_dZX_rel']:.3e}; PCG max diff kernel "
        f"{res['kernel_f64_pcg_max_diff']} / plain32 "
        f"{res['plain32_f64_pcg_max_diff']}")
    ok = (res["pcg_within_frac"] >= STEP_SAME_MIN
          and max(res["dZX_rel"], res["dZU_rel"], res["lam_rel"]) <= TRAJ_RTOL
          and res["kernel_f64_dZX_rel"] <= max(
              TRAJ_RTOL, F64_FACTOR * res["plain32_f64_dZX_rel"])
          and res["kernel_f64_pcg_max_diff"] <= max(
              PCG_SLACK, F64_FACTOR * res["plain32_f64_pcg_max_diff"]))
    if not ok:
        raise RuntimeError(f"iter kernel disagrees with its plain version: {res}")
    return args, skip, ro, res


def compare_kkt(f, X, U, x_s, ref):
    """The kkt kernel against setup_kkt_batched on the identical input."""
    k = setup_kkt_batched_cuda(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT)
    p = setup_kkt_batched(f.model, f.cp, X, U, x_s, ref, f.f_ext, DT)
    torch.cuda.synchronize()
    worst, errs = 0.0, {}
    for name in ("Q", "q", "R", "r", "A", "B", "c"):
        a, b = getattr(k, name), getattr(p, name)
        if not torch.isfinite(a).all():
            raise RuntimeError(f"kkt kernel output {name} is not finite")
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        errs[name] = (err, KKT_RTOL * scale)
        worst = max(worst, err)
    log(f"[compare] kkt kernel vs setup_kkt_batched (N={f.N}, B={f.B}): max abs "
        "err / tolerance (rtol {} of each tensor's max |value|): {}".format(
            KKT_RTOL, ", ".join(f"{n} {e:.3e}/{t:.3e}" for n, (e, t) in errs.items())))
    if any(e > t for e, t in errs.values()):
        raise RuntimeError(f"kkt kernel disagrees with its plain version: {errs}")
    return p, worst


def lane_rel(a, b):
    """Per-lane normwise distance of a from b, (B,)."""
    d = (a.double() - b.double()).flatten(1).abs().max(1).values
    return d / b.double().flatten(1).abs().max(1).values


def compare_pcg(f, kkt, lam0):
    """The pcg kernel against pcg_solve_batched on the identical assembled
    system (plain build_schur of the plain KKT), and both float32 arms
    against the float64 plain version on that system.

    Where float32 rounding alone moves lam by more than LAM_RTOL (the
    float32 plain version's own distance from the float64 one: about 1e-2
    at N=256), the limit on the kernel is that noise floor. The float64
    rule of compare_iteration (the kernel at most F64_FACTOR times as far
    off as the float32 plain version) is applied lane by lane against the
    plain version's largest distance over the batch, and must hold on
    PCG_SAME_MIN of the lanes: a lane where float32 PCG at tol 1e-4 stops many iterations away
    from float64 is a chance of rounding for either float32 arm."""
    sch = build_schur(kkt, f.hp.rho, 6)
    system = (sch.S_main, sch.S_lower, sch.P_main, sch.P_lower, sch.gamma, lam0,
              f.hp.pcg_tol)
    skip = torch.zeros(f.B, dtype=torch.bool, device=f.dev)
    mpcg = P["max_pcg_iters"]
    lk, ik = pcg_solve_batched_cuda(*system, mpcg, skip)
    lp, ip = pcg_solve_batched(*system, mpcg, skip)
    l64, i64 = pcg_solve_batched(*(t.double() for t in system), mpcg, skip)
    torch.cuda.synchronize()
    if not torch.isfinite(lk).all():
        raise RuntimeError("pcg kernel output is not finite")
    same = ik == ip
    k_rel, p_rel = lane_rel(lk, l64), lane_rel(lp, l64)
    k_cnt, p_cnt = (ik - i64).abs(), (ip - i64).abs()
    f64_ok = ((k_rel <= max(LAM_RTOL, F64_FACTOR * p_rel.max().item()))
              & (k_cnt <= max(PCG_SLACK, F64_FACTOR * p_cnt.max().item())))
    res = dict(same_frac=same.double().mean().item(),
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
               at_cap_frac=(ik == mpcg).double().mean().item())
    log(f"[compare] pcg kernel vs pcg_solve_batched (N={f.N}, B={f.B}, identical "
        f"assembled system): identical counts on {res['same_frac']:.4f} of lanes "
        f"(tolerance >= {PCG_SAME_MIN}), largest difference {res['max_diff']}; "
        f"lam normwise rel where counts agree {res['lam_rel']:.3e} (tolerance "
        f"{res['lam_limit']:.3e}: {LAM_RTOL}, or plain32's own distance from "
        f"float64 where larger); against the float64 plain version, lane by "
        f"lane (the kernel within {F64_FACTOR}x of plain32's largest distance, "
        f"floors {LAM_RTOL} and {PCG_SLACK}): holds on "
        f"{res['f64_rule_frac']:.4f} of lanes (tolerance "
        f">= {PCG_SAME_MIN}); largest lam rel kernel "
        f"{res['kernel_f64_lam_rel_max']:.3e} / plain32 "
        f"{res['plain32_f64_lam_rel_max']:.3e}, largest count diff kernel "
        f"{res['kernel_f64_max_diff']} / plain32 {res['plain32_f64_max_diff']}; "
        f"iterations sum {res['iters_sum']}, max {res['iters_max']}")
    ok = (res["same_frac"] >= PCG_SAME_MIN and res["lam_rel"] <= res["lam_limit"]
          and res["f64_rule_frac"] >= PCG_SAME_MIN)
    if not ok:
        raise RuntimeError(f"pcg kernel disagrees with its plain version: {res}")
    return system, skip, res


def compare_merit(f, X, U, dzx, dzu, x_s, ref):
    """The merit kernel against merit_alphas_batched at alpha in {0, 2^-j}."""
    alphas = [0.0] + [0.5 ** j for j in range(8)]
    args = (X, U, dzx, dzu, x_s, ref, f.f_ext, f.hp.mu, DT, alphas)
    mk = merit_alphas_batched_cuda(f.model, f.cp, *args)
    mp = merit_alphas_batched(f.model, f.cp, *args)
    torch.cuda.synchronize()
    rel = ((mk.double() - mp.double()).abs() / mp.double().abs()).max().item()
    err = (mk - mp).abs().max().item()
    log(f"[compare] merit kernel vs merit_alphas_batched (N={f.N}, B={f.B}, "
        f"{len(alphas)} alphas): max rel err {rel:.3e} (tolerance "
        f"{MERIT_ALPHA_RTOL}), max abs err {err:.3e}")
    if not (torch.isfinite(mk).all() and rel <= MERIT_ALPHA_RTOL):
        raise RuntimeError("merit kernel disagrees with its plain version")
    return args, err


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


def route_run(f, state, i0, gates, expect, card):
    """K cycles on one route with the launches counted; checks the counts
    against `expect` (every other kernel but rk4 launched 0 times)."""
    reset_launches()
    out = f.run(state, i0, f.solver(f.settings_with(*gates)), f.plant_kernel)
    got = launches()
    want = {name: expect.get(name, 0) for name in WRAPPERS}
    log(f"[route {gates}] launches over {K} cycles: {got}")
    if got != want:
        raise RuntimeError(f"route {gates} launched {got}, expected {want}")
    _, ms_cycle, err, pcg, step = out
    med = statistics.median(ms_cycle)
    log(f"[timing] {card}: route {gates} per-cycle median {med:.3f} ms "
        f"({f.B / (med / 1e3):.1f} solves/s); CUDA events over {K} cycles, "
        f"indy7 N={f.N} B={f.B}")
    log(f"[work] route {gates} 8-cycle trace: {json.dumps(work_trace(pcg, step))}")
    return got, med, err.mean().item()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] nvcc seconds per kernel: {secs}; total "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        log(f"[build] ptxas {name}:\n{_build.ptxas_report(name).rstrip()}")
    ops = generated_op_counts()
    log(f"[bound] operations per call of the generated functions: {ops}")

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
    dzx, dzu = scrubbed(core_ref[0], core_ref[1])
    merit_args, merit_err = compare_merit(f, X, U, dzx, dzu, x_s, ref)

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
    times = {name: (event_ms(kf, kernel_reps[name]), event_ms(pf, 3))
             for name, (kf, pf) in t.items()}
    S_dense = dense_btd(pcg_sys[0], pcg_sys[1])
    g_flat = pcg_sys[4].reshape(B, -1, 1)
    pcg_library_ms = event_ms(lambda: torch.linalg.solve(S_dense, g_flat), 3)
    del S_dense
    log(f"[timing] {card}: ms per call, kernel / plain version (N={N}, B={B}; "
        f"rk4 at B=1): "
        + ", ".join(f"{n} {k:.4f} / {p:.3f}" for n, (k, p) in times.items())
        + f"; pcg library yardstick torch.linalg.solve on the dense "
        f"({N * 12})^2 Schur matrix {pcg_library_ms:.3f} ms")

    # ---- the main path: K cycles on the default route, launches counted ----
    reset_launches()
    state_k, ms_k, err_k, pcg_k, step_k = f.run(state, i0, f.solve_kernel,
                                                f.plant_kernel)
    main_launches = launches()
    solves = K * P["max_sqp_iters"]
    log(f"[main path] launches over {K} cycles: {main_launches} ({solves} solves)")
    if main_launches != dict(bsqp_iter=solves, rk4=K, iter=0, kkt=0, pcg=0, merit=0):
        raise RuntimeError(f"main path did not run through the kernels: {main_launches}")
    Xk = state_k[0]
    if Xk.shape != (B, N, 12) or not torch.isfinite(Xk).all():
        raise RuntimeError("main path produced a non-finite or misshapen trajectory")

    state_p, ms_p, err_p, _, _ = f.run(state, i0, f.solve_plain, f.plant_plain)

    med_k, med_p = statistics.median(ms_k), statistics.median(ms_p)
    log(f"[timing] {card}: per-cycle median {med_k:.3f} ms on the kernel route "
        f"({B / (med_k / 1e3):.1f} solves/s), {med_p:.3f} ms on the plain "
        f"route ({B / (med_p / 1e3):.1f} solves/s); CUDA events over {K} "
        f"cycles, indy7 N={N} B={B}")
    log(f"[work] 8-cycle trace (bench.py:227-243): {json.dumps(work_trace(pcg_k, step_k))}")
    ek, ep = err_k.mean().item(), err_p.mean().item()

    # ---- the fused-iteration and the staged routes, K cycles each ----
    fused_l, med_fused, e_fused = route_run(
        f, state, i0, ("off", "auto"), dict(iter=solves, merit=solves, rk4=K), card)
    staged_l, med_staged, e_staged = route_run(
        f, state, i0, ("off", "off"), dict(kkt=solves, pcg=solves, merit=solves, rk4=K),
        card)
    log(f"[tracking] lane 0 mean EE error over {K} cycles: kernel route "
        f"{ek:.4f} m, fused-iteration route {e_fused:.4f} m, staged route "
        f"{e_staged:.4f} m, plain route {ep:.4f} m (limit {TRACK_MAX_M} m, "
        f"each kernel route within {TRACK_REL:.0%} of the plain route)")
    if not (ep < TRACK_MAX_M and all(e < TRACK_MAX_M and abs(e - ep) <= TRACK_REL * ep
                                      for e in (ek, e_fused, e_staged))):
        raise RuntimeError("fig-8 tracking check failed")

    # ---- a long horizon: N=256 B=64, where "auto" takes the staged route ----
    if select_route("auto", "auto", N_LONG, True) != "staged":
        raise RuntimeError("solve_kernel='auto' did not take the staged route at N=256")
    fl = Fig8(dev, N_LONG, B_LONG)
    state_l, i0_l = fl.steady_state()
    Xl, Ul, laml, xsl = state_l
    refl = fl.ref(i0_l - 1)
    kkt_pl, kkt_err_l = compare_kkt(fl, Xl, Ul, xsl, refl)
    pcg_sys_l, pcg_skip_l, pcg_res_l = compare_pcg(fl, kkt_pl, laml)
    core_l = sqp_iter_core_reference(fl.model, fl.cp, Xl, Ul, xsl, refl, fl.f_ext,
                                     laml, fl.hp.rho, fl.hp.pcg_tol, pcg_skip_l,
                                     DT, mpcg)
    compare_merit(fl, Xl, Ul, *scrubbed(core_l[0], core_l[1]), xsl, refl)
    long_pcg_ms = event_ms(
        lambda: pcg_solve_batched_cuda(*pcg_sys_l, mpcg, pcg_skip_l), 5)
    S_dense = dense_btd(pcg_sys_l[0], pcg_sys_l[1])
    g_flat = pcg_sys_l[4].reshape(B_LONG, -1, 1)
    long_library_ms = event_ms(lambda: torch.linalg.solve(S_dense, g_flat), 3)
    del S_dense
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
        rk4=bound(2 * (4 * ops["fd"] + RK4_SUBSTEP_AXPY_OPS),
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
                    library_ms=pcg_library_ms if n == "pcg" else None)
               for n in ("bsqp_iter", "rk4", "iter", "kkt", "pcg", "merit")]
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
