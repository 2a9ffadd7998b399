"""Smoke run of the PyTorch + CUDA port (gato_tpu_torch) on one NVIDIA GPU.

Drives the port's main path, the steady-state closed-loop fig-8 MPC cycle
of bench.py (indy7, N=32, B=512, DEFAULT_SOLVER_PARAMS): one batched solve
(gato_tpu_torch.solver.bsqp.solve_batched), an RK4 plant step of lane 0
under U[0, 0] (gato_tpu_torch.api.common.rk4_step, 2 substeps) and a roll
of the reference window, K=50 times. It builds both CUDA kernels from
gato_tpu_torch/csrc/, holds each against its plain PyTorch version on the
steady-state input, counts the kernels' launches over the main path, times
the cycle on the kernel route and on the plain route with CUDA events, and
checks lane 0's fig-8 tracking error on both routes.

    python3 chip_smoke.py

Needs one CUDA GPU; fails without one. Every failed check raises. The last
two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
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
from gato_tpu_torch.ops.cuda_sim import rk4_plain, rk4_step_batched
from gato_tpu_torch.ops.cuda_solve import (IterState, Problem, sqp_iter_cuda,
                                           sqp_iter_reference,
                                           sqp_solve_chained)
from gato_tpu_torch.ops.merit_fast import _get_cd
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams

N, B, DT, K, WARMUP = 32, 512, 0.01, 50, 6
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


class Fig8:
    """bench.py's closed loop on the port: one route (solve, plant) each."""

    def __init__(self, dev):
        self.dev = dev
        self.model = load_robot("indy7", torch.float32, dev)
        self.cp = CostParams(**{k: P[k] for k in (
            "q_cost", "qd_cost", "u_cost", "N_cost", "q_lim_cost",
            "vel_lim_cost", "ctrl_lim_cost")})
        self.settings = BSQPSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                                     max_pcg_iters=P["max_pcg_iters"],
                                     solve_ratio=P["solve_ratio"])
        self.hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"],
                                     pcg_tol=P["pcg_tol"], device=dev)
        self.traj = torch.tensor(figure8(DT).reshape(-1, 6), dtype=torch.float32,
                                 device=dev)
        # per-lane wrench hypotheses; lane 0 is the zero hypothesis and drives
        # the plant (bench.py:103-113)
        rng = np.random.default_rng(0)
        f_ext = rng.uniform(-5.0, 5.0, (B, 6)).astype(np.float32)
        f_ext[0] = 0.0
        self.f_ext = torch.tensor(f_ext, device=dev)

    def ref(self, i):
        T = self.traj.shape[0]
        j = i % (T - N)
        return self.traj[j:j + N][None].expand(B, N, 6).contiguous()

    def solve_kernel(self, X, U, lam, x_s, ref):
        Xo, Uo, lamo, _, st = solve_batched(self.model, self.settings, self.cp,
                                            self.hp, X, U, lam, x_s, ref,
                                            self.f_ext, DT)
        return Xo, Uo, lamo, st.pcg_iters[0], st.ls_step_size[0]

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
        x_s = xs1[None].expand(B, xs1.shape[0]).contiguous()
        Xo[:, 0] = x_s
        return (Xo, Uo, lamo, x_s), pcg, step

    def steady_state(self):
        """bench.py:54-130: 6 warm-up cycles from the 'ready' start with a
        10-substep RK4 plant, on the kernel route."""
        x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)])
        x0 = torch.tensor(x0, dtype=torch.float32, device=self.dev)
        X = x0.expand(B, N, 12).contiguous()
        U = torch.zeros(B, N - 1, 6, device=self.dev)
        lam = torch.zeros(B, N, 12, device=self.dev)
        x_s = x0.expand(B, 12).contiguous()
        for step in range(WARMUP):
            X, U, lam, _, _ = self.solve_kernel(X, U, lam, x_s, self.ref(step))
            x_s = self.plant_kernel(x_s[0], U[0, 0], 10)[None].expand(B, 12).contiguous()
            X[:, 0] = x_s
        return (X, U, lam, x_s), WARMUP  # bench.py: cycles start at step + 1

    def run(self, state, i0, solve, plant):
        """K closed-loop cycles; per-cycle CUDA-event ms, lane 0's EE
        tracking error against the reference knot it should reach next
        (api/mpc.py's goal distance), and the per-cycle work trace."""
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(K)]
        xs_hist, pcgs, steps = [], [], []
        for c in range(K):
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
        goal = torch.stack([self.ref(i0 + c)[0, 1, :3] for c in range(K)])
        err = (p_ee - goal).norm(dim=1)
        return (state, ms_cycle, err,
                torch.stack(pcgs).cpu().numpy(), torch.stack(steps).cpu().numpy())


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

    def normwise(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()

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

    f = Fig8(dev)
    state, i0 = f.steady_state()
    torch.cuda.synchronize()
    log(f"[steady] {WARMUP} warm-up cycles done (indy7 N={N} B={B})")

    prob, s0, iter_res = compare_iteration(f, state, i0 - 1)
    xr, ur, rk4_err = compare_rk4(f, state)

    iter_ms = event_ms(lambda: sqp_iter_cuda(f.model, f.cp, prob, s0, f.settings,
                                             seeded=False), 20)
    iter_plain_ms = event_ms(lambda: sqp_iter_reference(
        f.model, f.cp, prob, s0, f.settings, seeded=False), 3)
    rk4_ms = event_ms(lambda: rk4_step_batched(f.model, xr, ur, DT, None, 2), 200)
    rk4_plain_ms = event_ms(lambda: rk4_plain(f.model, xr, ur, DT, None, 2), 20)

    # ---- the main path: K cycles on the kernel route, launches counted ----
    sqp_iter_cuda.launches = 0
    rk4_step_batched.launches = 0
    state_k, ms_k, err_k, pcg_k, step_k = f.run(state, i0, f.solve_kernel,
                                                f.plant_kernel)
    launches = dict(bsqp_iter=sqp_iter_cuda.launches, rk4=rk4_step_batched.launches)
    solves = K * P["max_sqp_iters"]
    log(f"[main path] launches over {K} cycles: {launches} ({solves} solves)")
    if launches["bsqp_iter"] != solves or launches["rk4"] != K:
        raise RuntimeError(f"main path did not run through the kernels: {launches}")
    Xk = state_k[0]
    if Xk.shape != (B, N, 12) or not torch.isfinite(Xk).all():
        raise RuntimeError("main path produced a non-finite or misshapen trajectory")

    state_p, ms_p, err_p, _, _ = f.run(state, i0, f.solve_plain, f.plant_plain)

    med_k, med_p = statistics.median(ms_k), statistics.median(ms_p)
    log(f"[timing] {card}: per-cycle median {med_k:.3f} ms on the kernel route "
        f"({B / (med_k / 1e3):.1f} solves/s), {med_p:.3f} ms on the plain "
        f"route ({B / (med_p / 1e3):.1f} solves/s); CUDA events over {K} "
        f"cycles, indy7 N={N} B={B}")
    log(f"[timing] {card}: bsqp_iter kernel {iter_ms:.4f} ms/launch vs plain "
        f"{iter_plain_ms:.3f} ms; rk4 kernel (B=1) {rk4_ms:.4f} ms vs plain "
        f"{rk4_plain_ms:.3f} ms")
    work = dict(pcg_iters_lane0=pcg_k[:8, 0].astype(int).tolist(),
                step_lane0=[round(float(s), 4) for s in step_k[:8, 0]],
                pcg_iters_mean=round(float(pcg_k[:8].mean()), 2),
                pcg_iters_max=int(pcg_k[:8].max()),
                steps_accepted_frac=round(float((step_k[:8] > 0).mean()), 3))
    log(f"[work] 8-cycle trace (bench.py:227-243): {json.dumps(work)}")
    ek, ep = err_k.mean().item(), err_p.mean().item()
    log(f"[tracking] lane 0 mean EE error over {K} cycles: kernel route "
        f"{ek:.4f} m, plain route {ep:.4f} m (limit {TRACK_MAX_M} m, routes "
        f"within {TRACK_REL:.0%})")
    if not (ek < TRACK_MAX_M and ep < TRACK_MAX_M and abs(ek - ep) <= TRACK_REL * ep):
        raise RuntimeError("fig-8 tracking check failed")

    kernels = [
        dict(name="bsqp_iter", route="cuda", source="gato_tpu_torch/csrc/bsqp_iter.cu",
             replaces="gato_tpu/ops/pallas_solve.py:346", launches=launches["bsqp_iter"],
             max_abs_err=iter_res["X_max_abs_err"], ms=iter_ms, plain_ms=iter_plain_ms),
        dict(name="rk4", route="cuda", source="gato_tpu_torch/csrc/rk4.cu",
             replaces="gato_tpu/ops/pallas_sim.py:63", launches=launches["rk4"],
             max_abs_err=rk4_err, ms=rk4_ms, plain_ms=rk4_plain_ms),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
