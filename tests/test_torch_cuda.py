"""The port's CUDA kernels against their plain PyTorch versions, on the card.

No jax here: the card's machine has none. Run there with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py configures jax). Without a CUDA device every test skips.
The float32 tolerances: the kernels contract to FMAs, use CUDA's sinf/cosf
and sum in another order; PCG at tol 1e-4 may stop at another count where
the assembly's rounding differs, so the solve is compared on the lanes
where step and count agree. Every launch is followed by
torch.cuda.synchronize(), so a fault inside a kernel shows where it ran.
"""

import ctypes

import numpy as np
import pytest
import torch

from gato_tpu_torch.api.common import figure8, rk4_step
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import INDY7_START_CONFIGS
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch._build import load_library
from gato_tpu_torch.ops.cuda_iter import (sqp_iter_core_cuda,
                                          sqp_iter_core_reference)
from gato_tpu_torch.ops.cuda_kkt import setup_kkt_batched_cuda
from gato_tpu_torch.ops.cuda_merit import merit_alphas_batched_cuda
from gato_tpu_torch.ops.cuda_pcg import _PcgArgs, pcg_solve_batched_cuda
from gato_tpu_torch.ops.cuda_sim import rk4_plain, rk4_step_batched
from gato_tpu_torch.ops.cuda_solve import (IterState, Problem, sqp_iter_cuda,
                                           sqp_iter_reference,
                                           sqp_solve_chained)
from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
from gato_tpu_torch.ops.merit_fast import merit_alphas_batched
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from gato_tpu_torch.ops.schur import build_schur
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, lo, hi, shape, dev):
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                        device=dev)


def test_rk4_kernel_matches_plain(dev):
    m = load_robot("indy7", torch.float32, dev)
    rng = np.random.default_rng(5)
    x, u, fe = (_rand(rng, -1, 1, (512, 12), dev), _rand(rng, -5, 5, (512, 6), dev),
                _rand(rng, -5, 5, (512, 6), dev))
    for f in (None, fe):
        before = rk4_step_batched.launches
        out = rk4_step_batched(m, x, u, 0.01, f, 2)
        torch.cuda.synchronize()
        assert rk4_step_batched.launches == before + 1
        torch.testing.assert_close(out, rk4_plain(m, x, u, 0.01, f, 2),
                                   rtol=1e-5, atol=1e-5)


def test_bsqp_iter_kernel_matches_reference(dev):
    """One SQP iteration on a warm fig-8 steady state (indy7, N=16, B=64,
    DEFAULT_SOLVER_PARAMS, 6 warm-up cycles on the kernel route)."""
    B, N, dt = 64, 16, 0.01
    m = load_robot("indy7", torch.float32, dev)
    cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                         "q_lim_cost")})
    settings = BSQPSettings(N=N, max_sqp_iters=1, max_pcg_iters=P["max_pcg_iters"])
    hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                            device=dev)
    traj = torch.tensor(figure8(dt).reshape(-1, 6), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    fe = _rand(rng, -5, 5, (B, 6), dev)
    fe[0] = 0.0
    x0 = torch.tensor(np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]),
                      dtype=torch.float32, device=dev)
    X, x_s = x0.expand(B, N, 12).contiguous(), x0.expand(B, 12).contiguous()
    U = torch.zeros(B, N - 1, 6, device=dev)
    lam = torch.zeros(B, N, 12, device=dev)

    def ref(i):
        return traj[i:i + N][None].expand(B, N, 6).contiguous()

    for i in range(6):
        X, U, lam, _, _ = solve_batched(m, settings, cp, hp, X, U, lam, x_s,
                                        ref(i), fe, dt)
        x_s = rk4_step(m, x_s[0], U[0, 0], dt, substeps=10).expand(B, 12).contiguous()
        X[:, 0] = x_s

    zero = torch.zeros(B, device=dev)
    prob = Problem(x_s, ref(5), fe, hp.mu, hp.pcg_tol, dt)
    st0 = IterState(X, U, lam, hp.rho, hp.drho, zero, zero, zero, zero)
    before = sqp_iter_cuda.launches
    ko, ks = sqp_iter_cuda(m, cp, prob, st0, settings, seeded=False)
    torch.cuda.synchronize()
    assert sqp_iter_cuda.launches == before + 1
    ro, rs = sqp_iter_reference(m, cp, prob, st0, settings, seeded=False)
    assert torch.isfinite(ko.X).all() and torch.isfinite(ko.lam).all()
    torch.testing.assert_close(ko.merit0, ro.merit0, rtol=1e-5, atol=0)
    assert (ks.ls_step == rs.ls_step).double().mean() >= 0.95
    assert ((ks.pcg_iters - rs.pcg_iters).abs() <= 3).double().mean() >= 0.95
    same = (ks.ls_step == rs.ls_step) & (ks.pcg_iters == rs.pcg_iters)
    for k, r in ((ko.X, ro.X), (ko.U, ro.U)):
        assert (k[same] - r[same]).abs().max() <= 1e-3 * r[same].abs().max()
    torch.testing.assert_close(ko.conv, ro.conv)
    torch.testing.assert_close(ko.sqp, ro.sqp)

    # three SQP iterations through the chained loop, both routes
    st3 = BSQPSettings(N=N, max_sqp_iters=3, max_pcg_iters=P["max_pcg_iters"])
    before = sqp_iter_cuda.launches
    k3 = solve_batched(m, st3, cp, hp, X, U, lam, x_s, ref(5), fe, dt)
    assert sqp_iter_cuda.launches == before + int(k3[4].num_iters_run)
    r3 = sqp_solve_chained(sqp_iter_reference, m, cp, st3, X, U, lam, x_s,
                           ref(5), fe, hp.rho, hp.drho, hp.mu, hp.pcg_tol, dt)
    assert torch.isfinite(k3[0]).all()
    assert (k3[4].ls_step_size == r3[11]).double().mean() >= 0.9


COST = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                       "q_lim_cost")})


def _problem(dev, B, N, seed):
    """Random float32 inputs at the scale of tests/test_torch_ops.py."""
    rng = np.random.default_rng(seed)
    return dict(X=_rand(rng, -0.3, 0.3, (B, N, 12), dev),
                U=_rand(rng, -5, 5, (B, N - 1, 6), dev),
                x_s=_rand(rng, -0.3, 0.3, (B, 12), dev),
                ref=_rand(rng, -0.5, 0.5, (B, N, 6), dev),
                f_ext=_rand(rng, -3, 3, (B, 6), dev),
                lam=_rand(rng, -0.1, 0.1, (B, N, 12), dev),
                dzx=_rand(rng, -0.05, 0.05, (B, N, 12), dev),
                dzu=_rand(rng, -0.5, 0.5, (B, N - 1, 6), dev),
                rho=_rand(rng, 1e-3, 1e-1, (B,), dev),
                mu=_rand(rng, 8, 13, (B,), dev))


def _launched(wrapper, before):
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1


def test_kkt_and_merit_kernels_match_plain(dev):
    """Every KKTSystem tensor within 1e-4 of its largest |value|; every
    (lane, alpha) merit within 1e-5, relative; N=20 and N=150 (the merit
    block loops over knots past 128)."""
    m = load_robot("indy7", torch.float32, dev)
    for N in (20, 150):
        p = _problem(dev, 16, N, N)
        args = (p["X"], p["U"], p["x_s"], p["ref"], p["f_ext"], 0.01)
        before = setup_kkt_batched_cuda.launches
        k = setup_kkt_batched_cuda(m, COST, *args)
        _launched(setup_kkt_batched_cuda, before)
        r = setup_kkt_batched(m, COST, *args)
        for f in ("Q", "q", "R", "r", "A", "B", "c"):
            a, b = getattr(k, f), getattr(r, f)
            assert torch.isfinite(a).all(), f
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), f
        alphas = [0.0] + [0.5 ** j for j in range(8)]
        margs = (p["X"], p["U"], p["dzx"], p["dzu"], p["x_s"], p["ref"],
                 p["f_ext"], p["mu"], 0.01, alphas)
        before = merit_alphas_batched_cuda.launches
        mk = merit_alphas_batched_cuda(m, COST, *margs)
        _launched(merit_alphas_batched_cuda, before)
        mp = merit_alphas_batched(m, COST, *margs)
        assert ((mk - mp).abs() / mp.abs()).max() <= 1e-5


def test_pcg_kernel_matches_plain(dev):
    """A real Schur system at N=40, 300 and 600 (every block size of the
    kernel): lane 0's warm start holds a NaN (no iterations, max_iters),
    lane 1 is skipped (0, warm start kept); elsewhere counts within 3 and
    lam normwise within 1e-3 where the counts agree. A launch that the
    kernel refuses returns its CUDA error."""
    m = load_robot("indy7", torch.float32, dev)
    for N in (40, 300, 600):
        p = _problem(dev, 8, N, 3 * N)
        kkt = setup_kkt_batched(m, COST, p["X"], p["U"], p["x_s"], p["ref"],
                                p["f_ext"], 0.01)
        sch = build_schur(kkt, p["rho"], 6)
        lam0 = p["lam"].clone()
        lam0[0, N // 2, 3] = float("nan")
        skip = torch.zeros(8, dtype=torch.bool, device=dev)
        skip[1] = True
        eps = torch.full((8,), 1e-4, device=dev)
        system = (sch.S_main, sch.S_lower, sch.P_main, sch.P_lower, sch.gamma,
                  lam0, eps, 200, skip)
        before = pcg_solve_batched_cuda.launches
        lk, ik = pcg_solve_batched_cuda(*system)
        _launched(pcg_solve_batched_cuda, before)
        lp, ip = pcg_solve_batched(*system)
        assert ik[0] == 200 and ik[1] == 0
        torch.testing.assert_close(lk[:2], lam0[:2], equal_nan=True, rtol=0, atol=0)
        diff = (ik - ip)[2:].abs()
        assert diff.max() <= 3
        same = torch.cat([torch.zeros(2, dtype=torch.bool, device=dev), diff == 0])
        assert (lk[same] - lp[same]).abs().max() <= 1e-3 * lp[same].abs().max()
    # nx = 13 is not compiled: the launch function returns an error code
    lib = load_library("pcg")
    lib.gato_pcg.argtypes = [ctypes.POINTER(_PcgArgs), ctypes.c_int, ctypes.c_void_p]
    lib.gato_pcg.restype = ctypes.c_int
    args = _PcgArgs(*([None] * 11), 1, 2, 1)
    assert lib.gato_pcg(ctypes.byref(args), 13,
                        torch.cuda.current_stream().cuda_stream) != 0


def test_iter_kernel_matches_plain(dev):
    """The fused-iteration core at N=24, B=64: PCG counts within 3 on 95 %
    of lanes; dZX, dZU and lam normwise within 1e-3 where the counts agree;
    a skipped lane keeps its warm start and reports 0."""
    m = load_robot("indy7", torch.float32, dev)
    B, N = 64, 24
    p = _problem(dev, B, N, 11)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[5] = True
    tol = torch.full((B,), 1e-4, device=dev)
    args = (p["X"], p["U"], p["x_s"], p["ref"], p["f_ext"], p["lam"], p["rho"],
            tol, skip, 0.01, 200)
    before = sqp_iter_core_cuda.launches
    ko = sqp_iter_core_cuda(m, COST, *args)
    _launched(sqp_iter_core_cuda, before)
    ro = sqp_iter_core_reference(m, COST, *args)
    assert ko[3][5] == 0
    torch.testing.assert_close(ko[2][5], p["lam"][5], rtol=0, atol=0)
    diff = (ko[3] - ro[3]).abs()
    assert (diff <= 3).double().mean() >= 0.95
    same = diff == 0
    for a, b in zip(ko[:3], ro[:3]):
        assert torch.isfinite(a).all()
        assert (a[same] - b[same]).abs().max() <= 1e-3 * b[same].abs().max()


def test_staged_route_solves_past_128_knots(dev):
    """solve_batched at N=136 takes the staged route by itself: one launch
    each of kkt, pcg and merit per SQP iteration, none of bsqp_iter; its
    warm-start merit matches the plain route's, its steps mostly too."""
    m = load_robot("indy7", torch.float32, dev)
    B, N = 8, 136
    p = _problem(dev, B, N, 17)
    settings = BSQPSettings(N=N, max_sqp_iters=1, max_pcg_iters=P["max_pcg_iters"])
    hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                            device=dev)
    wrappers = (setup_kkt_batched_cuda, pcg_solve_batched_cuda,
                merit_alphas_batched_cuda, sqp_iter_cuda)
    before = [w.launches for w in wrappers]
    X, U, lam, _, st = solve_batched(m, settings, COST, hp, p["X"], p["U"],
                                     p["lam"], p["x_s"], p["ref"], p["f_ext"], 0.01)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1, 0]
    assert X.shape == (B, N, 12) and torch.isfinite(X).all()
    r = sqp_solve_chained(sqp_iter_reference, m, COST, settings, p["X"], p["U"],
                          p["lam"], p["x_s"], p["ref"], p["f_ext"], hp.rho,
                          hp.drho, hp.mu, hp.pcg_tol, 0.01)
    torch.testing.assert_close(st.initial_merit, r[6], rtol=1e-5, atol=0)
    assert (st.ls_step_size == r[11]).double().mean() >= 0.75
