"""The port's CUDA kernels against their plain PyTorch versions, on the card.

No jax here: the card's machine has none. Run there with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py configures jax). Without a CUDA device every test skips.
The float32 tolerances: the kernels contract to FMAs, use CUDA's sinf/cosf
and sum in another order; PCG at tol 1e-4 may stop at another count where
the assembly's rounding differs, so the solve is compared on the lanes
where step and count agree. The iteration kernels' limits are fixed, and
give way only where float32 rounding alone moves the float32 plain version
further from the float64 one on the same input (_share, _norm; with -s
each reading prints beside its limit, and PERF.md has them at every
horizon). Every launch is followed by
torch.cuda.synchronize(), so a fault inside a kernel shows where it ran.
"""

import ctypes

import numpy as np
import pytest
import torch

from gato_tpu_torch.api import BSQP, MPC_GATO, add_pendulum
from gato_tpu_torch.api.common import _rk4_algorithms, figure8, rk4_step
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import IIWA14_START_CONFIGS, INDY7_START_CONFIGS
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch._build import load_library
from gato_tpu_torch.ops.cuda_iter import (SMEM_LIMIT, smem_bytes,
                                          sqp_iter_core_cuda,
                                          sqp_iter_core_reference)
from gato_tpu_torch.ops.cuda_kkt import KKT_GROUPS, ONE, setup_kkt_batched_cuda
from gato_tpu_torch.ops.cuda_merit import VARIANTS as MERIT_VARIANTS
from gato_tpu_torch.ops.cuda_merit import merit_alphas_batched_cuda
from gato_tpu_torch.ops.cuda_pcg import (MAX_KNOTS, PLANT_OF_NX, SHARED_GROUPS,
                                         SHARED_MAX_N, _PcgArgs, fits,
                                         pcg_solve_batched_cuda,
                                         pcg_variant)
from gato_tpu_torch.ops.cuda_sim import VARIANTS as RK4_VARIANTS
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

# each plant's start and fig-8 (bench.py --plant)
START = dict(indy7=INDY7_START_CONFIGS["ready"], iiwa14=IIWA14_START_CONFIGS["bent"])
FIG8_SHAPE = dict(indy7={}, iiwa14=dict(A_x=0.25, A_z=0.25, offset=(0.393, -0.393, 0.21)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normwise(a, b):
    if a.numel() == 0:
        return 0.0
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def _share(k, p, p64, fixed, slack=0):
    """(the kernel k's share of lanes agreeing with the float32 plain
    version p within slack, p's share agreeing with the float64 plain
    version p64, the least share k may show): `fixed`, or p's own share
    where that is smaller, at least 0.8."""
    def agree(a, b):
        return ((a.double() - b.double()).abs() <= slack).double().mean().item()

    plain = agree(p, p64)
    return agree(k, p), plain, max(0.8, min(fixed, plain))


def _norm(k, p, p64, same, quiet):
    """(k's normwise distance from the float32 plain version p on the lanes
    `same`, p's from the float64 plain version p64 on the lanes `quiet`,
    where p's step and count agree with p64's, the limit): 1e-3, or twice
    p's distance where that is larger, since two float32 results that far
    from float64 may lie twice as far apart; at most 5e-3."""
    noise = _normwise(p[quiet], p64[quiet])
    return _normwise(k[same], p[same]), noise, min(5e-3, max(1e-3, 2 * noise))


def _check(what, kernel, plain, limit, at_least=False):
    """Hold a kernel's reading to its limit, printed beside the float32
    plain version's own reading against float64 (pytest -s shows it)."""
    print(f"{what}: kernel {kernel:.4e}, plain32 against float64 {plain:.4e}, "
          f"limit {'>=' if at_least else '<='} {limit:.4e}")
    assert kernel >= limit if at_least else kernel <= limit, what


def _rand(rng, lo, hi, shape, dev):
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("robot", ("indy7", "iiwa14", "indy7+pendulum", "iiwa14+pendulum"))
@pytest.mark.parametrize("variant", RK4_VARIANTS)
@pytest.mark.parametrize("B", (1, 512))
def test_rk4_kernel_matches_plain(dev, B, variant, robot):
    """Both rk4 variants (a thread a plant, the default; a CTA of two warps
    a plant) for every plant it serves (the pendulum plants from their
    generated libraries, 15 kg at 0.3 m), at the plant's B = 1 and at
    B = 512, with and without a wrench: within 1e-5 of the plain version.
    On the pendulum plants these inputs drive the gimbal (armature 5e-3 kg
    m^2) with up to 5 N m, a thousand rad/s^2, which amplifies float32
    rounding past 1e-5 in the plain version too (up to 1.2e-4 from the
    kernel on the card): there the kernel is held by the float64 rule, its
    largest distance from the float64 plain version within twice the
    float32 plain version's, or within 1e-5 of the largest |x|."""
    base, _, pendulum = robot.partition("+")
    m = load_robot(base, torch.float32, dev)
    if pendulum:
        m = add_pendulum(m, mass=15.0, length=0.3)
        m64 = add_pendulum(load_robot(base, torch.float64, dev), mass=15.0, length=0.3)
    rng = np.random.default_rng(5)
    x, u, fe = (_rand(rng, -1, 1, (B, m.nx), dev), _rand(rng, -5, 5, (B, m.nu), dev),
                _rand(rng, -5, 5, (B, 6), dev))
    for f in (None, fe):
        before = rk4_step_batched.launches
        out = rk4_step_batched(m, x, u, 0.01, f, 2, variant=variant)
        torch.cuda.synchronize()
        assert rk4_step_batched.launches == before + 1
        plain = rk4_plain(m, x, u, 0.01, f, 2)
        if not pendulum:
            torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
            continue
        ref = rk4_plain(m64, x.double(), u.double(), 0.01,
                        None if f is None else f.double(), 2)
        err = (out.double() - ref).abs().max().item()
        limit = max(2 * (plain.double() - ref).abs().max().item(),
                    1e-5 * ref.abs().max().item())
        assert torch.isfinite(out).all() and err <= limit, (err, limit)


# both layouts of the iteration kernels (shared up to N = 64), their edge
# and a partial last warp (33), in the phase A that N takes (None: staged
# up to N = 64); and the one-thread phase A forced in the shared layout
HORIZONS = ((8, None), (33, None), (64, None), (65, None), (128, None),
            (8, "one"), (33, "one"), (64, "one"))
# bsqp_iter for both plants: iiwa14's phase A is the one-thread one at
# every N, its shared layout G = 2 up to N = 64
BSQP_CASES = ([("indy7",) + h for h in HORIZONS]
              + [("iiwa14", n, None) for n in (8, 33, 64, 65, 128)])


@pytest.mark.parametrize("robot,N,phase_a", BSQP_CASES)
def test_bsqp_iter_kernel_matches_reference(dev, robot, N, phase_a):
    """One SQP iteration on a warm fig-8 steady state (B=64,
    DEFAULT_SOLVER_PARAMS, 6 warm-up cycles on the kernel route; indy7's
    ready start and fig-8, iiwa14's as bench.py --plant iiwa14 sets them),
    in the variant that N takes (ops/cuda_iter.py::iteration_variant) with
    the phase A given: the warm-start merit within 1e-5; steps equal and
    PCG counts within 3 on 95 % of lanes; X and U normwise within 1e-3
    where step and count agree; three chained iterations with equal steps
    on 90 %. Where the float32 plain version itself agrees less with the
    float64 one, these give way (_share, _norm)."""
    B, dt = 64, 0.01
    m = load_robot(robot, torch.float32, dev)
    nq, nx = m.nq, m.nx
    cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                         "q_lim_cost")})
    settings = BSQPSettings(N=N, max_sqp_iters=1, max_pcg_iters=P["max_pcg_iters"])
    hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                            device=dev)
    traj = torch.tensor(figure8(dt, **FIG8_SHAPE[robot]).reshape(-1, 6), dtype=torch.float32,
                        device=dev)
    rng = np.random.default_rng(0)
    fe = _rand(rng, -5, 5, (B, 6), dev)
    fe[0] = 0.0
    x0 = torch.tensor(np.concatenate([START[robot], np.zeros(nq)]),
                      dtype=torch.float32, device=dev)
    X, x_s = x0.expand(B, N, nx).contiguous(), x0.expand(B, nx).contiguous()
    U = torch.zeros(B, N - 1, nq, device=dev)
    lam = torch.zeros(B, N, nx, device=dev)

    def ref(i):
        return traj[i:i + N][None].expand(B, N, 6).contiguous()

    for i in range(6):
        X, U, lam, _, _ = solve_batched(m, settings, cp, hp, X, U, lam, x_s,
                                        ref(i), fe, dt)
        x_s = rk4_step(m, x_s[0], U[0, 0], dt, substeps=10).expand(B, nx).contiguous()
        X[:, 0] = x_s

    zero = torch.zeros(B, device=dev)
    prob = Problem(x_s, ref(5), fe, hp.mu, hp.pcg_tol, dt)
    st0 = IterState(X, U, lam, hp.rho, hp.drho, zero, zero, zero, zero)
    before = sqp_iter_cuda.launches
    ko, ks = sqp_iter_cuda(m, cp, prob, st0, settings, seeded=False, phase_a=phase_a)
    torch.cuda.synchronize()
    assert sqp_iter_cuda.launches == before + 1
    ro, rs = sqp_iter_reference(m, cp, prob, st0, settings, seeded=False)
    m64 = load_robot(robot, torch.float64, dev)
    prob64 = Problem(*(t.double() for t in prob[:5]), dt)
    st64 = IterState(*(t.double() for t in st0))
    o64, s64 = sqp_iter_reference(m64, cp, prob64, st64, settings, seeded=False)
    assert torch.isfinite(ko.X).all() and torch.isfinite(ko.lam).all()
    torch.testing.assert_close(ko.merit0, ro.merit0, rtol=1e-5, atol=0)
    _check(f"bsqp_iter N={N} steps equal", *_share(ks.ls_step, rs.ls_step,
                                                   s64.ls_step, 0.95), at_least=True)
    _check(f"bsqp_iter N={N} PCG counts within 3", *_share(
        ks.pcg_iters, rs.pcg_iters, s64.pcg_iters, 0.95, 3), at_least=True)
    same = (ks.ls_step == rs.ls_step) & (ks.pcg_iters == rs.pcg_iters)
    quiet = (same & (rs.ls_step.double() == s64.ls_step)
             & ((rs.pcg_iters - s64.pcg_iters).abs() <= 3))
    for name, k, r, r64 in (("X", ko.X, ro.X, o64.X), ("U", ko.U, ro.U, o64.U)):
        _check(f"bsqp_iter N={N} {name}", *_norm(k, r, r64, same, quiet))
    torch.testing.assert_close(ko.conv, ro.conv)
    torch.testing.assert_close(ko.sqp, ro.sqp)

    # three SQP iterations through the chained loop, both routes
    st3 = BSQPSettings(N=N, max_sqp_iters=3, max_pcg_iters=P["max_pcg_iters"])
    before = sqp_iter_cuda.launches
    k3 = solve_batched(m, st3, cp, hp, X, U, lam, x_s, ref(5), fe, dt)
    assert sqp_iter_cuda.launches == before + int(k3[4].num_iters_run)
    r3 = sqp_solve_chained(sqp_iter_reference, m, cp, st3, X, U, lam, x_s,
                           ref(5), fe, hp.rho, hp.drho, hp.mu, hp.pcg_tol, dt)
    r64 = sqp_solve_chained(sqp_iter_reference, m64, cp, st3,
                            *(t.double() for t in (X, U, lam, x_s, ref(5), fe, hp.rho,
                                                   hp.drho, hp.mu, hp.pcg_tol)), dt)
    assert torch.isfinite(k3[0]).all()
    _check(f"bsqp_iter N={N} chained steps equal",
           *_share(k3[4].ls_step_size, r3[11], r64[11], 0.9), at_least=True)


COST = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                       "q_lim_cost")})


def _problem(dev, B, N, seed, nq=6):
    """Random float32 inputs at the scale of tests/test_torch_ops.py for a
    plant of nq joints."""
    rng = np.random.default_rng(seed)
    nx = 2 * nq
    return dict(X=_rand(rng, -0.3, 0.3, (B, N, nx), dev),
                U=_rand(rng, -5, 5, (B, N - 1, nq), dev),
                x_s=_rand(rng, -0.3, 0.3, (B, nx), dev),
                ref=_rand(rng, -0.5, 0.5, (B, N, 6), dev),
                f_ext=_rand(rng, -3, 3, (B, 6), dev),
                lam=_rand(rng, -0.1, 0.1, (B, N, nx), dev),
                dzx=_rand(rng, -0.05, 0.05, (B, N, nx), dev),
                dzu=_rand(rng, -0.5, 0.5, (B, N - 1, nq), dev),
                rho=_rand(rng, 1e-3, 1e-1, (B,), dev),
                mu=_rand(rng, 8, 13, (B,), dev))


def _launched(wrapper, before):
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("robot,variant", [("indy7", ("staged", KKT_GROUPS)), ("indy7", ONE),
                                           ("iiwa14", ONE)])
@pytest.mark.parametrize("N", (2, 31, 33, 256))
def test_kkt_and_merit_kernels_match_plain(dev, N, robot, variant):
    """Every KKTSystem tensor within 1e-4 of its largest |value|, in each
    kkt kernel a plant's library compiles (indy7: the staged kernel and the
    one-thread one; iiwa14: the one-thread one), at N=2 (several problems
    in a CTA), 31 and 33 (knots of two problems in a CTA) and 256; every
    (lane, alpha) merit within 1e-5, relative (the merit block loops over
    knots past 128)."""
    m = load_robot(robot, torch.float32, dev)
    p = _problem(dev, 16, N, N, m.nq)
    args = (p["X"], p["U"], p["x_s"], p["ref"], p["f_ext"], 0.01)
    before = setup_kkt_batched_cuda.launches
    k = setup_kkt_batched_cuda(m, COST, *args, variant=variant)
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


@pytest.mark.parametrize("variant", MERIT_VARIANTS)
@pytest.mark.parametrize("N", (32, 256))
def test_merit_kernel_variants_match_plain(dev, N, variant):
    """Every merit variant at N = 32 (a warp of knots a pair) and 256 (a
    pair over several warps, looping): every (lane, alpha) merit within
    1e-5, relative."""
    m = load_robot("indy7", torch.float32, dev)
    p = _problem(dev, 24, N, N + 1)
    alphas = [0.0] + [0.5 ** j for j in range(8)]
    margs = (p["X"], p["U"], p["dzx"], p["dzu"], p["x_s"], p["ref"],
             p["f_ext"], p["mu"], 0.01, alphas)
    before = merit_alphas_batched_cuda.launches
    mk = merit_alphas_batched_cuda(m, COST, *margs, variant=variant)
    _launched(merit_alphas_batched_cuda, before)
    mp = merit_alphas_batched(m, COST, *margs)
    assert ((mk - mp).abs() / mp.abs()).max() <= 1e-5


# the pcg kernel's variants at their edges, for each plant's library: the
# shared variant's last N and the first cluster one, clusters at 256 and
# 600, the largest N; a 2-CTA cluster at G=2 past the 4-CTA clusters' last
# N (where its CTAs' knots fit: to N = 186 for indy7, 138 for iiwa14's
# 14x14 blocks) and the global variant forced
PCG_CASES = tuple((robot, n, v) for robot, nx, n2 in (("indy7", 12, 150), ("iiwa14", 14, 136))
                  for n, v in ((SHARED_MAX_N[nx], None), (SHARED_MAX_N[nx] + 1, None),
                               (256, None), (600, None), (MAX_KNOTS, None),
                               (n2, ("cluster", 2, 2)), (300, ("global", 1, 1))))


@pytest.mark.parametrize("robot,N,variant", PCG_CASES)
def test_pcg_kernel_matches_plain(dev, robot, N, variant):
    """A real Schur system of the plant at N, in the variant that
    pcg_variant(N, nx) takes or the one forced: lane 0's warm start holds a
    NaN (no iterations, max_iters), lane 1 is skipped (0, warm start kept);
    elsewhere counts within 3 and lam normwise within 1e-3 where the counts
    agree. A launch that the kernel refuses returns its CUDA error, and the
    wrapper raises."""
    m = load_robot(robot, torch.float32, dev)
    nx = m.nx
    p = _problem(dev, 8, N, 3 * N, m.nq)
    kkt = setup_kkt_batched(m, COST, p["X"], p["U"], p["x_s"], p["ref"],
                            p["f_ext"], 0.01)
    sch = build_schur(kkt, p["rho"], m.nq)
    lam0 = p["lam"].clone()
    lam0[0, N // 2, 3] = float("nan")
    skip = torch.zeros(8, dtype=torch.bool, device=dev)
    skip[1] = True
    eps = torch.full((8,), 1e-4, device=dev)
    system = (sch.S_main, sch.S_lower, sch.P_main, sch.P_lower, sch.gamma,
              lam0, eps, 200, skip)
    before = pcg_solve_batched_cuda.launches
    lk, ik = pcg_solve_batched_cuda(*system, variant=variant)
    _launched(pcg_solve_batched_cuda, before)
    lp, ip = pcg_solve_batched(*system)
    print(f"pcg {robot} N={N} {variant or pcg_variant(N, nx)}: counts {ik.tolist()}, "
          f"plain {ip.tolist()}")
    assert ik[0] == 200 and ik[1] == 0
    torch.testing.assert_close(lk[:2], lam0[:2], equal_nan=True, rtol=0, atol=0)
    diff = (ik - ip)[2:].abs()
    assert diff.max() <= 3
    same = torch.cat([torch.zeros(2, dtype=torch.bool, device=dev), diff == 0])
    assert (lk[same] - lp[same]).abs().max() <= 1e-3 * lp[same].abs().max()
    if N > SHARED_MAX_N[nx] and not fits(N, "shared", SHARED_GROUPS[nx], 1, nx=nx):
        with pytest.raises(RuntimeError, match="pcg kernel launch"):
            pcg_solve_batched_cuda(*system, variant=("shared", SHARED_GROUPS[nx], 1))
    # another nx than the plant's is not compiled: the library's launch
    # function returns an error code
    entry = getattr(load_library("pcg", robot), f"gato_pcg_{PLANT_OF_NX[nx]}")
    entry.argtypes = [ctypes.POINTER(_PcgArgs), ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    args = _PcgArgs(*([None] * 11), 1, 2, 1, 0, 1, 1)
    other = 14 if nx == 12 else 12
    assert entry(ctypes.byref(args), other, torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.parametrize("N,phase_a", HORIZONS)
def test_iter_kernel_matches_plain(dev, N, phase_a):
    """The fused-iteration core at B=64 on random inputs, in the variant
    that N takes with the phase A given: PCG counts within 3 on 95 % of
    lanes; dZX, dZU and lam,
    where the counts agree, within 1e-3 normwise, or where the float32
    plain version itself agrees less with the float64 one, as _share and
    _norm give way; a skipped lane keeps its warm start and reports
    0. Where the shared layout does not fit, a launch of it is refused and
    raises."""
    m = load_robot("indy7", torch.float32, dev)
    B = 64
    p = _problem(dev, B, N, 11)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[5] = True
    tol = torch.full((B,), 1e-4, device=dev)
    args = (p["X"], p["U"], p["x_s"], p["ref"], p["f_ext"], p["lam"], p["rho"],
            tol, skip, 0.01, 200)
    before = sqp_iter_core_cuda.launches
    ko = sqp_iter_core_cuda(m, COST, *args, phase_a=phase_a)
    _launched(sqp_iter_core_cuda, before)
    ro = sqp_iter_core_reference(m, COST, *args)
    m64 = load_robot("indy7", torch.float64, dev)
    o64 = sqp_iter_core_reference(m64, COST, *(t.double() for t in args[:8]),
                                  *args[8:])
    assert ko[3][5] == 0
    torch.testing.assert_close(ko[2][5], p["lam"][5], rtol=0, atol=0)
    _check(f"iter N={N} PCG counts within 3", *_share(ko[3], ro[3], o64[3], 0.95, 3),
           at_least=True)
    same = ko[3] == ro[3]
    quiet = same & ((ro[3] - o64[3]).abs() <= 3)
    for name, a, b, b64 in zip(("dZX", "dZU", "lam"), ko[:3], ro[:3], o64[:3]):
        assert torch.isfinite(a).all()
        _check(f"iter N={N} {name}", *_norm(a, b, b64, same, quiet))
    if smem_bytes(N, "shared", 1) > SMEM_LIMIT:
        with pytest.raises(RuntimeError, match="shared layout"):
            sqp_iter_core_cuda(m, COST, *args, variant=("shared", 1))


@pytest.mark.parametrize("robot", ("indy7", "iiwa14"))
def test_staged_route_solves_past_128_knots(dev, robot):
    """solve_batched at N=136 takes the staged route by itself, for each
    plant: one launch each of kkt, pcg and merit per SQP iteration, none of
    bsqp_iter; its warm-start merit matches the plain route's, its steps
    mostly too."""
    m = load_robot(robot, torch.float32, dev)
    B, N = 8, 136
    p = _problem(dev, B, N, 17, m.nq)
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
    assert X.shape == (B, N, m.nx) and torch.isfinite(X).all()
    r = sqp_solve_chained(sqp_iter_reference, m, COST, settings, p["X"], p["U"],
                          p["lam"], p["x_s"], p["ref"], p["f_ext"], hp.rho,
                          hp.drho, hp.mu, hp.pcg_tol, 0.01)
    torch.testing.assert_close(st.initial_merit, r[6], rtol=1e-5, atol=0)
    assert (st.ls_step_size == r[11]).double().mean() >= 0.75


@pytest.mark.parametrize("robot", ("indy7", "iiwa14"))
def test_facade_takes_one_bsqp_iter_launch_per_solve(dev, robot):
    """The BSQP facade on the card, its default device, at N=32 B=16
    DEFAULT_SOLVER_PARAMS, for both plants: one bsqp_iter launch a solve
    and no other kernel's; its warm start, duals and rho equal bit for bit
    a direct solve_batched call on the same inputs; the solve's device time
    by CUDA events in the stats."""
    B, N = 16, 32
    fac = BSQP(plant_type=robot, batch_size=B, N=N, dt=0.01, **{k: P[k] for k in (
        "max_sqp_iters", "max_pcg_iters", "pcg_tol", "mu", "q_cost", "qd_cost", "u_cost",
        "N_cost", "q_lim_cost", "rho")})
    assert fac.device.type == "cuda"
    p = _problem(dev, B, N, 23, fac.model.nq)
    fac.set_f_ext_B(p["f_ext"])
    fac.XU_B, fac.lam = fac._flatten(p["X"], p["U"]), p["lam"].clone()
    xcur, ref = p["x_s"].cpu().numpy(), p["ref"].cpu().numpy()
    XU_in = fac.XU_B.copy()
    XU_in[:, :fac.model.nx] = xcur
    hp0, lam0 = fac.hp, fac.lam
    wrappers = (setup_kkt_batched_cuda, pcg_solve_batched_cuda, merit_alphas_batched_cuda,
                sqp_iter_core_cuda, rk4_step_batched, sqp_iter_cuda)
    before = [w.launches for w in wrappers]
    XU, _ = fac.solve(xcur, ref)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 0, 0, 0, 0, 1]
    X, U = fac._unflatten(XU_in)
    Xo, Uo, lamo, hpo, _ = solve_batched(
        fac.model, fac.settings, fac.cost_params, hp0, X, U, lam0,
        torch.tensor(xcur, device=dev), torch.tensor(ref, device=dev), fac.f_ext_B, 0.01)
    np.testing.assert_array_equal(XU, fac._flatten(Xo, Uo))
    assert torch.equal(fac.lam, lamo) and torch.equal(fac.hp.rho, hpo.rho)
    assert fac.stats["sqp_time_us_device"] > 0
    assert fac.stats["pcg_iters"].shape == (1, B)


def test_rk4_step_routes_on_card(dev):
    """api.common.rk4_step on the card: indy7 or iiwa14 without a world
    wrench launches the rk4 kernel once and equals rk4_step_batched bit for
    bit; a world wrench launches no kernel and takes the rigid-body
    algorithms; the pendulum plant (its library generated at the first
    call) launches the rk4 kernel once. Both are within rtol 1e-4 of the
    same algorithms in float64 on the CPU (float32 forward dynamics)."""
    rng = np.random.default_rng(29)
    for robot in ("iiwa14", "indy7"):
        m = load_robot(robot, torch.float32, dev)
        x, u = _rand(rng, -1, 1, (m.nx,), dev), _rand(rng, -5, 5, (m.nu,), dev)
        before = rk4_step_batched.launches
        out = rk4_step(m, x, u, 0.01, substeps=2)
        torch.cuda.synchronize()
        assert rk4_step_batched.launches == before + 1
        assert torch.equal(out, rk4_step_batched(m, x[None], u[None], 0.01, substeps=2)[0])
    w = torch.tensor([0.0, 0.0, -60.0, 1.0, 0.0, 0.0], device=dev)
    m64 = load_robot("indy7", torch.float64, "cpu")
    pend = add_pendulum(m)
    xp, up = _rand(rng, -0.5, 0.5, (18,), dev), _rand(rng, -5, 5, (9,), dev)
    for model, model64, xs, us, wrench, kernel_launches in (
            (m, m64, x, u, w, 0), (pend, add_pendulum(m64), xp, up, None, 1)):
        before = rk4_step_batched.launches
        got = rk4_step(model, xs, us, 0.01, f_ext_world=wrench, substeps=2)
        torch.cuda.synchronize()
        assert rk4_step_batched.launches == before + kernel_launches
        want = _rk4_algorithms(model64, xs.cpu().double(), us.cpu().double(), 0.01,
                               None if wrench is None else wrench.cpu().double(), 2)
        assert torch.isfinite(got).all()
        assert (got.cpu().double() - want).abs().max() <= 1e-4 * want.abs().max()


def test_mpc_graphed_plant_step_equals_eager(dev):
    """MPC_GATO under a world wrench replays its plant step (the rigid-body
    algorithms) from a CUDA graph: the same states bit for bit as the
    eager step, over 20 cycles of the fig-8 loop (N=8, B=4)."""
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)
    runs = []
    for graphed in (True, False):
        mpc = MPC_GATO(plant_type="indy7", N=8, dt=0.01, batch_size=4,
                       constant_f_ext=[0.0, 0.0, -60.0, 0.0, 0.0, 0.0])
        assert mpc._graphs == {}
        if not graphed:
            mpc._graphs = None
        _, stats = mpc.run_mpc_fig8(x0, figure8(0.01), sim_dt=1e-3, sim_time=0.2)
        runs.append(np.asarray(stats["joint_positions"]))
    assert np.isfinite(runs[0]).all()
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("estimator", [None, "sphere", "observer", "iiwa14", "iiwa14 goals"])
def test_rollout_graph_replay_equals_eager(dev, estimator):
    """The rollouts' cycles replayed from their CUDA graph against the same
    cycles run eagerly, bit for bit (N=8, B=8, 12 cycles): the fig-8
    rollout (one bsqp_iter and one rk4 launch in the captured cycle) and the
    force-adaptive rollout in both modes (rk4 with a wrench), on indy7; the
    fig-8 rollout with iiwa14 as solver and plant ("iiwa14"), and
    examples/pickplace.py's device loop ("iiwa14 goals":
    gato_tpu_torch.examples.pickplace_device, iiwa14 + 15 kg pendulum
    plant, five bsqp_iter launches and one rk4 launch a captured cycle: the
    pendulum plant on its generated rk4 library)."""
    from gato_tpu_torch.api import rollout as R

    if estimator == "iiwa14 goals":
        from gato_tpu_torch.examples import pickplace_device as pp

        runs = [pp.run(8, N=8, n_steps=12, device=dev, graph=graph)[1]
                for graph in (True, False)]
        torch.cuda.synchronize()
        assert R.last_capture["launches"] == {"bsqp_iter": 5, "rk4": 1}
        for g, e in zip(*runs):
            assert torch.isfinite(g.float()).all() and torch.equal(g, e)
        return
    robot = "iiwa14" if estimator == "iiwa14" else "indy7"
    if estimator == "iiwa14":
        estimator = None

    model = load_robot(robot, torch.float32, dev)
    n, b, steps = 8, 8, 12
    settings = BSQPSettings(N=n, max_sqp_iters=1, max_pcg_iters=50)
    cp = CostParams(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0, q_lim_cost=0.01)
    hp = HyperParams.create(b, rho=0.01, mu=10.0, pcg_tol=1e-4, device=dev)
    x0 = torch.tensor(np.concatenate([START[robot], np.zeros(model.nq)]),
                      dtype=torch.float32, device=dev)
    traj = torch.tensor(figure8(0.01, **FIG8_SHAPE[robot]).reshape(-1, 6),
                        dtype=torch.float32, device=dev)
    refs = torch.stack([traj[k:k + n] for k in range(steps)])
    draws = torch.rand(steps, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    f_ext = torch.rand(b, 6, generator=torch.Generator().manual_seed(1)).to(dev) * 10 - 5
    f_ext[0] = 0.0

    def run(graph):
        if estimator is None:
            return R.closed_loop_rollout(model, model, settings, cp, hp, x0, refs, f_ext,
                                         0.01, 0.01, sim_substeps=2, graph=graph)
        return R.closed_loop_rollout_estimator(
            model, settings, cp, hp, x0, refs, torch.tensor([12.0, -8.0, 5.0, 0, 0, 0], device=dev),
            0.01, 0.01, b, draws, sim_substeps=2, estimator=estimator, graph=graph)

    graphed = run(True)
    torch.cuda.synchronize()
    assert R.last_capture["launches"] == {"bsqp_iter": 1, "rk4": 1}
    eager = run(False)
    torch.cuda.synchronize()
    for g, e in zip(graphed, eager):
        assert torch.isfinite(g).all() and torch.equal(g, e)


@pytest.mark.parametrize("N", (8, 256))
def test_fleet_graph_replay_equals_eager(dev, N):
    """The mixed indy7 + iiwa14 fleet's cycle (examples/mixed_fleet.py,
    B=4 each) replayed from its CUDA graph equals the same cycles run
    eagerly, bit for bit (device_cycle_time holds it over 4 cycles): at
    N=8 each member's bsqp_iter and rk4 in the captured cycle, at N=256
    each member's kkt, pcg, merit and rk4 (the staged route, its Schur
    inverse in the capturable form)."""
    from gato_tpu_torch.examples import mixed_fleet as mf

    members, trajs = [], {}
    for name, q0, off, amp in mf.SPECS:
        m, traj = mf.make_member(name, name, q0, off, 4, N, 0.01, 0, amp, device=dev)
        members.append(m)
        trajs[name] = traj
    out = mf.device_cycle_time(members, trajs, N, reps=3)
    per = dict(bsqp_iter=1, rk4=1) if N <= 128 else dict(kkt=1, pcg=1, merit=1, rk4=1)
    assert out["same_as_eager"] and out["ms"] > 0
    assert out["launches"] == {k: 2 * per.get(k, 0) for k in mf.WRAPPERS}


@pytest.fixture
def world_of_one(dev, request):
    """A process group of this process alone over request.param's backend
    (NCCL or gloo), left after the test."""
    import torch.distributed as dist
    from gato_tpu_torch.parallel.sharding import free_port

    dist.init_process_group(request.param, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    yield request.param
    dist.destroy_process_group()


@pytest.mark.parametrize("world_of_one", ["nccl"], indirect=True)
@pytest.mark.parametrize("gates", [("auto", "auto"), ("off", "auto")], ids=("solve", "iter"))
def test_sharded_solve_world_of_one(dev, world_of_one, gates):
    """solve_batched_sharded over an NCCL world of one on the card equals
    solve_batched bit for bit on routes "solve" and "iter" (the count's
    all-reduce on the card), with the exit read on the host and kept on
    the device; best_lane is the unsharded merits' argmin."""
    from gato_tpu_torch.parallel.sharding import (best_lane, make_mesh, shard_solve_args,
                                                  solve_batched_sharded)

    B, N = 64, 32
    p = _problem(dev, B, N, seed=11)
    model = load_robot("indy7", torch.float32, dev)
    hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"], device=dev)
    st = BSQPSettings(N=N, max_sqp_iters=3, max_pcg_iters=P["max_pcg_iters"],
                      solve_ratio=0.25, solve_kernel=gates[0], iter_kernel=gates[1])
    args = [p[k] for k in ("X", "U", "lam", "x_s", "ref", "f_ext")]
    mesh = make_mesh()
    for device_exit in (False, True):
        want = solve_batched(model, st, COST, hp, *args, 0.01, device_exit=device_exit)
        X, U, lam, x_s, ref, fe, hp_s = shard_solve_args(mesh, *args, hp)
        got = solve_batched_sharded(model, st, COST, hp_s, X, U, lam, x_s, ref, fe, 0.01,
                                    mesh=mesh, device_exit=device_exit)
        torch.cuda.synchronize()
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert torch.equal(got[3].rho, want[3].rho)
        for k in ("sqp_iters", "kkt_converged", "pcg_iters", "ls_step_size", "final_merit",
                  "num_iters_run"):
            assert torch.equal(getattr(got[4], k), getattr(want[4], k)), k
    m = want[4].final_merit
    assert int(best_lane(got[4].final_merit, mesh)) == int(
        torch.argmin(torch.where(torch.isfinite(m), m, torch.inf)))


@pytest.mark.parametrize("world_of_one", ["gloo"], indirect=True)
def test_sharded_device_exit_over_gloo_raises(dev, world_of_one):
    """A gloo mesh on the card takes the count through host memory: the
    device exit (a CUDA graph's) refuses it, and the fleet's mesh over it
    still solves with the host exit, equal to the unsharded fleet."""
    from gato_tpu_torch.examples import mixed_fleet as mf
    from gato_tpu_torch.parallel import fleet
    from gato_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh()
    members = [mf.make_member(n, n, q0, off, 4, 8, 0.01, 0, amp, device=dev)[0]
               for n, q0, off, amp in mf.SPECS]
    with pytest.raises(ValueError, match="gloo"):
        fleet.solve_fleet(members, mesh=mesh, device_exit=True)
    want, _ = fleet.solve_fleet(members)
    got, stats = fleet.solve_fleet(members, mesh=mesh)
    for g, w in zip(got, want):
        assert torch.equal(g.X, w.X) and torch.equal(g.U, w.U) and torch.equal(g.lam, w.lam)
    assert fleet.fleet_report(got, stats)["total_lanes"] == 8
