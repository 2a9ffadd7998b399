"""The pcg kernel's variants and what surrounds them, on the CPU:

- ops/cuda_pcg.py::pcg_variant at every horizon the kernel takes, with the
  shared-memory formula of csrc/pcg.cu (smem_bytes), the knots of each CTA
  of a cluster and its halo;
- the cluster variant's cut of the block-tridiagonal matvec: each CTA's
  rows from its own blocks, its halo and its neighbours' edge rows equal
  ops/schur.py::btd_matvec;
- the wrapper's plain version on CPU tensors, whatever variant is named;
- the float32 PCG on a fig-8 steady-state Schur system against the JAX
  package's pcg_channels in float32 (the counts lane by lane, the cap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gato_tpu.ops.pallas_pcg import pcg_channels
from gato_tpu_torch.api.common import figure8, rk4_step
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import INDY7_START_CONFIGS
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.ops.cuda_pcg import (CLUSTER_SIZES, MAX_KNOTS,
                                         PORTABLE_CLUSTER, SHARED_MAX_N,
                                         SMEM_LIMIT, cta_ranges, fits,
                                         pcg_solve_batched_cuda, pcg_variant,
                                         smem_bytes, threads)
from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from gato_tpu_torch.ops.schur import btd_matvec, build_schur, mv
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams
from torch_port_helpers import _bcast_chan, _to_chan


def test_pcg_variant_fits_every_horizon():
    """For every N from 1 to 1024 the variant that N takes fits a CTA's
    232,448 bytes and 1024 threads; a cluster's CTAs hold every knot exactly
    once, each but rank 0 with the halo; a cluster holds at most 8 CTAs, or
    16 (csrc/pcg.cu sets cudaFuncAttributeNonPortableClusterSizeAllowed
    past 8). The shared variant runs up to SHARED_MAX_N and no further than
    it fits; smem_bytes is csrc/pcg.cu's formula: 600 floats a slot (its
    knots, and in a cluster a halo slot on either side), two partials a
    thread, 8 totals and 48 floats of halo rows."""
    layouts = {}
    for N in range(1, MAX_KNOTS + 1):
        layout, g, c = pcg_variant(N)
        layouts.setdefault(layout, []).append(N)
        assert fits(N, layout, g, c)
        assert smem_bytes(N, layout, g, c) <= SMEM_LIMIT
        assert threads(N, layout, g, c) <= 1024
        if layout == "cluster":
            assert c in CLUSTER_SIZES and (c <= PORTABLE_CLUSTER or c == 16)
            ranges = cta_ranges(N, c)
            knots = [k for k0, n, _ in ranges for k in range(k0, k0 + n)]
            assert knots == list(range(N))
            assert all(n >= 1 for _, n, _ in ranges)
            assert [h for _, _, h in ranges] == [False] + [True] * (c - 1)
        else:
            assert c == 1
    assert layouts["shared"] == list(range(1, SHARED_MAX_N + 1))
    assert min(layouts["cluster"]) == SHARED_MAX_N + 1
    for N, g, c, nbytes in ((32, 4, 1, 80_448), (95, 4, 1, 231_296),
                            (256, 4, 8, 85_248), (256, 1, 16, 46_080)):
        layout = "shared" if c == 1 else "cluster"
        assert smem_bytes(N, layout, g, c) == nbytes
    assert smem_bytes(256, "global") == 4 * (3 * 256 * 12 + 32)


def test_cluster_cut_matvec_matches_btd_matvec():
    """Each CTA of a cluster computes its knots' rows of the block-
    tridiagonal matvec from its own main and lower blocks, the halo (knot
    k0 - 1's lower block) and the x rows of the knots just outside its
    range (the neighbours' edge rows): together btd_matvec, at N = 100 for
    every cluster size."""
    rng = np.random.default_rng(3)
    B, N, nx = 2, 100, 12
    main = torch.tensor(rng.normal(size=(B, N, nx, nx)))
    lower = torch.tensor(rng.normal(size=(B, N - 1, nx, nx)))
    x = torch.tensor(rng.normal(size=(B, N, nx)))
    want = btd_matvec(main, lower, x)
    for c in CLUSTER_SIZES:
        got = torch.zeros_like(want)
        for k0, n, halo in cta_ranges(N, c):
            ks = range(k0, k0 + n)
            held = {k: lower[:, k] for k in range(k0 - halo, min(k0 + n, N - 1))}
            for k in ks:
                y = mv(main[:, k], x[:, k])
                if k > 0:
                    y = y + mv(held[k - 1], x[:, k - 1])
                if k < N - 1:
                    y = y + mv(held[k].mT, x[:, k + 1])
                got[:, k] = y
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors pcg_solve_batched_cuda is pcg_solve_batched, bit for
    bit, whatever variant is named (the variant is the kernel's)."""
    rng = np.random.default_rng(1)
    B, N, nx = 3, 20, 12
    A = rng.normal(size=(B, N, nx, nx)) * 0.1
    main = torch.tensor(A @ A.transpose(0, 1, 3, 2) + 4 * np.eye(nx))
    lower = torch.tensor(rng.normal(size=(B, N - 1, nx, nx)) * 0.05)
    pm = torch.linalg.inv(main)
    pl = torch.zeros_like(lower)
    gamma = torch.tensor(rng.normal(size=(B, N, nx)))
    lam0 = torch.zeros(B, N, nx, dtype=torch.float64)
    eps = torch.full((B,), 1e-8, dtype=torch.float64)
    skip = torch.tensor([False, True, False])
    want = pcg_solve_batched(main, lower, pm, pl, gamma, lam0, eps, 100, skip)
    for variant in (None, ("shared", 4, 1), ("cluster", 4, 2), ("global", 1, 1)):
        got = pcg_solve_batched_cuda(main, lower, pm, pl, gamma, lam0, eps, 100,
                                     skip, variant=variant)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[1][1] == 0 and (want[1][[0, 2]] > 0).all()


def test_float32_steady_state_pcg_matches_pcg_channels():
    """A float32 fig-8 steady state at N = 64, B = 64 (indy7,
    DEFAULT_SOLVER_PARAMS, 6 warm-up cycles on the plain route, the wrench
    hypotheses of chip_smoke.py's first 64 lanes): the port's float32 PCG
    on the assembled Schur system stops at the same count as the JAX
    package's pcg_channels in float32 on every lane, no lane at the cap of
    200, and lam agrees where both are finite."""
    B, N, dt = 64, 64, 0.01
    m = load_robot("indy7", torch.float32, device="cpu")
    cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                         "q_lim_cost", "vel_lim_cost",
                                         "ctrl_lim_cost")})
    settings = BSQPSettings(N=N, max_sqp_iters=P["max_sqp_iters"],
                            max_pcg_iters=P["max_pcg_iters"],
                            solve_ratio=P["solve_ratio"])
    hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                            device="cpu")
    traj = torch.tensor(figure8(dt).reshape(-1, 6), dtype=torch.float32)
    fe = np.random.default_rng(0).uniform(-5.0, 5.0, (512, 6)).astype(np.float32)[:B]
    fe[0] = 0.0
    fe = torch.tensor(fe)
    x0 = torch.tensor(np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]),
                      dtype=torch.float32)
    X, x_s = x0.expand(B, N, 12).contiguous(), x0.expand(B, 12).contiguous()
    U, lam = torch.zeros(B, N - 1, 6), torch.zeros(B, N, 12)

    def ref(i):
        return traj[i:i + N][None].expand(B, N, 6).contiguous()

    for i in range(6):
        X, U, lam, _, _ = solve_batched(m, settings, cp, hp, X, U, lam, x_s, ref(i),
                                        fe, dt)
        x_s = rk4_step(m, x_s[0], U[0, 0], dt, substeps=10).expand(B, 12).contiguous()
        X[:, 0] = x_s
    kkt = setup_kkt_batched(m, cp, X, U, x_s, ref(5), fe, dt)
    sch = build_schur(kkt, hp.rho, 6)
    mats = [getattr(sch, f) for f in ("S_main", "S_lower", "P_main", "P_lower")]
    mp = P["max_pcg_iters"]
    skip = torch.zeros(B, dtype=torch.bool)
    lam_p, it_p = pcg_solve_batched(*mats, sch.gamma, lam, hp.pcg_tol, mp, skip)

    S, L = B + 1, N + 6
    valid = np.zeros((S, L), np.float32)
    valid[:, :N] = 1.0

    def chans(t):
        return _to_chan(t.numpy().reshape(B, t.shape[1], -1), S, L)

    lam_j, it_j = jax.jit(lambda *a: pcg_channels(12, mp, *a))(
        *(chans(t) for t in mats), chans(sch.gamma), chans(lam),
        _bcast_chan(hp.pcg_tol.numpy()[:, None], S, L)[0],
        _bcast_chan(np.zeros((B, 1), np.float32), S, L)[0], jnp.asarray(valid))
    assert lam_j[0].dtype == jnp.float32
    it_j = np.asarray(it_j)[:B, 0].astype(int)
    np.testing.assert_array_equal(it_p.numpy(), it_j)
    assert (it_j < mp).all() and (it_j > 0).all()
    lam_j = np.stack([np.asarray(c) for c in lam_j], -1)[:B, :N]
    assert np.isfinite(lam_j).all() and torch.isfinite(lam_p).all()
    assert np.abs(lam_p.numpy() - lam_j).max() <= 1e-3 * np.abs(lam_j).max()
