"""The port's plain solver modules, one by one, against their JAX
counterparts on identical numpy inputs (float64, CPU): the KKT setup
(ops/kkt_fast.py), Schur condensation and dz recovery (ops/schur.py), PCG
(ops/pcg.py), the merit sweep (ops/merit_fast.py) and the line search
(ops/linesearch.py). These compose sqp_iter_reference, the plain version
of the CUDA solve kernel. The KKT setup and the merit sweep run their
channel traces' straight-line programs (dynamics/codegen.py::kkt_program,
merit_program; on the CPU on numpy views of the channels), held here equal
to the traces bit for bit.
"""

import contextlib
from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gato_tpu.ops import kkt_fast as jkkt
from gato_tpu.ops import linesearch as jls
from gato_tpu.ops import merit_fast as jmerit
from gato_tpu.ops import pcg as jpcg
from gato_tpu.ops import schur as jschur
from gato_tpu_torch.dynamics import codegen
from gato_tpu_torch.ops import kkt_fast, linesearch, merit_fast, pcg, schur
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.robots.model import load_robot
from torch_port_helpers import DEFAULT_COST, costs, models, t64

B, N, DT = 3, 10, 0.01


def _problem(seed=21):
    rng = np.random.default_rng(seed)
    return dict(X=rng.uniform(-0.3, 0.3, (B, N, 12)),
                U=rng.uniform(-5, 5, (B, N - 1, 6)),
                x_s=rng.uniform(-0.3, 0.3, (B, 12)),
                ref=rng.uniform(-0.5, 0.5, (B, N, 6)),
                f_ext=rng.uniform(-3, 3, (B, 6)),
                lam=rng.uniform(-0.1, 0.1, (B, N, 12)),
                dzx=rng.uniform(-0.05, 0.05, (B, N, 12)),
                dzu=rng.uniform(-0.5, 0.5, (B, N - 1, 6)),
                rho=np.array([0.01, 0.003, 0.02]), mu=np.array([8.0, 10.0, 13.0]))


def _setup(p, jm, tm, jcp, tcp):
    jk = jkkt.setup_kkt_batched(jm, jcp, *(jnp.asarray(p[k]) for k in (
        "X", "U", "x_s", "ref", "f_ext")), DT)
    tk = kkt_fast.setup_kkt_batched(tm, tcp, *(t64(p[k]) for k in (
        "X", "U", "x_s", "ref", "f_ext")), DT)
    return jk, tk


def test_setup_kkt_and_schur_match_jax():
    jm, tm = models("indy7")
    jcp, tcp = costs(**DEFAULT_COST)
    p = _problem()
    jk, tk = _setup(p, jm, tm, jcp, tcp)
    for f in ("Q", "q", "R", "r", "A", "B", "c"):
        np.testing.assert_allclose(getattr(tk, f).numpy(),
                                   np.asarray(getattr(jk, f)), rtol=1e-11,
                                   atol=1e-11, err_msg=f)
    js = jax.jit(jax.vmap(lambda k, r: jschur.build_schur(k, r, 6)))(
        jk, jnp.asarray(p["rho"]))
    ts = schur.build_schur(tk, t64(p["rho"]), 6)
    for f in ("S_main", "S_lower", "gamma", "P_main", "P_lower", "Q_inv", "R_inv"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max(),
                                   err_msg=f)
    jdx, jdu, _, _ = jax.jit(jax.vmap(jschur.compute_dz))(jk, js, jnp.asarray(p["lam"]))
    tdx, tdu = schur.compute_dz(tk, ts, t64(p["lam"]))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jdx)).max())
    np.testing.assert_allclose(tdu.numpy(), np.asarray(jdu), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jdu)).max())


def test_pcg_matches_jax():
    """Same assembled system on both sides; lane 2 is skipped and lane 0's
    warm start is non-finite (reports max_iters without iterating)."""
    jm, tm = models("indy7")
    jcp, tcp = costs(**DEFAULT_COST)
    p = _problem(22)
    _, tk = _setup(p, jm, tm, jcp, tcp)
    ts = schur.build_schur(tk, t64(p["rho"]), 6)
    lam0 = p["lam"].copy()
    lam0[0, 3, 5] = np.nan
    skip = np.array([False, False, True])
    eps = np.full(B, 1e-10)
    sys_np = [getattr(ts, f).numpy() for f in ("S_main", "S_lower", "P_main",
                                               "P_lower", "gamma")]
    jl, ji = jpcg.pcg_solve_batched(*(jnp.asarray(a) for a in sys_np),
                                    jnp.asarray(lam0), jnp.asarray(eps), 300,
                                    jnp.asarray(skip))
    tl, ti = pcg.pcg_solve_batched(*(t64(a) for a in sys_np), t64(lam0),
                                   t64(eps), 300, torch.tensor(skip))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0] == 300 and ti[2] == 0
    np.testing.assert_allclose(tl.numpy()[1:], np.asarray(jl)[1:], rtol=1e-9,
                               atol=1e-9)


def test_merit_sweep_matches_jax():
    jm, tm = models("indy7")
    jcp, tcp = costs(**DEFAULT_COST)
    p = _problem(23)
    alphas = [0.0] + [0.5 ** j for j in range(8)]
    names = ("X", "U", "dzx", "dzu", "x_s", "ref", "f_ext", "mu")
    jm_ = jmerit.merit_alphas_batched(jm, jcp, *(jnp.asarray(p[k]) for k in names),
                                      DT, jnp.asarray(alphas))
    tm_ = merit_fast.merit_alphas_batched(tm, tcp, *(t64(p[k]) for k in names),
                                          DT, alphas)
    np.testing.assert_allclose(tm_.numpy(), np.asarray(jm_), rtol=1e-11)


def test_line_search_matches_jax():
    """First minimum wins ties, a non-finite merit never wins, failure
    leaves the trajectory untouched and escalates rho."""
    p = _problem(24)
    alphas = np.array([0.5 ** j for j in range(8)])
    merits = np.array([[5.0, 4.0, 3.0, 3.0, 6.0, 7.0, 8.0, 9.0],
                       [np.nan, 9.0, 9.5, 9.0, 10.0, 11.0, 12.0, 13.0],
                       [9.0, 9.0, 9.5, 9.1, 10.0, 11.0, 12.0, 13.0]])
    base = np.array([4.5, 9.5, 8.0])
    rho, drho = np.array([0.01, 5.0, 9.0]), np.array([1.0, 0.5, 2.0])
    jout = jax.vmap(lambda m, mb, X, U, dx, du, r, d: jls.line_search_update(
        m, mb, jnp.asarray(alphas), X, U, dx, du, r, d, adapt_rho=True))(
        *(jnp.asarray(a) for a in (merits, base, p["X"], p["U"], p["dzx"],
                                   p["dzu"], rho, drho)))
    tout = linesearch.line_search_update(
        t64(merits), t64(base), t64(alphas), t64(p["X"]), t64(p["U"]),
        t64(p["dzx"]), t64(p["dzu"]), t64(rho), t64(drho), adapt_rho=True)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(tout[3].numpy(), [0.25, 0.5, -1.0])
    np.testing.assert_array_equal(tout[0][2].numpy(), p["X"][2])


def test_kkt_and_merit_programs_equal_the_traces_bit_for_bit():
    """kkt_program and merit_program on numpy channels, on torch channels
    (as on the card) and through run_on_channels (as setup_kkt_batched and
    merit_alphas_batched call them) against kkt_knot_channels_structured
    and _knot_parts on torch channels, the same columns: both plants, float32 and float64, every limit cost on,
    each integrator on indy7 in float64 (the trapezoidal one elsewhere):
    every channel equal bit for bit, structural zeros and constants where
    the trace has them."""
    cp = CostParams(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0, q_lim_cost=0.01,
                    vel_lim_cost=0.3, ctrl_lim_cost=0.2)
    rng = np.random.default_rng(25)
    cases = [(r, d, 2) for r in ("indy7", "iiwa14") for d in (torch.float32, torch.float64)]
    cases += [("indy7", torch.float64, 0), ("indy7", torch.float64, 1)]
    for robot, dtype, itype in cases:
        m = load_robot(robot, dtype, "cpu")
        nq, M = m.nq, 7
        cols = [torch.tensor(rng.uniform(-a, a, (M, n)), dtype=dtype)
                for a, n in ((1.5, nq), (1.5, nq), (20.0, nq), (1.5, 2 * nq), (1.0, 3), (5.0, 6))]
        chans = [[c[:, i] for i in range(c.shape[1])] for c in cols]
        views = [[c.numpy() for c in part] for part in chans]
        cd = merit_fast._get_cd(m.key)
        pairs = ((codegen.kkt_program, kkt_fast.kkt_knot_channels_structured(
                      cd, m.key, cp, *chans, DT, itype, chans[0][0])),
                 (codegen.merit_program, merit_fast._knot_parts(
                      cd, m.key, cp, *chans, DT, itype, cp.q_cost)))
        for program, want in pairs:
            prog = program(m.key, astuple(cp), DT, itype)

            def same(w, g, where):
                if isinstance(w, (list, tuple)):
                    assert len(w) == len(g), where
                    for k, (a, b) in enumerate(zip(w, g)):
                        same(a, b, f"{where}[{k}]")
                elif isinstance(w, torch.Tensor):
                    if isinstance(g, np.ndarray):
                        g = torch.from_numpy(g)
                    assert isinstance(g, torch.Tensor) and torch.equal(w, g), where
                else:
                    assert w == g, where
            where = f"{program.__name__} {robot} {dtype} integrator {itype}"
            same(want, prog(*views), where + " on numpy channels")
            same(want, prog(*chans), where + " on torch channels")
            same(want, codegen.run_on_channels(prog, chans), where + " through run_on_channels")


def test_spd_inv_leaves_a_failed_block_to_itself():
    """A block that is not positive definite (here all zeros, whose factor
    has a zero pivot: torch.cholesky_inverse raises on it on the CPU) does
    not stop the batch: in either form of the inverse the other blocks
    equal their inverses alone bit for bit, and in the default form the
    failed block's inverse is NaN, as the JAX package's Cholesky gives it."""
    rng = np.random.default_rng(26)
    a = rng.uniform(-1, 1, (3, 12, 12))
    M = t64(a @ a.transpose(0, 2, 1) + 12 * np.eye(12))
    M[1] = 0.0
    for form in (contextlib.nullcontext, schur.capturable_inverse):
        with form():
            inv = schur.spd_inv(M)
            alone = schur.spd_inv(M[[0, 2]])
        assert torch.equal(inv[[0, 2]], alone)
        assert torch.allclose(inv[0] @ M[0], torch.eye(12, dtype=torch.float64), atol=1e-12)
    assert torch.isnan(schur.spd_inv(M)[1]).all()
