"""The port's array solver path against the JAX package's, float64, indy7,
inputs made with numpy from a seed: the integrators (sim_step, defect,
linearize for each integrator type), the knot cost and its gradient and
Hessian, the array KKT setup, the merit sweep and its alphas,
sim_forward_batched and the direct block-tridiagonal solve.

Tolerances: the same operations up to the order inside small matrix
products and the factorisations: rtol 1e-9, atol 1e-9; the merit (a sum of
O(10-1e3) terms) rtol 1e-10; the block-tridiagonal solve (Gauss-Jordan
inverses in JAX, LU in torch, chained over 8 knots) rtol 1e-8, atol 1e-10,
its iteration counts exactly. The JAX integrators and merit call their
forward dynamics compiled once (torch_port_helpers.jax_in_pieces).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.ops import btd_solve as jbtd
from gato_tpu.ops import cost as jcost
from gato_tpu.ops import integrators as jint
from gato_tpu.ops import kkt as jkkt
from gato_tpu.ops import merit as jmerit
from gato_tpu.solver.bsqp import sim_forward_batched as jax_sim_forward_batched
from gato_tpu_torch.ops import btd_solve, cost, integrators, kkt, merit
from gato_tpu_torch.solver.bsqp import sim_forward_batched
from torch_port_helpers import (DEFAULT_COST, costs, jax_in_pieces, jit_per_sample, models,
                                t64)

B, N, DT = 4, 8, 0.01
RTOL = ATOL = 1e-9
# a barrier on every joint, velocity and torque limit, so their terms count
COST = dict(DEFAULT_COST, vel_lim_cost=1e-3, ctrl_lim_cost=1e-3)


@pytest.fixture(scope="module")
def setup():
    jm, tm = models("indy7")
    jcp, tcp = costs(**COST)
    rng = np.random.default_rng(31)
    a = dict(X=rng.uniform(-0.3, 0.3, (B, N, 12)), U=rng.uniform(-5, 5, (B, N - 1, 6)),
             x_s=rng.uniform(-0.3, 0.3, (B, 12)), ref=rng.uniform(-0.5, 0.5, (B, N, 6)),
             f_ext=rng.uniform(-3, 3, (B, 6)), dZX=rng.uniform(-0.1, 0.1, (B, N, 12)),
             dZU=rng.uniform(-1, 1, (B, N - 1, 6)), mu=rng.uniform(1, 10, B))
    return jm, tm, jcp, tcp, a


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=msg)


@pytest.fixture(scope="module")
def jax_integrators(setup):
    """The JAX side of every integrator type in one compiled program (the
    three share their forward dynamics and its derivatives)."""
    jm, _, _, _, a = setup

    def one(x, u, xn, fe):
        return [(jint.sim_step(jm, x, u, DT, fe, itype),
                 jint.defect(jm, x, u, xn, DT, fe, itype),
                 jint.linearize(jm, x, u, DT, fe, itype)) for itype in (0, 1, 2)]

    with pytest.MonkeyPatch.context() as mp:
        jax_in_pieces(mp, jint)
        return jax.block_until_ready(jit_per_sample(one)(*map(jnp.asarray, (
            a["X"][:, 0], a["U"][:, 0], a["X"][:, 1], a["f_ext"]))))


@pytest.mark.parametrize("itype", [0, 1, 2])
def test_integrators_match_jax(setup, jax_integrators, itype):
    jm, tm, _, _, a = setup
    x, u, xn, fe = (a["X"][:, 0], a["U"][:, 0], a["X"][:, 1], a["f_ext"])
    ref = jax_integrators[itype]
    x, u, xn, fe = map(t64, (x, u, xn, fe))
    out = (integrators.sim_step(tm, x, u, DT, fe, itype),
           integrators.defect(tm, x, u, xn, DT, fe, itype),
           integrators.linearize(tm, x, u, DT, fe, itype))
    _close(out, ref, msg=f"integrator {itype}")


def test_knot_cost_and_kkt_setup_match_jax(setup, monkeypatch):
    """knot_cost, knot_cost_grad_hess (both kinds of knot) and the array
    setup_kkt, batched over problems (and knots)."""
    jax_in_pieces(monkeypatch, jint)
    jm, tm, jcp, tcp, a = setup
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def one(X, U, x_s, ref, fe):
        return (jcost.knot_cost(jm, jcp, X[0], U[0], ref[0], terminal=False),
                jcost.knot_cost(jm, jcp, X[-1], None, ref[-1], terminal=True),
                jcost.knot_cost_grad_hess(jm, jcp, X[0], U[0], ref[0], terminal=False),
                jcost.knot_cost_grad_hess(jm, jcp, X[-1], None, ref[-1], terminal=True)[:2],
                jkkt.setup_kkt(jm, jcp, X, U, x_s, ref, fe, DT))

    ref = jit_per_sample(one)(ja["X"], ja["U"], ja["x_s"], ja["ref"], ja["f_ext"])
    X, U, x_s, r6, fe = (t64(a[k]) for k in ("X", "U", "x_s", "ref", "f_ext"))
    k = kkt.setup_kkt(tm, tcp, X, U, x_s, r6, fe, DT)
    out = (cost.knot_cost(tm, tcp, X[:, 0], U[:, 0], r6[:, 0], terminal=False),
           cost.knot_cost(tm, tcp, X[:, -1], None, r6[:, -1], terminal=True),
           cost.knot_cost_grad_hess(tm, tcp, X[:, 0], U[:, 0], r6[:, 0], terminal=False),
           cost.knot_cost_grad_hess(tm, tcp, X[:, -1], None, r6[:, -1], terminal=True)[:2],
           (k.Q, k.q, k.R, k.r, k.A, k.B, k.c))
    jk = ref[4]
    _close(out[:4], ref[:4], msg="knot cost")
    _close(out[4], (jk.Q, jk.q, jk.R, jk.r, jk.A, jk.B, jk.c), msg="setup_kkt")


def test_merit_and_sim_forward_match_jax(setup, monkeypatch):
    """merit_alphas over default_alphas (alpha = 2^-j) with the problems'
    own mu, and one sim_forward_batched call over B wrench hypotheses."""
    jax_in_pieces(monkeypatch, jint, jmerit)
    jm, tm, jcp, tcp, a = setup
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jal = jmerit.default_alphas(8, dtype=jnp.float64)
    tal = merit.default_alphas(8, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tal.numpy(), np.asarray(jal))
    ref = jit_per_sample(lambda X, U, dX, dU, xs, r, fe, mu: jmerit.merit_alphas(
        jm, jcp, X, U, dX, dU, xs, r, fe, mu, DT, jal))(
        ja["X"], ja["U"], ja["dZX"], ja["dZU"], ja["x_s"], ja["ref"], ja["f_ext"], ja["mu"])
    out = merit.merit_alphas(tm, tcp, *(t64(a[k]) for k in (
        "X", "U", "dZX", "dZU", "x_s", "ref", "f_ext", "mu")), DT, tal)
    assert out.shape == (B, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10)

    x, u = a["X"][0, 0], a["U"][0, 0]
    ref = jax_sim_forward_batched(jm, jnp.asarray(x), jnp.asarray(u), ja["f_ext"],
                                  jnp.float64(DT))
    out = sim_forward_batched(tm, t64(x), t64(u), t64(a["f_ext"]), DT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_btd_solve_batched_matches_jax():
    """The direct solve on SPD block-tridiagonal systems, with PCG's
    bookkeeping: a skipped problem, one whose warm start already solves it
    (0 iterations), one whose warm start is not finite (solved anyway)."""
    Bn, n = 5, 12
    rng = np.random.default_rng(32)
    G = rng.normal(size=(Bn, N, n, n))
    main = G @ G.swapaxes(-1, -2) + 4 * n * np.eye(n)
    lower = rng.normal(size=(Bn, N - 1, n, n))
    gamma = rng.normal(size=(Bn, N, n))
    lam_prev = rng.normal(size=(Bn, N, n))
    exact = np.asarray(jbtd.btd_solve(jnp.asarray(main[2]), jnp.asarray(lower[2]),
                                      jnp.asarray(gamma[2])))
    lam_prev[2] = exact
    lam_prev[3, 0, 0] = np.nan
    skip = np.array([False, True, False, False, False])
    lam_j, it_j = jbtd.btd_solve_batched(*map(jnp.asarray, (main, lower, gamma, lam_prev, skip)))
    lam_t, it_t = btd_solve.btd_solve_batched(*map(t64, (main, lower, gamma, lam_prev)),
                                              torch.tensor(skip))
    np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))
    np.testing.assert_array_equal(it_t.numpy(), [1, 0, 0, 1, 1])
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-8, atol=1e-10)
