"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Every input is made once with numpy from a seed and handed to both
packages: to gato_tpu as jnp arrays, to gato_tpu_torch through
gato_tpu_torch.interop. Both sides run in float64 on the CPU
(tests/conftest.py enables x64 for JAX).

jax_in_pieces has the JAX package's on-device rollouts and rk4_step (and
the modules a test names) call its solve_batched, fd and sim_step each
compiled once on its own: inlined, every call site of the generated
dynamics (fd: tens of thousands of operations) and the solve is traced
and compiled again in every program, minutes of each test file on the
CPU. Each piece is traced once for its input signature and the same
trace gives its output shapes and its compiled program (_piece), kept
while the test file runs. The functions are the JAX package's own; only
where they are compiled changes (the three rollouts' outputs agree with
the inlined programs' to 1e-13 of the largest value in float64).

Importing this module sets torch to one intra-op thread: pytest-xdist's
workers share the machine's cores, and torch's thread pool over the plain
versions' small batched tensors (a (64, 64, 12) reduction, a batch of
12x12 matvecs) then ran far slower than one thread. pytest
imports every test module when it collects, so the setting holds in every
worker.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gato_tpu.api.common as jcommon
import gato_tpu.api.rollout as jrollout
from gato_tpu.dynamics import algorithms as JA
from gato_tpu.ops.cost import CostParams as JCostParams
from gato_tpu.ops.integrators import sim_step as jax_sim_step
from gato_tpu.ops.kkt_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_solve import solve_channels
from gato_tpu.robots.model import load_robot as jax_load_robot
from gato_tpu.solver.bsqp import solve_batched_jit
from gato_tpu_torch.interop import (MODEL_FIELDS, cost_from_numpy,
                                    model_from_numpy)

torch.set_num_threads(1)

COST_FIELDS = ("q_cost", "qd_cost", "u_cost", "N_cost", "q_lim_cost",
               "vel_lim_cost", "ctrl_lim_cost")
DEFAULT_COST = dict(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0,
                    q_lim_cost=0.01)


def models(robot: str):
    """(JAX model, port model) in float64 from the same URDF."""
    jm = jax_load_robot(robot, dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jm, f)) for f in MODEL_FIELDS + ("gravity",)}
    return jm, model_from_numpy(robot, arrays, dtype=torch.float64,
                               device="cpu")


def costs(**weights):
    """(JAX CostParams, port CostParams) with the same weights."""
    jcp = JCostParams.create(**weights, dtype=jnp.float64)
    return jcp, cost_from_numpy({k: getattr(jcp, k) for k in COST_FIELDS})


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def jit_per_sample(fn):
    """fn jitted on one sample and called on each row of its batched
    arguments in turn, the outputs stacked: the JAX side of a batched
    comparison. Traced without vmap, a large program (the dynamics and
    their derivatives) traces and compiles in about three quarters of the
    vmapped program's time, to the same values (within 2e-13 on the
    second-order derivatives)."""
    f = jax.jit(fn)

    def batched(*args):
        outs = [f(*(a[i] for a in args)) for i in range(args[0].shape[0])]
        return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *outs)
    return batched


def cols(a):
    """(M, k) numpy -> (jnp channel list, torch channel list)."""
    return ([jnp.asarray(a[:, i]) for i in range(a.shape[1])],
            [t64(a[:, i]) for i in range(a.shape[1])])


# ---- the whole-solve channel body (gato_tpu.ops.pallas_solve) on plain
# (S, L) arrays, as tests/test_pallas_solve.py runs it: problems on rows,
# knots on lanes; row B and lanes >= N are padding

def _to_chan(a, S, L):
    a = np.asarray(a)
    out = np.zeros((a.shape[2], S, L), dtype=a.dtype)
    out[:, :a.shape[0], :a.shape[1]] = a.transpose(2, 0, 1)
    return [jnp.asarray(c) for c in out]


def _bcast_chan(a, S, L):
    a = np.asarray(a)
    out = np.zeros((a.shape[1], S, L), dtype=a.dtype)
    out[:, :a.shape[0], :] = a.T[:, :, None]
    return [jnp.asarray(c) for c in out]


def run_solve_channels(jm, jcp, X, U, lam, x_s, ref, fe, rho, drho, mu, tol,
                       max_sqp_iters, max_pcg_iters, solve_ratio=1.0, dt=0.01):
    """JAX solve_channels on numpy inputs. Returns a dict of (B, ...) numpy
    outputs in solve_batched's terms."""
    B, N, nx = X.shape
    nu = U.shape[2]
    S, L = B + 1, N + 4
    pv = np.zeros((S, L))
    pv[:B] = 1.0
    like = _to_chan(X, S, L)[0]

    def b1(v):
        return _bcast_chan(np.asarray(v)[:, None], S, L)[0]

    outs = solve_channels(
        jax_get_cd(jm.key), jm.key, jcp, N, B, max_sqp_iters, max_pcg_iters,
        8, 2, True, solve_ratio, jnp.asarray(dt, jnp.float64),
        _to_chan(X, S, L), _to_chan(U, S, L), _bcast_chan(x_s, S, L),
        _to_chan(ref[:, :, :3], S, L), _bcast_chan(fe, S, L),
        _to_chan(lam, S, L), b1(rho), b1(drho), b1(mu), b1(tol), L,
        jnp.asarray(pv), like, unroll=True)
    o = [np.asarray(c) for c in outs]

    def traj(start, n, knots):
        return np.stack(o[start:start + n], -1)[:B, :knots]

    k = 2 * nx + nu
    res = dict(X=traj(0, nx, N), U=traj(nx, nu, N - 1),
               lam=traj(nx + nu, nx, N))
    for i, name in enumerate(("rho", "drho", "conv", "merit0", "merit_final",
                              "sqp_iters")):
        res[name] = o[k + i][:B, 0]
    k += 6
    for name in ("pcg_iters", "ls_merit", "ls_step"):
        res[name] = np.stack([o[k + i][:B, 0] for i in range(max_sqp_iters)])
        k += max_sqp_iters
    return res


# ---- the JAX package's rollouts and rk4_step with their solve and
# dynamics compiled once each (jax_in_pieces) ----

def _fd_tangent(primals, tangents):
    return jax.jvp(JA.fd, primals, tangents)[1]


# {(piece, static arguments, input signature): (compiled piece, its output
# shapes)}, kept while one test file runs (jax_in_pieces empties it when
# another file's test asks): one trace and one compile each
_PIECES = {}
_PIECES_FILE = [None]


def _piece(key, fn, args):
    """fn (a function of arrays) traced, lowered and compiled once for the
    shapes and dtypes of `args`, and its output shapes from the same trace
    (jax.eval_shape and a jitted call would trace it twice)."""
    leaves, tree = jax.tree_util.tree_flatten(args)
    sig = (key, tree, tuple((jnp.shape(x), jnp.result_type(x)) for x in leaves))
    if sig not in _PIECES:
        structs = jax.tree_util.tree_unflatten(
            tree, [jax.ShapeDtypeStruct(shape, dtype) for shape, dtype in sig[2]])
        traced = jax.jit(fn).trace(*structs)
        _PIECES[sig] = (traced.lower().compile(), traced.out_info)
    return _PIECES[sig]


def _on_host(key, fn, *args):
    """fn(*args) from inside a JAX trace, compiled once for its inputs'
    shapes (_piece, `key` naming fn and its static arguments) and called on
    the host through jax.pure_callback; under vmap once for each element."""
    compiled, out_info = _piece(key, fn, args)

    def host(*a):
        return jax.tree_util.tree_map(np.asarray, compiled(*a))
    return jax.pure_callback(host, out_info, *args, vmap_method="sequential")


@jax.custom_jvp
def _fd_on_host(model, q, qd, tau, f_ext):
    return _on_host("fd", JA.fd, model, q, qd, tau, f_ext)


@_fd_on_host.defjvp
def _fd_on_host_jvp(primals, tangents):
    return _fd_on_host(*primals), _on_host("fd_jvp", _fd_tangent, primals, tangents)


def _fd(model, q, qd, tau, f_ext=None, transforms=None):
    if transforms is not None:
        return JA.fd(model, q, qd, tau, f_ext=f_ext, transforms=transforms)
    return _fd_on_host(model, q, qd, tau, f_ext)


def _sim_step(model, x, u, dt, f_ext=None, integrator_type=2):
    return _on_host(("sim_step", integrator_type),
                    lambda *a: jax_sim_step(*a, integrator_type=integrator_type),
                    model, x, u, dt, f_ext)


def _solve_batched(model, settings, cp, hp, X, U, lam, x_s, ref, f_ext, dt):
    """The solve, its reference cut to the xyz it reads (ops/kkt_fast.py,
    ops/merit_fast.py: ref[..., :3]), so that one compiled solve serves the
    rollouts' (B, N, 6) and (B, N, 3) references."""
    return _on_host(("solve_batched", settings),
                    lambda *a: solve_batched_jit(a[0], settings, *a[1:]),
                    model, cp, hp, X, U, lam, x_s, ref[..., :3], f_ext, dt)


def jax_in_pieces(monkeypatch, *modules):
    """For one test: the JAX package's rollouts (gato_tpu.api.rollout) and
    rk4_step (gato_tpu.api.common), and the functions of `modules` that
    call fd, call solve_batched, fd and sim_step compiled on their own
    (module docstring)."""
    test_file = os.environ.get("PYTEST_CURRENT_TEST", "").split("::")[0]
    if test_file != _PIECES_FILE[0]:
        _PIECES.clear()
        _PIECES_FILE[0] = test_file
    monkeypatch.setattr(jrollout, "solve_batched", _solve_batched)
    monkeypatch.setattr(jrollout, "sim_step", _sim_step)
    for module in (jrollout, jcommon) + modules:
        monkeypatch.setattr(module, "fd", _fd)
