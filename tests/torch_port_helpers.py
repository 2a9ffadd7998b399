"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Every input is made once with numpy from a seed and handed to both
packages: to gato_tpu as jnp arrays, to gato_tpu_torch through
gato_tpu_torch.interop. Both sides run in float64 on the CPU
(tests/conftest.py enables x64 for JAX).
"""

import jax.numpy as jnp
import numpy as np
import torch

from gato_tpu.ops.cost import CostParams as JCostParams
from gato_tpu.ops.kkt_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_solve import solve_channels
from gato_tpu.robots.model import load_robot as jax_load_robot
from gato_tpu_torch.interop import (MODEL_FIELDS, cost_from_numpy,
                                    model_from_numpy)

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
