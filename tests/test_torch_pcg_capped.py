"""ROADMAP Queue 3's N=64 B=512 cap lanes, on the Schur system that the card
assembled.

`gato_tpu_torch/testdata/n64_capped_schur.npz` holds, for six lanes where
the float32 PCG ran to its cap of 200 on an NVIDIA H100
(`python3 chip_smoke.py --save-capped PATH`, from compare_core's input at
N=64 B=512), the float32 Schur system that the card assembled
(setup_kkt_batched and build_schur in float32), lam0, the tolerance, the
card's PCG counts (the plain version, the pcg kernel, float64 PCG on the
same float32 system) and each lane's KKT inputs. On the card the float32
Cholesky of the last knots' cost block Q + rho I failed and left the
system non-finite; PCG then does not iterate and reports its cap.

The JAX package stops at the same place. Its pcg_channels reports the cap
on every saved lane, in float32 and in float64, as the port's PCG and the
card did: on a system that is not finite any PCG does, so this alone says
nothing of where the NaN comes from. That the second test shows: from the
saved lanes' own inputs the JAX package's KKT setup gives the port's cost
blocks, and its own float32 inverse of them (ch_chol_inv_n, the Pallas
iteration kernel's inverse of Q~, gato_tpu/ops/pallas_iter.py:110) is not
finite on the very knots the card left non-finite. The cause is float32 on
a cost block whose diagonal spans from rho = 1e-2 to a joint-limit
barrier's 1e10 and more, which the reference shares.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.dynamics.channelized import ch_chol_inv_n
from gato_tpu.ops import kkt_fast as jkkt
from gato_tpu.ops.pallas_pcg import pcg_channels
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.ops.kkt_fast import setup_kkt_batched
from gato_tpu_torch.ops.pcg import pcg_solve_batched
from torch_port_helpers import _bcast_chan, _to_chan, costs, models, t64

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "gato_tpu_torch",
                    "testdata", "n64_capped_schur.npz")
MATS = ("S_main", "S_lower", "P_main", "P_lower")
NQ = 6


@pytest.fixture(scope="module")
def card():
    return dict(np.load(DATA))


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_pcg_channels_caps_on_the_same_lanes(card, dtype):
    """The JAX package's pcg_channels and the port's pcg_solve_batched on
    the card's system report the card's counts, lane by lane: the cap."""
    B, N = card["S_main"].shape[:2]
    cap = int(card["max_pcg_iters"])
    sys_np = [card[n].astype(dtype) for n in MATS + ("gamma", "lam0")]
    tol = card["pcg_tol"].astype(dtype)

    _, it_port = pcg_solve_batched(*(torch.tensor(a) for a in sys_np),
                                   torch.tensor(tol), cap,
                                   torch.zeros(B, dtype=torch.bool))
    S, L = B + 1, N + 6
    valid = np.zeros((S, L), dtype)
    valid[:, :N] = 1.0

    def chans(a):
        return _to_chan(a.reshape(B, a.shape[1], -1), S, L)

    lam_j, it_j = jax.jit(lambda *a: pcg_channels(12, cap, *a))(
        *(chans(a) for a in sys_np), _bcast_chan(tol[:, None], S, L)[0],
        _bcast_chan(np.zeros((B, 1), dtype), S, L)[0], jnp.asarray(valid))
    assert lam_j[0].dtype == dtype
    it_j = np.asarray(it_j)[:B, 0].astype(int)
    np.testing.assert_array_equal(it_j, card["plain32_iters"])
    np.testing.assert_array_equal(it_port.numpy(), it_j)
    np.testing.assert_array_equal(card["kernel_iters"], it_j)


def test_reference_inverse_fails_on_the_same_blocks(card):
    """Q + rho I of the saved lanes' knots, from their inputs in float64 by
    the JAX package's KKT setup (kkt_fast.setup_kkt_batched, the reference
    of its Pallas kkt kernel), equal to the port's (setup_kkt_batched) to
    rtol 1e-11 and rounded to float32 once: the JAX package's in-kernel
    Cholesky inverse (ch_chol_inv_n) in float32 is not finite on every knot
    whose Schur blocks the card left non-finite, and finite in float64
    there, within 1e-3 of numpy's inverse; each of those blocks' diagonal
    spans more than 1e11 x rho. The file is under 1 MB and each saved lane
    is at the cap on the card in all three arms."""
    assert os.path.getsize(DATA) < 1 << 20
    for arm in ("plain32_iters", "kernel_iters", "float64_iters"):
        assert (card[arm] == card["max_pcg_iters"]).all(), arm
    jm, tm = models("indy7")
    jcp, tcp = costs(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                          "q_lim_cost", "vel_lim_cost", "ctrl_lim_cost")})
    inputs = [card[k].astype(np.float64) for k in ("X", "U", "x_s", "ref", "f_ext")]
    Q = np.asarray(jkkt.setup_kkt_batched(jm, jcp, *map(jnp.asarray, inputs), 0.01).Q)
    Q_port = setup_kkt_batched(tm, tcp, *map(t64, inputs), 0.01).Q.numpy()
    np.testing.assert_allclose(Q_port, Q, rtol=1e-11, atol=1e-11)
    Qr = Q[..., :NQ, :NQ] + card["rho"].astype(np.float64)[:, None, None, None] * np.eye(NQ)
    B, N = Qr.shape[:2]
    bad = ~np.isfinite(card["S_main"].reshape(B, N, -1)).all(-1)
    assert bad[:, -1].all() and bad.sum() < B * N // 10

    def inverse(blocks):
        ch = [[jnp.asarray(blocks[:, r, c]) for c in range(NQ)] for r in range(NQ)]
        inv = ch_chol_inv_n(ch, NQ)
        return np.stack([np.stack([np.asarray(inv[r][c]) for c in range(NQ)], -1)
                         for r in range(NQ)], -2)

    diag = np.diagonal(Qr[bad], axis1=1, axis2=2)
    assert (diag.max(1) > 1e11 * card["rho"][np.nonzero(bad)[0]]).all()
    inv32 = inverse(Qr[bad].astype(np.float32))
    assert not np.isfinite(inv32).all((1, 2)).any()
    inv64, want = inverse(Qr[bad]), np.linalg.inv(Qr[bad])
    rel = np.abs(inv64 - want).max((1, 2)) / np.abs(want).max((1, 2))
    assert (rel < 1e-3).all()
