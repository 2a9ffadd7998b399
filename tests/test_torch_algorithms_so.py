"""The port's second-order rigid-body derivatives against the JAX package's,
float64, indy7 and iiwa14, a batch of 5 inputs made with numpy from a seed:
id_so_derivatives and fd_so_derivatives (forward over forward through the
RNEA and the forward dynamics: torch.func.jacfwd against jax.jacfwd) and
ee_pose_grad_hess. Tolerance: rtol 1e-8, atol 1e-8 (the same derivative
of the same operations; the forward dynamics' second derivatives pass
through two Cholesky solves). The first-order functions are in
tests/test_torch_algorithms.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu.dynamics import algorithms as JA
from gato_tpu_torch.dynamics import algorithms as TA
from torch_port_helpers import jit_per_sample, models, t64

B = 5


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_second_order_derivatives_match_jax(robot):
    jm, tm = models(robot)
    rng = np.random.default_rng(23)
    q, qd, qdd, tau = (rng.uniform(-1.5, 1.5, (B, jm.nq)) for _ in range(4))

    def one(q, qd, qdd, tau):
        return dict(id_so=JA.id_so_derivatives(jm, q, qd, qdd),
                    fd_so=JA.fd_so_derivatives(jm, q, qd, tau),
                    ee_pose_grad_hess=JA.ee_pose_grad_hess(jm, q))

    ref = jit_per_sample(one)(*map(jnp.asarray, (q, qd, qdd, tau)))
    out = dict(id_so=TA.id_so_derivatives(tm, t64(q), t64(qd), t64(qdd)),
               fd_so=TA.fd_so_derivatives(tm, t64(q), t64(qd), t64(tau)),
               ee_pose_grad_hess=TA.ee_pose_grad_hess(tm, t64(q)))
    for name in out:
        got, want = jax.tree_util.tree_leaves(out[name]), jax.tree_util.tree_leaves(ref[name])
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-8,
                                       err_msg=name)
