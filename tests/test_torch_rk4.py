"""The port's RK4 plant step against the JAX package (float64, CPU). The
CUDA kernel csrc/rk4.cu is held to its plain version in
tests/test_torch_cuda.py, on the card.

On a CPU tensor `rk4_step_batched` runs its plain version, `rk4_channels`:
the same channel trace as gato_tpu's Pallas kernel body, so the two agree
to rtol 1e-10. Against the spatial-algebra rk4_step the trace differs only
by its 1e-9 constant snap, which moves nothing on iiwa14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.api.common import rk4_step as jax_rk4_step
from gato_tpu.ops.merit_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_sim import rk4_channels as jax_rk4_channels
from gato_tpu_torch.api.common import rk4_step
from gato_tpu_torch.ops.cuda_sim import require_cuda_robot, rk4_step_batched
from gato_tpu_torch.robots.model import load_robot
from torch_port_helpers import models, t64

B, DT, SUBSTEPS = 5, 0.01, 2


def _inputs(nq, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 2 * nq)), rng.uniform(-20, 20, (B, nq)),
            rng.uniform(-5, 5, (B, 6)))


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
@pytest.mark.parametrize("with_fe", [False, True])
def test_rk4_matches_jax_rk4_channels(robot, with_fe):
    jm, tm = models(robot)
    nq = jm.nq
    x, u, fe = _inputs(nq)
    jfe = [jnp.asarray(fe[:, i]) for i in range(6)] if with_fe else None
    q, qd = jax_rk4_channels(jax_get_cd(jm.key),
                             [jnp.asarray(x[:, i]) for i in range(nq)],
                             [jnp.asarray(x[:, nq + i]) for i in range(nq)],
                             [jnp.asarray(u[:, i]) for i in range(nq)], jfe,
                             DT, SUBSTEPS)
    ref = np.stack([np.asarray(c) for c in q + qd], 1)
    out = rk4_step_batched(tm, t64(x), t64(u), DT,
                           t64(fe) if with_fe else None, SUBSTEPS)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_rk4_step_matches_jax_rk4_step():
    """api.common.rk4_step (one state) against gato_tpu.api.common.rk4_step,
    the spatial-algebra RK4, for each of the B states. iiwa14: indy7's
    constant snap alone moves a step by ~3e-9 relative."""
    jm, tm = models("iiwa14")
    x, u, _ = _inputs(jm.nq, seed=4)
    ref = jax.jit(jax.vmap(lambda a, b: jax_rk4_step(jm, a, b, DT,
                                                     substeps=SUBSTEPS)))(
        jnp.asarray(x), jnp.asarray(u))
    out = np.stack([rk4_step(tm, t64(x[i]), t64(u[i]), DT,
                             substeps=SUBSTEPS).numpy() for i in range(B)])
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_rk4_wrapper_takes_the_plain_path_only_on_cpu():
    """A tensor that is not on the CPU never falls back to the plain
    version: it is checked for the kernel and refused (here a 'meta'
    tensor); a plant without generated CUDA dynamics is refused."""
    m = load_robot("indy7", torch.float32, device="cpu")
    x = torch.empty(2, 12, device="meta")
    u = torch.empty(2, 6, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rk4_step_batched(m, x, u, DT)
    with pytest.raises(NotImplementedError, match="iiwa14"):
        require_cuda_robot(load_robot("iiwa14", torch.float32, device="cpu"))
    with pytest.raises(NotImplementedError, match="world-frame"):
        rk4_step(m, torch.zeros(12), torch.zeros(6), DT,
                 f_ext_world=torch.zeros(6))
