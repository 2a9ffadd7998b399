"""The pendulum-augmented plants (api/mpc.py::add_pendulum: indy7 or iiwa14
plus a 15 kg 3R gimbal payload, nq = 9 or 10) on the rk4 kernel's plain
version, against the JAX package, float64 on the CPU, inputs made with
numpy from a seed.

- add_pendulum registers the augmented plant's constants under its key, as
  the JAX package's add_pendulum does (gato_tpu/api/mpc.py:72-83): the
  channel trace and the code generator read them there.
- rk4_step_batched on CPU tensors of a pendulum plant runs rk4_plain, the
  channel trace of gato_tpu.ops.pallas_sim.rk4_channels, the TPU kernel's
  body (run on plain arrays, as tests/test_pallas_sim.py runs it: interpret
  mode is impractical for the whole body): equal to rtol 1e-10, with and
  without an EE-frame wrench.
- The same step against gato_tpu.api.rollout._rk4, the spatial-algebra RK4
  the JAX rollouts step this plant with off the TPU, substep by substep
  (its fd compiled once, torch_port_helpers.jax_in_pieces): within rtol
  1e-10 for iiwa14's plant (2.7e-14 measured); indy7's constant snap in
  the channel trace (near-round URDF constants set to their round values
  at 1e-9) moves these steps by up to 2.4e-10, so 1e-9 there.
- The library that serves a pendulum plant on the card is named by a hash
  of the registered constants: another mass or length, or the other base
  plant, never reaches the 15 kg library; the plants rk4 does not serve
  raise naming the kernel and the ROADMAP item.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu.api.rollout as jrollout
from gato_tpu.api.mpc import add_pendulum as jax_add_pendulum
from gato_tpu.ops.merit_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_sim import rk4_channels as jax_rk4_channels
from gato_tpu.robots.model import get_parsed as jax_get_parsed
from gato_tpu_torch import _build
from gato_tpu_torch.api.mpc import add_pendulum
from gato_tpu_torch.ops.cuda_sim import (has_cuda_kernel, require_cuda_robot,
                                         rk4_step_batched)
from gato_tpu_torch.robots.model import get_parsed, load_robot
from torch_port_helpers import jax_in_pieces, jit_per_sample, models, t64

B, DT, SUBSTEPS = 4, 0.002, 2
MASS, LENGTH = 15.0, 0.3
PARSED_FIELDS = ("R_tree", "p_tree", "axis", "inertia", "joint_limits",
                 "velocity_limits", "effort_limits", "R_ee", "p_ee")
# the channel trace against the spatial-algebra RK4 (module docstring)
ALGORITHMS_RTOL = dict(indy7=1e-9, iiwa14=1e-10)


def _plants(robot):
    jm, tm = models(robot)
    return (jax_add_pendulum(jm, mass=MASS, length=LENGTH),
            add_pendulum(tm, mass=MASS, length=LENGTH))


def _inputs(nq, seed):
    """States with the payload swung up to 0.5 rad, torques on the arm and
    damping-sized ones on the gimbal, EE-frame wrenches."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-1, 1, (B, nq - 3)), rng.uniform(-0.5, 0.5, (B, 3)),
                        rng.uniform(-1, 1, (B, nq))], 1)
    u = np.concatenate([rng.uniform(-20, 20, (B, nq - 3)), rng.uniform(-1, 1, (B, 3))], 1)
    return x, u, rng.uniform(-5, 5, (B, 6))


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_add_pendulum_registers_the_constants(robot):
    """The port's registration equals the JAX package's, field by field."""
    jp, tp = _plants(robot)
    assert tp.key == jp.key and tp.nq == jp.nq == {"indy7": 9, "iiwa14": 10}[robot]
    mine, theirs = get_parsed(tp.key), jax_get_parsed(jp.key)
    assert mine.nq == theirs.nq
    for f in PARSED_FIELDS:
        np.testing.assert_allclose(getattr(mine, f), getattr(theirs, f), rtol=1e-12,
                                   atol=1e-12, err_msg=f)


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_rk4_plain_matches_jax_rk4_channels(robot):
    jp, tp = _plants(robot)
    nq = tp.nq
    x, u, fe = _inputs(nq, 11)
    for wrench in (None, fe):
        jfe = None if wrench is None else [jnp.asarray(wrench[:, i]) for i in range(6)]
        q, qd = jax_rk4_channels(jax_get_cd(jp.key),
                                 [jnp.asarray(x[:, i]) for i in range(nq)],
                                 [jnp.asarray(x[:, nq + i]) for i in range(nq)],
                                 [jnp.asarray(u[:, i]) for i in range(nq)], jfe, DT,
                                 SUBSTEPS)
        ref = np.stack([np.asarray(c) for c in q + qd], 1)
        out = rk4_step_batched(tp, t64(x), t64(u), DT,
                               None if wrench is None else t64(wrench), SUBSTEPS)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12,
                                   err_msg=f"wrench {wrench is not None}")


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_rk4_plain_matches_jax_rollout_rk4(monkeypatch, robot):
    """rk4_step_batched (SUBSTEPS substeps over DT) against SUBSTEPS calls
    of the JAX rollouts' _rk4 over DT / SUBSTEPS, with a wrench."""
    jax_in_pieces(monkeypatch)
    jp, tp = _plants(robot)
    x, u, fe = _inputs(tp.nq, 12)
    h = DT / SUBSTEPS

    def jax_step(xi, ui, fi):
        for _ in range(SUBSTEPS):
            xi = jrollout._rk4(jp, xi, ui, h, fi)
        return xi

    ref = jit_per_sample(jax_step)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(fe))
    out = rk4_step_batched(tp, t64(x), t64(u), DT, t64(fe), SUBSTEPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ALGORITHMS_RTOL[robot],
                               atol=ALGORITHMS_RTOL[robot])


def test_each_pendulum_plant_gets_a_library_of_its_own():
    """The rk4 library plant of a pendulum plant is a slug of its name and
    a hash of its constants: the same constants give the same slug, another
    mass, length or base plant another slug, header and library path. The
    plant raises on every other kernel, naming it and the ROADMAP item."""
    slugs, paths = {}, {}
    for robot in ("indy7", "iiwa14"):
        m = load_robot(robot, torch.float32, device="cpu")
        for mass, length in ((MASS, LENGTH), (MASS, LENGTH), (10.0, LENGTH), (MASS, 0.5)):
            p = add_pendulum(m, mass=mass, length=length)
            assert has_cuda_kernel(p, "rk4") and p.name == f"{robot}+pendulum"
            slug = require_cuda_robot(p, "rk4")
            assert slug.startswith(f"{robot}_pendulum_") and slug.isidentifier()
            assert slugs.setdefault((robot, mass, length), slug) == slug
            paths[robot, mass, length] = _build.library_path("rk4", slug)
            assert f"namespace gato {{ namespace {slug} {{" in _build.GENERATED[slug][0]
            for kernel in ("bsqp_iter", "iter", "merit", "kkt", "pcg"):
                assert not has_cuda_kernel(p, kernel)
                with pytest.raises(NotImplementedError,
                                   match=f"{kernel} kernel.*ROADMAP Queue 2"):
                    require_cuda_robot(p, kernel)
    assert len(set(slugs.values())) == len(slugs) == 6
    assert len(set(paths.values())) == 6
    headers = {_build.GENERATED[s][0] for s in slugs.values()}
    assert len(headers) == 6
