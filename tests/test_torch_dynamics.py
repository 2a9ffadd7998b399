"""The port's channelized dynamics (gato_tpu_torch.dynamics.channelized on
torch tensors) against the JAX package, both robots, float64.

Against the JAX channel trace on jnp arrays the port runs the same ops in
the same order, so they agree to rtol 1e-12. Against the spatial-algebra
gato_tpu.dynamics.algorithms.fd they differ by the trace's 1e-9 constant
snap (channelized.py:22): atol 1e-7 on indy7, whose URDF has such
near-round constants; iiwa14's has none.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu.dynamics.algorithms import fd as jax_fd
from gato_tpu.ops.merit_fast import _get_cd as jax_get_cd
from gato_tpu_torch.dynamics import mathshim as ms
from gato_tpu_torch.ops.merit_fast import _get_cd
from torch_port_helpers import cols, jit_per_sample, models

B = 5


def _inputs(nq, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, (B, nq)), rng.uniform(-1, 1, (B, nq)),
            rng.uniform(-5, 5, (B, nq)), rng.uniform(-5, 5, (B, 6)),
            rng.uniform(-3, 3, (B, nq)))


def _np(c):
    """A channel (None, constant, jnp array or tensor) as a (B,) array."""
    if c is None:
        return np.zeros(B)
    if isinstance(c, (int, float)):
        return np.full(B, float(c))
    return np.broadcast_to(np.asarray(c), (B,))


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [_np(x)]


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_channel_trace_matches_jax_trace(robot):
    """fd, rnea (with a wrench), crba and fk_ee, entry by entry."""
    jm, tm = models(robot)
    jcd, tcd = jax_get_cd(jm.key), _get_cd(tm.key)
    q, qd, u, fe, qdd = _inputs(jm.nq)
    (jq, tq), (jqd, tqd), (ju, tu), (jfe, tfe), (jqdd, tqdd) = (
        cols(q), cols(qd), cols(u), cols(fe), cols(qdd))
    jcs, jss = [jnp.cos(x) for x in jq], [jnp.sin(x) for x in jq]
    tcs, tss = [ms.cos(x) for x in tq], [ms.sin(x) for x in tq]
    pairs = [
        (jcd.fd(jcs, jss, jqd, ju, f_ext=jfe), tcd.fd(tcs, tss, tqd, tu, f_ext=tfe)),
        (jcd.fd(jcs, jss, jqd, ju), tcd.fd(tcs, tss, tqd, tu)),
        (jcd.rnea(jcs, jss, jqd, jqdd, f_ext=jfe),
         tcd.rnea(tcs, tss, tqd, tqdd, f_ext=tfe)),
        (jcd.crba(jcs, jss), tcd.crba(tcs, tss)),
        (jcd.fk_ee(jcs, jss), tcd.fk_ee(tcs, tss)),
    ]
    for j, t in pairs:
        jf, tf = _flat(j), _flat(t)
        assert len(jf) == len(tf)
        np.testing.assert_allclose(np.stack(tf), np.stack(jf), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("robot,atol", [("indy7", 1e-7), ("iiwa14", 1e-10)])
def test_fd_matches_spatial_algebra_fd(robot, atol):
    jm, tm = models(robot)
    tcd = _get_cd(tm.key)
    q, qd, u, fe, _ = _inputs(jm.nq, seed=12)
    ref = jit_per_sample(lambda a, b, c, f: jax_fd(jm, a, b, c, f_ext=f))(
        jnp.asarray(q), jnp.asarray(qd), jnp.asarray(u), jnp.asarray(fe))
    _, tq = cols(q)
    out = tcd.fd([ms.cos(x) for x in tq], [ms.sin(x) for x in tq],
                 cols(qd)[1], cols(u)[1], f_ext=cols(fe)[1])
    np.testing.assert_allclose(np.stack([_np(c) for c in out], 1),
                               np.asarray(ref), rtol=0, atol=atol)


def test_model_from_numpy_refuses_arrays_of_another_robot():
    """interop builds the port's model from the JAX model's arrays and the
    same URDF's parsed constants, and refuses arrays that disagree."""
    import torch

    from gato_tpu_torch.interop import MODEL_FIELDS, model_from_numpy

    jm, tm = models("indy7")
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    arrays = {f: np.asarray(getattr(jm, f)) for f in MODEL_FIELDS + ("gravity",)}
    arrays["inertia"] = arrays["inertia"] * 1.01
    with pytest.raises(ValueError, match="inertia"):
        model_from_numpy("indy7", arrays, dtype=torch.float64, device="cpu")


def test_port_never_imports_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax and
    the JAX package out of sys.modules."""
    code = ("import pkgutil, importlib, sys, gato_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(gato_tpu_torch.__path__, "
            "'gato_tpu_torch.')]\n"
            "for name in names + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "for name in ('dynamics.spatial', 'dynamics.algorithms', 'native', "
            "'ops.integrators', 'ops.merit', 'ops.btd_solve', 'api.interface', "
            "'api.mpc', 'api.force_estimator', 'api.force_estimator_device', "
            "'api.rollout', 'api.experiment_runner', 'examples.pickplace_device'):\n"
            "    assert 'gato_tpu_torch.' + name in names, name\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'gato_tpu' or m.startswith('gato_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
