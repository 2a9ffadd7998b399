"""The port's on-device wrench estimator (gato_tpu_torch.api.
force_estimator_device) against the JAX package's and against the port's
numpy ForceEstimator, on the CPU, inputs made with numpy from a seed:
fe_generate and fe_update over 8 updates with injected draws, winners and
errors, from the JAX package's float32 state and from a float64 one,
rotation_from_uniforms, and the Gauss-Newton observer_update on one shared
prediction. Tolerances: 1e-6 where the JAX package
holds float32 fields (its fe_init's state, and in either dtype the rotation
and directions whose float32 product enters every batch), 1e-10 in float64
(the observer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu.api.force_estimator_device as J
from gato_tpu_torch.api import force_estimator_device as T
from gato_tpu_torch.api.force_estimator import ForceEstimator
from gato_tpu_torch.interop import fe_state_from_numpy
from torch_port_helpers import t64

B, STEPS = 10, 8
# the JAX package keeps the rotation and the sphere directions in float32
# in either dtype, and their product feeds every generated batch: 1e-6
TOL = 1e-6
FIELDS = ("estimate", "momentum", "smoothed", "radius", "confidence", "err_hist",
          "err_count", "rotation")


def jax_state(dtype, radius=10.0):
    st = J.fe_init(radius)
    if dtype == "float64":
        st = J.FEState(**{f: (getattr(st, f).astype(jnp.float64)
                              if f not in ("err_count", "rotation") else getattr(st, f))
                          for f in FIELDS})
    return st


def port_state(dtype, radius=10.0):
    st = T.fe_init(radius, dtype=getattr(torch, dtype))
    js = fe_state_from_numpy({f: np.asarray(getattr(jax_state(dtype, radius), f))
                              for f in FIELDS}, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(js, f)), f
    return st


def draws(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, B)), rng.uniform(0.01, 2.0, B), rng.random(3))
            for _ in range(STEPS)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generate_and_update_match_jax(dtype):
    tol = TOL
    dirs = J.fibonacci_sphere(B - 3)
    np.testing.assert_array_equal(T.fibonacci_sphere(B - 3), dirs)
    upd = jax.jit(lambda s, b, e, u: J.fe_update(s, jnp.asarray(dirs), b, e, u,
                                                 alpha=0.6, beta=0.5, min_radius=2.0,
                                                 max_radius=20.0, smoothing_factor=0.5))
    gen = jax.jit(lambda s: J.fe_generate(s, jnp.asarray(dirs)))
    js, ts, tdirs = jax_state(dtype), port_state(dtype), torch.tensor(dirs)
    for best, errs, u in draws(42):
        np.testing.assert_allclose(T.fe_generate(ts, tdirs).numpy(), np.asarray(gen(js)),
                                   rtol=tol, atol=tol)
        js = upd(js, jnp.int32(best), jnp.asarray(errs.astype(dtype)), jnp.asarray(u))
        ts = T.fe_update(ts, tdirs, best, torch.tensor(errs.astype(dtype)), torch.tensor(u),
                         alpha=0.6, beta=0.5, min_radius=2.0, max_radius=20.0,
                         smoothing_factor=0.5)
        for f in FIELDS:
            got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f)


def test_rotation_from_uniforms_matches_jax():
    u = np.random.default_rng(3).random((16, 3))
    want = np.stack([np.asarray(J.rotation_from_uniforms(jnp.asarray(v))) for v in u])
    got = np.stack([T.rotation_from_uniforms(torch.tensor(v)).numpy() for v in u])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.tile(np.eye(3), (16, 1, 1)),
                               atol=1e-6)


def test_update_matches_numpy_force_estimator():
    """The numpy class (the reference's algorithm) and the tensor update,
    driven by the same winners, errors and rotations: every field and batch
    agrees (as tests/test_force_estimator_device.py holds the JAX pair)."""
    ref = ForceEstimator(B, seed=0)
    dirs = torch.tensor(T.fibonacci_sphere(B - 3))
    st = T.fe_init(10.0)
    for best, errs, u in draws(7):
        np.testing.assert_allclose(T.fe_generate(st, dirs).numpy(), ref.generate_batch(),
                                   rtol=1e-5, atol=1e-5)
        errs = errs.astype(np.float32)
        ref.update(best, errs)
        ref.current_rotation = T.rotation_from_uniforms(torch.tensor(u, dtype=torch.float32)).numpy()
        st = T.fe_update(st, dirs, best, torch.tensor(errs), torch.tensor(u, dtype=torch.float32))
        for got, want in ((st.estimate, ref.estimate), (st.momentum, ref.momentum),
                          (st.smoothed, ref.smoothed_estimate)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(st.radius), ref.radius, rtol=1e-5)
        np.testing.assert_allclose(float(st.confidence), ref.confidence, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 50.0])
def test_observer_update_matches_jax(scale):
    """One Gauss-Newton step through one shared prediction, a smooth map
    of the wrench to a 12-state (c + M w + M2 sin(3 w), numpy from a seed,
    the same formula in both packages); at scale 50 the step meets the
    clip at max_step. The rollouts' observer (RK4 on the rigid-body
    algorithms) is held in tests/test_torch_rollout_estimator.py."""
    rng = np.random.default_rng(11)
    c, M, M2 = rng.normal(size=12), rng.normal(size=(12, 6)), 0.1 * rng.normal(size=(12, 6))
    w0, w_true = rng.uniform(-1, 1, 6), scale * rng.uniform(-1, 1, 6)

    def jpred(w):
        return jnp.asarray(c) + jnp.asarray(M) @ w + jnp.asarray(M2) @ jnp.sin(3 * w)

    def tpred(w):
        return t64(c) + t64(M) @ w + t64(M2) @ torch.sin(3 * w)

    x_meas = tpred(t64(w_true))
    np.testing.assert_allclose(x_meas.numpy(), np.asarray(jpred(jnp.asarray(w_true))),
                               rtol=1e-12)
    want = np.asarray(J.observer_update(jpred, jnp.asarray(w0), jnp.asarray(x_meas.numpy())))
    got = T.observer_update(tpred, t64(w0), x_meas).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    step = np.linalg.norm(got - w0)
    assert (step < 20.0 - 1e-9) if scale == 1.0 else np.isclose(step, 20.0)
