"""The 6D external-wrench estimator as tensors and pure step functions.

Port of gato_tpu/api/force_estimator_device.py: the random-search estimator
of api/force_estimator.py (lane 0 = smoothed estimate, lane 1 = zero, lane
2 = estimate + momentum, lanes 3.. = Fibonacci-sphere exploration at an
adaptive radius under a per-update random rotation) as a state of tensors
and functions without host reads, so that it runs inside the on-device
rollouts (api/rollout.py) and their CUDA graphs; and the Gauss-Newton
wrench observer. The rotation's three uniform draws are an argument: the
rollouts draw them all before their loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FEState:
    """Estimator state (shapes fixed; fe_init gives the dtype)."""

    estimate: torch.Tensor  # (6,)
    momentum: torch.Tensor  # (6,)
    smoothed: torch.Tensor  # (6,)
    radius: torch.Tensor  # ()
    confidence: torch.Tensor  # ()
    err_hist: torch.Tensor  # (5,) rolling, newest last
    err_count: torch.Tensor  # () int32
    rotation: torch.Tensor  # (3, 3)


def fibonacci_sphere(n: int) -> np.ndarray:
    """Static exploration directions (api/force_estimator.py's
    _fibonacci_sphere)."""
    if n == 0:
        return np.zeros((0, 3), np.float32)
    pts = np.zeros((n, 3), np.float32)
    golden = (1 + np.sqrt(5)) / 2
    for i in range(n):
        y = 1 - 2 * i / (n - 1) if n > 1 else 0.0
        r = np.sqrt(max(0.0, 1 - y * y))
        th = 2 * np.pi * i / golden
        pts[i] = [r * np.cos(th), y, r * np.sin(th)]
    return pts


def fe_init(initial_radius=10.0, dtype=torch.float32, device="cpu") -> FEState:
    """The initial state. The JAX package's is float32; the rollouts make
    theirs in their inputs' dtype (float32 on the card). The rotation stays
    float32, as rotation_from_uniforms makes it."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FEState(estimate=zeros(6), momentum=zeros(6), smoothed=zeros(6),
                   radius=torch.tensor(initial_radius, dtype=dtype, device=device),
                   confidence=zeros(), err_hist=zeros(5),
                   err_count=torch.zeros((), dtype=torch.int32, device=device),
                   rotation=torch.eye(3, dtype=torch.float32, device=device))


def rotation_from_uniforms(u):
    """Uniform random rotation from 3 U(0,1) draws u (3,) (Shoemake; the
    formula of api/force_estimator.py's _random_rotation), float32."""
    u1, u2, u3 = u[0], u[1], u[2]
    a, b = torch.sqrt(1 - u1), torch.sqrt(u1)
    x, y = a * torch.sin(2 * math.pi * u2), a * torch.cos(2 * math.pi * u2)
    z, w = b * torch.sin(2 * math.pi * u3), b * torch.cos(2 * math.pi * u3)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r) for r in rows]).to(torch.float32)


def fe_generate(state: FEState, dirs) -> torch.Tensor:
    """(B, 6) hypothesis batch; dirs: (B-3, 3) static sphere directions."""
    base = 0.7 * state.smoothed[:3] + 0.3 * state.estimate[:3]
    # float32 directions and rotation: their product takes the radius's
    # dtype before the scaling (torch would keep a 0-d float64 radius's
    # product in float32; the JAX package promotes it)
    turned = (dirs @ state.rotation.T).to(state.radius.dtype)
    expl_f = base[None, :] + state.radius * turned
    expl = torch.cat([expl_f, state.smoothed[3:][None].expand(dirs.shape[0], 3)], 1)
    head = torch.stack([state.smoothed, torch.zeros_like(state.smoothed),
                        state.smoothed + 0.5 * state.momentum])
    return torch.cat([head, expl])


def fe_update(state: FEState, dirs, best_idx, prediction_errors, u,
              alpha=0.5, beta=0.8, min_radius=1.0, max_radius=100.0,
              smoothing_factor=0.3) -> FEState:
    """One estimator update (api/force_estimator.py's update). best_idx is
    an int or a 0-d integer tensor; `u`: (3,) uniform draws for the next
    exploration rotation."""
    err_hist = torch.cat([state.err_hist[1:], prediction_errors.min()[None]])
    err_count = state.err_count + 1

    best_idx = torch.as_tensor(best_idx, device=state.estimate.device)
    best_force = fe_generate(state, dirs).index_select(0, best_idx.reshape(1))[0]
    delta = best_force - state.estimate
    momentum = beta * state.momentum + (1 - beta) * delta
    raw = alpha * best_force + (1 - alpha) * state.estimate
    estimate = 0.8 * state.estimate + 0.2 * (raw + 0.5 * momentum)
    smoothed = ((1 - smoothing_factor) * state.smoothed
                + smoothing_factor * estimate)

    exploit = best_idx < 3
    radius = torch.where(exploit, state.radius * 0.95, state.radius * 1.05)
    confidence = torch.where(exploit, torch.clamp(state.confidence + 0.05, max=1.0),
                             torch.clamp(state.confidence - 0.1, min=0.0))
    radius = torch.clamp(radius, min_radius, max_radius)

    # the error-history adaptation engages once more than 5 updates are in
    last = err_hist[-1]
    stag = torch.std(err_hist, correction=0) < 0.01
    spike = last > 1.5 * err_hist[:-1].mean()
    have5 = err_count > 5
    radius = torch.where(have5 & stag, radius * 0.9,
                         torch.where(have5 & spike, radius * 1.3, radius))
    confidence = torch.where(have5 & ~stag & spike, confidence * 0.5, confidence)
    radius = torch.clamp(radius, min_radius, max_radius)

    return FEState(estimate=estimate, momentum=momentum, smoothed=smoothed,
                   radius=radius, confidence=confidence, err_hist=err_hist,
                   err_count=err_count, rotation=rotation_from_uniforms(u))


def observer_update(pred_fn, w_est, x_meas, lam_rel=1e-3, max_step=20.0):
    """The Gauss-Newton wrench observer: one damped least-squares step on
    the measured transition,

        G = d pred(w) / d w   (nx x 6, torch.func.jacfwd through the
                               caller's integrator and frame transform),
        w <- w + (G^T G + lam I)^-1 G^T (x_meas - pred(w)),
        lam = lam_rel * diag(G^T G)   (per-dimension Marquardt damping:
              the state is far more sensitive to EE torque than to force),

    the step clipped to `max_step`. `pred_fn(w)` rolls the previous cycle's
    (state, control) forward under the world-frame wrench hypothesis w.
    The normal equations are summed elementwise (no TF32 on any device);
    the 6 x 6 solve is torch.linalg.solve without its error check, which
    would read the device."""
    r = x_meas - pred_fn(w_est)
    G = torch.func.jacfwd(pred_fn)(w_est)
    GtG = (G[:, :, None] * G[:, None, :]).sum(0)
    lam = lam_rel * torch.diagonal(GtG) + 1e-12
    A = GtG + torch.diag(lam)
    b = (G * r[:, None]).sum(0)
    step = torch.linalg.solve_ex(A, b)[0]
    nrm = torch.linalg.vector_norm(step)
    step = step * torch.clamp(max_step / torch.clamp(nrm, min=1e-9), max=1.0)
    return w_est + step
