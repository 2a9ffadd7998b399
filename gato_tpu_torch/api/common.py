"""Task utilities: the figure-8 reference, the RK4 plant step, world-frame
wrenches, warm starts and the pendulum samplers.

Port of gato_tpu/api/common.py (python/bsqp/common.py in the reference).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..dynamics.algorithms import fd, fk, joint_transforms
from ..ops.cuda_sim import has_cuda_kernel, rk4_step_batched
from ..robots.model import RobotModel


def figure8(dt, A_x=0.4, A_z=0.4, offset=(0.0, 0.5, 0.6), period=6, cycles=5,
            theta=math.pi / 4):
    """Rotated-lemniscate EE reference (common.py:10-46). Returns a flat
    array of [x, y, z, 0, 0, 0] per timestep, tiled over `cycles`."""
    ts = np.linspace(0, 2 * np.pi, int(period / dt))
    x = offset[0] + A_x * np.sin(ts)
    y = np.full_like(ts, offset[1])
    z = offset[2] + A_z * np.sin(2 * ts) / 2 + A_z / 2
    R = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    pts = (R @ np.stack([x, y, z])).T
    out = np.zeros((len(ts), 6))
    out[:, :3] = pts
    return np.tile(out.reshape(-1), cycles)


def _ee_frame(R_ee, w_world):
    """[force; torque] in the world -> the EE-frame spatial force [n; f]."""
    return torch.cat([(R_ee.mT @ w_world[..., 3:, None])[..., 0],
                      (R_ee.mT @ w_world[..., :3, None])[..., 0]], -1)


def world_wrench_to_ee_frame(model: RobotModel, q, w_world):
    """A world-frame wrench [force(3); torque(3)] acting at the EE link
    origin, expressed in the EE link frame as the solver's [n; f] spatial
    force: q (..., nq), w_world (..., 6) -> (..., 6)."""
    return _ee_frame(fk(model, q)[0][..., -1, :, :], w_world)


def _rk4_algorithms(model: RobotModel, x, u, dt: float, f_ext_world,
                    substeps: int, f_ext=None):
    """RK4 on the rigid-body algorithms (fk + fd), the counterpart of the
    JAX package's XLA rk4_step: the world wrench is re-expressed in the EE
    frame at each of the four stage evaluations. `f_ext` (..., 6) is an
    EE-frame wrench held constant over the step instead (the JAX package's
    api/rollout.py::_rk4)."""
    nq = model.nq

    def deriv(x):
        q, qd = x[..., :nq], x[..., nq:]
        E, r, R_link = joint_transforms(model, q)
        fe = f_ext
        if f_ext_world is not None:
            fe = _ee_frame(fk(model, q, R_link=R_link)[0][..., -1, :, :], f_ext_world)
        return torch.cat([qd, fd(model, q, qd, u, f_ext=fe, transforms=(E, r))], -1)

    h = dt / substeps
    for _ in range(substeps):
        k1 = deriv(x)
        k2 = deriv(x + 0.5 * h * k1)
        k3 = deriv(x + 0.5 * h * k2)
        k4 = deriv(x + h * k3)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def rk4_step(model: RobotModel, x, u, dt: float, f_ext_world=None,
             substeps: int = 1):
    """RK4 plant step of one state x (nx,) under u (nu,) over dt in
    `substeps` sub-intervals (common.py:49-91), optionally under a constant
    world-frame wrench f_ext_world (6,) = [force; torque] at the EE link.

    Where the JAX package's kernel serves (no world wrench, and a plant the
    rk4 kernel serves: indy7, iiwa14 and the pendulum-augmented plants
    add_pendulum makes of them, ops/cuda_sim.py::has_cuda_kernel) this is
    the RK4 kernel csrc/rk4.cu on a CUDA tensor and its plain version on a
    CPU tensor; a failed build or launch raises. A world wrench, or a
    plant no kernel serves (one loaded from another URDF), takes the
    rigid-body algorithms on either device, as the JAX package takes its
    XLA rk4_step outside any Pallas kernel."""
    if f_ext_world is None and has_cuda_kernel(model, "rk4"):
        return rk4_step_batched(model, x[None].contiguous(), u[None].contiguous(),
                                dt, substeps=substeps)[0]
    return _rk4_algorithms(model, x, u, dt, f_ext_world, substeps)


def initialize_warm_start(x_start, N, nx, nu):
    """Tile the start state over the horizon in the flat XU layout
    (common.py:93-99)."""
    XU = np.zeros(N * (nx + nu) - nu, dtype=np.float32)
    for i in range(N):
        s = i * (nx + nu)
        XU[s:s + nx] = x_start
    return XU


def sample_axis_angle(mag_range=(0.0, 0.6), rng=None):
    rng = rng or np.random.default_rng()
    mag = rng.uniform(*mag_range)
    v = rng.normal(size=3)
    return v / (np.linalg.norm(v) + 1e-12) * mag


def sample_pendulum_params(length_range=(0.3, 0.7), damping_range=(0.1, 0.6),
                           angle_range=(0.0, 0.6), mass=15.0, rng=None):
    rng = rng or np.random.default_rng()
    return {
        "mass": mass,
        "length": rng.uniform(*length_range),
        "damping": rng.uniform(*damping_range),
        "initial_angle": sample_axis_angle(angle_range, rng),
    }
