"""Task utilities: the figure-8 reference and the RK4 plant step.

Port of the parts of gato_tpu/api/common.py that the closed-loop fig-8
cycle runs (python/bsqp/common.py in the reference).
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.cuda_sim import rk4_step_batched
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


def rk4_step(model: RobotModel, x, u, dt: float, f_ext_world=None,
             substeps: int = 1):
    """RK4 plant step of one state x (nx,) under u (nu,) (common.py:49-91):
    the RK4 kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if f_ext_world is not None:
        raise NotImplementedError(
            "world-frame wrench in rk4_step: not ported yet (ROADMAP Queue 1, "
            "api/common.py world_wrench_to_ee_frame)")
    return rk4_step_batched(model, x[None].contiguous(), u[None].contiguous(),
                            dt, substeps=substeps)[0]
