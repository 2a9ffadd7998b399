"""RobotModel: the robot as torch tensors plus its parsed-constant registry.

Port of gato_tpu/robots/model.py. The tensors carry the model for array
code; the code-generation paths (dynamics/channelized.py traced on tensors,
dynamics/codegen.py traced on symbols) need the same constants as Python
floats, and read them from the registry by `RobotModel.key`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .urdf import ParsedRobot, parse_urdf

# The URDFs ship with the JAX package; they are read as files, never imported.
ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "gato_tpu", "robots", "assets")

# iiwa14 uses the GRiD-codegen variant of its URDF, as the JAX package does.
PLANT_URDFS = {
    "indy7": os.path.join(ASSET_DIR, "indy7.urdf"),
    "iiwa14": os.path.join(ASSET_DIR, "iiwa14_grid.urdf"),
}

_PARSED_REGISTRY: dict[str, ParsedRobot] = {}


def register_parsed(key: str, parsed: ParsedRobot) -> None:
    _PARSED_REGISTRY[key] = parsed


def get_parsed(key: str) -> ParsedRobot:
    return _PARSED_REGISTRY[key]


@dataclass(frozen=True)
class RobotModel:
    """Serial-chain rigid-body model (Featherstone conventions: motion
    [w; v], force [n; f]; the joint axis is in the child frame)."""

    R_tree: torch.Tensor  # (nq, 3, 3)
    p_tree: torch.Tensor  # (nq, 3)
    axis: torch.Tensor  # (nq, 3)
    inertia: torch.Tensor  # (nq, 6, 6)
    joint_limits: torch.Tensor  # (nq, 2)
    velocity_limits: torch.Tensor  # (nq, 2)
    effort_limits: torch.Tensor  # (nq, 2)
    R_ee: torch.Tensor  # (3, 3) fixed EE offset (not applied to the EE
    p_ee: torch.Tensor  # (3,)   position, as in the JAX package)
    gravity: torch.Tensor  # () magnitude of -z world gravity
    key: str  # registry key of the parsed constants
    name: str  # plant name ("indy7", "iiwa14") or URDF path

    @property
    def nq(self) -> int:
        return self.R_tree.shape[0]

    @property
    def nv(self) -> int:
        return self.nq

    @property
    def nx(self) -> int:
        return 2 * self.nq

    @property
    def nu(self) -> int:
        return self.nq


def from_parsed(robot: ParsedRobot, name: str, dtype: torch.dtype,
                device, gravity: float = 9.81) -> RobotModel:
    key = f"{name}:{str(dtype).removeprefix('torch.')}"
    register_parsed(key, robot)

    def cast(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return RobotModel(
        R_tree=cast(robot.R_tree), p_tree=cast(robot.p_tree),
        axis=cast(robot.axis), inertia=cast(robot.inertia),
        joint_limits=cast(robot.joint_limits),
        velocity_limits=cast(robot.velocity_limits),
        effort_limits=cast(robot.effort_limits),
        R_ee=cast(robot.R_ee), p_ee=cast(robot.p_ee),
        gravity=cast(gravity), key=key, name=name)


def check_device(device) -> torch.device:
    """The device an entry point builds its tensors on. The entry points
    default to the card; without one this raises instead of quietly building
    CPU tensors (which would take the plain route)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is false: pass device=\"cpu\" to build CPU tensors (the plain "
            "PyTorch route)")
    return device


def load_robot(name_or_path: str, dtype: torch.dtype = torch.float32,
               device="cuda") -> RobotModel:
    """Load a built-in plant by name ('indy7', 'iiwa14') or any URDF path,
    on the card unless `device` says otherwise."""
    path = PLANT_URDFS.get(name_or_path, name_or_path)
    return from_parsed(parse_urdf(path), name_or_path, dtype,
                       check_device(device))
