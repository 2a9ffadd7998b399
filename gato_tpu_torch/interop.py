"""Carry a model, a cost and a solver state across from the JAX package.

The tests make every input once with numpy and hand the same arrays to
gato_tpu and to this port; these functions build the port's side. They take
numpy arrays only, so this package still never imports jax.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .ops.cost import CostParams
from .robots.model import PLANT_URDFS, RobotModel, check_device, from_parsed
from .robots.urdf import parse_urdf
from .solver.types import HyperParams

MODEL_FIELDS = ("R_tree", "p_tree", "axis", "inertia", "joint_limits",
                "velocity_limits", "effort_limits", "R_ee", "p_ee")


def model_from_numpy(name: str, arrays: dict, dtype=torch.float64,
                     device="cuda") -> RobotModel:
    """The port's RobotModel of plant `name` from the JAX RobotModel's
    arrays ({field: numpy array}, MODEL_FIELDS plus "gravity"). The parsed
    constants come from the same URDF, and they must agree with the arrays:
    the channel trace reads the constants, the tensors carry the arrays."""
    device = check_device(device)
    parsed = parse_urdf(PLANT_URDFS[name])
    for f in MODEL_FIELDS:
        a = np.asarray(arrays[f], dtype=np.float64)
        if not np.allclose(a, getattr(parsed, f), rtol=1e-6, atol=1e-6):
            raise ValueError(f"model field {f} does not match {name}'s URDF")
    model = from_parsed(parsed, name, dtype, device,
                        gravity=float(np.asarray(arrays["gravity"])))
    return replace(model, **{
        f: torch.tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
        for f in MODEL_FIELDS})


def cost_from_numpy(weights: dict) -> CostParams:
    """CostParams from {field: scalar} (numpy or Python numbers)."""
    return CostParams(**{k: float(np.asarray(v)) for k, v in weights.items()})


def state_from_numpy(X, U, lam, x_s, ref, f_ext, rho, drho, mu, pcg_tol,
                     device="cuda", dtype=torch.float64):
    """(X, U, lam, x_s, ref, f_ext, HyperParams) as tensors from numpy
    arrays in the JAX package's layouts."""
    device = check_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    hp = HyperParams(rho=t(rho), drho=t(drho), mu=t(mu), pcg_tol=t(pcg_tol))
    return t(X), t(U), t(lam), t(x_s), t(ref), t(f_ext), hp
