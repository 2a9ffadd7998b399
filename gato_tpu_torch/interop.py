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


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def hyper_from_numpy(rho, drho, mu, pcg_tol, device="cuda",
                     dtype=torch.float64) -> HyperParams:
    """HyperParams from four (B,) numpy arrays."""
    device = check_device(device)
    return HyperParams(*(_tensor(a, dtype, device) for a in (rho, drho, mu, pcg_tol)))


def state_from_numpy(X, U, lam, x_s, ref, f_ext, rho, drho, mu, pcg_tol,
                     device="cuda", dtype=torch.float64):
    """(X, U, lam, x_s, ref, f_ext, HyperParams) as tensors from numpy
    arrays in the JAX package's layouts."""
    device = check_device(device)
    return (*(_tensor(a, dtype, device) for a in (X, U, lam, x_s, ref, f_ext)),
            hyper_from_numpy(rho, drho, mu, pcg_tol, device, dtype))


def bsqp_state_from_numpy(solver, XU_B, lam, hp, hp_init, f_ext_B):
    """Carry a JAX BSQP facade's state into the port's `solver`
    (api.interface.BSQP) from numpy arrays: the flat warm start XU_B
    (B, N*(nx+nu)-nu), the duals lam (B, N, nx), the hyperparameters hp and
    their reset values hp_init, each (rho, drho, mu, pcg_tol) of (B,)
    arrays, and the EE-frame wrench hypotheses f_ext_B (B, 6)."""
    dtype, device = solver.lam.dtype, solver.lam.device
    solver.XU_B = np.array(XU_B, dtype=solver.XU_B.dtype)
    solver.lam = _tensor(lam, dtype, device)
    solver.f_ext_B = _tensor(f_ext_B, dtype, device)
    solver.hp = hyper_from_numpy(*hp, device=device, dtype=dtype)
    solver._hp_init = hyper_from_numpy(*hp_init, device=device, dtype=dtype)


def fe_state_from_numpy(arrays: dict, device="cuda"):
    """The wrench estimator's state (api.force_estimator_device.FEState)
    from {field: numpy array}, a JAX FEState's fields, each in its own
    dtype."""
    from .api.force_estimator_device import FEState

    device = check_device(device)
    return FEState(**{f: torch.tensor(np.asarray(arrays[f]), device=device)
                      for f in FEState.__dataclass_fields__})
