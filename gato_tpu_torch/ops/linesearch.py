"""Parallel multi-alpha line search with adaptive rho regularization.

Port of gato_tpu/ops/linesearch.py (gato/bsqp/kernels/line_search.cuh:12-98),
batched over B problems. Per problem:
  - alpha* = argmin_alpha merit(alpha), the first minimum on ties (the
    reference's strict-less reduction),
  - success iff min merit < the previous baseline merit,
  - rho schedule (settings.h:18-21):
      success: drho = min(drho/1.2, 1/1.2); rho = clip(rho*drho, 1e-8, 10)
      failure: drho = max(drho*1.2, 1.2);   rho = clip(rho*drho, 1e-8, 10)
    and on failure a rho above RHO_MAX resets to RHO_INIT,
  - on success the trajectory moves and the baseline becomes the new merit;
    on failure step = -1 and the trajectory is untouched (a select, so a
    non-finite step cannot leak in through 0 * NaN).
"""

from __future__ import annotations

import torch

from .schur import RHO_FACTOR, RHO_INIT, RHO_MAX, RHO_MIN


def line_search_update(merits, merit_baseline, alphas, X, U, dZX, dZU,
                       rho, drho, adapt_rho: bool):
    """merits (B, A), merit_baseline/rho/drho (B,), alphas (A,) tensor,
    X/U/dZX/dZU (B, ...). Returns (X, U, merit, step, rho, drho)."""
    merits = torch.where(torch.isfinite(merits), merits, torch.inf)
    j = torch.argmin(merits, dim=1)
    min_merit = merits.gather(1, j[:, None])[:, 0]
    success = min_merit < merit_baseline

    if adapt_rho:
        drho = torch.where(success,
                           torch.clamp_max(drho / RHO_FACTOR, 1.0 / RHO_FACTOR),
                           torch.clamp_min(drho * RHO_FACTOR, RHO_FACTOR))
        rho = torch.clamp(rho * drho, RHO_MIN, RHO_MAX)
    rho = torch.where(~success & (rho > RHO_MAX), RHO_INIT, rho)

    a = alphas[j]
    step = torch.where(success, a, -1.0)
    s3 = success[:, None, None]
    X = torch.where(s3, X + a[:, None, None] * dZX, X)
    U = torch.where(s3, U + a[:, None, None] * dZU, U)
    merit = torch.where(success, min_merit, merit_baseline)
    return X, U, merit, step, rho, drho
