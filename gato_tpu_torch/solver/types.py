"""Solver configuration and statistics contracts.

Port of gato_tpu/solver/types.py. `BSQPSettings` keeps the solver's static
configuration, with the JAX package's two route gates `solve_kernel` and
`iter_kernel` ("auto" | "fused" | "off"; solver/bsqp.py::select_route says
what they choose on the card). The TPU-tuned gates (kkt_kernel, pcg_kernel,
fold_merit0) are gone. `HyperParams` holds the per-problem hyperparameters
and `SQPStats` the per-solve statistics, as tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..robots.model import check_device


KERNEL_GATES = ("auto", "fused", "off")


@dataclass(frozen=True)
class BSQPSettings:
    N: int = 32
    max_sqp_iters: int = 5
    max_pcg_iters: int = 100
    solve_ratio: float = 1.0
    num_alphas: int = 8  # settings.h:15
    integrator_type: int = 2  # trapezoidal default, integrator.cuh:20
    adapt_rho: bool = True
    linear_solver: str = "pcg"  # the reference's preconditioned CG; the
    # direct block-tridiagonal solve ("btd") is not ported yet
    kkt_tol: float = 1e-4  # accepted for parity; the reference's explicit
    # KKT-tolerance exit is disabled in its solve loop (bsqp.cuh:153)
    solve_kernel: str = "auto"  # "fused": one whole-iteration kernel per
    # SQP iteration (bsqp_iter); "off": the per-stage routes; "auto": fused
    # for N <= 128
    iter_kernel: str = "auto"  # with solve_kernel off: "fused" runs KKT +
    # Schur + PCG + dz in one kernel (iter); "off": the staged kernels;
    # "auto": fused for N <= 128

    def __post_init__(self):
        for name in ("solve_kernel", "iter_kernel"):
            if getattr(self, name) not in KERNEL_GATES:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected "
                                 f"one of {KERNEL_GATES}")


@dataclass(frozen=True)
class HyperParams:
    """Per-problem batched hyperparameters, (B,) each."""

    rho: torch.Tensor
    drho: torch.Tensor
    mu: torch.Tensor
    pcg_tol: torch.Tensor

    @staticmethod
    def create(batch_size: int, rho=1e-3, mu=10.0, pcg_tol=1e-5,
               dtype=torch.float32, device="cuda"):
        device = check_device(device)

        def full(v):
            return torch.full((batch_size,), v, dtype=dtype, device=device)

        return HyperParams(rho=full(rho), drho=full(1.0), mu=full(mu),
                           pcg_tol=full(pcg_tol))


@dataclass(frozen=True)
class SQPStats:
    """Per-solve statistics (gato/types.cuh:46-59)."""

    sqp_iters: torch.Tensor  # (B,) int32: iteration at which the problem
    # converged (pcg_iters == 0), or iterations run if it never did
    kkt_converged: torch.Tensor  # (B,) int32
    pcg_iters: torch.Tensor  # (max_sqp_iters, B) int32
    ls_min_merit: torch.Tensor  # (max_sqp_iters, B)
    ls_step_size: torch.Tensor  # (max_sqp_iters, B)
    initial_merit: torch.Tensor  # (B,) merit of the warm start
    final_merit: torch.Tensor  # (B,) merit of the returned trajectory
    num_iters_run: torch.Tensor  # () int32
