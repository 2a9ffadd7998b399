"""The port's CUDA kernels against their plain PyTorch versions, on the card.

No jax here: the card's machine has none. Run there with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py configures jax). Without a CUDA device every test skips.
The float32 tolerances: the kernels contract to FMAs, use CUDA's sinf/cosf
and sum in another order; PCG at tol 1e-4 may stop at another count where
the assembly's rounding differs, so the solve is compared on the lanes
where step and count agree.
"""

import numpy as np
import pytest
import torch

from gato_tpu_torch.api.common import figure8, rk4_step
from gato_tpu_torch.api.config import DEFAULT_SOLVER_PARAMS as P
from gato_tpu_torch.api.config import INDY7_START_CONFIGS
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.ops.cuda_sim import rk4_plain, rk4_step_batched
from gato_tpu_torch.ops.cuda_solve import (IterState, Problem, sqp_iter_cuda,
                                           sqp_iter_reference,
                                           sqp_solve_chained)
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import solve_batched
from gato_tpu_torch.solver.types import BSQPSettings, HyperParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, lo, hi, shape, dev):
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                        device=dev)


def test_rk4_kernel_matches_plain(dev):
    m = load_robot("indy7", torch.float32, dev)
    rng = np.random.default_rng(5)
    x, u, fe = (_rand(rng, -1, 1, (512, 12), dev), _rand(rng, -5, 5, (512, 6), dev),
                _rand(rng, -5, 5, (512, 6), dev))
    for f in (None, fe):
        before = rk4_step_batched.launches
        out = rk4_step_batched(m, x, u, 0.01, f, 2)
        torch.cuda.synchronize()
        assert rk4_step_batched.launches == before + 1
        torch.testing.assert_close(out, rk4_plain(m, x, u, 0.01, f, 2),
                                   rtol=1e-5, atol=1e-5)


def test_bsqp_iter_kernel_matches_reference(dev):
    """One SQP iteration on a warm fig-8 steady state (indy7, N=16, B=64,
    DEFAULT_SOLVER_PARAMS, 6 warm-up cycles on the kernel route)."""
    B, N, dt = 64, 16, 0.01
    m = load_robot("indy7", torch.float32, dev)
    cp = CostParams(**{k: P[k] for k in ("q_cost", "qd_cost", "u_cost", "N_cost",
                                         "q_lim_cost")})
    settings = BSQPSettings(N=N, max_sqp_iters=1, max_pcg_iters=P["max_pcg_iters"])
    hp = HyperParams.create(B, rho=P["rho"], mu=P["mu"], pcg_tol=P["pcg_tol"],
                            device=dev)
    traj = torch.tensor(figure8(dt).reshape(-1, 6), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    fe = _rand(rng, -5, 5, (B, 6), dev)
    fe[0] = 0.0
    x0 = torch.tensor(np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]),
                      dtype=torch.float32, device=dev)
    X, x_s = x0.expand(B, N, 12).contiguous(), x0.expand(B, 12).contiguous()
    U = torch.zeros(B, N - 1, 6, device=dev)
    lam = torch.zeros(B, N, 12, device=dev)

    def ref(i):
        return traj[i:i + N][None].expand(B, N, 6).contiguous()

    for i in range(6):
        X, U, lam, _, _ = solve_batched(m, settings, cp, hp, X, U, lam, x_s,
                                        ref(i), fe, dt)
        x_s = rk4_step(m, x_s[0], U[0, 0], dt, substeps=10).expand(B, 12).contiguous()
        X[:, 0] = x_s

    zero = torch.zeros(B, device=dev)
    prob = Problem(x_s, ref(5), fe, hp.mu, hp.pcg_tol, dt)
    st0 = IterState(X, U, lam, hp.rho, hp.drho, zero, zero, zero, zero)
    before = sqp_iter_cuda.launches
    ko, ks = sqp_iter_cuda(m, cp, prob, st0, settings, seeded=False)
    torch.cuda.synchronize()
    assert sqp_iter_cuda.launches == before + 1
    ro, rs = sqp_iter_reference(m, cp, prob, st0, settings, seeded=False)
    assert torch.isfinite(ko.X).all() and torch.isfinite(ko.lam).all()
    torch.testing.assert_close(ko.merit0, ro.merit0, rtol=1e-5, atol=0)
    assert (ks.ls_step == rs.ls_step).double().mean() >= 0.95
    assert ((ks.pcg_iters - rs.pcg_iters).abs() <= 3).double().mean() >= 0.95
    same = (ks.ls_step == rs.ls_step) & (ks.pcg_iters == rs.pcg_iters)
    for k, r in ((ko.X, ro.X), (ko.U, ro.U)):
        assert (k[same] - r[same]).abs().max() <= 1e-3 * r[same].abs().max()
    torch.testing.assert_close(ko.conv, ro.conv)
    torch.testing.assert_close(ko.sqp, ro.sqp)

    # three SQP iterations through the chained loop, both routes
    st3 = BSQPSettings(N=N, max_sqp_iters=3, max_pcg_iters=P["max_pcg_iters"])
    before = sqp_iter_cuda.launches
    k3 = solve_batched(m, st3, cp, hp, X, U, lam, x_s, ref(5), fe, dt)
    assert sqp_iter_cuda.launches == before + int(k3[4].num_iters_run)
    r3 = sqp_solve_chained(sqp_iter_reference, m, cp, st3, X, U, lam, x_s,
                           ref(5), fe, hp.rho, hp.drho, hp.mu, hp.pcg_tol, dt)
    assert torch.isfinite(k3[0]).all()
    assert (k3[4].ls_step_size == r3[11]).double().mean() >= 0.9
