"""The port's RK4 plant step against the JAX package (float64, CPU), and
which plants each kernel is built for (ops/cuda_sim.py::CUDA_ROBOTS). The
CUDA kernel csrc/rk4.cu is held to its plain version in
tests/test_torch_cuda.py, on the card.

On a CPU tensor `rk4_step_batched` runs its plain version, `rk4_channels`:
the same channel trace as gato_tpu's Pallas kernel body, so the two agree
to rtol 1e-10. Against the spatial-algebra rk4_step the trace differs only
by its 1e-9 constant snap, which moves nothing on iiwa14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.api.common import rk4_step as jax_rk4_step
from gato_tpu.ops.merit_fast import _get_cd as jax_get_cd
from gato_tpu.ops.pallas_sim import rk4_channels as jax_rk4_channels
from gato_tpu_torch.api.common import rk4_step
from gato_tpu_torch.api.mpc import add_pendulum
from gato_tpu_torch.ops.cuda_kkt import setup_kkt_batched_cuda
from gato_tpu_torch.ops.cuda_pcg import pcg_solve_batched_cuda
from gato_tpu_torch.ops.cuda_sim import (CUDA_ROBOTS, require_cuda_robot,
                                         rk4_step_batched)
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.solver.bsqp import select_route
from torch_port_helpers import jax_in_pieces, jit_per_sample, models, t64

B, DT, SUBSTEPS = 5, 0.01, 2


def _inputs(nq, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 2 * nq)), rng.uniform(-20, 20, (B, nq)),
            rng.uniform(-5, 5, (B, 6)))


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
@pytest.mark.parametrize("with_fe", [False, True])
def test_rk4_matches_jax_rk4_channels(robot, with_fe):
    jm, tm = models(robot)
    nq = jm.nq
    x, u, fe = _inputs(nq)
    jfe = [jnp.asarray(fe[:, i]) for i in range(6)] if with_fe else None
    q, qd = jax_rk4_channels(jax_get_cd(jm.key),
                             [jnp.asarray(x[:, i]) for i in range(nq)],
                             [jnp.asarray(x[:, nq + i]) for i in range(nq)],
                             [jnp.asarray(u[:, i]) for i in range(nq)], jfe,
                             DT, SUBSTEPS)
    ref = np.stack([np.asarray(c) for c in q + qd], 1)
    out = rk4_step_batched(tm, t64(x), t64(u), DT,
                           t64(fe) if with_fe else None, SUBSTEPS)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_rk4_step_matches_jax_rk4_step(monkeypatch):
    """api.common.rk4_step (one state) against gato_tpu.api.common.rk4_step,
    the spatial-algebra RK4, for each of the B states, its forward dynamics
    compiled once (torch_port_helpers.jax_in_pieces). iiwa14, whose step
    on the CPU is the rk4 kernel's plain version (the channel trace): indy7's
    constant snap alone moves a step by ~3e-9 relative."""
    jax_in_pieces(monkeypatch)
    jm, tm = models("iiwa14")
    x, u, _ = _inputs(jm.nq, seed=4)
    ref = jit_per_sample(lambda a, b: jax_rk4_step(jm, a, b, DT, substeps=SUBSTEPS))(
        jnp.asarray(x), jnp.asarray(u))
    out = np.stack([rk4_step(tm, t64(x[i]), t64(u[i]), DT,
                             substeps=SUBSTEPS).numpy() for i in range(B)])
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_rk4_wrapper_takes_the_plain_path_only_on_cpu():
    """A tensor that is not on the CPU never falls back to the plain
    version: it is checked for the kernel and refused (here a 'meta'
    tensor), through the wrapper and through api.common.rk4_step, which
    routes a plant the kernel serves and no world wrench to the kernel:
    indy7, iiwa14 and the pendulum-augmented plants add_pendulum makes of
    them (their header generated from the registered constants, no card
    needed for that)."""
    for robot in ("indy7", "iiwa14"):
        base = load_robot(robot, torch.float32, device="cpu")
        for m in (base, add_pendulum(base, mass=15.0, length=0.3)):
            x = torch.empty(2, m.nx, device="meta")
            u = torch.empty(2, m.nu, device="meta")
            with pytest.raises(ValueError, match="CUDA tensor"):
                rk4_step_batched(m, x, u, DT)
            with pytest.raises(ValueError, match="CUDA tensor"):
                rk4_step(m, x[0], u[0], DT)


def test_each_kernel_names_its_plants():
    """Every kernel is built for indy7 and iiwa14; every kernel but rk4
    raises NotImplementedError naming the kernel and the ROADMAP item for
    the pendulum-augmented plant, through require_cuda_robot and before
    any launch; rk4 serves it from a library of its own
    (require_cuda_robot names its generated plant). The kkt and pcg
    wrappers take iiwa14's inputs to their checks (a tensor off the card
    is refused there, before any build or launch); pcg's, which sees no
    model, raises for a state size no plant has, naming the ROADMAP item.
    Past N = 128 and with iter_kernel="off" a solve takes the staged
    route."""
    assert CUDA_ROBOTS == {"rk4": ("indy7", "iiwa14"), "bsqp_iter": ("indy7", "iiwa14"),
                           "iter": ("indy7", "iiwa14"), "pcg": ("indy7", "iiwa14"),
                           "merit": ("indy7", "iiwa14"), "kkt": ("indy7", "iiwa14")}
    indy7 = load_robot("indy7", torch.float32, device="cpu")
    iiwa = load_robot("iiwa14", torch.float32, device="cpu")
    pend = add_pendulum(iiwa, mass=15.0, length=0.3)
    for kernel in CUDA_ROBOTS:
        assert require_cuda_robot(indy7, kernel) == "indy7"
        if kernel == "rk4":
            assert require_cuda_robot(pend, kernel).startswith("iiwa14_pendulum_")
        else:
            with pytest.raises(NotImplementedError,
                               match=f"{kernel} kernel.*ROADMAP Queue 2"):
                require_cuda_robot(pend, kernel)
        assert require_cuda_robot(iiwa, kernel) == "iiwa14"
    B, N = 2, 4

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with pytest.raises(NotImplementedError, match="kkt kernel.*ROADMAP Queue 2"):
        setup_kkt_batched_cuda(pend, None, meta(B, N, 20), meta(B, N - 1, 10), meta(B, 20),
                               meta(B, N, 6), meta(B, 6), DT)
    with pytest.raises(ValueError, match="CUDA tensor"):
        setup_kkt_batched_cuda(iiwa, None, meta(B, N, 14), meta(B, N - 1, 7), meta(B, 14),
                               meta(B, N, 6), meta(B, 6), DT)
    for nx, err, match in ((14, ValueError, "CUDA tensor"),
                           (20, NotImplementedError, "pcg kernel.*nx=20.*ROADMAP Queue 2")):
        with pytest.raises(err, match=match):
            pcg_solve_batched_cuda(meta(B, N, nx, nx), meta(B, N - 1, nx, nx),
                                   meta(B, N, nx, nx), meta(B, N - 1, nx, nx), meta(B, N, nx),
                                   meta(B, N, nx), meta(B), 10, meta(B, dtype=torch.bool))
    assert [select_route("auto", "auto", n, True) for n in (128, 129)] == ["solve", "staged"]
    assert select_route("off", "auto", 128, True) == "iter"
    assert select_route("off", "off", 32, True) == "staged"
