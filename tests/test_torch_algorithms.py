"""The port's rigid-body algorithms (gato_tpu_torch.dynamics.algorithms)
against the JAX package's (gato_tpu.dynamics.algorithms) on indy7 and
iiwa14, float64, a batch of 5 inputs made with numpy from a seed, the EE
wrench included; and against the port's own binding of the native C++
runtime (gato_tpu_torch.native, native/rbd.cpp), as tests/test_native.py
holds the JAX package's.

Tolerances: against JAX the same algorithm in the same order of operations,
differing only by the order inside small matrix products (the JAX package's
unrolled exact-float32 forms against torch.matmul) and the Cholesky solve:
rtol 1e-9, atol 1e-9 (the first derivatives and ABA as well). Against the
native runtime, tests/test_native.py's: 1e-9, forward dynamics rtol 1e-7
atol 1e-8, the RK4 step rtol 1e-7 atol 1e-9. The second-order derivatives
are in tests/test_torch_algorithms_so.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu.dynamics import algorithms as JA
from gato_tpu_torch.api.common import rk4_step
from gato_tpu_torch.dynamics import algorithms as TA
from gato_tpu_torch.native import SOURCE, NativeRobot, library_path
from gato_tpu_torch.robots.model import PLANT_URDFS
from gato_tpu_torch.robots.urdf import parse_urdf
from torch_port_helpers import jit_per_sample, models, t64

B = 5
RTOL = ATOL = 1e-9


def _inputs(nq, seed):
    rng = np.random.default_rng(seed)
    q, qd, qdd, tau = (rng.uniform(-1.5, 1.5, (B, nq)) for _ in range(4))
    return q, qd, qdd, tau, rng.uniform(-5, 5, (B, 6))


def _port(tm, q, qd, qdd, tau, fe):
    E, r, R_link = TA.joint_transforms(tm, q)
    return dict(
        joint_transforms=(E, R_link), fk=TA.fk(tm, q), ee_position=TA.ee_position(tm, q),
        ee_xyz_jacobian=TA.ee_xyz_jacobian(tm, q),
        ee_position_and_jacobian=TA.ee_position_and_jacobian(tm, q),
        rnea=TA.rnea(tm, q, qd, qdd, f_ext=fe),
        rnea_no_gravity=TA.rnea(tm, q, qd, qdd, gravity=False),
        crba=TA.crba(tm, q), mass_matrix_cholesky=TA.mass_matrix_cholesky(tm, q),
        fd=TA.fd(tm, q, qd, tau, f_ext=fe), fd_no_wrench=TA.fd(tm, q, qd, tau),
        fd_and_grad=TA.fd_and_grad(tm, q, qd, tau, f_ext=fe),
        kinetic_energy=TA.kinetic_energy(tm, q, qd),
        potential_energy=TA.potential_energy(tm, q),
        aba=TA.aba(tm, q, qd, tau, f_ext=fe))


def _jax(jm):
    def one(q, qd, qdd, tau, fe):
        E, _, R_link = JA.joint_transforms(jm, q)
        return dict(
            joint_transforms=(E, R_link), fk=JA.fk(jm, q), ee_position=JA.ee_position(jm, q),
            ee_xyz_jacobian=JA.ee_xyz_jacobian(jm, q),
            ee_position_and_jacobian=JA.ee_position_and_jacobian(jm, q),
            rnea=JA.rnea(jm, q, qd, qdd, f_ext=fe),
            rnea_no_gravity=JA.rnea(jm, q, qd, qdd, gravity=False),
            crba=JA.crba(jm, q), mass_matrix_cholesky=JA.mass_matrix_cholesky(jm, q),
            fd=JA.fd(jm, q, qd, tau, f_ext=fe), fd_no_wrench=JA.fd(jm, q, qd, tau),
            fd_and_grad=JA.fd_and_grad(jm, q, qd, tau, f_ext=fe),
            kinetic_energy=JA.kinetic_energy(jm, q, qd),
            potential_energy=JA.potential_energy(jm, q),
            aba=JA.aba(jm, q, qd, tau, f_ext=fe))
    return jit_per_sample(one)


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_algorithms_match_jax(robot):
    """Every first-order function of dynamics/algorithms.py, output by
    output (the second-order ones: test_torch_algorithms_so.py)."""
    jm, tm = models(robot)
    args = _inputs(jm.nq, seed=21)
    ref = _jax(jm)(*map(jnp.asarray, args))
    out = _port(tm, *map(t64, args))
    assert set(out) == set(ref)
    for name in out:
        got, want = jax.tree_util.tree_leaves(out[name]), jax.tree_util.tree_leaves(ref[name])
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("robot", ["indy7", "iiwa14"])
def test_algorithms_match_native_runtime(robot):
    """rnea (with and without a wrench), crba, fd, fk and the RK4 step with
    a world wrench (api.common.rk4_step's algorithms path, the wrench
    re-expressed at each stage) against native/rbd.cpp, sample by sample."""
    _, tm = models(robot)
    native = NativeRobot(parse_urdf(PLANT_URDFS[robot]))
    q, qd, qdd, tau, fe = _inputs(tm.nq, seed=22)
    fe_world = np.array([5.0, -10.0, 20.0, 1.0, 0.0, -2.0])
    rnea = TA.rnea(tm, t64(q), t64(qd), t64(qdd)).numpy()
    rnea_fe = TA.rnea(tm, t64(q), t64(qd), t64(qdd), f_ext=t64(fe)).numpy()
    crba = TA.crba(tm, t64(q)).numpy()
    fd = TA.fd(tm, t64(q), t64(qd), t64(tau)).numpy()
    ee = TA.ee_position(tm, t64(q)).numpy()
    for i in range(B):
        np.testing.assert_allclose(rnea[i], native.rnea(q[i], qd[i], qdd[i]), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(rnea_fe[i], native.rnea(q[i], qd[i], qdd[i], f_ext=fe[i]),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(crba[i], native.crba(q[i]), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(fd[i], native.fd(q[i], qd[i], tau[i]), rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(ee[i], native.ee_pose(q[i]), rtol=1e-9, atol=1e-9)
        x = np.concatenate([q[i], qd[i]])
        xn = rk4_step(tm, t64(x), t64(tau[i]), 0.001, f_ext_world=t64(fe_world)).numpy()
        np.testing.assert_allclose(xn, native.rk4(x, tau[i], 0.001, f_ext_world=fe_world),
                                   rtol=1e-7, atol=1e-9)


def test_native_binding_builds_outside_native_dir():
    """The port's binding builds librbd-<hash>.so under build/gato_tpu_torch/
    and adds nothing under native/ (whose librbd.so is a tracked file of the
    JAX package, which tests/test_native.py may rebuild meanwhile)."""
    native_dir = os.path.dirname(SOURCE)
    before = set(os.listdir(native_dir))
    NativeRobot(parse_urdf(PLANT_URDFS["indy7"]))
    assert set(os.listdir(native_dir)) == before
    path = library_path()
    assert os.path.exists(path)
    assert os.path.join("build", "gato_tpu_torch", "librbd-") in path
    assert os.path.commonpath([path, native_dir]) != native_dir
