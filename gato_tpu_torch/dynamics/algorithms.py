"""Rigid-body dynamics algorithms in plain PyTorch, batched over leading
dimensions.

Port of gato_tpu/dynamics/algorithms.py: RNEA inverse dynamics, CRBA mass
matrix, forward dynamics, analytical dynamics gradients, second-order
derivatives, the energies, end-effector kinematics and the ABA. The JAX
functions take one configuration and rely on vmap; these take q of shape
(..., nq) (and qd, qdd, tau alike, f_ext (..., 6) or (6,)) and loop over the
joints, which are few and fixed per plant. They are plant-generic: any
serial chain a RobotModel holds, on either device.

External wrench semantics mirror the reference's `*_fext.cuh` variants: a
6D spatial force [moment; force] in the end-effector link frame,
subtracted from the EE link's net spatial force in the RNEA pass.

The second-order derivatives and the EE pose Hessian use
torch.func.jacfwd (forward over forward), sample by sample.
"""

from __future__ import annotations

import torch

from ..robots.model import RobotModel
from .spatial import (cross, crf, crm, imul, motion_transform, mv, rodrigues,
                      xf_apply_T, xm_apply)


def _per_sample(fn, *args):
    """fn applied to each sample of args (..., k) through torch.func.vmap
    over the flattened leading dimensions; nested tuple outputs come back
    with the leading dimensions restored."""
    lead = args[0].shape[:-1]
    flat = [a.expand(*lead, a.shape[-1]).reshape(-1, a.shape[-1]) for a in args]
    out = torch.func.vmap(fn)(*flat)

    def restore(o):
        if isinstance(o, tuple):
            return tuple(restore(x) for x in o)
        return o.reshape(*lead, *o.shape[1:])

    return restore(out)


def _motion_subspace(model: RobotModel):
    """(nq, 6) joint motion subspaces S_i = [axis_i; 0] (revolute joints)."""
    return torch.cat([model.axis, torch.zeros_like(model.axis)], -1)


def joint_transforms(model: RobotModel, q):
    """Per-joint motion transform (E, r), child<-parent, at configuration q:
    E (..., nq, 3, 3) = (R_tree_i R_axis(q_i))^T, r (nq, 3) = p_tree_i. Also
    returns R_link (..., nq, 3, 3), the rotation of each child in its
    parent."""
    R_link = model.R_tree @ rodrigues(model.axis, q)
    return R_link.mT, model.p_tree, R_link


def fk(model: RobotModel, q, R_link=None):
    """World pose of each link frame: R_w (..., nq, 3, 3), p_w (..., nq, 3)."""
    if R_link is None:
        R_link = joint_transforms(model, q)[2]
    Rs, ps = [], []
    Rw = torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)
    pw = q.new_zeros(*q.shape[:-1], 3)
    for i in range(model.nq):
        pw = pw + mv(Rw, model.p_tree[i])
        Rw = Rw @ R_link[..., i, :, :]
        Rs.append(Rw)
        ps.append(pw)
    return torch.stack(Rs, -3), torch.stack(ps, -2)


def ee_position(model: RobotModel, q):
    """6D end-effector pose [x, y, z, roll, pitch, yaw] of the last joint
    frame, (..., 6). As the reference's generated `end_effector_positions`:
    the trailing fixed tool offset is not applied, and rpy uses the same
    atan2 extraction."""
    Rs, ps = fk(model, q)
    R, p = Rs[..., -1, :, :], ps[..., -1, :]
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = -torch.atan2(R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.cat([p, torch.stack([roll, pitch, yaw], -1)], -1)


def ee_position_and_jacobian(model: RobotModel, q):
    """EE xyz (..., 3) and its Jacobian (..., 3, nq) from one FK pass:
    column i is w_i x (p_ee - p_i), w_i the world-frame joint axis."""
    Rs, ps = fk(model, q)
    p_ee = ps[..., -1, :]
    cols = [cross(mv(Rs[..., i, :, :], model.axis[i]), p_ee - ps[..., i, :])
            for i in range(model.nq)]
    return p_ee, torch.stack(cols, -1)


def ee_xyz_jacobian(model: RobotModel, q):
    """Analytic Jacobian of the EE xyz position with respect to q: (..., 3, nq)."""
    return ee_position_and_jacobian(model, q)[1]


def _base_accel(model: RobotModel, q, gravity: bool):
    """RNEA's base acceleration: +g z for gravity (the world is z-up)."""
    z = torch.zeros(5, dtype=q.dtype, device=q.device)
    g = model.gravity.to(q.dtype) if gravity else torch.zeros_like(model.gravity)
    return torch.cat([z, g[None]])


def rnea(model: RobotModel, q, qd, qdd, f_ext=None, gravity: bool = True,
         transforms=None):
    """Recursive Newton-Euler inverse dynamics tau(q, qd, qdd), (..., nq).

    f_ext: optional spatial wrench [n; f] in the EE link frame, subtracted
    from the last link's net spatial force (indy7_fext.cuh:137-142).
    transforms: optional precomputed (E, r) to share FK work across calls."""
    E, r = transforms if transforms is not None else joint_transforms(model, q)[:2]
    S = _motion_subspace(model)
    v_par = torch.zeros(6, dtype=q.dtype, device=q.device)
    a_par = _base_accel(model, q, gravity)
    f_list = []
    for i in range(model.nq):
        Ei = E[..., i, :, :]
        vJ = S[i] * qd[..., i, None]
        v = xm_apply(Ei, r[i], v_par) + vJ
        a = xm_apply(Ei, r[i], a_par) + S[i] * qdd[..., i, None] + crm(v, vJ)
        f_list.append(imul(model.inertia[i], a)
                      + crf(v, imul(model.inertia[i], v)))
        v_par, a_par = v, a
    if f_ext is not None:
        f_list[-1] = f_list[-1] - f_ext
    tau = [None] * model.nq
    for i in reversed(range(model.nq)):
        tau[i] = (S[i] * f_list[i]).sum(-1)
        if i > 0:
            f_list[i - 1] = f_list[i - 1] + xf_apply_T(E[..., i, :, :], r[i], f_list[i])
    return torch.stack(tau, -1)


def crba(model: RobotModel, q, transforms=None):
    """Composite rigid body algorithm: the joint-space mass matrix M(q),
    (..., nq, nq)."""
    E, r = transforms if transforms is not None else joint_transforms(model, q)[:2]
    nq = model.nq
    S = _motion_subspace(model)
    Ic = [model.inertia[i] for i in range(nq)]
    M = [[None] * nq for _ in range(nq)]
    for i in reversed(range(nq)):
        if i > 0:
            X = motion_transform(E[..., i, :, :], r[i])
            Ic[i - 1] = Ic[i - 1] + X.mT @ Ic[i] @ X
        F = imul(Ic[i], S[i])
        M[i][i] = (S[i] * F).sum(-1)
        for j in reversed(range(i)):
            F = xf_apply_T(E[..., j + 1, :, :], r[j + 1], F)
            M[i][j] = M[j][i] = (F * S[j]).sum(-1)
    lead = q.shape[:-1]  # the last link's diagonal entry is a constant
    return torch.stack([torch.stack([m.expand(lead) for m in row], -1) for row in M], -2)


def mass_matrix_cholesky(model: RobotModel, q, transforms=None):
    """Lower Cholesky factor of M(q). cholesky_ex: no host check of the
    factorisation's status, so a CUDA caller never waits on the device."""
    return torch.linalg.cholesky_ex(crba(model, q, transforms=transforms))[0]


def _chol_solve(L, b):
    """x with L L^T x = b, by the two triangular solves of LAPACK's potrs
    (equal bit for bit to torch.cholesky_solve on the CPU). On the card
    torch.cholesky_solve of a batch takes MAGMA's batched potrs, which a
    CUDA graph cannot capture; the triangular solves can be."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def fd(model: RobotModel, q, qd, tau, f_ext=None, transforms=None):
    """Forward dynamics qdd = M(q)^-1 (tau - c(q, qd, f_ext)), (..., nq): the
    reference's composition of the mass matrix, the RNEA bias and a solve
    (indy7_plant.cuh:150-173)."""
    c = rnea(model, q, qd, torch.zeros_like(q), f_ext=f_ext, transforms=transforms)
    L = mass_matrix_cholesky(model, q, transforms=transforms)
    return _chol_solve(L, tau - c)


def fd_and_grad(model: RobotModel, q, qd, tau, f_ext=None):
    """Forward dynamics with its gradients: (qdd, dqdd/dq, dqdd/dqd,
    dqdd/dtau = M^-1), the last three (..., nq, nq), through
      d qdd / dz = -M^-1 d ID(q, qd, qdd*) / dz
    (indy7_plant.cuh:180-217), the inverse-dynamics partials by forward-mode
    differentiation of the RNEA."""
    c = rnea(model, q, qd, torch.zeros_like(q), f_ext=f_ext)
    L = mass_matrix_cholesky(model, q)
    qdd = _chol_solve(L, tau - c)
    if f_ext is None:
        did_dq, did_dqd = _per_sample(
            lambda q_, qd_, qdd_: torch.func.jacfwd(
                lambda a, b: rnea(model, a, b, qdd_), argnums=(0, 1))(q_, qd_),
            q, qd, qdd)
    else:
        did_dq, did_dqd = _per_sample(
            lambda q_, qd_, qdd_, fe_: torch.func.jacfwd(
                lambda a, b: rnea(model, a, b, qdd_, f_ext=fe_), argnums=(0, 1))(q_, qd_),
            q, qd, qdd, f_ext)
    eye = torch.eye(model.nq, dtype=q.dtype, device=q.device)
    Minv = torch.cholesky_solve(eye.expand(L.shape), L)
    return qdd, -Minv @ did_dq, -Minv @ did_dqd, Minv


def kinetic_energy(model: RobotModel, q, qd):
    return 0.5 * (qd * mv(crba(model, q), qd)).sum(-1)


def potential_energy(model: RobotModel, q):
    """Sum of m g z_com over the links (z-up world), (...)."""
    Rs, ps = fk(model, q)
    pe = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    for i in range(model.nq):
        I6 = model.inertia[i]
        m = I6[5, 5]
        mc = torch.stack([I6[2, 4], I6[0, 5], I6[1, 3]])  # m * com, unskewed
        com_w = ps[..., i, :] + mv(Rs[..., i, :, :], mc / torch.clamp(m, min=1e-12))
        pe = pe + m * model.gravity * com_w[..., 2]
    return pe


def id_so_derivatives(model: RobotModel, q, qd, qdd):
    """Second-order inverse-dynamics derivatives, each (..., nq, nq, nq):
    ((d2tau/dq dq, d2tau/dq dqd), (d2tau/dqd dq, d2tau/dqd dqd)), the JAX
    package's nesting (the reference's generated `idsva_so_inner`)."""
    def one(q_, qd_, qdd_):
        f = lambda a, b: rnea(model, a, b, qdd_)
        return torch.func.jacfwd(torch.func.jacfwd(f, argnums=(0, 1)),
                                 argnums=(0, 1))(q_, qd_)
    return _per_sample(one, q, qd, qdd)


def fd_so_derivatives(model: RobotModel, q, qd, tau):
    """Second-order forward-dynamics derivatives over (q, qd, tau), nested
    3 x 3, each (..., nq, nq, nq) (`fdsva_so_inner`)."""
    def one(q_, qd_, t_):
        f = lambda a, b, c: fd(model, a, b, c)
        return torch.func.jacfwd(torch.func.jacfwd(f, argnums=(0, 1, 2)),
                                 argnums=(0, 1, 2))(q_, qd_, t_)
    return _per_sample(one, q, qd, tau)


def ee_pose_grad_hess(model: RobotModel, q):
    """Gradient (..., 6, nq) and Hessian (..., 6, nq, nq) of the 6D EE pose
    with respect to q (the generated `end_effector_pose_gradient[_hessian]`)."""
    f = lambda q_: ee_position(model, q_)
    return _per_sample(lambda q_: (torch.func.jacfwd(f)(q_),
                                   torch.func.jacfwd(torch.func.jacfwd(f))(q_)), q)


def aba(model: RobotModel, q, qd, tau, f_ext=None):
    """Articulated-body algorithm: O(n) forward dynamics without forming M
    (Featherstone ch. 7; the reference's generated, unused `aba`). f_ext
    follows rnea's EE-link convention."""
    E, r, _ = joint_transforms(model, q)
    nq = model.nq
    S = _motion_subspace(model)
    v, c = [], []
    v_par = torch.zeros(6, dtype=q.dtype, device=q.device)
    for i in range(nq):
        vJ = S[i] * qd[..., i, None]
        vi = xm_apply(E[..., i, :, :], r[i], v_par) + vJ
        v.append(vi)
        c.append(crm(vi, vJ))
        v_par = vi
    IA = [model.inertia[i] for i in range(nq)]
    pA = [crf(v[i], imul(model.inertia[i], v[i])) for i in range(nq)]
    if f_ext is not None:
        pA[-1] = pA[-1] - f_ext
    U, d, u_ = [None] * nq, [None] * nq, [None] * nq
    for i in reversed(range(nq)):
        U[i] = imul(IA[i], S[i])
        d[i] = (S[i] * U[i]).sum(-1)
        u_[i] = tau[..., i] - (S[i] * pA[i]).sum(-1)
        if i > 0:
            Ia = IA[i] - U[i][..., :, None] * U[i][..., None, :] / d[i][..., None, None]
            pa = pA[i] + imul(Ia, c[i]) + U[i] * (u_[i] / d[i])[..., None]
            X = motion_transform(E[..., i, :, :], r[i])
            IA[i - 1] = IA[i - 1] + X.mT @ Ia @ X
            pA[i - 1] = pA[i - 1] + xf_apply_T(E[..., i, :, :], r[i], pa)
    a_par = _base_accel(model, q, True)
    qdd = [None] * nq
    for i in range(nq):
        a_p = xm_apply(E[..., i, :, :], r[i], a_par) + c[i]
        qdd[i] = (u_[i] - (U[i] * a_p).sum(-1)) / d[i]
        a_par = a_p + S[i] * qdd[i][..., None]
    return torch.stack(qdd, -1)
