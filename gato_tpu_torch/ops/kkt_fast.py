"""Codegen-style KKT setup over (lane, knot) work items.

Port of gato_tpu/ops/kkt_fast.py (the reference's setupKKTSystemBatched,
setup_kkt.cuh:14-157): the dynamics linearization (A_k, B_k) from sparse
dual-number tangents, the integrator defects, and the cost gradient and
Hessian all come out of one channel trace with the robot constants folded.
`kkt_knot_channels_structured` is also what dynamics/codegen.py traces into
the CUDA `knot_kkt` function.
"""

from __future__ import annotations

from dataclasses import astuple

import torch

from ..dynamics import mathshim as ms
from ..dynamics.channelized import (ChannelizedDynamics, Dual, chadd, chmul,
                                    chneg, chsub, chsum, mat_vec)
from ..robots.model import RobotModel
from .cost import CostParams
from .kkt import KKTSystem
from .merit_fast import _get_cd, _limits


def _vec1(c, like):
    """Materialize a channel on `like`'s shape. On the symbolic trace (like
    is not a tensor) constants stay literals and a structural zero is 0."""
    if not isinstance(like, torch.Tensor):
        return 0.0 if c is None else c
    if c is None:
        return torch.zeros_like(like)
    if isinstance(c, (int, float)):
        return torch.full_like(like, c)
    if c.shape != like.shape:
        return c.expand(like.shape).to(like.dtype)
    return c


def _mat(channels, like):
    """Stack a 2D list of channels into a tensor (M, rows, cols)."""
    return torch.stack([torch.stack([_vec1(c, like) for c in row], -1)
                        for row in channels], -2)


def _vec(channels, like):
    return torch.stack([_vec1(c, like) for c in channels], -1)


def _barrier_grad(x, lo, hi):
    d1 = ms.maximum(x - lo, 1e-6)
    d2 = ms.maximum(hi - x, 1e-6)
    return -1.0 / d1 + 1.0 / d2


def fd_primal_channels(cd: ChannelizedDynamics, cs, ss, qd, u, fe):
    """The primal half of the forward dynamics: (qdd (nq channels), Minv
    (nq x nq channels, Minv[c][r] = (M^-1)[r, c], column c's solve))."""
    nq = cd.nq
    bias = cd.rnea(cs, ss, qd, [None] * nq, f_ext=fe)
    M = cd.crba(cs, ss)
    L, inv_d = cd.chol_factor(M)
    rhs = [chsub(u[i], bias[i]) for i in range(nq)]
    qdd = cd.chol_solve_factored(L, inv_d, rhs)
    Minv = [cd.chol_solve_factored(
        L, inv_d, [1.0 if r == c else None for r in range(nq)])
        for c in range(nq)]  # Minv[c][r] = (M^-1)[r, c]; symmetric
    return qdd, Minv


def dual_id_columns(cd: ChannelizedDynamics, cs, ss, qd, qdd, fe):
    """The dual RNEA at the achieved qdd: cols[z][j] = dID_j / dz for the
    2 nq tangent directions z (q_z for z < nq, qd_{z - nq} past it); None
    where structurally zero. Each direction's channels depend on no other
    direction's, so any subset of them is a slice of this trace."""
    nq = cd.nq
    cs_d = [Dual(cs[i], {i: chneg(ss[i])}) for i in range(nq)]
    ss_d = [Dual(ss[i], {i: cs[i]}) for i in range(nq)]
    qd_d = [Dual(qd[i], {nq + i: 1.0}) for i in range(nq)]
    tau_d = cd.rnea(cs_d, ss_d, qd_d, qdd, f_ext=fe)
    return [[tau_d[j].t.get(z) if isinstance(tau_d[j], Dual) else None
             for j in range(nq)] for z in range(2 * nq)]


def dqdd_channels(Minv, cols, nq):
    """dqdd[i][z] = -sum_j Minv[j][i] dID[j][z]."""
    dqdd = [[None] * (2 * nq) for _ in range(nq)]
    for z in range(2 * nq):
        for i in range(nq):
            dqdd[i][z] = chneg(chsum(
                [chmul(Minv[j][i], cols[z][j]) for j in range(nq)]))
    return dqdd


def _fd_and_grad_channels(cd: ChannelizedDynamics, q, qd, u, fe):
    """Returns (qdd (nq channels), dqdd (nq x 2nq channel lists),
    Minv (nq x nq channels), plus primal FK products (Rws, pws))."""
    cs = [ms.cos(x) for x in q]
    ss = [ms.sin(x) for x in q]
    qdd, Minv = fd_primal_channels(cd, cs, ss, qd, u, fe)
    cols = dual_id_columns(cd, cs, ss, qd, qdd, fe)
    dqdd = dqdd_channels(Minv, cols, cd.nq)
    fk = cd.fk_ee(cs, ss)
    return qdd, dqdd, Minv, fk


def ab_channels(dqdd, Minv, dt, integrator_type: int, nq: int):
    """A (nx x nx) and B (nx x nu) channels of the integrator
    (integrator.cuh:65-188 formulas; trapezoidal default) from dqdd/dx and
    dqdd/du = Minv."""
    nx = 2 * nq
    it = integrator_type
    A_ch = [[None] * nx for _ in range(nx)]
    B_ch = [[None] * nq for _ in range(nx)]
    for r in range(nq):
        for c in range(nx):
            dq_rc = dqdd[r][c]
            if it == 0:
                top = 1.0 if r == c else (dt if c == nq + r else None)
                bot = chmul(dt, dq_rc)
            elif it == 1:
                base = 1.0 if r == c else (dt if c == nq + r else None)
                top = chadd(base, chmul(dt * dt, dq_rc))
                bot = chmul(dt, dq_rc)
            else:
                base = 1.0 if r == c else (dt if c == nq + r else None)
                top = chadd(base, chmul(0.5 * dt * dt, dq_rc))
                bot = chmul(dt, dq_rc)
            A_ch[r][c] = top
            A_ch[nq + r][c] = chadd(1.0 if nq + r == c else None, bot)
        for c in range(nq):
            du_rc = Minv[c][r]  # dqdd/du = Minv (symmetric)
            if it == 0:
                B_ch[r][c] = None
            elif it == 1:
                B_ch[r][c] = chmul(dt * dt, du_rc)
            else:
                B_ch[r][c] = chmul(0.5 * dt * dt, du_rc)
            B_ch[nq + r][c] = chmul(dt, du_rc)
    return A_ch, B_ch


def defect_channels(q, qd, xn, qdd, dt, integrator_type: int, like):
    """The defect c_{k+1} = x_next - integrate(x, qdd), nx channels."""
    nq = len(q)
    it = integrator_type
    c_ch = []
    for i in range(nq):
        if it == 0:
            q_n = q[i] + dt * qd[i]
        elif it == 1:
            q_n = q[i] + dt * (qd[i] + dt * _vec1(qdd[i], like))
        else:
            q_n = q[i] + dt * qd[i] + (0.5 * dt * dt) * _vec1(qdd[i], like)
        c_ch.append(xn[i] - q_n)
    for i in range(nq):
        qd_n = qd[i] + dt * _vec1(qdd[i], like)
        c_ch.append(xn[nq + i] - qd_n)
    return c_ch


def cost_channels(cd: ChannelizedDynamics, key: str, cp: CostParams, q, qd,
                  u, r3, fk, w_track, like):
    """The knot's cost gradient and Hessian (cost.knot_cost_grad_hess
    semantics) from the FK products fk = (p_ee, Rws, pws): (Q nx x nx, qv
    nx, R_diag nu, rv nu)."""
    nq = cd.nq
    nx = 2 * nq
    p_ee, Rws, pws = fk
    (jlo, jhi), (vlo, vhi), (clo, chi) = _limits(key)
    err = [p_ee[k] - r3[k] for k in range(3)]
    # J columns: w_i x (p_ee - p_i)
    g = []
    for i in range(nq):
        w = mat_vec(Rws[i], cd.axis[i])
        dpi = [chsub(p_ee[k], pws[i][k]) for k in range(3)]
        col = [chsub(chmul(w[1], dpi[2]), chmul(w[2], dpi[1])),
               chsub(chmul(w[2], dpi[0]), chmul(w[0], dpi[2])),
               chsub(chmul(w[0], dpi[1]), chmul(w[1], dpi[0]))]
        g.append(chsum([chmul(col[k], err[k]) for k in range(3)]))
    bg_q = [_barrier_grad(q[i], float(jlo[i]), float(jhi[i]))
            for i in range(nq)]
    bg_qd = [_barrier_grad(qd[i], float(vlo[i]), float(vhi[i]))
             for i in range(nq)]
    grad_q = [w_track * _vec1(g[i], like) + cp.q_lim_cost * bg_q[i]
              for i in range(nq)]
    grad_qd = [cp.qd_cost * qd[i] + cp.vel_lim_cost * bg_qd[i]
               for i in range(nq)]
    Q_ch = [[None] * nx for _ in range(nx)]
    for i in range(nq):
        for j in range(nq):
            Q_ch[i][j] = (w_track * _vec1(chmul(g[i], g[j]), like)
                          + cp.q_lim_cost * (bg_q[i] * bg_q[j]))
        Q_ch[nq + i][nq + i] = (cp.qd_cost
                                + cp.vel_lim_cost * bg_qd[i] * bg_qd[i])
    qv = grad_q + grad_qd

    bg_u = [_barrier_grad(u[i], float(clo[i]), float(chi[i]))
            for i in range(nq)]
    rv = [cp.u_cost * u[i] + cp.ctrl_lim_cost * bg_u[i] for i in range(nq)]
    R_diag = [cp.u_cost + cp.ctrl_lim_cost * bg_u[i] * bg_u[i]
              for i in range(nq)]
    return Q_ch, qv, R_diag, rv


def kkt_knot_channels_structured(cd: ChannelizedDynamics, key: str,
                                 cp: CostParams, q, qd, u, xn, r3, fe, dt,
                                 integrator_type: int, like, w_track=None):
    """Per-work-item KKT channels for non-terminal knots, in structured form
    (channel lists that keep `None` structural zeros). Returns (A_ch nx x nx,
    B_ch nx x nu, c_ch nx, Q_ch nx x nx, qv nx, R_diag nu, rv nu).

    w_track: optional channel overriding cp.q_cost as the tracking weight;
    N_cost makes the same formula emit the terminal-knot cost blocks
    (identical to terminal_cost_channels).

    The stages (fd_primal_channels, dual_id_columns, dqdd_channels,
    ab_channels, defect_channels, cost_channels) are what
    dynamics/codegen.py also emits one by one for the staged CUDA kernels."""
    nq = cd.nq
    if w_track is None:
        w_track = cp.q_cost
    qdd, dqdd, Minv, fk = _fd_and_grad_channels(cd, q, qd, u, fe)
    A_ch, B_ch = ab_channels(dqdd, Minv, dt, integrator_type, nq)
    c_ch = defect_channels(q, qd, xn, qdd, dt, integrator_type, like)
    Q_ch, qv, R_diag, rv = cost_channels(cd, key, cp, q, qd, u, r3, fk,
                                         w_track, like)
    return A_ch, B_ch, c_ch, Q_ch, qv, R_diag, rv


def terminal_cost_channels(cd: ChannelizedDynamics, key: str, cp: CostParams,
                           q, qd, r3, like):
    """Terminal-knot channels: (Q nx x nx, qv nx)."""
    nq = cd.nq
    nx = 2 * nq
    (jlo, jhi), (vlo, vhi), _ = _limits(key)
    cs = [ms.cos(x) for x in q]
    ss = [ms.sin(x) for x in q]
    p_ee, Rws, pws = cd.fk_ee(cs, ss)
    err = [chsub(p_ee[k], r3[k]) for k in range(3)]
    g = []
    for i in range(nq):
        w = mat_vec(Rws[i], cd.axis[i])
        dpi = [chsub(p_ee[k], pws[i][k]) for k in range(3)]
        col = [chsub(chmul(w[1], dpi[2]), chmul(w[2], dpi[1])),
               chsub(chmul(w[2], dpi[0]), chmul(w[0], dpi[2])),
               chsub(chmul(w[0], dpi[1]), chmul(w[1], dpi[0]))]
        g.append(chsum([chmul(col[k], err[k]) for k in range(3)]))
    bg_q = [_barrier_grad(q[i], float(jlo[i]), float(jhi[i])) for i in range(nq)]
    bg_qd = [_barrier_grad(qd[i], float(vlo[i]), float(vhi[i])) for i in range(nq)]
    Q_ch = [[None] * nx for _ in range(nx)]
    for i in range(nq):
        for j in range(nq):
            Q_ch[i][j] = (cp.N_cost * _vec1(chmul(g[i], g[j]), like)
                          + cp.q_lim_cost * (bg_q[i] * bg_q[j]))
        Q_ch[nq + i][nq + i] = cp.qd_cost + cp.vel_lim_cost * bg_qd[i] * bg_qd[i]
    qv = ([cp.N_cost * _vec1(g[i], like) + cp.q_lim_cost * bg_q[i]
           for i in range(nq)]
          + [cp.qd_cost * qd[i] + cp.vel_lim_cost * bg_qd[i] for i in range(nq)])
    return Q_ch, qv


def setup_kkt_batched(model: RobotModel, cp: CostParams, X, U, x_s, ref,
                      f_ext, dt, integrator_type: int = 2) -> KKTSystem:
    """Batched KKT setup: X (B,N,nx), U (B,N-1,nu) -> KKTSystem with (B, ...)
    leading axes."""
    from ..dynamics.codegen import kkt_program, run_on_channels

    cd = _get_cd(model.key)
    nq = cd.nq
    nx = 2 * nq
    B, N = X.shape[0], X.shape[1]
    M = B * (N - 1)

    xk = X[:, :-1].reshape(M, nx)
    xnm = X[:, 1:].reshape(M, nx)
    uk = U.reshape(M, nq)
    r3m = ref[:, :-1, :3].reshape(M, 3)
    fe_arr = f_ext[:, None, :].expand(B, N - 1, 6).reshape(M, 6)
    q = [xk[:, i] for i in range(nq)]
    inputs = (q, [xk[:, nq + i] for i in range(nq)], [uk[:, i] for i in range(nq)],
              [xnm[:, i] for i in range(nx)], [r3m[:, i] for i in range(3)],
              [fe_arr[:, i] for i in range(6)])
    # the trace's straight-line program, equal to kkt_knot_channels_structured
    # bit for bit (dynamics/codegen.py::kkt_program)
    channels = run_on_channels(kkt_program(model.key, astuple(cp), float(dt), integrator_type),
                               inputs)
    return assemble_kkt(model, cp, channels, q[0], X, x_s, ref)


def assemble_kkt(model, cp, channels, like, X, x_s, ref) -> KKTSystem:
    """Build the KKTSystem from the non-terminal knots' structured channels
    (on B*(N-1) work items) plus the terminal knot's channels on (B,)."""
    cd = _get_cd(model.key)
    nq = cd.nq
    B, N = X.shape[0], X.shape[1]
    A_ch, B_ch, c_ch, Q_ch, qv, R_diag, rv = channels

    def knots(t):
        return t.reshape(B, N - 1, *t.shape[1:])

    A = knots(_mat(A_ch, like))
    Bm = knots(_mat(B_ch, like))
    c_knots = knots(_vec(c_ch, like))
    Q = knots(_mat(Q_ch, like))
    qk = knots(_vec(qv, like))
    R = torch.diag_embed(knots(_vec(R_diag, like)))
    r = knots(_vec(rv, like))

    xT = X[:, -1]
    qT = [xT[:, i] for i in range(nq)]
    QT_ch, qvT_ch = terminal_cost_channels(
        cd, model.key, cp, qT, [xT[:, nq + i] for i in range(nq)],
        [ref[:, -1, k] for k in range(3)], qT[0])
    QT = _mat(QT_ch, qT[0])
    qvT = _vec(qvT_ch, qT[0])

    c = torch.cat([(X[:, 0] - x_s)[:, None], c_knots], 1)
    return KKTSystem(Q=torch.cat([Q, QT[:, None]], 1),
                     q=torch.cat([qk, qvT[:, None]], 1),
                     R=R, r=r, A=A, B=Bm, c=c)
