"""Channelized rigid-body dynamics: scalar-channel codegen via Python tracing.

Port of gato_tpu/dynamics/channelized.py. The trace is unchanged apart from
the two square roots, which go through `mathshim` so that the same code runs
on torch tensors (the plain PyTorch path) and on symbolic channels
(`dynamics/codegen.py`, which emits the CUDA C++ device functions).

This is the true analogue of the reference's GRiD code generation
(indy7_grid.cuh / iiwa14_grid.cuh): the robot's constants are baked into the
traced program as Python floats, structural zeros/ones are folded away at
trace time (GRiD's generated code gets the same effect from its code
generator), and every remaining operation is an elementwise op on a "channel"
— an arbitrary-shaped batch tensor. Channels can be torch tensors of any shape
(e.g. the flat work-item axis of a batched solve) or symbolic scalars that
emit C++ (dynamics/codegen.py): the same traced algorithm serves both.

A channel value is one of:
  None          — structural zero (skipped entirely),
  python float  — compile-time constant (folded),
  tensor/symbol — runtime data.
"""

from __future__ import annotations

from ..robots.urdf import ParsedRobot
from . import mathshim

_SNAP_TOL = 1e-9  # model constants within this of {0, +-1} are snapped,
# exactly as codegen would emit clean rotation entries for multiples of pi/2.


def _is_const(x):
    return isinstance(x, (int, float))


class Dual:
    """Forward-mode dual channel with SPARSE tangents: {direction: channel}.

    Structural sparsity (most tangents start empty and fill only through the
    kinematic chain) is what makes trace-time forward-mode competitive with
    hand-derived gradients — the same effect GRiD gets from generating its
    inverse_dynamics_gradient_inner code."""

    __slots__ = ("p", "t")

    def __init__(self, p, t=None):
        self.p = p
        self.t = t if t is not None else {}


def _is_dual(x):
    return isinstance(x, Dual)


def chmul(a, b):
    if _is_dual(a) or _is_dual(b):
        if not _is_dual(a):
            a = Dual(a)
        if not _is_dual(b):
            b = Dual(b)
        p = chmul(a.p, b.p)
        if p is None:
            # primal zero does not kill tangents unless the factor is a
            # structural zero overall
            pass
        t = {}
        for k, tb in b.t.items():
            t[k] = chmul(a.p, tb)
        for k, ta in a.t.items():
            t[k] = chadd(t.get(k), chmul(ta, b.p))
        t = {k: v for k, v in t.items() if v is not None}
        if p is None and not t:
            return None
        return Dual(p, t)
    return _chmul_plain(a, b)


def _chmul_plain(a, b):
    if a is None or b is None:
        return None
    if _is_const(a) and _is_const(b):
        return a * b
    if _is_const(a):
        if a == 0.0:
            return None
        if a == 1.0:
            return b
        if a == -1.0:
            return -b
        return a * b
    if _is_const(b):
        return chmul(b, a)
    return a * b


def chadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if _is_dual(a) or _is_dual(b):
        if not _is_dual(a):
            a = Dual(a)
        if not _is_dual(b):
            b = Dual(b)
        t = dict(a.t)
        for k, tb in b.t.items():
            t[k] = chadd(t.get(k), tb)
        return Dual(chadd(a.p, b.p), t)
    return a + b


def chsub(a, b):
    return chadd(a, chneg(b))


def chneg(a):
    if a is None:
        return None
    if _is_dual(a):
        return Dual(chneg(a.p), {k: chneg(v) for k, v in a.t.items()})
    return -a


def chsum(terms):
    out = None
    for t in terms:
        out = chadd(out, t)
    return out


def chdot(a, b):
    return chsum([chmul(x, y) for x, y in zip(a, b)])


def cross_ch(a, b):
    return [
        chsub(chmul(a[1], b[2]), chmul(a[2], b[1])),
        chsub(chmul(a[2], b[0]), chmul(a[0], b[2])),
        chsub(chmul(a[0], b[1]), chmul(a[1], b[0])),
    ]


def mat_vec(A, v):
    """A: 3x3 channel matrix (list of rows), v: 3 channels."""
    return [chdot(A[i], v) for i in range(3)]


def ch_chol_factor_n(M, n):
    """Unrolled Cholesky of an n x n SPD channel matrix (list of rows).
    Returns (L rows, inv_diag channels). Generic-n version of
    ChannelizedDynamics.chol_factor."""
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        d = chsub(M[j][j], chsum([chmul(L[j][k], L[j][k]) for k in range(j)]))
        Ld = mathshim.sqrt(d)
        L[j][j] = Ld
        inv_d[j] = 1.0 / Ld
        for i2 in range(j + 1, n):
            s = chsub(M[i2][j],
                      chsum([chmul(L[i2][k], L[j][k]) for k in range(j)]))
            L[i2][j] = chmul(s, inv_d[j])
    return L, inv_d


def ch_chol_solve_n(L, inv_d, b, n):
    """Solve A x = b from ch_chol_factor_n channels; b: n channels."""
    y = [None] * n
    for i2 in range(n):
        s = chsub(b[i2], chsum([chmul(L[i2][k], y[k]) for k in range(i2)]))
        y[i2] = chmul(s, inv_d[i2])
    x = [None] * n
    for i2 in reversed(range(n)):
        s = chsub(y[i2],
                  chsum([chmul(L[k][i2], x[k]) for k in range(i2 + 1, n)]))
        x[i2] = chmul(s, inv_d[i2])
    return x


def ch_chol_inv_n(M, n):
    """SPD inverse of an n x n channel matrix: n unit-column solves (the
    structural sparsity of e_c folds roughly half the substitution work)."""
    L, inv_d = ch_chol_factor_n(M, n)
    cols = [ch_chol_solve_n(L, inv_d,
                            [1.0 if r == c else None for r in range(n)], n)
            for c in range(n)]
    # cols[c][r] = (M^-1)[r][c]; return as rows
    return [[cols[c][r] for c in range(n)] for r in range(n)]


def mat_T_vec(A, v):
    return [chdot([A[0][i], A[1][i], A[2][i]], v) for i in range(3)]


def mat_mul(A, B):
    return [[chsum([chmul(A[i][k], B[k][j]) for k in range(3)])
             for j in range(3)] for i in range(3)]


def mat_T(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def _snap(x):
    for v in (0.0, 1.0, -1.0):
        if abs(x - v) < _SNAP_TOL:
            return v
    return float(x)


class ChannelizedDynamics:
    """Trace-time-specialized dynamics for one robot (GRiD-codegen analogue)."""

    def __init__(self, robot: ParsedRobot, gravity: float = 9.81):
        self.nq = robot.nq
        self.R_tree = [[[_snap(robot.R_tree[i][r][c]) for c in range(3)]
                        for r in range(3)] for i in range(self.nq)]
        self.p_tree = [[_snap(v) for v in robot.p_tree[i]] for i in range(self.nq)]
        self.axis = [[_snap(v) for v in robot.axis[i]] for i in range(self.nq)]
        self.inertia = [[[_snap(robot.inertia[i][r][c]) for c in range(6)]
                         for r in range(6)] for i in range(self.nq)]
        self.gravity = float(gravity)

    # ---- kinematics ----

    def joint_E(self, i, ci, si):
        """E_i = (R_tree_i @ R_axis(q_i))^T from cos/sin channels."""
        k = self.axis[i]
        C = chsub(1.0, ci)
        Rj = [
            [chadd(ci, chmul(chmul(k[0], k[0]), C)),
             chsub(chmul(chmul(k[0], k[1]), C), chmul(k[2], si)),
             chadd(chmul(chmul(k[0], k[2]), C), chmul(k[1], si))],
            [chadd(chmul(chmul(k[1], k[0]), C), chmul(k[2], si)),
             chadd(ci, chmul(chmul(k[1], k[1]), C)),
             chsub(chmul(chmul(k[1], k[2]), C), chmul(k[0], si))],
            [chsub(chmul(chmul(k[2], k[0]), C), chmul(k[1], si)),
             chadd(chmul(chmul(k[2], k[1]), C), chmul(k[0], si)),
             chadd(ci, chmul(chmul(k[2], k[2]), C))],
        ]
        RL = mat_mul(self.R_tree[i], Rj)
        return mat_T(RL), RL

    def fk_ee(self, cs, ss):
        """World EE xyz from per-joint cos/sin channels. Returns (p_ee (3),
        Rw_all, pw_all) for reuse."""
        Rw = [[1.0, None, None], [None, 1.0, None], [None, None, 1.0]]
        pw = [None, None, None]
        Rws, pws = [], []
        for i in range(self.nq):
            _, RL = self.joint_E(i, cs[i], ss[i])
            pw = [chadd(pw[r], chdot(Rw[r], self.p_tree[i])) for r in range(3)]
            Rw = mat_mul(Rw, RL)
            Rws.append(Rw)
            pws.append(pw)
        return pws[-1], Rws, pws

    # ---- spatial helpers on (w3, v3) channel pairs ----

    def _xm(self, E, r, w, v):
        """Motion transform: (E w, E (v - r x w)) with constant r."""
        rxw = cross_ch(r, w)
        t = [chsub(v[k], rxw[k]) for k in range(3)]
        return mat_vec(E, w), mat_vec(E, t)

    def _xfT(self, E, r, n, f):
        """Force to parent: (E^T n + r x E^T f, E^T f)."""
        Etf = mat_T_vec(E, f)
        Etn = mat_T_vec(E, n)
        rx = cross_ch(r, Etf)
        return [chadd(Etn[k], rx[k]) for k in range(3)], Etf

    def _imul(self, i, w, v):
        I = self.inertia[i]
        out = [chsum([chmul(I[r][c], w[c]) for c in range(3)]
                     + [chmul(I[r][c + 3], v[c]) for c in range(3)])
               for r in range(6)]
        return out[:3], out[3:]

    # ---- algorithms ----

    def rnea(self, cs, ss, qd, qdd, f_ext=None, gravity=True):
        """Inverse dynamics from cos/sin channels; qd/qdd lists of channels.
        f_ext: optional 6 channels [n; f] in the EE frame."""
        nq = self.nq
        Es = []
        vw = [None, None, None]
        vv = [None, None, None]
        aw = [None, None, None]
        av = [None, None, self.gravity if gravity else None]
        fns, fvs = [], []
        for i in range(nq):
            E, _ = self.joint_E(i, cs[i], ss[i])
            Es.append(E)
            r = self.p_tree[i]
            vw, vv = self._xm(E, r, vw, vv)
            aw, av = self._xm(E, r, aw, av)
            S = self.axis[i]
            vJ = [chmul(S[k], qd[i]) for k in range(3)]
            vw = [chadd(vw[k], vJ[k]) for k in range(3)]
            # a += S qdd + v x vJ  (motion cross of (vw, vv) with (vJ, 0))
            cw = cross_ch(vw, vJ)
            cv = cross_ch(vv, vJ)
            aw = [chadd(chadd(aw[k], chmul(S[k], qdd[i])), cw[k]) for k in range(3)]
            av = [chadd(av[k], cv[k]) for k in range(3)]
            Iw, Iv = self._imul(i, aw, av)
            Jw, Jv = self._imul(i, vw, vv)
            # f = I a + v x* (I v): [w x n + vl x fl ; w x fl]
            n1 = cross_ch(vw, Jw)
            n2 = cross_ch(vv, Jv)
            fl = cross_ch(vw, Jv)
            fns.append([chadd(chadd(Iw[k], n1[k]), n2[k]) for k in range(3)])
            fvs.append([chadd(Iv[k], fl[k]) for k in range(3)])
        if f_ext is not None:
            fns[-1] = [chsub(fns[-1][k], f_ext[k]) for k in range(3)]
            fvs[-1] = [chsub(fvs[-1][k], f_ext[k + 3]) for k in range(3)]
        tau = [None] * nq
        fn, fv = fns[-1], fvs[-1]
        for i in reversed(range(nq)):
            if i < nq - 1:
                fn = [chadd(fns[i][k], fn[k]) for k in range(3)]
                fv = [chadd(fvs[i][k], fv[k]) for k in range(3)]
            tau[i] = chdot(self.axis[i], fn)
            if i > 0:
                fn, fv = self._xfT(Es[i], self.p_tree[i], fn, fv)
        return tau

    def crba(self, cs, ss):
        """Mass matrix channels M[i][j] (upper stored, symmetric)."""
        nq = self.nq
        Es = [self.joint_E(i, cs[i], ss[i])[0] for i in range(nq)]
        # composite inertias as 6x6 channel matrices
        Ic = [[[self.inertia[i][r][c] for c in range(6)] for r in range(6)]
              for i in range(nq)]
        M = [[None] * nq for _ in range(nq)]
        for i in reversed(range(nq)):
            if i > 0:
                # X = [[E, 0], [-E sk(r), E]]; Ic[i-1] += X^T Ic X
                E = Es[i]
                r = self.p_tree[i]
                sk = [[None, -r[2] if r[2] else None, r[1] if r[1] else None],
                      [r[2] if r[2] else None, None, -r[0] if r[0] else None],
                      [-r[1] if r[1] else None, r[0] if r[0] else None, None]]
                Esk = [[chneg(chsum([chmul(E[a][t], sk[t][b]) for t in range(3)]))
                        for b in range(3)] for a in range(3)]
                X = [[None] * 6 for _ in range(6)]
                for a in range(3):
                    for b in range(3):
                        X[a][b] = E[a][b]
                        X[3 + a][3 + b] = E[a][b]
                        X[3 + a][b] = Esk[a][b]
                T1 = [[chsum([chmul(Ic[i][a][t], X[t][b]) for t in range(6)])
                       for b in range(6)] for a in range(6)]
                for a in range(6):
                    for b in range(6):
                        Ic[i - 1][a][b] = chadd(
                            Ic[i - 1][a][b],
                            chsum([chmul(X[t][a], T1[t][b]) for t in range(6)]),
                        )
            S = self.axis[i]
            F = [chsum([chmul(Ic[i][r][c], S[c]) for c in range(3)])
                 for r in range(6)]
            M[i][i] = chsum([chmul(S[k], F[k]) for k in range(3)])
            j = i
            Fn, Fv = F[:3], F[3:]
            while j > 0:
                Fn, Fv = self._xfT(Es[j], self.p_tree[j], Fn, Fv)
                j -= 1
                M[i][j] = chdot(self.axis[j], Fn)
                M[j][i] = M[i][j]
        return M

    def chol_factor(self, M):
        """Unrolled Cholesky of a channel matrix; returns (L, inv_diag)."""
        n = self.nq
        L = [[None] * n for _ in range(n)]
        inv_d = [None] * n
        for j in range(n):
            d = chsub(M[j][j], chsum([chmul(L[j][k], L[j][k]) for k in range(j)]))
            Ld = mathshim.sqrt(d)
            L[j][j] = Ld
            inv_d[j] = 1.0 / Ld
            for i2 in range(j + 1, n):
                s = chsub(M[i2][j],
                          chsum([chmul(L[i2][k], L[j][k]) for k in range(j)]))
                L[i2][j] = chmul(s, inv_d[j])
        return L, inv_d

    def chol_solve_factored(self, L, inv_d, b):
        n = self.nq
        y = [None] * n
        for i2 in range(n):
            s = chsub(b[i2], chsum([chmul(L[i2][k], y[k]) for k in range(i2)]))
            y[i2] = chmul(s, inv_d[i2])
        x = [None] * n
        for i2 in reversed(range(n)):
            s = chsub(y[i2],
                      chsum([chmul(L[k][i2], x[k]) for k in range(i2 + 1, n)]))
            x[i2] = chmul(s, inv_d[i2])
        return x

    def chol_solve(self, M, b):
        """Solve M x = b via unrolled Cholesky."""
        L, inv_d = self.chol_factor(M)
        return self.chol_solve_factored(L, inv_d, b)

    def fd(self, cs, ss, qd, tau, f_ext=None):
        """Forward dynamics channels: qdd = M^-1 (tau - bias)."""
        zero = [None] * self.nq
        bias = self.rnea(cs, ss, qd, zero, f_ext=f_ext)
        M = self.crba(cs, ss)
        rhs = [chsub(tau[i], bias[i]) for i in range(self.nq)]
        return self.chol_solve(M, rhs)
