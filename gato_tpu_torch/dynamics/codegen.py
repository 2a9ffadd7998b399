"""Per-robot CUDA C++ code generation from the channel trace (the GRiD role).

The same trace that the plain PyTorch path runs on tensors
(dynamics/channelized.py, ops/kkt_fast.py, ops/merit_fast.py) runs here on
symbolic channels. Every op appends one SSA line (`const T t123 = t45 *
t67;`); Python floats (the folded robot constants) become literals and
structural `None` zeros vanish, exactly as they vanish from the tensor
trace. Identical lines are emitted once and lines no output needs are
dropped. The result is a header of straight-line
`template <typename T> GATO_HD` functions, one per traced function:

  fd(q, qd, u, fe) -> qdd                         (channelized fd)
  knot_kkt(q, qd, u, xn, r3, fe, dt, w_track, w)  (kkt_knot_channels_structured)
      -> A, B, c, Q, qv, R_diag, rv
  knot_merit(q, qd, u, xn, r3, fe, dt, w_track, w) (merit_fast._knot_parts)
      -> cost, ucost, defect

fd once more in parts, for a kernel that shares one plant among the lanes
of two warps (csrc/rk4.cu):

  fd_bias(q, qd, fe) -> bias                      (the RNEA at qdd = 0)
  fd_crba(q) -> M                                 (CRBA, lower triangle)
  fd_solve(M, u, bias) -> qdd                     (the unrolled Cholesky)

and, for a robot with a staged split (KKT_SPLITS: indy7), knot_kkt once
more in stages, for kernels that share a knot among threads (csrc/kkt.cu,
phase A of csrc/sqp_iter.cuh); its header defines GATO_KKT_STAGES:

  knot_dyn(q, qd, u, fe) -> qdd, Minv             (fd_primal_channels)
  knot_cost(q, qd, u, r3, w_track, w) -> Q, qv, R_diag, rv   (cost_channels)
  knot_dual<G, P>(q, qd, qdd, fe) -> dID columns of part P   (dual_id_columns)
  knot_ab<G, P>(Minv, dID, dt) -> A columns of part P, B columns c = P mod G
  knot_defect(q, qd, xn, qdd, dt) -> c                       (defect_channels)

The dual RNEA's 2 NQ tangent directions are split into G parts (G in
KKT_SPLITS), balanced by each part's rendered lines (greedy, largest
direction first); the split is written into the header as constexpr tables
(KKT_DIRS_G<G>, each part's line count in a comment). Composed, the stages
compute knot_kkt's outputs with knot_kkt's own expressions.

Above each function the header states its operations and its dependency
depth (the longest chain of operations from its inputs), which
`header_stats` reads back and `main` prints. A binary + - * / and a math
call count as one operation; a negation counts as none, since it compiles
into its user's operand.

A plant whose constants are registered at run time rather than read from
a committed URDF (api/mpc.py::add_pendulum's pendulum-augmented plants)
gets a header of its own at first use, `generate_plant`: NQ, NX, fd and
fd's three parts, which is all csrc/rk4.cu calls, in a namespace named by
`plant_slug` (the plant's name and a hash of its constants). _build.py
writes it under the build directory, never into csrc/generated/.

The cost weights `w` (CostParams order), dt and the tracking weight are
runtime arguments; only the robot constants and limits are folded.
`GATO_HD` is `__host__ __device__` under nvcc and empty otherwise, so the
header also compiles as host C++ (tests/test_torch_codegen.py).

    python -m gato_tpu_torch.dynamics.codegen      # rewrites csrc/generated/
"""

from __future__ import annotations

import functools
import hashlib
import os
import re

import numpy as np
import torch

from ..ops.cost import CostParams
from ..ops.kkt_fast import (ab_channels, cost_channels, defect_channels,
                             dqdd_channels, dual_id_columns,
                             fd_primal_channels, kkt_knot_channels_structured)
from ..ops.merit_fast import _get_cd, _knot_parts
from ..robots.model import get_parsed, load_robot
from . import mathshim as ms
from .channelized import chsub

GENERATED_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "generated")

# robots whose header is generated and committed
ROBOTS = ("indy7", "iiwa14")
# each robot's part counts G of the staged KKT's split of the tangent
# directions: indy7's for csrc/kkt.cu's KKT_GROUPS = 2 and the staged phase
# A's 4 groups (sqp_iter.cuh). iiwa14 has none: it takes neither kkt.cu nor
# the staged phase A (written for 12 rows in 4 groups), so its header holds
# only what bsqp_iter's one-thread phase A and rk4 call (fd, knot_kkt,
# knot_merit, fd_bias, fd_crba, fd_solve)
KKT_SPLITS = {"indy7": (2, 4), "iiwa14": ()}

_FUNCS = {"sqrt": "gsqrt", "sin": "gsin", "cos": "gcos", "log": "glog",
          "abs": "gabs", "max": "gmax"}


def _lit(x) -> str:
    x = float(x)
    s = repr(x)
    if "e" not in s and "." not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return f"T({s})"


class Sym:
    """A symbolic channel: the name of one SSA value in an Emitter."""

    __slots__ = ("em", "name")

    def __init__(self, em, name):
        self.em = em
        self.name = name

    def _bin(self, op, other, rev):
        a, b = (other, self) if rev else (self, other)
        return self.em.binop(op, a, b)

    def __add__(self, o):
        return self._bin("+", o, False)

    def __radd__(self, o):
        return self._bin("+", o, True)

    def __sub__(self, o):
        return self._bin("-", o, False)

    def __rsub__(self, o):
        return self._bin("-", o, True)

    def __mul__(self, o):
        return self._bin("*", o, False)

    def __rmul__(self, o):
        return self._bin("*", o, True)

    def __truediv__(self, o):
        return self._bin("/", o, False)

    def __rtruediv__(self, o):
        return self._bin("/", o, True)

    def __neg__(self):
        return self.em.emit(f"-{self.name}", (self.name,))

    def apply(self, fn, *consts):
        args = ", ".join([self.name] + [_lit(c) for c in consts])
        return self.em.emit(f"{_FUNCS[fn]}({args})", (self.name,))


class Emitter:
    """SSA line recorder with hash-consing (identical expressions share one
    value) and dead-line elimination at render time."""

    def __init__(self):
        self.lines = []  # (name, expr, deps)
        self.by_expr = {}

    def emit(self, expr, deps):
        hit = self.by_expr.get(expr)
        if hit is not None:
            return hit
        s = Sym(self, f"t{len(self.lines)}")
        self.lines.append((s.name, expr, deps))
        self.by_expr[expr] = s
        return s

    def binop(self, op, a, b):
        def term(x):
            return x.name if isinstance(x, Sym) else _lit(x)

        deps = tuple(x.name for x in (a, b) if isinstance(x, Sym))
        return self.emit(f"{term(a)} {op} {term(b)}", deps)

    def live(self, channels):
        """Names of the lines that `channels` need."""
        need = {ch.name for ch in channels if isinstance(ch, Sym)}
        for name, _, deps in reversed(self.lines):
            if name in need:
                need.update(deps)
        return {name for name, _, _ in self.lines if name in need}

    def stats(self, channels):
        """(operations, dependency depth) of the lines that `channels`
        need: a binary + - * / or a math call is one operation, a negation
        none (it becomes an operand modifier of its user), and the depth is
        the longest chain of operations from the inputs."""
        need = self.live(channels)
        depth, ops = {}, 0
        for name, expr, deps in self.lines:
            if name in need:
                op = not expr.startswith("-")
                ops += op
                depth[name] = op + max((depth.get(d, 0) for d in deps), default=0)
        return ops, max(depth.values(), default=0)

    def render(self, outputs):
        """Body lines needed by `outputs` [(target, channel)], then the
        output stores (a structural zero stores 0)."""
        need = self.live([ch for _, ch in outputs])
        body = [f"  const T {name} = {expr};"
                for name, expr, _ in self.lines if name in need]
        for target, ch in outputs:
            if isinstance(ch, Sym):
                val = ch.name
            elif ch is None:
                val = "T(0)"
            else:
                val = _lit(ch)
            body.append(f"  {target} = {val};")
        return body


def _inputs(em, name, n):
    return [Sym(em, f"{name}[{i}]") for i in range(n)]


def _func(em, sig, outputs):
    """A generated function: (signature, body lines, (operations, depth))."""
    return sig, em.render(outputs), em.stats([ch for _, ch in outputs])


def _angles(em, nq):
    q = _inputs(em, "q", nq)
    return q, [ms.cos(x) for x in q], [ms.sin(x) for x in q]


def _weights(em):
    w = _inputs(em, "w", 7)
    return CostParams(*w)


def _gen_fd(cd, nq):
    em = Emitter()
    q, qd, u, fe = (_inputs(em, "q", nq), _inputs(em, "qd", nq),
                    _inputs(em, "u", nq), _inputs(em, "fe", 6))
    cs = [ms.cos(x) for x in q]
    ss = [ms.sin(x) for x in q]
    qdd = cd.fd(cs, ss, qd, u, f_ext=fe)
    sig = ("fd(const T* q, const T* qd, const T* u, const T* fe, T* qdd)")
    return _func(em, sig, [(f"qdd[{i}]", qdd[i]) for i in range(nq)])


def _sqrt(x):
    """torch's square root, also of a numpy channel or a numpy scalar
    (numpy's rounds some float32 values otherwise)."""
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.sqrt(torch.from_numpy(np.asarray(x))).numpy()[()]
    return torch.sqrt(x)


def _on_channel(fn):
    """A mathshim function of a channel as the straight-line programs call
    it: torch's, also on a numpy channel (through a tensor view of it)."""
    def g(x, *consts):
        if isinstance(x, np.ndarray):
            return fn(torch.from_numpy(x), *consts).numpy()
        return fn(x, *consts)
    return g


_PROGRAM_SCOPE = {"T": float, "gsqrt": _sqrt, "gsin": _on_channel(torch.sin),
                  "gcos": _on_channel(torch.cos), "glog": _on_channel(torch.log),
                  "gabs": _on_channel(torch.abs), "gmax": _on_channel(torch.clamp_min)}


def _straight_line(em, out, params, label):
    """The lines of `em` that the channels in `out` (lists and tuples of
    channels) need, in the order they were recorded, as one Python function
    of `params` that returns `out` with each channel's value (None a
    structural zero, a float a constant)."""
    def flat(x):
        return [c for y in x for c in flat(y)] if isinstance(x, (list, tuple)) else [x]

    def value(x):
        if isinstance(x, list):
            return "[" + ", ".join(value(y) for y in x) + "]"
        if isinstance(x, tuple):
            return "(" + "".join(value(y) + ", " for y in x) + ")"
        if isinstance(x, Sym):
            return x.name
        return "None" if x is None else repr(float(x))

    need = em.live(flat(out))
    body = [f"    {name} = {expr}" for name, expr, _ in em.lines if name in need]
    src = (f"def program({', '.join(params)}):\n" + "\n".join(body)
           + f"\n    return {value(out)}\n")
    scope = dict(_PROGRAM_SCOPE)
    exec(compile(src, f"<{label}>", "exec"), scope)
    return scope["program"]


@functools.lru_cache(maxsize=None)
def fd_program(key: str, with_fe: bool):
    """cd.fd of the plant registered under `key`, with a wrench or without,
    as one straight-line Python function fd(cs, ss, qd, u, fe) -> qdd on
    numpy or torch channels: the trace's lines (Python as they are, with T
    = float and the math calls torch's, _PROGRAM_SCOPE) in the order cd.fd runs
    them, so every value equals the traced call's bit for bit. The trace
    (its constant folding and the channel algebra's dispatch) runs once,
    not at every call."""
    cd = _get_cd(key)
    em = Emitter()
    cs, ss, qd, u = (_inputs(em, name, cd.nq) for name in ("cs", "ss", "qd", "u"))
    qdd = cd.fd(cs, ss, qd, u, f_ext=_inputs(em, "fe", 6) if with_fe else None)
    return _straight_line(em, qdd, ("cs", "ss", "qd", "u", "fe"), f"fd_program {key}")


_KNOT_PARAMS = ("q", "qd", "u", "xn", "r3", "fe")


def _knot_inputs(em, nq):
    """The symbolic (q, qd, u, xn, r3, fe) channel lists of a knot."""
    return [_inputs(em, name, n) for name, n in zip(_KNOT_PARAMS, (nq, nq, nq, 2 * nq, 3, 6))]


@functools.lru_cache(maxsize=None)
def kkt_program(key: str, weights: tuple, dt: float, integrator_type: int):
    """kkt_knot_channels_structured of the plant registered under `key`,
    with the cost weights (CostParams' fields in order) and dt folded as
    the trace folds them, as one straight-line Python function kkt(q, qd,
    u, xn, r3, fe) -> (A, B, c, Q, qv, R_diag, rv) on numpy or torch
    channels, each a channel list as the trace returns it: the trace's
    lines in the order the trace runs them, so every value equals the
    traced call's bit for bit, without the channel algebra's dispatch at
    every call."""
    cd = _get_cd(key)
    em = Emitter()
    out = kkt_knot_channels_structured(cd, key, CostParams(*weights), *_knot_inputs(em, cd.nq),
                                       dt, integrator_type, None)
    return _straight_line(em, out, _KNOT_PARAMS, f"kkt_program {key}")


@functools.lru_cache(maxsize=None)
def merit_program(key: str, weights: tuple, dt: float, integrator_type: int):
    """ops/merit_fast.py::_knot_parts of a non-terminal knot (tracking
    weight q_cost) as kkt_program is the KKT's: merit(q, qd, u, xn, r3, fe)
    -> (cost, ucost, defect), equal to the trace's bit for bit."""
    cd = _get_cd(key)
    em = Emitter()
    cp = CostParams(*weights)
    out = _knot_parts(cd, key, cp, *_knot_inputs(em, cd.nq), dt, integrator_type, cp.q_cost)
    return _straight_line(em, out, _KNOT_PARAMS, f"merit_program {key}")


def run_on_channels(program, inputs):
    """A straight-line program on lists of tensor channels: on the card on
    the tensors themselves, on the CPU on numpy views of them (the same
    operations on the same float type, so the values equal torch channels'
    bit for bit, without torch's cost a call on small columns) with the
    channels it returns handed back as tensors."""
    if inputs[0][0].device.type != "cpu":
        return program(*inputs)

    def back(ch):
        if isinstance(ch, (list, tuple)):
            return type(ch)(back(c) for c in ch)
        return torch.from_numpy(ch) if isinstance(ch, np.ndarray) else ch
    return back(program(*[[c.numpy() for c in part] for part in inputs]))


def _knot_args(em, nq):
    nx = 2 * nq
    return (_inputs(em, "q", nq), _inputs(em, "qd", nq), _inputs(em, "u", nq),
            _inputs(em, "xn", nx), _inputs(em, "r3", 3), _inputs(em, "fe", 6),
            Sym(em, "dt"), Sym(em, "w_track"), _weights(em))


_KNOT_SIG = ("const T* q, const T* qd, const T* u, const T* xn, const T* r3, "
             "const T* fe, T dt, T w_track, const T* w")


def _gen_knot_kkt(cd, key, nq):
    nx = 2 * nq
    em = Emitter()
    q, qd, u, xn, r3, fe, dt, w_track, cp = _knot_args(em, nq)
    A, Bm, c, Q, qv, Rd, rv = kkt_knot_channels_structured(
        cd, key, cp, q, qd, u, xn, r3, fe, dt, 2, None, w_track=w_track)
    outs = ([(f"A[{r * nx + k}]", A[r][k]) for r in range(nx) for k in range(nx)]
            + [(f"B[{r * nq + k}]", Bm[r][k]) for r in range(nx) for k in range(nq)]
            + [(f"c[{r}]", c[r]) for r in range(nx)]
            + [(f"Q[{r * nx + k}]", Q[r][k]) for r in range(nx) for k in range(nx)]
            + [(f"qv[{r}]", qv[r]) for r in range(nx)]
            + [(f"R_diag[{r}]", Rd[r]) for r in range(nq)]
            + [(f"rv[{r}]", rv[r]) for r in range(nq)])
    sig = (f"knot_kkt({_KNOT_SIG}, O A, O B, O c, O Q, O qv, O R_diag, O rv)")
    return _func(em, sig, outs)


def _gen_knot_merit(cd, key, nq):
    em = Emitter()
    q, qd, u, xn, r3, fe, dt, w_track, cp = _knot_args(em, nq)
    cost, ucost, defect = _knot_parts(cd, key, cp, q, qd, u, xn, r3, fe, dt,
                                      2, w_track)
    sig = f"knot_merit({_KNOT_SIG}, O out)"
    return _func(em, sig, [("out[0]", cost), ("out[1]", ucost), ("out[2]", defect)])


def _gen_knot_dyn(cd, nq):
    em = Emitter()
    q, qd, u, fe = (_inputs(em, "q", nq), _inputs(em, "qd", nq),
                    _inputs(em, "u", nq), _inputs(em, "fe", 6))
    qdd, Minv = fd_primal_channels(cd, [ms.cos(x) for x in q],
                                   [ms.sin(x) for x in q], qd, u, fe)
    sig = "knot_dyn(const T* q, const T* qd, const T* u, const T* fe, O qdd, O Minv)"
    return _func(em, sig, [(f"qdd[{i}]", qdd[i]) for i in range(nq)]
                          + [(f"Minv[{c * nq + r}]", Minv[c][r])
                             for c in range(nq) for r in range(nq)])


def _gen_knot_cost(cd, key, nq):
    em = Emitter()
    q, qd, u, r3 = (_inputs(em, "q", nq), _inputs(em, "qd", nq),
                    _inputs(em, "u", nq), _inputs(em, "r3", 3))
    cs = [ms.cos(x) for x in q]
    ss = [ms.sin(x) for x in q]
    Q, qv, Rd, rv = cost_channels(cd, key, _weights(em), q, qd, u, r3,
                                  cd.fk_ee(cs, ss), Sym(em, "w_track"), None)
    nx = 2 * nq
    sig = ("knot_cost(const T* q, const T* qd, const T* u, const T* r3, "
           "T w_track, const T* w, O Q, O qv, O R_diag, O rv)")
    return _func(em, sig, [(f"Q[{r * nx + k}]", Q[r][k]) for r in range(nx) for k in range(nx)]
                          + [(f"qv[{r}]", qv[r]) for r in range(nx)]
                          + [(f"R_diag[{r}]", Rd[r]) for r in range(nq)]
                          + [(f"rv[{r}]", rv[r]) for r in range(nq)])


def _gen_knot_defect(nq):
    em = Emitter()
    q, qd, xn, qdd = (_inputs(em, "q", nq), _inputs(em, "qd", nq),
                      _inputs(em, "xn", 2 * nq), _inputs(em, "qdd", nq))
    c = defect_channels(q, qd, xn, qdd, Sym(em, "dt"), 2, None)
    sig = ("knot_defect(const T* q, const T* qd, const T* xn, const T* qdd, "
           "T dt, O c)")
    return _func(em, sig, [(f"c[{r}]", c[r]) for r in range(2 * nq)])


def _gen_fd_bias(cd, nq):
    """fd's RNEA bias (qdd = 0, gravity, the wrench): M qdd = u - bias."""
    em = Emitter()
    q, cs, ss = _angles(em, nq)
    qd, fe = _inputs(em, "qd", nq), _inputs(em, "fe", 6)
    bias = cd.rnea(cs, ss, qd, [None] * nq, f_ext=fe)
    return _func(em, "fd_bias(const T* q, const T* qd, const T* fe, O bias)",
                 [(f"bias[{i}]", bias[i]) for i in range(nq)])


def _gen_fd_crba(cd, nq):
    """fd's mass matrix by CRBA, as fd computes it: its lower triangle
    column-major, M[c * NQ + r] for r >= c (fd_solve's layout)."""
    em = Emitter()
    _, cs, ss = _angles(em, nq)
    M = cd.crba(cs, ss)
    return _func(em, "fd_crba(const T* q, O M)",
                 [(f"M[{c * nq + r}]", M[r][c]) for c in range(nq) for r in range(c, nq)])


def _gen_fd_solve(cd, nq):
    """fd's last step, qdd = M^-1 (u - bias) by the unrolled Cholesky, from
    M's lower triangle column-major (M[c * NQ + r], r >= c)."""
    em = Emitter()
    M = [[Sym(em, f"M[{min(r, c) * nq + max(r, c)}]") for c in range(nq)]
         for r in range(nq)]
    u, bias = _inputs(em, "u", nq), _inputs(em, "bias", nq)
    qdd = cd.chol_solve(M, [chsub(u[i], bias[i]) for i in range(nq)])
    return _func(em, "fd_solve(const T* M, const T* u, const T* bias, O qdd)",
                 [(f"qdd[{i}]", qdd[i]) for i in range(nq)])


def _dual_trace(cd, nq):
    """One trace of the dual RNEA with qdd an input: (emitter, cols[z][j])."""
    em = Emitter()
    q, qd, qdd, fe = (_inputs(em, "q", nq), _inputs(em, "qd", nq),
                      _inputs(em, "qdd", nq), _inputs(em, "fe", 6))
    cols = dual_id_columns(cd, [ms.cos(x) for x in q], [ms.sin(x) for x in q],
                           qd, qdd, fe)
    return em, cols


def split_directions(em, cols, groups):
    """The 2 NQ tangent directions in `groups` parts: greedy, the direction
    with the most rendered lines first, each to the part with the fewest
    lines so far (a part's lines counted as rendered, shared lines once).
    Returns (parts: sorted direction lists, lines per part)."""
    def lines(dirs):
        return len(em.live([ch for z in dirs for ch in cols[z]]))

    single = [lines([z]) for z in range(len(cols))]
    parts, sizes = [[] for _ in range(groups)], [0] * groups
    for z in sorted(range(len(cols)), key=lambda z: (-single[z], z)):
        p = min(range(groups), key=lambda p: (sizes[p], p))
        parts[p].append(z)
        sizes[p] = lines(parts[p])
    return [sorted(p) for p in parts], sizes


def _gen_knot_dual(em, cols, dirs, nq, name):
    nx = 2 * nq
    sig = (f"{name}(const T* q, const T* qd, const T* qdd, const T* fe, O dID)")
    return _func(em, sig, [(f"dID[{j * nx + z}]", cols[z][j])
                           for z in dirs for j in range(nq)])


def _gen_knot_ab(cols, dirs, bcols, nq, name):
    """A's columns `dirs` and B's columns `bcols` from Minv and dID, the
    structural zeros of dID folded as in knot_kkt."""
    nx = 2 * nq
    em = Emitter()
    Minv = [[Sym(em, f"Minv[{c * nq + r}]") for r in range(nq)] for c in range(nq)]
    dID = [[None if cols[z][j] is None else Sym(em, f"dID[{j * nx + z}]")
            for j in range(nq)] for z in range(nx)]
    A, Bm = ab_channels(dqdd_channels(Minv, dID, nq), Minv, Sym(em, "dt"), 2, nq)
    sig = f"{name}(const T* Minv, const T* dID, T dt, O A, O B)"
    return _func(em, sig, [(f"A[{r * nx + z}]", A[r][z]) for r in range(nx) for z in dirs]
                          + [(f"B[{r * nq + c}]", Bm[r][c]) for r in range(nx)
                             for c in bcols])


def _dispatch(name, args, params, groups_parts):
    """template <int G, int P, ...> name(...): the part function of (G, P)."""
    lines = ["template <int G, int P, typename T, typename O>",
             f"GATO_HD inline void {name}({params}) {{"]
    kw = "if"
    for g, p in groups_parts:
        lines.append(f"  {kw} constexpr (G == {g} && P == {p}) "
                     f"{name}_g{g}_p{p}<T, O>({args});")
        kw = "else if"
    lines += ["  else static_assert(G < 0, \"no such split of the tangent directions\");",
              "}"]
    return lines


def generate(robot: str) -> str:
    """The header text for one robot (trapezoidal integrator, the default
    and the only one the CUDA kernels take)."""
    model = load_robot(robot, torch.float64, device="cpu")
    cd = _get_cd(model.key)
    nq = cd.nq
    splits = KKT_SPLITS[robot]
    parts = [
        f"// Generated by `python -m gato_tpu_torch.dynamics.codegen` from the "
        f"{robot} URDF. Do not edit.",
        "// Straight-line forward dynamics, per-knot KKT blocks"
        + (" (whole, and in stages)" if splits else "") + " and per-knot merit terms,",
        "// traced from gato_tpu_torch/ops/{kkt_fast,merit_fast}.py with the "
        "robot constants folded.",
        "// Weights w: q_cost, qd_cost, u_cost, N_cost, q_lim_cost, "
        "vel_lim_cost, ctrl_lim_cost.",
        "// Matrices are row-major: A (nx, nx), B (nx, nu), Q (nx, nx).",
        "// Outputs of type O are anything indexable as O[i] = T: a T* or a "
        "strided accessor.",
        "#pragma once",
        '#include "../gato_math.cuh"',
    ]
    if splits:
        parts += ["// knot_dyn, knot_cost, knot_defect, knot_dual<G, P>, knot_ab<G, P> below",
                  "#define GATO_KKT_STAGES 1"]
    parts += [
        "",
        f"namespace gato {{ namespace {robot} {{",
        "",
        f"constexpr int NQ = {nq};",
        f"constexpr int NX = {2 * nq};",
    ]
    funcs = [_gen_fd(cd, nq), _gen_knot_kkt(cd, model.key, nq),
             _gen_knot_merit(cd, model.key, nq)]
    if splits:
        funcs += [_gen_knot_dyn(cd, nq), _gen_knot_cost(cd, model.key, nq),
                  _gen_knot_defect(nq)]
    funcs += [_gen_fd_bias(cd, nq), _gen_fd_crba(cd, nq), _gen_fd_solve(cd, nq)]
    groups_parts = []
    if splits:
        em, cols = _dual_trace(cd, nq)
        parts += [
            "",
            "// The staged KKT's split of the dual RNEA's tangent directions: part P of",
            "// G holds directions KKT_DIRS_G<G>[P] (z < NQ: q_z; z >= NQ: qd_{z - NQ};",
            "// -1 pads), knot_dual<G, P> computes their dID columns, knot_ab<G, P>",
            "// their A columns and B's columns c = P mod G."]
    for g in splits:
        parts_g, sizes = split_directions(em, cols, g)
        rows = ", ".join("{" + ", ".join(map(str, d + [-1] * (2 * nq - len(d)))) + "}"
                         for d in parts_g)
        parts += [f"// G = {g}: knot_dual's parts run {', '.join(map(str, sizes))} lines.",
                  f"constexpr int KKT_DIRS_G{g}[{g}][NX] = {{{rows}}};"]
        for p, dirs in enumerate(parts_g):
            funcs.append(_gen_knot_dual(em, cols, dirs, nq, f"knot_dual_g{g}_p{p}"))
            funcs.append(_gen_knot_ab(cols, dirs, [c for c in range(nq) if c % g == p],
                                      nq, f"knot_ab_g{g}_p{p}"))
            groups_parts.append((g, p))
    parts += _render(funcs)
    if groups_parts:
        parts += [""] + _dispatch(
            "knot_dual", "q, qd, qdd, fe, dID",
            "const T* q, const T* qd, const T* qdd, const T* fe, O dID", groups_parts)
        parts += [""] + _dispatch(
            "knot_ab", "Minv, dID, dt, A, B",
            "const T* Minv, const T* dID, T dt, O A, O B", groups_parts)
    parts += ["", f"}}}}  // namespace gato::{robot}", ""]
    return "\n".join(parts)


def _render(funcs):
    """Header lines of generated functions, each under its operations and
    dependency depth."""
    parts = []
    for sig, body, (ops, depth) in funcs:
        tmpl = "typename T, typename O" if " O " in sig else "typename T"
        parts += ["", f"// {sig[:sig.index('(')]}: {ops} operations, dependency depth {depth}",
                  f"template <{tmpl}>", f"GATO_HD inline void {sig} {{"]
        parts += body
        parts.append("}")
    return parts


def plant_slug(name: str, key: str) -> str:
    """A C identifier for the plant registered under `key`: its name with
    every other character an underscore, then a hash of its constants (the
    tree, the inertias, the limits, the EE offset), so that two plants of
    one name with other constants (add_pendulum's mass or length) never
    share a header, a namespace or a library."""
    p = get_parsed(key)
    h = hashlib.sha256(str(p.nq).encode())
    for a in (p.R_tree, p.p_tree, p.axis, p.inertia, p.joint_limits,
              p.velocity_limits, p.effort_limits, p.R_ee, p.p_ee):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    stem = re.sub(r"\W", "_", name)
    return f"{stem}_{h.hexdigest()[:12]}"


def generate_plant(key: str, namespace: str) -> str:
    """The header of a plant whose constants are registered under `key`
    rather than read from a committed URDF (api/mpc.py::add_pendulum's
    pendulum-augmented plants), in namespace gato::<namespace>: NQ, NX and
    only what csrc/rk4.cu calls (fd, fd_bias, fd_crba, fd_solve). It is
    written under the build directory at first use (_build.py) and
    includes gato_math.cuh from csrc/ by the include path."""
    cd = _get_cd(key)
    nq = cd.nq
    parts = [
        f"// Generated by gato_tpu_torch.dynamics.codegen.generate_plant from a "
        f"registered plant ({nq} joints). Do not edit.",
        "// Straight-line forward dynamics, whole and in csrc/rk4.cu's parts, traced "
        "from gato_tpu_torch/dynamics/channelized.py with the plant constants folded.",
        "#pragma once",
        '#include "gato_math.cuh"',
        "",
        f"namespace gato {{ namespace {namespace} {{",
        "",
        f"constexpr int NQ = {nq};",
        f"constexpr int NX = {2 * nq};",
    ]
    parts += _render([_gen_fd(cd, nq), _gen_fd_bias(cd, nq), _gen_fd_crba(cd, nq),
                      _gen_fd_solve(cd, nq)])
    parts += ["", f"}}}}  // namespace gato::{namespace}", ""]
    return "\n".join(parts)


def header_path(robot: str) -> str:
    return os.path.join(GENERATED_DIR, f"{robot}.cuh")


def header_stats(text: str) -> dict[str, tuple[int, int]]:
    """{function: (operations, dependency depth)} from a generated header."""
    return {m.group(1): (int(m.group(2)), int(m.group(3))) for m in re.finditer(
        r"^// (\w+): (\d+) operations, dependency depth (\d+)$", text, re.M)}


def main():
    os.makedirs(GENERATED_DIR, exist_ok=True)
    for robot in ROBOTS:
        text = generate(robot)
        with open(header_path(robot), "w") as f:
            f.write(text)
        print(f"wrote {header_path(robot)} ({text.count(chr(10))} lines, "
              f"{len(text.encode())} bytes)")
        for name, (ops, depth) in header_stats(text).items():
            print(f"  {name}: {ops} operations, dependency depth {depth}")


if __name__ == "__main__":
    main()
