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

The cost weights `w` (CostParams order), dt and the tracking weight are
runtime arguments; only the robot constants and limits are folded.
`GATO_HD` is `__host__ __device__` under nvcc and empty otherwise, so the
header also compiles as host C++ (tests/test_torch_codegen.py).

    python -m gato_tpu_torch.dynamics.codegen      # rewrites csrc/generated/
"""

from __future__ import annotations

import os

import torch

from ..ops.cost import CostParams
from ..ops.kkt_fast import kkt_knot_channels_structured
from ..ops.merit_fast import _get_cd, _knot_parts
from ..robots.model import load_robot
from . import mathshim as ms

GENERATED_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "generated")

# robots whose header is generated and committed
ROBOTS = ("indy7",)

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

    def render(self, outputs):
        """Body lines needed by `outputs` [(target, channel)], then the
        output stores (a structural zero stores 0)."""
        need = set()
        for _, ch in outputs:
            if isinstance(ch, Sym):
                need.add(ch.name)
        for name, _, deps in reversed(self.lines):
            if name in need:
                need.update(deps)
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
    return sig, em.render([(f"qdd[{i}]", qdd[i]) for i in range(nq)])


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
    return sig, em.render(outs)


def _gen_knot_merit(cd, key, nq):
    em = Emitter()
    q, qd, u, xn, r3, fe, dt, w_track, cp = _knot_args(em, nq)
    cost, ucost, defect = _knot_parts(cd, key, cp, q, qd, u, xn, r3, fe, dt,
                                      2, w_track)
    sig = f"knot_merit({_KNOT_SIG}, O out)"
    return sig, em.render([("out[0]", cost), ("out[1]", ucost),
                           ("out[2]", defect)])


def generate(robot: str) -> str:
    """The header text for one robot (trapezoidal integrator, the default
    and the only one the CUDA kernels take)."""
    model = load_robot(robot, torch.float64, device="cpu")
    cd = _get_cd(model.key)
    nq = cd.nq
    parts = [
        f"// Generated by `python -m gato_tpu_torch.dynamics.codegen` from the "
        f"{robot} URDF. Do not edit.",
        "// Straight-line forward dynamics, per-knot KKT blocks and per-knot "
        "merit terms,",
        "// traced from gato_tpu_torch/ops/{kkt_fast,merit_fast}.py with the "
        "robot constants folded.",
        "// Weights w: q_cost, qd_cost, u_cost, N_cost, q_lim_cost, "
        "vel_lim_cost, ctrl_lim_cost.",
        "// Matrices are row-major: A (nx, nx), B (nx, nu), Q (nx, nx).",
        "// Outputs of type O are anything indexable as O[i] = T: a T* or a "
        "strided accessor.",
        "#pragma once",
        '#include "../gato_math.cuh"',
        "",
        f"namespace gato {{ namespace {robot} {{",
        "",
        f"constexpr int NQ = {nq};",
        f"constexpr int NX = {2 * nq};",
    ]
    for sig, body in (_gen_fd(cd, nq), _gen_knot_kkt(cd, model.key, nq),
                      _gen_knot_merit(cd, model.key, nq)):
        tmpl = "typename T, typename O" if " O " in sig else "typename T"
        parts += ["", f"template <{tmpl}>", f"GATO_HD inline void {sig} {{"]
        parts += body
        parts.append("}")
    parts += ["", f"}}}}  // namespace gato::{robot}", ""]
    return "\n".join(parts)


def header_path(robot: str) -> str:
    return os.path.join(GENERATED_DIR, f"{robot}.cuh")


def main():
    os.makedirs(GENERATED_DIR, exist_ok=True)
    for robot in ROBOTS:
        text = generate(robot)
        with open(header_path(robot), "w") as f:
            f.write(text)
        print(f"wrote {header_path(robot)} ({text.count(chr(10))} lines)")


if __name__ == "__main__":
    main()
