"""The code generator (gato_tpu_torch.dynamics.codegen) without a card,
for each plant it writes a header for (indy7, iiwa14): the committed header
is what the generator writes today, and the header, compiled as host C++
(T = double), computes what the plain PyTorch trace computes: fd,
knot_kkt and knot_merit to rtol 1e-10 on random inputs; fd's parts,
composed as csrc/rk4.cu's crba variant composes them (fd_crba, fd_bias,
fd_solve), compute fd; and indy7's staged functions (knot_dyn, knot_dual,
knot_ab, knot_defect, knot_cost; iiwa14's header has none), composed as
csrc/kkt.cu composes them, compute knot_kkt's outputs for every split of
the tangent directions. The header that a pendulum-augmented plant gets at
first use (codegen.generate_plant, from the constants add_pendulum
registers: NQ, NX, fd and fd's parts) computes fd as the plain trace does,
whole and composed as the crba variant composes it, to rtol 1e-10, for the
two default plants (15 kg at 0.3 m on indy7 and iiwa14) and iiwa14 with
10 kg at 0.5 m. Each plant's shim instantiates only what its tests
call; all compile at once, at -O0: the test runs each function a few
times, and g++ takes a quarter of -O1's time over 50k lines of
straight-line code.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gato_tpu_torch.api.mpc import add_pendulum
from gato_tpu_torch.dynamics import codegen
from gato_tpu_torch.dynamics import mathshim as ms
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.ops.kkt_fast import _mat, _vec, kkt_knot_channels_structured
from gato_tpu_torch.ops.merit_fast import _get_cd, _knot_parts
from gato_tpu_torch.robots.model import load_robot

_KKT_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_double] * 2
                 + [ctypes.c_void_p] * 8)

M = 7  # random work items
ROBOTS = codegen.ROBOTS
NQS = {"indy7": 6, "iiwa14": 7}

# the pendulum plants whose generated header is compiled: (base, mass, length)
PENDULUMS = (("indy7", 15.0, 0.3), ("iiwa14", 15.0, 0.3), ("iiwa14", 10.0, 0.5))

# fd and the crba variant's composition of fd (every header), knot_kkt and
# knot_merit (the committed ones)
_FD_SHIM = r"""
#include "generated/ROBOT.cuh"
typedef double T;
namespace R = gato::ROBOT;
extern "C" {
void h_fd(const T* q, const T* qd, const T* u, const T* fe, T* qdd) {
  R::fd<T>(q, qd, u, fe, qdd);
}
// csrc/rk4.cu's crba variant on one thread: CRBA, the bias, the solve
void h_fd_crba(const T* q, const T* qd, const T* u, const T* fe, T* qdd) {
  T M[R::NQ * R::NQ], bias[R::NQ];
  R::fd_crba<T, T*>(q, M);
  R::fd_bias<T, T*>(q, qd, fe, bias);
  R::fd_solve<T, T*>(M, u, bias, qdd);
}
}
"""
_SHIM = _FD_SHIM + r"""
extern "C" {
void h_kkt(const T* q, const T* qd, const T* u, const T* xn, const T* r3,
           const T* fe, T dt, T w_track, const T* w, T* A, T* B, T* c, T* Q,
           T* qv, T* Rd, T* rv) {
  R::knot_kkt<T, T*>(q, qd, u, xn, r3, fe, dt, w_track, w, A, B, c, Q, qv, Rd, rv);
}
void h_merit(const T* q, const T* qd, const T* u, const T* xn, const T* r3,
             const T* fe, T dt, T w_track, const T* w, T* out) {
  R::knot_merit<T, T*>(q, qd, u, xn, r3, fe, dt, w_track, w, out);
}
}
"""

# indy7's staged KKT
_STAGED_SHIM = r"""
namespace gato { namespace indy7 {
// csrc/kkt.cu's stages on one thread: the primal, every part's dual columns
// and A/B columns, the defect, the cost
template <int G, int P = 0>
void staged(const T* q, const T* qd, const T* u, const T* xn, const T* r3,
            const T* fe, T dt, T w_track, const T* w, T* A, T* B, T* c, T* Q,
            T* qv, T* Rd, T* rv, T* qdd, T* Minv, T* dID) {
  if constexpr (P == 0) {
    knot_dyn<T, T*>(q, qd, u, fe, qdd, Minv);
    knot_cost<T, T*>(q, qd, u, r3, w_track, w, Q, qv, Rd, rv);
    knot_defect<T, T*>(q, qd, xn, qdd, dt, c);
  }
  if constexpr (P < G) {
    knot_dual<G, P, T, T*>(q, qd, qdd, fe, dID);
    knot_ab<G, P, T, T*>(Minv, dID, dt, A, B);
    staged<G, P + 1>(q, qd, u, xn, r3, fe, dt, w_track, w, A, B, c, Q, qv, Rd,
                     rv, qdd, Minv, dID);
  }
}
}}
extern "C" {
int h_split(int G, int P, int* dirs) {
  const int* row = G == 2 ? gato::indy7::KKT_DIRS_G2[P] : gato::indy7::KKT_DIRS_G4[P];
  int n = 0;
  for (int i = 0; i < gato::indy7::NX && row[i] >= 0; ++i) dirs[n++] = row[i];
  return n;
}
void h_staged(int G, const T* q, const T* qd, const T* u, const T* xn,
              const T* r3, const T* fe, T dt, T w_track, const T* w, T* A,
              T* B, T* c, T* Q, T* qv, T* Rd, T* rv, T* dID) {
  T qdd[6], Minv[36];
  auto f = G == 2 ? gato::indy7::staged<2> : gato::indy7::staged<4>;
  f(q, qd, u, xn, r3, fe, dt, w_track, w, A, B, c, Q, qv, Rd, rv, qdd, Minv, dID);
}
}
"""


def test_committed_header_is_generated_output():
    for robot in ROBOTS:
        with open(codegen.header_path(robot)) as f:
            assert f.read() == codegen.generate(robot), robot


def _pendulum(base, mass, length):
    """(the float64 pendulum plant, its slug)."""
    p = add_pendulum(load_robot(base, torch.float64, device="cpu"), mass=mass, length=length)
    return p, codegen.plant_slug(p.name, p.key)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{robot or PENDULUMS entry: the shim's library}, every shim compiled
    at once: the committed headers' from csrc/generated/, the pendulum
    plants' from headers generated here (as _build.py writes them, under
    generated/ of a directory on the include path, beside csrc/)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("codegen")
    csrc = os.path.join(os.path.dirname(codegen.GENERATED_DIR))
    (d / "generated").mkdir()
    sources = {robot: _SHIM.replace("ROBOT", robot)
               + (_STAGED_SHIM if codegen.KKT_SPLITS[robot] else "") for robot in ROBOTS}
    for plant in PENDULUMS:
        p, slug = _pendulum(*plant)
        (d / "generated" / f"{slug}.cuh").write_text(codegen.generate_plant(p.key, slug))
        sources[plant] = _FD_SHIM.replace("ROBOT", slug)
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        src, lib = d / f"shim{i}.cpp", d / f"libshim{i}.so"
        src.write_text(text)
        procs[key] = (subprocess.Popen([gxx, "-O0", "-std=c++17", "-shared", "-fPIC",
                                        "-I", str(d), "-I", csrc, "-o", str(lib),
                                        str(src)]), lib)
    for proc, _ in procs.values():
        assert proc.wait(timeout=600) == 0
    return {key: ctypes.CDLL(str(lib)) for key, (_, lib) in procs.items()}


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inputs(seed, nq=6):
    rng = np.random.default_rng(seed)
    return dict(q=rng.uniform(-1.5, 1.5, (M, nq)), qd=rng.uniform(-1, 1, (M, nq)),
                u=rng.uniform(-20, 20, (M, nq)), xn=rng.uniform(-1, 1, (M, 2 * nq)),
                r3=rng.uniform(-0.5, 0.8, (M, 3)), fe=rng.uniform(-5, 5, (M, 6)))


WEIGHTS = CostParams(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0,
                     q_lim_cost=0.01, vel_lim_cost=0.003, ctrl_lim_cost=0.002)
DT, W_TRACK = 0.01, 50.0


def _cols(a):
    return [torch.tensor(a[:, i]) for i in range(a.shape[1])]


def test_generated_fd_matches_trace(host_libs):
    for robot in ROBOTS:
        _fd_matches_trace(host_libs[robot], robot)


def test_generated_pendulum_fd_matches_trace(host_libs):
    for plant in PENDULUMS:
        p, _ = _pendulum(*plant)
        _fd_matches_trace(host_libs[plant], p.name, p.key, p.nq)


def _fd_matches_trace(host_lib, robot, key=None, NQ=None):
    NQ = NQ or NQS[robot]
    x = _inputs(1, NQ)
    cd = _get_cd(key or load_robot(robot, torch.float64, device="cpu").key)
    q = _cols(x["q"])
    ref = cd.fd([ms.cos(v) for v in q], [ms.sin(v) for v in q], _cols(x["qd"]),
                _cols(x["u"]), f_ext=_cols(x["fe"]))
    ref = torch.stack(ref, 1).numpy()
    for fn in (host_lib.h_fd, host_lib.h_fd_crba):
        fn.argtypes = [ctypes.c_void_p] * 5
        out = np.zeros((M, NQ))
        for m in range(M):
            qdd = np.zeros(NQ)
            fn(_ptr(x["q"][m].copy()), _ptr(x["qd"][m].copy()),
               _ptr(x["u"][m].copy()), _ptr(x["fe"][m].copy()), _ptr(qdd))
            out[m] = qdd
        np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)


def test_generated_knot_kkt_matches_trace(host_libs):
    for robot in ROBOTS:
        _knot_kkt_matches_trace(host_libs[robot], robot)


def _knot_kkt_matches_trace(host_lib, robot):
    NQ = NQS[robot]
    NX = 2 * NQ
    x = _inputs(2, NQ)
    model = load_robot(robot, torch.float64, device="cpu")
    cd = _get_cd(model.key)
    like = torch.tensor(x["q"][:, 0])
    A, Bm, c, Q, qv, Rd, rv = kkt_knot_channels_structured(
        cd, model.key, WEIGHTS, _cols(x["q"]), _cols(x["qd"]), _cols(x["u"]),
        _cols(x["xn"]), _cols(x["r3"]), _cols(x["fe"]), DT, 2, like,
        w_track=W_TRACK)
    ref = [_mat(A, like), _mat(Bm, like), _vec(c, like), _mat(Q, like),
           _vec(qv, like), _vec(Rd, like), _vec(rv, like)]
    fn = host_lib.h_kkt
    fn.argtypes = _KKT_ARGTYPES
    w = np.array(WEIGHTS.weights())
    for m in range(M):
        outs = _kkt_outputs(NQ)
        fn(_ptr(x["q"][m].copy()), _ptr(x["qd"][m].copy()),
           _ptr(x["u"][m].copy()), _ptr(x["xn"][m].copy()),
           _ptr(x["r3"][m].copy()), _ptr(x["fe"][m].copy()), DT, W_TRACK,
           _ptr(w), *[_ptr(o) for o in outs])
        for o, r in zip(outs, ref):
            np.testing.assert_allclose(o, r[m].numpy(), rtol=1e-10, atol=1e-12)


def test_generated_knot_merit_matches_trace(host_libs):
    for robot in ROBOTS:
        _knot_merit_matches_trace(host_libs[robot], robot)


def _knot_merit_matches_trace(host_lib, robot):
    x = _inputs(3, NQS[robot])
    model = load_robot(robot, torch.float64, device="cpu")
    cd = _get_cd(model.key)
    ref = _knot_parts(cd, model.key, WEIGHTS, _cols(x["q"]), _cols(x["qd"]),
                      _cols(x["u"]), _cols(x["xn"]), _cols(x["r3"]),
                      _cols(x["fe"]), DT, 2, W_TRACK)
    ref = torch.stack(ref, 1).numpy()
    fn = host_lib.h_merit
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 2
    w = np.array(WEIGHTS.weights())
    out = np.zeros((M, 3))
    for m in range(M):
        o = np.zeros(3)
        fn(_ptr(x["q"][m].copy()), _ptr(x["qd"][m].copy()),
           _ptr(x["u"][m].copy()), _ptr(x["xn"][m].copy()),
           _ptr(x["r3"][m].copy()), _ptr(x["fe"][m].copy()), DT, W_TRACK,
           _ptr(w), _ptr(o))
        out[m] = o
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-12)


def _kkt_outputs(NQ=6):
    NX = 2 * NQ
    return [np.zeros((NX, NX)), np.zeros((NX, NQ)), np.zeros(NX),
            np.zeros((NX, NX)), np.zeros(NX), np.zeros(NQ), np.zeros(NQ)]


@pytest.mark.parametrize("groups", codegen.KKT_SPLITS["indy7"])
def test_staged_knot_kkt_matches_knot_kkt(host_libs, groups):
    """knot_dyn, then knot_dual and knot_ab of every part of the split into
    `groups` parts, knot_defect and knot_cost, composed as csrc/kkt.cu
    composes them, give knot_kkt's outputs to rtol 1e-10 on random inputs;
    the header's split (KKT_DIRS_G<groups>) holds each tangent direction in
    exactly one part."""
    NQ, NX = 6, 12
    host_lib = host_libs["indy7"]
    dirs = []
    split = host_lib.h_split
    split.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for p in range(groups):
        d = np.zeros(NX, dtype=np.int32)
        dirs += d[:split(groups, p, _ptr(d))].tolist()
    assert sorted(dirs) == list(range(NX))
    x = _inputs(4)
    w = np.array(WEIGHTS.weights())
    kkt, staged = host_lib.h_kkt, host_lib.h_staged
    kkt.argtypes = _KKT_ARGTYPES
    staged.argtypes = [ctypes.c_int] + _KKT_ARGTYPES + [ctypes.c_void_p]
    for m in range(M):
        ins = [_ptr(x[k][m].copy()) for k in ("q", "qd", "u", "xn", "r3", "fe")]
        ref, outs = _kkt_outputs(), _kkt_outputs()
        kkt(*ins, DT, W_TRACK, _ptr(w), *[_ptr(o) for o in ref])
        staged(groups, *ins, DT, W_TRACK, _ptr(w), *[_ptr(o) for o in outs],
               _ptr(np.zeros(NQ * NX)))
        for o, r in zip(outs, ref):
            np.testing.assert_allclose(o, r, rtol=1e-10, atol=1e-12)
