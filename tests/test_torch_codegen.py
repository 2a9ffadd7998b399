"""The code generator (gato_tpu_torch.dynamics.codegen) without a card:
the committed header is what the generator writes today, and the header,
compiled as host C++ (T = double), computes what the plain PyTorch trace
computes: fd, knot_kkt and knot_merit to rtol 1e-10 on random inputs.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gato_tpu_torch.dynamics import codegen
from gato_tpu_torch.dynamics import mathshim as ms
from gato_tpu_torch.ops.cost import CostParams
from gato_tpu_torch.ops.kkt_fast import _mat, _vec, kkt_knot_channels_structured
from gato_tpu_torch.ops.merit_fast import _get_cd, _knot_parts
from gato_tpu_torch.robots.model import load_robot

M = 7  # random work items
NQ, NX = 6, 12

_SHIM = r"""
#include "generated/indy7.cuh"
typedef double T;
extern "C" {
void h_fd(const T* q, const T* qd, const T* u, const T* fe, T* qdd) {
  gato::indy7::fd<T>(q, qd, u, fe, qdd);
}
void h_kkt(const T* q, const T* qd, const T* u, const T* xn, const T* r3,
           const T* fe, T dt, T w_track, const T* w, T* A, T* B, T* c, T* Q,
           T* qv, T* Rd, T* rv) {
  gato::indy7::knot_kkt<T, T*>(q, qd, u, xn, r3, fe, dt, w_track, w, A, B, c,
                               Q, qv, Rd, rv);
}
void h_merit(const T* q, const T* qd, const T* u, const T* xn, const T* r3,
             const T* fe, T dt, T w_track, const T* w, T* out) {
  gato::indy7::knot_merit<T, T*>(q, qd, u, xn, r3, fe, dt, w_track, w, out);
}
}
"""


def test_committed_header_is_generated_output():
    with open(codegen.header_path("indy7")) as f:
        assert f.read() == codegen.generate("indy7")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("codegen")
    src = d / "host.cpp"
    src.write_text(_SHIM)
    lib = d / "libhost.so"
    csrc = os.path.join(os.path.dirname(codegen.GENERATED_DIR))
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", csrc,
                    "-o", str(lib), str(src)], check=True, timeout=600)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(q=rng.uniform(-1.5, 1.5, (M, NQ)), qd=rng.uniform(-1, 1, (M, NQ)),
                u=rng.uniform(-20, 20, (M, NQ)), xn=rng.uniform(-1, 1, (M, NX)),
                r3=rng.uniform(-0.5, 0.8, (M, 3)), fe=rng.uniform(-5, 5, (M, 6)))


WEIGHTS = CostParams(q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0,
                     q_lim_cost=0.01, vel_lim_cost=0.003, ctrl_lim_cost=0.002)
DT, W_TRACK = 0.01, 50.0


def _cols(a):
    return [torch.tensor(a[:, i]) for i in range(a.shape[1])]


def test_generated_fd_matches_trace(host_lib):
    x = _inputs(1)
    cd = _get_cd(load_robot("indy7", torch.float64, device="cpu").key)
    q = _cols(x["q"])
    ref = cd.fd([ms.cos(v) for v in q], [ms.sin(v) for v in q], _cols(x["qd"]),
                _cols(x["u"]), f_ext=_cols(x["fe"]))
    ref = torch.stack(ref, 1).numpy()
    fn = host_lib.h_fd
    fn.argtypes = [ctypes.c_void_p] * 5
    out = np.zeros((M, NQ))
    for m in range(M):
        qdd = np.zeros(NQ)
        fn(_ptr(x["q"][m].copy()), _ptr(x["qd"][m].copy()),
           _ptr(x["u"][m].copy()), _ptr(x["fe"][m].copy()), _ptr(qdd))
        out[m] = qdd
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)


def test_generated_knot_kkt_matches_trace(host_lib):
    x = _inputs(2)
    model = load_robot("indy7", torch.float64, device="cpu")
    cd = _get_cd(model.key)
    like = torch.tensor(x["q"][:, 0])
    A, Bm, c, Q, qv, Rd, rv = kkt_knot_channels_structured(
        cd, model.key, WEIGHTS, _cols(x["q"]), _cols(x["qd"]), _cols(x["u"]),
        _cols(x["xn"]), _cols(x["r3"]), _cols(x["fe"]), DT, 2, like,
        w_track=W_TRACK)
    ref = [_mat(A, like), _mat(Bm, like), _vec(c, like), _mat(Q, like),
           _vec(qv, like), _vec(Rd, like), _vec(rv, like)]
    fn = host_lib.h_kkt
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 8
    w = np.array(WEIGHTS.weights())
    for m in range(M):
        outs = [np.zeros((NX, NX)), np.zeros((NX, NQ)), np.zeros(NX),
                np.zeros((NX, NX)), np.zeros(NX), np.zeros(NQ), np.zeros(NQ)]
        fn(_ptr(x["q"][m].copy()), _ptr(x["qd"][m].copy()),
           _ptr(x["u"][m].copy()), _ptr(x["xn"][m].copy()),
           _ptr(x["r3"][m].copy()), _ptr(x["fe"][m].copy()), DT, W_TRACK,
           _ptr(w), *[_ptr(o) for o in outs])
        for o, r in zip(outs, ref):
            np.testing.assert_allclose(o, r[m].numpy(), rtol=1e-10, atol=1e-12)


def test_generated_knot_merit_matches_trace(host_lib):
    x = _inputs(3)
    model = load_robot("indy7", torch.float64, device="cpu")
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
