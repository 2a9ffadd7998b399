"""ctypes binding to the native C++ rigid-body runtime (native/rbd.cpp).

The reference checks its GRiD dynamics against native Pinocchio; this
repository's counterpart is native/rbd.cpp, an independent implementation
of RNEA, CRBA, forward dynamics, EE kinematics and an RK4 step. This module
is the port's own copy of the JAX package's binding (importing that one
would import jax). It serves as an oracle for dynamics/algorithms.py.

The library is built with g++ at first use into build/gato_tpu_torch/,
named by a hash of the source and the flags, beside the CUDA kernels'
libraries; nothing is written under native/.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ._build import BUILD_DIR
from .robots.urdf import ParsedRobot

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "native", "rbd.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librbd-{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The runtime's library, built first if needed."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rbd_create.restype = ctypes.c_void_p
    lib.rbd_create.argtypes = [ctypes.c_int, dp, dp, dp, dp, ctypes.c_double]
    lib.rbd_destroy.restype = None
    lib.rbd_destroy.argtypes = [ctypes.c_void_p]
    for name, argtypes in (("rbd_rnea", [ctypes.c_void_p, dp, dp, dp, dp, dp]),
                           ("rbd_crba", [ctypes.c_void_p, dp, dp]),
                           ("rbd_fd", [ctypes.c_void_p, dp, dp, dp, dp, dp]),
                           ("rbd_fk_ee", [ctypes.c_void_p, dp, dp]),
                           ("rbd_rk4", [ctypes.c_void_p, dp, dp, ctypes.c_double,
                                        dp, dp])):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = argtypes
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRobot:
    """A native rigid-body model of one parsed robot."""

    def __init__(self, robot: ParsedRobot, gravity: float = 9.81):
        self._lib = get_lib()
        self.nq = robot.nq
        arrays = [np.ascontiguousarray(a, np.float64)
                  for a in (robot.R_tree, robot.p_tree, robot.axis, robot.inertia)]
        self._h = self._lib.rbd_create(self.nq, *map(_ptr, arrays), gravity)
        if not self._h:
            raise RuntimeError("rbd_create failed (nq out of range?)")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rbd_destroy(self._h)
            self._h = None

    @staticmethod
    def _vec(a, n):
        return None if a is None else np.ascontiguousarray(
            np.asarray(a, np.float64).reshape(n))

    def rnea(self, q, qd, qdd, f_ext=None):
        tau = np.zeros(self.nq)
        self._lib.rbd_rnea(self._h, *map(_ptr, (
            self._vec(q, self.nq), self._vec(qd, self.nq), self._vec(qdd, self.nq),
            self._vec(f_ext, 6), tau)))
        return tau

    def crba(self, q):
        M = np.zeros((self.nq, self.nq))
        self._lib.rbd_crba(self._h, _ptr(self._vec(q, self.nq)), _ptr(M))
        return M

    def fd(self, q, qd, tau, f_ext=None):
        qdd = np.zeros(self.nq)
        self._lib.rbd_fd(self._h, *map(_ptr, (
            self._vec(q, self.nq), self._vec(qd, self.nq), self._vec(tau, self.nq),
            self._vec(f_ext, 6), qdd)))
        return qdd

    def ee_pose(self, q):
        out = np.zeros(6)
        self._lib.rbd_fk_ee(self._h, _ptr(self._vec(q, self.nq)), _ptr(out))
        return out

    def rk4(self, x, u, dt, f_ext_world=None):
        out = np.zeros(2 * self.nq)
        self._lib.rbd_rk4(self._h, _ptr(self._vec(x, 2 * self.nq)),
                          _ptr(self._vec(u, self.nq)), dt,
                          _ptr(self._vec(f_ext_world, 6)), _ptr(out))
        return out
