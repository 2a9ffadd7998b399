"""Build the CUDA kernels at first use and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled by
nvcc into its own shared library (no PyTorch headers, so a build takes
seconds to minutes, not the many minutes of a torch extension):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

The libraries go to `build/gato_tpu_torch/` beside the package, named by a
hash of every file under csrc/ and of the flags, so an edit rebuilds and an
unchanged tree reuses the build. ptxas' register and spill report is kept
next to each library (`<name>-<hash>.log`). There is no fallback: without
nvcc, or when nvcc fails, this raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "gato_tpu_torch")
KERNELS = ("rk4", "bsqp_iter", "iter", "pcg", "merit", "kkt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "gato_tpu_torch/csrc/ on a machine with the CUDA "
                           "toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "**", "*.cu*"),
                                 recursive=True)):
        h.update(os.path.relpath(path, CSRC_DIR).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_source_hash()}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named kernels that are not built yet, all at once in
    parallel nvcc processes. Returns {name: build seconds} of those built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out[:-3] + ".log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            with open(out[:-3] + ".log") as f:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{f.read()}")
        os.replace(tmp, out)
    return seconds


def ptxas_report(name: str) -> str:
    """ptxas' resource lines (registers, spills, shared memory) of a build."""
    with open(library_path(name)[:-3] + ".log") as f:
        return "".join(line for line in f
                       if "registers" in line or "spill" in line
                       or "Compiling entry" in line)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    build((name,))
    return ctypes.CDLL(library_path(name))
