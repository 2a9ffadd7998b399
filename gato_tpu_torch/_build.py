"""Build the CUDA kernels at first use and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled by
nvcc once for each plant of its row in KERNELS into its own shared library
(no PyTorch headers, so a build takes seconds to minutes, not the many
minutes of a torch extension):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 -DGATO_ROBOT=<plant>

(-DGATO_ROBOT picks the generated header, csrc/robot.cuh; the entry points
are named for the plant: gato_<name>_<plant>.)

(--split-compile=0 optimizes the kernels of one file in parallel on every
CPU: the iteration kernels' files hold five variants each, kkt.cu three.)

The libraries go to `build/gato_tpu_torch/` beside the package, named by
kernel, plant and a hash of every file under csrc/ and of the flags
(`lib<name>_<plant>-<hash>.so`), so an edit rebuilds and an unchanged tree
reuses the build. ptxas' register and spill report is kept next to each
library (`<name>_<plant>-<hash>.log`). There is no fallback: without
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
# the plants each kernel is built for; a kernel's other plants are ROADMAP
# Queue 1 item 2's (ops/cuda_sim.py::require_cuda_robot raises for them)
KERNELS = {"rk4": ("indy7", "iiwa14"), "bsqp_iter": ("indy7", "iiwa14"),
           "iter": ("indy7",), "pcg": ("indy7",), "merit": ("indy7",),
           "kkt": ("indy7",)}
# every (kernel, plant) library
LIBRARIES = tuple((name, robot) for name, robots in KERNELS.items() for robot in robots)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


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


def _check(name: str, robot: str):
    if robot not in KERNELS.get(name, ()):
        raise ValueError(f"no {name} library for {robot!r}: KERNELS builds {name} for "
                         f"{KERNELS.get(name, ())}")


def library_path(name: str, robot: str = "indy7") -> str:
    _check(name, robot)
    return os.path.join(BUILD_DIR, f"lib{name}_{robot}-{_source_hash()}.so")


def nvcc_command(name: str, robot: str, out: str, extra=()) -> list[str]:
    """The nvcc command line that builds csrc/<name>.cu for `robot` into
    `out`, with `extra` flags (a measurement's build) before the source."""
    return [_nvcc(), *NVCC_FLAGS, f"-DGATO_ROBOT={robot}", *extra, "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def build(libraries=LIBRARIES) -> dict[tuple[str, str], float]:
    """Compile the (kernel, plant) libraries that are not built yet, all at
    once in parallel nvcc processes. Returns {(name, plant): build seconds}
    of those built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, robot in libraries:
        out = library_path(name, robot)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out[:-3] + ".log", "w")
        procs[name, robot] = (subprocess.Popen(nvcc_command(name, robot, tmp), stdout=log,
                                               stderr=subprocess.STDOUT),
                              tmp, out, log, time.perf_counter())
    seconds = {}
    for key, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        seconds[key] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            with open(out[:-3] + ".log") as f:
                raise RuntimeError(f"nvcc failed for csrc/{key[0]}.cu ({key[1]}):\n{f.read()}")
        os.replace(tmp, out)
    return seconds


def ptxas_report(name: str, robot: str = "indy7") -> str:
    """ptxas' resource lines (registers, spills, shared memory) of a build."""
    with open(library_path(name, robot)[:-3] + ".log") as f:
        return "".join(line for line in f
                       if "registers" in line or "spill" in line
                       or "Compiling entry" in line)


@functools.lru_cache(maxsize=None)
def load_library(name: str, robot: str = "indy7") -> ctypes.CDLL:
    """The kernel library of `robot`, built first if needed."""
    build(((name, robot),))
    return ctypes.CDLL(library_path(name, robot))
