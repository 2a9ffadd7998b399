"""Build the CUDA kernels at first use and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled by
nvcc once for each plant of its row in KERNELS into its own shared library
(no PyTorch headers, so a build takes seconds to minutes, not the many
minutes of a torch extension):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 -DGATO_ROBOT=<plant>

(-DGATO_ROBOT picks the generated header, csrc/robot.cuh; the entry points
are named for the plant: gato_<name>_<plant>.)

A plant whose constants come from a call at run time (api/mpc.py::
add_pendulum's mass and length) has no committed header: its header is
generated from the registered constants (dynamics/codegen.py::
generate_plant), registered here under the plant's slug with the kernels
it serves (register_plant, done by ops/cuda_sim.py::require_cuda_robot), and
written to `build/gato_tpu_torch/generated/<slug>.cuh` when its library is
built; nvcc then takes `-I build/gato_tpu_torch -I gato_tpu_torch/csrc`,
and the header's text enters the library's hash.

(--split-compile=0 optimizes the kernels of one file in parallel on every
CPU: the iteration kernels' files hold five variants each, kkt.cu two for
indy7 and one for iiwa14.)

The libraries go to `build/gato_tpu_torch/` beside the package, named by
kernel, plant and a hash of every file under csrc/ and of the flags
(`lib<name>_<plant>-<hash>.so`), so an edit rebuilds and an unchanged tree
reuses the build (a generated plant's header text is hashed too). ptxas'
register and spill report is kept next to each
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
GENERATED_DIR = os.path.join(BUILD_DIR, "generated")
# the plants with a committed header that each kernel is built for: every
# kernel serves both; rk4 also serves the pendulum-augmented plants of the
# two, whose headers are generated at first use (GENERATED); any other
# plant is ROADMAP Queue 2's (ops/cuda_sim.py::require_cuda_robot raises
# for it)
KERNELS = {"rk4": ("indy7", "iiwa14"), "bsqp_iter": ("indy7", "iiwa14"),
           "iter": ("indy7", "iiwa14"), "pcg": ("indy7", "iiwa14"),
           "merit": ("indy7", "iiwa14"), "kkt": ("indy7", "iiwa14")}
# every (kernel, plant) library of the committed headers
LIBRARIES = tuple((name, robot) for name, robots in KERNELS.items() for robot in robots)
# {slug: (header text, kernels)} of the plants whose header is generated
# in this process (register_plant)
GENERATED: dict[str, tuple[str, tuple[str, ...]]] = {}
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


def register_plant(slug: str, header: str, kernels) -> None:
    """Register a plant whose header is generated (text `header`, namespace
    gato::<slug>) for `kernels`; its libraries build like the others."""
    GENERATED[slug] = (header, tuple(kernels))


def _check(name: str, robot: str):
    if robot not in KERNELS.get(name, ()) and name not in GENERATED.get(robot, ("", ()))[1]:
        raise ValueError(f"no {name} library for {robot!r}: KERNELS builds {name} for "
                         f"{KERNELS.get(name, ())}, and no generated plant of that name "
                         f"is registered for it")


def library_path(name: str, robot: str = "indy7") -> str:
    _check(name, robot)
    h = _source_hash()
    if robot in GENERATED:
        h = hashlib.sha256((h + GENERATED[robot][0]).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{robot}-{h}.so")


def nvcc_command(name: str, robot: str, out: str, extra=()) -> list[str]:
    """The nvcc command line that builds csrc/<name>.cu for `robot` into
    `out`, with `extra` flags (a measurement's build) before the source."""
    include = ("-I", BUILD_DIR, "-I", CSRC_DIR) if robot in GENERATED else ()
    return [_nvcc(), *NVCC_FLAGS, f"-DGATO_ROBOT={robot}", *include, *extra, "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def _write_header(robot: str):
    """Write a generated plant's header where nvcc_command's include path
    finds it (generated/<slug>.cuh), whole or not at all."""
    os.makedirs(GENERATED_DIR, exist_ok=True)
    path = os.path.join(GENERATED_DIR, f"{robot}.cuh")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(GENERATED[robot][0])
    os.replace(tmp, path)


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
        if robot in GENERATED:
            _write_header(robot)
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
