"""Profiling hooks: torch.profiler traces around solver calls.

Port of gato_tpu/utils/profiling.py. The reference's observability is
wall-clock stats threaded through SQPStats (bsqp.cuh:109-190); the port
returns the same stats from the solve and adds a trace of the host's
operators and, on the card, of every kernel (CUPTI through
torch.profiler), viewable in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the body (the host's operators, and the card's kernels where
    there is a card) and write its Chrome trace to log_dir/trace.json on
    exit; log_dir defaults to a new directory under the temporary
    directory. Yields log_dir."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="gato_tpu_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a record_function span in the profiler's trace and,
    where there is a card, an NVTX range around the same work."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
