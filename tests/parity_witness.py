"""The fixed-step N=128 B=1 cell of the fig-8 parity grid on the CPU, the
JAX package's tool beside the port's: is a loop that goes non-finite there
the workload's or the port's? A script, not a test:

    python tests/parity_witness.py starts [--cycles 400] [--tools jax,port]
        each tool (tools/parity_fig8.py's run_cell,
        gato_tpu_torch/examples/parity_fig8.py's run_cell) in float32 from
        the "ready" start and from each of its 12 neighbours one float32
        ulp away in one joint (up, then down)
    python tests/parity_witness.py float64 [--cycles 400]
        both tools' loops from the ready start in float64, each
        closed_loop_rollout wrapped as tests/test_torch_rollout.py's
        test_parity_cell_matches_the_jax_tool wraps it: the first cycle at
        which their states part by more than RTOL of the largest value

One JSON line a run: the first cycle whose EE is not finite (null: none),
the joint speeds before it over the plant's limits, the largest |u|, the
EE error's means over windows of 50 cycles, the tool's record.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
N, B, RTOL = 128, 1, 1e-6


def neighbours(x0):
    """The start and its 12 neighbours one ulp away in one joint: (label,
    x0) pairs, x0 a copy in x0's float type."""
    out = [("ready", x0.copy())]
    for sign in (1, -1):
        for j in range(6):
            x = x0.copy()
            x[j] = np.nextafter(x[j], sign * np.inf, dtype=x.dtype)
            out.append((f"q{j}{'+' if sign > 0 else '-'}1ulp", x))
    return out


def summary(xs, ees, us, refs, limits):
    xs, ees, us = (np.asarray(a, np.float64) for a in (xs, ees, us))
    finite = np.isfinite(ees).all(1)
    first = None if finite.all() else int(np.argmin(finite))
    span = xs[:first, 6:]
    errs = np.linalg.norm(ees - np.asarray(refs, np.float64)[:, 1, :3], axis=1)
    return dict(first_nonfinite=first,
                speed_over_limit=round(float((np.abs(span) / limits).max()), 1),
                umax=round(float(np.nanmax(np.abs(us))), 1),
                windows=[round(float(errs[k:k + 50].mean()), 4)
                         for k in range(0, len(errs), 50)])


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_fig8", os.path.join(ROOT, "tools", "parity_fig8.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def starts(cycles, tools):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import gato_tpu.api.rollout as jrollout
    from gato_tpu.api.config import INDY7_START_CONFIGS
    from gato_tpu_torch.api import rollout as trollout
    from gato_tpu_torch.examples import parity_fig8

    torch.set_num_threads(1)
    jtool, got, start = jax_tool(), {}, {}
    jreal, treal = jrollout.closed_loop_rollout, trollout.closed_loop_rollout

    def jax_from(model, sim_model, settings, cp, hp, x0, refs, f_ext, dt, **kw):
        got["out"] = jreal(model, sim_model, settings, cp, hp, jnp.asarray(start["x0"]),
                           refs, f_ext, dt, **kw)
        got["refs"], got["limits"] = refs, model.velocity_limits[:, 1]
        return got["out"]

    def port_from(model, sim_model, settings, cp, hp, x0, refs, f_ext, dt, **kw):
        got["out"] = treal(model, sim_model, settings, cp, hp, torch.from_numpy(start["x0"]),
                           refs, f_ext, dt, **kw)
        got["refs"], got["limits"] = refs, model.velocity_limits[:, 1]
        return got["out"]

    jrollout.closed_loop_rollout, trollout.closed_loop_rollout = jax_from, port_from
    x0 = np.concatenate([INDY7_START_CONFIGS["ready"], np.zeros(6)]).astype(np.float32)
    runs = dict(jax=lambda: jtool.run_cell(N, B, cycles),
                port=lambda: parity_fig8.run_cell(N, B, cycles, device="cpu"))
    for tool in tools:
        for label, x in neighbours(x0):
            start["x0"] = x
            t0 = time.perf_counter()
            rec = runs[tool]()
            print(json.dumps(dict(tool=tool, dtype="float32", start=label, record=rec, **summary(
                *(np.asarray(a) for a in got["out"]), got["refs"], np.asarray(got["limits"])),
                seconds=round(time.perf_counter() - t0, 1))), flush=True)


def float64(cycles):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import gato_tpu.api.rollout as jrollout
    from gato_tpu_torch.api import rollout as trollout
    from gato_tpu_torch.examples import parity_fig8
    from torch_port_helpers import models

    jm, tm = models("indy7")
    jtool, got = jax_tool(), {}
    jreal, treal = jrollout.closed_loop_rollout, trollout.closed_loop_rollout

    def up(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

    def jax_f64(model, sim_model, settings, cp, hp, x0, refs, f_ext, dt, **kw):
        t0 = time.perf_counter()
        got["jax"] = [np.asarray(a) for a in jreal(
            jm, jm, settings, up(cp), up(hp), up(x0), up(refs), up(f_ext), jnp.float64(dt), **kw)]
        got["jax_s"], got["refs"] = time.perf_counter() - t0, np.asarray(refs)
        return got["jax"]

    def port_f64(model, sim_model, settings, cp, hp, x0, refs, f_ext, dt, **kw):
        cp = dataclasses.replace(cp, **{f.name: float(np.float32(getattr(cp, f.name)))
                                        for f in dataclasses.fields(cp)})
        hp = type(hp)(*(getattr(hp, f.name).double() for f in dataclasses.fields(hp)))
        t0 = time.perf_counter()
        out = treal(tm, tm, settings, cp, hp, x0.double(), refs.double(), f_ext.double(), dt,
                    **kw)
        got["port"], got["port_s"] = [a.numpy() for a in out], time.perf_counter() - t0
        return out

    jrollout.closed_loop_rollout, trollout.closed_loop_rollout = jax_f64, port_f64
    records = dict(jax=jtool.run_cell(N, B, cycles),
                   port=parity_fig8.run_cell(N, B, cycles, device="cpu"))
    limits = np.asarray(tm.velocity_limits[:, 1])
    for tool in ("jax", "port"):
        print(json.dumps(dict(tool=tool, dtype="float64", start="ready", record=records[tool],
                              **summary(*got[tool], got["refs"], limits),
                              seconds=round(got[tool + "_s"], 1))), flush=True)
    # the first cycle at which the two loops' states part, and how far
    # apart they are before it
    xp, xj = got["port"][0], got["jax"][0]
    both = np.isfinite(xp).all(1) & np.isfinite(xj).all(1)
    span = int(np.argmin(both)) if not both.all() else len(both)
    rel = np.abs(xp[:span] - xj[:span]).max(1) / np.abs(xj[:span]).max()
    parted = np.nonzero(rel > RTOL)[0]
    print(json.dumps(dict(
        compare="port against jax, float64, x_sim", rtol=RTOL, cycles_both_finite=span,
        first_cycle_past_rtol=int(parted[0]) if len(parted) else None,
        largest_rel_before_it=float(rel[:parted[0]].max()) if len(parted) and parted[0] else
        (float(rel.max()) if not len(parted) else None),
        rel_every_50=[float(rel[k]) for k in range(0, span, 50)])), flush=True)


def main(argv=None):
    # a loop that runs away overflows: numpy's warnings of it are expected
    warnings.simplefilter("ignore", RuntimeWarning)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("starts", "float64"))
    ap.add_argument("--cycles", type=int, default=400)
    ap.add_argument("--tools", default="jax,port")
    args = ap.parse_args(argv)
    if args.mode == "starts":
        starts(args.cycles, args.tools.split(","))
    else:
        float64(args.cycles)


if __name__ == "__main__":
    main()
