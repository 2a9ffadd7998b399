"""The port's fig-8 example scripts (gato_tpu_torch/examples/parity_fig8.py,
fig8_tracking.py, benchmark_fig8.py, bsqp_example.py) against the JAX
package's (tools/parity_fig8.py, examples/fig8_tracking.py,
examples/benchmark_fig8.py) on the CPU.

Each script's own arithmetic is held against the JAX script's bit for bit,
with its expensive call replaced in both by one stub (monkeypatch on the
module attribute): closed_loop_rollout by one that returns EE positions made
with numpy from a seed, the real-time branch's solve timing (the JAX tool's
bench.bench_solve, the port's solve_seconds) by one value, MPC_GATO by a
controller whose run returns seeded statistics. Held equal: what each
script hands the stub, its returns, and its record or pickle (apart from
the JAX record's "backend" and the port's "card"). bsqp_example runs its
solve for real on the CPU. Every entry point raises without a card unless
it is given device="cpu". tests/test_torch_rollout.py runs one parity cell
through both tools for real, in float64.
"""

import dataclasses
import importlib.util
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import gato_tpu.api.rollout as jrollout
import gato_tpu_torch.api.rollout as trollout
from gato_tpu_torch.examples import benchmark_fig8, bsqp_example, fig8_tracking, parity_fig8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_FIELDS = ("backend", "card")


def load_jax_script(rel):
    """A JAX script (tools/ and examples/ are not packages) as a module of
    its own name."""
    name = "jax_" + os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_scripts():
    return {rel: load_jax_script(rel) for rel in (
        "tools/parity_fig8.py", "examples/fig8_tracking.py", "examples/benchmark_fig8.py")}


def numpy_of(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def fields_of(obj):
    """A dataclass's or a pytree's fields as numpy."""
    names = [f.name for f in dataclasses.fields(obj)]
    return {n: numpy_of(getattr(obj, n)) for n in names}


class RolloutStub:
    """closed_loop_rollout's stand-in: keeps what a tool hands it and returns
    (x, EE, u) with the EE positions near each window's knot-1 goal, made
    with numpy from the number of cycles and the batch, in the tool's own
    array type."""

    def __init__(self, to_array):
        self.to_array, self.calls = to_array, []

    def __call__(self, model, sim_model, settings, cp, hp, x0, refs, f_ext, dt, **kw):
        refs = numpy_of(refs)
        self.calls.append(dict(
            refs=refs, x0=numpy_of(x0), f_ext=numpy_of(f_ext), dt=float(dt),
            kw=kw, settings=(settings.N, settings.max_sqp_iters, settings.max_pcg_iters),
            cp={k: np.float32(v) for k, v in fields_of(cp).items()}, hp=fields_of(hp)))
        n, b = refs.shape[0], self.calls[-1]["f_ext"].shape[0]
        ees = refs[:, 1, :3] + np.random.default_rng([n, b]).normal(
            0.0, 0.05, (n, 3)).astype(np.float32)
        return tuple(self.to_array(a) for a in (
            np.zeros((n, 12), np.float32), ees, np.zeros((n, 6), np.float32)))


def same_calls(jax_calls, port_calls):
    assert len(jax_calls) == len(port_calls)
    for j, t in zip(jax_calls, port_calls):
        for k in ("refs", "x0", "f_ext"):
            assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k
        assert (j["dt"], j["kw"], j["settings"], j["cp"]) == (
            t["dt"], t["kw"], t["settings"], t["cp"])
        assert all(np.array_equal(j["hp"][k], t["hp"][k]) for k in j["hp"])


def without_card(record):
    """The record with the JAX backend's or the card's field taken out of
    every cell and of meta."""
    return {k: ({f: x for f, x in v.items() if f not in CARD_FIELDS}
                if isinstance(v, dict) else v) for k, v in record.items()}


def run_both_parity_tools(jtool, tmp_path, monkeypatch, argv):
    """Both tools' main on the same arguments, each rollout stubbed: (the JAX
    stub, the port's stub, the JAX record, the port's record)."""
    jstub, tstub = RolloutStub(jnp.asarray), RolloutStub(torch.from_numpy)
    monkeypatch.setattr(jrollout, "closed_loop_rollout", jstub)
    monkeypatch.setattr(trollout, "closed_loop_rollout", tstub)
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["parity_fig8.py", *argv, "--out", str(jout)])
    jtool.main()
    returned = parity_fig8.main([*argv, "--out", str(tout), "--device", "cpu"])
    with open(jout) as f:
        jrec = json.load(f)
    with open(tout) as f:
        trec = json.load(f)
    assert returned == trec
    assert {v["card"] for k, v in trec.items() if k != "meta"} == {"cpu"}
    return jstub, tstub, jrec, trec


@pytest.mark.parametrize("N, sqp_iters", [(8, None), (32, 3)])
def test_parity_tool_matches_the_jax_tool(jax_scripts, tmp_path, monkeypatch, N, sqp_iters):
    """Fixed-step cells at B = 1 and 3, 12 cycles: the windows, start,
    hypotheses, dt, settings, costs and hyperparameters each tool hands its
    rollout, and the records (keys with the _sqpK suffix), bit for bit."""
    argv = ["--cells", f"N{N}_B1,N{N}_B3", "--cycles", "12"]
    if sqp_iters:
        argv += ["--sqp-iters", str(sqp_iters)]
    jstub, tstub, jrec, trec = run_both_parity_tools(
        jax_scripts["tools/parity_fig8.py"], tmp_path, monkeypatch, argv)
    same_calls(jstub.calls, tstub.calls)
    assert [c["refs"].shape for c in tstub.calls] == [(12, N, 6)] * 2
    suffix = f"_sqp{sqp_iters}" if sqp_iters else ""
    assert set(trec) == {"meta", f"N{N}_B1{suffix}", f"N{N}_B3{suffix}"}
    assert without_card(trec) == without_card(jrec)


def test_parity_tool_realtime_matches_the_jax_tool(jax_scripts, tmp_path, monkeypatch):
    """The real-time branch with the solve time stubbed (bench.bench_solve
    and parity_fig8.solve_seconds, by N): 0.37 ms gives 27 solves a knot,
    0.05 ms the cap of 100; m, control_dt, sim_substeps, the windows (N
    knots m samples apart) and the records (_rt, t_solve_ms,
    solves_per_knot) equal."""
    seconds = {8: 3.7e-4, 32: 5e-5}
    monkeypatch.setattr(bench, "bench_solve", lambda N, B, solver: seconds[N])
    monkeypatch.setattr(parity_fig8, "solve_seconds", lambda N, B, *a, **k: seconds[N])
    jstub, tstub, jrec, trec = run_both_parity_tools(
        jax_scripts["tools/parity_fig8.py"], tmp_path, monkeypatch,
        ["--cells", "N8_B2,N32_B1", "--cycles", "2", "--realtime"])
    same_calls(jstub.calls, tstub.calls)
    assert [c["kw"] for c in tstub.calls] == [
        dict(control_dt=0.01 / 27, sim_substeps=1), dict(control_dt=0.01 / 100, sim_substeps=1)]
    assert [c["refs"].shape for c in tstub.calls] == [(54, 8, 6), (200, 32, 6)]
    assert (trec["N8_B2_rt"]["solves_per_knot"], trec["N32_B1_rt"]["solves_per_knot"]) == (27, 100)
    assert trec["N8_B2_rt"]["t_solve_ms"] == 0.37
    assert without_card(trec) == without_card(jrec)


class MPCStub:
    """MPC_GATO's stand-in: keeps its keyword arguments and each run's, and
    returns statistics made with numpy from the batch size (numpy arrays,
    as MPC_GATO's run_mpc_fig8 returns them)."""

    def __init__(self, calls, **kw):
        self.calls, self.B = calls, kw["batch_size"]
        calls.append({k: v for k, v in kw.items() if k != "device"})

    def run_mpc_fig8(self, x_start, fig8_traj, sim_dt=0.001, sim_time=5.0):
        self.calls.append(dict(x0=np.asarray(x_start), traj=np.asarray(fig8_traj),
                               sim_dt=sim_dt, sim_time=sim_time))
        rng, n = np.random.default_rng(self.B), int(round(sim_time / 0.01))
        return None, {"timestamps": np.arange(1, n + 1) * 0.01,
                      "solve_times": rng.uniform(0.1, 2.0, n),
                      "goal_distances": rng.uniform(0.0, 0.2, n),
                      "ee_actual": rng.normal(size=(n, 3))}


def same_mpc_calls(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
                assert np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype == np.asarray(
                    b[k]).dtype, k
            else:
                assert a[k] == b[k], k


def same_nested(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            same_nested(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("script", ["fig8_tracking", "benchmark_fig8"])
def test_mpc_scripts_match_the_jax_scripts(jax_scripts, tmp_path, monkeypatch, script):
    """fig8_tracking (B = 1 and 4 under -60 N, --save's JSON) and
    benchmark_fig8 (B = 1 and 4 under -20 N, the pickle) with MPC_GATO
    stubbed in both: the controllers' arguments and runs, the returns and
    the saved files equal."""
    jmod = jax_scripts[f"examples/{script}.py"]
    tmod = {"fig8_tracking": fig8_tracking, "benchmark_fig8": benchmark_fig8}[script]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmod, "MPC_GATO", lambda **kw: MPCStub(jcalls, **kw))
    monkeypatch.setattr(tmod, "MPC_GATO", lambda **kw: MPCStub(tcalls, **kw))
    jpath, tpath = tmp_path / "jax.out", tmp_path / "port.out"
    if script == "fig8_tracking":
        kw = dict(batch_sizes=(1, 4), fz=-60.0, N=8, sim_time=0.3)
        jres = jmod.main(save=str(jpath), **kw)
        tres = tmod.main(save=str(tpath), device="cpu", **kw)
        with open(jpath) as f:
            jrec = json.load(f)
        with open(tpath) as f:
            trec = json.load(f)
        assert trec["meta"]["card"] == "cpu"
        assert without_card(trec) == without_card(jrec)
    else:
        f_ext = np.array([0, 0, -20.0, 0, 0, 0])
        jres = jmod.run(8, [1, 4], 0.3, f_ext=f_ext, save=str(jpath))
        tres = tmod.run(8, [1, 4], 0.3, f_ext=f_ext, save=str(tpath), device="cpu")
        with open(jpath, "rb") as f:
            jrec = pickle.load(f)
        with open(tpath, "rb") as f:
            trec = pickle.load(f)
        same_nested(jrec, trec)
    same_mpc_calls(jcalls, tcalls)
    same_nested(jres, tres)


def test_bsqp_example_on_the_cpu(capsys):
    """bsqp_example.main(device="cpu"): the solve of B=16 N=16 over 5 SQP
    iterations on the plain route; it returns what it prints, finite, and
    the solved trajectories moved the first control off zero."""
    got = bsqp_example.main(device="cpu")
    out = capsys.readouterr().out
    assert f"solve time: {got['solve_time_us']} us" in out
    assert got.keys() == {"solve_time_us", "first_knot_state", "first_control", "sqp_iters",
                          "steps", "initial_merit", "final_merit", "XU"}
    assert got["XU"].shape == (16, 16 * 18 - 6) and np.isfinite(got["XU"]).all()
    assert np.array_equal(got["first_knot_state"], got["XU"][0, :12])
    assert np.array_equal(got["first_control"], got["XU"][0, 12:18])
    assert np.abs(got["first_control"]).max() > 0
    assert got["sqp_iters"].shape == (4,) and (got["sqp_iters"] >= 1).all()
    assert (got["sqp_iters"] <= 5).all() and len(got["steps"]) == 5
    assert np.isfinite([got["initial_merit"], got["final_merit"]]).all()
    assert got["final_merit"] < got["initial_merit"]


def test_entry_points_need_a_card_unless_told_cpu(tmp_path, monkeypatch):
    """With torch.cuda.is_available() false every script's entry raises
    before it builds anything, unless given device="cpu" (--device cpu),
    where the fig-8 scripts' controllers and the parity cell run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "rec.json")
    for entry in (
            lambda: parity_fig8.main(["--cells", "N8_B1", "--cycles", "1", "--out", out]),
            lambda: parity_fig8.run_cell(8, 1, 1),
            lambda: parity_fig8.solve_seconds(8, 1),
            lambda: fig8_tracking.main(batch_sizes=(1,), N=8, sim_time=0.01),
            lambda: fig8_tracking.cli(["--batch-sizes", "1", "--N", "8"]),
            lambda: benchmark_fig8.run(8, [1], 0.01),
            lambda: benchmark_fig8.cli(["--N", "8", "--batch-sizes", "1"]),
            bsqp_example.main):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            entry()
    assert not os.path.exists(out)
    rec = parity_fig8.run_cell(8, 1, 2, device="cpu")
    assert rec["cycles"] == 2 and np.isfinite(rec["avg_err_all_m"])
    assert np.isfinite(fig8_tracking.cli(
        ["--batch-sizes", "1", "--N", "8", "--sim-time", "0.02", "--device", "cpu"])[1])
    res = benchmark_fig8.cli(["--N", "8", "--batch-sizes", "1", "--sim-time", "0.02",
                              "--device", "cpu"])
    assert np.isfinite(res[1]["avg_error_m"])
