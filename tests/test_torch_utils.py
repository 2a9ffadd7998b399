"""The port's utils (gato_tpu_torch/utils/) on the CPU, against the JAX
package's (gato_tpu/utils/) where both compute the same thing:

- csvio: the port writes and both read back the same file (and the JAX
  package's file reads back in the port), ragged rows raise alike;
- check_batch_trajs_match against the JAX one on matching and deviating
  batches;
- viz.skeleton_points against the JAX one (float32 FK on both sides;
  within 1e-6 m);
- profiling.trace writes a Chrome trace that holds an annotate span;
- the timers return positive seconds for a CPU function, timed by the host
  clock, and refuse a CUDA graph there.
"""

import json
import os

import numpy as np
import pytest
import torch

from gato_tpu.robots.model import load_robot as jax_load_robot
from gato_tpu.utils import csvio as jcsvio
from gato_tpu.utils import debug as jdebug
from gato_tpu.utils import viz as jviz
from gato_tpu_torch.robots.model import load_robot
from gato_tpu_torch.utils import csvio, debug, profiling, timing, viz


def test_csvio_round_trip_against_the_jax_package(tmp_path):
    """A matrix written by either package reads back equal in both; flat
    and row reads agree; ragged rows raise ValueError in both."""
    a = np.random.default_rng(0).uniform(-1, 1, (7, 6))
    mine, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
    csvio.write_csv_matrix(mine, a)
    jcsvio.write_csv_matrix(theirs, a)
    assert mine.read_text() == theirs.read_text()
    for read in (csvio.read_csv_matrix, jcsvio.read_csv_matrix):
        np.testing.assert_array_equal(read(mine, np.float64), a)
    np.testing.assert_array_equal(csvio.read_csv_flat(theirs), jcsvio.read_csv_flat(mine))
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("1,2,3\n\n4,5\n")
    for mod in (csvio, jcsvio):
        rows = mod.read_csv_rows(ragged)
        assert [r.tolist() for r in rows] == [[1, 2, 3], [4, 5]]
        with pytest.raises(ValueError, match="ragged"):
            mod.read_csv_matrix(ragged)


def test_check_batch_trajs_match_against_the_jax_package():
    """Equal lanes, a lane off by less than atol, and one off by more:
    both packages' checks say the same."""
    XU = np.tile(np.random.default_rng(1).uniform(size=(1, 20)), (4, 1))
    off = XU.copy()
    off[2, 5] += 1e-3
    for batch, atol in ((XU, 0.0), (off, 1e-2), (off, 1e-4), (off, 0.0)):
        want = jdebug.check_batch_trajs_match(batch, atol=atol, verbose=False)
        assert debug.check_batch_trajs_match(batch, atol=atol, verbose=False) == want
    assert not debug.check_batch_trajs_match(off, verbose=False)


@pytest.mark.parametrize("robot", ("indy7", "iiwa14"))
def test_skeleton_points_against_the_jax_package(robot):
    """Base, joint frames and EE from the port's FK against the JAX
    package's, float32 both (the JAX one casts q to float32): within 1e-6
    m, float32's rounding over a chain of 6-7 transforms of about 1 m."""
    jm = jax_load_robot(robot)
    tm = load_robot(robot, torch.float32, "cpu")
    for q in np.random.default_rng(2).uniform(-1.5, 1.5, (3, tm.nq)):
        got, want = viz.skeleton_points(tm, q), jviz.skeleton_points(jm, q)
        assert got.shape == want.shape == (tm.nq + 2, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    """trace() over an annotated matmul writes log_dir/trace.json, whose
    events include the annotate span."""
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        with profiling.annotate("gato_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "gato_span" for e in events)


def test_timers_on_the_cpu():
    """Each timer gives positive seconds a call for a CPU function (host
    clock), chained or not; graph=True asks for the card."""
    a = torch.ones(16, 16)
    assert timing.time_fn(lambda x: x @ x, (a,), k=3, trials=2) > 0
    assert timing.time_fn_ms(lambda x: (x @ x) / 16, (a,), chain=lambda args, out: (out,),
                             k=3, trials=2) > 0
    assert timing.time_loop_fn(lambda k: [a @ a for _ in range(k)][-1], k=3, trials=2) > 0
    assert timing.time_scan_fn(lambda k: (lambda x: [x @ x for _ in range(k)][-1], (a,)),
                               k=3, trials=2) > 0
    with pytest.raises(ValueError, match="on the card"):
        timing.time_fn(lambda x: x, (a,), graph=True)
