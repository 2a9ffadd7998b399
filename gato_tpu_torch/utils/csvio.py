"""CSV trajectory IO (gato/utils/utils.h:9-51 readCSVToVec /
readCSVToVecVec analogues). A copy of gato_tpu/utils/csvio.py: numpy only.

The reference feeds precomputed reference trajectories to its example binary
from comma-separated files (one knot per line); these helpers load the same
files into arrays for the solver's (N, k) reference windows, and write
solved trajectories back out for external tooling. Ragged rows are allowed
on read (readCSVToVecVec keeps per-row lengths); `read_csv_matrix` demands a
rectangle since the solver consumes fixed shapes.
"""

from __future__ import annotations

import numpy as np


def read_csv_flat(path, dtype=np.float32):
    """Every comma-separated value in file order as one 1-D array
    (readCSVToVec). Empty lines are skipped."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals.extend(float(v) for v in line.split(","))
    return np.asarray(vals, dtype=dtype)


def read_csv_rows(path, dtype=np.float32):
    """List of per-line 1-D arrays, possibly ragged (readCSVToVecVec)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append(np.asarray([float(v) for v in line.split(",")],
                                   dtype=dtype))
    return rows


def read_csv_matrix(path, dtype=np.float32):
    """(rows, cols) array; raises ValueError on ragged rows (the solver's
    reference windows are fixed-shape)."""
    rows = read_csv_rows(path, dtype=dtype)
    if not rows:
        return np.zeros((0, 0), dtype=dtype)
    w = rows[0].shape[0]
    if any(r.shape[0] != w for r in rows):
        raise ValueError(f"ragged CSV rows in {path}: "
                         f"{sorted({r.shape[0] for r in rows})} columns")
    return np.stack(rows)


def write_csv_matrix(path, arr):
    """One comma-separated line per row (the inverse of read_csv_matrix);
    accepts any array-like convertible to 2-D."""
    a = np.asarray(arr)
    if a.ndim != 2:
        raise ValueError(f"expected 2-D, got shape {a.shape}")
    with open(path, "w") as f:
        for row in a:
            f.write(",".join(repr(float(v)) for v in row) + "\n")
