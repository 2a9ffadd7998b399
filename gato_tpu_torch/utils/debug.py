"""Debug invariants (the reference's gato/utils/utils.h analogues). A copy
of gato_tpu/utils/debug.py: numpy only (a tensor on the card is copied to
the host by np.asarray's caller: pass t.cpu())."""

from __future__ import annotations

import numpy as np


def check_batch_trajs_match(XU_B, atol: float = 0.0, verbose: bool = True):
    """All batch lanes identical (checkIfBatchTrajsMatch, utils.h:53-71):
    the natural correctness oracle when every lane gets identical inputs."""
    XU_B = np.asarray(XU_B)
    ref = XU_B[0]
    ok = True
    for b in range(1, XU_B.shape[0]):
        d = np.abs(XU_B[b] - ref).max()
        if d > atol:
            ok = False
            if verbose:
                print(f"lane {b} deviates from lane 0 by {d}")
    return ok
