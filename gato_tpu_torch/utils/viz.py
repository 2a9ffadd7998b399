"""Robot / trajectory visualization.

Port of gato_tpu/utils/viz.py. The reference visualizes pick-and-place
rollouts with meshcat (its examples/gato_pickplace.ipynb: MeshcatVisualizer
over the URDF meshes). Mesh assets are not bundled here, so the primary
path is a dependency-light matplotlib skeleton view built from the port's
FK (dynamics/algorithms.py::fk, ee_position); a meshcat path is provided
behind a gated import for environments that have it. matplotlib is
imported inside plot_rollout, so the module imports where it is missing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dynamics.algorithms import ee_position, fk
from ..robots.model import RobotModel


def _q(model: RobotModel, q):
    """q (array-like or tensor) as a tensor of the model's dtype on its device."""
    return torch.as_tensor(q, dtype=model.R_tree.dtype, device=model.R_tree.device)


def skeleton_points(model: RobotModel, q):
    """World positions of base + every joint frame + EE: (nq + 2, 3),
    numpy."""
    q = _q(model, q)
    _, ps = fk(model, q)
    ee = ee_position(model, q)[:3]
    return np.concatenate([np.zeros((1, 3)), ps.cpu().numpy(),
                           ee.cpu().numpy()[None]], axis=0)


def plot_rollout(model: RobotModel, qs, ref=None, path=None, stride=None,
                 elev=22.0, azim=35.0):
    """Render a closed-loop rollout as a 3D skeleton strip + EE trace.

    qs: (T, nq) joint trajectory; ref: optional (T, >=3) EE reference to
    overlay; path: output PNG (interactive window otherwise); stride: plot
    every stride-th configuration (default ~8 frames).
    Returns the matplotlib figure.
    """
    import matplotlib
    if path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    qs = np.asarray(qs)
    T = qs.shape[0]
    stride = stride or max(1, T // 8)
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")

    ee_trace = ee_position(model, _q(model, qs))[:, :3].cpu().numpy()
    ax.plot(*ee_trace.T, color="tab:blue", lw=1.5, label="EE path")
    if ref is not None:
        ref = np.asarray(ref)
        ax.plot(ref[:, 0], ref[:, 1], ref[:, 2], "--", color="tab:gray",
                lw=1.0, label="reference")

    for i, t in enumerate(range(0, T, stride)):
        pts = skeleton_points(model, qs[t])
        a = 0.25 + 0.75 * (t / max(1, T - 1))
        ax.plot(*pts.T, "-o", color="tab:red", ms=2.5, lw=1.2, alpha=a,
                label="robot" if i == 0 else None)

    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.view_init(elev=elev, azim=azim)
    ax.legend(loc="upper left")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def meshcat_rollout(model: RobotModel, qs, dt=0.01, zmq_url=None):
    """Animate a rollout in meshcat (if installed) as a line skeleton —
    the reference notebook's viewer role without bundled meshes."""
    try:
        import meshcat
        import meshcat.geometry as g
    except ImportError as e:  # pragma: no cover - meshcat not in CI image
        raise ImportError(
            "meshcat is not installed; use plot_rollout for the "
            "matplotlib path") from e
    import time

    vis = meshcat.Visualizer(zmq_url=zmq_url) if zmq_url else \
        meshcat.Visualizer()
    for t, q in enumerate(np.asarray(qs)):  # pragma: no cover
        pts = skeleton_points(model, q).T.astype(np.float32)
        vis["robot"].set_object(
            g.Line(g.PointsGeometry(pts),
                   g.MeshBasicMaterial(color=0xcc3333)))
        time.sleep(dt)
    return vis
