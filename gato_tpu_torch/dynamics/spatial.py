"""Spatial (Plücker) algebra primitives, batched over leading dimensions.

Port of gato_tpu/dynamics/spatial.py. Conventions follow Featherstone:
motion vectors are [w; v], force vectors are [n; f]. Transforms are carried
as (E, r) pairs (rotation child<-parent, child origin in the parent frame)
instead of 6x6 Plücker matrices. The JAX package's exact-float32 unrolled
products (ops/batch_linalg.py) are a TPU workaround: here products are
torch.matmul, with TF32 off on the card.
"""

from __future__ import annotations

import torch


def cross(a, b):
    """a x b over the last axis; the leading dimensions broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def mv(M, v):
    """(..., m, n) @ (..., n) -> (..., m)."""
    return (M @ v[..., None])[..., 0]


def mtv(M, v):
    """M^T v: (..., n, m), (..., n) -> (..., m)."""
    return mv(M.mT, v)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def rodrigues(axis, q):
    """Rotation about a fixed unit axis by angle q. axis (..., 3) and q (...)
    broadcast -> (..., 3, 3)."""
    c = torch.cos(q)[..., None, None]
    s = torch.sin(q)[..., None, None]
    K = skew(axis)
    return torch.eye(3, dtype=axis.dtype, device=axis.device) + s * K + (1.0 - c) * (K @ K)


def xm_apply(E, r, m):
    """Motion transform child<-parent applied to a motion vector:
    [E w ; E (v - r x w)]."""
    w, v = m[..., :3], m[..., 3:]
    return torch.cat([mv(E, w), mv(E, v - cross(r, w))], -1)


def xf_apply_T(E, r, f):
    """Force accumulation to the parent, X^T f (X the motion transform
    child<-parent): n_p = E^T n + r x (E^T f), f_p = E^T f."""
    n, fl = f[..., :3], f[..., 3:]
    Etf = mtv(E, fl)
    return torch.cat([mtv(E, n) + cross(r, Etf), Etf], -1)


def crm(v, m):
    """Motion cross product v x m = [w x mw ; w x mv + vl x mw]."""
    w, vl = v[..., :3], v[..., 3:]
    mw, mvl = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mvl) + cross(vl, mw)], -1)


def crf(v, f):
    """Force cross product v x* f = [w x n + vl x fl ; w x fl]."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)], -1)


def imul(I6, v):
    """Spatial inertia times motion vector."""
    return mv(I6, v)


def motion_transform(E, r):
    """The 6x6 motion transform child<-parent [[E, 0], [-E skew(r), E]]."""
    lower = -E @ skew(r)
    E = E.expand_as(lower)
    return torch.cat([torch.cat([E, torch.zeros_like(E)], -1),
                      torch.cat([lower, E], -1)], -2)


def xform_to_parent_inertia(E, r, I6):
    """X^T I X with X the motion transform child<-parent: a child spatial
    inertia in the parent frame (the CRBA's composite buildup)."""
    X = motion_transform(E, r)
    return X.mT @ I6 @ X
