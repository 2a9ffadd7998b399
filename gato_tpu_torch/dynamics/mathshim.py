"""Elementwise math for the channel trace, dispatched on the channel type.

A channel is a torch tensor (the plain PyTorch path), a Python number (a
constant folded at trace time) or a symbolic channel from
`dynamics/codegen.py`, which records the op as one line of C++. The shim
keeps `channelized.py`, `ops/merit_fast.py` and `ops/kkt_fast.py` free of
any one backend.
"""

from __future__ import annotations

import math

import torch


def _unary(name, torch_fn, math_fn):
    def fn(x):
        if isinstance(x, torch.Tensor):
            return torch_fn(x)
        if isinstance(x, (int, float)):
            return math_fn(x)
        return x.apply(name)

    fn.__name__ = name
    return fn


sqrt = _unary("sqrt", torch.sqrt, math.sqrt)
sin = _unary("sin", torch.sin, math.sin)
cos = _unary("cos", torch.cos, math.cos)
log = _unary("log", torch.log, math.log)
abs = _unary("abs", torch.abs, lambda x: math.fabs(x))  # noqa: A001


def maximum(x, c: float):
    """max(x, c) with a constant floor c; NaN propagates (as jnp.maximum)."""
    if isinstance(x, torch.Tensor):
        return torch.clamp_min(x, c)
    if isinstance(x, (int, float)):
        return max(x, c)
    return x.apply("max", c)
