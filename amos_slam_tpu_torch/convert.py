"""Move state between the JAX package and the port as numpy arrays.

The JAX package keeps its state in NamedTuples of arrays (FrameFeatures,
Keypoints, PoseObs, ...). The port has NamedTuples of the same names and
fields, holding tensors. These helpers turn one into the other through
numpy, so a test can feed both packages identical state; this module never
imports jax (``np.asarray`` reads a jax array).
"""

from __future__ import annotations

import typing
from typing import Any, Mapping

import numpy as np
import torch

from .geometry.camera import Camera


def _fields(tree) -> Mapping[str, Any]:
    return tree._asdict() if hasattr(tree, "_asdict") else tree


def camera_from_numpy(d, device="cuda") -> Camera:
    """A :class:`Camera` from a mapping (or Camera-like NamedTuple) of
    fx, fy, cx, cy, dist, bf arrays and width, height ints."""
    d = _fields(d)
    t = {
        k: torch.as_tensor(np.array(d[k], np.float32), device=device)
        for k in ("fx", "fy", "cx", "cy", "dist", "bf")
    }
    return Camera(width=int(d["width"]), height=int(d["height"]), **t)


def tree_from_numpy(cls, tree, device):
    """An instance of the port's NamedTuple ``cls`` from a mapping or a
    NamedTuple with the same field names, whose leaves are arrays. Nested
    NamedTuple fields (e.g. FrameFeatures.kp) convert recursively; dtypes
    are kept (f32, int32, int8, bool)."""
    hints = typing.get_type_hints(cls)
    values = _fields(tree)
    out = {}
    for name in cls._fields:
        v, hint = values[name], hints.get(name)
        if isinstance(hint, type) and issubclass(hint, tuple) and hasattr(hint, "_fields"):
            out[name] = tree_from_numpy(hint, v, device)
        elif hint is int:
            out[name] = int(v)
        else:
            out[name] = torch.from_numpy(np.array(v)).to(device)
    return cls(**out)


def tree_to_numpy(tree) -> dict:
    """Inverse of :func:`tree_from_numpy`: a dict of numpy arrays (nested
    dicts for nested NamedTuples, ints stay ints)."""
    out = {}
    for name, v in _fields(tree).items():
        if isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        elif hasattr(v, "_asdict"):
            out[name] = tree_to_numpy(v)
        else:
            out[name] = v
    return out
