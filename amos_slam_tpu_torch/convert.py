"""Move state between the JAX package and the port as numpy arrays.

The JAX package keeps its state in NamedTuples of arrays (FrameFeatures,
Keypoints, PoseObs, MapArrays, ...). The port has NamedTuples of the same
names and fields, holding tensors. These helpers turn one into the other
through numpy, so a test can feed both packages identical state; this module
never imports jax (``np.asarray`` reads a jax array). :func:`slam_map_from`
carries a whole map across, device arrays and host mirrors;
:func:`vocabulary_from` a BoW vocabulary; :func:`yolact_state_dict` YOLACT
weights; :func:`train_state_from` a YOLACT training state.
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


_MAP_HOST_ARRAYS = ("kf_obs_np", "kf_frame_id", "kf_alive", "covis",
                    "pt_obs_count", "pt_birth_kf", "pt_alive", "kf_parent",
                    "slot_uid")
_MAP_HOST_INTS = ("K", "M", "N", "V", "n_kfs", "n_pts", "version", "kf_uid_next")


def slam_map_from(src, cfg, cam: Camera, device):
    """The port's :class:`SlamMap` holding the same state as ``src``, a
    JAX-package SlamMap (read duck-typed: its ``arrays`` NamedTuple and its
    host mirrors). Device arrays go through :func:`tree_from_numpy`; host
    mirrors are copied; cull-time poses become tensors."""
    from .slam_map.map_state import MapArrays
    from .slam_map.slam_map import SlamMap

    m = SlamMap(cfg, cam, device)
    m.arrays = tree_from_numpy(MapArrays, src.arrays, device)
    for name in _MAP_HOST_INTS:
        setattr(m, name, int(getattr(src, name)))
    for name in _MAP_HOST_ARRAYS:
        setattr(m, name, np.array(getattr(src, name)))

    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    m.uid_cull = {int(u): (int(p), tensor(T)) for u, (p, T) in src.uid_cull.items()}
    m.loop_edges = [(int(i), int(j), np.array(T), float(s))
                    for (i, j, T, s) in src.loop_edges]
    m.culled_log = [int(k) for k in src.culled_log]
    return m


def vocabulary_from(src, device=None):
    """The port's :class:`~.loop.vocabulary.Vocabulary` holding the same
    tree as ``src``, a JAX-package Vocabulary (read duck-typed), on
    ``device`` (the CUDA card by default)."""
    from .device import resolve_device
    from .loop.vocabulary import Vocabulary

    device = resolve_device(device)

    return Vocabulary(
        k=int(src.k), depth=int(src.depth),
        levels=tuple(torch.from_numpy(np.array(l, np.int8)).to(device) for l in src.levels),
        node_valid=tuple(torch.from_numpy(np.array(v, bool)).to(device)
                         for v in src.node_valid),
        idf=torch.from_numpy(np.array(src.idf, np.float32)).to(device),
    )


def yolact_state_dict(flax_params) -> dict:
    """The port's YOLACT ``state_dict`` (f32 CPU tensors; float64 leaves,
    from a JAX tree made with x64 enabled, stay float64) holding the JAX
    package's Yolact parameters (a ``{"params": ...}`` tree of arrays):
    the inverse of the JAX package's ``port_state_dict``. Conv kernels go
    from (kh, kw, in, out) to (out, in, kh, kw); batch norm's
    scale/bias/mean/var become weight/bias/running_mean/running_var; the
    FPN's reversed pairing and ProtoNet's indices are undone
    (``models.port_torch.name_map``)."""
    from .models.port_torch import name_map

    tree = flax_params["params"]
    layers = []     # blocks per stage, from the backbone's layer{s}_{b} names
    while f"layer{len(layers)}_0" in tree["backbone"]:
        n = 0
        while f"layer{len(layers)}_{n}" in tree["backbone"]:
            n += 1
        layers.append(n)
    out = {}
    for path, key in name_map(layers):
        leaf = tree
        for name in path:
            leaf = leaf[name]
        a = np.array(leaf)
        a = a if a.dtype == np.float64 else a.astype(np.float32)
        if path[-1] == "kernel":
            a = np.transpose(a, (3, 2, 0, 1))
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def train_state_from(jax_train_state, *, device=None):
    """The port's :class:`~.models.train.TrainState` holding the JAX
    package's YOLACT ``TrainState`` (read duck-typed), on ``device`` (the
    CUDA card by default): the params through :func:`yolact_state_dict`,
    optax's momentum trace (the ``TraceState`` inside the chain's state)
    under the same keys, and the step count."""
    from .device import resolve_device
    from .models.train import TrainState

    device = resolve_device(device)

    def find_trace(state):
        if hasattr(state, "trace"):
            return state.trace
        for sub in state if isinstance(state, tuple) else ():
            found = find_trace(sub)
            if found is not None:
                return found
        return None

    trace = find_trace(jax_train_state.opt_state)
    if trace is None:
        raise ValueError("the optimizer state holds no momentum trace")

    def on_device(tree):
        return {k: v.to(device) for k, v in yolact_state_dict(tree).items()}

    return TrainState(on_device(jax_train_state.params), on_device(trace),
                      torch.tensor(int(np.asarray(jax_train_state.step)), dtype=torch.int32,
                                   device=device))


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
