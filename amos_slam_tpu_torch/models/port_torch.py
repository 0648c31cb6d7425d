"""YOLACT weights: the reference's ``.pth`` names and the JAX package's
Flax names (port of models/port_torch.py).

The port's modules carry the reference's PyTorch names, so a reference
checkpoint (``yolact_base_54_800000.pth``, src/System.cc:106-108) loads
into :class:`..models.yolact.Yolact` as it is: :func:`load_pth` only keeps
the keys the model has. :func:`name_map` is the pairing of Flax parameter
paths and PyTorch keys that the JAX package's ``port_state_dict`` applies;
``convert.yolact_state_dict`` runs it backwards. Torch convs are
(out, in, kh, kw); Flax kernels are (kh, kw, in, out).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

# batch norm fields: Flax name -> PyTorch name
BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# the FPN's laterals and smoothing convs are applied to C5..C3 in reversed
# order: lat_layers.0 pairs with C5 (Flax lat2), pred_layers.0 with P5
FPN_NAMES = {
    "lat2": "fpn.lat_layers.0", "lat1": "fpn.lat_layers.1", "lat0": "fpn.lat_layers.2",
    "pred2": "fpn.pred_layers.0", "pred1": "fpn.pred_layers.1", "pred0": "fpn.pred_layers.2",
    "down0": "fpn.downsample_layers.0", "down1": "fpn.downsample_layers.1",
}
# ProtoNet: the reference Sequential's indices of its convs
PROTO_NAMES = {"conv0": "proto_net.0", "conv1": "proto_net.2", "conv2": "proto_net.4",
               "conv3": "proto_net.8", "conv4": "proto_net.10"}
HEAD_NAMES = {
    "upfeature": "prediction_layers.0.upfeature.0", "bbox": "prediction_layers.0.bbox_layer",
    "conf": "prediction_layers.0.conf_layer", "mask": "prediction_layers.0.mask_layer",
}


def name_map(layers: Sequence[int] = (3, 4, 6, 3)) -> List[Tuple[Tuple[str, ...], str]]:
    """(Flax path under ``params``, PyTorch key) for every tensor of the
    model with this backbone."""
    out = []

    def conv(path, key, bias=True):
        out.append((path + ("kernel",), f"{key}.weight"))
        if bias:
            out.append((path + ("bias",), f"{key}.bias"))

    def bn(path, key):
        out.extend((path + (f,), f"{key}.{t}") for f, t in BN_FIELDS.items())

    conv(("backbone", "conv1"), "backbone.conv1", bias=False)
    bn(("backbone", "bn1"), "backbone.bn1")
    for s, n in enumerate(layers):
        for b in range(n):
            path, key = ("backbone", f"layer{s}_{b}"), f"backbone.layers.{s}.{b}"
            for i in (1, 2, 3):
                conv(path + (f"conv{i}",), f"{key}.conv{i}", bias=False)
                bn(path + (f"bn{i}",), f"{key}.bn{i}")
            if b == 0:
                conv(path + ("down_conv",), f"{key}.downsample.0", bias=False)
                bn(path + ("down_bn",), f"{key}.downsample.1")
    for group, names in (("fpn", FPN_NAMES), ("proto_net", PROTO_NAMES),
                         ("pred_head", HEAD_NAMES)):
        for flax_name, key in names.items():
            conv((group, flax_name), key)
    return out


def load_pth(path: str, layers: Sequence[int] = (3, 4, 6, 3)) -> Dict[str, torch.Tensor]:
    """A reference checkpoint as the port's ``state_dict`` (f32, CPU): the
    keys the model has, nothing else (``num_batches_tracked`` and
    training-only heads such as ``semantic_seg_conv`` are dropped). Raises
    ``KeyError`` naming any key the checkpoint lacks."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    keys = [key for _, key in name_map(layers)]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} YOLACT keys, e.g. {missing[:3]}")
    return {k: sd[k].to(torch.float32) for k in keys}

