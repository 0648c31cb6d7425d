"""Stage-one semantic segmenter: RGB frames -> dynamic-object (person)
masks (port of models/segmenter.py).

The reference resizes a frame to the net size, runs YOLACT, keeps the
detections above score 0.15 (top 15) and sums the class-0 "person" masks
into one mask (src/yolact.cc:203-318, src/python/yolact_interface.py:
806-890). Here one call is one batched forward plus batched detection on
the card, with no host read: its (B, H, W) bool masks go straight to
``System.track_rgbd_chunk(seg_masks=...)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..utils.profiling import span
from .yolact import (IMG_SIZE, MEANS, STD, Resize, Yolact, assemble_masks, detect,
                     make_priors)


def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialization, in place: conv kernels lecun-normal
    (a normal truncated at +-2 standard deviations, scaled to variance
    1 / fan_in), conv biases 0; batch norm stays at scale 1, bias 0, mean
    0, variance 1. Draws from ``generator`` (a CPU generator) in module
    order."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class Segmenter:
    """YOLACT wrapper producing per-frame dynamic masks.

    Args:
      params: a state_dict of :class:`Yolact` (from ``port_torch.load_pth``
        or ``convert.yolact_state_dict``). Random init (Flax's
        distributions, drawn from ``generator``, default seed 0) if None.
      person_classes: class ids treated as dynamic (reference: person = 0).
      compute_dtype: the net's dtype (bf16 by default); the weights are cast
        to it once, here. Detection and mask assembly run in f32.
      img_size: the net's input size: 550 is the reference's yolact_base,
        400 its yolact_im400; the same weights serve either.
      device: the CUDA card by default; ``"cpu"`` runs the plain path.
    """

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 num_classes: int = 81, person_classes: Tuple[int, ...] = (0,),
                 score_th: float = 0.15, top_k: int = 15,
                 compute_dtype: torch.dtype = torch.bfloat16, img_size: int = IMG_SIZE,
                 *, device=None):
        self.device = resolve_device(device)
        self.score_th = score_th
        self.top_k = top_k
        self.person_classes = person_classes
        self.img_size = img_size
        self.compute_dtype = compute_dtype
        model = Yolact(num_classes=num_classes)
        if params is None:
            flax_init_(model, generator if generator is not None
                       else torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(params)
        self.model = model.requires_grad_(False).to(self.device, compute_dtype).eval()
        dev = self.device
        self.priors = torch.from_numpy(make_priors(img_size)).to(dev)
        self._pc = torch.tensor(person_classes, dtype=torch.int32, device=dev)
        self._means = torch.from_numpy(MEANS).to(dev)[:, None, None]
        # jit divides by the constant std as a product with its f32 reciprocal
        self._inv_std = torch.from_numpy(np.float32(1.0) / STD).to(dev)[:, None, None]
        self._resize_in = Resize(h_first=False)
        self._resize_out = Resize(h_first=True)

    def person_mask(self, rgb) -> torch.Tensor:
        """(H, W, 3) RGB image (uint8 or float [0, 255], array or tensor)
        -> (H, W) bool on the segmenter's device."""
        return self._masks(self._upload(rgb)[None])[0]

    def person_mask_batch(self, rgbs) -> torch.Tensor:
        """(B, H, W, 3) RGB images -> (B, H, W) bool masks, one forward."""
        return self._masks(self._upload(rgbs))

    def _upload(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, torch.float32)

    def raw(self, rgbs) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) RGB images -> the net's (loc, conf, coef, proto),
        cast to f32: what detection reads."""
        with span("slam.segmenter.net"):
            rgbs = self._upload(rgbs)
            size = (self.img_size, self.img_size)
            img = self._resize_in(rgbs.permute(0, 3, 1, 2), size)    # (B, 3, S, S) RGB
            x = ((img.flip(1) - self._means) * self._inv_std).to(self.compute_dtype)
            return tuple(t.float() for t in self.model(x))

    def _masks(self, rgbs: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = rgbs.shape
        loc, conf, coef, proto = self.raw(rgbs)
        with span("slam.segmenter.masks"):
            det = detect(loc, conf, coef, self.priors, top_k=self.top_k, conf_th=self.score_th)
            is_person = (det.classes[..., None] == self._pc).any(dim=-1)
            masks = assemble_masks(proto, det) & (is_person & det.valid)[..., None, None]
            union = masks.any(dim=1).float()
            return self._resize_out(union, (H, W)) > 0.5
