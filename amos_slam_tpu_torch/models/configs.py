"""YOLACT configuration registry (port of models/configs.py).

The reference's named training configurations (src/python/config.py:88
yolact_base_config / yolact_im400_config / yolact_resnet50_config /
yolact_im700_config) as frozen dataclasses with the JAX package's values:
one object read by model construction, prior generation, the data
pipeline and the train step. ``lr_steps``, ``lr_gamma`` and ``max_iter``
are kept as data; the train step, like the JAX package's, uses a constant
learning rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..device import resolve_device
from .yolact import Yolact, make_priors


@dataclass(frozen=True)
class YolactConfig:
    name: str = "yolact_base"
    img_size: int = 550
    num_classes: int = 81                 # 80 COCO + background
    backbone_layers: Tuple[int, ...] = (3, 4, 23, 3)   # ResNet-101
    max_objs: int = 16                    # padded gt per image
    proto_hw: Tuple[int, int] = (138, 138)
    # training schedule (reference: SGD momentum 0.9, wd 5e-4, lr 1e-3
    # with step decays at fixed iterations)
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_steps: Tuple[int, ...] = (280000, 600000, 700000, 750000)
    lr_gamma: float = 0.1
    max_iter: int = 800000
    batch_size: int = 8

    def build(self, *, device=None) -> Yolact:
        """The port's :class:`Yolact` for this config, in f32 on ``device``
        (the CUDA card by default), with torch's default init."""
        return Yolact(num_classes=self.num_classes,
                      backbone_layers=self.backbone_layers).to(resolve_device(device))

    def priors(self):
        return make_priors(self.img_size)

    @property
    def proto_shape(self):
        # ProtoNet upsamples P3 (stride 8) 2x -> stride 4
        s = self.img_size // 4 + (1 if self.img_size % 4 else 0)
        return (s, s)


_REGISTRY = {}


def register(cfg: YolactConfig) -> YolactConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# the reference's named configs (src/python/config.py:720-850)
yolact_base = register(YolactConfig())
yolact_resnet50 = register(
    YolactConfig(name="yolact_resnet50", backbone_layers=(3, 4, 6, 3))
)
yolact_im400 = register(
    YolactConfig(name="yolact_im400", img_size=400)
)
yolact_im700 = register(
    YolactConfig(name="yolact_im700", img_size=700)
)
# tiny config for tests / synthetic training proofs
yolact_tiny = register(
    YolactConfig(
        name="yolact_tiny",
        img_size=128,
        num_classes=4,                    # 3 shapes + background
        backbone_layers=(1, 1, 1, 1),
        max_objs=4,
        lr=2e-3,
        batch_size=8,
    )
)


def get_config(name: str) -> YolactConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown YOLACT config {name!r}; known: {sorted(_REGISTRY)}"
        )
