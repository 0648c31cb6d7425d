"""YOLACT data pipeline: COCO loading, SSD augmentations, static batching
(port of models/data.py).

The reference's training data stack (src/python/data/coco.py
COCODetection, src/python/utils/augmentations.py SSDAugmentation,
src/python/data/__init__.py detection_collate), as the JAX package has it:

* all decode/augment work is HOST-side numpy/PIL (like the reference's
  cv2 pipeline) so the device only ever sees one padded, static-shaped
  :class:`~.train.GTBatch` per step. Every random draw is the JAX
  package's, from the same numpy generator in the same order, so a loader
  with the same seed yields the same batches; only the images' layout
  differs: (B, 3, S, S) for the NCHW :class:`~.yolact.Yolact`;
* COCO mask decoding (polygon rasterization + both RLE forms) is
  implemented clean-room from the COCO annotation spec (pycocotools is
  not a dependency); polygons and image decoding use PIL, imported where
  they are used;
* a background-thread prefetcher overlaps host decode/augment with the
  device step, the dataloader-worker analogue of the reference's
  torch DataLoader(num_workers=...).

A synthetic shapes dataset with exact ground-truth masks is provided for
training proofs and CI (no COCO images are in the repository).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import span
from .train import GTBatch
from .yolact import MEANS, STD


# ---------------------------------------------------------------------------
# COCO mask decoding (clean-room from the COCO annotation format spec)
# ---------------------------------------------------------------------------

def decode_uncompressed_rle(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """COCO uncompressed RLE: alternating run lengths of 0s/1s in
    COLUMN-major order."""
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string: LEB128-style base-48 varints (offset by
    48 into printable ASCII), with difference coding from the 3rd run on."""
    runs: List[int] = []
    i = 0
    n = len(counts)
    while i < n:
        x, k, more = 0, 0, True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return decode_uncompressed_rle(runs, h, w)


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon annotations ([x0,y0,x1,y1,...] lists)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        if len(poly) >= 6:
            draw.polygon([float(v) for v in poly], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def annotation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """COCO 'segmentation' field (polygons or RLE dict) -> (h, w) uint8."""
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    counts = segm["counts"]
    hh, ww = segm["size"]
    if isinstance(counts, str):
        return decode_compressed_rle(counts, hh, ww)
    return decode_uncompressed_rle(counts, hh, ww)


# ---------------------------------------------------------------------------
# datasets: a sample is a dict with
#   image: (H, W, 3) uint8 RGB
#   boxes: (G, 4) float32 pixel xyxy
#   labels: (G,) int32 0-based contiguous class ids
#   masks: (G, H, W) uint8 {0, 1}
# ---------------------------------------------------------------------------

class CocoDataset:
    """COCO-format instance segmentation dataset (reference COCODetection,
    src/python/data/coco.py): instances json + an image directory. Category
    ids are remapped to contiguous 0-based labels; crowd annotations are
    dropped (the reference trains without them by default)."""

    def __init__(
        self,
        image_dir: str,
        ann_file: str,
        class_names: Optional[Sequence[str]] = None,
    ):
        self.image_dir = image_dir
        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        if class_names:
            keep = set(class_names)
            cats = [c for c in cats if c["name"] in keep]
        self.cat_remap = {c["id"]: i for i, c in enumerate(cats)}
        self.class_names = [c["name"] for c in cats]
        self.images = {im["id"]: im for im in coco["images"]}
        self.by_image: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0) or a["category_id"] not in self.cat_remap:
                continue
            self.by_image.setdefault(a["image_id"], []).append(a)
        # train only on images that have at least one usable annotation
        self.ids = [i for i in self.images if self.by_image.get(i)]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        img_id = self.ids[idx]
        info = self.images[img_id]
        path = os.path.join(self.image_dir, info["file_name"])
        image = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        h, w = image.shape[:2]
        anns = self.by_image[img_id]
        boxes, labels, masks = [], [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            if bw <= 1 or bh <= 1:
                continue
            boxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat_remap[a["category_id"]])
            masks.append(annotation_to_mask(a["segmentation"], h, w))
        if not boxes:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
            masks = np.zeros((0, h, w), np.uint8)
        return {
            "image": image,
            "boxes": np.asarray(boxes, np.float32),
            "labels": np.asarray(labels, np.int32),
            "masks": np.asarray(masks, np.uint8),
        }


class SyntheticShapes:
    """Random shapes with exact instance masks (circle / square / triangle
    as 3 classes) on textured backgrounds. Deterministic per (seed, index):
    the CI-able stand-in for COCO used by the training-proof tests."""

    class_names = ("circle", "square", "triangle")

    def __init__(self, n: int = 256, size: int = 128, max_shapes: int = 3,
                 seed: int = 0):
        self.n = n
        self.size = size
        self.max_shapes = max_shapes
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        S = self.size
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
        image = rng.uniform(20, 60, (S, S, 3)).astype(np.float32)
        image += rng.normal(0, 6, (S, S, 3))
        boxes, labels, masks = [], [], []
        for _ in range(int(rng.integers(1, self.max_shapes + 1))):
            kind = int(rng.integers(0, 3))
            r = float(rng.uniform(0.1, 0.22) * S)
            cx = float(rng.uniform(r + 2, S - r - 2))
            cy = float(rng.uniform(r + 2, S - r - 2))
            if kind == 0:
                m = ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r
            elif kind == 1:
                m = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
            else:
                m = (
                    (yy >= cy - r)
                    & (yy - (cy - r) >= np.abs(xx - cx) * 2 - 1e-6)
                    & (yy <= cy + r)
                )
            if m.sum() < 16:
                continue
            color = rng.uniform(120, 240, 3)
            image[m] = color + rng.normal(0, 4, (int(m.sum()), 3))
            ys, xs = np.where(m)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            labels.append(kind)
            masks.append(m.astype(np.uint8))
        image = np.clip(image, 0, 255).astype(np.uint8)
        return {
            "image": image,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "masks": (
                np.stack(masks) if masks else np.zeros((0, S, S), np.uint8)
            ),
        }


# ---------------------------------------------------------------------------
# SSD augmentations (reference src/python/utils/augmentations.py)
# ---------------------------------------------------------------------------

@dataclass
class AugmentConfig:
    photometric: bool = True
    expand: bool = True
    crop: bool = True
    mirror: bool = True
    expand_max: float = 2.5
    crop_min_ious: Tuple = (0.1, 0.3, 0.5, 0.7, 0.9, -1.0)
    brightness_delta: float = 32.0
    contrast_range: Tuple[float, float] = (0.7, 1.3)
    saturation_range: Tuple[float, float] = (0.7, 1.3)
    hue_delta: float = 14.0


def _photometric(img: np.ndarray, rng) -> np.ndarray:
    """Brightness / contrast / saturation / hue jitter (the reference's
    PhotometricDistort, implemented on RGB float arrays)."""
    img = img.astype(np.float32)
    if rng.random() < 0.5:
        img += rng.uniform(-32, 32)
    if rng.random() < 0.5:
        img = (img - img.mean()) * rng.uniform(0.7, 1.3) + img.mean()
    if rng.random() < 0.5:   # saturation: scale chroma around luma
        luma = img.mean(axis=-1, keepdims=True)
        img = luma + (img - luma) * rng.uniform(0.7, 1.3)
    if rng.random() < 0.5:   # cheap hue rotation: roll channels slightly
        w = rng.uniform(0, 0.15)
        img = (1 - w) * img + w * np.roll(img, 1, axis=-1)
    return np.clip(img, 0, 255)


def augment_sample(sample: dict, rng, cfg: AugmentConfig = AugmentConfig()) -> dict:
    """SSDAugmentation: photometric -> expand -> IoU-constrained crop ->
    mirror. Boxes/masks transform with the image."""
    img = sample["image"].astype(np.float32)
    boxes = sample["boxes"].copy()
    labels = sample["labels"].copy()
    masks = sample["masks"].copy()
    h, w = img.shape[:2]

    if cfg.photometric:
        img = _photometric(img, rng)

    # expand: place on a larger mean-filled canvas (zoom out)
    if cfg.expand and rng.random() < 0.5 and len(boxes):
        ratio = rng.uniform(1.0, cfg.expand_max)
        nh, nw = int(h * ratio), int(w * ratio)
        top = int(rng.uniform(0, nh - h))
        left = int(rng.uniform(0, nw - w))
        canvas = np.empty((nh, nw, 3), np.float32)
        canvas[:] = img.mean(axis=(0, 1))
        canvas[top : top + h, left : left + w] = img
        mcanvas = np.zeros((len(masks), nh, nw), np.uint8)
        mcanvas[:, top : top + h, left : left + w] = masks
        img, masks = canvas, mcanvas
        boxes[:, [0, 2]] += left
        boxes[:, [1, 3]] += top
        h, w = nh, nw

    # IoU-constrained random crop (zoom in); keeps boxes whose centers
    # stay inside, like the reference's RandomSampleCrop
    if cfg.crop and len(boxes):
        for _ in range(25):
            min_iou = cfg.crop_min_ious[
                int(rng.integers(0, len(cfg.crop_min_ious)))
            ]
            if min_iou < 0:
                break
            cw = int(rng.uniform(0.3, 1.0) * w)
            ch = int(rng.uniform(0.3, 1.0) * h)
            if cw / max(ch, 1) < 0.5 or cw / max(ch, 1) > 2:
                continue
            x0 = int(rng.uniform(0, w - cw))
            y0 = int(rng.uniform(0, h - ch))
            rect = np.array([x0, y0, x0 + cw, y0 + ch], np.float32)
            ix1 = np.maximum(boxes[:, 0], rect[0])
            iy1 = np.maximum(boxes[:, 1], rect[1])
            ix2 = np.minimum(boxes[:, 2], rect[2])
            iy2 = np.minimum(boxes[:, 3], rect[3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            iou = inter / np.maximum(area, 1e-9)
            if iou.min() < min_iou:
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) * 0.5
            keep = (
                (centers[:, 0] >= rect[0]) & (centers[:, 0] < rect[2])
                & (centers[:, 1] >= rect[1]) & (centers[:, 1] < rect[3])
            )
            if not keep.any():
                continue
            img = img[y0 : y0 + ch, x0 : x0 + cw]
            masks = masks[keep, y0 : y0 + ch, x0 : x0 + cw]
            boxes = boxes[keep]
            labels = labels[keep]
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - x0, 0, cw)
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - y0, 0, ch)
            h, w = ch, cw
            break

    if cfg.mirror and rng.random() < 0.5 and len(boxes):
        img = img[:, ::-1]
        masks = masks[:, :, ::-1]
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]

    return {
        "image": np.ascontiguousarray(img),
        "boxes": boxes,
        "labels": labels,
        "masks": np.ascontiguousarray(masks),
    }


# ---------------------------------------------------------------------------
# static batching -> GTBatch
# ---------------------------------------------------------------------------

def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    mode = "F" if img.ndim == 2 else None
    if img.ndim == 2:
        pil = Image.fromarray(img.astype(np.float32), mode="F")
    else:
        pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    out = pil.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(out, np.float32)


def samples_to_gt_batch(
    samples: List[dict],
    img_size: int,
    max_objs: int,
    proto_hw: Tuple[int, int],
    *,
    device=None,
) -> GTBatch:
    """Pad a list of samples into one static-shaped GTBatch of f32 / int32
    tensors on ``device`` (the CUDA card by default), built in host numpy.
    Images are resized to (S, S) and normalized with the reference's
    means/std, and stored (B, 3, S, S) for the NCHW net (the JAX package's
    are (B, S, S, 3)); boxes go to normalized xyxy; masks are resampled to
    the proto resolution for the mask loss."""
    device = resolve_device(device)
    B = len(samples)
    S = img_size
    Hp, Wp = proto_hw
    images = np.zeros((B, 3, S, S), np.float32)
    boxes = np.zeros((B, max_objs, 4), np.float32)
    labels = np.full((B, max_objs), -1, np.int32)
    masks = np.zeros((B, max_objs, Hp, Wp), np.float32)
    for b, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[b] = ((_resize(s["image"], (S, S)) - MEANS[::-1]) / STD[::-1]).transpose(2, 0, 1)
        G = min(len(s["boxes"]), max_objs)
        if G:
            bx = s["boxes"][:G].astype(np.float32)
            bx[:, [0, 2]] /= w
            bx[:, [1, 3]] /= h
            boxes[b, :G] = np.clip(bx, 0.0, 1.0)
            labels[b, :G] = s["labels"][:G]
            for g in range(G):
                masks[b, g] = (
                    _resize(s["masks"][g].astype(np.float32), (Hp, Wp)) > 0.5
                )
    return GTBatch(*(torch.from_numpy(a).to(device) for a in (images, boxes, labels, masks)))


class DataLoader:
    """Shuffling, batching, augmenting loader with background prefetch.

    The host thread decodes + augments + pads the NEXT batch and uploads it
    to ``device`` (the CUDA card by default) while the device runs the
    current step (the reference's DataLoader worker pool; one thread, as in
    the JAX package: PIL/numpy release the GIL for the heavy parts).
    ``batches`` counts the batches handed out, ``waits`` those the caller
    had to wait for (the queue was empty; the span ``train.loader.wait``)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        img_size: int,
        max_objs: int = 16,
        proto_hw: Tuple[int, int] = (69, 69),
        augment: Optional[AugmentConfig] = AugmentConfig(),
        seed: int = 0,
        prefetch: int = 2,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        self.ds = dataset
        self.bs = batch_size
        self.img_size = img_size
        self.max_objs = max_objs
        self.proto_hw = proto_hw
        self.augment = augment
        self.rng = np.random.default_rng(seed)

        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.batches = 0
        self.waits = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _make_batch(self):
        idx = self.rng.integers(0, len(self.ds), self.bs)
        samples = []
        for i in idx:
            s = self.ds[int(i)]
            if self.augment is not None:
                s = augment_sample(s, self.rng, self.augment)
            samples.append(s)
        return samples_to_gt_batch(
            samples, self.img_size, self.max_objs, self.proto_hw, device=self.device
        )

    def _run(self):
        # hold a full queue's rejected batch and retry THAT batch: drawing a
        # fresh one per retry would make the consumed batch sequence (and
        # thus every training run) depend on consumer timing
        pending = None
        while not self._stop:
            if pending is None:
                pending = self._make_batch()
            try:
                self._q.put(pending, timeout=1.0)
                pending = None
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        try:
            batch = self._q.get_nowait()
        except queue.Empty:
            self.waits += 1
            with span("train.loader.wait"):
                batch = self._q.get()
        self.batches += 1
        return batch

    def stop(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
