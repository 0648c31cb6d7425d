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
* a background prefetcher overlaps host decode/augment with the device
  step: one coordinator thread makes the draws, a pool of sample processes
  does the pixel work (the analogue of the reference's torch
  DataLoader(num_workers=...)).

A synthetic shapes dataset with exact ground-truth masks is provided for
training proofs and CI (no COCO images are in the repository).
"""

from __future__ import annotations

import json
import mmap
import multiprocessing
import os
import pickle
import queue
import threading
import time
import traceback
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


@dataclass
class AugmentPlan:
    """Every draw of one sample's SSDAugmentation, and the boxes and labels
    it leaves (see :func:`plan_augment`)."""

    photometric: Optional[Tuple[Optional[float], ...]]  # _photometric_draws; None: step off
    expand: Optional[Tuple[int, int, int, int]]         # canvas (nh, nw), image at (top, left)
    crop: Optional[Tuple[int, int, int, int, np.ndarray]]  # x0, y0, cw, ch, boxes kept
    mirror: bool
    boxes: np.ndarray
    labels: np.ndarray


def _photometric_draws(rng) -> Tuple[Optional[float], ...]:
    """The draws of the reference's PhotometricDistort: brightness shift,
    contrast, saturation and hue weights, each None where its coin skips it."""
    return tuple(rng.uniform(lo, hi) if rng.random() < 0.5 else None
                 for lo, hi in ((-32, 32), (0.7, 1.3), (0.7, 1.3), (0, 0.15)))


def _photometric(img: np.ndarray, draws) -> np.ndarray:
    """Brightness / contrast / saturation / hue jitter (the reference's
    PhotometricDistort, implemented on RGB float arrays)."""
    brightness, contrast, saturation, hue = draws
    img = img.astype(np.float32)
    if brightness is not None:
        img += brightness
    if contrast is not None:
        img = (img - img.mean()) * contrast + img.mean()
    if saturation is not None:   # scale chroma around luma
        luma = img.mean(axis=-1, keepdims=True)
        img = luma + (img - luma) * saturation
    if hue is not None:          # cheap hue rotation: roll channels slightly
        img = (1 - hue) * img + hue * np.roll(img, 1, axis=-1)
    return np.clip(img, 0, 255)


def plan_augment(boxes: np.ndarray, labels: np.ndarray, hw: Tuple[int, int], rng,
                 cfg: AugmentConfig = AugmentConfig()) -> AugmentPlan:
    """Every draw :func:`augment_sample` makes for a sample with these
    boxes and labels on an (h, w) image, in the same order and number, with
    no pixel: photometric draws need none, and expand, crop and mirror are
    decided from box geometry alone. The plan holds the transformed boxes
    and labels; :func:`apply_augment` does the pixel work."""
    boxes = boxes.copy()
    labels = labels.copy()
    h, w = hw
    photometric = _photometric_draws(rng) if cfg.photometric else None

    # expand: place on a larger mean-filled canvas (zoom out)
    expand = None
    if cfg.expand and rng.random() < 0.5 and len(boxes):
        ratio = rng.uniform(1.0, cfg.expand_max)
        nh, nw = int(h * ratio), int(w * ratio)
        top = int(rng.uniform(0, nh - h))
        left = int(rng.uniform(0, nw - w))
        expand = (nh, nw, top, left)
        boxes[:, [0, 2]] += left
        boxes[:, [1, 3]] += top
        h, w = nh, nw

    # IoU-constrained random crop (zoom in); keeps boxes whose centers
    # stay inside, like the reference's RandomSampleCrop
    crop = None
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
            crop = (x0, y0, cw, ch, keep)
            boxes = boxes[keep]
            labels = labels[keep]
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - x0, 0, cw)
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - y0, 0, ch)
            h, w = ch, cw
            break

    mirror = bool(cfg.mirror and rng.random() < 0.5 and len(boxes))
    if mirror:
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return AugmentPlan(photometric, expand, crop, mirror, boxes, labels)


def apply_augment(sample: dict, plan: AugmentPlan) -> dict:
    """The pixel work of ``plan`` on ``sample``'s image and masks:
    photometric, canvas, crop, mirror. Draws nothing."""
    img = sample["image"].astype(np.float32)
    masks = sample["masks"].copy()
    if plan.photometric is not None:
        img = _photometric(img, plan.photometric)
    if plan.expand is not None:
        nh, nw, top, left = plan.expand
        h, w = img.shape[:2]
        canvas = np.empty((nh, nw, 3), np.float32)
        canvas[:] = img.mean(axis=(0, 1))
        canvas[top : top + h, left : left + w] = img
        mcanvas = np.zeros((len(masks), nh, nw), np.uint8)
        mcanvas[:, top : top + h, left : left + w] = masks
        img, masks = canvas, mcanvas
    if plan.crop is not None:
        x0, y0, cw, ch, keep = plan.crop
        img = img[y0 : y0 + ch, x0 : x0 + cw]
        masks = masks[keep, y0 : y0 + ch, x0 : x0 + cw]
    if plan.mirror:
        img = img[:, ::-1]
        masks = masks[:, :, ::-1]
    return {
        "image": np.ascontiguousarray(img),
        "boxes": plan.boxes,
        "labels": plan.labels,
        "masks": np.ascontiguousarray(masks),
    }


def augment_sample(sample: dict, rng, cfg: AugmentConfig = AugmentConfig()) -> dict:
    """SSDAugmentation: photometric -> expand -> IoU-constrained crop ->
    mirror. Boxes/masks transform with the image."""
    plan = plan_augment(sample["boxes"], sample["labels"], sample["image"].shape[:2], rng, cfg)
    return apply_augment(sample, plan)


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


def gt_arrays(batch: int, img_size: int, max_objs: int,
              proto_hw: Tuple[int, int]) -> Tuple[np.ndarray, ...]:
    """The host arrays of one padded GTBatch, empty: (B, 3, S, S) images,
    (B, max_objs, 4) boxes, (B, max_objs) labels at -1 and
    (B, max_objs, Hp, Wp) masks."""
    Hp, Wp = proto_hw
    return (np.zeros((batch, 3, img_size, img_size), np.float32),
            np.zeros((batch, max_objs, 4), np.float32),
            np.full((batch, max_objs), -1, np.int32),
            np.zeros((batch, max_objs, Hp, Wp), np.float32))


def fill_gt_row(arrays: Tuple[np.ndarray, ...], b: int, sample: dict) -> None:
    """Row ``b`` of :func:`gt_arrays`' arrays, whole, from one sample: the
    image resized to (S, S) and normalized with the reference's means/std,
    boxes in normalized xyxy, the first ``max_objs`` labels, and masks
    resampled to the proto resolution, padded as :func:`gt_arrays` pads.
    Rows are independent, so they fill in any order, from any thread or
    process, and a row can be filled again."""
    images, boxes, labels, masks = arrays
    S, (Hp, Wp) = images.shape[-1], masks.shape[-2:]
    h, w = sample["image"].shape[:2]
    images[b] = ((_resize(sample["image"], (S, S)) - MEANS[::-1]) / STD[::-1]).transpose(2, 0, 1)
    G = min(len(sample["boxes"]), boxes.shape[1])
    boxes[b, G:] = 0.0
    labels[b, G:] = -1
    masks[b, G:] = 0.0
    if G:
        bx = sample["boxes"][:G].astype(np.float32)
        bx[:, [0, 2]] /= w
        bx[:, [1, 3]] /= h
        boxes[b, :G] = np.clip(bx, 0.0, 1.0)
        labels[b, :G] = sample["labels"][:G]
        for g in range(G):
            masks[b, g] = _resize(sample["masks"][g].astype(np.float32), (Hp, Wp)) > 0.5


def samples_to_gt_batch(
    samples: List[dict],
    img_size: int,
    max_objs: int,
    proto_hw: Tuple[int, int],
    *,
    device=None,
) -> GTBatch:
    """Pad a list of samples into one static-shaped GTBatch of f32 / int32
    tensors on ``device`` (the CUDA card by default), built in host numpy
    (:func:`fill_gt_row` per sample). Images are stored (B, 3, S, S) for
    the NCHW net (the JAX package's are (B, S, S, 3))."""
    device = resolve_device(device)
    arrays = gt_arrays(len(samples), img_size, max_objs, proto_hw)
    for b, s in enumerate(samples):
        fill_gt_row(arrays, b, s)
    return GTBatch(*(torch.from_numpy(a).to(device) for a in arrays))


def _pool_size(batch_size: int) -> int:
    """The loader's sample processes: the CPUs this process may run on,
    less two (the caller's dispatch and the loader's coordinator), at most
    one per sample of a batch, at least one."""
    return max(1, min(batch_size, len(os.sched_getaffinity(0)) - 2))


def _views(buf: mmap.mmap, layout) -> Tuple[np.ndarray, ...]:
    """Arrays of ``layout``'s (shape, dtype)s laid end to end in ``buf``."""
    out, offset = [], 0
    for shape, dtype in layout:
        out.append(np.frombuffer(buf, dtype, int(np.prod(shape)), offset).reshape(shape))
        offset += out[-1].nbytes
    return tuple(out)


def _sample_worker(w: int, ds, inbox, outbox, slots, layout, parent: int) -> None:
    """One sample process. ``("make", key, index)`` makes ``ds[index]``,
    keeps it and answers with its boxes, labels and image size;
    ``("fill", key, plan, slot)`` augments the kept sample by ``plan`` (or
    not, for None) and writes it into row ``key[1]`` of batch buffer
    ``slot``. Every answer carries ``w`` and the key; a failure answers
    with the exception. Ends on None, or when the parent process is gone."""
    views = [_views(buf, layout) for buf in slots]
    held = {}
    while True:
        try:
            task = inbox.get(timeout=1.0)
        except queue.Empty:
            if os.getppid() != parent:
                return
            continue
        if task is None:
            return
        key = task[1]
        try:
            if task[0] == "make":
                s = held[key] = ds[task[2]]
                outbox.put((w, "made", key, (s["boxes"], s["labels"], s["image"].shape[:2])))
            else:
                s, plan = held.pop(key), task[2]
                fill_gt_row(views[task[3]], key[1], s if plan is None else apply_augment(s, plan))
                outbox.put((w, "filled", key, None))
        except Exception as e:
            where = f"in DataLoader sample process {os.getpid()}:\n{traceback.format_exc()}"
            try:
                pickle.dumps(e)
                e.add_note(where)
            except Exception:
                e = RuntimeError(where)
            outbox.put((w, "failed", key, e))


class _Stopped(Exception):
    pass


class DataLoader:
    """Shuffling, batching, augmenting loader with background prefetch.

    A coordinator thread keeps the numpy generator and makes every draw in
    the JAX package's order (a batch's indices, then each sample's
    augmentation draws, :func:`plan_augment`), so a loader with the same
    seed yields the same batches whatever its pool size or its caller's
    timing. The pixel work runs on a pool of sample processes (the
    reference's DataLoader workers, forked as torch's are): a process makes
    a sample and keeps it; once the coordinator has planned it, the same
    process augments it and writes its row of the batch into memory shared
    with this process (:func:`apply_augment`, :func:`fill_gt_row`). The
    coordinator plans batch k + 1 while batch k's rows fill, then uploads
    batch k to ``device`` (the CUDA card by default) and queues it, in
    order. Processes, not threads: numpy and PIL hold the GIL for much of a
    sample, which slows the caller's own dispatch. An exception in a sample
    or in the coordinator, or a sample process that dies, is raised from
    ``next``; ``stop`` ends the coordinator and the processes.

    Counters: ``workers``, the pool's size (one per CPU this process may
    use, less two, at most ``batch_size``); ``batches``, the batches handed
    out; ``waits``, those the caller had to wait for (the queue was empty;
    the span ``train.loader.wait``); ``build_s``, the summed wall seconds
    from a batch's index draw to its upload (two batches are in flight at
    a time, so ``build_s / batches`` is a batch's latency through the
    loader, up to twice its pace)."""

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
        self.augment = augment
        self.rng = np.random.default_rng(seed)

        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.workers = _pool_size(batch_size)
        self.batches = 0
        self.waits = 0
        self.build_s = 0.0
        self._stop = False
        self._error: Optional[BaseException] = None

        # two batch buffers: batch k fills one while k + 1 fills the other
        arrays = gt_arrays(batch_size, img_size, max_objs, proto_hw)
        self._layout = [(a.shape, a.dtype) for a in arrays]
        self._slots = [mmap.mmap(-1, sum(a.nbytes for a in arrays)) for _ in range(2)]
        ctx = multiprocessing.get_context("fork")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.workers)]
        self._procs = [
            ctx.Process(target=_sample_worker, name=f"DataLoader.sample{w}", daemon=True,
                        args=(w, dataset, inbox, self._outbox, self._slots, self._layout,
                              os.getpid()))
            for w, inbox in enumerate(self._inboxes)]
        for p in self._procs:
            p.start()
        self._tasks = [0] * self.workers    # tasks sent to each process, not yet answered
        self._answers: Dict[tuple, tuple] = {}
        self._k = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="DataLoader.coordinator")
        self._thread.start()

    # -- the coordinator --------------------------------------------------
    def _send(self, w: int, task: tuple) -> None:
        self._tasks[w] += 1
        self._inboxes[w].put(task)

    def _answer(self, kind: str, key: tuple):
        """The answer ``kind`` to ``key``, keeping the others that arrive
        first; raises a failed sample's exception."""
        while (kind, key) not in self._answers:
            try:
                w, got, k, value = self._outbox.get(timeout=0.1)
            except queue.Empty:
                if self._stop:
                    raise _Stopped
                for p in self._procs:
                    if p.exitcode is not None:
                        raise RuntimeError(
                            f"DataLoader sample process {p.name} exited with code {p.exitcode}")
                continue
            self._tasks[w] -= 1
            if got == "failed":
                raise value
            self._answers[got, k] = (w, value)
        return self._answers.pop((kind, key))

    def _start_batch(self):
        """Draw batch k's indices, have its samples made, plan each in order
        and send its augmentation to the process that holds it."""
        k, self._k = self._k, self._k + 1
        t0 = time.perf_counter()
        for b, i in enumerate(self.rng.integers(0, len(self.ds), self.bs)):
            self._send(self._tasks.index(min(self._tasks)), ("make", (k, b), int(i)))
        for b in range(self.bs):
            w, (boxes, labels, hw) = self._answer("made", (k, b))
            plan = None if self.augment is None else plan_augment(
                boxes, labels, hw, self.rng, self.augment)
            self._send(w, ("fill", (k, b), plan, k % 2))
        return k, t0

    def _finish_batch(self, k: int, t0: float) -> GTBatch:
        for b in range(self.bs):
            self._answer("filled", (k, b))
        batch = GTBatch(*(torch.from_numpy(a).to(self.device, copy=True)
                          for a in _views(self._slots[k % 2], self._layout)))
        self.build_s += time.perf_counter() - t0
        return batch

    def _put(self, batch) -> None:
        # a full queue's rejected batch is the one retried: drawing a fresh
        # one per retry would make the consumed batch sequence (and thus
        # every training run) depend on consumer timing
        while not self._stop:
            try:
                self._q.put(batch, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self):
        try:
            started = self._start_batch()
            while not self._stop:
                after = self._start_batch()
                self._put(self._finish_batch(*started))
                started = after
        except _Stopped:
            pass
        except BaseException as e:      # raised to the caller by __next__
            self._error = e

    # -- the caller -------------------------------------------------------
    def _get(self):
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if self._stop:
                    raise StopIteration

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        try:
            batch = self._q.get_nowait()
        except queue.Empty:
            self.waits += 1
            with span("train.loader.wait"):
                batch = self._get()
        self.batches += 1
        return batch

    def stop(self):
        self._stop = True
        self._thread.join()
        for inbox in self._inboxes:
            inbox.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.exitcode is None:
                p.terminate()
                p.join()
        for q in (self._outbox, *self._inboxes):
            q.cancel_join_thread()      # what is left unread is not needed
            q.close()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
