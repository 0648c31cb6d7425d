"""The port's YOLACT configs and data pipeline (models/configs.py,
models/data.py) against the JAX package's, on the CPU.

Everything here is host numpy (and PIL) in both packages, drawn from the
same numpy generators in the same order, so it must be exactly equal: the
COCO decoders, the COCO dataset, ``SyntheticShapes``, ``augment_sample``,
``samples_to_gt_batch`` (the port's images are (B, 3, S, S), transposed
here) and the first batches of two ``DataLoader``s with one seed, whatever
the port's pool of sample processes. The port's loader is also held to the
same batches under any caller timing, to raising a failed sample or a
dead sample process from ``next`` and to ending its coordinator and
processes on ``stop``. The card machine has PIL, so ``_resize`` is PIL's,
as in the JAX package.
``test_training_learns_synthetic_shapes`` (slow) is the counterpart of the
JAX package's training proof.
"""

import dataclasses
import json
import multiprocessing
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from amos_slam_tpu.models import configs as JC
from amos_slam_tpu.models import data as JD
from amos_slam_tpu_torch.models import configs as TC
from amos_slam_tpu_torch.models import data as TD
from amos_slam_tpu_torch.models.port_torch import name_map


def equal_samples(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def equal_batches(jb, tb):
    assert tb.images.dtype == torch.float32 and tb.labels.dtype == torch.int32
    np.testing.assert_array_equal(tb.images.permute(0, 2, 3, 1).numpy(), np.asarray(jb.images))
    for name in ("boxes", "labels", "masks"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))


def test_configs_equal_jax():
    assert sorted(TC._REGISTRY) == sorted(JC._REGISTRY)
    assert [f.name for f in dataclasses.fields(TC.YolactConfig)] == [
        f.name for f in dataclasses.fields(JC.YolactConfig)]
    for name, jcfg in JC._REGISTRY.items():
        tcfg = TC.get_config(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert tcfg.proto_shape == jcfg.proto_shape
        np.testing.assert_array_equal(tcfg.priors(), jcfg.priors())
    with pytest.raises(KeyError, match="unknown YOLACT config"):
        TC.get_config("yolact_nope")
    assert TC.get_config("yolact_resnet50").proto_shape == (138, 138)
    assert len(TC.yolact_resnet50.priors()) == 19248


def test_config_build():
    """build(device=...) is the port's Yolact with the config's backbone and
    classes; without ``device`` it goes to the card, and raises without one."""
    cfg = TC.yolact_tiny
    model = cfg.build(device="cpu")
    want = {key for _, key in name_map(cfg.backbone_layers)}
    assert set(model.state_dict()) == want
    assert model.state_dict()["prediction_layers.0.conf_layer.weight"].shape[0] == 3 * 4
    assert next(model.parameters()).dtype == torch.float32
    if torch.cuda.is_available():
        assert next(cfg.build().parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.build()


def test_rle_decoders_equal_jax():
    rng = np.random.default_rng(0)
    for h, w in ((23, 17), (40, 31), (1, 9)):
        mask = (rng.random((h, w)) > 0.6).astype(np.uint8)
        flat = mask.T.reshape(-1)
        change = np.flatnonzero(np.diff(flat)) + 1
        runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
        counts = ([0] + runs) if flat[0] else runs
        out = TD.decode_uncompressed_rle(counts, h, w)
        np.testing.assert_array_equal(out, JD.decode_uncompressed_rle(counts, h, w))
        np.testing.assert_array_equal(out, mask)
        s = encode_compressed_rle(counts)
        out = TD.decode_compressed_rle(s, h, w)
        np.testing.assert_array_equal(out, JD.decode_compressed_rle(s, h, w))
        np.testing.assert_array_equal(out, mask)
        for segm in ({"counts": counts, "size": [h, w]}, {"counts": s, "size": [h, w]}):
            np.testing.assert_array_equal(TD.annotation_to_mask(segm, h, w),
                                          JD.annotation_to_mask(segm, h, w))


def encode_compressed_rle(counts):
    """Test-side encoder of the COCO compressed RLE string (base-48
    varints, difference coding from the 3rd run)."""
    s = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def test_polygons_equal_jax():
    polys = [[[5, 5, 15, 5, 15, 15, 5, 15]], [[2.5, 1, 30.2, 8, 11, 27.9], [1, 1, 3, 1]],
             [[0, 0, 39, 0, 39, 19, 0, 19]]]
    for p in polys:
        out = TD.polygons_to_mask(p, 20, 40)
        np.testing.assert_array_equal(out, JD.polygons_to_mask(p, 20, 40))
        np.testing.assert_array_equal(TD.annotation_to_mask(p, 20, 40), out)


def test_coco_dataset_equal_jax(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    rng = np.random.default_rng(1)
    for name in ("a.png", "b.png", "c.png"):
        Image.fromarray(rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)).save(img_dir / name)
    rle = {"counts": [130, 12, 28, 12, 2218], "size": [40, 60]}
    ann = {
        "images": [{"id": i, "file_name": n, "height": 40, "width": 60}
                   for i, n in ((1, "a.png"), (2, "b.png"), (3, "c.png"))],
        "categories": [{"id": 9, "name": "dog"}, {"id": 7, "name": "cat"},
                       {"id": 3, "name": "bird"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 9, "iscrowd": 0, "bbox": [10, 5, 20, 15],
             "segmentation": [[10, 5, 30, 5, 30, 20, 10, 20]]},
            {"id": 2, "image_id": 1, "category_id": 7, "iscrowd": 1, "bbox": [0, 0, 10, 10],
             "segmentation": [[0, 0, 9, 0, 9, 9]]},
            {"id": 3, "image_id": 2, "category_id": 7, "iscrowd": 0, "bbox": [2, 2, 30, 30],
             "segmentation": [[2, 2, 32, 2, 32, 32, 2, 32]]},
            {"id": 4, "image_id": 2, "category_id": 3, "iscrowd": 0, "bbox": [3, 2, 1, 9],
             "segmentation": rle},
            {"id": 5, "image_id": 3, "category_id": 3, "bbox": [3, 2, 2, 9],
             "segmentation": rle},
        ],
    }
    ann_file = tmp_path / "instances.json"
    ann_file.write_text(json.dumps(ann))
    for names in (None, ["cat", "dog"]):
        t = TD.CocoDataset(str(img_dir), str(ann_file), names)
        j = JD.CocoDataset(str(img_dir), str(ann_file), names)
        assert t.ids == j.ids and t.class_names == j.class_names and t.cat_remap == j.cat_remap
        for i in range(len(j)):
            equal_samples(t[i], j[i])


def test_synthetic_shapes_equal_jax():
    for size, seed in ((128, 11), (96, 3), (550, 0)):
        t, j = TD.SyntheticShapes(n=8, size=size, seed=seed), JD.SyntheticShapes(n=8, size=size,
                                                                                 seed=seed)
        assert len(t) == len(j) and t.class_names == j.class_names
        for i in range(3 if size == 550 else 8):
            equal_samples(t[i], j[i])


@pytest.mark.parametrize("aug", [
    {}, {"expand": False, "crop": False},
    {"photometric": False, "mirror": False, "expand_max": 4.0},
])
def test_augment_sample_equal_jax(aug):
    ds = JD.SyntheticShapes(n=12, size=96, seed=3)
    t_rng, j_rng = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(12):
        s = ds[i]
        equal_samples(TD.augment_sample(s, t_rng, TD.AugmentConfig(**aug)),
                      JD.augment_sample(s, j_rng, JD.AugmentConfig(**aug)))
    assert t_rng.random() == j_rng.random()      # the same number of draws


def test_samples_to_gt_batch_equal_jax():
    """Padding, truncation at max_objs, images of other sizes, an image
    with no object; and the device rule."""
    ds = JD.SyntheticShapes(n=6, size=96, seed=5, max_shapes=5)
    rng = np.random.default_rng(2)
    samples = [JD.augment_sample(ds[i], rng) for i in range(5)]
    samples.append({"image": np.full((50, 70, 3), 90, np.uint8),
                    "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int32),
                    "masks": np.zeros((0, 50, 70), np.uint8)})
    for img_size, max_objs, proto in ((128, 4, (32, 32)), (100, 2, (25, 25))):
        jb = JD.samples_to_gt_batch(samples, img_size, max_objs, proto)
        tb = TD.samples_to_gt_batch(samples, img_size, max_objs, proto, device="cpu")
        assert tb.images.shape == (6, 3, img_size, img_size)
        equal_batches(jb, tb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.samples_to_gt_batch(samples, 64, 2, (16, 16))


@pytest.mark.parametrize("aug", [
    {}, {"expand": False, "crop": False},
    {"photometric": False, "mirror": False, "expand_max": 4.0},
])
def test_plan_then_apply_is_augment_sample(aug):
    """plan_augment's draws and apply_augment's pixels are augment_sample's,
    in the same number of draws, and the plan alone holds the boxes and
    labels the pixels end with."""
    ds = TD.SyntheticShapes(n=12, size=96, seed=3, max_shapes=5)
    cfg = TD.AugmentConfig(**aug)
    a_rng, p_rng = np.random.default_rng(4), np.random.default_rng(4)
    for i in range(12):
        s = ds[i]
        plan = TD.plan_augment(s["boxes"], s["labels"], s["image"].shape[:2], p_rng, cfg)
        out = TD.apply_augment(s, plan)
        equal_samples(out, TD.augment_sample(s, a_rng, cfg))
        assert out["masks"].shape[1:] == out["image"].shape[:2]
    assert a_rng.random() == p_rng.random()      # the same number of draws
    equal_samples(s, ds[11])                       # the sample itself is left as it was


def pool_of(monkeypatch, workers):
    """Loaders built from here on use ``workers`` sample processes (None:
    the machine's default)."""
    if workers is not None:
        monkeypatch.setattr(TD, "_pool_size", lambda batch_size: workers)


@pytest.mark.parametrize("workers", [1, 3, None], ids=["pool1", "pool3", "default"])
def test_dataloader_batches_equal_jax(monkeypatch, workers):
    """Two loaders, one seed: the first 3 batches are equal, whatever the
    port's pool size."""
    pool_of(monkeypatch, workers)
    kw = dict(batch_size=3, img_size=64, max_objs=4, proto_hw=(16, 16), seed=1, prefetch=2)
    j = JD.DataLoader(JD.SyntheticShapes(n=16, size=64, seed=7), **kw)
    t = TD.DataLoader(TD.SyntheticShapes(n=16, size=64, seed=7), **kw, device="cpu")
    try:
        assert t.workers == (workers or TD._pool_size(3))
        for _ in range(3):
            equal_batches(next(j), next(t))
        assert t.batches == 3 and t.build_s > 0
    finally:
        j.stop()
        t.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.DataLoader(TD.SyntheticShapes(n=4, size=64), **kw)


def test_pool_size_from_the_cpus(monkeypatch):
    """One sample process per CPU the process may use, less two, at most
    one per sample of a batch, at least one."""
    for cpus, batch, want in ((8, 8, 6), (8, 4, 4), (2, 8, 1), (1, 8, 1), (32, 8, 8)):
        monkeypatch.setattr(TD.os, "sched_getaffinity", lambda pid, n=cpus: set(range(n)))
        assert TD._pool_size(batch) == want


@pytest.mark.parametrize("workers", [2, None], ids=["pool2", "default"])
def test_dataloader_batches_independent_of_timing(monkeypatch, workers):
    """One seed, the same first 4 batches under a caller that sleeps at
    random between batches (the queue full, the pool idle) and one that
    never sleeps."""
    pool_of(monkeypatch, workers)
    kw = dict(batch_size=4, img_size=48, max_objs=6, proto_hw=(12, 12), seed=9, prefetch=1,
              device="cpu")
    runs = []
    for sleepy in (False, True):
        pause = np.random.default_rng(3)
        dl = TD.DataLoader(TD.SyntheticShapes(n=32, size=64, seed=2, max_shapes=5), **kw)
        try:
            got = []
            for _ in range(4):
                if sleepy:
                    time.sleep(float(pause.uniform(0, 0.3)))
                got.append(next(dl))
        finally:
            dl.stop()
        runs.append(got)
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


class Faulty(TD.SyntheticShapes):
    """SyntheticShapes that fails at index 2: raising there ("made"),
    raising an exception that cannot be pickled ("unpicklable"), or
    returning a sample with no masks ("filled")."""

    where = "made"

    def __getitem__(self, idx):
        s = super().__getitem__(idx)
        if idx == 2:
            if self.where == "made":
                raise ValueError("sample 2 is unreadable")
            if self.where == "unpicklable":
                raise ValueError(lambda: "sample 2")
            del s["masks"]
        return s


FAILURES = {"made": ValueError, "unpicklable": RuntimeError, "filled": KeyError}


@pytest.mark.parametrize("where", list(FAILURES))
def test_dataloader_raises_a_failed_sample(where):
    """An exception in a sample reaches the caller from next() instead of
    leaving next() waiting forever; one that cannot cross to this process
    arrives as its traceback's text."""
    ds = Faulty(n=4, size=48, seed=1)
    ds.where = where
    dl = TD.DataLoader(ds, 3, 48, 4, (12, 12), seed=0, device="cpu")
    calls = ThreadPoolExecutor(1)
    try:
        with pytest.raises(FAILURES[where], match="sample 2|masks") as got:
            for _ in range(50):
                calls.submit(next, dl).result(timeout=30)
        assert "in DataLoader sample process" in "".join(
            getattr(got.value, "__notes__", [])) + str(got.value)
    finally:
        dl.stop()
        calls.shutdown()


def loader_parts():
    """The live threads and child processes of every DataLoader."""
    return ([t.name for t in threading.enumerate() if t.name.startswith("DataLoader")]
            + [p.name for p in multiprocessing.active_children()
               if p.name.startswith("DataLoader")])


def test_stop_leaves_no_thread_or_process():
    """stop() ends the coordinator and every sample process, with batches
    queued, mid-build, or after a failure; next() then stops iterating."""
    before = loader_parts()
    for where in (None, "made"):
        ds = Faulty(n=16, size=48, seed=1) if where else TD.SyntheticShapes(n=16, size=48)
        dl = TD.DataLoader(ds, 4, 48, 4, (12, 12), seed=0, device="cpu")
        if where is None:
            next(dl)
        else:
            time.sleep(0.5)
        started = [n for n in loader_parts() if n not in before]
        assert sum(n.startswith("DataLoader.sample") for n in started) == dl.workers
        assert "DataLoader.coordinator" in started or dl._error is not None
        dl.stop()
        assert loader_parts() == before
        assert all(p.exitcode is not None for p in dl._procs)
        if where is None:
            with pytest.raises(StopIteration):
                next(dl)


class Dying(TD.SyntheticShapes):
    """SyntheticShapes whose process exits at index 2."""

    def __getitem__(self, idx):
        if idx == 2:
            os._exit(3)
        return super().__getitem__(idx)


def test_dataloader_raises_a_dead_process():
    """A sample process that dies is raised from next(), not waited for."""
    dl = TD.DataLoader(Dying(n=4, size=48, seed=1), 3, 48, 4, (12, 12), seed=0, device="cpu")
    calls = ThreadPoolExecutor(1)
    try:
        with pytest.raises(RuntimeError, match="exited with code 3"):
            for _ in range(50):
                calls.submit(next, dl).result(timeout=30)
    finally:
        dl.stop()
        calls.shutdown()


@pytest.mark.slow
def test_training_learns_synthetic_shapes():
    """The counterpart of tests/test_yolact_data.py::test_training_learns_synthetic_shapes:
    yolact_tiny on synthetic shapes (Flax's init drawn by the port, seed 0)
    must cut its loss substantially in 60 steps; prints the mAP of the
    trained net on 16 held-out shapes."""
    from amos_slam_tpu_torch.models.eval import evaluate_detections
    from amos_slam_tpu_torch.models.segmenter import flax_init_
    from amos_slam_tpu_torch.models.train import make_train_step
    from amos_slam_tpu_torch.models.yolact import assemble_masks, detect

    cfg = TC.yolact_tiny
    model = cfg.build(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(0))
    priors = torch.from_numpy(cfg.priors())
    dl = TD.DataLoader(
        TD.SyntheticShapes(n=64, size=cfg.img_size, seed=11), batch_size=4,
        img_size=cfg.img_size, max_objs=cfg.max_objs, proto_hw=cfg.proto_shape, seed=2,
        augment=TD.AugmentConfig(expand=False, crop=False), device="cpu")
    init, step = make_train_step(model, priors, lr=cfg.lr)
    state = init(model.state_dict())
    losses = []
    try:
        for _ in range(60):
            state, loss, _ = step(state, next(dl))
            losses.append(float(loss))
    finally:
        dl.stop()
    assert np.isfinite(losses[-1])
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-5:]))
    assert last < 0.6 * first, (first, last, losses)

    held = TD.SyntheticShapes(n=16, size=cfg.img_size, seed=99)
    samples = [held[i] for i in range(16)]
    batch = TD.samples_to_gt_batch(samples, cfg.img_size, cfg.max_objs, cfg.proto_shape,
                                   device="cpu")
    with torch.no_grad():
        loc, conf, coef, proto = torch.func.functional_call(model, state.params, (batch.images,))
    det = detect(loc, conf, coef, priors)
    masks = assemble_masks(proto, det)
    preds, gts = [], []
    for b, s in enumerate(samples):
        v = det.valid[b].numpy()
        preds.append({"boxes": det.boxes[b].numpy()[v], "scores": det.scores[b].numpy()[v],
                      "classes": det.classes[b].numpy()[v], "masks": masks[b].numpy()[v]})
        g = batch.labels[b].numpy() >= 0
        gts.append({"boxes": batch.boxes[b].numpy()[g], "classes": batch.labels[b].numpy()[g],
                    "masks": batch.masks[b].numpy()[g] > 0.5})
    print("held-out box", evaluate_detections(preds, gts),
          "mask", evaluate_detections(preds, gts, iou_type="mask"), "losses", first, last)
