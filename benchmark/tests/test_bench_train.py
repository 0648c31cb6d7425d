"""The training cell (``yolact-r50-train.shapes``) and the staggered
multistream cell (``orbslam2-x8.halfsphere``) on the CPU, at a size a test
run holds.

Training (``cell()``: the configuration's widths, 64 px images, batches of
2, a short warm-up and window): a sound run reads correct, through the
port's ``DataLoader`` and ``make_train_step``, with a finite loss at every
step; a traced run reads every per-layer metric the cell lists; the
control in bf16 fails both limits (TF32, the other control, exists only
on the card: ``test_bench_card.py``); and a run with the step broken
underneath reads not correct: the mask term left out of the loss, the
weight decay dropped from the update, the parameters left as they were
(the new momentum kept), the learning rate 1 % off. The span readers on a
canned trace.

Staggered streams: each stream reads its own frame and ground truth, and
the per-stream ATE reads 0 on the ground truth and fails its limit frozen.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.compare import _train
from benchmark.tests import tiny
from benchmark.trace import WINDOW_SPAN, Trace

NAME = "yolact-r50-train.shapes"
SEED = 2 ** 31 + 4242
SECONDS = 2.0
MS = 1_000_000
READERS = ["loader_wait_ms_per_step", "train_step_ms", "loss_ms_per_step",
           "device_idle_share.train", "mfu.train"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell() -> harness.Cell:
    """The training cell at 64 px, batches of 2; every width kept."""
    c = harness.resolve(NAME)
    cfg = copy.deepcopy(c.config)
    cfg.update(img_size=64, batch_size=2)
    tr = copy.deepcopy(c.traffic)
    tr.update(warmup_steps=2, trace_steps=2)
    tr["dataset"].update(n=64, size=64)
    tr["check"].update(span=2)
    return harness.Cell(name=c.name, chips=c.chips, config=cfg, traffic=tr, limits=c.limits,
                        end_to_end=c.end_to_end, per_layer=c.per_layer)


def failed(result: dict) -> set:
    return {n for n, d in result["checks"].items() if not d["value"] <= d["limit"]}


def test_sound_run_is_correct():
    r = harness.run(cell(), SEED, SECONDS, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}


def test_traced_run_reads_every_metric():
    r = harness.run(cell(), SEED, SECONDS, True, "cpu")
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(READERS) - {"device_idle_share.train"}   # no card, no device work
    assert m["loader_wait_ms_per_step"] >= 0
    assert 0 < m["loss_ms_per_step"] < m["train_step_ms"]
    assert m["mfu.train"] > 0


def test_bf16_control_fails_the_limits():
    c = cell()
    drv = harness.driver(c.traffic["driver"])(c, SEED, torch.device("cpu"))
    drv.make_inputs()
    r = _train.controls(drv.outputs())["bf16"]
    assert r["loss"] > c.limits["train_loss_rel"], r
    assert r["update"] > c.limits["train_update_rel"], r


def _no_mask_term(monkeypatch):
    from amos_slam_tpu_torch.models import train

    orig = train._mask_loss
    # weighted by 0, not removed: the mask head stays in the graph (with a 0 gradient)
    monkeypatch.setattr(train, "_mask_loss", lambda *a: orig(*a) * 0.0)


def _no_weight_decay(monkeypatch):
    from amos_slam_tpu_torch.models import train

    orig = train.sgd_update
    monkeypatch.setattr(train, "sgd_update",
                        lambda state, grads, lr, momentum, wd: orig(state, grads, lr, momentum, 0.0))


def _params_unchanged(monkeypatch):
    from amos_slam_tpu_torch.models import train

    orig = train.sgd_update
    monkeypatch.setattr(train, "sgd_update", lambda state, *a: orig(state, *a)._replace(
        params=state.params))


def _lr_off(monkeypatch):
    from amos_slam_tpu_torch.models import train

    orig = train.sgd_update
    monkeypatch.setattr(train, "sgd_update",
                        lambda state, grads, lr, momentum, wd: orig(state, grads, lr * 1.01,
                                                                    momentum, wd))


@pytest.mark.parametrize("fault,number", [(_no_mask_term, "train_loss_rel"),
                                          (_no_weight_decay, "train_update_rel"),
                                          (_params_unchanged, "train_update_rel"),
                                          (_lr_off, "train_update_rel")])
def test_planted_fault_reads_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    r = harness.run(cell(), SEED, SECONDS, False, "cpu")
    assert r["correct"] is False
    assert number in failed(r), r["checks"]


def canned(spans=True) -> Trace:
    """A 100 ms window of 2 steps of 8 images: a wait 0-10 ms, grads 10-40
    holding the loss 20-25, sgd 40-45; then grads 50-80 holding the loss
    60-70, sgd 80-90; kernels busy 15-35 and 55-85."""
    t = Trace(0, 100 * MS, frames=16)
    t.kernels = [("k", 15 * MS, 35 * MS), ("k", 55 * MS, 85 * MS)]
    t.device = list(t.kernels)
    t.host = [(WINDOW_SPAN, 0, 100 * MS), ("bench.train_step", 10 * MS, 90 * MS)]
    if spans:
        t.host += [(n, a * MS, b * MS) for n, a, b in (
            ("train.loader.wait", 0, 10), ("train.grads", 10, 40), ("train.loss", 20, 25),
            ("train.sgd", 40, 45), ("train.grads", 50, 80), ("train.loss", 60, 70),
            ("train.sgd", 80, 90))]
    return t


def info(trace, frames=16, window_s=2.0):
    c = harness.resolve(NAME)
    return harness.RunInfo(config=c.config, traffic=c.traffic, trace=trace, frames=frames,
                           window_s=window_s)


@pytest.mark.parametrize("name,value", [
    ("loader_wait_ms_per_step", 5.0), ("train_step_ms", 37.5), ("loss_ms_per_step", 7.5),
    ("device_idle_share.train", 50.0)])
def test_readers_on_a_canned_trace(name, value):
    assert harness.reader(name)(info(canned())) == pytest.approx(value)


def test_readers_without_spans_read_nothing_and_without_waits_zero():
    for name in READERS[:3]:
        assert harness.reader(name)(info(canned(False))) is None
        assert harness.reader(name)(info(None)) is None
    t = canned()
    t.host = [h for h in t.host if h[0] != "train.loader.wait"]
    assert harness.reader("loader_wait_ms_per_step")(info(t)) == 0.0


def test_mfu_train_counts_three_forward_passes():
    from benchmark.yardstick.flops import yolact_flops_per_image
    from benchmark.yardstick.peaks import F32_FLOP_S

    got = harness.reader("mfu.train")(info(None, frames=100, window_s=10.0))
    assert got == pytest.approx(100 * 3 * yolact_flops_per_image() * 10 / F32_FLOP_S)
    assert harness.reader("mfu.train")(info(None, frames=0)) is None


def test_train_spans_are_the_ports():
    from amos_slam_tpu_torch.utils.profiling import SPANS

    assert {"train.loader.wait", "train.grads", "train.loss", "train.sgd"} <= set(SPANS)


def test_configuration_is_the_registered_one():
    """The file's fields are ``yolact_resnet50``'s, its loss constants the
    train step's and its batch the published one; the traffic pads to the
    registered config's objects an image."""
    import inspect

    from amos_slam_tpu_torch.models import configs, train

    c = harness.resolve(NAME)
    drv = harness.driver(c.traffic["driver"])(c, SEED, "cpu")
    assert drv.yolact_config() == configs.get_config("yolact_resnet50")
    args = inspect.signature(train.multibox_loss).parameters
    for key in ("pos_iou", "neg_ratio", "mask_weight", "box_weight"):
        assert args[key].default == c.config[key]
    assert c.config["batch_size"] == 8 and "batch" not in c.traffic
    assert c.traffic["max_objs"] == drv.yolact_config().max_objs and "max_objs" not in c.config


STAGGERED = "orbslam2-x8.halfsphere"


def test_staggered_streams_read_their_own_frames_and_ground_truth():
    c = tiny.cell(STAGGERED)
    drv = harness.driver(c.traffic["driver"])(c, SEED, torch.device("cpu"))
    drv.make_inputs()
    seq, base = drv.seq, drv.seq.seq
    n, off = base.n, c.traffic["stagger_frames"]
    from benchmark import scene

    g, _ = seq.frames([5])
    for s in range(drv.S):
        i = int(scene.playback(5 + off * s, n))
        assert torch.equal(g[s, 0], base.gray[s, i].float())
        assert torch.equal(seq.gray_of(s, 5), base.gray[s, i])
        assert np.array_equal(seq.gt([5])[0, s], base.poses[i])
    out = drv.outputs()
    est = seq.gt(np.arange(30))
    mod = harness.compare("ate_m.staggered")
    assert mod.value(SimpleNamespace(est=est, gt=est)) == pytest.approx(0, abs=1e-9)
    assert mod.control(out, 40) > c.limits["ate_m.staggered"]
