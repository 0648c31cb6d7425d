"""The output check on the CPU, at a size a test run holds
(``tiny.cell``): a sound run reads correct; the controls (the references
in the precision below the configuration's, a state that never changes)
fail the cell's limits; and a run with the timed path broken underneath
reads not correct, once for each fault the cell can have: a step that
returns its state unchanged, half of the batch (streams) left out, an
answer altered where it is produced (the FAST responses, stage one's net
outputs). The cells run on one card, so no exchange between cards can be
left out."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]
SEED = 2 ** 31 + 4242
SECONDS = 1.5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name: str) -> dict:
    return harness.run(tiny.cell(name), SEED, SECONDS, False, "cpu")


def failed(result: dict) -> set:
    return {n for n, d in result["checks"].items() if not d["value"] <= d["limit"]}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == ({e["name"] for e in harness.resolve(name).end_to_end}
                                 - set(harness.CARD_ONLY))


@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_the_limits(name):
    cell = tiny.cell(name)
    readings = control.readings(cell, SEED, torch.device("cpu"), 40)
    for number, limit in cell.limits.items():
        assert readings[number] > limit, (number, readings[number], limit)


def _freeze_system(monkeypatch):
    """Every System call returns, and keeps, the pose it started from."""
    from amos_slam_tpu_torch.system import System

    def frozen(orig):
        def call(self, *args, **kwargs):
            prev = self.last_Tcw.clone()
            orig(self, *args, **kwargs)
            self.poses_cw[-1] = prev.expand_as(self.poses_cw[-1]).clone()
            self.last_Tcw = prev
            return self.poses_cw[-1]
        return call

    monkeypatch.setattr(System, "track_rgbd", frozen(System.track_rgbd))
    monkeypatch.setattr(System, "track_rgbd_chunk", frozen(System.track_rgbd_chunk))


def _freeze_streams(monkeypatch, first: int):
    """Streams from ``first`` on keep the poses of the first step."""
    from amos_slam_tpu_torch.parallel.multistream import MultiStreamSLAM

    orig = MultiStreamSLAM.step

    def step(self, images, depths):
        T, sup = orig(self, images, depths)
        if not hasattr(self, "_held"):
            self._held = T.clone()
        T = T.clone()
        T[first:] = self._held[first:]
        return T, sup

    monkeypatch.setattr(MultiStreamSLAM, "step", step)


def _alter_fast(monkeypatch):
    from amos_slam_tpu_torch.ops.kernels.fast_margin_nms import _FastMarginNMS

    orig = _FastMarginNMS.launch

    def launch(self, imgs, extents=None):
        out = orig(self, imgs, extents)
        return torch.where(out > 0, out + 1.0, out)

    monkeypatch.setattr(_FastMarginNMS, "launch", launch)


def _alter_net(monkeypatch):
    from amos_slam_tpu_torch.models.yolact import Yolact

    orig = Yolact.forward

    def forward(self, x):
        loc, conf, coef, proto = orig(self, x)
        return loc, conf * 1.1, coef, proto

    monkeypatch.setattr(Yolact, "forward", forward)


FAULTS = [
    ("amos-tum.walk-chunk", "state_unchanged", "ate_m"),
    ("amos-tum.walk-chunk", "fast_altered", "fast_mismatch_share"),
    ("amos-tum.walk-chunk", "net_altered", "net_rel_rms"),
    ("amos-tum.walk-live", "state_unchanged", "ate_m"),
    ("amos-tum.walk-live", "net_altered", "net_rel_rms"),
    ("orbslam2-x8.walk", "state_unchanged", "ate_m"),
    ("orbslam2-x8.walk", "half_the_streams", "ate_m"),
    ("orbslam2-x8.walk", "fast_altered", "fast_mismatch_share"),
]


@pytest.mark.parametrize("name,fault,number", FAULTS)
def test_planted_fault_reads_not_correct(monkeypatch, name, fault, number):
    streams = name.startswith("orbslam2")
    if fault == "state_unchanged":
        _freeze_streams(monkeypatch, 0) if streams else _freeze_system(monkeypatch)
    elif fault == "half_the_streams":
        _freeze_streams(monkeypatch, tiny.cell(name).config["streams"] // 2)
    elif fault == "fast_altered":
        _alter_fast(monkeypatch)
    else:
        _alter_net(monkeypatch)
    r = run(name)
    assert r["correct"] is False
    assert number in failed(r), r["checks"]
