"""What the RGB-D drivers share: the cell's sequence rendered on the card
(``benchmark.traffic``), the FAST op's build, stage one's ``Segmenter``
with weights from the seed, the hooks that read the timed path
(``benchmark.capture``), and the outputs the check compares. A subclass
builds its program in ``program(syscfg)`` and keeps every step's poses."""

from __future__ import annotations

from time import perf_counter as now
from types import SimpleNamespace

import numpy as np
import torch

from ..capture import Capture, samples
from ..reference.fast import level_sizes
from ..traffic import make_sequence
from ..weights import yolact_params


def system_config(d: dict):
    """The program's ``SystemConfig`` from the configuration file's
    ``system`` group (every field given)."""
    from amos_slam_tpu_torch import config as C

    groups = {"camera": C.CameraConfig, "orb": C.ORBConfig, "dynamics": C.DynamicsConfig,
              "tracking": C.TrackingConfig, "map": C.MapConfig}
    return C.SystemConfig(**{k: groups[k](**v) if k in groups else v for k, v in d.items()})


class RGBDDriver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.cam, orb = self.cfg["system"]["camera"], self.cfg["system"]["orb"]
        self.sizes = level_sizes(self.cam["width"], self.cam["height"], orb["scale_factor"],
                                 orb["n_levels"])
        self.S = self.cfg["streams"]
        self.warm = self.traffic["warmup_frames"]
        self.sc = self.cfg.get("segmenter")
        self.fast_steps, self.net_steps = samples(seed, self.warm, self.traffic)
        self.cap = Capture(len(self.sizes), self.fast_steps, self.net_steps)
        self.seq = self.seg = self.params = None
        self.kernel_names: tuple = ()
        self.seg_events = []           # (start, end) CUDA events around segmenter calls
        self.window_steps = (0, 0)
        self.est = self.gt = None
        self.k = 0

    # -- set-up -------------------------------------------------------------
    def make_inputs(self):
        self.seq = make_sequence(self.traffic, self.cam, self.S, self.seed, self.device)
        return [("render", now())]

    def _params(self):
        if self.params is None and self.sc:
            bias = {c: self.sc["person_conf_bias"] for c in self.sc["person_classes"]}
            self.params = yolact_params(self.seed, self.sc["num_classes"],
                                        self.sc["backbone_layers"], self.device,
                                        getattr(torch, self.sc["compute_dtype"]), bias)
        return self.params

    def build(self):
        from amos_slam_tpu_torch.models.segmenter import Segmenter
        from amos_slam_tpu_torch.ops.kernels import build
        from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn

        marks = []
        if self.device.type == "cuda":
            build.build([fmn.NAME])
            marks.append(("kernel build or load", now()))
        if self.sc:
            sc, dtype = self.sc, getattr(torch, self.sc["compute_dtype"])
            self.seg = Segmenter(self._params(), num_classes=sc["num_classes"],
                                 person_classes=tuple(sc["person_classes"]),
                                 score_th=sc["score_th"], top_k=sc["top_k"],
                                 compute_dtype=dtype, img_size=sc["img_size"],
                                 device=self.device)
            self.cap.attach_net(self.seg.model)
            marks.append(("weights and segmenter", now()))
        self.cap.attach_fast(fmn.fast_margin_nms)
        self.kernel_names = tuple(fmn.KERNEL_NAMES)
        self.program(system_config(self.cfg["system"]))
        marks.append(("system", now()))
        return marks

    def program(self, syscfg) -> None:
        raise NotImplementedError

    # -- shared by the drivers' loops ---------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed_seg(self, call, record: bool):
        """``call()``, between two CUDA events kept when ``record``."""
        if not record or self.device.type != "cuda":
            return call()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = call()
        b.record()
        self.seg_events.append((a, b))
        return out

    def traced(self) -> int:
        self.cap.recording_shapes = True
        try:
            return self.traced_steps(self.traffic["trace_frames"])
        finally:
            self.cap.recording_shapes = False

    def fill(self, run) -> None:
        run.seg_event_ms = [a.elapsed_time(b) for a, b in self.seg_events]
        run.fast_launch_shapes = list(self.cap.launch_shapes)
        run.fast_kernel_names = self.kernel_names

    def close(self) -> None:
        self.cap.detach()
        self.seg = None

    # -- what the check reads ---------------------------------------------
    def outputs(self) -> SimpleNamespace:
        seq, sc = self.seq, self.sc or {}
        return SimpleNamespace(
            est=self.est, gt=self.gt, streams=self.S, warm=self.warm,
            chunk=self.traffic["chunk"], sizes=self.sizes,
            fast=self.cap.fast, fast_steps=self.fast_steps,
            net=self.cap.net, net_steps=self.net_steps,
            gray_of=seq.gray_of, rgb_of=seq.rgb_of, gt_of=seq.gt,
            segmenter=self.sc, params=self._params(),
            img_size=sc.get("img_size"), layers=tuple(sc.get("backbone_layers", ())))

    def _poses(self, est: np.ndarray) -> None:
        self.est = est
        self.gt = self.seq.gt(np.arange(len(est)))
