"""The one traffic generator: a traffic file's parameters (``traffic/
<name>.json``) and the seed -> a rendered RGB-D sequence on the card.

A sequence is ``frames`` frames at ``fps`` of one camera path
(:func:`benchmark.scene.handheld_path` at ``speed_m_s`` / ``turn_deg_s``
about ``base_m``), seen in one room per stream (the configuration's
``streams``), each room's textures drawn from the seed and the stream's
index; ``mover`` adds a person-sized plane that walks across the view
and back. Grey frames are stored as a camera gives them (uint8) and depth
as a TUM depth image (int16 at ``depth_map_factor`` units per metre). A
run that needs more steps than the sequence has plays it forward and back
(:func:`benchmark.scene.playback`); the ground truth follows.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from . import scene
from .weights import generator

RENDER_BATCH = 32


@dataclass
class Sequence:
    gray: torch.Tensor          # (S, n, H, W) uint8
    depth: torch.Tensor         # (S, n, H, W) int16, depth_factor units per metre
    poses: np.ndarray           # (n, 4, 4) float64 camera-from-world
    fps: float
    depth_factor: float

    @property
    def n(self) -> int:
        return self.gray.shape[1]

    def index(self, steps) -> torch.Tensor:
        return torch.as_tensor(scene.playback(steps, self.n), device=self.gray.device)

    def frames(self, steps):
        """(grey f32, depth m f32), each (S, len(steps), H, W), for ``steps``."""
        i = self.index(np.asarray(steps))
        return (self.gray[:, i].to(torch.float32),
                self.depth[:, i].to(torch.float32) / self.depth_factor)

    def gray_u8(self, steps) -> torch.Tensor:
        return self.gray[:, self.index(np.asarray(steps))]

    def gray_of(self, s: int, k: int) -> torch.Tensor:
        """Stream s's (H, W) uint8 frame at step k."""
        return self.gray[s, int(scene.playback(k, self.n))]

    def rgb_of(self, frames) -> torch.Tensor:
        """(B, H, W, 3) of (stream, step) frames, grey replicated."""
        return torch.stack([self.gray_of(s, k) for s, k in frames])[..., None].expand(-1, -1, -1, 3)

    def gt(self, steps) -> np.ndarray:
        return self.poses[scene.playback(np.asarray(steps), self.n)]


def make_sequence(traffic: dict, camera: dict, streams: int, seed: int, device) -> Sequence:
    """Render the traffic file's sequence for ``streams`` rooms on
    ``device``; ``render_frames``, where given, renders only the first
    frames of the path (played forward and back as any sequence)."""
    n = traffic.get("render_frames", traffic["frames"])
    fps = float(traffic["fps"])
    poses = scene.handheld_path(traffic["frames"], fps, traffic["speed_m_s"],
                                traffic["turn_deg_s"], traffic["base_m"])[:n]
    W, H = camera["width"], camera["height"]
    factor = float(camera["depth_map_factor"])
    cam = dict(fx=camera["fx"], fy=camera["fy"], cx=camera["cx"], cy=camera["cy"],
               width=W, height=H)
    gray = torch.empty((streams, n, H, W), dtype=torch.uint8, device=device)
    depth = torch.empty((streams, n, H, W), dtype=torch.int16, device=device)
    mv = traffic.get("mover")
    for s in range(streams):
        gen = generator(seed, 100 + s, device)
        planes = scene.room(gen, device)
        if mv:
            x0 = scene.back_and_forth(traffic["frames"], fps, mv["speed_m_s"], *mv["x_range_m"])
            planes.append(scene.mover(gen, x0, tuple(mv["size_m"]), mv["depth_m"],
                                      mv["y_top_m"], device))
        for a in range(0, n, RENDER_BATCH):
            idx = np.arange(a, min(a + RENDER_BATCH, n))
            g, d = scene.render(planes, poses[idx], idx, device=device, **cam)
            gray[s, idx[0]: idx[-1] + 1] = g.clamp(0, 255).to(torch.uint8)
            depth[s, idx[0]: idx[-1] + 1] = (d * factor).round().clamp(0, 32767).to(torch.int16)
    return Sequence(gray, depth, poses, fps, factor)
