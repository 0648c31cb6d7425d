"""Time System's per-frame and chunk paths against each other on one card.

    python3 -m amos_slam_tpu_torch.tools.time_system [--frames 256] [--w 8] [--dynamics | --seg]

One ``System(SystemConfig(use_dynamics=False))`` at the 640x480 defaults
tracks ``orbit_trajectory(frames, radius=0.1, advance=frames/768)`` in the
synthetic room ``default_room(seed=1)``, grey rounded to integers and all
frames staged on the card first (as ``chip_smoke.py``'s system phase). The
first 2W frames go through ``track_rgbd``; the rest in blocks of 2W frames,
each W frames through ``track_rgbd`` (each call timed) and W frames through
one ``track_rgbd_chunk`` call, the path that goes first alternating from
block to block, so both paths see the same map and the same host at nearly
the same time. Times are host clock ending in a device sync. Frames of a
block that inserts a keyframe are reported apart. Prints one JSON line with
each path's median ms per frame over the blocks without a keyframe, every
block's ms per frame, the card's name and power limit. Needs a CUDA card.

``--dynamics`` times the flagship's split instead: ``System(SystemConfig(
dynamics=DynamicsConfig(dyn_stride=2)))`` on ``room_with_mover(seed=1,
speed=1.5)`` with the renderer's mover mask as each frame's stage-one mask
(``seg_mask`` / ``seg_masks``); a block of W frames holds W/2 frames that
run the geometric stage and W/2 that reuse its mask.

``--seg`` times the flagship against that split, both on
``track_rgbd_chunk`` in the same System: a block of the flagship first
makes its W masks with ``Segmenter(img_size=400).person_mask_batch``
(bf16, random weights from seed 0) on the grey frames replicated to RGB,
then tracks the chunk with them; the other block tracks its chunk with the
renderer's masks. With random weights the segmenter's masks are empty
while the renderer's cover the mover, so the two paths also keep other
keypoints: their difference is the segmenter's cost plus that.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..config import DynamicsConfig, SystemConfig
from ..io import evaluate, synthetic
from ..models.segmenter import Segmenter
from ..ops.kernels import timing
from ..system import System


def staged_frames(n: int, device, mover: bool = False):
    """(gray, depth) stacks (n, 480, 640) on ``device``, the mover masks
    (with ``mover``, else None) and the ground-truth poses of the bench's
    motion."""
    planes = synthetic.default_room(seed=1)
    poses = synthetic.orbit_trajectory(n, radius=0.1, advance=n / 768)
    gray, depth, masks = [], [], []
    for i, T in enumerate(poses):
        if mover:
            planes, mid = synthetic.room_with_mover(seed=1, t=i / 30.0, speed=1.5)
            g, d, ids = synthetic.render(planes, T, return_ids=True)
            masks.append(ids == mid)
        else:
            g, d = synthetic.render(planes, T)
        gray.append(np.clip(g, 0, 255).astype(np.uint8).astype(np.float32))
        depth.append(d.astype(np.float32))
    m = torch.from_numpy(np.stack(masks)).to(device) if mover else None
    return (torch.from_numpy(np.stack(gray)).to(device),
            torch.from_numpy(np.stack(depth)).to(device), m, poses)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--w", type=int, default=8, help="chunk width")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dynamics", action="store_true",
                      help="the flagship's split: dyn_stride 2, stage-one masks every frame")
    mode.add_argument("--seg", action="store_true",
                      help="the flagship (segmenter masks) against the split (renderer masks)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_system: no CUDA device available")
    W = args.w
    dynamics = args.dynamics or args.seg
    g, d, m, poses = staged_frames(args.frames, torch.device("cuda"), mover=dynamics)
    stamps = [i / 30.0 for i in range(args.frames)]
    slam = System(SystemConfig(dynamics=DynamicsConfig(dyn_stride=2)) if dynamics
                  else SystemConfig(use_dynamics=False))

    def per_frame(a: int) -> float:
        t = time.perf_counter()
        for i in range(a, a + W):
            slam.track_rgbd(g[i], d[i], stamps[i], seg_mask=None if m is None else m[i])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / W

    def chunk(a: int) -> float:
        t = time.perf_counter()
        slam.track_rgbd_chunk(g[a: a + W], d[a: a + W], stamps[a: a + W],
                              seg_masks=None if m is None else m[a: a + W])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / W

    order = (("track_rgbd", per_frame), ("track_rgbd_chunk", chunk))
    if args.seg:
        seg = Segmenter(img_size=400)
        rgb = g[..., None].expand(-1, -1, -1, 3)     # grey replicated, as bench.py

        def segmented_chunk(a: int) -> float:
            t = time.perf_counter()
            masks = seg.person_mask_batch(rgb[a: a + W])
            slam.track_rgbd_chunk(g[a: a + W], d[a: a + W], stamps[a: a + W], seg_masks=masks)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / W

        seg.person_mask_batch(rgb[:W])      # warm-up
        order = (("track_rgbd_chunk", chunk), ("segmenter_then_chunk", segmented_chunk))

    for a in range(0, 2 * W, W):
        per_frame(a)
    blocks = {name: [] for name, _ in order}
    for k, a in enumerate(range(2 * W, args.frames - 2 * W + 1, 2 * W)):
        for j, (name, fn) in enumerate(order if k % 2 == 0 else order[::-1]):
            start = a + j * W
            ms = fn(start)
            kf = any(s["kf"] for s in slam.stats[start: start + W])
            blocks[name].append({"first_frame": start, "ms_per_frame": ms, "keyframe": kf})
    est = np.asarray(slam.corrected_poses_np())
    gt = np.asarray(poses[: len(est)])
    out = {
        "tool": "time_system", "frames": len(est), "w": W, "dynamics": dynamics,
        "segmenter": args.seg,
        "ate_m": evaluate.ate_rmse(evaluate.positions_from_cw(est),
                                   evaluate.positions_from_cw(gt)),
        "keyframes": slam.map.n_kfs, "state": slam.state.name,
        "keyframe_frames": [int(f) for f in slam.map.kf_frame_id[: slam.map.n_kfs]],
        "card": timing.smi("name,power.limit"),
    }
    for name, rows in blocks.items():
        clean = [r["ms_per_frame"] for r in rows if not r["keyframe"]]
        out[name] = {"median_ms_per_frame_no_keyframe": statistics.median(clean),
                     "blocks": rows}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
