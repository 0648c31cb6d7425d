"""Drive the flagship System over a revisiting sequence, and search for one
on which it closes a loop.

    python3 -m amos_slam_tpu_torch.tools.loop_search [--cand JSON] [--seg] [--out PATH]

This module drives ``chip_smoke.py`` phase 8 (which adds its gates and
its timing probe around :func:`track`) and is a search tool of its own.
Each candidate is a trajectory in ``default_room(seed)`` at 640x480:
``{"kind": "sweep", ...}`` is ``io.synthetic.sweep_and_return(n_sweep,
n_over, n_tail, yaw, pitch, ...)``, ``{"kind": "out_and_back", ...}`` is
``io.synthetic.out_and_back(n, radius, advance, yaw_amp)``. Frames are
rendered by the host's cores (grey rounded to integers) and staged on the
card, then tracked by ``System(SystemConfig(dynamics=DynamicsConfig(
dyn_stride=2)))`` at the defaults through ``track_rgbd_chunk`` in chunks of
8; with ``--seg`` each chunk's stage-one masks come from
``Segmenter(img_size=400)`` (random weights from seed 0) as in
``chip_smoke.py``'s flagship.

``"blackout": true``: the three frames at the start of the first chunk
after the map holds 8 keyframes get zero grey and depth; the motion model
carries the chunk over them. ``"kidnap": true``: after the sequence, three
more chunks. The first holds the last pose for five frames and then goes
black for three, so the chunk ends LOST; the next two put the camera back
at the sequence's first 16 poses, far from the held pose, so the first of
them takes the per-frame path, whose motion model and local map both
fail, and only the BoW relocalizer can place it. The loop gates read the
sequence alone; the kidnap is read after it.

Prints one JSON line per candidate: the loops closed and the frame of
each, the keyframes, the loop closer's detections and rejections, the
relocalized frames, the ATE of the raw and the corrected trajectory (the
blackout and the two frames after it left out), the state at the end and
the seconds it took; and, given ``--out``, writes them all there as JSON.
Needs a CUDA card.

Why a search: going out and coming back along the same path, the tracker
re-finds the landmarks of the way out, so the start stays covisible with
the keyframes that return to it and DetectLoop rightly skips it; a loop
closes only where the way back builds landmarks of its own, which depends
on the motion and on the scene.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import DynamicsConfig, SystemConfig
from ..io import evaluate, synthetic
from ..ops.kernels import timing
from ..system import System

W = 8   # chunk width, as bench.py
# chip_smoke.py phase 8's sequence
PHASE8 = dict(kind="sweep", n_sweep=40, n_over=80, n_tail=40, yaw=0.7, pitch=1.1, sway=0.2,
              seed=7, blackout=True, kidnap=True)
KIDNAP_HOLD, KIDNAP_DARK, KIDNAP_BACK = 5, 3, 16   # the kidnap's frames, in that order


def trajectory(spec: dict):
    """The candidate's Tcw poses."""
    kw = {k: v for k, v in spec.items() if k not in ("kind", "seed", "blackout", "kidnap")}
    if spec["kind"] == "sweep":
        return synthetic.sweep_and_return(**kw)
    return synthetic.out_and_back(kw.pop("n"), **kw)


def render(spec: dict, workers: int = 8):
    """(grey, depth) on the card and the ground-truth poses of the sequence
    cut to whole chunks, then of the kidnap if the spec asks for one;
    returns (grey, depth, poses, n) with n the sequence's frame count."""
    poses = trajectory(spec)
    n = len(poses) - len(poses) % W
    poses = list(poses[:n])
    if spec.get("kidnap"):
        poses += [poses[-1]] * (KIDNAP_HOLD + KIDNAP_DARK) + poses[:KIDNAP_BACK]
    frames = synthetic.render_many(synthetic.default_room(seed=spec["seed"]), poses, workers)
    g = np.stack([np.clip(f[0], 0, 255).astype(np.uint8) for f in frames]).astype(np.float32)
    d = np.stack([f[1] for f in frames])
    if spec.get("kidnap"):
        dark = slice(n + KIDNAP_HOLD, n + KIDNAP_HOLD + KIDNAP_DARK)
        g[dark] = 0.0
        d[dark] = 0.0
    return torch.from_numpy(g).cuda(), torch.from_numpy(d).cuda(), poses, n


def ate(est, gt, keep) -> float:
    return evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(est)[keep]),
                             evaluate.positions_from_cw(np.asarray(gt)[keep]))


def keyframe_poses(m) -> dict:
    """{frame id: Tcw} of the map's live keyframes (one host read)."""
    n = m.n_kfs
    poses = m.arrays.kf_pose[:n].cpu().numpy().astype(np.float64)
    return {int(m.kf_frame_id[s]): poses[s] for s in range(n) if m.kf_alive[s]}


def keyframe_ate(snaps, gt) -> dict:
    """ATE of the keyframes present in every snapshot ({frame: Tcw}) of
    ``snaps``, one value per snapshot, and their frame ids."""
    frames = sorted(set.intersection(*(set(s) for s in snaps)))
    if len(frames) < 3:
        return {"frames": frames, "ate_m": None}
    g = evaluate.positions_from_cw(np.stack([gt[f] for f in frames]))
    return {"frames": frames, "ate_m": [
        evaluate.ate_rmse(evaluate.positions_from_cw(np.stack([s[f] for f in frames])), g)
        for s in snaps]}


def track(spec: dict, g, d, poses, n: int, seg=None, slam=None, overhead_ms=lambda: 0.0):
    """Track the rendered candidate through ``track_rgbd_chunk``; returns
    (slam, result dict). ``overhead_ms`` reads a caller's instrumentation
    time, taken out of each chunk's time."""
    slam = slam or System(SystemConfig(dynamics=DynamicsConfig(dyn_stride=2)))
    stamps = [i / 30.0 for i in range(len(poses))]
    blackout = [] if spec.get("blackout") else None
    chunk_ms, chunk_loops = [], []

    def loops():
        return 0 if slam.loop is None else len(slam.loop.loops_closed)

    def chunk(c, gc, dc):
        n_loops = loops()
        t, o = time.perf_counter(), overhead_ms()
        masks = None if seg is None else seg.person_mask_batch(
            gc[..., None].expand(-1, -1, -1, 3))
        slam.track_rgbd_chunk(gc, dc, stamps[c: c + W], seg_masks=masks)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t) * 1e3 - (overhead_ms() - o))
        chunk_loops.append(loops() - n_loops)

    t0, o0 = time.perf_counter(), overhead_ms()
    for c in range(0, n, W):
        gc, dc = g[c: c + W], d[c: c + W]
        if blackout == [] and slam.map.n_kfs >= 8:
            # three frames with no image and no depth (tests/test_reloc_loop.py)
            blackout = list(range(c, c + 3))
            gc, dc = gc.clone(), dc.clone()
            gc[:3] = 0.0
            dc[:3] = 0.0
        chunk(c, gc, dc)
    run_ms = (time.perf_counter() - t0) * 1e3 - (overhead_ms() - o0)
    slam.loop.flush_gba()   # the export drains it too
    # the sequence alone: the blackout and the two frames after it hold or
    # regain a pose, and are left out of the ATE, as tests/test_reloc_loop.py does
    keep = [i for i in range(n) if not blackout or not blackout[0] <= i <= blackout[-1] + 2]
    raw, est = slam.poses_np(), slam.corrected_poses_np()
    m = slam.map
    res = {
        **spec, "frames": n, "chunk_w": W, "blackout_frames": blackout,
        "loops_closed": [list(x) for x in slam.loop.loops_closed],
        "loop_frames": [int(m.kf_frame_id[s]) for s, _ in slam.loop.loops_closed if s >= 0],
        "detections": slam.loop.detections, "rejected_by_gate": slam.loop.rejected_by_gate,
        "gba_aborts": slam.loop.gba_aborts, "fused_last_loop": slam.loop.fused_last_loop,
        "keyframes": m.n_kfs, "keyframe_frames": [int(f) for f in m.kf_frame_id[: m.n_kfs]],
        "reloc_frames_in_sequence": [i for i, st in enumerate(slam.stats) if st.get("reloc")],
        "ate_raw_m": ate(raw, poses, keep), "ate_m": ate(est, poses, keep),
        "rpe_t_m": evaluate.rpe(np.asarray(est)[keep], np.asarray(poses)[keep])[0],
        "keyframe_poses": keyframe_poses(m),
        "state_after_sequence": slam.state.name, "ms_per_frame": run_ms / n,
        "chunk_ms": chunk_ms, "chunk_loops": chunk_loops,
    }
    if spec.get("kidnap"):
        for c in range(n, len(poses), W):
            chunk(c, g[c: c + W], d[c: c + W])
        dark = n + KIDNAP_HOLD
        back = dark + KIDNAP_DARK
        reloc = [i for i, st in enumerate(slam.stats) if i >= n and st.get("reloc")]
        res.update(
            kidnap_dark_frames=list(range(dark, back)), kidnap_back_frames=[back, len(poses) - 1],
            reloc_frames=reloc,
            # the sequence's kept frames, the held frames before the dark
            # ones, and every frame from the first relocalized one on
            ate_with_kidnap_m=None if not reloc else ate(
                slam.corrected_poses_np(), poses,
                keep + list(range(n, dark)) + list(range(reloc[0], len(poses)))),
            kidnap_chunk_ms=chunk_ms[n // W:])
    res.update(state=slam.state.name, keyframes_at_end=m.n_kfs)
    return slam, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cand", default=None,
                    help="JSON list of candidate dicts (default: phase 8's)")
    ap.add_argument("--seg", action="store_true")
    ap.add_argument("--out", default=None, help="JSON file for all candidates' results")
    args = ap.parse_args()
    cands = [PHASE8] if args.cand is None else json.loads(args.cand)
    seg = None
    if args.seg:
        from ..models.segmenter import Segmenter
        seg = Segmenter(img_size=400)
    card = timing.smi("name,power.limit")
    out = []
    for spec in cands:
        t0 = time.perf_counter()
        g, d, poses, n = render(spec, os.cpu_count() or 1)
        render_s = time.perf_counter() - t0
        _, res = track(spec, g, d, poses, n, seg)
        res.pop("keyframe_poses")
        res.update(render_s=render_s, track_s=time.perf_counter() - t0 - render_s, card=card)
        print(json.dumps(res), flush=True)
        out.append(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
