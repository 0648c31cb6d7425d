#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (amos_slam_tpu_torch).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. build   -- nvcc builds every CUDA kernel of the path from csrc/.
  2. kernels -- each kernel against its plain PyTorch version on the card,
                exact equality, at the shapes and extents the main path gives
                it and at extra shapes (negative values, ragged extents);
                timings (ops/kernels/timing.py): median over 5 runs of N
                back-to-back launches between two CUDA events, divided by
                N, after warm-up, the stream held by a spin kernel while the
                host enqueues; nvidia-smi's SM clock and power sampled
                before, after and under load; the bound from the bytes and
                operations that the extents need.
  3. main    -- RGBDOdometry at 640x480 (8 levels, 1000 features) over the
                30-frame synthetic sequence of tests/test_odometry_e2e.py,
                with the same gates (inliers > 50, ATE < 2 cm, RPE-t < 1 cm)
                and one FAST kernel launch per frame.
  4. profile -- torch.profiler over 5 frames: device time by op.
The last three lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from amos_slam_tpu_torch.config import SystemConfig
from amos_slam_tpu_torch.frontend.tracking import RGBDOdometry
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.ops import pyramid
from amos_slam_tpu_torch.ops.kernels import build
from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod
from amos_slam_tpu_torch.ops.kernels import timing

N_FRAMES = 30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fmn = fmn_mod.fast_margin_nms

    # 1. build
    t0 = time.perf_counter()
    build.build([fmn_mod.NAME])
    print(f"build: {fmn_mod.NAME} in {time.perf_counter() - t0:.2f} s")
    print(build.log_path(fmn_mod.NAME).read_text().strip())

    cfg = SystemConfig()
    cam = cfg.camera
    planes = synthetic.default_room(seed=1)
    poses_gt = synthetic.orbit_trajectory(N_FRAMES, radius=0.15, advance=0.3)
    frames = [synthetic.render(planes, T) for T in poses_gt]

    # 2. kernels against their plain versions, on the card
    sizes = cfg.orb.level_sizes(cam.width, cam.height)
    gray0 = torch.from_numpy(frames[0][0]).to(dev)
    pyr = pyramid.build_pyramid(gray0, sizes)                  # (8, 480, 640)
    levels = torch.tensor(sizes, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    rand = torch.from_numpy(
        np.round(rng.uniform(-50, 255, (3, 70, 128))).astype(np.float32)).to(dev)
    ragged = torch.tensor([[70, 128], [37, 65], [1, 1]], dtype=torch.int32, device=dev)
    cases = {
        "pyramid_level_extents": (pyr, levels),
        "pyramid_whole_canvas": (pyr, None),
        "random_3x70x128_ragged_extents": (rand, ragged),
        "single_1x480x640": (gray0[None].contiguous(), None),
    }
    max_err = 0.0
    for name, (x, ext) in cases.items():
        out_k = fmn(x, ext)
        out_p = fmn_mod.fast_margin_nms_plain(x, ext)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        exact = bool(torch.equal(out_k, out_p))
        print(f"kernel {fmn_mod.NAME} {name} {tuple(x.shape)}: tolerance exact, equal={exact} "
              f"max_abs_err={err} nonzero={int((out_k > 0).sum())}")
        check(exact, f"{fmn_mod.NAME} differs from its plain version on {name}")
        max_err = max(max_err, err)

    # timing on the main path's input, warm in L2 as in the pipeline
    smi_query = "clocks.sm,power.draw,power.limit"
    smi_before = timing.smi(smi_query)
    ms, runs_ms, held = timing.loop_ms(lambda: fmn(pyr, levels), launches=200)
    smi_after = timing.smi(smi_query)
    smi_load = timing.smi_under_load(smi_query, lambda: fmn(pyr, levels))
    plain_ms, _, _ = timing.loop_ms(
        lambda: fmn_mod.fast_margin_nms_plain(pyr, levels), launches=10, hold=False)
    read_px = sum(h * w for h, w in sizes)
    ops = fmn_mod.OPS_PER_PIXEL * read_px
    bound_ms, bound_by = timing.bound(4 * read_px, 4 * pyr.numel(), ops)
    mhz = timing.sm_mhz(smi_load + [smi_after])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({
        "timing": fmn_mod.NAME, "shape": list(pyr.shape), "extents": "level sizes",
        "method": "median of 5 runs x 200 launches between CUDA events / 200, "
                  "stream held by a spin kernel while the host enqueues",
        "ms": ms, "runs_ms": runs_ms, "runs_queue_held": held, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "read_px": read_px, "write_px": pyr.numel(), "ops": ops,
        "ops_ms_one_per_lane_per_clock":
            None if mhz is None else timing.lane_ms(ops, mhz, n_sm),
        "sm_mhz_max_sampled": mhz, "sms": n_sm,
        "smi_clocks_sm_power_draw_limit_before": smi_before,
        "smi_clocks_sm_power_draw_limit_after": smi_after,
        "smi_under_load": smi_load,
    }))

    # 3. the main path
    odo = RGBDOdometry(cfg)
    fmn.launches = 0
    frame_ms = []
    for i in range(N_FRAMES):
        gray, depth = frames[i]
        t1 = time.perf_counter()
        odo.track(gray, depth, timestamp=i / 30.0)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    launches = fmn.launches
    check(launches == N_FRAMES, f"{fmn_mod.NAME} launched {launches} times in "
          f"{N_FRAMES} frames")

    est = np.asarray(odo.poses_cw)
    gt = np.asarray(poses_gt)
    check(bool(np.isfinite(est).all()) and est.shape == (N_FRAMES, 4, 4),
          f"trajectory not finite or of shape {est.shape}")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est),
                            evaluate.positions_from_cw(gt))
    rpe_t, rpe_r = evaluate.rpe(est, gt)
    inliers = [s["inliers"] for s in odo.stats[1:]]
    print(json.dumps({
        "main_path": "RGBDOdometry 640x480", "frames": N_FRAMES,
        "ate_m": ate, "rpe_t_m": rpe_t, "rpe_r_rad": rpe_r,
        "min_inliers": min(inliers),
        "frame_ms_median_after_5": statistics.median(frame_ms[5:]),
        "frame_ms_first": frame_ms[0], "kernel_launches": launches,
    }))
    check(min(inliers) > 50, f"min inliers {min(inliers)}")
    check(ate < 0.02, f"ATE {ate:.4f} m")
    check(rpe_t < 0.01, f"RPE-t {rpe_t:.4f} m")

    # 4. where the device time goes: a fresh odometry, frames 3-7 profiled
    from torch.profiler import ProfilerActivity, profile

    odo = RGBDOdometry(cfg)
    for i in range(3):
        odo.track(*frames[i], timestamp=i / 30.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        for i in range(3, 8):
            odo.track(*frames[i], timestamp=i / 30.0)
        wall_ms = (time.perf_counter() - t2) * 1e3
    # Device kernels carry device_type CUDA; the aten ops that launched them
    # carry the same time again, so each list is summed on its own.
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        on_device = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        (kernels if on_device else ops).append((dev_us, e.key, e.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    dev_ms_per_frame = sum(r[0] for r in kernels) / 1e3 / 5
    frame_med = statistics.median(frame_ms[5:])
    print(json.dumps({
        "profile_frames": 5, "profiled_wall_ms_per_frame": wall_ms / 5,
        "device_kernel_ms_per_frame": dev_ms_per_frame,
        "kernel_launches_per_frame": sum(r[2] for r in kernels) / 5,
        "device_busy_share_unprofiled": dev_ms_per_frame / frame_med,
        "top_ops_by_device_ms": [
            {"op": k[:48], "ms_per_frame": u / 5e3, "calls_per_frame": c / 5}
            for u, k, c in ops[:8]
        ],
        "top_kernels_by_device_ms": [
            {"kernel": k[:48], "ms_per_frame": u / 5e3, "calls_per_frame": c / 5}
            for u, k, c in kernels[:5]
        ],
    }))

    print(json.dumps({"kernels": [{
        "name": fmn_mod.NAME, "route": "cuda",
        "source": "amos_slam_tpu_torch/csrc/fast_margin_nms.cu",
        "replaces": "amos_slam_tpu/ops/pallas/fast_pallas.py:110",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(timing.smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
