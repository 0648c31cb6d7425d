"""The port's System with the geometric dynamic stage (use_dynamics=True)
on its own, on the CPU at 320x240.

Setup as tests/test_torch_system_dynamics.py: 4 levels, 500 features,
max_kpts 512, MapConfig(max_keyframes=32, max_points=8192),
max_map_points_local 2048, the DynamicsConfig defaults, and the first 16
frames of the room_with_mover(seed=1, speed=1.5) sequence of
tests/test_dynamic_slam_e2e.py rendered with the camera halved. Gates:

* track_rgbd_chunk (W=4) vs per-frame with dynamics: corrected ATE < 3 cm
  each, and the chunk -> per-frame transition;
* dyn_stride=2 with oracle stage-one masks through the chunk, and a
  stage-one mask alone with use_dynamics=False (per frame, where it drops
  the mover's keypoints, and through the chunk, which drops its masks as
  the JAX package's chunk does): ATE < 3 cm of the tracked
  poses, as tests/test_dynamic_slam_e2e.py measures them (at 320x240 the
  mask, dilated by the same 15 px, covers twice the share of the image;
  both packages' corrected poses of the seg-only run drift to 0.10 m over
  all 24 frames, measured);
* the colour path (rgb / rgbs), reset() clearing the dynamic state, and
  System(SystemConfig()) constructing with its defaults.
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.config import (CameraConfig, DynamicsConfig, MapConfig, ORBConfig,
                                        SystemConfig, TrackingConfig)
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.system import System, TrackingState

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
N_PARITY = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg(**kw):
    kw.setdefault("use_dynamics", True)
    return SystemConfig(camera=CameraConfig(**CAM),
                        orb=ORBConfig(n_features=500, n_levels=4, max_kpts=512),
                        map=MapConfig(max_keyframes=32, max_points=8192),
                        tracking=TrackingConfig(max_map_points_local=2048), **kw)


@pytest.fixture(scope="module")
def sequence():
    n = 24
    poses = synthetic.orbit_trajectory(n, radius=0.1, advance=0.2)
    frames = []
    for i in range(n):
        planes, mover = synthetic.room_with_mover(seed=1, t=i / 30.0, speed=1.5)
        planes[mover].chroma = (1.6, 0.85, 0.55)
        g, d, ids, rgb = synthetic.render(planes, poses[i], return_ids=True, return_rgb=True,
                                          **CAM)
        frames.append((g, d, ids == mover, rgb))
    return poses, frames


def ate(est, poses):
    return evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(est)),
                             evaluate.positions_from_cw(np.asarray(poses[: len(est)])))


def _run_chunks(c, frames, W, seg=False):
    slam = System(c, device="cpu")
    for s in range(0, len(frames), W):
        fr = frames[s: s + W]
        out = slam.track_rgbd_chunk(
            np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]),
            [(s + j) / 30.0 for j in range(len(fr))],
            seg_masks=np.stack([f[2] for f in fr]) if seg else None)
        assert out.shape == (len(fr), 4, 4)
    return slam


@pytest.fixture(scope="module")
def per_frame(sequence):
    _, frames = sequence
    slam = System(tcfg(deterministic=True), device="cpu")
    for i, (g, d, _, _) in enumerate(frames[:N_PARITY]):
        slam.track_rgbd(g, d, i / 30.0)
    return slam


def test_chunk_vs_per_frame_with_dynamics(per_frame, sequence):
    poses, frames = sequence
    chunk = _run_chunks(tcfg(), frames[:N_PARITY], 4)
    assert chunk.state is TrackingState.OK
    assert any(T.ndim == 3 for T in chunk.poses_cw)        # chunks were tracked
    assert chunk.prev_gray.shape == (4, 240, 320)          # the chunk keeps its stack
    for s in (chunk, per_frame):
        a = ate(s.corrected_poses_np(), poses)
        assert a < 0.03, a
        assert min(x["inliers"] for x in s.stats[1:]) > 50
    # chunk -> per-frame: the last row of the stack becomes the previous frame
    g, d, _, _ = frames[N_PARITY]
    chunk.track_rgbd(g, d, N_PARITY / 30.0)
    assert chunk.prev_gray.shape == (240, 320) and chunk.state is TrackingState.OK


def test_stride2_chunk_with_oracle_masks(sequence):
    poses, frames = sequence
    slam = _run_chunks(tcfg(dynamics=DynamicsConfig(dyn_stride=2)), frames[:N_PARITY], 4,
                       seg=True)
    assert slam.state is TrackingState.OK
    assert ate(slam.poses_np(), poses) < 0.03
    assert slam._dyn_mask is not None and slam._dyn_mask.shape == (240, 320)
    # the stage-one mask drops the mover's keypoints in the last frame
    kp = slam.last_feats.kp
    xy = kp.xy[slam.last_feats.valid].round().long()
    mover = frames[N_PARITY - 1][2]
    on_mover = mover[xy[:, 1].clamp(0, 239).numpy(), xy[:, 0].clamp(0, 319).numpy()]
    assert not on_mover.any()


@pytest.mark.parametrize("path", ["track_rgbd", "track_rgbd_chunk"])
def test_stage1_seg_mask_only(sequence, path):
    poses, frames = sequence
    if path == "track_rgbd":
        slam = System(tcfg(use_dynamics=False, deterministic=True), device="cpu")
        for i, (g, d, m, _) in enumerate(frames[:N_PARITY]):
            slam.track_rgbd(g, d, i / 30.0, seg_mask=m)
    else:
        slam = _run_chunks(tcfg(use_dynamics=False), frames[:N_PARITY], 4, seg=True)
        assert any(T.ndim == 3 for T in slam.poses_cw)    # chunks were tracked
    assert slam._dyn_gates is None                           # no geometric stage
    assert ate(slam.poses_np(), poses) < 0.03
    # per frame, the dilated stage-one mask dropped the mover's keypoints;
    # the chunk without the dynamic stage drops its masks, as the JAX
    # package's does, and keeps them
    xy = slam.last_feats.kp.xy[slam.last_feats.valid].round().long()
    mover = frames[N_PARITY - 1][2]
    on_mover = mover[xy[:, 1].clamp(0, 239).numpy(), xy[:, 0].clamp(0, 319).numpy()]
    assert on_mover.any() == (path == "track_rgbd_chunk")


def test_rgb_path_and_reset(sequence):
    poses, frames = sequence
    slam = System(tcfg(), device="cpu")
    for i, (g, d, _, rgb) in enumerate(frames[:6]):
        slam.track_rgbd(g, d, i / 30.0, rgb=rgb)
    rest = frames[6:10]
    slam.track_rgbd_chunk(np.stack([f[0] for f in rest]), np.stack([f[1] for f in rest]),
                          [(6 + j) / 30.0 for j in range(4)],
                          rgbs=np.stack([f[3] for f in rest]))
    assert slam.state is TrackingState.OK
    assert ate(slam.poses_np(), poses) < 0.03
    assert slam._dyn_gates is not None and bool(torch.isfinite(slam._dyn_gates).all())
    slam.reset()
    for name in ("prev_gray", "prev_depth", "prev_kp_xy", "prev_kp_valid", "_dyn_gates",
                 "_dyn_mask"):
        assert getattr(slam, name) is None, name
    assert slam._zero_masks == {}
    assert slam.state is TrackingState.NOT_INITIALIZED
    # tracking starts over after the reset
    for i, (g, d, _, _) in enumerate(frames[10:13]):
        slam.track_rgbd(g, d, (10 + i) / 30.0)
    assert slam.state is TrackingState.OK and slam._dyn_gates is not None


def test_default_config_constructs():
    slam = System(SystemConfig(), device="cpu")
    assert slam.cfg.use_dynamics and slam.cfg.dynamics.dyn_stride == 1
    assert slam._dyn_gates is None and slam.prev_gray is None
