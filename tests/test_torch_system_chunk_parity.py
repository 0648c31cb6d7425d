"""Port parity: System.track_rgbd_chunk without dynamics against the JAX
package's, at 320x240.

Setup: 4 levels, 500 features, max_kpts 512, MapConfig(max_keyframes=32,
max_points=8192), max_map_points_local 2048, use_dynamics=False; 40 frames
of orbit_trajectory(40, radius=0.15, advance=0.6, yaw_amp=0.4) in
default_room(seed=1), in chunks of 8. The yaw makes keyframes at frames 0,
3, 19 and 22: two of them in one chunk.

The JAX System runs without ``deterministic`` (its chunk path) and its
pending work is flushed (``_flush_pending``) after every call, so its
keyframe supervision resolves at the same points as the port's: after
each frame of the first chunk, which both packages track frame by frame
(JAX's per-frame fallback would resolve on its reader thread's schedule,
so the JAX side is fed those frames one by one), and after each later
chunk. Every chunk after the first carries a stage-one mask (a block of
the image): without the dynamic stage both packages drop it.

Held: the same keyframe frames, the same per-frame stats, the same
landmark counts, every frame's pose within 1e-4 (the local-BA tolerance
of tests/test_torch_local_ba.py); and the port's run with the masks
equals its run without them bit for bit.
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                  ORBConfig as JORB, SystemConfig as JSys,
                                  TrackingConfig as JTrk)
from amos_slam_tpu.system import System as JSystem
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.system import System as TSystem

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192)
N, W = 40, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence():
    poses = synthetic.orbit_trajectory(N, radius=0.15, advance=0.6, yaw_amp=0.4)
    planes = synthetic.default_room(seed=1)
    frames = [synthetic.render(planes, T, fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
                               cy=CAM["cy"], width=320, height=240) for T in poses]
    g = np.stack([f[0] for f in frames])
    d = np.stack([f[1] for f in frames])
    masks = np.zeros(g.shape, bool)
    masks[:, 60:180, 100:200] = True
    return poses, g, d, masks


def port_run(g, d, masks):
    ts = TSystem(TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                      tracking=TTrk(max_map_points_local=2048), use_dynamics=False),
                 device="cpu")
    stamps = [i / 30.0 for i in range(N)]
    for c in range(0, N, W):
        ts.track_rgbd_chunk(g[c: c + W], d[c: c + W], stamps[c: c + W],
                            seg_masks=None if masks is None or c == 0 else masks[c: c + W])
    ts.shutdown()
    return ts


@pytest.fixture(scope="module")
def runs(sequence):
    _, g, d, masks = sequence
    js = JSystem(JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**MAP),
                      tracking=JTrk(max_map_points_local=2048), use_dynamics=False))
    stamps = [i / 30.0 for i in range(N)]
    for i in range(W):
        js.track_rgbd(g[i], d[i], stamps[i])
        js._flush_pending()
    for c in range(W, N, W):
        js.track_rgbd_chunk(g[c: c + W], d[c: c + W], stamps[c: c + W],
                            seg_masks=masks[c: c + W])
        js._flush_pending()
    js.shutdown()
    return js, port_run(g, d, masks)


def test_chunk_path_matches_jax(runs, sequence):
    poses = sequence[0]
    js, ts = runs
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    late = [int(f) for f in mt.kf_frame_id[: mt.n_kfs] if f >= W]
    assert len(late) >= 2 and len(set(f // W for f in late)) < len(late)   # two in one chunk
    assert any(T.ndim == 3 for T in ts.poses_cw)                            # chunks were tracked
    assert ts.stats == js.stats
    assert mt.n_pts == mj.n_pts and int(mt.pt_alive.sum()) == int(mj.pt_alive.sum())
    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (N, 4, 4)
    gap = np.abs(pt - pj).max(axis=(1, 2))
    assert gap.max() < 1e-4, gap
    cj, ct = np.asarray(js.corrected_poses_np()), np.asarray(ts.corrected_poses_np())
    assert np.abs(ct - cj).max() < 1e-4
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(ct), evaluate.positions_from_cw(
        np.asarray(poses)))
    assert ate < 0.015, ate


def test_chunk_drops_stage_one_masks(runs, sequence):
    _, g, d, _ = sequence
    _, ts = runs
    plain = port_run(g, d, None)
    np.testing.assert_array_equal(np.asarray(ts.poses_np()), np.asarray(plain.poses_np()))
    assert ts.stats == plain.stats
