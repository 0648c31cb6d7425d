"""The port's System on its own (RGB-D, no dynamics, on the CPU): map
bookkeeping, chunk vs per-frame tracking, a LOST episode, keyframe
capacity growth and compaction (tests/test_long_sequence.py's cases at
320x240), trajectory export, the snapshot that local BA must not reach,
the features that once raised NotImplementedError (debug overlays, map
checkpoints, stereo, mono, dynamics), and a given vocabulary with
global_refine.

Gates: ATE < 1.5 cm on the orbit sequence for the per-frame and the chunk
path; < 5 cm on the 80-frame exploratory sweep; device and host
observation tables equal; scratch slots dead; TUM export within 1e-6 m of
corrected_poses_np (its 9 printed decimals).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.config import (CameraConfig, MapConfig, ORBConfig,
                                        SystemConfig, TrackingConfig)
from amos_slam_tpu_torch.io import evaluate, synthetic, trajectory
from amos_slam_tpu_torch.loop import vocab_io
from amos_slam_tpu_torch.system import System, TrackingState

DEFAULT_VOCAB = (pathlib.Path(__file__).resolve().parents[1] / "amos_slam_tpu_torch" / "data"
                 / "default_vocab.npz")

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)


def cfg(max_keyframes=32, max_points=8192, **kw):
    return SystemConfig(camera=CameraConfig(**CAM), orb=ORBConfig(**ORB),
                        map=MapConfig(max_keyframes=max_keyframes, max_points=max_points),
                        tracking=TrackingConfig(max_map_points_local=2048),
                        use_dynamics=False, **kw)


def render(planes, poses):
    return [synthetic.render(planes, T, fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
                             cy=CAM["cy"], width=320, height=240) for T in poses]


def ate(est, poses):
    return evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(est)),
                             evaluate.positions_from_cw(np.asarray(poses)))


def run(c, frames):
    slam = System(c, device="cpu")
    for i, (g, d) in enumerate(frames):
        slam.track_rgbd(g, d, i / 30.0)
    return slam


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def orbit():
    poses = synthetic.orbit_trajectory(20, radius=0.15, advance=0.3)
    return poses, render(synthetic.default_room(seed=1), poses)


@pytest.fixture(scope="module")
def per_frame(orbit):
    return run(cfg(), orbit[1])


def test_map_bookkeeping_consistency(per_frame):
    m = per_frame.map
    dev_obs = m.arrays.kf_obs[: m.n_kfs].numpy()
    np.testing.assert_array_equal(dev_obs, m.kf_obs_np[: m.n_kfs])
    obs = dev_obs[dev_obs >= 0]
    assert obs.max() < m.n_pts
    c = m.covis[: m.n_kfs, : m.n_kfs]
    np.testing.assert_array_equal(c, c.T)
    assert (np.diag(c) == 0).all()
    # scratch slots never allocated
    assert not bool(m.arrays.pt_valid[m.M - 1])
    assert not bool(m.arrays.kf_valid[m.K - 1])
    np.testing.assert_array_equal(m.arrays.kf_valid.numpy()[: m.n_kfs], m.kf_alive[: m.n_kfs])
    np.testing.assert_array_equal(m.arrays.pt_valid.numpy()[: m.n_pts], m.pt_alive[: m.n_pts])


def test_chunk_vs_per_frame(orbit, per_frame):
    poses, frames = orbit
    slam = System(cfg(), device="cpu")
    W = 4
    for c in range(0, len(frames), W):
        fr = frames[c: c + W]
        out = slam.track_rgbd_chunk(np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]),
                                    [(c + j) / 30.0 for j in range(len(fr))])
        assert out.shape == (len(fr), 4, 4)
    assert slam.state is TrackingState.OK
    assert len(slam.poses_np()) == len(frames) == len(slam.timestamps)
    assert any(T.ndim == 3 for T in slam.poses_cw)        # chunks were tracked
    # the chunk's fixed view and lagged resolution change no keyframe here
    np.testing.assert_array_equal(slam.map.kf_frame_id[: slam.map.n_kfs],
                                  per_frame.map.kf_frame_id[: per_frame.map.n_kfs])
    for s in (slam, per_frame):
        a = ate(s.corrected_poses_np(), poses)
        assert a < 0.015, a
        assert min(x["inliers"] for x in s.stats[1:]) > 50
        assert s.map.n_kfs >= 2


def test_lost_episode_holds_pose_and_recovers(orbit):
    poses, frames = orbit
    slam = run(cfg(), frames[:8])
    held = slam.last_Tcw.clone()
    blank = np.zeros_like(frames[8][0])
    T = slam.track_rgbd(blank, frames[8][1], 8 / 30.0)
    assert torch.equal(T, held)
    assert slam.state is TrackingState.LOST
    for i in range(9, 14):
        slam.track_rgbd(*frames[i], i / 30.0)
    assert slam.state is TrackingState.OK
    est = np.asarray(slam.poses_np())
    assert np.isfinite(est).all() and len(est) == 14
    assert min(s["inliers"] for s in slam.stats[-4:]) > 50
    assert np.isfinite(np.asarray(slam.corrected_poses_np())).all()


def sweep(n):
    return synthetic.orbit_trajectory(n, radius=0.5, advance=1.6, yaw_amp=0.25)


# An exploratory sweep that outgrows max_keyframes=8 at 320x240 (the JAX
# tests' sweep(60) at 640x480 yields 6 keyframes in the port; this one,
# faster and wider, 13).
EXPLORE = dict(n_frames=80, radius=0.5, advance=2.2, yaw_amp=0.35)


@pytest.fixture(scope="module")
def explore():
    planes = synthetic.default_room(seed=29)
    poses = synthetic.orbit_trajectory(**EXPLORE)
    return planes, poses, run(cfg(max_keyframes=8, max_points=16384), render(planes, poses))


def test_capacity_growth_beyond_max_keyframes(explore):
    _, poses, slam = explore
    m = slam.map
    assert m.K > 8 and m.n_kfs > 8
    assert slam.state is TrackingState.OK
    assert ate(slam.poses_np(), poses) < 0.05
    assert ate(slam.corrected_poses_np(), poses) < 0.05


def test_compact_keyframes(explore):
    """Runs after the growth test: it culls and compacts the shared map."""
    planes, poses, slam = explore
    m = slam.map
    n0 = m.n_kfs
    for kf in (1, 3):
        m._remove_keyframe(kf)
    alive_before = np.where(m.kf_alive[:n0])[0]
    frame_ids_before = m.kf_frame_id[alive_before].copy()
    obs_before = m.kf_obs_np[alive_before].copy()
    covis_before = m.covis.copy()
    birth_before = m.pt_birth_kf.copy()
    lut = m.compact_keyframes()
    A = m.n_kfs
    assert lut is not None and A == len(alive_before) <= n0 - 2
    np.testing.assert_array_equal(m.kf_frame_id[:A], frame_ids_before)
    np.testing.assert_array_equal(m.kf_obs_np[:A], obs_before)
    np.testing.assert_array_equal(m.arrays.kf_obs[:A].numpy(), m.kf_obs_np[:A])
    assert m.arrays.kf_valid[:A].all() and not m.arrays.kf_valid[A:].any()
    np.testing.assert_array_equal(m.covis[:A, :A],
                                  covis_before[np.ix_(alive_before, alive_before)])
    alive_pts = np.where(m.pt_alive)[0]
    expected = np.where(birth_before[alive_pts] >= 0,
                        lut[np.maximum(birth_before[alive_pts], 0)], -1)
    np.testing.assert_array_equal(m.pt_birth_kf[alive_pts], expected)
    np.testing.assert_array_equal(m.arrays.pt_first_kf.numpy()[alive_pts], expected)
    # tracking continues on the compacted map (the reference keyframe was
    # remapped); the replay resolves the culled keyframes through their
    # cull-time parent poses
    slam.ref_kf = int(lut[slam.ref_kf]) if lut[slam.ref_kf] >= 0 else A - 1
    for j in range(3):
        slam.track_rgbd(*render(planes, [poses[-1]])[0], (len(poses) + j) / 30.0)
    assert slam.state is TrackingState.OK
    assert np.isfinite(np.asarray(slam.corrected_poses_np())).all()


def test_back_to_back_inserts_at_capacity_grow():
    slam = run(cfg(max_keyframes=8, max_points=16384),
               render(synthetic.default_room(seed=23), sweep(10)))
    m = slam.map
    none = np.full(ORB["max_kpts"], -1, np.int64)
    K0 = m.K
    frame = 1000
    while m.n_kfs < K0 - 1 + 3:
        m.insert_keyframe(slam.last_feats, torch.eye(4), none, frame)
        frame += 1
    assert m.K > K0
    assert m.kf_alive[: m.n_kfs].all()
    assert m.arrays.kf_pose.shape[0] == m.K == m.kf_obs_np.shape[0]
    assert not bool(m.arrays.kf_valid[m.K - 1])


def test_epoch_snapshot_is_not_a_view(orbit):
    """The track-time reference pose must not move when local BA writes
    kf_pose in place (an integer index of a tensor is a view)."""
    slam = run(cfg(), orbit[1][:6])
    assert slam.map.n_kfs == 2
    slam.ref_kf = 0
    slam.map.version += 1
    snap = slam._ref_epochs[slam._ref_epoch()][1]
    before = snap.clone()
    view = slam.map.arrays.kf_pose[0]
    assert slam.map.run_local_ba(1)              # slot 1 fixed, slot 0 free
    assert not torch.equal(view, before)         # BA moved slot 0 in place
    assert torch.equal(snap, before)


def test_save_trajectory_tum_round_trip(per_frame, tmp_path):
    path = str(tmp_path / "traj.txt")
    per_frame.save_trajectory_tum(path)
    stamps, poses_wc = trajectory.load_tum(path)
    np.testing.assert_allclose(stamps, per_frame.timestamps, atol=1e-6)
    est = np.asarray(per_frame.corrected_poses_np())
    np.testing.assert_allclose(poses_wc[:, :3, 3], evaluate.positions_from_cw(est), atol=1e-6)
    np.testing.assert_allclose(poses_wc[:, :3, :3], np.transpose(est[:, :3, :3], (0, 2, 1)),
                               atol=1e-6)
    # keyframe trajectory: one line per live keyframe, at its frame's stamp
    per_frame.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    kf_stamps, kf_wc = trajectory.load_tum(str(tmp_path / "kf.txt"))
    m = per_frame.map
    fids = m.kf_frame_id[: m.n_kfs][m.kf_alive[: m.n_kfs]]
    np.testing.assert_allclose(kf_stamps, np.asarray(per_frame.timestamps)[fids], atol=1e-6)
    kf_cw = m.arrays.kf_pose[: m.n_kfs][torch.from_numpy(m.kf_alive[: m.n_kfs])].numpy()
    np.testing.assert_allclose(kf_wc[:, :3, 3], evaluate.positions_from_cw(kf_cw), atol=1e-6)
    # KITTI: 12 numbers per frame, the corrected Tcw's inverse
    per_frame.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    rows = np.loadtxt(str(tmp_path / "kitti.txt")).reshape(-1, 3, 4)
    np.testing.assert_allclose(rows[:, :, 3], evaluate.positions_from_cw(est), atol=1e-5)


def test_unported_features_raise(orbit, tmp_path):
    """The features that once raised NotImplementedError construct and run."""
    g, d = orbit[1][0]
    # per-frame debug overlays and map checkpoints are ported (item 11)
    dbg_dir = tmp_path / "debug_frames"
    dbg = System(cfg(), None, str(dbg_dir), device="cpu")
    for i, (gi, di) in enumerate(orbit[1][:3]):
        dbg.track_rgbd(gi, di, i / 30.0)
    assert sorted(p.name for p in dbg_dir.iterdir()) == [f"{i:06d}_frame.png" for i in range(3)]
    dbg.save_map(str(tmp_path / "map.npz"))
    slam = System(cfg(), device="cpu")
    slam.load_map(str(tmp_path / "map.npz"))
    assert (slam.map.n_kfs, slam.map.n_pts) == (dbg.map.n_kfs, dbg.map.n_pts) != (0, 0)
    assert torch.equal(slam.map.arrays.pt_pos, dbg.map.arrays.pt_pos)
    assert slam.ref_kf == dbg.map.n_kfs - 1
    assert slam.frame_id == -1 and not slam.poses_cw     # nothing was tracked
    # stereo and monocular are ported (item 10): they construct and track;
    # the first monocular frame becomes the initializer's reference
    stereo = System(dataclasses.replace(cfg(), sensor="stereo"), device="cpu")
    assert stereo.track_stereo(g, g, 0.0).shape == (4, 4)
    assert stereo.frame_id == 0 and len(stereo.poses_cw) == 1
    mono = System(dataclasses.replace(cfg(), sensor="mono"), device="cpu")
    assert mono.track_monocular(g, 0.0).shape == (4, 4)
    assert mono.frame_id == 0 and mono._mono_ref is not None
    # dynamics, stage-one masks and colour input are ported: they construct
    # and track
    dyn = System(dataclasses.replace(cfg(), use_dynamics=True), device="cpu")
    dyn.track_rgbd(g, d, 0.0, seg_mask=np.zeros_like(g, bool),
                   rgb=np.zeros(g.shape + (3,), np.uint8))
    assert dyn.frame_id == 0 and dyn.state is TrackingState.OK
    # place recognition is ported: a vocabulary given positionally, as in
    # the JAX package, is the loop closer's; global_refine runs
    voc = vocab_io.load_npz(str(DEFAULT_VOCAB), device="cpu")
    slam = System(cfg(), voc, device="cpu")
    for i, (gi, di) in enumerate(orbit[1][:6]):
        slam.track_rgbd(gi, di, i / 30.0)
    assert slam.loop is not None and slam.loop.voc.n_words == voc.n_words == 4096
    assert sorted(slam.loop.db.kf_bow) == list(range(slam.map.n_kfs))
    slam.global_refine()
    assert bool(torch.isfinite(slam.map.arrays.kf_pose).all())
    assert ate(slam.corrected_poses_np(), orbit[0][:6]) < 0.015


def test_system_defaults_to_cuda():
    if torch.cuda.is_available():
        assert System(cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            System(cfg())
