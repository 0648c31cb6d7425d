"""Port parity: map checkpoints (slam_map/checkpoint.py) and the viewer
(viewer.py), against the JAX package's.

The map comes from the port's multistream tracker over one stream of
tests/test_multistream.py's tiny config (128x96, 8 steps: several
keyframes and a few hundred landmarks), plus a loop edge and a culled
keyframe's record so that every key of the file is exercised.

Held: a map saved by the port loads in the JAX package and a map saved by
the JAX package loads in the port, every array and host mirror equal and
the same n_kfs / n_pts; the viewer's PLY, keyframe trajectory and frame
overlay equal the JAX package's byte for byte; ``plot_topdown`` writes its
PNG, and returns False without matplotlib; ``System(debug_dir=...)``
writes each frame's overlay.
"""

import types

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch import viewer as tviewer
from amos_slam_tpu_torch.config import (CameraConfig, MapConfig, ORBConfig, SystemConfig,
                                        TrackingConfig)
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.parallel import multistream as tms
from amos_slam_tpu_torch.slam_map import checkpoint as tckpt
from amos_slam_tpu_torch.slam_map.slam_map import SlamMap as TSlamMap
from amos_slam_tpu_torch.system import System

CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
ORB = dict(n_features=96, max_kpts=128, n_levels=3, border=8, cell_size=8)
HOST = ("n_kfs", "n_pts", "kf_obs_np", "kf_frame_id", "covis", "pt_obs_count",
        "pt_birth_kf", "pt_alive", "kf_alive", "kf_parent", "kf_uid_next", "slot_uid")


def cfg(mod=None):
    from amos_slam_tpu_torch import config as tcfg

    c = mod or tcfg
    return c.SystemConfig(camera=c.CameraConfig(**CAM, bf=10.0), orb=c.ORBConfig(**ORB),
                          map=c.MapConfig(max_keyframes=16, max_points=4096),
                          tracking=c.TrackingConfig(max_map_points_local=512,
                                                    min_inliers_local_map=15),
                          use_dynamics=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tracked():
    """(port multistream tracker of one stream, its grey frames)."""
    poses = synthetic.orbit_trajectory(9, radius=0.08, advance=0.22)
    room = synthetic.default_room(seed=20)
    frames = [synthetic.render(room, T, **CAM) for T in poses]
    slam = tms.MultiStreamSLAM(cfg(), 1, device="cpu")
    slam.initialize(frames[0][0][None], frames[0][1][None])
    for g, d in frames[1:]:
        slam.step(g[None], d[None])
    m = slam.maps[0]
    assert m.n_kfs >= 3 and m.n_pts > 100
    T = np.eye(4)
    T[:3, 3] = (0.1, -0.2, 0.3)
    m.loop_edges.append((0, 2, T, 0.9))
    m.uid_cull[m.kf_uid_next] = (0, torch.eye(4) * 2.0)
    return slam, [g for g, _ in frames]


def jax_map():
    from amos_slam_tpu import config as jcfg
    from amos_slam_tpu.frontend.features import ORBPipeline
    from amos_slam_tpu.slam_map.slam_map import SlamMap

    c = cfg(jcfg)
    return SlamMap(c, ORBPipeline(c.orb, c.camera).cam)


def assert_same_map(t, j):
    """A port map ``t`` and a JAX map ``j`` hold the same state."""
    for k in t.arrays._fields:
        a, b = getattr(t.arrays, k).numpy(), np.asarray(getattr(j.arrays, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in HOST:
        np.testing.assert_array_equal(np.asarray(getattr(t, k)), np.asarray(getattr(j, k)),
                                      err_msg=k)
    assert len(t.loop_edges) == len(j.loop_edges)
    for (i, k, T, s), (i2, k2, T2, s2) in zip(t.loop_edges, j.loop_edges):
        assert (i, k, s) == (i2, k2, s2)
        np.testing.assert_array_equal(np.asarray(T), np.asarray(T2))
    assert sorted(t.uid_cull) == sorted(j.uid_cull)
    for u in t.uid_cull:
        assert t.uid_cull[u][0] == j.uid_cull[u][0]
        np.testing.assert_array_equal(t.uid_cull[u][1].numpy(), np.asarray(j.uid_cull[u][1]))


def test_map_saved_by_either_package_loads_in_the_other(tracked, tmp_path):
    from amos_slam_tpu.slam_map import checkpoint as jckpt

    src = tracked[0].maps[0]
    tckpt.save_map(str(tmp_path / "port.npz"), src)
    jm = jax_map()
    jckpt.load_map(str(tmp_path / "port.npz"), jm)
    assert (jm.n_kfs, jm.n_pts) == (src.n_kfs, src.n_pts)
    assert_same_map(src, jm)

    jckpt.save_map(str(tmp_path / "jax.npz"), jm)
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    back = TSlamMap(src.cfg, src.cam, "cpu")
    version = back.version
    tckpt.load_map(str(tmp_path / "jax.npz"), back)
    assert (back.n_kfs, back.n_pts) == (src.n_kfs, src.n_pts)
    assert back.version == version + 1
    assert_same_map(back, jm)
    # the loaded map serves the tracker: its local view equals the source's
    for a, b in zip(back.local_view(back.n_kfs - 1), src.local_view(src.n_kfs - 1)):
        assert torch.equal(a, b)


def test_viewer_outputs_equal_jax(tracked, tmp_path):
    from amos_slam_tpu import viewer as jviewer
    from amos_slam_tpu.slam_map import checkpoint as jckpt

    slam, grays = tracked
    src = slam.maps[0]
    tckpt.save_map(str(tmp_path / "m.npz"), src)
    jm = jax_map()
    jckpt.load_map(str(tmp_path / "m.npz"), jm)
    tviewer.dump_map(types.SimpleNamespace(map=src), str(tmp_path / "t"))
    jviewer.dump_map(types.SimpleNamespace(map=jm), str(tmp_path / "j"))
    for suffix in ("_map.ply", "_keyframes.txt"):
        t, j = (tmp_path / f"t{suffix}").read_bytes(), (tmp_path / f"j{suffix}").read_bytes()
        assert t == j and len(t) > 100, suffix

    pts = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    cols = np.random.default_rng(1).integers(0, 255, (20, 3))
    tviewer.save_ply(str(tmp_path / "t.ply"), torch.from_numpy(pts), cols)
    jviewer.save_ply(str(tmp_path / "j.ply"), pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()

    from amos_slam_tpu_torch.frontend.tracking import index_tree

    feats = index_tree(slam.state.feats, 0)
    jfeats = types.SimpleNamespace(kp=types.SimpleNamespace(xy=feats.kp.xy.numpy()),
                                   valid=feats.valid.numpy())
    mask = np.zeros(grays[-1].shape, bool)
    mask[20:50, 30:90] = True
    for m in (None, mask):
        t = tviewer.draw_frame(torch.from_numpy(grays[-1]), feats, m)
        j = jviewer.draw_frame(grays[-1], jfeats, m)
        assert t.dtype == np.uint8 and t.shape == (96, 128, 3)
        np.testing.assert_array_equal(t, j)
    assert (t[..., 1] == 255).sum() > 9 * 20    # keypoints drawn


def test_plot_topdown(tracked, tmp_path, monkeypatch):
    import sys

    slam, _ = tracked
    poses = [np.eye(4)] * 3
    view = types.SimpleNamespace(map=slam.maps[0], poses_np=lambda: poses)
    pytest.importorskip("matplotlib")
    assert tviewer.plot_topdown(view, gt_poses=poses, path=str(tmp_path / "top.png"))
    assert (tmp_path / "top.png").stat().st_size > 1000
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tviewer.plot_topdown(view, path=str(tmp_path / "none.png")) is False
    assert not (tmp_path / "none.png").exists()


def test_system_debug_dir_writes_frames(tmp_path):
    from PIL import Image

    poses = synthetic.orbit_trajectory(4, radius=0.08, advance=0.22)
    room = synthetic.default_room(seed=21)
    frames = [synthetic.render(room, T, **CAM) for T in poses]
    out = tmp_path / "dbg"
    slam = System(cfg(), None, str(out), device="cpu")
    for i, (g, d) in enumerate(frames):
        slam.track_rgbd(g, d, i / 30.0)
    assert sorted(p.name for p in out.iterdir()) == [f"{i:06d}_frame.png" for i in range(4)]
    last = np.asarray(Image.open(out / "000003_frame.png"))
    np.testing.assert_array_equal(last, tviewer.draw_frame(frames[-1][0], slam.last_feats))
