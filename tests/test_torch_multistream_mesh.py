"""The port's multistream SLAM over a stream mesh of two entries
(parallel/multistream.py: ``stream_groups``, ``split_streams``,
``gather_streams``, ``shard_step`` and ``MultiStreamSLAM`` with G = 2)
against the JAX package's ``shard_map`` over 2 of the 8 forced CPU
devices and against the port's own one-group run, on the CPU at
tests/test_torch_multistream.py's tiny config (128x96, 3 levels, 96
features; the live-map runs with MapConfig(16, 4096), 512 local points
and min_inliers_local_map 15), over distinct rooms (seeds 20 + s). Torch
has one CPU device, so both mesh entries name it: the group logic does
not assume distinct devices.

Held:
* ``shard_step`` over the 2-entry mesh against JAX's ``shard_step`` over 2
  devices, 4 streams (tests/test_multistream.py's room and orbit, each
  stream 2 poses behind the one before) and empty views, 2 steps: ``sup``
  rows equal and ``Tcw`` within 1e-4 (tests/test_torch_multistream.py's
  JAX parity), but for at most one stream-step whose counts differ by 1,
  that stream's poses within 1e-3 from then on: at step 1 stream 3 keeps
  36 motion-model inliers in the port and 35 in JAX, 4.8e-4 apart, from the pyramid levels'
  rounding gap (ROADMAP queue 3, keypoints >= 95% equal); JAX's own
  1-device and 2-device runs are bit-equal there, and the port's two
  groups equal its one group: ``sup`` and heavy rows equal, poses within
  1e-5;
* ``MultiStreamSLAM(cfg, 8, 2-entry mesh)`` over 12 steps, ``flush()``
  after each, against the one-group port run: ``sup`` rows equal every
  step, poses, keyframe poses and landmarks within 1e-5, the same keyframe
  frames and counts per stream;
  against JAX's ``MultiStreamSLAM`` on a 2-device mesh: ``sup`` equal,
  poses and keyframe poses within 1e-4 (measured 3.6e-5 and 4.1e-5),
  landmarks within 1e-3 on >= 99.5% of them and all within 5e-3: the
  local-BA gap of tests/test_torch_local_ba.py (JAX's bf16 hi/lo sums)
  compounds over 8 maps of 6-11 keyframes to 1.2-3.6 mm on 10 of 3,995
  landmarks (99.75% within 1e-3), and JAX's run on one device gives the
  same gaps, so the mesh adds none;
* 8 streams do not split over 3 entries: ``stream_groups``,
  ``split_streams`` and ``MultiStreamSLAM`` raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap, ORBConfig as JORB,
                                  SystemConfig as JSys, TrackingConfig as JTrk)
from amos_slam_tpu.frontend.features import ORBPipeline as JPipeline
from amos_slam_tpu.parallel import multistream as jms
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.frontend.features import ORBPipeline
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.parallel import multistream as tms

CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
ORB = dict(n_features=96, max_kpts=128, n_levels=3, border=8, cell_size=8)
S, STEPS = 8, 12
JAX_TOL, GROUP_TOL = 1e-4, 1e-5
# a stream whose motion-model inliers differ by one between the packages
# (the pinned pyramid-level gap: keypoints >= 95% equal): its pose
LOST_ONE_TOL = 1e-3
# landmarks against JAX: 1e-3 on >= 99.5% of them, all within 5 mm (the
# local-BA gap compounds on 10 of 3,995 to 1.2-3.6 mm, the same with JAX's
# MultiStreamSLAM on one device)
PT_TOL, PT_SHARE, PT_MAX = 1e-3, 0.995, 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(mod=None):
    Sys, Cam, Orb, Map, Trk = mod or (TSys, TCam, TORB, TMap, TTrk)
    return Sys(camera=Cam(**CAM, bf=10.0), orb=Orb(**ORB),
               map=Map(max_keyframes=16, max_points=4096),
               tracking=Trk(max_map_points_local=512, min_inliers_local_map=15),
               use_dynamics=False)


def stream_frames(n_streams, n):
    """n batches of n_streams streams: distinct rooms, one orbit."""
    gt = synthetic.orbit_trajectory(n, radius=0.08, advance=0.22)
    rooms = [synthetic.default_room(seed=20 + s) for s in range(n_streams)]
    return [(np.stack([g for g, _ in row]).astype(np.float32),
             np.stack([d for _, d in row]).astype(np.float32))
            for row in synthetic.render_rooms(rooms, gt, **CAM)]


def mesh2():
    return tms.make_stream_mesh(["cpu", "cpu"])


def test_shard_step_equals_jax_shard_map_and_one_group():
    n_streams, lag = 4, 2
    # tests/test_multistream.py's room (seed 2) and orbit, each stream 2
    # poses behind the one before it: distinct frames that track on the
    # motion model alone (the views are empty)
    n = 3 + lag * n_streams
    gt = synthetic.orbit_trajectory(n, radius=0.05, advance=0.05 * n / 3)
    room = synthetic.default_room(seed=2)
    frames = []
    for k in range(3):
        r = [synthetic.render(room, gt[k + lag * s], **CAM) for s in range(n_streams)]
        frames.append((np.stack([g for g, _ in r]).astype(np.float32),
                       np.stack([d for _, d in r]).astype(np.float32)))
    pipe = ORBPipeline(TORB(**ORB), TCam(**CAM, bf=10.0), device="cpu")
    jpipe = JPipeline(JORB(**ORB), JCam(**CAM, bf=10.0))
    r1, r2 = 10.0, 6.0
    # JAX: shard_map over 2 devices, 2 streams each
    jmesh = jms.make_stream_mesh(jax.devices()[:2])
    jstep = jms.shard_step(jpipe, jmesh)
    jstate = jms.init_state(jpipe, jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
    jviews = jms.empty_views(n_streams, 256)
    # the port: per-group form over the 2-entry mesh, and one group
    mesh = mesh2()
    step2, step1 = tms.shard_step(pipe, mesh), tms.shard_step(pipe, tms.make_stream_mesh(["cpu"]))
    state1 = tms.init_state(pipe, *(torch.from_numpy(x) for x in frames[0]))
    states = tms.split_streams(state1, mesh)
    views1 = tms.empty_views(n_streams, 256, device="cpu")
    views = tms.split_streams(views1, mesh)
    unequal, off_by, apart = 0, [], np.zeros(n_streams, bool)
    for k in (1, 2):
        g, d = frames[k]
        jstate, jsup, _ = jstep(jstate, jnp.asarray(g), jnp.asarray(d), jviews,
                                jnp.asarray(r1), jnp.asarray(r2))
        states, sups, heavies = step2(states, tms.split_streams(g, mesh),
                                      tms.split_streams(d, mesh), views,
                                      torch.tensor(r1), torch.tensor(r2))
        state1, sup1, heavy1 = step1(state1, torch.from_numpy(g), torch.from_numpy(d), views1,
                                     torch.tensor(r1), torch.tensor(r2))
        assert len(states) == len(sups) == len(heavies) == 2
        assert [tuple(s.shape) for s in sups] == [(2, 3), (2, 3)]
        sup = tms.gather_streams(sups, "cpu")
        Tcw = tms.gather_streams([s.Tcw for s in states], "cpu")
        same = (sup.numpy() == np.asarray(jsup)).all(axis=1)
        off_by.append(np.abs(sup.numpy() - np.asarray(jsup)).max())
        unequal += int((~same).sum())
        gap = np.abs(Tcw.numpy() - np.asarray(jstate.Tcw)).max(axis=(1, 2))
        apart |= ~same
        assert (gap[~apart] <= JAX_TOL).all() and (gap <= LOST_ONE_TOL).all(), (k, gap, apart)
        np.testing.assert_array_equal(sup.numpy(), sup1.numpy())
        np.testing.assert_allclose(Tcw.numpy(), state1.Tcw.numpy(), atol=GROUP_TOL)
        assert torch.equal(tms.gather_streams(heavies, "cpu"), heavy1)
    assert unequal <= 1 and max(off_by) <= 1, (unequal, off_by)
    assert len(jstate.Tcw.sharding.device_set) == 2
    assert (np.asarray(jsup)[:, 0] > 20).all()          # the streams tracked


def run_port(mesh):
    """MultiStreamSLAM(cfg, S, mesh) with flush() after every step:
    (slam, per-step poses, per-step sup rows)."""
    frames = stream_frames(S, STEPS + 1)
    slam = tms.MultiStreamSLAM(cfg(), S, mesh)
    slam.initialize(*frames[0])
    poses, sups = [], []
    for k in range(1, STEPS + 1):
        T, _ = slam.step(*frames[k])
        slam.flush()
        poses.append(T.numpy().copy())
        sups.append(np.array(slam.last_sup))
    return slam, poses, sups


@pytest.fixture(scope="module")
def two_groups():
    return run_port(mesh2())


def test_multistream_two_groups_equal_one_group(two_groups):
    slam2, poses2, sups2 = two_groups
    slam1, poses1, sups1 = run_port(tms.make_stream_mesh(["cpu"]))
    assert slam2.groups == [slice(0, 4), slice(4, 8)] and slam1.groups == [slice(0, 8)]
    assert len(slam2._states) == 2 and slam2._states[0].Tcw.shape == (4, 4, 4)
    for k in range(STEPS):
        np.testing.assert_array_equal(sups2[k], sups1[k], err_msg=f"step {k + 1}")
        np.testing.assert_allclose(poses2[k], poses1[k], atol=GROUP_TOL, err_msg=f"step {k + 1}")
    for s, (m2, m1) in enumerate(zip(slam2.maps, slam1.maps)):
        assert (m2.n_kfs, m2.n_pts) == (m1.n_kfs, m1.n_pts), s
        assert m2.n_kfs >= 2, s
        np.testing.assert_array_equal(m2.kf_frame_id[: m2.n_kfs], m1.kf_frame_id[: m1.n_kfs])
        np.testing.assert_allclose(m2.arrays.kf_pose[: m2.n_kfs].numpy(),
                                   m1.arrays.kf_pose[: m1.n_kfs].numpy(), atol=GROUP_TOL)
        np.testing.assert_allclose(m2.arrays.pt_pos[: m2.n_pts].numpy(),
                                   m1.arrays.pt_pos[: m1.n_pts].numpy(), atol=GROUP_TOL)
    st = slam2.state                                    # gathered in stream order
    np.testing.assert_array_equal(st.Tcw.numpy(), poses2[-1])
    assert slam2.views.ids.shape == (S, 512)


def test_multistream_two_groups_equal_jax_two_devices(two_groups):
    slam, poses, sups = two_groups
    frames = stream_frames(S, STEPS + 1)
    jslam = jms.MultiStreamSLAM(cfg((JSys, JCam, JORB, JMap, JTrk)), S,
                                jms.make_stream_mesh(jax.devices()[:2]))
    jslam.initialize(*frames[0])
    for k in range(1, STEPS + 1):
        jT, _ = jslam.step(*frames[k])
        jslam.flush()
        np.testing.assert_array_equal(sups[k - 1], np.asarray(jslam.last_sup),
                                      err_msg=f"step {k}")
        np.testing.assert_allclose(poses[k - 1], np.asarray(jT), atol=JAX_TOL,
                                   err_msg=f"step {k}")
    assert len(jslam.state.Tcw.sharding.device_set) == 2
    gaps = []
    for s, (jm, tm) in enumerate(zip(jslam.maps, slam.maps)):
        assert (tm.n_kfs, tm.n_pts) == (jm.n_kfs, jm.n_pts), s
        np.testing.assert_array_equal(tm.kf_frame_id[: tm.n_kfs], jm.kf_frame_id[: jm.n_kfs])
        np.testing.assert_array_equal(tm.pt_alive, jm.pt_alive)
        np.testing.assert_allclose(tm.arrays.kf_pose[: tm.n_kfs].numpy(),
                                   np.asarray(jm.arrays.kf_pose)[: jm.n_kfs], atol=JAX_TOL)
        gaps.append(np.abs(tm.arrays.pt_pos[: tm.n_pts].numpy()
                           - np.asarray(jm.arrays.pt_pos)[: jm.n_pts]).max(axis=1))
        assert slam.ref_kf[s] == jslam.ref_kf[s]
    gaps = np.concatenate(gaps)
    assert np.mean(gaps <= PT_TOL) >= PT_SHARE and gaps.max() <= PT_MAX, (
        int((gaps > PT_TOL).sum()), len(gaps), float(gaps.max()))


def test_uneven_stream_split_raises():
    mesh3 = tms.make_stream_mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="do not split evenly over the 3 entries"):
        tms.stream_groups(S, mesh3)
    with pytest.raises(ValueError, match="do not split evenly"):
        tms.split_streams(np.zeros((S, 2), np.float32), mesh3)
    with pytest.raises(ValueError, match="do not split evenly"):
        tms.MultiStreamSLAM(cfg(), S, mesh3)
    assert tms.stream_groups(9, mesh3) == [slice(0, 3), slice(3, 6), slice(6, 9)]
