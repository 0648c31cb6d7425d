"""Port parity: multistream SLAM (parallel/multistream.py) and the FAST op's
vmap rule, at the tiny config of tests/test_multistream.py (128x96, 3
levels, 96 features, max_kpts 128; the live-map runs with MapConfig(16,
4096), 512 local points and min_inliers_local_map 15).

Every test runs with torch's vmap fallback warning turned on and raised
as an error, so an op that silently loops over the streams fails.

Held:
* the vmap rule of the FAST op over (S, L, H, W) equals the plain
  version per image, exactly;
* ``multistream_step`` equals S separate ``fused_frame_step`` calls on
  the same inputs, a stream that goes dark (the LOST fallback) included:
  ``sup`` rows equal, poses within 1e-5;
* the JAX ``MultiStreamSLAM(cfg, 3)`` on its default one-device mesh
  against the port over 12 steps of 3 distinct rooms, each with
  ``flush()`` after every ``step()`` (both resolve keyframes up to 2 steps
  late otherwise; tests/test_torch_pipeline.py holds them under a fixed
  lag): ``sup``
  rows equal every step, poses within 1e-4 (the local-BA gap of
  tests/test_torch_local_ba.py), the same keyframe frames, keyframe and
  landmark counts per stream, landmarks within 1e-3;
* ``init_state``'s pose and velocity are distinct storage;
* the two-pass motion model (the mono and stereo steps' branch) vmaps and
  equals S separate calls;
* the port alone over 8 streams with live maps meets the JAX test's gates
  (>= 2 keyframes per stream, ATE < 8 cm, median < 4 cm).
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.frontend.features import ORBPipeline
from amos_slam_tpu_torch.frontend.tracking import fused_frame_step, index_tree
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod
from amos_slam_tpu_torch.parallel import multistream as tms

CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
ORB = dict(n_features=96, max_kpts=128, n_levels=3, border=8, cell_size=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def no_vmap_fallback():
    """vmap's per-sample fallback warns; here it raises."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def cfg(mod=None):
    Sys, Cam, Orb, Map, Trk = mod or (TSys, TCam, TORB, TMap, TTrk)
    return Sys(camera=Cam(**CAM, bf=10.0), orb=Orb(**ORB),
               map=Map(max_keyframes=16, max_points=4096),
               tracking=Trk(max_map_points_local=512, min_inliers_local_map=15),
               use_dynamics=False)


def stream_frames(S, n):
    """n batches of S streams: distinct rooms (seeds 20 + s), one orbit."""
    gt = synthetic.orbit_trajectory(n, radius=0.08, advance=0.22)
    rooms = [synthetic.default_room(seed=20 + s) for s in range(S)]
    out = [(np.stack([g for g, _ in row]).astype(np.float32),
            np.stack([d for _, d in row]).astype(np.float32))
           for row in synthetic.render_rooms(rooms, gt, **CAM)]
    return gt, out


def _images(seed, shape, low=-50):
    rng = np.random.default_rng(seed)
    img = np.round(rng.uniform(low, 40, shape)).astype(np.float32)
    flat = img.reshape(-1, *shape[-2:])
    h, w = shape[-2:]
    for i in range(flat.shape[0]):
        for y, x in zip(rng.integers(3, h - 6, 30), rng.integers(3, w - 6, 30)):
            flat[i, y: y + 3, x: x + 3] += np.round(rng.uniform(80, 160))
    return torch.from_numpy(img)


@pytest.mark.parametrize("case", ["level_extents", "vmapped_extents", "whole_canvas",
                                  "stream_axis_not_first"])
def test_fast_op_vmap_rule_equals_plain(case):
    S, L, H, W = 3, 4, 70, 128
    x = _images(0, (S, L, H, W))
    levels = torch.tensor([[70, 128], [58, 107], [49, 89], [1, 1]], dtype=torch.int32)
    per_stream = torch.tensor(np.random.default_rng(1).integers(1, [H + 1, W + 1], (S, L, 2)),
                              dtype=torch.int32)
    fmn = fmn_mod.fast_margin_nms
    before = fmn.launches
    with no_vmap_fallback():
        if case == "level_extents":
            out = torch.func.vmap(lambda im: fmn(im, levels))(x)
            ext = [levels] * S
        elif case == "vmapped_extents":
            out = torch.func.vmap(fmn)(x, per_stream)
            ext = list(per_stream)
        elif case == "whole_canvas":
            out = torch.func.vmap(fmn)(x)
            ext = [None] * S
        else:
            out = torch.func.vmap(lambda im: fmn(im, levels), in_dims=1)(
                x.transpose(0, 1).contiguous())
            ext = [levels] * S
    assert fmn.launches == before           # the CPU path launches nothing
    want = torch.stack([fmn_mod.fast_margin_nms_plain(x[s], ext[s]) for s in range(S)])
    assert out.shape == (S, L, H, W)
    assert torch.equal(out, want)


def test_repeated_extents_are_built_once():
    ext = torch.tensor([[70, 128], [35, 64]], dtype=torch.int32)
    rep = fmn_mod.repeated_extents(ext, 8)
    assert rep.shape == (16, 2) and torch.equal(rep, ext.repeat(8, 1))
    assert fmn_mod.repeated_extents(ext, 8) is rep              # cached
    assert fmn_mod.repeated_extents(ext, 2) is not rep          # per S
    ext[1, 0] = 20                                              # in place: rebuilt
    again = fmn_mod.repeated_extents(ext, 8)
    assert again is not rep and int(again[3, 0]) == 20


def test_multistream_step_equals_separate_steps():
    S = 3
    _, frames = stream_frames(S, 5)
    slam = tms.MultiStreamSLAM(cfg(), S, device="cpu")
    with no_vmap_fallback():
        slam.initialize(*frames[0])
        for k in range(1, 6):
            st0, views = slam.state, slam.views
            g, d = frames[min(k, 4)]
            if k == 5:   # stream 1 goes dark: the step's LOST fallback
                g, d = g.copy(), d.copy()
                g[1], d[1] = 0.0, 0.0
            T, _ = slam.step(g, d)
            slam.flush()                 # this step's rows: resolve what is in flight
            sup = slam.last_sup
            sep = [fused_frame_step(
                slam.pipeline, torch.from_numpy(g[s]), torch.from_numpy(d[s]),
                index_tree(st0.feats, s), st0.Tcw[s], st0.velocity[s], index_tree(views, s),
                slam._r_mm, slam._r_map, min_lm=15) for s in range(S)]
            np.testing.assert_array_equal(sup, np.stack([r.sup.numpy() for r in sep]))
            np.testing.assert_allclose(T.numpy(), torch.stack([r.Tcw for r in sep]).numpy(),
                                       atol=1e-5)
    assert all(m.n_kfs >= 2 for m in slam.maps)                 # live views were used
    assert sup[1, 0] < 10 and sup[1, 1] < 15 and (sup[[0, 2], 1] >= 15).all()
    np.testing.assert_array_equal(T[1].numpy(), st0.Tcw[1].numpy())   # pose held


def test_jax_parity_three_streams():
    from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                      ORBConfig as JORB, SystemConfig as JSys,
                                      TrackingConfig as JTrk)
    from amos_slam_tpu.parallel import multistream as jms

    S, n = 3, 13
    _, frames = stream_frames(S, n)
    jslam = jms.MultiStreamSLAM(cfg((JSys, JCam, JORB, JMap, JTrk)), S)
    tslam = tms.MultiStreamSLAM(cfg(), S, device="cpu")
    jslam.initialize(*frames[0])
    with no_vmap_fallback():
        tslam.initialize(*frames[0])
    for k in range(1, n):
        jslam.step(*frames[k])
        jslam.flush()
        with no_vmap_fallback():
            T, _ = tslam.step(*frames[k])
            tslam.flush()
        np.testing.assert_array_equal(tslam.last_sup, np.asarray(jslam.last_sup),
                                      err_msg=f"step {k}")
        np.testing.assert_allclose(T.numpy(), np.asarray(jslam.state.Tcw), atol=1e-4,
                                   err_msg=f"step {k}")
    for s, (jm, tm) in enumerate(zip(jslam.maps, tslam.maps)):
        assert (tm.n_kfs, tm.n_pts) == (jm.n_kfs, jm.n_pts), s
        assert tm.n_kfs >= 3, s
        np.testing.assert_array_equal(tm.kf_frame_id[: tm.n_kfs], jm.kf_frame_id[: jm.n_kfs])
        np.testing.assert_array_equal(tm.pt_alive, jm.pt_alive)
        np.testing.assert_allclose(tm.arrays.kf_pose[: tm.n_kfs].numpy(),
                                   np.asarray(jm.arrays.kf_pose)[: jm.n_kfs], atol=1e-4)
        np.testing.assert_allclose(tm.arrays.pt_pos[: tm.n_pts].numpy(),
                                   np.asarray(jm.arrays.pt_pos)[: jm.n_pts], atol=1e-3)
        assert tslam.ref_kf[s] == jslam.ref_kf[s]


def test_init_state_buffers_are_distinct():
    pipeline = ORBPipeline(TORB(**ORB), TCam(**CAM, bf=10.0), device="cpu")
    g, d = synthetic.render(synthetic.default_room(seed=5), np.eye(4), **CAM)
    S = 2
    with no_vmap_fallback():
        state = tms.init_state(pipeline, torch.from_numpy(np.stack([g] * S)).float(),
                               torch.from_numpy(np.stack([d] * S)).float())
    assert state.Tcw is not state.velocity
    assert state.Tcw.data_ptr() != state.velocity.data_ptr()
    assert torch.equal(state.Tcw, torch.eye(4).repeat(S, 1, 1))
    state.Tcw[0, 0, 3] = 1.0                   # an in-place update stays local
    assert float(state.velocity[0, 0, 3]) == 0.0
    assert state.feats.desc.shape == (S, ORB["max_kpts"], 256)


def test_empty_views_and_mesh():
    v = tms.empty_views(3, 64, device="cpu")
    assert v.ids.shape == (3, 64) and bool((v.ids == -1).all()) and not bool(v.valid.any())
    mesh = tms.make_stream_mesh(["cpu"])
    slam = tms.MultiStreamSLAM(cfg(), 2, mesh)
    assert slam.device == torch.device("cpu") and slam.mesh.axis == "stream"
    assert slam.groups == [slice(0, 2)]
    # a mesh of two entries: two contiguous groups, in mesh order, on their devices
    mesh2 = tms.make_stream_mesh(["cpu", "cpu"])
    slam2 = tms.MultiStreamSLAM(cfg(), 6, mesh2)
    assert slam2.groups == [slice(0, 3), slice(3, 6)]
    assert slam2._where == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert slam2.pipelines[0] is slam2.pipelines[1] is slam2.pipeline   # one device, one pipeline
    assert all(m.device == torch.device("cpu") for m in slam2.maps)
    x = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    parts = tms.split_streams(x, mesh2)
    assert [p.tolist() for p in parts] == [x[:3].tolist(), x[3:].tolist()]
    assert all(p.device == torch.device("cpu") for p in parts)
    assert torch.equal(tms.gather_streams(parts, "cpu"), torch.from_numpy(x))   # stream order


def test_live_maps_eight_streams():
    S, n = 8, 14
    gt, frames = stream_frames(S, n)
    slam = tms.MultiStreamSLAM(cfg(), S, device="cpu")
    with no_vmap_fallback():
        slam.initialize(*frames[0])
        est = [np.tile(np.eye(4), (S, 1, 1))]
        for k in range(1, n):
            T, _ = slam.step(*frames[k])
            est.append(T.numpy().copy())
    slam.flush()
    kfs = [m.n_kfs for m in slam.maps]
    assert all(k >= 2 for k in kfs), kfs
    gt_pos = evaluate.positions_from_cw(np.asarray(gt))
    ates = [evaluate.ate_rmse(evaluate.positions_from_cw(np.stack([e[s] for e in est])), gt_pos)
            for s in range(S)]
    assert max(ates) < 0.08, ates
    assert float(np.median(ates)) < 0.04, ates


def test_two_pass_motion_model_vmaps():
    """The two-pass motion model (the mono and stereo steps' branch) batches
    without a per-stream loop and equals S separate calls."""
    from amos_slam_tpu_torch.frontend.tracking import track_motion_model

    S = 3
    _, frames = stream_frames(S, 2)
    pipe = ORBPipeline(TORB(**ORB), TCam(**CAM, bf=10.0), device="cpu")
    eye = torch.eye(4).repeat(S, 1, 1)
    radius = torch.tensor(10.0)
    with no_vmap_fallback():
        ex = torch.func.vmap(lambda im, d: pipe.extract(im, depth_image=d))
        f0, f1 = (ex(torch.from_numpy(g), torch.from_numpy(d)) for g, d in frames)
        res = torch.func.vmap(lambda c, last, T: track_motion_model(
            pipe.cam, c, last, T, T, radius, two_pass=True))(f1, f0, eye)
    sep = [track_motion_model(pipe.cam, index_tree(f1, s), index_tree(f0, s), eye[s], eye[s],
                              radius, two_pass=True) for s in range(S)]
    assert res.num_inliers.tolist() == [int(r.num_inliers) for r in sep]
    assert min(res.num_inliers.tolist()) > 20
    np.testing.assert_allclose(res.Tcw.numpy(), torch.stack([r.Tcw for r in sep]).numpy(),
                               atol=1e-5)
