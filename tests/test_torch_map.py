"""Port parity: triangulation, the map kernels, local-map tracking and the
SlamMap methods, on state carried across from the JAX package.

Setup: a 320x240 synthetic room (4 levels, 500 features, max_kpts 512,
MapConfig(max_keyframes=32, max_points=8192), max_map_points_local 2048).
The JAX package extracts the features and builds the map; every port call
gets the same state through ``convert`` (FrameFeatures, MapArrays, the host
mirrors). Tolerances:

* triangulate_dlt and epipolar_distance: 1e-5 relative.
* triangulate_pair: match_j and good exact; good points: median gap
  1e-4 m, largest 2.5 mm (the f32 DLT is conditioning-limited: at the
  test's 0.31 m baseline either package is up to ~1.3 mm from an f64
  evaluation; both are held within 2.5 mm of it).
* each map_state kernel, and each SlamMap method (device arrays and host
  mirrors): ints and bools exact, floats within 1e-6 (absolute and
  relative).
* track_local_map: kp_point_id, visible_ids, found_ids exact, pose 1e-4.
* _fuse_match_kernel and _triangulate_batch_kernel: packed outputs exact;
  the batch's points, normals and scale ranges within 5 mm (median 0.5 mm;
  the DLT gap again, at a 0.16 m baseline). SlamMap.create_new_points:
  landmark positions within 2.5 mm for the same reason.
* the scratch slots pt_valid[M-1] and kf_valid[K-1] stay False.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                  ORBConfig as JORB, SystemConfig as JSys,
                                  TrackingConfig as JTrk)
from amos_slam_tpu.frontend.features import ORBPipeline as JPipe
from amos_slam_tpu.geometry import triangulate as jtd
from amos_slam_tpu.slam_map import map_state as jms
from amos_slam_tpu.slam_map import slam_map as jsm
from amos_slam_tpu.slam_map import triangulation as jtri
from amos_slam_tpu.solvers import fundamental as jfund
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.frontend.features import FrameFeatures
from amos_slam_tpu_torch.geometry import triangulate as ttd
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.slam_map import map_state as tms
from amos_slam_tpu_torch.slam_map import slam_map as tsm
from amos_slam_tpu_torch.slam_map import triangulation as ttri
from amos_slam_tpu_torch.solvers import fundamental as tfund

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192)
TRK = dict(max_map_points_local=2048)
KF_FRAMES = (0, 3, 6)


def jcfg():
    return JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**MAP),
                tracking=JTrk(**TRK), use_dynamics=False)


def tcfg():
    return TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                tracking=TTrk(**TRK), use_dynamics=False)


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_close(out, ref, name="", atol=1e-6):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(out, ref, err_msg=name)


def assert_same_arrays(mt, mj, atol=None):
    """atol: per-field absolute tolerances beyond the default 1e-6."""
    out = convert.tree_to_numpy(mt)
    for name in tms.MapArrays._fields:
        assert_close(out[name], getattr(mj, name), name, (atol or {}).get(name, 1e-6))


HOST = convert._MAP_HOST_ARRAYS + convert._MAP_HOST_INTS


def dump(m):
    """Numpy snapshot of a JAX SlamMap (arrays + host mirrors)."""
    return {"arrays": jms.MapArrays(*(np.array(x) for x in m.arrays)),
            **{k: copy.deepcopy(getattr(m, k)) for k in HOST}}


def assert_same_map(mt, snap, atol=None):
    assert_same_arrays(mt.arrays, snap["arrays"], atol)
    for k in HOST:
        assert_close(getattr(mt, k), snap[k], k)
    a = mt.arrays
    assert not bool(a.pt_valid[mt.M - 1]) and not bool(a.kf_valid[mt.K - 1])


@pytest.fixture(scope="module")
def world():
    planes = synthetic.default_room(seed=1)
    poses = synthetic.orbit_trajectory(8, radius=0.15, advance=0.3)
    pipe = JPipe(JORB(**ORB), JCam(**CAM))
    feats = {}
    for i in KF_FRAMES + (7,):
        g, d = synthetic.render(planes, poses[i], fx=CAM["fx"], fy=CAM["fy"],
                                cx=CAM["cx"], cy=CAM["cy"], width=320, height=240)
        f = pipe.extract(jnp.asarray(g), jnp.asarray(d))
        if i in KF_FRAMES[1:]:
            # depth holes at every third keypoint: their landmarks can only
            # come from triangulation between keyframes
            hole = jnp.arange(f.depth.shape[0]) % 3 == 0
            f = f._replace(depth=jnp.where(hole, -1.0, f.depth),
                           u_right=jnp.where(hole, -1.0, f.u_right))
        feats[i] = f
    cam_t = convert.camera_from_numpy(pipe.cam, device="cpu")
    return poses, pipe, feats, cam_t


def tfeats(f):
    return convert.tree_from_numpy(FrameFeatures, f, "cpu")


# ---------------------------------------------------------------- geometry

def test_triangulate_dlt_and_epipolar_distance(rng):
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    T1, T2 = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    # a well-conditioned pair: f32 DLT amplifies rounding by the system's
    # condition number (at a 0.3 m baseline and 8 m depth both packages
    # stray ~1e-4 relative from an f64 evaluation, each its own way)
    T2[:3, 3] = [1.0, 0.1, -0.05]
    X = np.c_[rng.uniform(-2, 2, (200, 2)), rng.uniform(2, 5, 200)].astype(np.float32)
    P1, P2 = K @ T1[:3], K @ T2[:3]

    def proj(P):
        y = np.c_[X, np.ones(200)] @ P.T
        return (y[:, :2] / y[:, 2:] + rng.normal(0, 0.3, (200, 2))).astype(np.float32)

    x1, x2 = proj(P1), proj(P2)
    Xj, wj = jtd.triangulate_dlt(*(jnp.asarray(a) for a in (P1, P2, x1, x2)))
    Xt, wt = ttd.triangulate_dlt(*(_t(a) for a in (P1, P2, x1, x2)))
    Xj = np.asarray(Xj)
    rel = np.linalg.norm(Xt.numpy() - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert rel.max() < 1e-5, rel.max()
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-9)
    assert np.median(np.linalg.norm(Xt.numpy() - X, axis=1)) < 0.05

    F = rng.normal(size=(3, 3, 3)).astype(np.float32)
    dj = jfund.epipolar_distance(jnp.asarray(F), jnp.asarray(x1), jnp.asarray(x2))
    dt = tfund.epipolar_distance(_t(F), _t(x1), _t(x2))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_triangulate_pair(world):
    poses, pipe, feats, cam_t = world
    f1, f2 = feats[0], feats[6]
    T1, T2 = (np.asarray(poses[i], np.float32) for i in (0, 6))
    un = np.ones(ORB["max_kpts"], bool)
    args_j = (f1.xy_un, f1.desc, f1.valid, jnp.asarray(un), f1.kp.angle, jnp.asarray(T1),
              f2.xy_un, f2.desc, f2.valid, jnp.asarray(un), f2.kp.angle, jnp.asarray(T2))
    rj = jtri.triangulate_pair(pipe.cam, *args_j)
    rt = ttri.triangulate_pair(cam_t, *(_t(a) for a in args_j))
    np.testing.assert_array_equal(rt.match_j.numpy(), np.asarray(rj.match_j))
    good = np.asarray(rj.good)
    np.testing.assert_array_equal(rt.good.numpy(), good)
    assert good.sum() > 50
    # The f32 DLT at this 0.31 m baseline is conditioning-limited: each
    # package strays up to ~1.3 mm from an f64 evaluation of the same
    # matches, in its own rounding order. So the median gap is held to
    # 1e-4 m, the largest to 2.5 mm, and both packages to the f64 points.
    Xt, Xj = rt.points_w.numpy()[good], np.asarray(rj.points_w)[good]
    gap = np.linalg.norm(Xt - Xj, axis=1)
    assert np.median(gap) < 1e-4 and gap.max() < 2.5e-3, (np.median(gap), gap.max())
    j = np.maximum(np.asarray(rj.match_j), 0)
    K = cam_t.K.double()
    X64, _ = ttd.triangulate_dlt(K @ _t(T1[:3]).double(), K @ _t(T2[:3]).double(),
                                 _t(f1.xy_un).double(), _t(np.asarray(f2.xy_un)[j]).double())
    X64 = X64.numpy()[good]
    for X in (Xt, Xj):
        assert np.abs(X - X64).max() < 2.5e-3


# ---------------------------------------------------------------- the map

@pytest.fixture(scope="module")
def maps(world):
    """A JAX SlamMap grown through every SlamMap method. Before each
    method the map is carried across to the port, the method runs on both,
    and the port's map is kept beside a snapshot of the JAX map."""
    poses, pipe, feats, cam_t = world
    jm = jsm.SlamMap(jcfg(), pipe.cam)
    out = {}
    none = np.full(ORB["max_kpts"], -1, np.int64)

    def both(name, fj, ft):
        tm = convert.slam_map_from(jm, tcfg(), cam_t, "cpu")
        rj = fj(jm)
        rt = ft(tm)
        out[name] = (tm, dump(jm), rj, rt)

    both("insert_first",
         lambda m: m.insert_keyframe(feats[0], jnp.asarray(poses[0], jnp.float32), none, 0),
         lambda m: m.insert_keyframe(tfeats(feats[0]), _t(np.float32(poses[0])), none, 0))
    for n, i in enumerate(KF_FRAMES[1:], start=1):
        view = jm.local_view(n - 1)
        T = jnp.asarray(poses[i], jnp.float32)
        lm = jsm.track_local_map(pipe.cam, feats[i], view, T, jnp.asarray(6.0))
        kp = np.array(lm.kp_point_id).astype(np.int64)
        both(f"insert_{n}",
             lambda m: m.insert_keyframe(feats[i], lm.Tcw, kp, i),
             lambda m: m.insert_keyframe(tfeats(feats[i]), _t(lm.Tcw), kp, i))
        both(f"create_new_points_{n}",
             lambda m: m.create_new_points(n), lambda m: m.create_new_points(n))
    both("local_view", lambda m: m.local_view(2), lambda m: m.local_view(2))
    both("fuse_neighbors", lambda m: m.fuse_neighbors(2), lambda m: m.fuse_neighbors(2))
    vis = np.full(2048, -1, np.int32)
    vis[:600] = np.arange(600)
    fnd = np.where(np.arange(2048) % 3 == 0, vis, -1).astype(np.int32)

    def bump_cull(m, conv):
        for _ in range(6):
            m.bump_stats(conv(vis), conv(fnd))
        m.cull_points()

    both("cull_points", lambda m: bump_cull(m, jnp.asarray), lambda m: bump_cull(m, _t))
    both("refresh_landmarks", lambda m: m.refresh_landmarks(2),
         lambda m: m.refresh_landmarks(2))
    both("run_local_ba", lambda m: m.run_local_ba(2), lambda m: m.run_local_ba(2))
    both("cull_keyframes", lambda m: m.cull_keyframes(2), lambda m: m.cull_keyframes(2))

    def remove_compact(m):
        m._remove_keyframe(1)
        return m.compact_keyframes()

    both("compact_keyframes", remove_compact, remove_compact)
    both("grow_keyframes", lambda m: m.grow_keyframes(), lambda m: m.grow_keyframes())
    return out


DLT_ATOL = dict(pt_pos=2.5e-3, pt_normal=1e-3, pt_min_dist=1e-3, pt_max_dist=5e-3)
METHODS = ["insert_first", "insert_1", "create_new_points_1", "insert_2",
           "create_new_points_2", "local_view", "fuse_neighbors", "cull_points",
           "refresh_landmarks", "cull_keyframes", "compact_keyframes",
           "grow_keyframes"]


@pytest.mark.parametrize("name", METHODS)
def test_slam_map_methods(maps, name):
    tm, snap, rj, rt = maps[name]
    # triangulated landmarks carry the f32 DLT gap (see triangulate_pair):
    # positions within 2.5 mm, their normals and scale ranges accordingly
    tri = name.startswith("create_new_points")
    assert_same_map(tm, snap, DLT_ATOL if tri else None)
    if name == "local_view":
        for f in tsm.LocalView._fields:
            assert_close(getattr(rt, f).numpy(), getattr(rj, f), f)
    elif name == "compact_keyframes":
        np.testing.assert_array_equal(rt, rj)
    elif rj is not None:
        assert rt == rj, (rt, rj)


def test_map_grows_through_the_methods(maps):
    tm = maps["create_new_points_2"][0]
    assert tm.n_kfs == 3 and tm.n_pts > 500
    assert maps["create_new_points_2"][3] > 10        # triangulated landmarks
    assert maps["compact_keyframes"][0].n_kfs < 3
    assert maps["grow_keyframes"][0].K == 2 * MAP["max_keyframes"]


def test_local_ba_in_the_map(maps):
    """run_local_ba moves poses and points within 1e-4 of JAX (the JAX
    solver aggregates landmark sums in bf16 hi/lo, ~2^-16 relative)."""
    tm, snap, _, _ = maps["run_local_ba"]
    out = convert.tree_to_numpy(tm.arrays)
    np.testing.assert_allclose(out["kf_pose"], snap["arrays"].kf_pose, atol=1e-4)
    np.testing.assert_allclose(out["pt_pos"], snap["arrays"].pt_pos, atol=1e-3)
    before = maps["refresh_landmarks"][1]["arrays"].kf_pose
    assert np.abs(out["kf_pose"][1:3] - before[1:3]).max() > 1e-7   # BA moved them


# ---------------------------------------------------------------- kernels

def _state(maps, after="create_new_points_2"):
    """The JAX map after a step (default: the second triangulation, 3
    keyframes, landmarks with one to three observations)."""
    tm, snap, _, _ = maps[after]
    return snap["arrays"], tm


def _kernel_case(name, a, rng, feats, n_pts):
    """(JAX call, port call) of one map_state kernel on numpy map ``a``."""
    N, M, K = a.kf_obs.shape[1], a.pt_pos.shape[0], a.kf_pose.shape[0]
    i32 = lambda x: np.asarray(x, np.int32)
    if name == "insert_keyframe":
        f = feats[7]
        valid, close = np.asarray(f.valid), np.asarray(f.depth) > 0
        matched = i32(np.where(rng.random(N) < 0.4, rng.integers(0, n_pts, N), -1))
        create = valid & close & (matched < 0)
        new_ids = i32(np.where(create, n_pts + np.cumsum(create) - 1, -1))
        T = np.asarray(synthetic.orbit_trajectory(8, radius=0.15, advance=0.3)[7], np.float32)
        fields = (f.xy_un, f.u_right, f.depth, f.inv_sigma2, f.kp.angle, f.kp.level,
                  f.desc, f.valid)
        rest = (matched, create, new_ids)
        return (lambda m, cam: jms.insert_keyframe_kernel(
                    m, jnp.asarray(3, jnp.int32), jnp.asarray(T), *fields,
                    *(jnp.asarray(x) for x in rest), cam, scale_factor=1.2, n_levels=4),
                lambda m, cam: tms.insert_keyframe_kernel(
                    m, 3, _t(T), *(_t(x) for x in fields + rest), cam,
                    scale_factor=1.2, n_levels=4))
    if name == "add_points":
        ids = i32(np.where(rng.random(N) < 0.3, n_pts + np.arange(N), -1))
        pos = rng.normal(0, 2, (N, 3)).astype(np.float32)
        nrm = rng.normal(0, 1, (N, 3)).astype(np.float32)
        mn, mx = (rng.uniform(0.1, 9, N).astype(np.float32) for _ in range(2))
        kp_a = i32(np.where(rng.random(N) < 0.9, np.arange(N), -1))
        kp_b = i32(np.where(rng.random(N) < 0.9, rng.permutation(N), -1))
        arrs = (ids, pos, a.kf_desc[2], nrm, mn, mx)
        return (lambda m, cam: jms.add_points_kernel(
                    m, *(jnp.asarray(x) for x in arrs), jnp.asarray(2, jnp.int32),
                    jnp.asarray(2, jnp.int32), jnp.asarray(kp_a), jnp.asarray(1, jnp.int32),
                    jnp.asarray(kp_b)),
                lambda m, cam: tms.add_points_kernel(
                    m, *(_t(x) for x in arrs), 2, 2, _t(kp_a), 1, _t(kp_b)))
    if name == "bump_point_stats":
        vis = i32(np.where(rng.random(2048) < 0.7, rng.integers(0, n_pts, 2048), -1))
        fnd = i32(np.where(rng.random(2048) < 0.5, vis, -1))
        return (lambda m, cam: jms.bump_point_stats_kernel(m, jnp.asarray(vis), jnp.asarray(fnd)),
                lambda m, cam: tms.bump_point_stats_kernel(m, _t(vis), _t(fnd)))
    if name == "bump_point_stats_rows":
        ids = i32(np.where(rng.random(2048) < 0.8, rng.permutation(2048), -1))
        acc = i32(rng.integers(0, 9, (2048, 2)))
        return (lambda m, cam: jms.bump_point_stats_rows_kernel(m, jnp.asarray(ids), jnp.asarray(acc)),
                lambda m, cam: tms.bump_point_stats_rows_kernel(m, _t(ids), _t(acc)))
    if name == "apply_ba":
        slots = i32([0, 1, 2, 0, 0, 0])
        ok = np.array([False, True, True, False, False, False])
        poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
        poses[:, :3, 3] = rng.normal(0, 1, (6, 3))
        pts = np.full(1024, -1, np.int32)
        pts[: min(n_pts, 1024)] = rng.permutation(n_pts)[:1024]
        pts = i32(np.where(rng.random(1024) < 0.8, pts, -1))
        new = rng.normal(0, 2, (1024, 3)).astype(np.float32)
        arrs = (slots, ok, poses, pts, new)
        return (lambda m, cam: jms.apply_ba_kernel(m, *(jnp.asarray(x) for x in arrs)),
                lambda m, cam: tms.apply_ba_kernel(m, *(_t(x) for x in arrs)))
    if name == "refresh_landmarks":
        V = 2048
        ids = i32(np.where(np.arange(V) < n_pts, np.arange(V), -1))
        kf_of = i32(rng.integers(0, 3, (V, 8)))
        kp_of = i32(rng.integers(0, 40, (V, 8)))   # few keypoints: many ties
        cnt = i32(rng.integers(0, 9, V))
        arrs = (ids, kf_of, kp_of, cnt)
        return (lambda m, cam: jms.refresh_landmarks_kernel(m, *(jnp.asarray(x) for x in arrs)),
                lambda m, cam: tms.refresh_landmarks_kernel(m, *(_t(x) for x in arrs)))
    if name == "compact_keyframes":
        alive = np.array([0, 2])
        src, ok, lut = np.zeros(K, np.int32), np.zeros(K, bool), np.full(K, -1, np.int32)
        src[:2], ok[:2], lut[alive] = alive, True, np.arange(2)
        return (lambda m, cam: jms.compact_keyframes_kernel(
                    m, jnp.asarray(src), jnp.asarray(ok), jnp.asarray(lut)),
                lambda m, cam: tms.compact_keyframes_kernel(m, _t(src), _t(ok), _t(lut)))
    if name == "cull_points":
        cull = i32(np.where(rng.random(2048) < 0.3, rng.permutation(n_pts)[:2048] if n_pts >= 2048
                            else rng.integers(0, n_pts, 2048), -1))
        cull = i32(np.where(np.r_[True, np.diff(np.sort(cull)) != 0][np.argsort(np.argsort(cull))],
                            cull, -1))
        return (lambda m, cam: jms.cull_points_kernel(m, jnp.asarray(cull)),
                lambda m, cam: tms.cull_points_kernel(m, _t(cull)))
    raise KeyError(name)


KERNELS = ["insert_keyframe", "add_points", "bump_point_stats", "bump_point_stats_rows",
           "apply_ba", "refresh_landmarks", "compact_keyframes", "cull_points"]


@pytest.mark.parametrize("name", KERNELS)
def test_map_state_kernels(maps, world, rng, name):
    a, tm = _state(maps)
    _, pipe, feats, cam_t = world
    fj, ft = _kernel_case(name, a, rng, feats, tm.n_pts)
    out_j = fj(jms.MapArrays(*(jnp.asarray(x) for x in a)), pipe.cam)
    out_t = ft(convert.tree_from_numpy(tms.MapArrays, a, "cpu"), cam_t)
    assert_same_arrays(out_t, jms.MapArrays(*(np.asarray(x) for x in out_j)))
    changed = [f for f in tms.MapArrays._fields
               if not np.array_equal(np.asarray(getattr(out_j, f)), getattr(a, f))]
    assert changed, name


def test_track_local_map(maps, world):
    a, tm = _state(maps)
    poses, pipe, feats, cam_t = world
    jm = jsm.SlamMap(jcfg(), pipe.cam)
    jm.arrays = jms.MapArrays(*(jnp.asarray(x) for x in a))
    ids = np.full(2048, -1, np.int32)
    alive = np.where(tm.pt_alive)[0][:2048]
    ids[: len(alive)] = alive
    view_j = jsm._gather_view(jm.arrays, jnp.asarray(ids))
    view_t = tsm._gather_view(convert.tree_from_numpy(tms.MapArrays, a, "cpu"), _t(ids))
    for f in tsm.LocalView._fields:
        assert_close(getattr(view_t, f).numpy(), getattr(view_j, f), f)
    T0 = np.asarray(poses[7], np.float32).copy()
    T0[:3, 3] += [0.01, -0.005, 0.008]
    for r in (6.0, 18.0):
        rj = jsm.track_local_map(pipe.cam, feats[7], view_j, jnp.asarray(T0), jnp.asarray(r))
        rt = tsm.track_local_map(cam_t, tfeats(feats[7]), view_t, _t(T0), torch.tensor(r))
        for f in ("kp_point_id", "visible_ids", "found_ids", "num_inliers"):
            np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), f)
        np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)
        assert int(rt.num_inliers) > 100


def test_fuse_and_triangulate_batch_kernels(maps, world):
    a, tm = _state(maps, after="insert_2")   # keypoints left to triangulate
    _, pipe, _, cam_t = world
    aj = jms.MapArrays(*(jnp.asarray(x) for x in a))
    at = convert.tree_from_numpy(tms.MapArrays, a, "cpu")
    nbs = np.array([1, 0, 0, 0], np.int32)
    nb_ok = np.array([True, True, False, False])
    my_obs = a.kf_obs[2].astype(np.int32)
    pj = jsm._fuse_match_kernel(aj, pipe.cam, jnp.asarray(2, jnp.int32), jnp.asarray(nbs),
                                jnp.asarray(nb_ok), jnp.asarray(my_obs))
    pt = tsm._fuse_match_kernel(at, cam_t, 2, nbs, nb_ok, _t(my_obs))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt[1].sum() > 50

    un = a.kf_obs[nbs] < 0
    rj = jsm._triangulate_batch_kernel(
        aj, pipe.cam, jnp.asarray(2, jnp.int32), jnp.asarray(nbs), jnp.asarray(nb_ok),
        jnp.asarray(a.kf_obs[2] < 0), jnp.asarray(un), scale_factor=1.2, n_levels=4)
    rt = tsm._triangulate_batch_kernel(at, cam_t, 2, nbs, nb_ok,
                                       _t(a.kf_obs[2] < 0), _t(un), scale_factor=1.2, n_levels=4)
    np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
    good = np.asarray(rj[0][1]) > 0
    assert good.sum() > 10
    # the points carry the f32 DLT gap, here at a 0.16 m baseline
    for out, ref in zip(rt[1:], rj[1:]):
        gap = np.abs(out.numpy()[good] - np.asarray(ref)[good])
        assert np.median(gap) < 5e-4 and gap.max() < 5e-3, (np.median(gap), gap.max())


def test_build_ba_problem_and_apply(maps, world, rng):
    """The BA problem assembly shared with global BA, and the scatter back."""
    _, snap, _, _ = maps["create_new_points_2"]
    tm = convert.slam_map_from(_jax_map(snap, world[1]), tcfg(), world[3], "cpu")
    jm = _jax_map(snap, world[1])
    slots, free = np.array([2, 1, 0]), np.array([True, True, False])
    pt_ids = np.where(jm.pt_alive)[0][:1024]
    pj, sj, fj, ij = jm.build_ba_problem(slots, free, pt_ids, 12, 1024)
    pt, st, ft, it = tm.build_ba_problem(slots, free, pt_ids, 12, 1024)
    for f in pj._fields:
        assert_close(getattr(pt, f).numpy(), getattr(pj, f), f)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(it, ij)
    poses = np.asarray(pj.kf_pose) + rng.normal(0, 1e-3, (12, 4, 4)).astype(np.float32)
    pts = np.asarray(pj.points) + rng.normal(0, 1e-2, (1024, 3)).astype(np.float32)
    jm.apply_ba_result(sj, fj, ij, jnp.asarray(poses), jnp.asarray(pts))
    tm.apply_ba_result(st, ft, it, _t(poses), _t(pts))
    assert_same_map(tm, dump(jm))


def _jax_map(snap, pipe):
    """A JAX SlamMap holding a snapshot's state."""
    jm = jsm.SlamMap(jcfg(), pipe.cam)
    jm.arrays = jms.MapArrays(*(jnp.asarray(x) for x in snap["arrays"]))
    for k in HOST:
        setattr(jm, k, copy.deepcopy(snap[k]))
    return jm
