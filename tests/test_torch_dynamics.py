"""Port parity: the geometric dynamic stage (frontend/dynamics.py) against
the JAX package, and its mask-level contracts on the port.

Parity runs at 320x240 (the JAX package's dense LK sampling products are
slow on this CPU at 640x480): the room_with_mover(seed=1, speed=3) pair of
tests/test_dynamics.py, rendered with the camera halved, flow sources from
the JAX ORB front end (4 levels, 500 features, max_kpts 512 or 1024) fed to
both packages, the DynamicsConfig defaults as System passes them (LK on
160x120 frames over 3 levels, SLIC 3 iterations, 256 PnP hypotheses), and
the oracle constant-velocity model. ``jax.random.choice`` cannot be
reproduced by torch: the JAX program here is compute_dynamics traced with
ransac_pnp wrapped to report the draw it makes from its key (nothing in the
package changes), and the port gets that draw as ``pnp_sample_idx``.
Tolerances:

* flow_pts1 within 1e-3 px on >= 99% of the tracks valid in both and
  within 0.05 px on all of them (measured: 1 or 2 tracks of ~200 at
  0.005-0.013 px, the rest within 2e-5 px; the cause is tests/
  test_torch_lk.py's: XLA's CPU program contracts LK's window dot products
  into FMAs, and the bf16-quantized iteration carries such last bits into
  another quantization step on a track that has not settled);
  T_used within 1e-5, gate_state within 1e-4;
* flow_valid and epi_outlier equal on >= 99% of the tracks;
* pixel_cluster and suppress_mask equal on >= 99.5% of the pixels;
* dynamic_cluster and used_pnp exactly equal;
* cases: grey with gate_state carried over 3 consecutive frames; a stage-one
  mask with the colour frame (SLIC in CIELAB); max_kpts 1024, so that the
  1024 sources are subsampled to 512.

Port only, at 640x480 with compute_dynamics' own defaults (the JAX tests'
setting): recall > 0.6 and false positives < 0.25 on the mover pair, < 10%
suppressed on a clean pair, and the luma-matched mover with its colour
frame (recall > 0.5, false positives < 0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, ORBConfig as JORB,
                                  SystemConfig as JSys)
from amos_slam_tpu.frontend import dynamics as jdyn
from amos_slam_tpu.frontend.features import ORBPipeline as JPipe
from amos_slam_tpu_torch.config import SystemConfig as TSys
from amos_slam_tpu_torch.frontend import dynamics as tdyn
from amos_slam_tpu_torch.frontend.features import ORBPipeline as TPipe
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.ops.slic import dilate_mask

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
STATIC = ("n_clusters", "slic_cell", "slic_iters", "dilate_radius", "has_seg",
          "slic_downsample", "lk_levels", "lk_win", "lk_iters", "pnp_hypotheses",
          "lk_downsample")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dynamics():
    """compute_dynamics, freshly traced with ransac_pnp wrapped to report
    its draw; returns (call, draws)."""
    draws = []
    orig = jdyn.ransac_pnp

    def recording_pnp(cam, pts_w, uv, valid, key, n_hyp=512, **kw):
        probs = valid.astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        idx = jax.random.choice(key, pts_w.shape[0], shape=(n_hyp, 6), p=probs)
        jax.debug.callback(lambda i: draws.append(np.asarray(i)), idx)
        return orig(cam, pts_w, uv, valid, key, n_hyp=n_hyp, **kw)

    def fresh(*args, **kwargs):   # a new function: no cached trace applies
        return jdyn.compute_dynamics.__wrapped__(*args, **kwargs)

    fn = jax.jit(fresh, static_argnames=STATIC)
    jdyn.ransac_pnp = recording_pnp
    try:
        yield fn, draws
    finally:
        jdyn.ransac_pnp = orig


def _mover_frames(ids, times, **render_kw):
    poses = synthetic.orbit_trajectory(20, radius=0.05, advance=0.1)
    out = []
    for i, t in zip(ids, times):
        planes, mover = synthetic.room_with_mover(seed=1, t=t, speed=3.0)
        planes[mover].chroma = (1.6, 0.85, 0.55)
        g, d, m, rgb = synthetic.render(planes, poses[i], return_ids=True, return_rgb=True,
                                        **render_kw)
        out.append((g, d, m == mover, rgb.astype(np.float32), poses[i]))
    return out


@pytest.fixture(scope="module")
def small_frames():
    return _mover_frames(range(3, 7), [i / 30.0 for i in range(3, 7)], **CAM)


def _pipes(max_kpts):
    jc = JSys(camera=JCam(**CAM), orb=JORB(n_features=500, n_levels=4, max_kpts=max_kpts))
    return JPipe(jc.orb, jc.camera), TPipe(jc.orb, jc.camera, device="cpu"), jc.dynamics


def _t(x):
    return torch.from_numpy(np.array(x))


def _run_pair(jax_dynamics, jp, tp, dcfg, f0, f1, frame_idx, seg=False, rgb=False,
              gates=(jnp.zeros(3, jnp.float32), None)):
    fn, draws = jax_dynamics
    g0, d0, _, _, T0 = f0
    g1, d1, m1, rgb1, T1 = f1
    kp = jp.detect_keypoints(jnp.asarray(g0))[0]
    T0 = T0.astype(np.float32)
    vel = (T1 @ np.linalg.inv(f0[4])).astype(np.float32)
    kw = tdyn.config_kwargs(dcfg)
    rj = fn(jp.cam, jnp.asarray(g0), jnp.asarray(d0), jnp.asarray(g1), jnp.asarray(d1),
            jnp.asarray(m1 if seg else np.zeros_like(m1)), jnp.asarray(T0), jnp.asarray(vel),
            kp.xy, kp.valid, frame_idx, has_seg=seg,
            cur_rgb=jnp.asarray(rgb1) if rgb else None, gate_state=gates[0], **kw)
    jax.block_until_ready(rj)
    jax.effects_barrier()
    idx = draws[-1]
    rt = tdyn.compute_dynamics(
        tp.cam, _t(g0), _t(d0), _t(g1), _t(d1), _t(m1) if seg else None, _t(T0), _t(vel),
        _t(kp.xy), _t(kp.valid), frame_idx, has_seg=seg,
        cur_rgb=_t(rgb1) if rgb else None, gate_state=gates[1],
        pnp_sample_idx=_t(idx).long(), **kw)
    return rj, rt


def _assert_parity(rj, rt):
    vj, vt = np.asarray(rj.flow_valid), rt.flow_valid.numpy()
    assert (vj == vt).mean() >= 0.99
    both = vj & vt
    gap = np.abs(rt.flow_pts1.numpy() - np.asarray(rj.flow_pts1)).max(axis=1)
    assert (gap[both] < 1e-3).mean() >= 0.99, np.sort(gap[both])[-5:]
    assert gap[both].max() < 0.05, np.sort(gap[both])[-5:]
    np.testing.assert_allclose(rt.T_used.numpy(), np.asarray(rj.T_used), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rt.gate_state.numpy(), np.asarray(rj.gate_state), atol=1e-4,
                               rtol=0)
    assert (rt.epi_outlier.numpy() == np.asarray(rj.epi_outlier)).mean() >= 0.99
    assert (rt.pixel_cluster.numpy() == np.asarray(rj.pixel_cluster)).mean() >= 0.995
    assert (rt.suppress_mask.numpy() == np.asarray(rj.suppress_mask)).mean() >= 0.995
    np.testing.assert_array_equal(rt.dynamic_cluster.numpy(), np.asarray(rj.dynamic_cluster))
    assert bool(rt.used_pnp) == bool(rj.used_pnp)
    np.testing.assert_array_equal(rt.geom_mask.numpy() | rt.suppress_mask.numpy(),
                                  rt.suppress_mask.numpy())


def test_compute_dynamics_matches_jax_gates_carried(jax_dynamics, small_frames):
    """Three consecutive frames, each package carrying its own gate_state."""
    jp, tp, dcfg = _pipes(512)
    gj, gt = jnp.zeros(3, jnp.float32), None   # both mean a cold start
    for k in range(3):
        rj, rt = _run_pair(jax_dynamics, jp, tp, dcfg, small_frames[k], small_frames[k + 1],
                           4 + k, gates=(gj, gt))
        _assert_parity(rj, rt)
        gj, gt = rj.gate_state, rt.gate_state
    mover = small_frames[-1][2]
    sup = rt.suppress_mask.numpy()
    assert (sup & mover).sum() / mover.sum() > 0.6       # the mover is caught
    assert float(rt.gate_state.abs().sum()) > 0           # the EMA warmed up


def test_compute_dynamics_matches_jax_seg_and_rgb(jax_dynamics, small_frames):
    jp, tp, dcfg = _pipes(512)
    rj, rt = _run_pair(jax_dynamics, jp, tp, dcfg, small_frames[0], small_frames[1], 4,
                       seg=True, rgb=True)
    _assert_parity(rj, rt)
    # the dilated stage-one mask is part of the suppression
    seg = dilate_mask(_t(small_frames[1][2]), dcfg.mask_dilate_radius).numpy()
    assert (rt.suppress_mask.numpy() >= seg).all()


def test_compute_dynamics_matches_jax_1024_sources(jax_dynamics, small_frames):
    jp, tp, dcfg = _pipes(1024)
    rj, rt = _run_pair(jax_dynamics, jp, tp, dcfg, small_frames[0], small_frames[1], 4)
    assert rt.flow_pts1.shape == (512, 2)                 # flow_pts[::2][:512]
    _assert_parity(rj, rt)


# ---- port only, at 640x480 -------------------------------------------------
@pytest.fixture(scope="module")
def pipe640():
    cfg = TSys()
    return TPipe(cfg.orb, cfg.camera, device="cpu")


def _port_dyn(pipe, g0, d0, g1, d1, T0, T1, frame_idx, rgb=None):
    kp = pipe.detect_keypoints(_t(g0))[0]
    vel = (T1 @ np.linalg.inv(T0)).astype(np.float32)
    return tdyn.compute_dynamics(
        pipe.cam, _t(g0), _t(d0), _t(g1), _t(d1), None, _t(T0.astype(np.float32)), _t(vel),
        kp.xy, kp.valid, frame_idx, has_seg=False,
        cur_rgb=None if rgb is None else _t(rgb).float())


def _recall_fp(sup, mover, trail_from):
    trail = dilate_mask(_t(trail_from), 24).numpy()
    return (sup & mover).sum() / max(mover.sum(), 1), (sup & ~trail).sum() / (~trail).sum()


def test_port_mask_level_contracts_640(pipe640):
    """tests/test_dynamics.py's mover and clean pairs on the port."""
    (g0, d0, m0, _, T0), (g1, d1, m1, _, T1) = _mover_frames((3, 4), (0.1, 0.1333))
    res = _port_dyn(pipe640, g0, d0, g1, d1, T0, T1, 0)
    sup = res.suppress_mask.numpy()
    recall, fp = _recall_fp(sup, m1, m0 | m1)
    assert recall > 0.6, recall
    assert fp < 0.25, fp
    assert sup.shape == (480, 640) and res.pixel_cluster.shape == (480, 640)

    poses = synthetic.orbit_trajectory(10, radius=0.05, advance=0.1)
    planes = synthetic.default_room(seed=2)
    (c0, e0), (c1, e1) = (synthetic.render(planes, poses[i]) for i in (3, 4))
    clean = _port_dyn(pipe640, c0, e0, c1, e1, poses[3], poses[4], 1)
    assert float(clean.suppress_mask.float().mean()) < 0.1


def test_luma_matched_mover_needs_color(pipe640):
    """tests/test_color_and_adversarial.py's luma-matched mover: with the
    colour frame, the CIELAB superpixels isolate it."""
    n0 = 10
    poses = synthetic.orbit_trajectory(16, radius=0.08, advance=0.15)
    frames = []
    for i in (n0, n0 + 1):
        planes, mid = synthetic.luma_matched_mover(i / 30.0)
        g, d, ids, rgb = synthetic.render(planes, poses[i], return_ids=True, return_rgb=True)
        frames.append((g, d, ids == mid, rgb))
    (g0, d0, _, _), (g1, d1, m1, rgb1) = frames
    res = _port_dyn(pipe640, g0, d0, g1, d1, poses[n0], poses[n0 + 1], 0, rgb=rgb1)
    recall, fp = _recall_fp(res.suppress_mask.numpy(), m1, m1)
    assert recall > 0.5, recall
    assert fp < 0.25, fp
