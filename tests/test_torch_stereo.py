"""Port parity: the stereo matcher (ops/stereo.py), project_stereo, and the
fused stereo step's features.

A rectified pair rendered from default_room(seed=4) at 320x240 (4 levels,
500 features), the right camera shifted by bf / fx = 0.0747 m. Tolerances:

* match_stereo, with the JAX pipeline's descriptors, keypoints and blurred
  level-0 images given to both packages: ``valid`` equal, ``u_right`` and
  ``depth`` within 1e-4 (px, m), against the JAX function run eagerly and
  under jit (the two agree bit for bit on these inputs).
* project_stereo: 1e-4 px.
* the port's own front end on the same pair: > 150 matches, median depth
  error < 5% of the renderer's depth (tests/test_stereo_init.py gates its
  640x480 pair at 3%; at 320x240 the disparities are halved, and the JAX
  pipeline's own median here is 4.36%), and the JAX matcher on the port's
  features gives the same depths within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import CameraConfig as JCam, ORBConfig as JORB
from amos_slam_tpu.frontend.features import ORBPipeline as JPipe
from amos_slam_tpu.geometry import camera as jcamera
from amos_slam_tpu.ops.stereo import match_stereo as jmatch
from amos_slam_tpu_torch.config import CameraConfig as TCam, ORBConfig as TORB
from amos_slam_tpu_torch.frontend import tracking as ttrack
from amos_slam_tpu_torch.frontend.features import ORBPipeline as TPipe
from amos_slam_tpu_torch.geometry import camera as tcamera
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.ops.stereo import match_stereo as tmatch

BF = 20.0
CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240, bf=BF)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    planes = synthetic.default_room(seed=4)
    kw = dict(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"], width=320, height=240)
    T_r = np.eye(4)
    T_r[0, 3] = -BF / CAM["fx"]
    gl, dl = synthetic.render(planes, np.eye(4), **kw)
    gr, _ = synthetic.render(planes, T_r, **kw)
    return gl, gr, dl


@pytest.fixture(scope="module")
def jax_inputs(pair):
    gl, gr, _ = pair
    pipe = JPipe(JORB(**ORB), JCam(**CAM))
    kl, _, bl, pl = pipe.detect_keypoints(jnp.asarray(gl))
    kr, _, br, pr = pipe.detect_keypoints(jnp.asarray(gr))
    fl, fr = pipe.describe(kl, pl), pipe.describe(kr, pr)
    return (fl.desc, kl.xy, kl.level, fl.valid, fr.desc, kr.xy, kr.level, fr.valid,
            bl[0], br[0], pipe.cam.bf, pipe.cam.bf / pipe.cam.fx)


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jit"])
def test_match_stereo_matches_jax(jax_inputs, jitted):
    rj = (jax.jit(jmatch) if jitted else jmatch)(*jax_inputs)
    rt = tmatch(*[torch.from_numpy(np.array(a)) for a in jax_inputs])
    v = np.asarray(rj.valid)
    assert v.sum() > 150
    np.testing.assert_array_equal(rt.valid.numpy(), v)
    np.testing.assert_allclose(rt.u_right.numpy(), np.asarray(rj.u_right), atol=TOL, rtol=0)
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth), atol=TOL, rtol=0)


def test_project_stereo_matches_jax():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(0.5, 5, (64, 1))], -1)
    pts = pts.astype(np.float32)
    jc = jcamera.Camera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], bf=BF,
                               width=320, height=240)
    tc = tcamera.Camera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], bf=BF,
                               width=320, height=240)
    uj, zj = jcamera.project_stereo(jc, jnp.asarray(pts))
    ut, zt = tcamera.project_stereo(tc, torch.from_numpy(pts))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=TOL, rtol=0)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))


def test_port_front_end_depth(pair):
    """The port's own extraction on both images, then its matcher (as the
    fused stereo step runs them), against the renderer's depth."""
    gl, gr, dl = pair
    pipe = TPipe(TORB(**ORB), TCam(**CAM), "cpu")
    kl, _, bl, pl = pipe.detect_keypoints(torch.from_numpy(gl))
    kr, _, br, pr = pipe.detect_keypoints(torch.from_numpy(gr))
    feats = ttrack.stereo_features(pipe, kl, bl, pl, kr, br, pr, pipe.cam.bf / pipe.cam.fx)
    ok = (feats.depth > 0).numpy()
    assert ok.sum() > 150
    assert np.array_equal(ok, (feats.u_right >= 0).numpy())
    xy = feats.kp.xy.numpy()
    gt = dl[np.clip(xy[:, 1].round().astype(int), 0, 239),
            np.clip(xy[:, 0].round().astype(int), 0, 319)]
    sel = ok & (gt > 0)
    rel = np.abs(feats.depth.numpy()[sel] - gt[sel]) / gt[sel]
    assert np.median(rel) < 0.05, np.median(rel)
    # the same features through the JAX matcher give the same depths
    fr = pipe.describe(kr, pr)
    j = jmatch(*[jnp.asarray(x.numpy()) for x in (
        feats.desc, kl.xy, kl.level, feats.valid, fr.desc, kr.xy, kr.level, fr.valid,
        bl[0], br[0], pipe.cam.bf, pipe.cam.bf / pipe.cam.fx)])
    np.testing.assert_allclose(feats.depth.numpy(), np.asarray(j.depth), atol=TOL, rtol=0)
