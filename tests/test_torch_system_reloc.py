"""The port's System relocalizing a LOST frame against the JAX package's,
on the CPU at 320x240 (use_dynamics=False; JAX runs
System(deterministic=True)), frame by frame on the same rendered frames,
JAX's PnP draws fed to the port (test_torch_system_loop.run_pair).

The sequence: tests/test_reloc_loop.py:22-52's room and trajectory
(orbit_trajectory(30, radius=0.12, advance=0.25) in default_room(seed=5)).
At 320x240 its map holds two keyframes when that test's blackout (frames
12-14) hits, so both packages take the reference's auto-reset of a map of
<= 5 keyframes and never relocalize. Here the map is kept: frames 0-19 are
tracked, localization mode starts at frame 20 (keyframes stop, the map
stays), frames 20-22 have zero grey and depth, and the camera comes back
at the poses of frames 2-9, too far from the held pose for the motion
model, so the BoW relocalizer must place it.

Gates: the same frames relocalized (``"reloc": True`` in stats), at least
one, state OK, ATE < 2 cm over the frames outside the blackout, and the
relocalizer localizing the last frame with >= 25 inliers
(tests/test_reloc_loop.py:43-44).
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.system import TrackingState
from test_torch_system_loop import CAM, ate, configs, run_pair

BLACKOUT = (20, 23)          # frames with zero grey and depth
REVISIT = (2, 10)            # the poses the camera comes back at


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_blackout_relocalizes_as_in_jax(monkeypatch):
    planes = synthetic.default_room(seed=5)
    orbit = synthetic.orbit_trajectory(30, radius=0.12, advance=0.25)
    b0, b1 = BLACKOUT
    poses = orbit[:b0] + [orbit[b0]] * (b1 - b0) + orbit[REVISIT[0]: REVISIT[1]]
    frames = []
    for i, T in enumerate(poses):
        g, d = synthetic.render(planes, T, **CAM)
        if b0 <= i < b1:
            g, d = np.zeros_like(g), np.zeros_like(d)
        frames.append((g, d))
    js, ts = run_pair(frames, *configs(max_keyframes=32), monkeypatch, localize_from=b0)
    rj = [i for i, s in enumerate(js.stats) if s.get("reloc")]
    rt = [i for i, s in enumerate(ts.stats) if s.get("reloc")]
    assert rj, "the fixture lost its relocalization"
    assert rt == rj
    assert ts.state is TrackingState.OK
    keep = [i for i in range(len(poses)) if not b0 <= i < b1]
    a = ate(ts.poses_np(), poses, keep)
    assert a < 0.02, a
    reloc = ts.loop.relocalize(ts.last_feats)
    assert reloc is not None and reloc[1] >= 25, reloc
