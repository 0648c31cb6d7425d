"""The port's System against the JAX package's on the sequence of
``chip_smoke.py`` phase 8, on the CPU at 320x240 (use_dynamics=False; JAX
runs System(deterministic=True)), frame by frame, JAX's draws fed to the
port (test_torch_system_loop.run_pair).

The sequence is ``tools/loop_search.PHASE8``'s sweep without its blackout
and kidnap: ``sweep_and_return(40, 80, 40, yaw=0.7, pitch=1.1, sway=0.2)``
in ``default_room(seed=7)``, 160 frames, default ``loop_consistency_th``
3. On the card at 640x480 the flagship closes two loops on it and ends with
the corrected ATE under the raw one; of the other sweeps searched there,
most that closed a loop ended above it (ROADMAP queue 3, fault 4). This
run asks whether the port does what the reference does on it. Gates: the
same loops_closed, the same keyframes (frame ids), the corrected
trajectories within 5 mm of each other frame by frame. It prints, for
each package, the raw and corrected ATE and, for each loop, the ATE of the
keyframes alive throughout at their track-time poses, before and after
the pose graph, after the global BA and at the end.

The second test runs both packages' ``track_rgbd_chunk`` (chunks of 8,
use_dynamics=False, JAX without ``deterministic``) on the same 160 frames,
JAX's pending work flushed after every call so that its keyframe work
resolves where the port's does (test_torch_system_loop.run_pair with
``chunk``), with the same gates and readings as the first.

Marked slow (four 160-frame Systems, ~6 min on the CPU); run it with
``python -m pytest -m slow -s tests/test_torch_loop_sweep.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from amos_slam_tpu.loop import global_ba as jgba
from amos_slam_tpu.loop import loop_closing as jlc
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.loop import global_ba as tgba
from amos_slam_tpu_torch.loop import loop_closing as tlc
from amos_slam_tpu_torch.tools import loop_search
from test_torch_system_loop import CAM, ate, configs, run_pair

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keyframe_poses(m) -> dict:
    """{frame id: Tcw} of the live keyframes of either package's map."""
    poses = np.asarray(m.arrays.kf_pose[: m.n_kfs], np.float64)
    return {int(m.kf_frame_id[s]): poses[s] for s in range(m.n_kfs) if m.kf_alive[s]}


def record_stages(monkeypatch, lc_mod, gba_mod):
    """Snapshots of the live keyframes around each pose graph and after each
    global BA finishes (the latest loop's: a newer loop aborts it)."""
    loops = []
    pgc, finish = lc_mod.LoopCloser._pose_graph_correct, gba_mod.GlobalBundleAdjustment.finish

    def pose_graph(lc, *args, **kwargs):
        before = keyframe_poses(lc.map)
        res = pgc(lc, *args, **kwargs)
        loops.append({"before_pose_graph": before, "after_pose_graph": keyframe_poses(lc.map)})
        return res

    def after_gba(gba, *args, **kwargs):
        res = finish(gba, *args, **kwargs)
        loops[-1]["after_global_ba"] = keyframe_poses(gba.m)
        return res

    monkeypatch.setattr(lc_mod.LoopCloser, "_pose_graph_correct", pose_graph)
    monkeypatch.setattr(gba_mod.GlobalBundleAdjustment, "finish", after_gba)
    return loops


def readings(s, poses, loops) -> dict:
    raw = np.asarray(s.poses_np())
    end = keyframe_poses(s.map)
    out = {"loops_closed": [list(x) for x in s.loop.loops_closed],
           "ate_raw_m": ate(raw, poses), "ate_m": ate(s.corrected_poses_np(), poses),
           "keyframe_ate_m": []}
    for lp in loops:
        names = ["raw", "before_pose_graph", "after_pose_graph", "after_global_ba",
                 "end_of_sequence"]
        snaps = {**lp, "raw": {f: raw[f] for f in lp["before_pose_graph"]},
                 "end_of_sequence": end}
        names = [x for x in names if x in snaps]
        k = loop_search.keyframe_ate([snaps[x] for x in names], poses)
        out["keyframe_ate_m"].append({"keyframes": len(k["frames"]),
                                      **dict(zip(names, k["ate_m"] or []))})
    return out


def test_phase8_sweep_as_in_jax(monkeypatch):
    planes = synthetic.default_room(seed=loop_search.PHASE8["seed"])
    poses = loop_search.trajectory(loop_search.PHASE8)
    frames = [synthetic.render(planes, T, **CAM) for T in poses]
    jloops = record_stages(monkeypatch, jlc, jgba)
    tloops = record_stages(monkeypatch, tlc, tgba)
    js, ts = run_pair(frames, *configs(), monkeypatch)
    rj, rt = readings(js, poses, jloops), readings(ts, poses, tloops)
    print(json.dumps({"sequence": f"{loop_search.PHASE8} without blackout and kidnap, 320x240",
                      "jax": rj, "port": rt}))
    assert ts.loop.loops_closed == js.loop.loops_closed
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    cj, ct = np.asarray(js.corrected_poses_np()), np.asarray(ts.corrected_poses_np())
    dpos = np.linalg.norm(evaluate.positions_from_cw(cj) - evaluate.positions_from_cw(ct), axis=1)
    assert dpos.max() < 5e-3, dpos.max()


def test_phase8_sweep_chunk_path_readings(monkeypatch):
    planes = synthetic.default_room(seed=loop_search.PHASE8["seed"])
    poses = loop_search.trajectory(loop_search.PHASE8)
    frames = [synthetic.render(planes, T, **CAM) for T in poses]
    jloops = record_stages(monkeypatch, jlc, jgba)
    tloops = record_stages(monkeypatch, tlc, tgba)
    jcfg, tcfg = configs()
    js, ts = run_pair(frames, dataclasses.replace(jcfg, deterministic=False),
                      dataclasses.replace(tcfg, deterministic=False), monkeypatch,
                      chunk=loop_search.W)
    assert any(T.ndim == 3 for T in ts.poses_cw)                  # chunks were tracked
    rj, rt = readings(js, poses, jloops), readings(ts, poses, tloops)
    print(json.dumps({"sequence": f"{loop_search.PHASE8} chunk path, 320x240",
                      "jax": rj, "port": rt}))
    assert ts.loop.loops_closed == js.loop.loops_closed
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    cj, ct = np.asarray(js.corrected_poses_np()), np.asarray(ts.corrected_poses_np())
    dpos = np.linalg.norm(evaluate.positions_from_cw(cj) - evaluate.positions_from_cw(ct), axis=1)
    assert dpos.max() < 5e-3, dpos.max()
