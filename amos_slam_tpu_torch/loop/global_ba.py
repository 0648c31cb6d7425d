"""Global map refinement, the reference's background global BA (port of
loop/global_ba.py).

LoopClosing::RunGlobalBundleAdjustment (src/LoopClosing.cc:881) runs a full
BA after a loop closes, abortable when a new loop arrives (mbStopGBA), with
a spanning-tree merge for keyframes inserted while it ran
(src/LoopClosing.cc:920-1010). Two flavours:

* :class:`GlobalBundleAdjustment` -- joint camera + structure LM over all
  keyframes (Optimizer::GlobalBundleAdjustemnt), reusing the local-BA Schur
  solver with the keyframe axis padded to a power-of-two bucket and the
  landmark set capped to the most-observed points. It runs in phases of a
  few LM iterations; between phases the caller may abort. On finish,
  keyframes and landmarks created during the solve follow their reference
  keyframe's correction.
* :func:`run_global_refinement` -- motion-then-structure alternation
  (pose-graph GN over all keyframes, then structure-only landmark refits).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..geometry import se3
from ..solvers.local_ba import solve_local_ba
from ..solvers.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..solvers.structure_only import refine_points


def _bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n, clamped to [lo, hi]."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


class GlobalBundleAdjustment:
    """Abortable, phase-wise joint global BA.

        gba = GlobalBundleAdjustment(slam_map, fixed_kf=cand)
        gba.run(abort_check=lambda: new_loop_arrived)
    or phase-wise:
        while gba.step():
            if should_abort: gba.abort(); break
        gba.finish()   # no-op if aborted
    """

    def __init__(self, slam_map, fixed_kf: int = 0, phases: int = 3,
                 iters_per_phase=(2, 2), max_points: Optional[int] = None):
        m = slam_map
        self.m = m
        self.aborted = False
        self.finished = False
        self.phases_left = phases
        self.iters = iters_per_phase
        self.k0 = m.n_kfs          # keyframes snapshot: later ones merge
        self.n_pts0 = m.n_pts

        alive = np.where(m.kf_alive[: m.n_kfs])[0]
        self.alive = alive
        free = alive != fixed_kf
        if free.all() and len(alive) > 0:
            free[0] = False        # gauge
        self.free = free
        cap = max_points or 4 * m.cfg.map.ba_max_points
        pt_ids = np.where(m.pt_alive)[0]
        self.capped = len(pt_ids) > cap
        if self.capped:
            pt_ids = pt_ids[np.argsort(-m.pt_obs_count[pt_ids])[:cap]]
        self.pt_set = pt_ids
        # padded axes in power-of-two buckets (the JAX package's shapes)
        Kb = _bucket(len(alive), 32, m.K)
        Pb = _bucket(len(pt_ids), 256, cap)
        self.prob, self.slots_t, self.free_p, self.pt_ids_p = m.build_ba_problem(
            alive, free, pt_ids, Kb, Pb)

    def step(self) -> bool:
        """Run one LM phase. Returns True while phases remain."""
        if self.aborted or self.finished or self.phases_left <= 0:
            return False
        res = solve_local_ba(self.m.cam, self.prob, iters_phase1=self.iters[0],
                             iters_phase2=self.iters[1])
        self.prob = self.prob._replace(kf_pose=res.kf_pose, points=res.points)
        self.phases_left -= 1
        return self.phases_left > 0

    def abort(self):
        """Cooperative abort (mbStopGBA): the result is discarded and
        finish() becomes a no-op."""
        self.aborted = True

    def finish(self):
        """Apply the solution and merge keyframes and landmarks created
        while the solve ran (the spanning-tree merge,
        src/LoopClosing.cc:920-1010)."""
        if self.aborted or self.finished:
            return
        self.finished = True
        m = self.m
        K_now = m.n_kfs
        # the current poses before applying, and the solution: one read
        host = torch.cat([m.arrays.kf_pose[:K_now], self.prob.kf_pose]).cpu().numpy()
        poses_old, new_poses = host[:K_now], host[K_now:]
        m.apply_ba_result(self.slots_t, self.free_p, self.pt_ids_p, self.prob.kf_pose,
                          self.prob.points)

        # keyframes inserted after the snapshot take their spanning-tree
        # parent's correction, in slot order (parents have lower slots).
        # The problem's keyframe axis is in self.alive order.
        if K_now > self.k0 or self.capped or m.n_pts > self.n_pts0:
            corrected = poses_old.copy()
            corrected[self.alive[self.free]] = new_poses[: len(self.alive)][self.free]
            for k in range(self.k0, K_now):
                p = int(m.kf_parent[k])
                parent = p if 0 <= p < k else k - 1
                rel = poses_old[k] @ np.linalg.inv(poses_old[parent])
                corrected[k] = rel @ corrected[parent]
            if K_now > self.k0:
                m.arrays.kf_pose[self.k0: K_now] = m._t(corrected[self.k0:], torch.float32)
            # landmarks outside the optimized set (capped out, or created
            # during the solve): re-anchored through their first keyframe
            in_set = np.zeros(m.M, bool)
            in_set[self.pt_set] = True
            first = m.pt_birth_kf   # host mirror of pt_first_kf
            ids = np.where(m.pt_alive & ~in_set & (first >= 0) & (first < K_now))[0]
            if len(ids) > 0:
                f = first[ids]
                T_old = poses_old[f]
                T_new = corrected[f]
                ids_t = m._t(ids, torch.long)
                pts = m.arrays.pt_pos[ids_t].cpu().numpy()
                pc = np.einsum("nij,nj->ni", T_old[:, :3, :3], pts) + T_old[:, :3, 3]
                Rn = T_new[:, :3, :3].transpose(0, 2, 1)
                pw = np.einsum("nij,nj->ni", Rn, pc - T_new[:, :3, 3])
                m.arrays.pt_pos[ids_t] = m._t(pw, torch.float32)
            m.version += 1

    def run(self, abort_check: Optional[Callable[[], bool]] = None):
        """Run all phases with the abort flag checked between them, then
        apply and merge."""
        while self.step():
            if abort_check is not None and abort_check():
                self.abort()
                return
        self.finish()


def harvest_observations(slam_map, ids: np.ndarray, max_obs: int = 8):
    """Padded (P, OBS) observation tables (keyframe slot, keypoint index)
    for the given landmark ids, from the host mirror."""
    P = len(ids)
    kf_of = np.zeros((P, max_obs), np.int64)
    kp_of = np.zeros((P, max_obs), np.int64)
    cnt = np.zeros(P, np.int64)
    remap = {int(p): i for i, p in enumerate(ids)}
    obs = slam_map.kf_obs_np[: slam_map.n_kfs]
    kfs, kps = np.where(obs >= 0)
    for kf, kp in zip(kfs, kps):
        li = remap.get(int(obs[kf, kp]))
        if li is not None and cnt[li] < max_obs:
            kf_of[li, cnt[li]] = kf
            kp_of[li, cnt[li]] = kp
            cnt[li] += 1
    return kf_of, kp_of, cnt


def run_global_refinement(
    slam_map,
    fixed_kf: int = 0,
    pose_iters: int = 15,
    structure_iters: int = 4,
    covis_edge_th: int = 30,
    max_points: int = 0,
):
    """Motion-then-structure global refinement over the whole map."""
    m = slam_map
    K = m.n_kfs
    if K < 3:
        return
    # 1. pose graph over all keyframes: the odometry chain between
    # consecutive alive keyframes + covisibility edges
    a = m.arrays
    # a copy: on the CPU, .numpy() is a view of the poses written below
    poses_old = a.kf_pose[:K].cpu().numpy().copy()
    kf_ok = a.kf_valid[:K].cpu().numpy()
    alive = np.where(kf_ok)[0]
    if len(alive) < 3:
        return
    covis_ok = np.triu(m.covis[:K, :K] >= covis_edge_th, k=2)
    covis_ok &= kf_ok[:, None] & kf_ok[None, :]
    ci, cj = np.nonzero(covis_ok)
    ei = np.concatenate([alive[:-1], ci]).astype(np.int64)
    ej = np.concatenate([alive[1:], cj]).astype(np.int64)
    ew = np.concatenate([np.ones(len(alive) - 1), np.full(len(ci), 0.5)]).astype(np.float32)
    Ri = poses_old[ei, :3, :3]
    ti = poses_old[ei, :3, 3]
    Tj = poses_old[ej]
    eR = np.einsum("nij,nkj->nik", Tj[:, :3, :3], Ri)   # Rj Ri^T
    et = Tj[:, :3, 3] - np.einsum("nij,nj->ni", eR, ti)
    E = len(ei)
    fixed = np.zeros(K, bool)
    fixed[fixed_kf] = True
    t = m._t
    f32 = dict(dtype=torch.float32, device=m.device)
    prob = PoseGraphProblem(
        R=t(poses_old[:, :3, :3], torch.float32), t=t(poses_old[:, :3, 3], torch.float32),
        s=torch.ones(K, **f32), pose_valid=t(kf_ok, torch.bool), pose_fixed=t(fixed, torch.bool),
        edge_i=t(ei, torch.long), edge_j=t(ej, torch.long),
        edge_R=t(eR, torch.float32), edge_t=t(et, torch.float32),
        edge_s=torch.ones(E, **f32), edge_w=t(ew, torch.float32),
    )
    res = optimize_pose_graph(prob, iters=pose_iters, fix_scale=True)
    m.version += 1
    m.arrays.kf_pose[:K] = se3.make_T(res.R, res.t)

    # 2. structure-only refinement
    ids = np.where(m.pt_alive)[0]
    if max_points and len(ids) > max_points:
        ids = ids[np.argsort(-m.pt_obs_count[ids])[:max_points]]
    if len(ids) == 0:
        return
    kf_of, kp_of, cnt = harvest_observations(m, ids)
    a = m.arrays
    kf_t, kp_t, ids_t = t(kf_of, torch.long), t(kp_of, torch.long), t(ids, torch.long)
    obs_valid = (torch.arange(kf_of.shape[1], device=m.device)[None, :]
                 < t(cnt, torch.long)[:, None]).to(torch.float32)
    X, _ = refine_points(m.cam, a.pt_pos[ids_t], a.pt_valid[ids_t], a.kf_pose[kf_t],
                         a.kf_xy[kf_t, kp_t], obs_valid, a.kf_inv_sigma2[kf_t, kp_t],
                         iters=structure_iters)
    m.arrays.pt_pos[ids_t] = X
