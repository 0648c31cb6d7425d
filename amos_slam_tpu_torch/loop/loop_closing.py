"""Loop detection, Sim3 verification and loop correction (port of
loop/loop_closing.py).

The counterpart of the reference's LoopClosing thread
(src/LoopClosing.cc:72-880). It runs at keyframe rate on the host and
dispatches tensor work on the map's device:

  detect   -> BoW retrieval (kf_database) with 3-consistent covisibility
              groups (DetectLoop, src/LoopClosing.cc:134-250)
  verify   -> a full Hamming match, 3D from the matched landmarks (the
              keyframe depth as the RGB-D fallback), Horn Sim3/SE3 RANSAC,
              mutual-reprojection refinement (OptimizeSim3), then a guided
              re-search from the corrected similarity against the
              candidate's covisible landmarks with the reference's >= 40
              accept gate (src/LoopClosing.cc:509-560)
  correct  -> essential-graph pose-graph Gauss-Newton over all keyframes
              (covisibility + spanning tree + loop edges; 7-DoF with free
              scale for monocular), landmarks re-anchored through their
              first keyframe's correction, SearchAndFuse across the loop
              (src/LoopClosing.cc:690-810), then a joint global BA stepped
              one phase per keyframe

The two draws (the Sim3 RANSAC's and the relocalizer's PnP) come from
generators seeded as the JAX package seeds its keys (the keyframe slot, the
candidate + 99): torch cannot reproduce ``jax.random``, so the parity tests
feed JAX's draws through ``sample_idx``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..geometry import se3
from ..geometry.camera import Camera, backproject, in_image, project
from ..geometry.sim3 import Sim3
from ..ops import hamming
from ..slam_map.slam_map import SlamMap, _scatter_obs_kernel, track_local_map
from ..solvers.pnp import ransac_pnp
from ..solvers.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..solvers.sim3_solver import optimize_sim3, ransac_sim3
from .kf_database import KeyFrameDatabase
from .vocabulary import Vocabulary, _transform_impl, bow_vector, l1_score, transform


def _bow_for_slot(arrays, slot: int, levels, node_valid, idf, k: int, depth: int):
    """BoW transform of a stored keyframe's descriptors. Returns (2, N)
    float32 [word, weight] (word ids <= k^depth are exact in f32)."""
    desc = arrays.kf_desc[slot]
    valid = arrays.kf_kp_valid[slot]
    words = _transform_impl(levels, node_valid, desc, k, depth)
    w = idf[words]
    words = torch.where(valid, words, -1)
    w = torch.where(valid, w, 0.0)
    return torch.stack([words.to(torch.float32), w])


def _loop_pairs_kernel(a, cam: Camera, slot: int, cand: int):
    """Match slot-keyframe keypoints against the candidate's and build
    3D-3D pairs in camera coordinates: 3D from the matched keypoints'
    landmark positions (through the owning keyframe's pose), the keyframe
    depth as the fallback (src/Sim3Solver.cc:61-141)."""
    d = hamming.hamming_matrix(a.kf_desc[slot], a.kf_desc[cand])
    ok = a.kf_kp_valid[slot][:, None] & a.kf_kp_valid[cand][None, :]
    res = hamming.match(hamming.apply_mask(d, ok), max_dist=60, nn_ratio=0.75, mutual=True,
                        angle_q=a.kf_angle[slot], angle_t=a.kf_angle[cand])
    j = torch.clamp(res.idx, min=0)

    def kp_3d(kf, kp_sel=None):
        """(camera-coord points, has-3d) for a keyframe's keypoint rows."""
        obs = a.kf_obs[kf] if kp_sel is None else a.kf_obs[kf][kp_sel]
        xy = a.kf_xy[kf] if kp_sel is None else a.kf_xy[kf][kp_sel]
        dep = a.kf_depth[kf] if kp_sel is None else a.kf_depth[kf][kp_sel]
        gather = torch.clamp(obs, min=0).long()
        has_lm = (obs >= 0) & a.pt_valid[gather]
        p_lm = se3.transform_points(a.kf_pose[kf], a.pt_pos[gather])
        p_d = backproject(cam, xy, torch.clamp(dep, min=1e-3))
        return torch.where(has_lm[:, None], p_lm, p_d), has_lm | (dep > 0)

    p1c, has1 = kp_3d(slot)
    p2c, has2 = kp_3d(cand, j)
    pair_ok = res.valid & has1 & has2
    return (res.idx, pair_ok, p1c, p2c, a.kf_xy[slot], a.kf_xy[cand][j],
            a.kf_inv_sigma2[slot], a.kf_inv_sigma2[cand][j])


def _guided_search_kernel(a, cam: Camera, slot: int, cand: int, view_ids, gR, gt, gs, radius):
    """SearchByProjection with the corrected similarity (src/ORBmatcher.cc:388):
    project the candidate side's landmark neighbourhood into the slot
    keyframe through g^-1 o T_cand, then window-match descriptors. Returns
    per view row (match keypoint index in slot, valid), and the count."""
    g_inv = Sim3(R=gR, t=gt, s=gs).inverse()
    gather = torch.clamp(view_ids, min=0).long()
    pw = a.pt_pos[gather]
    vvalid = (view_ids >= 0) & a.pt_valid[gather]
    q2 = se3.transform_points(a.kf_pose[cand], pw)    # candidate-camera coords
    q1 = g_inv.apply(q2)                              # slot-camera coords
    uv, z = project(cam, q1)
    vis = vvalid & (z > 0.05) & in_image(cam, uv, border=8.0)
    d = hamming.hamming_matrix(a.pt_desc[gather], a.kf_desc[slot])
    wmask = hamming.window_mask(uv, a.kf_xy[slot], radius, vis, a.kf_kp_valid[slot])
    res = hamming.match(hamming.apply_mask(d, wmask), max_dist=55, nn_ratio=1.0, mutual=True)
    return res.idx, res.valid, torch.sum(res.valid, dtype=torch.int32)


class LoopCloser:
    def __init__(self, cfg: SystemConfig, cam: Camera, voc: Vocabulary, slam_map: SlamMap):
        self.cfg = cfg
        self.cam = cam
        self.voc = voc
        self.map = slam_map
        self.db = KeyFrameDatabase(voc.n_words)
        # covisibility-consistency state: list of (group frozenset, streak)
        self.consistent_groups: List[Tuple[frozenset, int]] = []
        # reference mnCovisibilityConsistencyTh = 3 (src/LoopClosing.cc:48)
        self.consistency_th = cfg.map.loop_consistency_th
        self.last_loop_kf = -999
        self.loops_closed: List[Tuple[int, int]] = []
        self.fused_last_loop = 0   # SearchAndFuse merge count (diagnostics)
        self.rejected_by_gate = 0  # guided re-search rejections (diagnostics)
        self.detections = 0        # DetectLoop candidates verified (diagnostics)
        # in-flight joint global BA (the reference's GBA thread,
        # src/LoopClosing.cc:881): one LM phase per keyframe tick, aborted
        # when a new loop verifies (mbStopGBA)
        self.gba = None
        self.gba_aborts = 0

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.map.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def bow_dispatch(self, slot: int) -> torch.Tensor:
        """Device half: the stored keyframe's BoW transform, packed (2, N)
        [word, weight]; read it and hand it to :meth:`on_keyframe_resolve`."""
        return _bow_for_slot(self.map.arrays, slot, self.voc.levels, self.voc.node_valid,
                             self.voc.idf, self.voc.k, self.voc.depth)

    def on_keyframe(self, slot: int) -> bool:
        """Process a freshly inserted keyframe; returns True if a loop was
        closed (poses and points were rewritten)."""
        return self.on_keyframe_resolve(slot, self.bow_dispatch(slot).cpu().numpy())

    def on_keyframe_resolve(self, slot: int, ww: np.ndarray) -> bool:
        words_np = ww[0].astype(np.int64)
        weights_np = ww[1]
        # keyframes culled since the last tick leave the BoW index
        # (KeyFrameDatabase::erase on SetBadFlag)
        for culled in self.map.drain_culled():
            self.db.erase(culled)
        # advance the in-flight global BA by one LM phase per keyframe
        if self.gba is not None and not self.gba.step():
            self.gba.finish()
            self.gba = None

        closed = False
        if slot - self.last_loop_kf > 5 and self.map.n_kfs > 8:
            cand = self._detect(slot, words_np, weights_np)
            if cand is not None:
                self.detections += 1
                closed = self._verify_and_correct(slot, cand)
                if closed:
                    self.last_loop_kf = slot
                    self.loops_closed.append((slot, cand))
        self.db.add(slot, words_np, weights_np)
        return closed

    # ------------------------------------------------------------------
    def remap_slots(self, lut: np.ndarray):
        """Rewrite keyframe slot references after a map compaction. An
        in-flight global BA indexes pre-compaction slots, so it is aborted."""
        if self.gba is not None:
            self.gba.abort()
            self.gba = None
        self.db.remap(lut)
        groups = []
        for g, streak in self.consistent_groups:
            g2 = frozenset(int(lut[k]) for k in g if lut[k] >= 0)
            if g2:
                groups.append((g2, streak))
        self.consistent_groups = groups
        if self.last_loop_kf >= 0:
            self.last_loop_kf = (int(lut[self.last_loop_kf])
                                 if lut[self.last_loop_kf] >= 0 else -999)
        self.loops_closed = [
            (int(lut[a]) if lut[a] >= 0 else -1, int(lut[b]) if lut[b] >= 0 else -1)
            for a, b in self.loops_closed
        ]

    # ------------------------------------------------------------------
    def flush_gba(self):
        """Drain an in-flight global BA to completion (at shutdown and before
        exports, where the reference joins its GBA thread)."""
        if self.gba is not None:
            while self.gba.step():
                pass
            self.gba.finish()
            self.gba = None

    # ------------------------------------------------------------------
    def relocalize(self, feats) -> Optional[Tuple[np.ndarray, int]]:
        """Relocalize a LOST frame against the keyframe database
        (Tracking::Relocalization, src/Tracking.cc:2591): BoW candidates ->
        descriptor matching -> PnP-RANSAC on the matched keypoints' landmark
        world positions (depth backprojection as the RGB-D fallback). A
        first pass with [10, 50) inliers gets the reference's second stage
        (src/Tracking.cc:2715-2788): one track_local_map from the PnP pose
        over the candidate's local view, accepted at >= 50 inliers. Returns
        (Tcw, num_inliers) or None."""
        if not self.db.kf_bow:
            return None
        words, weights = transform(self.voc, feats.desc, feats.valid)
        ww = torch.stack([words.to(torch.float32), weights]).cpu().numpy()
        cands = self.db.query(ww[0].astype(np.int64), ww[1], max_candidates=3)
        a = self.map.arrays
        best = None
        for cand in cands:
            d = hamming.hamming_matrix(feats.desc, a.kf_desc[cand])
            ok = feats.valid[:, None] & a.kf_kp_valid[cand][None, :]
            res = hamming.match(hamming.apply_mask(d, ok), max_dist=60, nn_ratio=0.75,
                                mutual=True)
            j = torch.clamp(res.idx, min=0)
            obs = a.kf_obs[cand][j]
            gather = torch.clamp(obs, min=0).long()
            has_lm = (obs >= 0) & a.pt_valid[gather]
            kf_depth = a.kf_depth[cand][j]
            pc = backproject(self.cam, a.kf_xy[cand][j], torch.clamp(kf_depth, min=1e-3))
            pts_d = se3.transform_points(se3.inv_T(a.kf_pose[cand]), pc)
            pts_w = torch.where(has_lm[:, None], a.pt_pos[gather], pts_d)
            pair_ok = res.valid & (has_lm | (kf_depth > 0))
            if int(torch.sum(pair_ok)) < 15:
                continue
            pnp = ransac_pnp(self.cam, pts_w, feats.xy_un, pair_ok,
                             self._generator(cand + 99), inlier_th_px=4.0, min_inliers=10)
            ok_n = torch.stack([pnp.ok.to(torch.int32), pnp.num_inliers]).cpu()
            if not bool(ok_n[0]):
                continue
            n = int(ok_n[1])
            Tcw = pnp.Tcw
            # a solid first pass stands on its own; a marginal one is usable
            # only if the second stage confirms it at the reference's gate
            ok_cand = n >= 20
            if n < 50:
                view = self.map.local_view(cand)
                lm = track_local_map(self.cam, feats, view, Tcw,
                                     torch.tensor(10.0, device=self.map.device))
                n2 = int(lm.num_inliers)
                if n2 >= 50 and n2 > n:
                    n, Tcw, ok_cand = n2, lm.Tcw, True
            if ok_cand and (best is None or n > best[1]):
                best = (Tcw.cpu().numpy(), n)
        return best

    # ------------------------------------------------------------------
    def _covis_group(self, kf: int) -> frozenset:
        covis_row = self.map.covis[kf, : self.map.n_kfs]
        return frozenset(np.where(covis_row > 0)[0].tolist()) | {kf}

    def _detect(self, slot: int, words, weights) -> Optional[int]:
        """BoW candidates outside the covisible neighbourhood, gated by the
        least covisible score, then covisibility-group temporal consistency:
        a candidate is accepted once its group has intersected a previously
        detected group in >= consistency_th consecutive detections
        (DetectLoop, src/LoopClosing.cc:134-250)."""
        covis_row = self.map.covis[slot, : self.map.n_kfs]
        neighbours = set(np.where(covis_row > 0)[0].tolist())
        neighbours.add(slot)
        # also exclude temporally recent keyframes
        neighbours.update(range(max(0, slot - 4), slot + 1))

        min_score = 1e-3
        nz, vals = bow_vector(words, weights, self.voc.n_words)
        scores = [
            l1_score(nz, vals, *self.db.kf_bow[nb])
            for nb in np.where(covis_row >= self.cfg.map.covis_weight_th)[0]
            if nb in self.db.kf_bow
        ]
        if scores:
            min_score = max(min(scores), 1e-3)

        cands = self.db.query(
            words, weights, exclude=sorted(neighbours), min_score=min_score,
            covis=self.map.covis[: self.map.n_kfs, : self.map.n_kfs], max_candidates=3)
        if not cands:
            self.consistent_groups = []
            return None

        # each candidate's group extends the streak of any previous group it
        # intersects (the reference's mvConsistentGroups)
        chosen = None
        new_groups: List[Tuple[frozenset, int]] = []
        for c in cands:
            group = self._covis_group(c)
            streak = 1
            for prev_group, prev_streak in self.consistent_groups:
                if group & prev_group:
                    streak = max(streak, prev_streak + 1)
            new_groups.append((group, streak))
            if streak >= self.consistency_th and chosen is None:
                chosen = c
        self.consistent_groups = new_groups
        return chosen

    # ------------------------------------------------------------------
    def _verify_and_correct(self, slot: int, cand: int) -> bool:
        a = self.map.arrays
        cam = self.cam
        mono = self.cfg.sensor == "mono"
        dev = self.map.device

        (idx, pair_ok, p1c, p2c, xy1, xy2, is2_1, is2_2) = _loop_pairs_kernel(a, cam, slot, cand)

        # 3D-3D Horn RANSAC. The inlier threshold is metric for RGB-D; a
        # monocular map's scale is arbitrary (and drifts), so the mono
        # threshold scales with the slot side's median scene depth (the
        # mean of the two middle values, as jnp.nanmedian)
        if mono:
            z = torch.where(pair_ok, p1c[:, 2], torch.nan)
            inlier_th = torch.maximum(0.04 * torch.nanquantile(z, 0.5),
                                      torch.tensor(1e-4, device=dev))
        else:
            inlier_th = 0.08
        sres = ransac_sim3(p1c, p2c, pair_ok, self._generator(slot), fix_scale=not mono,
                           inlier_th=inlier_th)
        ok_n = torch.stack([sres.ok.to(torch.int32), sres.num_inliers]).cpu()
        if not bool(ok_n[0]) or int(ok_n[1]) < 20:
            return False

        # Sim3 refinement by mutual reprojection (OptimizeSim3) over the
        # RANSAC inliers
        opt = optimize_sim3(cam, sres.sim3, p1c, xy1, p2c, xy2, pair_ok & sres.inliers,
                            is2_1, is2_2, fix_scale=not mono)
        if int(opt.num_inliers) < 20:
            return False
        g = opt.sim3

        # guided re-search with the corrected similarity and the reference's
        # >= 40 gate: what kills perceptual-aliasing false positives that
        # survive the 3D RANSAC
        cand_kfs = self.map.local_keyframes(cand, 6)
        view_ids = self.map.local_point_ids(cand_kfs)
        V = self.cfg.tracking.max_map_points_local
        if len(view_ids) > V:
            view_ids = view_ids[:V]
        ids_p = np.full(V, -1, np.int64)
        ids_p[: len(view_ids)] = view_ids
        gidx, gvalid, n_guided = _guided_search_kernel(
            a, cam, slot, cand, self.map._t(ids_p), g.R, g.t, g.s,
            torch.tensor(8.0, device=dev))
        host = torch.cat([gidx.to(torch.int32), gvalid.to(torch.int32),
                          n_guided.reshape(1)]).cpu().numpy()
        if int(host[-1]) < 40:
            self.rejected_by_gate += 1
            return False

        # a verified new loop aborts any in-flight global BA before the
        # correction rewrites the map (mbStopGBA, src/LoopClosing.cc:591-595)
        if self.gba is not None:
            self.gba.abort()
            self.gba = None
            self.gba_aborts += 1

        gh = torch.cat([g.R.reshape(-1), g.t, g.s.reshape(1)]).cpu().numpy()
        T_rel = np.eye(4, dtype=np.float32)
        T_rel[:3, :3] = gh[:9].reshape(3, 3)
        T_rel[:3, 3] = gh[9:12]
        s_rel = float(gh[12])
        self._pose_graph_correct(slot, cand, T_rel, s_rel)
        # the loop edge persists (KeyFrame::AddLoopEdge): later essential
        # graphs keep this loop rigid, and its endpoints are cull-protected
        self.map.loop_edges.append((slot, cand, T_rel.copy(), s_rel))

        # SearchAndFuse across the loop from the guided-search matches
        self.fused_last_loop = self._fuse_across_loop(slot, ids_p, host[:V], host[V:2 * V] > 0)

        # the joint global BA: its first LM phase now, the later ones on the
        # next keyframe ticks, aborted if another loop verifies meanwhile
        from .global_ba import GlobalBundleAdjustment
        self.gba = GlobalBundleAdjustment(self.map, fixed_kf=cand)
        if not self.gba.step():
            self.gba.finish()
            self.gba = None
        return True

    # ------------------------------------------------------------------
    def _fuse_across_loop(self, slot: int, view_ids: np.ndarray, gidx: np.ndarray,
                          gvalid: np.ndarray) -> int:
        """Host half of SearchAndFuse: each candidate-side landmark matched
        into the slot keyframe either merges with the slot keypoint's
        different landmark (the one with more observations survives, as
        MapPoint::Replace) or adds the missing observation."""
        m = self.map
        merges = {}
        gained = []
        obs_slot = m.kf_obs_np[slot]
        for vi in np.where(gvalid & (view_ids >= 0))[0]:
            lm_cand = int(view_ids[vi])
            k = int(gidx[vi])
            if not m.pt_alive[lm_cand]:
                continue
            lm_slot = int(obs_slot[k])
            if lm_slot < 0:
                gained.append((k, lm_cand))
                m.kf_obs_np[slot][k] = lm_cand
                m.pt_obs_count[lm_cand] += 1
            elif lm_slot != lm_cand and m.pt_alive[lm_slot]:
                keep, lose = ((lm_slot, lm_cand)
                              if m.pt_obs_count[lm_slot] >= m.pt_obs_count[lm_cand]
                              else (lm_cand, lm_slot))
                merges[lose] = keep
        if gained:
            js = np.asarray([gk for gk, _ in gained], np.int64)
            vs = np.asarray([gv for _, gv in gained], np.int64)
            m.arrays = _scatter_obs_kernel(m.arrays, slot, m._t(js, torch.long), m._t(vs))
        if merges:
            m._apply_merges(merges)
            m.version += 1
        if gained:
            m._update_covisibility(slot)
            m.version += 1
        return len(merges)

    # ------------------------------------------------------------------
    def _pose_graph_correct(self, slot: int, cand: int, T_rel: np.ndarray, s_rel: float = 1.0):
        """Essential-graph optimization with the new loop edge (CorrectLoop
        + OptimizeEssentialGraph). Monocular graphs are 7-DoF (free scale
        per keyframe), which absorbs scale drift around the loop."""
        m = self.map
        K = m.n_kfs
        a = m.arrays
        mono = self.cfg.sensor == "mono"
        # a copy: on the CPU, .numpy() is a view of the poses written below
        poses_old = a.kf_pose[:K].cpu().numpy().copy()

        # essential graph = spanning tree + strong covisibility + persistent
        # loop edges + the new loop edge (src/Optimizer.cc:1017)
        th = max(self.cfg.map.covis_weight_th, 30)
        ii, jj = np.nonzero(np.triu(m.covis[:K, :K] >= th, k=2))
        par = m.kf_parent[:K]
        child = np.where((par >= 0) & m.kf_alive[:K])[0]
        old_loops = [(i, j, T, s) for (i, j, T, s) in m.loop_edges
                     if i < K and j < K and m.kf_alive[i] and m.kf_alive[j]]
        oi = np.asarray([e[0] for e in old_loops], np.int64)
        oj = np.asarray([e[1] for e in old_loops], np.int64)
        ei = np.concatenate([child, ii, oi, [slot]]).astype(np.int64)
        ej = np.concatenate([par[child], jj, oj, [cand]]).astype(np.int64)
        ew = np.concatenate([np.ones(len(child)), np.full(len(ii), 0.5),
                             np.full(len(oi), 10.0), [10.0]]).astype(np.float32)
        # rel[e] = T_j T_i^-1
        Ri = poses_old[ei, :3, :3]
        ti = poses_old[ei, :3, 3]
        Tj = poses_old[ej]
        eR = np.einsum("nij,njk->nik", Tj[:, :3, :3], Ri.transpose(0, 2, 1))
        et = Tj[:, :3, 3] - np.einsum("nij,nj->ni", eR, ti)
        E = len(ei)
        edge_s = np.ones(E, np.float32)
        # measured relative transforms for the old and new loop edges
        for k, (_, _, T_o, s_o) in enumerate(old_loops):
            eR[len(child) + len(ii) + k] = T_o[:3, :3]
            et[len(child) + len(ii) + k] = T_o[:3, 3]
            edge_s[len(child) + len(ii) + k] = s_o
        eR[-1] = T_rel[:3, :3]
        et[-1] = T_rel[:3, 3]
        edge_s[-1] = s_rel
        fixed = np.zeros(K, bool)
        fixed[cand] = True
        t = m._t
        prob = PoseGraphProblem(
            R=t(poses_old[:, :3, :3], torch.float32), t=t(poses_old[:, :3, 3], torch.float32),
            s=torch.ones(K, dtype=torch.float32, device=m.device),
            pose_valid=torch.ones(K, dtype=torch.bool, device=m.device),
            pose_fixed=t(fixed, torch.bool),
            edge_i=t(ei, torch.long), edge_j=t(ej, torch.long),
            edge_R=t(eR, torch.float32), edge_t=t(et, torch.float32),
            edge_s=t(edge_s, torch.float32), edge_w=t(ew, torch.float32),
        )
        res = optimize_pose_graph(prob, iters=15, fix_scale=not mono)
        host = torch.cat([res.R.reshape(K, 9), res.t, res.s.reshape(K, 1)], dim=1).cpu().numpy()
        R_new = host[:, :9].reshape(K, 3, 3)
        t_new = host[:, 9:12]
        s_new = host[:, 12] if mono else np.ones(K, np.float32)

        # keyframe SE3 poses from the corrected Sim3: Tcw = [R | t/s]
        # (CorrectLoop, src/LoopClosing.cc:640-648)
        poses_new = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        poses_new[:, :3, :3] = R_new
        poses_new[:, :3, 3] = t_new / np.maximum(s_new, 1e-9)[:, None]

        # landmarks re-anchored through their first keyframe's correction:
        # pc = T_old p, then p' = S_new^-1 pc = (1/s) R^T (pc - t)
        # (src/LoopClosing.cc:620-636)
        first = a.pt_first_kf.cpu().numpy()
        alive = m.pt_alive & (first >= 0) & (first < K)
        ids = np.where(alive)[0]
        m.version += 1
        a.kf_pose[:K] = t(poses_new, torch.float32)
        if len(ids) > 0:
            f = first[ids]
            T_old = poses_old[f]
            ids_t = t(ids, torch.long)
            pts = a.pt_pos[ids_t].cpu().numpy()
            pc = np.einsum("nij,nj->ni", T_old[:, :3, :3], pts) + T_old[:, :3, 3]
            Rn = R_new[f].transpose(0, 2, 1)
            sw = np.maximum(s_new[f], 1e-9)[:, None]
            pw = np.einsum("nij,nj->ni", Rn, pc - t_new[f]) / sw
            a.pt_pos[ids_t] = t(pw, torch.float32)
