"""Host-side map orchestration: covisibility, local windows, local mapping
(port of slam_map/slam_map.py).

The replacement for the reference's LocalMapping thread
(src/LocalMapping.cc:73) and the Map/KeyFrame bookkeeping APIs. Numeric work
runs in tensor functions over the device-resident :class:`MapArrays`; the
host keeps a numpy mirror of the observation table and takes the
bookkeeping decisions (covisibility order, local windows, culling, id
allocation) from it. That mirror code is the JAX package's numpy, copied,
so identical inputs give identical decisions (numpy's argsort tie order
included).

Host reads happen at keyframe rate only: the triangulation and fusion
match tables and the landmark counters, one small read each.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SystemConfig
from ..frontend.features import FrameFeatures
from ..geometry import se3
from ..geometry.camera import Camera, in_image, project
from ..ops import hamming
from ..solvers.local_ba import BAProblem, solve_local_ba
from ..solvers.pose_opt import PoseObs, optimize_pose
from .map_state import (
    MapArrays,
    add_points_kernel,
    apply_ba_kernel,
    bump_point_stats_kernel,
    bump_point_stats_rows_kernel,
    compact_keyframes_kernel,
    cull_points_kernel,
    empty_map,
    insert_keyframe_kernel,
    refresh_landmarks_kernel,
)
from .triangulation import triangulate_pair


class LocalView(NamedTuple):
    """Gathered local-map snapshot used by TrackLocalMap (static size V)."""

    ids: torch.Tensor       # (V,) landmark ids (-1 pad)
    pos: torch.Tensor       # (V, 3)
    desc: torch.Tensor      # (V, 256) int8
    normal: torch.Tensor    # (V, 3)
    min_dist: torch.Tensor  # (V,)
    max_dist: torch.Tensor  # (V,)
    valid: torch.Tensor     # (V,)


class LocalMapTrackResult(NamedTuple):
    Tcw: torch.Tensor
    num_inliers: torch.Tensor
    kp_point_id: torch.Tensor   # (N,) landmark id matched per frame keypoint (-1)
    visible_ids: torch.Tensor   # (V,) ids predicted visible (-1 pad)
    found_ids: torch.Tensor     # (V,) ids matched as inliers (-1 pad)


def track_local_map(
    cam: Camera,
    cur: FrameFeatures,
    view: LocalView,
    Tcw0: torch.Tensor,
    radius: torch.Tensor,
    nn_ratio: float = 0.8,
    max_dist: int = 100,
) -> LocalMapTrackResult:
    """Project local landmarks into the frame, match, optimize.

    Contract of Tracking::TrackLocalMap + SearchLocalPoints
    (src/Tracking.cc:1998, :2321): isInFrustum gates (depth in scale range,
    viewing angle < 60 deg), scale-predicted search radius, ratio test,
    then motion-only BA over all matches.
    """
    Twc = se3.inv_T(Tcw0)
    pc = se3.transform_points(Tcw0, view.pos)
    uv, z = project(cam, pc)
    rel = view.pos - Twc[:3, 3]
    dist = torch.linalg.vector_norm(rel, dim=-1)
    cos_view = torch.sum(rel * view.normal, dim=-1) / torch.clamp(dist, min=1e-9)
    visible = (
        view.valid
        & (z > 0.05)
        & in_image(cam, uv, border=16.0)
        & (dist >= 0.8 * view.min_dist)
        & (dist <= 1.2 * view.max_dist)
        & (cos_view > 0.5)
    )

    # Scale prediction (MapPoint::PredictScale, src/MapPoint.cc:551):
    # level ~ log(max_dist / dist) / log(1.2) -> radius multiplier 1.2^level.
    # ceil() is a bin edge: the divisor is the f32 log of f32(1.2) as JAX
    # computes it (np.log(1.2) rounded to f32 is 2 ulp away), and a tensor,
    # since CUDA divides by a Python float as a product with its reciprocal
    ratio = torch.clamp(view.max_dist / torch.clamp(dist, min=1e-6), min=1.0)
    log_step = torch.log(torch.full((), 1.2, dtype=ratio.dtype, device=ratio.device))
    level = torch.clamp(torch.ceil(torch.log(ratio) / log_step), 0, 7)
    row_radius = radius * torch.pow(1.2, level)

    dmat = hamming.hamming_matrix(view.desc, cur.desc)
    wmask = hamming.window_mask(uv, cur.xy_un, row_radius, visible, cur.valid)
    res = hamming.match(
        hamming.apply_mask(dmat, wmask),
        max_dist=max_dist,
        nn_ratio=nn_ratio,
        mutual=True,
    )

    j = torch.clamp(res.idx, min=0)
    obs = PoseObs(
        points_w=view.pos,
        uv=cur.xy_un[j],
        u_right=torch.where(res.valid, cur.u_right[j], -1.0),
        inv_sigma2=cur.inv_sigma2[j],
        valid=res.valid,
    )
    opt = optimize_pose(Tcw0, cam, obs, rounds=2, iters_per_round=4, unroll=True)

    # Per frame-keypoint landmark id: scatter-max over row -> column matches
    # (start at -1; rows that lose write -1; duplicate targets resolve to
    # the largest id, independent of order).
    N = cur.valid.shape[0]
    inlier_match = res.valid & opt.inlier
    kp_point = torch.full((N,), -1, dtype=torch.int32, device=Tcw0.device)
    kp_point.scatter_reduce_(
        0, torch.where(inlier_match, res.idx, 0),
        torch.where(inlier_match, view.ids, -1).to(torch.int32), "amax",
        include_self=True)

    return LocalMapTrackResult(
        Tcw=opt.Tcw,
        num_inliers=opt.num_inliers,
        kp_point_id=kp_point,
        visible_ids=torch.where(visible, view.ids, -1),
        found_ids=torch.where(inlier_match, view.ids, -1),
    )


def _gather_view(a: MapArrays, ids_p: torch.Tensor) -> LocalView:
    gather = torch.clamp(ids_p, min=0).long()
    return LocalView(
        ids=ids_p,
        pos=a.pt_pos[gather],
        desc=a.pt_desc[gather],
        normal=a.pt_normal[gather],
        min_dist=a.pt_min_dist[gather],
        max_dist=a.pt_max_dist[gather],
        valid=(ids_p >= 0) & a.pt_valid[gather],
    )


# ---------------------------------------------------------------------------
# Batched keyframe-maintenance functions: each is one pass over NB_PAD padded
# neighbour slots and at most one host read.
# ---------------------------------------------------------------------------

NB_PAD = 4   # fixed neighbour-slot pad shared by fuse/triangulation


def _fuse_match_kernel(
    a: MapArrays, cam: Camera, slot: int,
    nbs: np.ndarray, nb_ok: np.ndarray, my_obs: torch.Tensor,
) -> torch.Tensor:
    """Duplicate-candidate matching between ``slot`` and up to NB_PAD
    covisible neighbours (ORBmatcher::Fuse search stage,
    src/ORBmatcher.cc:1020): project slot's landmarks into each neighbour,
    window-match descriptors. ``nbs`` / ``nb_ok`` are host arrays (a slot
    index held in a device tensor would cost a sync to use). Returns packed
    (2, NB_PAD, N) int32 [match idx, match valid] for a single host read."""
    mine_has = my_obs >= 0
    desc_s = a.kf_desc[slot]
    kpv_s = a.kf_kp_valid[slot]
    pts = a.pt_pos[torch.clamp(my_obs, min=0).long()]
    idx, val = [], []
    for nb, ok_nb in zip(nbs.tolist(), nb_ok.tolist()):
        d = hamming.hamming_matrix(desc_s, a.kf_desc[nb])
        ok = (kpv_s & mine_has)[:, None] & a.kf_kp_valid[nb][None, :]
        uv, z = project(cam, se3.transform_points(a.kf_pose[nb], pts))
        wmask = hamming.window_mask(
            uv, a.kf_xy[nb], 4.0, mine_has & (z > 0.05), a.kf_kp_valid[nb])
        res = hamming.match(hamming.apply_mask(d, ok & wmask),
                            max_dist=50, nn_ratio=0.9, mutual=True)
        idx.append(res.idx)
        val.append(res.valid & ok_nb)
    return torch.stack([torch.stack(idx), torch.stack(val)]).to(torch.int32)


def _scatter_obs_kernel(a: MapArrays, nb: int, js: torch.Tensor,
                        vs: torch.Tensor) -> MapArrays:
    """Record gained observations on neighbour ``nb``."""
    a.kf_obs[nb].scatter_reduce_(0, js.long(), vs.to(torch.int32), "amax")
    return a


def _apply_merges_kernel(a: MapArrays, lut: torch.Tensor, lose: torch.Tensor) -> MapArrays:
    """Rewrite observation ids through a merge LUT and kill loser landmarks
    (MapPoint::Replace, src/MapPoint.cc:244). ``lose`` is -1 padded."""
    M = a.pt_pos.shape[0]
    obs = a.kf_obs
    a.kf_obs.copy_(torch.where(obs >= 0, lut[torch.clamp(obs, min=0).long()], obs))
    ok = lose >= 0
    ids = torch.where(ok, lose, M - 1).long()
    a.pt_valid[ids] = torch.where(ok, False, a.pt_valid[ids])
    a.pt_valid[M - 1] = False   # the scratch slot stays dead
    return a


def _triangulate_batch_kernel(
    a: MapArrays, cam: Camera, slot: int,
    nbs: np.ndarray, nb_ok: np.ndarray,
    un_slot: torch.Tensor, un_nbs: torch.Tensor,
    scale_factor: float = 1.2, n_levels: int = 8,
):
    """Triangulate ``slot`` against up to NB_PAD neighbours
    (LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:313), with the
    landmark normals and scale ranges computed on the device. Returns a
    packed (2, NB_PAD, N) int32 [match_j, good] for one host read, plus the
    point attributes for :func:`_add_points_batch_kernel`."""
    xy1, desc1 = a.kf_xy[slot], a.kf_desc[slot]
    v1, ang1, T1 = a.kf_kp_valid[slot], a.kf_angle[slot], a.kf_pose[slot]
    Xs, mjs, goods = [], [], []
    for i, (nb, ok_nb) in enumerate(zip(nbs.tolist(), nb_ok.tolist())):
        r = triangulate_pair(
            cam,
            xy1, desc1, v1, un_slot, ang1, T1,
            a.kf_xy[nb], a.kf_desc[nb], a.kf_kp_valid[nb], un_nbs[i],
            a.kf_angle[nb], a.kf_pose[nb],
        )
        Xs.append(r.points_w)
        mjs.append(r.match_j)
        goods.append(r.good & ok_nb)
    X = torch.stack(Xs)
    Twc = se3.inv_T(T1)
    view = X - Twc[:3, 3]
    dist = torch.linalg.vector_norm(view, dim=-1)
    normal = view / torch.clamp(dist, min=1e-9)[..., None]
    max_d = dist * scale_factor
    min_d = max_d / (scale_factor ** (n_levels - 1))
    packed = torch.stack([torch.stack(mjs), torch.stack(goods)]).to(torch.int32)
    return packed, X, normal, min_d, max_d


def _add_points_batch_kernel(
    m: MapArrays,
    ids: torch.Tensor,      # (NB_PAD, N) new landmark ids (-1 pad)
    pos: torch.Tensor,      # (NB_PAD, N, 3)
    normal: torch.Tensor,   # (NB_PAD, N, 3)
    min_d: torch.Tensor,    # (NB_PAD, N)
    max_d: torch.Tensor,    # (NB_PAD, N)
    slot: int,              # creating keyframe
    nbs,                    # (NB_PAD,) neighbour slots
    kp_a: torch.Tensor,     # (NB_PAD, N) keypoint index in slot (-1 pad)
    kp_b: torch.Tensor,     # (NB_PAD, N) keypoint index in neighbour (-1 pad)
) -> MapArrays:
    """Insert every neighbour's triangulated landmarks."""
    desc = m.kf_desc[slot].clone()
    for i in range(ids.shape[0]):
        m = add_points_kernel(
            m, ids[i], pos[i], desc, normal[i], min_d[i], max_d[i],
            slot, slot, kp_a[i], int(nbs[i]), kp_b[i],
        )
    return m


def _pt_stats_kernel(a: MapArrays) -> torch.Tensor:
    """(2, M) stacked [visible, found] counters for one host read."""
    return torch.stack([a.pt_visible, a.pt_found])


def _remove_kf_kernel(a: MapArrays, kf: int) -> MapArrays:
    a.kf_valid[kf] = False
    a.kf_kp_valid[kf] = False
    a.kf_obs[kf] = -1
    return a


def _gather_ba_inputs(
    a: MapArrays, slots_j: torch.Tensor, gather_pts: torch.Tensor,
    perm_j: torch.Tensor,
):
    """All local-BA input gathers.

    perm_j (Kb, Ob): per-keyframe keypoint-column permutation packing the
    landmark-bound observations first (host-computed). Every per-iteration
    cost of the solver scales with the observation width; columns beyond
    the packed prefix all have obs_valid=False, so truncation to Ob is
    lossless."""
    s = slots_j.long()
    kf, pj = s[:, None], perm_j.long()
    g = gather_pts.long()
    return (
        a.kf_pose[s],
        a.pt_pos[g],
        a.pt_valid[g],
        a.kf_xy[kf, pj],
        a.kf_ur[kf, pj],
        a.kf_inv_sigma2[kf, pj],
        a.kf_kp_valid[kf, pj],
    )


def _local_ba_fused(
    a: MapArrays,
    cam: Camera,
    slots_j: torch.Tensor,      # (Kb,) keyframe slots (padded)
    slot_valid: torch.Tensor,   # (Kb,) bool
    free_p: torch.Tensor,       # (Kb,) bool (already masked by slot_valid)
    obs_local: torch.Tensor,    # (Kb, Ob) local landmark index per packed kp
    pt_ids_p: torch.Tensor,     # (Vp,) landmark ids (-1 pad)
    perm_j: torch.Tensor,       # (Kb, Ob) packed keypoint-column permutation
) -> MapArrays:
    """Local BA: input gather -> Schur/LM solve -> result scatter."""
    kf_pose, pt_pos, pt_valid, kf_xy, kf_ur, kf_is2, kf_kpv = _gather_ba_inputs(
        a, slots_j, torch.clamp(pt_ids_p, min=0), perm_j)
    prob = BAProblem(
        kf_pose=kf_pose,
        kf_free=free_p,
        kf_valid=slot_valid,
        points=pt_pos,
        point_valid=(pt_ids_p >= 0) & pt_valid,
        obs_point=obs_local,
        obs_uv=kf_xy,
        obs_ur=kf_ur,
        obs_inv_sigma2=kf_is2,
        obs_valid=kf_kpv & (obs_local >= 0),
    )
    res = solve_local_ba(cam, prob)
    return apply_ba_kernel(a, slots_j, free_p, res.kf_pose, pt_ids_p, res.points)


class SlamMap:
    """The map: device tensors + host bookkeeping mirror."""

    def __init__(self, cfg: SystemConfig, cam: Camera, device):
        self.cfg = cfg
        self.cam = cam
        self.device = torch.device(device)
        N = cfg.orb.max_kpts
        self.arrays = empty_map(cfg.map, N, self.device)
        self.K = cfg.map.max_keyframes
        self.M = cfg.map.max_points
        self.N = N
        self.V = cfg.tracking.max_map_points_local
        # host mirrors
        self.n_kfs = 0
        self.n_pts = 0
        self.version = 0          # bumped on any map mutation
        self._view_cache = {}     # (ref_slot, version) -> LocalView
        self.kf_obs_np = np.full((self.K, N), -1, np.int64)   # mirror
        self.kf_frame_id = np.full(self.K, -1, np.int64)
        self.kf_alive = np.zeros(self.K, bool)                # kf_valid mirror
        self.covis = np.zeros((self.K, self.K), np.int32)
        self.pt_obs_count = np.zeros(self.M, np.int32)
        self.pt_birth_kf = np.full(self.M, -1, np.int32)
        self.pt_alive = np.zeros(self.M, bool)
        # slots culled since the last drain: the loop closer erases them
        # from its BoW database on its next keyframe tick
        self.culled_log: list = []
        # spanning tree (KeyFrame::mpParent, src/KeyFrame.cc:599-700): each
        # keyframe's parent is its strongest-covisibility predecessor;
        # culling reparents children, so the tree stays connected
        self.kf_parent = np.full(self.K, -1, np.int64)
        # loop edges (KeyFrame::AddLoopEdge): (slot_i, slot_j, T_rel, s_rel)
        # per accepted loop closure, kept in every later essential graph;
        # their endpoints are protected from culling (the reference's
        # mbNotErase)
        self.loop_edges: list = []
        # Stable keyframe uids for trajectory replay (slots are reused after
        # compaction): uid_cull[uid] = (parent_uid, Tcp) recorded when the
        # keyframe is culled, Tcp = Tcw_kf @ inv(Tcw_parent) at cull time --
        # the reference's KeyFrame::mTcp fallback (src/System.cc:468-476).
        self.kf_uid_next = 0
        self.slot_uid = np.full(self.K, -1, np.int64)
        self.uid_cull: dict = {}

    def _t(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        """A host array on the map's device (keyframe-rate transfers only)."""
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device, dtype)

    # -- keyframe insertion ------------------------------------------------
    def insert_keyframe(
        self,
        feats: FrameFeatures,
        Tcw: torch.Tensor,
        kp_point_id: np.ndarray,   # (N,) matched landmark per keypoint (-1)
        frame_id: int,
        valid_close=None,          # optional prefetched (valid, close) bools
    ) -> int:
        """Insert a keyframe; create landmarks for unmatched close-depth
        keypoints (Tracking::CreateNewKeyFrame, src/Tracking.cc:2210)."""
        # Capacity backstop: growth renumbers nothing, so it is always safe
        # here (compaction is preferred by the caller when near full; the
        # reference never caps the keyframe count, src/LocalMapping.cc:874).
        if self.n_kfs >= self.K - 1:
            self.grow_keyframes()
        slot = self.n_kfs
        self.n_kfs += 1
        self.kf_frame_id[slot] = frame_id
        self.kf_alive[slot] = True
        uid = self.kf_uid_next
        self.kf_uid_next += 1
        self.slot_uid[slot] = uid

        if valid_close is not None:
            valid, close = valid_close
        else:
            vd = torch.stack([feats.valid, feats.depth > 0]).cpu().numpy()
            valid, close = vd[0], vd[1]

        # tracking may have matched against a cached (pre-cull) view
        # snapshot; drop references to landmarks that died since
        kp_point_id = np.where(
            (kp_point_id >= 0) & self.pt_alive[np.maximum(kp_point_id, 0)],
            kp_point_id, -1,
        )
        matched = kp_point_id >= 0
        create = valid & close & ~matched
        n_new = int(create.sum())
        cap = self.M - 1 - self.n_pts
        if n_new > cap:   # drop farthest-first beyond capacity
            depth = feats.depth.cpu().numpy()
            idx = np.where(create)[0]
            order = np.argsort(depth[idx])
            create[:] = False
            create[idx[order[:cap]]] = True
            n_new = cap
        new_ids = np.full(self.N, -1, np.int64)
        new_ids[create] = self.n_pts + np.arange(n_new)
        self.n_pts += n_new

        self.arrays = insert_keyframe_kernel(
            self.arrays,
            slot,
            Tcw,
            feats.xy_un,
            feats.u_right,
            feats.depth,
            feats.inv_sigma2,
            feats.kp.angle,
            feats.kp.level,
            feats.desc,
            feats.valid,
            self._t(kp_point_id),
            self._t(create, torch.bool),
            self._t(new_ids),
            self.cam,
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels,
        )

        # host mirror + covisibility
        obs = np.where(valid, np.where(create, new_ids, kp_point_id), -1)
        self.kf_obs_np[slot] = obs
        created_ids = new_ids[create]
        self.pt_alive[created_ids] = True
        self.pt_birth_kf[created_ids] = slot
        self.pt_obs_count[created_ids] = 1
        seen = obs[matched & valid]
        seen = seen[seen >= 0]
        self.pt_obs_count[seen] += 1
        self._update_covisibility(slot)
        # spanning-tree parent: strongest covisible predecessor (the
        # reference parents a new KF to its max-weight connection,
        # src/KeyFrame.cc:446-456); else the latest alive predecessor
        if slot > 0:
            w = self.covis[slot, :slot].copy()
            w[~self.kf_alive[:slot]] = 0
            p = int(np.argmax(w))
            if w[p] == 0:
                alive_prev = np.where(self.kf_alive[:slot])[0]
                p = int(alive_prev[-1]) if len(alive_prev) else -1
            self.kf_parent[slot] = p
        else:
            self.kf_parent[slot] = -1
        self.version += 1
        return slot

    def _update_covisibility(self, slot: int):
        """Shared-landmark counts vs all existing KFs (KeyFrame::
        UpdateConnections, src/KeyFrame.cc:386)."""
        mine = self.kf_obs_np[slot]
        member = np.zeros(self.M, bool)
        member[mine[mine >= 0]] = True
        obs = self.kf_obs_np[: self.n_kfs]
        w = (member[np.maximum(obs, 0)] & (obs >= 0)).sum(axis=1)
        w[slot] = 0
        self.covis[slot, : self.n_kfs] = w
        self.covis[: self.n_kfs, slot] = w

    # -- local views ---------------------------------------------------------
    def local_keyframes(self, ref_slot: int, max_kfs: int) -> np.ndarray:
        """ref KF + best covisible neighbours, strongest first."""
        if self.n_kfs == 0:
            return np.zeros(0, np.int64)
        w = self.covis[ref_slot, : self.n_kfs].copy()
        order = np.argsort(-w)
        neigh = [k for k in order if w[k] > 0][: max_kfs - 1]
        return np.asarray([ref_slot] + neigh, np.int64)

    def local_point_ids(self, kf_slots: np.ndarray) -> np.ndarray:
        obs = self.kf_obs_np[kf_slots]
        ids = np.unique(obs[obs >= 0])
        return ids[self.pt_alive[ids]]

    def local_view(self, ref_slot: int) -> LocalView:
        """Gather the TrackLocalMap point set (UpdateLocalKeyFrames/Points,
        src/Tracking.cc:2456/2418). Cached per (ref keyframe, map version):
        between keyframes the map does not change."""
        key = (ref_slot, self.version)
        hit = self._view_cache.get(key)
        if hit is not None:
            return hit
        kfs = self.local_keyframes(ref_slot, self.cfg.map.local_window)
        ids = self.local_point_ids(kfs)
        V = self.V
        if len(ids) > V:   # keep the most-observed points
            order = np.argsort(-self.pt_obs_count[ids])
            ids = ids[order[:V]]
        ids_p = np.concatenate([ids, np.full(V - len(ids), -1, np.int64)])
        out = _gather_view(self.arrays, self._t(ids_p))
        self._view_cache = {key: out}   # keep only the newest snapshot
        return out

    # -- keyframe culling ------------------------------------------------------
    def cull_keyframes(self, around: int) -> int:
        """Disable redundant keyframes: >= 90% of a KF's landmarks are
        observed by >= 3 other keyframes (LocalMapping::KeyFrameCulling,
        src/LocalMapping.cc:874). Host mirror math; the device keeps the
        slot (kf_valid=False removes it from BA)."""
        culled = 0
        cands = self.local_keyframes(around, self.cfg.map.local_window)
        protected = {e[0] for e in self.loop_edges} | {e[1] for e in self.loop_edges}
        for kf in cands.tolist():
            if kf == 0 or kf == around or not self.kf_alive[kf]:
                continue
            if kf in protected:   # loop-edge endpoints anchor the graph
                continue
            obs = self.kf_obs_np[kf]
            ids = obs[obs >= 0]
            ids = ids[self.pt_alive[ids]]
            if len(ids) < 20:
                continue
            # observation counts excluding this keyframe
            redundant = (self.pt_obs_count[ids] - 1 >= 3).mean()
            if redundant > 0.9:
                self._remove_keyframe(kf)
                culled += 1
        if culled:
            self.version += 1
        return culled

    def _remove_keyframe(self, kf: int):
        # trajectory-replay fallback: frames referenced to this keyframe
        # recompose through its spanning-tree parent (KeyFrame::mTcp,
        # src/System.cc:468-476), recorded before any mutation. A device
        # product, no host read; a new tensor, so later in-place pose
        # writes do not reach it.
        parent = int(self.kf_parent[kf])
        uid = int(self.slot_uid[kf])
        if parent >= 0 and uid >= 0:
            Tcp = self.arrays.kf_pose[kf] @ se3.inv_T(self.arrays.kf_pose[parent])
            self.uid_cull[uid] = (int(self.slot_uid[parent]), Tcp)
        self.slot_uid[kf] = -1
        obs = self.kf_obs_np[kf]
        ids = obs[obs >= 0]
        self.pt_obs_count[ids] -= 1
        self.kf_obs_np[kf] = -1
        # SetBadFlag reparenting (src/KeyFrame.cc:599-700): children
        # re-attach to their strongest alive covisible predecessor, else to
        # the removed keyframe's own parent
        children = np.where(
            (self.kf_parent[: self.n_kfs] == kf) & self.kf_alive[: self.n_kfs]
        )[0]
        for ch in children:
            w = self.covis[ch, :ch].copy()
            w[~self.kf_alive[:ch]] = 0
            w[kf] = 0
            p = int(np.argmax(w)) if ch > 0 else -1
            if ch == 0 or w[p] == 0:
                p = int(self.kf_parent[kf])
            self.kf_parent[ch] = p
        self.covis[kf, :] = 0
        self.covis[:, kf] = 0
        self.kf_alive[kf] = False
        self.kf_parent[kf] = -1
        self.culled_log.append(kf)
        self.arrays = _remove_kf_kernel(self.arrays, kf)

    def drain_culled(self) -> list:
        out, self.culled_log = self.culled_log, []
        return out

    def grow_keyframes(self):
        """Double keyframe capacity: the escape hatch when the map is full
        and nothing is redundant enough to cull (long exploratory
        sequences)."""
        K0 = self.K
        a = self.arrays

        def pad0(x, fill):
            return torch.cat([x, torch.full((K0,) + x.shape[1:], fill,
                                            dtype=x.dtype, device=x.device)])

        self.arrays = a._replace(
            kf_pose=torch.cat([a.kf_pose, torch.eye(
                4, dtype=torch.float32, device=self.device).repeat(K0, 1, 1)]),
            kf_valid=pad0(a.kf_valid, False),
            kf_xy=pad0(a.kf_xy, 0.0),
            kf_ur=pad0(a.kf_ur, -1.0),
            kf_depth=pad0(a.kf_depth, -1.0),
            kf_inv_sigma2=pad0(a.kf_inv_sigma2, 1.0),
            kf_angle=pad0(a.kf_angle, 0.0),
            kf_desc=pad0(a.kf_desc, 0),
            kf_kp_valid=pad0(a.kf_kp_valid, False),
            kf_obs=pad0(a.kf_obs, -1),
        )
        self.K = 2 * K0
        self.kf_obs_np = np.concatenate([self.kf_obs_np, np.full((K0, self.N), -1, np.int64)])
        self.kf_frame_id = np.concatenate([self.kf_frame_id, np.full(K0, -1, np.int64)])
        self.kf_alive = np.concatenate([self.kf_alive, np.zeros(K0, bool)])
        self.kf_parent = np.concatenate([self.kf_parent, np.full(K0, -1, np.int64)])
        self.slot_uid = np.concatenate([self.slot_uid, np.full(K0, -1, np.int64)])
        cv = np.zeros((self.K, self.K), np.int32)
        cv[:K0, :K0] = self.covis
        self.covis = cv
        self.version += 1

    def compact_keyframes(self):
        """Compact alive keyframes into a dense slot prefix, freeing the
        slots of culled keyframes for reuse (KeyFrame::SetBadFlag + erase,
        src/KeyFrame.cc:599-700). Temporal slot order is preserved. Returns
        the old->new slot LUT ((K,) int64, -1 = dead), or None if there
        were no dead slots."""
        alive = np.where(self.kf_alive[: self.n_kfs])[0]
        A = len(alive)
        if A == self.n_kfs:
            return None
        lut = np.full(self.K, -1, np.int64)
        lut[alive] = np.arange(A)
        src = np.zeros(self.K, np.int64)
        src[:A] = alive
        src_ok = np.zeros(self.K, bool)
        src_ok[:A] = True

        self.arrays = compact_keyframes_kernel(
            self.arrays, self._t(src), self._t(src_ok, torch.bool), self._t(lut))
        # host mirrors follow the same permutation
        obs_new = np.full_like(self.kf_obs_np, -1)
        obs_new[:A] = self.kf_obs_np[alive]
        self.kf_obs_np = obs_new
        fid = np.full_like(self.kf_frame_id, -1)
        fid[:A] = self.kf_frame_id[alive]
        self.kf_frame_id = fid
        self.kf_alive = src_ok.copy()
        cv = np.zeros_like(self.covis)
        cv[:A, :A] = self.covis[np.ix_(alive, alive)]
        self.covis = cv
        self.pt_birth_kf = np.where(
            self.pt_birth_kf >= 0, lut[np.maximum(self.pt_birth_kf, 0)], -1,
        ).astype(np.int32)
        # the spanning tree follows the permutation; a parent is always
        # alive (reparenting happens at cull time)
        par = np.full_like(self.kf_parent, -1)
        old_par = self.kf_parent[alive]
        par[:A] = np.where(old_par >= 0, lut[np.maximum(old_par, 0)], -1)
        self.kf_parent = par
        su = np.full_like(self.slot_uid, -1)
        su[:A] = self.slot_uid[alive]
        self.slot_uid = su
        self.loop_edges = [
            (int(lut[i]), int(lut[j]), T, s)
            for (i, j, T, s) in self.loop_edges
            if lut[i] >= 0 and lut[j] >= 0
        ]
        self.culled_log = []   # stale slot ids mean nothing after compaction
        self.n_kfs = A
        self.version += 1
        return lut

    # -- duplicate-landmark fusion ---------------------------------------------
    def fuse_neighbors(self, slot: int, max_neighbours: int = NB_PAD) -> int:
        """Fuse duplicate landmarks between ``slot`` and its covisible
        keyframes (LocalMapping::SearchInNeighbors + ORBmatcher::Fuse,
        src/LocalMapping.cc:629, src/ORBmatcher.cc:1020): when keypoint k of
        a neighbour matches a landmark of ``slot`` but already observes a
        different landmark, the two are duplicates -- keep the one with more
        observations, rewrite the loser's id everywhere."""
        disp = self.fuse_neighbors_dispatch(slot, max_neighbours)
        if disp is None:
            return 0
        return self.fuse_neighbors_resolve(slot, disp, disp["packed"].cpu().numpy())

    def fuse_neighbors_dispatch(self, slot: int, max_neighbours: int = NB_PAD):
        kfs = self.local_keyframes(slot, max_neighbours + 1)
        my_obs = self.kf_obs_np[slot].copy()
        neighbours = kfs[1:].tolist()
        if not neighbours:
            return None
        nbs = np.zeros(NB_PAD, np.int64)
        nb_ok = np.zeros(NB_PAD, bool)
        nbs[: len(neighbours)] = neighbours
        nb_ok[: len(neighbours)] = True
        packed = _fuse_match_kernel(self.arrays, self.cam, slot, nbs, nb_ok, self._t(my_obs))
        return {"packed": packed, "neighbours": neighbours, "my_obs": my_obs}

    def fuse_neighbors_resolve(self, slot: int, disp: dict, packed: np.ndarray) -> int:
        neighbours = disp["neighbours"]
        my_obs = disp["my_obs"]
        fused = 0
        merges = {}
        for di, nb in enumerate(neighbours):
            midx = packed[0, di].astype(np.int64)
            mval = packed[1, di] > 0
            nb_obs = self.kf_obs_np[nb]
            # mutual matching makes midx unique over valid rows, so the
            # scatter below is conflict-free
            rows = mval & (my_obs >= 0)
            mine = np.where(rows, my_obs, 0)
            # never merge from or toward a dead landmark
            ok = rows & self.pt_alive[mine]
            j_all = np.maximum(midx, 0)
            theirs = nb_obs[j_all]
            ok &= ~((theirs >= 0) & ~self.pt_alive[np.maximum(theirs, 0)])
            gain = ok & (theirs < 0)
            gj = j_all[gain]
            gid = my_obs[gain]
            if len(gj) != len(np.unique(gj)):
                raise AssertionError(
                    "fuse match produced duplicate neighbour keypoints: "
                    "mutual-match invariant broken")
            self.kf_obs_np[nb][gj] = gid
            np.add.at(self.pt_obs_count, gid, 1)
            # keep/lose reads pt_obs_count after all of this neighbour's
            # gains, as in the JAX package (a near-tie can keep the other
            # landmark vs the reference's per-row interleave; the surviving
            # observation set is the same)
            mg = np.where(ok & (theirs >= 0) & (theirs != my_obs))[0]
            for i in mg.tolist():
                a_id, b_id = int(my_obs[i]), int(theirs[i])
                keep, lose = (
                    (a_id, b_id)
                    if self.pt_obs_count[a_id] >= self.pt_obs_count[b_id]
                    else (b_id, a_id)
                )
                if keep != lose:
                    merges[lose] = keep
                    fused += 1
            if len(gj):
                self.arrays = _scatter_obs_kernel(
                    self.arrays, nb, self._t(gj, torch.long), self._t(gid))
        if merges:
            self._apply_merges(merges)
            self.version += 1
        return fused

    def _apply_merges(self, merges: dict):
        # resolve chains (lose1 -> keep1 where keep1 itself lost later):
        # follow each target to its final survivor, guarding against cycles
        def resolve(x):
            seen = set()
            while x in merges and x not in seen:
                seen.add(x)
                x = merges[x]
            return x

        merges = {l: resolve(k) for l, k in merges.items()}
        merges = {l: k for l, k in merges.items() if l != k}
        if not merges:
            return
        lose = np.asarray(list(merges.keys()), np.int64)
        keep = np.asarray(list(merges.values()), np.int64)
        lut = np.arange(self.M, dtype=np.int64)
        lut[lose] = keep
        live = self.kf_obs_np >= 0
        self.kf_obs_np[live] = lut[self.kf_obs_np[live]]
        self.pt_obs_count[keep] += self.pt_obs_count[lose]
        self.pt_alive[lose] = False
        self.arrays = _apply_merges_kernel(self.arrays, self._t(lut), self._t(lose))

    # -- landmark statistics refresh -------------------------------------------
    def refresh_landmarks(self, slot: int):
        """Recompute distinctive descriptors and normals for the landmarks
        observed by ``slot``'s local window (MapPoint::
        ComputeDistinctiveDescriptors, src/MapPoint.cc:359;
        UpdateNormalAndDepth, :477)."""
        kfs = self.local_keyframes(slot, self.cfg.map.local_window)
        ids = self.local_point_ids(kfs)
        if len(ids) == 0:
            return
        P = min(len(ids), self.V)
        ids = ids[:P]
        ids_p = np.concatenate([ids, np.full(self.V - P, -1, np.int64)])
        # per landmark, up to OBS observing (kf, kp) pairs from the mirror,
        # ranked within each landmark by a stable sort (kf order, kp order)
        OBS = 8
        kf_of = np.zeros((self.V, OBS), np.int64)
        kp_of = np.zeros((self.V, OBS), np.int64)
        obs = self.kf_obs_np[kfs]                       # (Wk, N)
        kfi = np.broadcast_to(kfs[:, None], obs.shape)
        kpi = np.broadcast_to(np.arange(self.N)[None, :], obs.shape)
        sel = obs >= 0
        lut = np.full(self.M, -1, np.int64)
        lut[ids] = np.arange(P)
        li = lut[obs[sel]]
        ok = li >= 0
        li, kfo, kpo = li[ok], kfi[sel][ok], kpi[sel][ok]
        order = np.argsort(li, kind="stable")
        li, kfo, kpo = li[order], kfo[order], kpo[order]
        first = np.searchsorted(li, np.arange(P), side="left")
        rank = np.arange(len(li)) - first[li]
        keep = rank < OBS
        kf_of[li[keep], rank[keep]] = kfo[keep]
        kp_of[li[keep], rank[keep]] = kpo[keep]
        cnt = np.zeros(self.V, np.int64)
        cnt[:P] = np.minimum(np.bincount(li, minlength=P), OBS)
        self.arrays = refresh_landmarks_kernel(
            self.arrays, self._t(ids_p), self._t(kf_of), self._t(kp_of), self._t(cnt))
        self.version += 1

    # -- epipolar triangulation of new landmarks -------------------------------
    def create_new_points_dispatch(self, slot: int, max_neighbours: int = 3):
        """Device half of CreateNewMapPoints: the batched triangulation.
        Returns a handle for :meth:`create_new_points_resolve` (its
        ``packed`` field is the one tensor the host reads), or None if
        there are no neighbours."""
        kfs = self.local_keyframes(slot, max_neighbours + 1)
        obs_slot = self.kf_obs_np[slot]
        neighbours = [int(nb) for nb in kfs[1:]][:NB_PAD]
        if not neighbours:
            return None
        nbs = np.zeros(NB_PAD, np.int64)
        nb_ok = np.zeros(NB_PAD, bool)
        nbs[: len(neighbours)] = neighbours
        nb_ok[: len(neighbours)] = True
        un_nbs = self.kf_obs_np[nbs] < 0
        packed, X, normal, min_d, max_d = _triangulate_batch_kernel(
            self.arrays, self.cam, slot, nbs, nb_ok,
            self._t(obs_slot < 0, torch.bool), self._t(un_nbs, torch.bool),
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels,
        )
        return {"packed": packed, "X": X, "normal": normal, "min_d": min_d,
                "max_d": max_d, "neighbours": neighbours, "nbs": nbs}

    def create_new_points(self, slot: int, max_neighbours: int = 3) -> int:
        """Triangulate new landmarks between ``slot`` and its best
        covisible keyframes (LocalMapping::CreateNewMapPoints). Returns the
        number created. The host assigns landmark ids neighbour by
        neighbour (a later neighbour cannot re-claim a keypoint an earlier
        one took), then one insertion writes every neighbour's points."""
        disp = self.create_new_points_dispatch(slot, max_neighbours)
        if disp is None:
            return 0
        return self.create_new_points_resolve(slot, disp, disp["packed"].cpu().numpy())

    def create_new_points_resolve(self, slot: int, disp: dict, packed: np.ndarray) -> int:
        """Host half: assign landmark ids from the read match/good masks and
        insert the points."""
        neighbours = disp["neighbours"]
        match_all = packed[0].astype(np.int64)
        goods_all = packed[1] > 0

        created = 0
        N = self.N
        ids_all = np.full((NB_PAD, N), -1, np.int64)
        kp_b_all = np.full((NB_PAD, N), -1, np.int64)
        for ni, nb in enumerate(neighbours):
            good = goods_all[ni].copy()
            # keep only keypoints still unmatched on the host mirror (an
            # earlier neighbour may have claimed them)
            good &= self.kf_obs_np[slot] < 0
            n_new = int(good.sum())
            cap = self.M - 1 - self.n_pts
            if n_new > cap:
                keep = np.where(good)[0][:cap]
                good[:] = False
                good[keep] = True
                n_new = cap
            if n_new == 0:
                continue
            ids = np.full(N, -1, np.int64)
            ids[good] = self.n_pts + np.arange(n_new)
            self.n_pts += n_new
            created += n_new
            match_j = match_all[ni]
            ids_all[ni] = ids
            kp_b_all[ni] = np.where(good, match_j, -1)
            # host mirrors
            self.kf_obs_np[slot][good] = ids[good]
            self.kf_obs_np[nb][match_j[good]] = ids[good]
            cids = ids[good]
            self.pt_alive[cids] = True
            self.pt_birth_kf[cids] = slot
            self.pt_obs_count[cids] = 2
        if created:
            kp_a_all = np.where(ids_all >= 0, np.arange(N)[None, :], -1)
            self.arrays = _add_points_batch_kernel(
                self.arrays, self._t(ids_all),
                disp["X"], disp["normal"], disp["min_d"], disp["max_d"],
                slot, disp["nbs"], self._t(kp_a_all), self._t(kp_b_all),
            )
            self._update_covisibility(slot)
            self.version += 1
        return created

    # -- bundle adjustment -----------------------------------------------------
    def _ba_host_prep(self, slots: np.ndarray, free: np.ndarray,
                      pt_ids: np.ndarray, Kb: int, Vp: int):
        """Host-side padding/remapping: returns (slots_p, slot_valid,
        free_p, obs_local, pt_ids_p, perm) numpy.

        ``perm`` (Kb, Ob) packs each keyframe's landmark-bound keypoint
        columns first and truncates the observation width to N/2 when the
        densest keyframe fits (else N). The dropped columns are exactly the
        obs_valid=False padding, so this is lossless."""
        pad = Kb - len(slots)
        slots_p = np.concatenate([slots, np.zeros(pad, np.int64)])
        slot_valid = np.concatenate([np.ones(len(slots), bool), np.zeros(pad, bool)])
        free_p = np.concatenate([free, np.zeros(pad, bool)])

        # remap landmark ids -> local indices
        remap = np.full(self.M, -1, np.int64)
        remap[pt_ids] = np.arange(len(pt_ids))
        obs_local = remap[np.maximum(self.kf_obs_np[slots_p], 0)]
        obs_local[self.kf_obs_np[slots_p] < 0] = -1
        obs_local[~slot_valid] = -1

        # pack bound columns first; bucket the static width
        bound = obs_local >= 0
        perm = np.argsort(~bound, axis=1, kind="stable")
        densest = int(bound.sum(axis=1).max()) if len(slots) else 0
        Ob = self.N // 2 if densest <= self.N // 2 else self.N
        perm = perm[:, :Ob]
        obs_local = np.take_along_axis(obs_local, perm, axis=1)

        pt_ids_p = np.concatenate([pt_ids, np.full(Vp - len(pt_ids), -1, np.int64)])
        return slots_p, slot_valid, free_p, obs_local, pt_ids_p, perm

    def build_ba_problem(self, slots: np.ndarray, free: np.ndarray,
                         pt_ids: np.ndarray, Kb: int, Vp: int):
        """Assemble a padded BAProblem over the given keyframes/landmarks.
        Returns (problem, slots_t, free_p, pt_ids_p)."""
        slots_p, slot_valid, free_p, obs_local, pt_ids_p, perm = self._ba_host_prep(
            slots, free, pt_ids, Kb, Vp)
        slots_t = self._t(slots_p)
        kf_pose, pt_pos, pt_valid, kf_xy, kf_ur, kf_is2, kf_kpv = _gather_ba_inputs(
            self.arrays, slots_t, self._t(np.maximum(pt_ids_p, 0)), self._t(perm))
        prob = BAProblem(
            kf_pose=kf_pose,
            kf_free=self._t(free_p, torch.bool),
            kf_valid=self._t(slot_valid, torch.bool),
            points=pt_pos,
            point_valid=self._t(pt_ids_p >= 0, torch.bool) & pt_valid,
            obs_point=self._t(obs_local),
            obs_uv=kf_xy,
            obs_ur=kf_ur,
            obs_inv_sigma2=kf_is2,
            obs_valid=kf_kpv & self._t(obs_local >= 0, torch.bool),
        )
        return prob, slots_t, (free_p & slot_valid), pt_ids_p

    def apply_ba_result(self, slots_t, free_p, pt_ids_p, kf_pose, points):
        """Scatter optimized poses/points back into the map."""
        self.version += 1
        self.arrays = apply_ba_kernel(
            self.arrays, slots_t, self._t(free_p, torch.bool), kf_pose,
            self._t(pt_ids_p), points)

    def run_local_ba(self, center_slot: int) -> bool:
        """Local BA around ``center_slot`` (Optimizer::LocalBundleAdjustment
        contract: covisible window free, frontier fixed). Returns whether a
        solve ran."""
        Lw = self.cfg.map.local_window
        Fw = self.cfg.map.fixed_window
        Vba = self.cfg.map.ba_max_points
        window = self.local_keyframes(center_slot, Lw)
        pt_ids = self.local_point_ids(window)
        P = min(len(pt_ids), Vba)
        if P == 0 or len(window) < 2:
            return False
        if len(pt_ids) > P:
            order = np.argsort(-self.pt_obs_count[pt_ids])
            pt_ids = pt_ids[order[:P]]

        # frontier: KFs observing local points but outside the window
        inset = np.zeros(self.n_kfs, bool)
        inset[window] = True
        obs = self.kf_obs_np[: self.n_kfs]
        pt_set = np.zeros(self.M, bool)
        pt_set[pt_ids] = True
        observes = (pt_set[np.maximum(obs, 0)] & (obs >= 0)).any(axis=1)
        frontier = np.where(observes & ~inset)[0][:Fw]

        slots = np.concatenate([window, frontier])
        free = np.concatenate([np.ones(len(window), bool), np.zeros(len(frontier), bool)])
        # gauge: if nothing is fixed, fix the first window KF
        if len(frontier) == 0:
            free[0] = False

        slots_p, slot_valid, free_p, obs_local, pt_ids_p, perm = self._ba_host_prep(
            slots, free, pt_ids, Lw + Fw, Vba)
        self.version += 1
        self.arrays = _local_ba_fused(
            self.arrays, self.cam,
            self._t(slots_p), self._t(slot_valid, torch.bool),
            self._t(free_p & slot_valid, torch.bool), self._t(obs_local),
            self._t(pt_ids_p), self._t(perm),
        )
        return True

    # -- maintenance -----------------------------------------------------------
    def bump_stats(self, visible_ids: torch.Tensor, found_ids: torch.Tensor):
        self.arrays = bump_point_stats_kernel(self.arrays, visible_ids, found_ids)

    def apply_stats_rows(self, ids: torch.Tensor, acc: torch.Tensor):
        """Apply a (V, 2) [visible, found] accumulator (carried by the
        fused frame step) in one scatter."""
        self.arrays = bump_point_stats_rows_kernel(self.arrays, ids, acc)

    def cull_points_dispatch(self) -> torch.Tensor:
        """Device half of MapPointCulling: the (2, M) counters."""
        return _pt_stats_kernel(self.arrays)

    def cull_points(self):
        """Reference MapPointCulling: drop landmarks with found/visible <
        0.25, or stuck at <= 2 observations several KFs after creation."""
        self.cull_points_resolve(self.cull_points_dispatch().cpu().numpy())

    def cull_points_resolve(self, both: np.ndarray):
        vis, fnd = both[0], both[1]
        alive_ids = np.where(self.pt_alive)[0]
        if len(alive_ids) == 0:
            return
        ratio_bad = (vis[alive_ids] > 4) & (
            fnd[alive_ids] < 0.25 * np.maximum(vis[alive_ids], 1)
        )
        stale = (self.pt_obs_count[alive_ids] <= 2) & (
            self.pt_birth_kf[alive_ids] <= self.n_kfs - 4
        )
        cull = alive_ids[ratio_bad | stale]
        if len(cull) == 0:
            return
        self.pt_alive[cull] = False
        self.version += 1
        self.arrays = cull_points_kernel(self.arrays, self._t(cull))
        # host mirror: erase observations
        hit = np.isin(self.kf_obs_np, cull)
        self.kf_obs_np[hit] = -1
