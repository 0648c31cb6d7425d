"""Array-resident SLAM map (port of slam_map/map_state.py).

Replaces the reference's pointer graph (Map/KeyFrame/MapPoint,
src/{Map,KeyFrame,MapPoint}.cc) with a structure of capacity-padded tensors
on one device:

* keyframes: K slots of pose + the full padded feature tables,
* landmarks: M slots of position / descriptor / normal / scale range,
* observations: a (K, N) int32 table -- keypoint slot -> landmark id --
  which is the bipartite observation graph.

The JAX kernels return a new MapArrays (donating the old buffers); these
update the map tensors in place and return the same MapArrays, except
:func:`compact_keyframes_kernel`, which gathers new keyframe tensors.

Scratch slots: rows that must not write (padding, rows not created) are
routed to landmark M-1 / keypoint N-1 / keyframe K-1 and write that slot's
own old value. ``index_put_`` with duplicate indices has no defined order;
this is only safe because every duplicate writes the same value, and
because the host allocator never hands out slot M-1 or K-1, so
``pt_valid[M-1]`` and ``kf_valid[K-1]`` stay False (tests check both).

Indices are stored int32, as in the JAX arrays, and cast to int64 where
they index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig
from ..geometry import se3
from ..geometry.camera import Camera, backproject


class MapArrays(NamedTuple):
    """Device-resident map storage (all capacity-padded)."""

    # keyframes
    kf_pose: torch.Tensor        # (K, 4, 4) Tcw
    kf_valid: torch.Tensor       # (K,) bool
    # per-keyframe feature tables (what matching/BA need)
    kf_xy: torch.Tensor          # (K, N, 2) undistorted pixel coords
    kf_ur: torch.Tensor          # (K, N) right-u (<0 mono)
    kf_depth: torch.Tensor       # (K, N) RGB-D depth (<=0 none)
    kf_inv_sigma2: torch.Tensor  # (K, N)
    kf_angle: torch.Tensor       # (K, N)
    kf_desc: torch.Tensor        # (K, N, 256) int8 bitplanes
    kf_kp_valid: torch.Tensor    # (K, N) bool
    kf_obs: torch.Tensor         # (K, N) int32 landmark id, -1 = none
    # landmarks
    pt_pos: torch.Tensor         # (M, 3)
    pt_desc: torch.Tensor        # (M, 256) int8
    pt_normal: torch.Tensor      # (M, 3) mean viewing direction
    pt_min_dist: torch.Tensor    # (M,)
    pt_max_dist: torch.Tensor    # (M,)
    pt_valid: torch.Tensor       # (M,) bool
    pt_visible: torch.Tensor     # (M,) int32 times expected visible
    pt_found: torch.Tensor       # (M,) int32 times actually matched inlier
    pt_first_kf: torch.Tensor    # (M,) int32 creating keyframe slot


def empty_map(map_cfg: MapConfig, n_kpts: int, device) -> MapArrays:
    K, M, N = map_cfg.max_keyframes, map_cfg.max_points, n_kpts
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return MapArrays(
        kf_pose=torch.eye(4, **f32).repeat(K, 1, 1),
        kf_valid=torch.zeros(K, dtype=torch.bool, device=device),
        kf_xy=torch.zeros((K, N, 2), **f32),
        kf_ur=torch.full((K, N), -1.0, **f32),
        kf_depth=torch.full((K, N), -1.0, **f32),
        kf_inv_sigma2=torch.ones((K, N), **f32),
        kf_angle=torch.zeros((K, N), **f32),
        kf_desc=torch.zeros((K, N, 256), dtype=torch.int8, device=device),
        kf_kp_valid=torch.zeros((K, N), dtype=torch.bool, device=device),
        kf_obs=torch.full((K, N), -1, **i32),
        pt_pos=torch.zeros((M, 3), **f32),
        pt_desc=torch.zeros((M, 256), dtype=torch.int8, device=device),
        pt_normal=torch.zeros((M, 3), **f32),
        pt_min_dist=torch.zeros(M, **f32),
        pt_max_dist=torch.full((M,), 1e9, **f32),
        pt_valid=torch.zeros(M, dtype=torch.bool, device=device),
        pt_visible=torch.zeros(M, **i32),
        pt_found=torch.zeros(M, **i32),
        pt_first_kf=torch.full((M,), -1, **i32),
    )


def _set_rows(t: torch.Tensor, idx: torch.Tensor, write: torch.Tensor,
              vals) -> None:
    """t[idx] = vals where ``write``, else t[idx]'s own value (scratch
    routing: the caller sends non-writing rows to one scratch index)."""
    old = t[idx]
    w = write.reshape(write.shape + (1,) * (old.ndim - write.ndim))
    if isinstance(vals, torch.Tensor):
        vals = vals.to(t.dtype)
    t[idx] = torch.where(w, vals, old)   # a Python scalar stays a kernel argument


# ---------------------------------------------------------------------------
# update kernels
# ---------------------------------------------------------------------------

def insert_keyframe_kernel(
    m: MapArrays,
    slot: int,
    Tcw: torch.Tensor,          # (4,4)
    xy: torch.Tensor,           # (N,2) undistorted
    ur: torch.Tensor,
    depth: torch.Tensor,
    inv_sigma2: torch.Tensor,
    angle: torch.Tensor,
    level: torch.Tensor,        # (N,) int32
    desc: torch.Tensor,         # (N,256) int8
    kp_valid: torch.Tensor,     # (N,)
    matched_pt: torch.Tensor,   # (N,) int32 landmark id matched by tracking, -1
    create_mask: torch.Tensor,  # (N,) bool: create a new landmark here
    new_ids: torch.Tensor,      # (N,) int32 pre-assigned landmark ids (-1 pad)
    cam: Camera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
) -> MapArrays:
    """Write one keyframe and create its new RGB-D landmarks
    (Tracking::CreateNewKeyFrame + StereoInitialization, src/Tracking.cc:2210,
    :1343): depth-valid unmatched keypoints become landmarks; matched
    keypoints record observations."""
    obs = torch.where(create_mask, new_ids, matched_pt)
    m.kf_pose[slot] = Tcw
    m.kf_valid[slot] = True
    m.kf_xy[slot] = xy
    m.kf_ur[slot] = ur
    m.kf_depth[slot] = depth
    m.kf_inv_sigma2[slot] = inv_sigma2
    m.kf_angle[slot] = angle
    m.kf_desc[slot] = desc
    m.kf_kp_valid[slot] = kp_valid
    m.kf_obs[slot] = torch.where(kp_valid, obs, -1).to(torch.int32)

    # New landmarks: backproject with this keyframe's pose.
    Twc = se3.inv_T(Tcw)
    pc = backproject(cam, xy, torch.clamp(depth, min=1e-3))
    pw = se3.transform_points(Twc, pc)
    view = pw - Twc[:3, 3]
    dist = torch.linalg.vector_norm(view, dim=-1)
    normal = view / torch.clamp(dist, min=1e-9)[:, None]
    # scale-invariance range (MapPoint::UpdateNormalAndDepth,
    # src/MapPoint.cc:477): maxdist = dist * scale^level, min = max/scale^L
    max_d = dist * torch.pow(scale_factor, level.to(torch.float32))
    min_d = max_d / (scale_factor ** (n_levels - 1))

    M = m.pt_pos.shape[0]
    ids = torch.where(create_mask, new_ids, M - 1).long()
    w = create_mask
    _set_rows(m.pt_pos, ids, w, pw)
    _set_rows(m.pt_desc, ids, w, desc)
    _set_rows(m.pt_normal, ids, w, normal)
    _set_rows(m.pt_min_dist, ids, w, min_d)
    _set_rows(m.pt_max_dist, ids, w, max_d)
    _set_rows(m.pt_valid, ids, w, True)
    _set_rows(m.pt_first_kf, ids, w, slot)
    return m


def add_points_kernel(
    m: MapArrays,
    ids: torch.Tensor,      # (P,) new landmark ids (-1 pad)
    pos: torch.Tensor,      # (P, 3)
    desc: torch.Tensor,     # (P, 256)
    normal: torch.Tensor,   # (P, 3)
    min_d: torch.Tensor,    # (P,)
    max_d: torch.Tensor,    # (P,)
    first_kf: int,
    slot_a: int,
    kp_a: torch.Tensor,     # (P,) keypoint index in A (-1 pad)
    slot_b: int,
    kp_b: torch.Tensor,     # (P,) keypoint index in B (-1 pad)
) -> MapArrays:
    """Insert triangulated landmarks and their two observations
    (LocalMapping::CreateNewMapPoints tail, src/LocalMapping.cc:313)."""
    M = m.pt_pos.shape[0]
    N = m.kf_obs.shape[1]
    w = ids >= 0
    ii = torch.where(w, ids, M - 1).long()
    _set_rows(m.pt_pos, ii, w, pos)
    _set_rows(m.pt_desc, ii, w, desc)
    _set_rows(m.pt_normal, ii, w, normal)
    _set_rows(m.pt_min_dist, ii, w, min_d)
    _set_rows(m.pt_max_dist, ii, w, max_d)
    _set_rows(m.pt_valid, ii, w, True)
    _set_rows(m.pt_first_kf, ii, w, first_kf)

    def row_max(slot, kp):
        ok = w & (kp >= 0)
        k = torch.where(ok, kp, N - 1).long()
        vals = torch.where(ok, ids, -1).to(torch.int32)
        return m.kf_obs[slot].clone().scatter_reduce_(0, k, vals, "amax")

    # both rows read the table before either is written, as in the JAX kernel
    obs_a, obs_b = row_max(slot_a, kp_a), row_max(slot_b, kp_b)
    m.kf_obs[slot_a] = obs_a
    m.kf_obs[slot_b] = obs_b
    return m


def bump_point_stats_kernel(
    m: MapArrays, visible_ids: torch.Tensor, found_ids: torch.Tensor
) -> MapArrays:
    """Increment found/visible counters (MapPoint::IncreaseVisible/Found);
    ids are padded with -1 (added as 0 to the scratch slot)."""
    M = m.pt_pos.shape[0]
    for counter, ids in ((m.pt_visible, visible_ids), (m.pt_found, found_ids)):
        ok = ids >= 0
        counter.index_add_(0, torch.where(ok, ids, M - 1).long(), ok.to(torch.int32))
    return m


def bump_point_stats_rows_kernel(
    m: MapArrays, ids: torch.Tensor, acc: torch.Tensor
) -> MapArrays:
    """Apply an accumulated (V, 2) [visible, found] count block onto the
    global counters in one scatter each. The accumulator is carried frame
    to frame by the fused frame step, so per-frame stat bumps cost no extra
    map update; the reference bumps per frame from TrackLocalMap
    (MapPoint::IncreaseVisible/Found, src/Tracking.cc:2321-2419)."""
    M = m.pt_pos.shape[0]
    ok = ids >= 0
    tgt = torch.where(ok, ids, M - 1).long()
    okz = ok.to(torch.int32)
    m.pt_visible.index_add_(0, tgt, (acc[:, 0] * okz).to(torch.int32))
    m.pt_found.index_add_(0, tgt, (acc[:, 1] * okz).to(torch.int32))
    return m


def apply_ba_kernel(
    m: MapArrays,
    kf_slots: torch.Tensor,       # (L,) int32 slots whose poses were optimized
    kf_slot_valid: torch.Tensor,  # (L,) bool
    new_poses: torch.Tensor,      # (L, 4, 4)
    pt_ids: torch.Tensor,         # (P,) int32 landmark ids optimized (-1 pad)
    new_pts: torch.Tensor,        # (P, 3)
) -> MapArrays:
    """Scatter local-BA results back into the map."""
    K = m.kf_pose.shape[0]
    M = m.pt_pos.shape[0]
    ks = torch.where(kf_slot_valid, kf_slots, K - 1).long()
    _set_rows(m.kf_pose, ks, kf_slot_valid, new_poses)
    ok = pt_ids >= 0
    _set_rows(m.pt_pos, torch.where(ok, pt_ids, M - 1).long(), ok, new_pts)
    return m


def refresh_landmarks_kernel(
    m: MapArrays,
    ids: torch.Tensor,      # (V,) landmark ids (-1 pad)
    kf_of: torch.Tensor,    # (V, OBS) observing keyframe slots
    kp_of: torch.Tensor,    # (V, OBS) keypoint index within that keyframe
    cnt: torch.Tensor,      # (V,) number of valid observations
) -> MapArrays:
    """Distinctive-descriptor vote + normal refresh for landmarks.

    MapPoint::ComputeDistinctiveDescriptors (src/MapPoint.cc:359): among a
    landmark's observed descriptors, keep the one minimizing the median
    Hamming distance to the others. MapPoint::UpdateNormalAndDepth (:477):
    normal = mean unit vector landmark -> camera centres.
    """
    V, OBS = kf_of.shape
    kfo, kpo = kf_of.long(), kp_of.long()
    desc8 = m.kf_desc[kfo, kpo]                              # (V, OBS, 256)
    # The JAX kernel takes an int32 einsum; CUDA has no integer batched
    # product, and the f32 one is exact (every partial sum is <= 256).
    d = desc8.to(torch.float32)
    dot = torch.einsum("voi,vpi->vop", d, d)
    n1 = torch.sum(d, dim=-1)
    dist = (n1[:, :, None] + n1[:, None, :] - 2.0 * dot).to(torch.int32)
    obs_ok = torch.arange(OBS, device=cnt.device)[None, :] < cnt[:, None]
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    big = 1 << 20
    dist = torch.where(pair_ok, dist, big)
    srt = torch.sort(dist, dim=-1).values                    # (V, OBS, OBS)
    med_idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    med = torch.gather(srt, -1, med_idx.long()[:, None, None].expand(V, OBS, 1))[..., 0]
    med = torch.where(obs_ok, med, big)
    # torch.argmin, like jnp.argmin, returns the first minimum on ties
    best = torch.argmin(med, dim=-1)                         # (V,)
    new_desc = desc8[torch.arange(V, device=best.device), best]   # (V, 256)

    M = m.pt_pos.shape[0]
    safe_ids = torch.where(ids >= 0, ids, M - 1).long()
    pos = m.pt_pos[safe_ids]                                 # (V, 3)
    poses = m.kf_pose[kfo]                                   # (V, OBS, 4, 4)
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    centers = -torch.einsum("voji,voj->voi", R, t)
    rel = pos[:, None, :] - centers
    dd = torch.linalg.vector_norm(rel, dim=-1)
    unit = rel / torch.clamp(dd[..., None], min=1e-9)
    normal = torch.sum(unit * obs_ok.to(pos.dtype)[..., None], dim=1)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-9)

    ok = (ids >= 0) & (cnt > 0)
    _set_rows(m.pt_desc, safe_ids, ok, new_desc)
    _set_rows(m.pt_normal, safe_ids, ok, normal)
    return m


def compact_keyframes_kernel(
    m: MapArrays,
    src: torch.Tensor,     # (K,) int32: old slot gathered into each new slot
    src_ok: torch.Tensor,  # (K,) bool: new slot holds a real keyframe
    lut: torch.Tensor,     # (K,) int32 old->new slot (-1 = culled)
) -> MapArrays:
    """Permute keyframe slots so alive keyframes occupy a dense prefix.

    Slot reuse after culling (the reference frees KeyFrame objects via
    SetBadFlag + erase, src/KeyFrame.cc:599). The permutation preserves
    temporal order. pt_first_kf is remapped through the LUT; landmarks
    whose reference keyframe was culled get -1."""
    s = src.long()
    pf = m.pt_first_kf
    pf_new = torch.where(pf >= 0, lut[torch.clamp(pf, min=0).long()], -1)
    return m._replace(
        kf_pose=m.kf_pose[s],
        kf_valid=src_ok.clone(),
        kf_xy=m.kf_xy[s],
        kf_ur=m.kf_ur[s],
        kf_depth=m.kf_depth[s],
        kf_inv_sigma2=m.kf_inv_sigma2[s],
        kf_angle=m.kf_angle[s],
        kf_desc=m.kf_desc[s],
        kf_kp_valid=m.kf_kp_valid[s] & src_ok[:, None],
        kf_obs=torch.where(src_ok[:, None], m.kf_obs[s], -1).to(torch.int32),
        pt_first_kf=pf_new.to(torch.int32),
    )


def cull_points_kernel(m: MapArrays, cull_ids: torch.Tensor) -> MapArrays:
    """Invalidate landmarks (MapPointCulling, src/LocalMapping.cc:262) and
    erase their observations."""
    M = m.pt_pos.shape[0]
    mask = cull_ids >= 0
    ids = torch.where(mask, cull_ids, M - 1).long()
    _set_rows(m.pt_valid, ids, mask, False)
    is_culled = torch.zeros(M + 1, dtype=torch.bool, device=mask.device)
    is_culled[ids] = mask
    obs = m.kf_obs
    hit = (obs >= 0) & is_culled[torch.clamp(obs, 0, M - 1).long()]
    m.kf_obs.masked_fill_(hit, -1)
    return m
