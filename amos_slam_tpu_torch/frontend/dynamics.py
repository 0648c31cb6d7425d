"""Geometric stage two of the dynamic-object rejection (port of
frontend/dynamics.py): Tracking::GetSceneFlowObj (reference
src/Tracking.cc:850-1186) fused with Frame::CalDyna (src/Frame.cc:517-667).

  1. pyramidal LK flow of the previous frame's corners          (:896)
  2. back-projection through the previous depth; batched PnP-RANSAC
     against the motion-model prediction, arbitrated under plausibility
     gates                                                       (:963-1131)
  3. epipolar distances under the F derived from the winning pose (:1133)
  4. per-track reprojection errors under the winner             (:1023)
  5. 3D scene flow                                              (:1149-1184)
  6. SLIC + k-means depth clusters on the current frame         (Frame.cc:525)
  7. per-cluster coherent-median votes against EMA-adapted gates
  8. the suppression mask: the dilated stage-one mask, when one is given,
     OR the dynamic cluster pixels (MovingKeyPoints,
     src/ORBextractor.cc:1688-1745)

The mask feeds ``ORBPipeline.describe``, which drops keypoints before
their descriptors are computed. Nothing here reads the device from the
host: the arbitration, the gates and the masks stay tensors, and the
RANSAC generator is seeded from host ints.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DynamicsConfig
from ..geometry import se3
from ..geometry.camera import Camera, backproject
from ..ops.f32 import recip, seq_sum
from ..ops.lk import lk_flow
from ..ops.slic import dilate_mask, rgb_to_lab, slic_kmeans
from ..solvers.fundamental import epipolar_distance
from ..solvers.pnp import ransac_pnp

RANSAC_SEED = 20240817


class DynamicsResult(NamedTuple):
    suppress_mask: torch.Tensor    # (H, W) bool: drop keypoints here
    geom_mask: torch.Tensor        # (H, W) bool: the geometric cluster part
                                   # only (no stage-one mask); the part that
                                   # dyn_stride > 1 reuses
    dynamic_cluster: torch.Tensor  # (k,) bool
    pixel_cluster: torch.Tensor    # (H, W) int64
    epi_outlier: torch.Tensor      # (N,) bool (the reference's T_M set)
    rpe: torch.Tensor              # (N,) per-track reprojection error
    flow3d: torch.Tensor           # (N,) scene-flow magnitude
    flow_pts1: torch.Tensor        # (N, 2) tracked positions in the current frame
    flow_valid: torch.Tensor       # (N,) bool
    T_used: torch.Tensor           # (4, 4) arbitration winner
    used_pnp: torch.Tensor         # () bool
    gate_state: torch.Tensor       # (3,) EMA noise levels [rpe, epi, flow]:
                                   # the next frame's ``gate_state``


def config_kwargs(dcfg: DynamicsConfig) -> dict:
    """The keyword arguments of :func:`compute_dynamics` that a
    DynamicsConfig sets (all but ``has_seg``)."""
    return dict(
        epi_outlier_th=dcfg.epipolar_outlier_th,
        mean_rpe_th=dcfg.mean_rpe_th,
        flow3d_th=dcfg.flow3d_th,
        n_clusters=dcfg.n_clusters,
        slic_cell=dcfg.slic_cell,
        slic_iters=dcfg.slic_iters,
        dilate_radius=dcfg.mask_dilate_radius,
        slic_compactness=dcfg.slic_compactness,
        slic_downsample=dcfg.slic_downsample,
        lk_levels=dcfg.lk_levels,
        lk_win=dcfg.lk_win,
        lk_iters=dcfg.lk_iters,
        lk_downsample=dcfg.lk_downsample,
        pnp_hypotheses=dcfg.pnp_hypotheses,
    )


def ransac_generator(frame_idx: int, device) -> torch.Generator:
    """The RANSAC generator of frame ``frame_idx``, seeded from
    (RANSAC_SEED, frame_idx): the per-frame and the chunk paths draw the
    same samples for the same frame (the JAX package folds the frame index
    into PRNGKey(20240817))."""
    gen = torch.Generator(device=device)
    gen.manual_seed((RANSAC_SEED << 32) + (int(frame_idx) & 0xFFFFFFFF))
    return gen


def _masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """q-quantile of x where mask, 0 if the mask is empty."""
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    cnt = torch.sum(mask, dtype=torch.int32)
    idx = torch.clamp((cnt.to(torch.float32) * q).to(torch.long), 0, x.shape[0] - 1)
    v = vals.gather(0, idx.reshape(1))[0]
    return torch.where(cnt > 0, v, torch.zeros_like(v))


def _segment_count(w: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) sum of the 0/1 weights ``w`` per segment id: integers below
    2^24, exact in any order of addition (so ``index_add_`` serves)."""
    out = torch.zeros(n, dtype=w.dtype, device=w.device)
    return out.index_add_(0, seg, w)


def _cluster_median(vals: torch.Tensor, member: torch.Tensor,
                    pt_cluster: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """(C,) median of vals over each cluster's member tracks (0 if none).

    A median, not a mean: on weak texture a few aliased LK tracks put 30+
    px errors inside static clusters. One sort for all clusters: tracks
    sort by the key (cluster, normalized value), non-members keyed past
    every cluster, and each median is a 2-element pick at its cluster's
    rank offsets. ``torch.sort(stable=True)`` where JAX's one-key
    ``lax.sort`` is not stable: equal keys only come from equal normalized
    values, so the picked value is the same."""
    N = vals.shape[0]
    c = torch.where(member, pt_cluster, torch.full_like(pt_cluster, n_clusters))
    finite = torch.isfinite(vals) & member
    v_m = torch.where(finite, vals, torch.zeros_like(vals))
    inf = torch.full_like(vals, float("inf"))
    vmin = torch.min(torch.where(finite, v_m, inf))
    vmax = torch.max(torch.where(finite, v_m, -inf))
    span = torch.clamp(vmax - vmin, min=1e-20)
    vn = torch.clamp((v_m - vmin) / span, 0.0, 1.0)
    key = c.to(torch.float32) * 2.0 + torch.where(finite, vn, torch.full_like(vn, 1.5))
    order = torch.sort(key, stable=True).indices
    v_sorted = v_m[order]

    ones = torch.ones(N, dtype=torch.int32, device=vals.device)
    cnt_all = _segment_count(ones, c, n_clusters + 1)
    start = torch.cumsum(cnt_all, dim=0) - cnt_all                  # (C+1,)
    cnt = _segment_count(finite.to(torch.int32), pt_cluster, n_clusters)
    lo = start[:n_clusters] + torch.clamp(cnt - 1, min=0) // 2
    hi = start[:n_clusters] + cnt // 2
    med = 0.5 * (v_sorted[torch.clamp(lo, 0, N - 1)] + v_sorted[torch.clamp(hi, 0, N - 1)])
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def _project(cam: Camera, T: torch.Tensor, pts_w: torch.Tensor):
    pc = se3.transform_points(T, pts_w)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    return u, v, pc[..., 2]


def _reproj_err(cam: Camera, T: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor):
    u, v, z = _project(cam, T, pts_w)
    du, dv = u - uv[..., 0], v - uv[..., 1]
    return torch.sqrt(du * du + dv * dv), z


def _reproj_residual(cam: Camera, T: torch.Tensor, pts_w, uv) -> torch.Tensor:
    """(N, 2) signed reprojection residual (projection - observation)."""
    u, v, _ = _project(cam, T, pts_w)
    return torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)


def _coherent_mag(res_vec: torch.Tensor, member: torch.Tensor,
                  pt_cluster: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """(C,) norm of each cluster's median residual vector. A rigid mover
    displaces its tracks coherently and keeps the magnitude; aliased
    weak-texture tracks jump in random directions and cancel."""
    comps = [_cluster_median(res_vec[..., c], member, pt_cluster, n_clusters)
             for c in range(res_vec.shape[-1])]
    acc = comps[0] * comps[0]
    for c in comps[1:]:
        acc = acc + c * c
    return torch.sqrt(acc)


def _upsample_edge(x: torch.Tensor, ds: int, H: int, W: int) -> torch.Tensor:
    """(H//ds, W//ds) -> (H, W): block replication, edge rows/columns
    repeated where ds does not divide the size."""
    if ds == 1:
        return x
    Hh, Wh = x.shape
    rows = torch.clamp(torch.arange(H, device=x.device) // ds, max=Hh - 1)
    cols = torch.clamp(torch.arange(W, device=x.device) // ds, max=Wh - 1)
    return x[rows][:, cols]


def _norm_last(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(seq_sum(x * x))


def compute_dynamics(
    cam: Camera,
    prev_gray: torch.Tensor,
    prev_depth: torch.Tensor,
    cur_gray: torch.Tensor,
    cur_depth: torch.Tensor,
    seg_mask: Optional[torch.Tensor],  # (H, W) stage-one mask (any dtype);
                                   # read only with has_seg
    last_Tcw: torch.Tensor,
    velocity: torch.Tensor,        # constant-velocity model: the prediction
                                   # is orthonormalize(velocity @ last_Tcw)
    flow_pts: torch.Tensor,        # (N, 2) (x, y) corners in the previous frame
    flow_pts_valid: torch.Tensor,  # (N,)
    frame_idx: int,                # seeds the RANSAC generator (host int)
    epi_outlier_th: float = 1.0,
    mean_rpe_th: float = 3.0,
    flow3d_th: float = 0.04,       # meters/frame (~1.2 m/s at 30 fps)
    n_clusters: int = 15,
    slic_cell: int = 16,
    slic_iters: int = 5,
    dilate_radius: int = 15,
    slic_compactness: float = 10.0,
    track_err_th: float = 12.0,
    pnp_gate_rot: float = 0.06,    # rad/frame PnP plausibility
    pnp_gate_trans: float = 0.15,  # m/frame
    has_seg: bool = True,          # False leaves the stage-one mask out
    slic_downsample: int = 1,      # SLIC resolution divisor
    lk_levels: int = 4,
    lk_win: int = 7,
    lk_iters: int = 6,
    lk_downsample: int = 1,        # track flow on 1/n-res frames
    pnp_hypotheses: int = 256,
    cur_rgb: Optional[torch.Tensor] = None,     # (H, W, 3) RGB: SLIC in CIELAB
    gate_state: Optional[torch.Tensor] = None,  # (3,) EMA levels of the
                                   # previous frame; None starts at the
                                   # absolute thresholds
    pnp_sample_idx: Optional[torch.Tensor] = None,  # (pnp_hypotheses, 6)
                                   # RANSAC samples in place of the draw
) -> DynamicsResult:
    H, W = cur_gray.shape
    dev = cur_gray.device
    prev_gray = prev_gray.to(torch.float32)
    cur_gray = cur_gray.to(torch.float32)
    T_pred = se3.orthonormalize(velocity @ last_Tcw)

    # 1. optical flow + the reference's neighbourhood-SAD gate
    # (src/Tracking.cc:902-924): tracks whose window residual stays high
    # are appearance failures (disocclusion trails) and must not vote.
    # 512 well-spread sources carry the same signal as all corners.
    if flow_pts.shape[0] > 512:
        flow_pts = flow_pts[::2][:512]
        flow_pts_valid = flow_pts_valid[::2][:512]
    if lk_downsample > 1:
        # a lk_win half-window on 1/n-res frames covers n x the context;
        # one pyramid level less spans the same displacement range
        lds = lk_downsample
        flow = lk_flow(
            prev_gray[::lds, ::lds], cur_gray[::lds, ::lds],
            flow_pts * recip(lds), flow_pts_valid,
            levels=max(lk_levels - 1, 1), win_half=lk_win, iters=lk_iters,
        )
        flow = flow._replace(pts1=flow.pts1 * lds)
    else:
        flow = lk_flow(prev_gray, cur_gray, flow_pts, flow_pts_valid,
                       levels=lk_levels, win_half=lk_win, iters=lk_iters)
    good_track = flow.valid & (flow.err < track_err_th)

    # 2. 3D from the previous depth; PnP vs motion-model arbitration
    xi = torch.clamp(torch.round(flow_pts[:, 0]).to(torch.long), 0, W - 1)
    yi = torch.clamp(torch.round(flow_pts[:, 1]).to(torch.long), 0, H - 1)
    d0 = prev_depth[yi, xi]
    has3d = good_track & (d0 > 0)
    pc0 = backproject(cam, flow_pts, torch.clamp(d0, min=1e-3))
    pts_w = se3.transform_points(se3.inv_T(last_Tcw), pc0)

    pnp = ransac_pnp(cam, pts_w, flow.pts1, has3d,
                     generator=(ransac_generator(frame_idx, dev)
                                if pnp_sample_idx is None else None),
                     n_hyp=pnp_hypotheses, sample_idx=pnp_sample_idx)
    err_pred, _ = _reproj_err(cam, T_pred, pts_w, flow.pts1)

    # 2b. depth clusters on the current frame (strided subsample when
    # slic_downsample > 1: pooling would mix surfaces at object borders)
    ds = slic_downsample
    Hh, Wh = H // ds, W // ds
    if cur_rgb is not None:
        # Lab spans ~[0,100] / [-100,100] against grey's [0,255]: rescale so
        # the compactness keeps the same balance in both modes
        feat_img = rgb_to_lab(cur_rgb)[::ds, ::ds][:Hh, :Wh] * 2.55
    else:
        feat_img = cur_gray[::ds, ::ds][:Hh, :Wh]
    depth_h = cur_depth[::ds, ::ds][:Hh, :Wh]
    cl = slic_kmeans(
        feat_img, depth_h,
        cell=max(slic_cell // ds, 4) if ds > 1 else slic_cell,
        compactness=slic_compactness, slic_iters=slic_iters, k=n_clusters,
    )
    x1i = torch.clamp(torch.round(flow.pts1[:, 0]).to(torch.long), 0, W - 1)
    y1i = torch.clamp(torch.round(flow.pts1[:, 1]).to(torch.long), 0, H - 1)
    pt_cluster = cl.pixel_cluster[torch.clamp(y1i // ds, 0, Hh - 1),
                                  torch.clamp(x1i // ds, 0, Wh - 1)]

    # Arbitration: PnP rescues a broken prediction and never competes with
    # a healthy one. Raw inlier-count arbitration (the reference's,
    # src/Tracking.cc:1023-1131) inverts when a textured mover dominates
    # the tracks: PnP locks onto the mover's consensus and the whole
    # rejection flips. The prediction comes from a pose chain re-optimized
    # against the map every frame, so PnP fires only when the prediction's
    # support collapsed, under the velocity-jump plausibility bound.
    err_pnp, _ = _reproj_err(cam, pnp.Tcw, pts_w, flow.pts1)

    def _support(err):
        ok = ((err < 2.0) & has3d).to(torch.float32)
        per = _segment_count(ok, pt_cluster, n_clusters)
        return torch.sum(per >= 2.0), torch.sum(ok)

    sup_pred, n_pred = _support(err_pred)
    sup_pnp, n_pnp = _support(err_pnp)
    rel = pnp.Tcw @ se3.inv_T(T_pred)
    cos_ang = 0.5 * (seq_sum(torch.diagonal(rel[:3, :3])) - 1.0)
    # the gate as jnp.cos of an f32 angle gives it
    rot_ok = cos_ang > float(torch.cos(torch.tensor(pnp_gate_rot, dtype=torch.float32)))
    trans_ok = _norm_last(rel[:3, 3]) < pnp_gate_trans
    pred_broken = (sup_pred < 4) & (n_pred < 15)
    use_pnp = pnp.ok & rot_ok & trans_ok & pred_broken & (
        (sup_pnp > sup_pred) | ((sup_pnp == sup_pred) & (n_pnp > n_pred))
    )
    T_used = torch.where(use_pnp, pnp.Tcw, T_pred)

    # 3. epipolar residuals under the F derived from the winning pose,
    # F = K^-T [t]x R K^-1 of the prev->cur relative pose: moving points
    # are epipolar outliers however much of the image they cover (a RANSAC
    # F, the reference's src/Tracking.cc:927-945, locks onto a dominant
    # mover's consensus)
    rel_pc = T_used @ se3.inv_T(last_Tcw)
    E = se3.hat(rel_pc[:3, 3]) @ rel_pc[:3, :3]
    inv_fx, inv_fy = 1.0 / cam.fx, 1.0 / cam.fy
    zero, one = torch.zeros_like(inv_fx), torch.ones_like(inv_fx)
    Kinv = torch.stack([
        torch.stack([inv_fx, zero, -cam.cx * inv_fx]),
        torch.stack([zero, inv_fy, -cam.cy * inv_fy]),
        torch.stack([zero, zero, one]),
    ])
    F_pose = Kinv.T @ E @ Kinv
    epi_dist = epipolar_distance(F_pose, flow_pts, flow.pts1)

    # 4. per-track RPE under the winner (the reference's mvRpe)
    rpe, _ = _reproj_err(cam, T_used, pts_w, flow.pts1)
    rpe = torch.where(has3d, rpe, torch.zeros_like(rpe))

    # 5. 3D scene flow: current-depth backprojection vs the previous point
    d1 = cur_depth[y1i, x1i]
    pc1 = backproject(cam, flow.pts1, torch.clamp(d1, min=1e-3))
    pts_w1 = se3.transform_points(se3.inv_T(T_used), pc1)
    flow3d = _norm_last(pts_w1 - pts_w)
    flow3d = torch.where(has3d & (d1 > 0), flow3d, torch.zeros_like(flow3d))

    # depth consistency: a tracked moving surface keeps (roughly) its
    # depth; disocclusion-trail failures land on background at another
    # depth than their source point predicts
    z_pred = se3.transform_points(T_used, pts_w)[..., 2]
    depth_consistent = (d1 > 0) & (
        torch.abs(d1 - z_pred) < 0.3 * torch.clamp(z_pred, min=1e-3))

    # 6. per-cluster votes and coherent-displacement statistics. Within a
    # cluster: the norm of the median residual vector. Across clusters the
    # scene level cannot be a median of cluster statistics (a large mover
    # spans many clusters), so it lives across time: an EMA carried frame to
    # frame (gate_state), measured only from clusters the current gate
    # calls static, falling back to all clusters when every one trips.
    w3 = has3d.to(torch.float32)
    wt = good_track.to(torch.float32)
    rpe_cnt = _segment_count(w3, pt_cluster, n_clusters)
    epi_cnt = _segment_count(wt, pt_cluster, n_clusters)
    r_vec = _reproj_residual(cam, T_used, pts_w, flow.pts1)
    mag_rpe = _coherent_mag(r_vec, has3d, pt_cluster, n_clusters)
    med_epi = _cluster_median(epi_dist, good_track, pt_cluster, n_clusters)

    if gate_state is None:
        gate_state = torch.zeros(3, dtype=torch.float32, device=dev)
    cl_ok = rpe_cnt >= 2
    rpe_gate = torch.clamp(2.5 * gate_state[0], min=mean_rpe_th)
    epi_gate = torch.clamp(3.0 * gate_state[1], min=epi_outlier_th)

    epi_out = (epi_dist > epi_gate) & good_track
    epi_vote = epi_out & has3d & depth_consistent
    votes = _segment_count(epi_vote.to(torch.float32), pt_cluster, n_clusters)

    # Scene-flow criterion: the epipolar test is blind to motion along the
    # epipolar plane; the 3D scene flow (both frames' depth under the
    # winning pose) is not, and the depth-consistency gate guards its
    # disocclusion failure. The reference computes vFlow_3d
    # (src/Tracking.cc:1149-1184) but only displays it.
    wf_m = has3d & (d1 > 0) & depth_consistent
    flow_cnt = _segment_count(wf_m.to(torch.float32), pt_cluster, n_clusters)
    mag_flow = _coherent_mag(pts_w1 - pts_w, wf_m, pt_cluster, n_clusters)
    flow_gate = torch.clamp(3.0 * gate_state[2], min=flow3d_th)
    # conjunction with the RPE gate: the coherent reprojection magnitude
    # cross-checks depth noise
    dyn_flow = (mag_flow >= flow_gate) & (flow_cnt >= 2) & (mag_rpe >= rpe_gate)

    dynamic_cluster = ((votes > 0) & (mag_rpe >= rpe_gate) & (rpe_cnt >= 2)) | dyn_flow

    def _lvl(med, cnt_ok, dyn):
        static_cl = cnt_ok & ~dyn
        m = torch.where(torch.any(static_cl),
                        _masked_quantile(med, static_cl, 0.5),
                        _masked_quantile(med, cnt_ok, 0.3))
        return torch.where(torch.any(cnt_ok), m, torch.full_like(m, float("nan")))

    meas = torch.stack([
        _lvl(mag_rpe, cl_ok, dynamic_cluster),
        _lvl(med_epi, epi_cnt >= 2, dynamic_cluster),
        _lvl(mag_flow, flow_cnt >= 2, dynamic_cluster),
    ])
    gate_new = torch.where(torch.isnan(meas), gate_state, 0.8 * gate_state + 0.2 * meas)

    # 8. the suppression mask. Dynamic clusters are cluster-granular and
    # are not dilated; the stage-one mask is (src/ORBextractor.cc:1697).
    dyn_pix = _upsample_edge(dynamic_cluster[cl.pixel_cluster], ds, H, W)
    suppress = (dilate_mask(seg_mask.to(torch.bool), dilate_radius) | dyn_pix
                if has_seg else dyn_pix)

    return DynamicsResult(
        suppress_mask=suppress,
        geom_mask=dyn_pix,
        dynamic_cluster=dynamic_cluster,
        pixel_cluster=_upsample_edge(cl.pixel_cluster, ds, H, W),
        epi_outlier=epi_out,
        rpe=rpe,
        flow3d=flow3d,
        flow_pts1=flow.pts1,
        flow_valid=flow.valid,
        T_used=T_used,
        used_pnp=use_pnp,
        gate_state=gate_new,
    )
