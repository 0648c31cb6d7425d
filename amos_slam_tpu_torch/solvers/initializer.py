"""Monocular map initialization: batched H/F RANSAC and motion recovery
(port of solvers/initializer.py).

The counterpart of the reference's Initializer (src/Initializer.cc:68-1845):
RANSAC over a homography (4-point DLT) and a fundamental matrix (8-point),
model selection by the score ratio RH = SH / (SH + SF) > 0.40, then
ReconstructH (Faugeras's decomposition) or ReconstructF (the four
decompositions of E), each candidate validated by triangulating and
counting the points that pass cheirality, reprojection and parallax
(CheckRT). Here the two hypothesis batches run side by side and the 4 + 4
motion candidates are checked by one batched triangulation.

The draws: ``jax.random.choice`` cannot be reproduced by torch, so
:func:`initialize_two_view` takes the F and H sample indices
(``sample_idx_f`` (n_hyp, 8), ``sample_idx_h`` (n_hyp, 4)) where a caller
has them, and otherwise draws both from ``generator``.

Signs. ``eigh`` returns each null vector up to sign and SVD each singular
pair up to sign; both sets of candidates are closed under those flips
(a flipped H negates every candidate's t, which is the candidate with both
Faugeras signs flipped; a flipped singular pair of E swaps R1 and R2 or
t and -t), so only the order of the candidates can differ from the JAX
package's, and the winner is the same unless two candidates tie.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.camera import Camera
from ..geometry.triangulate import triangulate_dlt
from .fundamental import _f_from_8, _normalize_points, epipolar_distance
from .pnp import draw_samples

CHI2_H = 5.991
CHI2_F = 3.841


def _h_from_4(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 4-point DLT homography: (H, 4, 2) x2 -> (H, 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                             # (H, 8, 9)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    _, V = torch.linalg.eigh(AtA)
    h = V[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _h_transfer_error(Hm: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Symmetric transfer errors under H: (..., N) squared px errors both ways."""
    def apply(H, x):
        p = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], -1)
        y = torch.einsum("...ij,nj->...ni", H, p)
        w = y[..., 2:]
        return y[..., :2] / torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)

    Hinv = torch.linalg.inv(Hm)
    e12 = torch.sum((apply(Hm, x1) - x2) ** 2, dim=-1)
    e21 = torch.sum((apply(Hinv, x2) - x1) ** 2, dim=-1)
    return e12, e21


class InitResult(NamedTuple):
    ok: torch.Tensor          # () bool
    used_h: torch.Tensor      # () bool which model was selected
    Tcw2: torch.Tensor        # (4, 4) pose of frame 2 (frame 1 = identity)
    points: torch.Tensor      # (N, 3) triangulated points
    point_ok: torch.Tensor    # (N,) triangulation validity
    num_good: torch.Tensor


def _check_rt(R, t, cam: Camera, x1, x2, match_ok, th2=16.0):
    """Triangulate under each candidate (R, t) ((C, 3, 3), (C, 3)) and score
    it (Initializer::CheckRT, src/Initializer.cc:1578): cheirality in both
    views, reprojection under ``th2`` px^2 in both, and parallax.
    ``match_ok`` is (C, N). Returns ((C,) scores, (C, N, 3) points,
    (C, N) good masks)."""
    C = R.shape[0]
    K = cam.K
    T2 = se3.make_T(R, t)                                       # (C, 4, 4)
    P1 = (K @ torch.eye(4, dtype=K.dtype, device=K.device)[:3]).expand(C, 3, 4)
    P2 = K @ T2[:, :3]
    X, _ = triangulate_dlt(P1, P2, x1.expand(C, -1, -1), x2.expand(C, -1, -1))
    z1 = X[..., 2]
    z2 = se3.transform_points(T2, X)[..., 2]

    def reproj(P, X):
        Xh = torch.cat([X, torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)], -1)
        y = torch.einsum("cij,cnj->cni", P, Xh)
        return y[..., :2] / torch.clamp(y[..., 2:], min=1e-9)

    e1 = torch.sum((reproj(P1, X) - x1) ** 2, dim=-1)
    e2 = torch.sum((reproj(P2, X) - x2) ** 2, dim=-1)

    # parallax between the two viewing rays
    c2 = -torch.einsum("cji,cj->ci", R, t)
    r2 = X - c2[:, None]
    cosp = torch.sum(X * r2, -1) / torch.clamp(
        torch.linalg.vector_norm(X, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-9)
    good = (match_ok & (z1 > 0) & (z2 > 0) & (e1 < th2) & (e2 < th2)
            & (cosp < 0.99998))
    return torch.sum(good, dim=-1, dtype=torch.int32), X, good


def _f_candidates(F: torch.Tensor, K: torch.Tensor):
    """The four (R, t) of E = K^T F K (ReconstructF)."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=F.dtype, device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tu = U[:, 2]
    tu = tu / torch.clamp(torch.linalg.vector_norm(tu), min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([tu, -tu, tu, -tu])


def _h_candidates(Hm: torch.Tensor, K: torch.Tensor):
    """The four (R, t) with d' = +d2 of Faugeras's decomposition of
    A = K^-1 H K (ReconstructH)."""
    A = torch.linalg.inv(K) @ Hm @ K
    Ua, Sa, Vta = torch.linalg.svd(A)
    d1, d2, d3 = Sa[0], Sa[1], Sa[2]
    sgn = torch.linalg.det(Ua) * torch.linalg.det(Vta)
    # x1 / x3 magnitudes; guard equal singular values
    eps = 1e-8
    den = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    x1m = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0))
    x3m = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0))
    z, o = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    for e1s in (1.0, -1.0):
        for e3s in (1.0, -1.0):
            x1v, x3v = e1s * x1m, e3s * x3m
            st = (d1 - d3) * x1v * x3v / torch.clamp(d2, min=eps)
            ct = (d1 * x3v * x3v + d3 * x1v * x1v) / torch.clamp(d2, min=eps)
            nrm = torch.clamp(torch.sqrt(st * st + ct * ct), min=eps)
            st, ct = st / nrm, ct / nrm
            Rp = torch.stack([torch.stack([ct, z, -st]), torch.stack([z, o, z]),
                              torch.stack([st, z, ct])])
            tp = torch.stack([(d1 - d3) * x1v, 0.0 * d1, -(d1 - d3) * x3v])
            t = Ua @ tp
            Rs.append(sgn * Ua @ Rp @ Vta)
            ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-9))
    return torch.stack(Rs), torch.stack(ts)


def initialize_two_view(
    cam: Camera,
    x1: torch.Tensor,          # (N, 2) undistorted keypoints in frame 1
    x2: torch.Tensor,          # (N, 2) matched keypoints in frame 2
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_hyp: int = 256,
    min_good: int = 50,
    min_parallax_deg: float = 1.0,
    *,
    sample_idx_f: Optional[torch.Tensor] = None,   # (n_hyp, 8) int64
    sample_idx_h: Optional[torch.Tensor] = None,   # (n_hyp, 4) int64
) -> InitResult:
    """Two-view initialization: the pose of frame 2 (frame 1 at the
    identity, unit baseline), the triangulated points and their validity.
    ``min_parallax_deg`` is kept for the signature: the parallax gate is
    CheckRT's cos < 0.99998, as in the JAX package."""
    x1n, T1 = _normalize_points(x1, valid)
    x2n, T2 = _normalize_points(x2, valid)
    s = 0.5 * (T1[0, 0] + T1[1, 1])
    if sample_idx_f is None:
        sample_idx_f = draw_samples(valid, n_hyp, 8, generator)
    if sample_idx_h is None:
        sample_idx_h = draw_samples(valid, n_hyp, 4, generator)
    idxF = sample_idx_f.to(x1.device, torch.long)
    idxH = sample_idx_h.to(x1.device, torch.long)
    zero = torch.zeros((), dtype=x1.dtype, device=x1.device)

    # ---- F branch: the reference's SF, sum of (th - e^2) over inliers
    F_h = _f_from_8(x1n[idxF], x2n[idxF])
    dF = epipolar_distance(F_h, x1n, x2n) / s                   # px
    sF = torch.sum(torch.where((dF * dF < CHI2_F) & valid[None], CHI2_H - dF * dF * 1.0, zero),
                   dim=-1)
    bestF = torch.argmax(sF).reshape(1)
    SF = sF.index_select(0, bestF)[0]
    F = T2.T @ F_h.index_select(0, bestF)[0] @ T1

    # ---- H branch: symmetric transfer scores
    H_h = _h_from_4(x1n[idxH], x2n[idxH])
    e12, e21 = _h_transfer_error(H_h, x1n, x2n)
    e12, e21 = e12 / (s * s), e21 / (s * s)
    sH = torch.sum(torch.where((e12 < CHI2_H) & valid[None], CHI2_H - e12, zero)
                   + torch.where((e21 < CHI2_H) & valid[None], CHI2_H - e21, zero), dim=-1)
    bestH = torch.argmax(sH).reshape(1)
    SH = sH.index_select(0, bestH)[0]
    Hm = torch.linalg.inv(T2) @ H_h.index_select(0, bestH)[0] @ T1

    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    # match masks under each model, in pixels
    dF_px = epipolar_distance(F, x1, x2)
    f_ok = (dF_px * dF_px < CHI2_F * 2) & valid
    e12p, e21p = _h_transfer_error(Hm, x1, x2)
    h_ok = (e12p < CHI2_H * 2) & (e21p < CHI2_H * 2) & valid

    # ---- the 4 + 4 motion candidates, one batched CheckRT
    K = cam.K
    Rf, tf = _f_candidates(F, K)
    Rh, th = _h_candidates(Hm, K)
    R, t = torch.cat([Rf, Rh]), torch.cat([tf, th])
    ok_mask = torch.cat([f_ok.expand(4, -1), h_ok.expand(4, -1)])
    scores, X, good = _check_rt(R, t, cam, x1, x2, ok_mask)
    # the first best of each model's four, as jnp.argmax
    pick = torch.where(use_h, 4 + torch.argmax(scores[4:]), torch.argmax(scores[:4])).reshape(1)
    num_good = scores.index_select(0, pick)[0]
    ok = num_good >= min_good
    return InitResult(
        ok=ok, used_h=use_h,
        Tcw2=se3.make_T(R.index_select(0, pick)[0], t.index_select(0, pick)[0]),
        points=X.index_select(0, pick)[0],
        point_ok=good.index_select(0, pick)[0] & ok,
        num_good=num_good,
    )
