"""Offline visualization: map/trajectory artifact dumps (port of viewer.py).

Replaces the reference's live Pangolin viewer stack (Viewer/FrameDrawer/
MapDrawer, src/Viewer.cc:77, src/MapDrawer.cc:58) with artifact dumping fit
for headless machines: PLY point clouds (any viewer opens them), PNG
top-down trajectory/map plots (matplotlib if present, imported only when a
plot is asked for), and per-frame debug overlays equivalent to
FrameDrawer::DrawFrame/DivisionDrawer (src/FrameDrawer.cc:54,185).
Everything here runs on the host: tensors are read to numpy first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .io import trajectory
from .io.evaluate import positions_from_cw


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Write an ASCII PLY point cloud."""
    points = _np(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            colors = _np(colors)
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.4f} {points[i,1]:.4f} {points[i,2]:.4f}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")


def dump_map(slam, out_prefix: str):
    """Dump the live map: landmarks as PLY + keyframe trajectory TUM file."""
    m = slam.map
    alive = np.where(m.pt_alive)[0]
    pts = _np(m.arrays.pt_pos)[alive]
    save_ply(out_prefix + "_map.ply", pts)
    # keyframe trajectory (SaveKeyFrameTrajectoryTUM, src/System.cc:520)
    K = m.n_kfs
    poses = _np(m.arrays.kf_pose[:K])
    ts = [float(t) for t in m.kf_frame_id[:K]]
    trajectory.save_tum(out_prefix + "_keyframes.txt", ts, list(poses))


def plot_topdown(
    slam, gt_poses=None, path: str = "map_topdown.png", draw_graph: bool = True
):
    """Top-down (x-z) view of trajectory + landmarks; needs matplotlib
    (returns False without it).

    With draw_graph, also renders the MapDrawer::DrawKeyFrames content
    (src/MapDrawer.cc:106-232): keyframe positions, covisibility edges
    (weight >= threshold), spanning-tree edges, and loop edges."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False

    fig, ax = plt.subplots(figsize=(8, 8))
    m = slam.map
    alive = np.where(m.pt_alive)[0]
    if len(alive):
        pts = _np(m.arrays.pt_pos)[alive]
        ax.scatter(pts[:, 0], pts[:, 2], s=0.5, c="#888888", label="landmarks")
    if draw_graph and m.n_kfs > 0:
        K = m.n_kfs
        kf_alive = m.kf_alive[:K]
        centers = positions_from_cw(_np(m.arrays.kf_pose[:K]))

        def _edges(pairs, color, lw, label):
            first = True
            for i, j in pairs:
                if not (kf_alive[i] and kf_alive[j]):
                    continue
                ax.plot(
                    [centers[i, 0], centers[j, 0]],
                    [centers[i, 2], centers[j, 2]],
                    "-", c=color, lw=lw, alpha=0.6,
                    label=label if first else None,
                )
                first = False

        th = m.cfg.map.covis_weight_th
        ii, jj = np.nonzero(np.triu(m.covis[:K, :K] >= th, k=1))
        _edges(zip(ii.tolist(), jj.tolist()), "#9ecae1", 0.5, "covisibility")
        par = m.kf_parent[:K]
        tree = [(k, int(par[k])) for k in range(K) if par[k] >= 0]
        _edges(tree, "#2ca02c", 0.9, "spanning tree")
        _edges(
            [(i, j) for i, j, _, _ in m.loop_edges if i < K and j < K],
            "#d62728", 1.6, "loop edges",
        )
        ax.scatter(
            centers[kf_alive, 0], centers[kf_alive, 2], s=12.0,
            c="#08519c", marker="s", label="keyframes", zorder=3,
        )
    est = positions_from_cw(np.asarray(slam.poses_np()))
    ax.plot(est[:, 0], est[:, 2], "-", c="#1f77b4", lw=1.5, label="estimate")
    if gt_poses is not None:
        gt = positions_from_cw(np.asarray(gt_poses))
        ax.plot(gt[:, 0], gt[:, 2], "--", c="#2ca02c", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def draw_frame(gray: np.ndarray, feats, suppress_mask=None) -> np.ndarray:
    """Debug overlay (FrameDrawer::DrawFrame): RGB uint8 image with tracked
    keypoints (green), suppressed/dynamic regions tinted red."""
    img = np.clip(_np(gray), 0, 255).astype(np.uint8)
    rgb = np.stack([img, img, img], axis=-1)
    if suppress_mask is not None:
        m = _np(suppress_mask).astype(bool)
        rgb[m, 0] = np.minimum(255, rgb[m, 0].astype(int) + 80).astype(np.uint8)
    xy = _np(feats.kp.xy)
    valid = _np(feats.valid)
    H, W = img.shape
    for (x, y) in xy[valid]:
        xi, yi = int(round(x)), int(round(y))
        if 1 <= xi < W - 1 and 1 <= yi < H - 1:
            rgb[yi - 1: yi + 2, xi - 1: xi + 2, 1] = 255
    return rgb
