"""Map checkpoint/resume (port of slam_map/checkpoint.py).

The reference never implemented SaveMap/LoadMap (explicit TODO,
include/System.h:148-151) because its map is a pointer graph. Ours is
tensors, so persistence is one compressed npz of the MapArrays plus the
small host mirrors -- and resume is exact.

The file is the JAX package's: the same keys and dtypes, so a map saved by
either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .map_state import MapArrays


def save_map(path: str, slam_map) -> None:
    a = slam_map.arrays
    cull = list(slam_map.uid_cull.items())
    np.savez_compressed(
        path,
        **{f"arr_{k}": v.detach().cpu().numpy() for k, v in a._asdict().items()},
        n_kfs=slam_map.n_kfs,
        n_pts=slam_map.n_pts,
        kf_obs_np=slam_map.kf_obs_np,
        kf_frame_id=slam_map.kf_frame_id,
        covis=slam_map.covis,
        pt_obs_count=slam_map.pt_obs_count,
        pt_birth_kf=slam_map.pt_birth_kf,
        pt_alive=slam_map.pt_alive,
        kf_alive=slam_map.kf_alive,
        kf_parent=slam_map.kf_parent,
        loop_edge_ij=np.asarray(
            [[i, j] for i, j, _, _ in slam_map.loop_edges], np.int64
        ).reshape(-1, 2),
        loop_edge_T=np.asarray(
            [np.asarray(T) for _, _, T, _ in slam_map.loop_edges], np.float64
        ).reshape(-1, 4, 4),
        loop_edge_s=np.asarray(
            [s for _, _, _, s in slam_map.loop_edges], np.float64
        ),
        kf_uid_next=slam_map.kf_uid_next,
        slot_uid=slam_map.slot_uid,
        uid_cull_k=np.asarray([k for k, _ in cull], np.int64),
        uid_cull_p=np.asarray([p for _, (p, _) in cull], np.int64),
        uid_cull_T=np.asarray(
            [torch.as_tensor(T).detach().cpu().numpy() for _, (_, T) in cull],
            np.float64,
        ).reshape(-1, 4, 4),
    )


def load_map(path: str, slam_map) -> None:
    """Restore into an existing SlamMap (created with the same config), its
    tensors on the map's device."""
    z = np.load(path)
    dev = slam_map.device
    slam_map.arrays = MapArrays(**{
        k: torch.from_numpy(np.ascontiguousarray(z[f"arr_{k}"])).to(dev)
        for k in MapArrays._fields
    })
    slam_map.K = slam_map.arrays.kf_pose.shape[0]
    slam_map.n_kfs = int(z["n_kfs"])
    slam_map.n_pts = int(z["n_pts"])
    slam_map.kf_obs_np = z["kf_obs_np"]
    slam_map.kf_frame_id = z["kf_frame_id"]
    slam_map.covis = z["covis"]
    slam_map.pt_obs_count = z["pt_obs_count"]
    slam_map.pt_birth_kf = z["pt_birth_kf"]
    slam_map.pt_alive = z["pt_alive"]
    if "kf_alive" in z:
        slam_map.kf_alive = z["kf_alive"]
    else:   # older checkpoints: every stored keyframe slot is alive
        slam_map.kf_alive = np.arange(slam_map.K) < slam_map.n_kfs
    if "kf_parent" in z:
        slam_map.kf_parent = z["kf_parent"]
        slam_map.loop_edges = [
            (int(ij[0]), int(ij[1]), T, float(s))
            for ij, T, s in zip(
                z["loop_edge_ij"], z["loop_edge_T"], z["loop_edge_s"]
            )
        ]
    else:   # older checkpoints: chain-parent tree, no recorded loop edges
        par = np.full(slam_map.K, -1, np.int64)
        par[1: slam_map.n_kfs] = np.arange(slam_map.n_kfs - 1)
        slam_map.kf_parent = par
        slam_map.loop_edges = []
    if "slot_uid" in z:
        slam_map.kf_uid_next = int(z["kf_uid_next"])
        slam_map.slot_uid = z["slot_uid"]
        slam_map.uid_cull = {
            int(k): (int(p), torch.from_numpy(np.asarray(T, np.float32)).to(dev))
            for k, p, T in zip(z["uid_cull_k"], z["uid_cull_p"], z["uid_cull_T"])
        }
    else:   # older checkpoints: uid = slot for stored keyframes
        slam_map.kf_uid_next = slam_map.n_kfs
        su = np.full(slam_map.K, -1, np.int64)
        su[: slam_map.n_kfs] = np.arange(slam_map.n_kfs)
        su[~slam_map.kf_alive] = -1
        slam_map.slot_uid = su
        slam_map.uid_cull = {}
    slam_map.version += 1
    slam_map._view_cache = {}
