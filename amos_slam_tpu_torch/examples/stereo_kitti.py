"""KITTI stereo main (reference Examples/Stereo/stereo_kitti.cc) on the port.

    python3 -m amos_slam_tpu_torch.examples.stereo_kitti SEQUENCE_DIR --seq-id 0
        [--out KittiTrajectory.txt] [--max-frames N] [--device cpu]

Writes a KITTI-format trajectory for the standard odometry evaluation.
"""

import argparse

from ._common import Timer, add_common, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--seq-id", type=int, default=0)
    add_common(ap, "KittiTrajectory.txt")
    args = ap.parse_args(argv)

    from amos_slam_tpu_torch.config import ORBConfig, SystemConfig
    from amos_slam_tpu_torch.io.kitti import KittiStereoDataset, kitti_camera_config
    from amos_slam_tpu_torch.system import System

    cfg = SystemConfig(
        camera=kitti_camera_config(args.seq_id),
        orb=ORBConfig(n_features=2000, max_kpts=2048),   # reference KITTI yaml
        sensor="stereo",
        use_dynamics=False,
    )
    ds = KittiStereoDataset(args.sequence)
    slam = System(cfg, device=args.device)
    timer = Timer()
    n = n_frames(len(ds), args.max_frames)
    for i in range(n):
        left, right, ts = ds[i]
        timer.track(slam.track_stereo, left, right, ts)
        timer.progress(i, n, slam, 100)
    slam.shutdown()
    slam.save_trajectory_kitti(args.out)
    print(timer.summary())


if __name__ == "__main__":
    main()
