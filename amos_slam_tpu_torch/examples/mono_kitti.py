"""KITTI monocular main (reference Examples/Monocular/mono_kitti.cc) on
the port: the left grey camera (image_0) with the sequence's intrinsics.

    python3 -m amos_slam_tpu_torch.examples.mono_kitti SEQ_DIR --sequence N
        [--out KeyFrameTrajectory.txt] [--max-frames N] [--device cpu]
"""

import argparse
import os

import numpy as np

from ._common import Timer, add_common, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq_dir")
    ap.add_argument("--sequence", type=int, default=0,
                    help="KITTI sequence number for the intrinsics (0-21)")
    add_common(ap, "KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    from amos_slam_tpu_torch.config import ORBConfig, SystemConfig
    from amos_slam_tpu_torch.io.kitti import kitti_camera_config
    from amos_slam_tpu_torch.system import System
    from PIL import Image

    cfg = SystemConfig(
        camera=kitti_camera_config(args.sequence),
        orb=ORBConfig(n_features=2000),   # reference mono_kitti: 2000
        sensor="mono",
        use_dynamics=False,
    )
    left_dir = os.path.join(args.seq_dir, "image_0")
    names = sorted(os.listdir(left_dir))
    with open(os.path.join(args.seq_dir, "times.txt")) as f:
        stamps = [float(line) for line in f if line.strip()]
    slam = System(cfg, device=args.device)
    timer = Timer()
    n = n_frames(min(len(names), len(stamps)), args.max_frames)
    for i in range(n):
        gray = np.asarray(Image.open(os.path.join(left_dir, names[i])).convert("L"), np.float32)
        timer.track(slam.track_monocular, gray, stamps[i])
        timer.progress(i, n, slam, 100)
    slam.shutdown()
    slam.save_keyframe_trajectory_tum(args.out)
    print(timer.summary())
    print(f"keyframe trajectory -> {args.out}")


if __name__ == "__main__":
    main()
