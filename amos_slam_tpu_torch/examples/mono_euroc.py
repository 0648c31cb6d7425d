"""EuRoC monocular main (reference Examples/Monocular/mono_euroc.cc) on
the port: raw cam0 images, undistorted analytically by the front end.

    python3 -m amos_slam_tpu_torch.examples.mono_euroc MAV_ROOT
        [--out CameraTrajectory.txt] [--max-frames N] [--device cpu]
"""

import argparse

from ._common import Timer, add_common, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    add_common(ap, "CameraTrajectory.txt")
    args = ap.parse_args(argv)

    from amos_slam_tpu_torch.config import ORBConfig, SystemConfig
    from amos_slam_tpu_torch.io.euroc import EurocMonoDataset, euroc_camera_config
    from amos_slam_tpu_torch.system import System

    cfg = SystemConfig(
        camera=euroc_camera_config(),
        orb=ORBConfig(n_features=1000),
        sensor="mono",
        use_dynamics=False,
    )
    ds = EurocMonoDataset(args.root)
    slam = System(cfg, device=args.device)
    timer = Timer()
    n = n_frames(len(ds), args.max_frames)
    for i in range(n):
        gray, ts = ds[i]
        timer.track(slam.track_monocular, gray, ts)
        timer.progress(i, n, slam, 100)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    print(timer.summary())


if __name__ == "__main__":
    main()
