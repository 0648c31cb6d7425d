"""EuRoC stereo main (reference Examples/Stereo/stereo_euroc.cc) on the port.

EuRoC stereo needs rectification (the reference builds it with
cv::initUndistortRectifyMap from its yaml). This main takes
pre-rectified image directories (mav0/cam0/data layout) and tracks with
the rectified intrinsics of the reference's Examples/Stereo/EuRoC.yaml;
for raw EuRoC use mono_euroc, whose analytic undistortion handles the
radtan model.

    python3 -m amos_slam_tpu_torch.examples.stereo_euroc MAV_ROOT --right MAV_ROOT2
        [--bf 47.906] [--out CameraTrajectory.txt] [--max-frames N] [--device cpu]
"""

import argparse

from ._common import Timer, add_common, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="rectified cam0 root (mav0/cam0/data layout)")
    ap.add_argument("--right", required=True, help="rectified cam1 root")
    ap.add_argument("--bf", type=float, default=47.90639384423901)
    add_common(ap, "CameraTrajectory.txt")
    args = ap.parse_args(argv)

    from amos_slam_tpu_torch.config import CameraConfig, SystemConfig
    from amos_slam_tpu_torch.io.euroc import EurocMonoDataset
    from amos_slam_tpu_torch.system import System

    cam = CameraConfig(
        fx=435.2046959714599, fy=435.2046959714599,
        cx=367.4517211914062, cy=252.2008514404297,
        width=752, height=480, fps=20.0, bf=args.bf, th_depth=35.0,
    )
    left = EurocMonoDataset(args.root)
    right = EurocMonoDataset(args.right, cam="cam1")
    slam = System(SystemConfig(camera=cam, sensor="stereo", use_dynamics=False),
                  device=args.device)
    timer = Timer()
    n = n_frames(len(left), args.max_frames)
    for i in range(n):
        gl, t = left[i]
        gr, _ = right[i]
        timer.track(slam.track_stereo, gl, gr, t)
        timer.progress(i, n, slam, 100)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    print(timer.summary())


if __name__ == "__main__":
    main()
