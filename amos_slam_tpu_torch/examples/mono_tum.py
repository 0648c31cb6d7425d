"""TUM monocular main (reference Examples/Monocular/mono_tum.cc) on the port.

    python3 -m amos_slam_tpu_torch.examples.mono_tum SEQUENCE_DIR [--yaml TUM1.yaml]
        [--out KeyFrameTrajectory.txt] [--max-frames N] [--device cpu]

Reads rgb.txt (a timestamp and a path per line), tracks monocular, and
writes the keyframe trajectory in TUM format, as the reference's main does
(mono_tum.cc:141 SaveKeyFrameTrajectoryTUM: a monocular run's scale is
arbitrary, so the keyframes are the meaningful export).
"""

import argparse
import dataclasses
import os

import numpy as np

from ._common import Timer, add_common, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--yaml", default=None, help="reference-style settings yaml")
    add_common(ap, "KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    from amos_slam_tpu_torch.config import SystemConfig, load_yaml
    from amos_slam_tpu_torch.io.tum import read_list
    from amos_slam_tpu_torch.system import System
    from PIL import Image

    cfg = load_yaml(args.yaml) if args.yaml else SystemConfig()
    cfg = dataclasses.replace(cfg, sensor="mono", use_dynamics=False)
    items = read_list(os.path.join(args.sequence, "rgb.txt"))
    slam = System(cfg, device=args.device)
    timer = Timer()
    n = n_frames(len(items), args.max_frames)
    for i in range(n):
        ts, path = items[i]
        gray = np.asarray(Image.open(os.path.join(args.sequence, path)).convert("L"), np.float32)
        timer.track(slam.track_monocular, gray, ts)
        timer.progress(i, n, slam, 100)
    slam.shutdown()
    slam.save_keyframe_trajectory_tum(args.out)
    print(timer.summary())
    print(f"keyframe trajectory -> {args.out}")


if __name__ == "__main__":
    main()
