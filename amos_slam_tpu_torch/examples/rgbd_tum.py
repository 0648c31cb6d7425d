"""TUM RGB-D main (reference Examples/RGB-D/rgbd_tum.cc) on the port.

    python3 -m amos_slam_tpu_torch.examples.rgbd_tum SEQUENCE_DIR [--assoc FILE]
        [--yaml TUM3.yaml] [--out CameraTrajectory.txt] [--seg] [--weights yolact.pth]
        [--no-dynamics] [--max-frames N] [--device cpu]

Prints per-frame tracking stats and the median / mean frame time, and
writes the TUM-format trajectory. ``--seg`` runs YOLACT stage one on each
colour frame (random weights unless ``--weights`` names a .pth).
"""

import argparse
import dataclasses

from ._common import Timer, add_common, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--assoc", default=None)
    ap.add_argument("--yaml", default=None, help="reference-style settings yaml")
    ap.add_argument("--seg", action="store_true", help="run YOLACT stage one")
    ap.add_argument("--weights", default=None, help="yolact .pth for --seg")
    ap.add_argument("--no-dynamics", action="store_true")
    add_common(ap, "CameraTrajectory.txt")
    args = ap.parse_args(argv)

    from amos_slam_tpu_torch.config import SystemConfig, load_yaml
    from amos_slam_tpu_torch.io.tum import TumRGBDDataset
    from amos_slam_tpu_torch.system import System

    cfg = load_yaml(args.yaml) if args.yaml else SystemConfig()
    if args.no_dynamics:
        cfg = dataclasses.replace(cfg, use_dynamics=False)
    seg = None
    if args.seg:
        from amos_slam_tpu_torch.models.port_torch import load_pth
        from amos_slam_tpu_torch.models.segmenter import Segmenter

        params = load_pth(args.weights) if args.weights else None
        seg = Segmenter(params=params, device=args.device)

    ds = TumRGBDDataset(args.sequence, args.assoc, depth_factor=cfg.camera.depth_map_factor)
    slam = System(cfg, device=args.device)
    timer = Timer()
    n = n_frames(len(ds), args.max_frames)
    for i in range(n):
        gray, depth, rgb, ts = ds[i]
        mask = seg.person_mask(rgb) if seg is not None else None
        timer.track(slam.track_rgbd, gray, depth, ts, mask)
        timer.progress(i, n, slam, 50)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    print(timer.summary())
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
