"""Time chip_smoke.py's phase 11 (MultiStreamSLAM, 8 streams at 640x480,
then the same step at S = 1) in two checkouts of the repository, in
turns A, B, B, A, on one rendered sequence, on one card.

    python3 -m amos_slam_tpu_torch.tools.ab_multistream A_DIR B_DIR

Each checkout's root holds its own ``chip_smoke.py`` and package. The
sequence (``chip_smoke.ms_frames()`` of B) is rendered once into
``B_DIR/build/ab_multistream/``; each run is a fresh process in its
checkout's root that builds that checkout's FAST kernel and runs its own
``chip_smoke.multistream_phase`` on the sequence, gates included. Prints
each run's phase-11 JSON line as it comes, then one JSON line: per run the
checkout, per-step ms median at S = 8 and at S = 1, aggregate FPS,
launches and device ms per step, and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RENDER = """
import sys, numpy as np, chip_smoke as cs
poses, gray, depth = cs.ms_frames()
np.save(sys.argv[1] + "/poses.npy", np.asarray(poses))
np.save(sys.argv[1] + "/gray.npy", gray)
np.save(sys.argv[1] + "/depth.npy", depth)
"""

RUN = """
import sys, numpy as np, chip_smoke as cs
from amos_slam_tpu_torch.ops.kernels import build, fast_margin_nms as F
build.build([F.NAME])
seq = tuple(np.load(sys.argv[1] + f"/{k}.npy") for k in ("poses", "gray", "depth"))
cs.multistream_phase(F.fast_margin_nms, seq)
"""


def _python(code: str, root: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=root, env=env,
                         stdout=subprocess.PIPE, text=True, check=True).stdout
    return out


def main(argv=None) -> int:
    a, b = (argv if argv is not None else sys.argv[1:])[:2]
    seq_dir = os.path.abspath(os.path.join(b, "build", "ab_multistream"))
    os.makedirs(seq_dir, exist_ok=True)
    _python(RENDER, b, seq_dir)
    rows = []
    for root in (a, b, b, a):
        out = _python(RUN, root, seq_dir)
        line = next(ln for ln in out.splitlines() if ln.startswith('{"multistream_phase"'))
        print(line, flush=True)
        r = json.loads(line)
        rows.append({"checkout": root, "step_ms_median_s8": r["step_ms_median"],
                     "step_ms_median_s1": r["solo_s1"]["step_ms_median"],
                     "aggregate_fps": r["aggregate_fps"],
                     "launches_per_step_s8": r["launches_per_step"],
                     "device_ms_per_step_s8": r["device_ms_per_step"],
                     "launches_per_step_s1": r["solo_s1"]["launches_per_step"],
                     "card": r["card"]})
    print(json.dumps({"ab_multistream": "chip_smoke phase 11 in turns A, B, B, A",
                      "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
