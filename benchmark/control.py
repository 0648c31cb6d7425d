"""The controls of the output check, at a cell's own size, on the card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, on the frames a run of the cell samples, prints the
numbers the check compares as a control gives them (each number's
``control`` in ``compare/<number>.py``): ``net_rel_rms`` of the YOLACT
reference with fp8 convolutions (the precision below the configuration's
bf16), ``fast_mismatch_share`` of the FAST reference in bfloat16 (below
its float32), and ``ate_m`` of a tracker whose state never changes (every
pose the first; also what a stream left out of the batch reads) over
``--frames`` frames. The benchmark's own runs do not run it;
``tests/test_bench_check.py`` keeps it at a size a test run holds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, frames: int) -> dict:
    """Each number of the cell's check as its control gives it, on the
    inputs a run with ``seed`` makes (``compare/<number>.py``'s
    ``control``)."""
    from benchmark import harness

    drv = harness.driver(cell.traffic["driver"])(cell, seed, device)
    drv.make_inputs()
    out = drv.outputs()
    r = {"workload": cell.name, "seed": seed}
    for number in cell.limits:
        r[number] = harness.compare(number).control(out, frames)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, torch.device("cuda"), args.frames)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
