"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks the outputs against
the plain references and prints one JSON line as the last line of
standard output (``--trace 1``: the per-layer metrics of a traced window
after the measured one). Each compared number and its limit go to
standard error as its last lines and into the result's ``checks``. Exits
with 2 and prints no result without a CUDA card (or fewer than the cell
asks for), and with 3 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["USE_FLAX"] = "0"
# one process with one intra-op thread: the program is bound by one host
# thread's dispatch, and idle pool threads spinning beside it only add noise
os.environ["OMP_NUM_THREADS"] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    log = []
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, log)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(harness.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
