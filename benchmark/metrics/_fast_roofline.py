"""Shared by the ``fast_roofline.*`` readers: the bytes bound of the FAST
op's launches in the traced window (``yardstick.bytes``, from each
launch's shape and the configuration's level extents) over the device
time the profiler gives the op's kernels, in %."""

from benchmark.reference.fast import level_sizes
from benchmark.yardstick.bytes import fast_launch_ms


def roofline(run, batched: bool):
    t = run.trace
    if t is None or not run.fast_launch_shapes:
        return None
    cam, orb = run.config["system"]["camera"], run.config["system"]["orb"]
    sizes = level_sizes(cam["width"], cam["height"], orb["scale_factor"], orb["n_levels"])
    L = len(sizes)
    if any((B > L) != batched for B, _, _ in run.fast_launch_shapes):
        return None
    bound_ms = sum(fast_launch_ms(B // L, sizes, H, W) for B, H, W in run.fast_launch_shapes)
    names = run.fast_kernel_names
    kernel_ns = sum(e - s for n, s, e in t.kernels if any(k in n for k in names))
    if kernel_ns <= 0:
        return None
    return 100.0 * bound_ms * 1e6 / kernel_ns
