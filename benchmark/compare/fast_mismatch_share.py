"""fast_mismatch_share: the FAST op's responses of the sampled frames
against the float32 reference (``reference/fast.py``). Control: the
reference in bfloat16, the precision below, on every stream's sampled
frames."""

import torch

from benchmark import check


def value(out) -> float:
    return check.fast_share(out.fast, out.gray_of, out.sizes)


def control(out, frames: int) -> float:
    fast = [([(s, k) for s in range(out.streams)], None) for k in sorted(out.fast_steps)]
    return check.fast_share(fast, out.gray_of, out.sizes, torch.bfloat16)
