"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA without one raises: the
    port never falls back to the CPU on its own; callers (the tests) ask
    for ``"cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "amos_slam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    return dev
