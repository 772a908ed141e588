"""The one rule for where the port runs: on the card unless the caller asks
for the CPU. A CUDA device without a card raises; nothing falls back to the
CPU by itself."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """`device` ("cuda", "cuda:1", "cpu" or a torch.device) as a
    torch.device; raises when it names CUDA and torch finds no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch finds no CUDA device; pass "
            "device='cpu' to run on the CPU")
    return dev


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array -> `dtype` tensor on `device`, without a blocking copy (a
    blocking host-to-device copy waits for the card)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    a = np.ascontiguousarray(np.asarray(a, np_dtype))
    return torch.from_numpy(a).to(device, non_blocking=True)
