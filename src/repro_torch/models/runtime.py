"""Runtime options threaded through every model call.

The JAX package's sharding, remat and MoE-buffer fields do nothing on one
device and are left out, and so are its cache and score options
(`ring_cache`, `opt_cache_dus`, `opt_bf16_scores`): the port behaves as
`repro` does at their defaults, and none of its entry points sets another
value. `device` defaults to "cuda": an entry point runs on the card unless
the caller asks for the CPU, and raises if there is no card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Runtime:
    device: str = "cuda"
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    ssd_chunk: int = 128

    def torch_device(self) -> torch.device:
        """The device to run on; raises when it is a CUDA device and no card
        is present (the port never falls back to the CPU by itself)."""
        return resolve_device(self.device)


CPU_TEST = Runtime(device="cpu", compute_dtype=torch.float32)
