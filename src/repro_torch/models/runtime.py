"""Runtime options threaded through every model call.

The JAX package's sharding and MoE-buffer fields do nothing on one device
and are left out, and so are its cache and score options
(`ring_cache`, `opt_cache_dus`, `opt_bf16_scores`): the port behaves as
`repro` does at their defaults, and none of its entry points sets another
value. `device` defaults to "cuda": an entry point runs on the card unless
the caller asks for the CPU, and raises if there is no card.

`remat` ("none" | "block") and `grad_acc_dtype` are `repro`'s training
options: "block" recomputes each decoder layer and each SSM layer in the
backward (`remat_block`; the hybrid's shared attention block is not
recomputed, as in `repro`), and microbatched gradients are summed in
`grad_acc_dtype` (`train/train_step.py`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Runtime:
    device: str = "cuda"
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    ssd_chunk: int = 128
    remat: str = "block"            # none | block  (recompute each layer in the backward)
    grad_acc_dtype: torch.dtype = torch.float32

    def torch_device(self) -> torch.device:
        """The device to run on; raises when it is a CUDA device and no card
        is present (the port never falls back to the CPU by itself)."""
        return resolve_device(self.device)


def remat_block(rt: Runtime, block, x: torch.Tensor, *args, probe: torch.Tensor):
    """block(x, *args); with `rt.remat == "block"`, while autograd records a
    graph (grad mode on and x or the block's parameter `probe` needs a
    gradient), under `torch.utils.checkpoint` (non-reentrant): the block's
    activations are dropped and the whole block is recomputed in the
    backward."""
    if rt.remat == "block" and torch.is_grad_enabled() and (
            x.requires_grad or probe.requires_grad):
        return checkpoint(block, x, *args, use_reentrant=False)
    return block(x, *args)


CPU_TEST = Runtime(device="cpu", compute_dtype=torch.float32, remat="none")
