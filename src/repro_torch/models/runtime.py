"""Runtime options threaded through every model call.

The JAX package's sharding and MoE-buffer fields do nothing on one device
and are left out, and so are its cache and score options
(`ring_cache`, `opt_cache_dus`, `opt_bf16_scores`): the port behaves as
`repro` does at their defaults, and none of its entry points sets another
value. `device` defaults to "cuda": an entry point runs on the card unless
the caller asks for the CPU, and raises if there is no card.

`remat` ("none" | "block") and `grad_acc_dtype` are `repro`'s training
options: "block" checkpoints each decoder, SSM, encoder and encdec decoder
layer under `repro`'s policy (`remat_block`: the weight GEMMs' outputs are
kept, everything else is recomputed in the backward; the hybrid's shared
attention block is not checkpointed, as in `repro`), and microbatched
gradients are summed in `grad_acc_dtype` (`train/train_step.py`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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


# the weight GEMMs: `h @ w` of an activation and a 2-D weight dispatches to
# aten.mm (a 3-D h is folded to 2-D first), a biased one to aten.addmm
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_gemms(ctx, op, *args, **kwargs):
    """`repro`'s `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
    on the port's ops: a product without a batch dimension is kept, any
    other op (batched products such as `bmm` and the MoE experts' einsums,
    elementwise ops, K1 and K2) is recomputed in the backward."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(rt: Runtime, block, x: torch.Tensor, *args, probe: torch.Tensor):
    """block(x, *args); with `rt.remat == "block"`, while autograd records a
    graph (grad mode on and x or the block's parameter `probe` needs a
    gradient), under non-reentrant `torch.utils.checkpoint` with `repro`'s
    policy (`_save_weight_gemms`): the outputs of the block's weight GEMMs
    are kept, its other activations are dropped and recomputed in the
    backward. The values are those of remat "none", bit for bit."""
    if rt.remat == "block" and torch.is_grad_enabled() and (
            x.requires_grad or probe.requires_grad):
        return checkpoint(block, x, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_weight_gemms))
    return block(x, *args)


CPU_TEST = Runtime(device="cpu", compute_dtype=torch.float32, remat="none")
