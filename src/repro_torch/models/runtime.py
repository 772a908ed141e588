"""Runtime options threaded through every model call.

`mesh` is the torch `DeviceMesh` a model is laid out on (None on one
device) and `mesh_axes` its {axis: size}, as in `repro`: with a mesh the
model's parameters are DTensors (`dist.sharding.distribute_model`), and
the activations take `repro`'s sharding constraints as DTensor
redistributions (`constrain`): attention heads or sequence
(`attention._constrain_attn`), SSD heads (`mamba2._constrain_heads`, with
`opt_ssm_head_tp`), the MoE dispatch buffer (`moe_buf_spec`). The cache and
score options of `repro`'s dry-run variants (`ring_cache`,
`opt_cache_dus`, `opt_bf16_scores`) are left out: the port behaves as
`repro` does at their defaults. `device` defaults to "cuda": an entry
point runs on the card unless the caller asks for the CPU, and raises if
there is no card.

`remat` ("none" | "block") and `grad_acc_dtype` are `repro`'s training
options: "block" checkpoints each decoder, SSM, encoder and encdec decoder
layer under `repro`'s policy (`remat_block`: the weight GEMMs' outputs are
kept, everything else is recomputed in the backward; the hybrid's shared
attention block is not checkpointed, as in `repro`), and microbatched
gradients are summed in `grad_acc_dtype` (`train/train_step.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import PartitionSpec, batch_entry, to_placements


@dataclasses.dataclass(frozen=True)
class Runtime:
    device: str = "cuda"
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    ssd_chunk: int = 128
    remat: str = "block"            # none | block  (recompute each layer in the backward)
    grad_acc_dtype: torch.dtype = torch.float32
    # the DeviceMesh the parameters are laid out on, and its {axis: size}
    # (the activation constraints read mesh_axes); None on one device
    mesh: Any = None
    mesh_axes: Optional[dict] = None
    # sharding constraint (PartitionSpec) of the MoE dispatch buffer (E, C, D)
    moe_buf_spec: Any = None
    # SSD heads over "model" (False: repro's flat-TP baseline, no constraint)
    opt_ssm_head_tp: bool = True

    def torch_device(self) -> torch.device:
        """The device to run on; raises when it is a CUDA device and no card
        is present (the port never falls back to the CPU by itself)."""
        return resolve_device(self.device)


def constrain(x: torch.Tensor, rt: Runtime, spec) -> torch.Tensor:
    """`jax.lax.with_sharding_constraint(x, spec)` on the port: x, a DTensor
    under `rt.mesh`, redistributed to the spec's placements (the same
    tensor when it has them already). Without a mesh, or with no spec, x."""
    if rt.mesh is None or spec is None:
        return x
    return x.redistribute(rt.mesh, to_placements(rt.mesh, spec))


def weight(w: torch.Tensor, rt: Runtime, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A parameter where it is used: `w.to(dtype)` (the compute dtype by
    default), and under a mesh with its shards over the data axes gathered
    (cast first, so the gather moves the compute dtype's bytes): `repro`'s
    rules shard weights' d_model dims over the data axes too (FSDP), and
    the product then runs on whole contractions, its "model" shard kept."""
    w = w.to(rt.compute_dtype if dtype is None else dtype)
    if rt.mesh is None:
        return w
    names = rt.mesh.mesh_dim_names
    return w.redistribute(rt.mesh, [Replicate() if names[i] in ("pod", "data") else pl
                                    for i, pl in enumerate(w.placements)])


def batch_axes(B: int, rt: Runtime):
    """The data axes that shard a batch of B under `rt.mesh_axes` (all of
    them when their product divides B), else None."""
    return batch_entry(rt.mesh_axes, B)


def residual(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The residual stream (B, S, D) between blocks under a mesh: batch over
    the data axes, whole over "model" (a row-parallel product's partial
    sums reduced here, once per block). x as it is without a mesh."""
    if rt.mesh is None:
        return x
    spec = PartitionSpec(batch_axes(x.shape[0], rt), *([None] * (x.dim() - 1)))
    return constrain(x, rt, spec)


def keep_layout(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as it is, with its gradient brought to the same placements
    in the backward (a redistribution to the placements it has): put after
    a flatten, whose backward unflattens the gradient and would fail on a
    shard that cuts the unflattened dims. A plain tensor as it is."""
    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


@contextlib.contextmanager
def mesh_ops(rt: Runtime):
    """Under a mesh, plain tensors that meet DTensors (positions, masks,
    RoPE tables, the MoE routing's constants) count as replicated: every
    rank computes the same ones. DTensor's flag is per thread and travels
    with autograd's backward; it is put back as it was on exit. Without a
    mesh, nothing."""
    if rt.mesh is None:
        yield
        return
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


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
