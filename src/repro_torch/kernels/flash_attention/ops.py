"""Public attention entry point. A CUDA tensor always goes to the
hand-written flash-attention kernels (which launch or raise): the forward
kernel, and the backward kernels when autograd asks for gradients
(`FlashAttentionFn`). A CPU tensor goes to the plain masked version, which
autograd differentiates by itself. There is no switch and no fallback
between the two.

Under a device mesh (DTensor q, k, v) the kernel runs on each rank's local
shard through `local_map`, since DTensor has no sharding rule for a custom
autograd function. The kernel takes whole sequences at aligned positions
and maps a local query head to local KV head h // (Hq // Hkv), so q, k and
v are first redistributed to the one layout it admits (`kernel_spec`):
heads over "model" when both Hq and Hkv divide it (each rank then holds
its query heads' KV groups), else replicated over "model"; batch over the
data axes when it divides them. A sequence-parallel q is gathered here,
as GSPMD gathers around an opaque custom call. The gradients come back
with the same placements."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist.sharding import PartitionSpec, batch_entry, mesh_axes, to_placements
from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """K1 under autograd: the forward kernel (with the row log-sum-exp when
    an input needs a gradient), and `flash_attention_bwd` as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale):
        ctx.opts = {"causal": causal, "window": window, "softmax_scale": softmax_scale}
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, **ctx.opts)
        o, lse = flash_attention(q, k, v, return_lse=True, **ctx.opts)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def kernel_spec(mesh, q_shape, n_kv: int):
    """The PartitionSpec of (B, S, H, hd) q, k and v that K1 runs on under
    `mesh` (see the module docstring)."""
    axes = mesh_axes(mesh)
    model = axes.get("model", 1)
    B, _, Hq, _ = q_shape
    batch = batch_entry(axes, B)
    heads = "model" if model > 1 and Hq % model == 0 and n_kv % model == 0 else None
    return PartitionSpec(batch, None, heads, None)


def _mha_local(q, k, v, q_pos, kv_pos, causal, window, softmax_scale):
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                             softmax_scale=softmax_scale)
    return FlashAttentionFn.apply(q, k, v, causal, window, softmax_scale)


def _mha_mesh(q, k, v, q_pos, kv_pos, causal, window, softmax_scale):
    """mha on DTensors: each rank's kernel on its local shard."""
    mesh = q.device_mesh
    spec = kernel_spec(mesh, q.shape, k.shape[2])
    qkv = to_placements(mesh, spec)
    pos = to_placements(mesh, PartitionSpec(spec[0], None))
    q, k, v = (t.redistribute(mesh, qkv) for t in (q, k, v))
    q_pos, kv_pos = (p.redistribute(mesh, pos) if isinstance(p, DTensor)
                     else distribute_tensor(p, mesh, pos, src_data_rank=None)
                     for p in (q_pos, kv_pos))

    def local(q_, k_, v_, qp, kp):
        return _mha_local(q_, k_, v_, qp, kp, causal, window, softmax_scale)
    return local_map(local, out_placements=list(qkv), in_placements=(qkv, qkv, qkv, pos, pos),
                     device_mesh=mesh)(q, k, v, q_pos, kv_pos)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True,
        window: Optional[int] = None, softmax_scale: Optional[float] = None
        ) -> torch.Tensor:
    """(B, Sq, Hq, hd) attention in q's dtype.

    On the card the kernel ignores `q_pos` and `kv_pos`: it assumes aligned
    self-attention (query i and key j at positions i and j), exactly as
    `repro`'s Pallas path does. Callers with other positions (decode against
    a cache, cross-attention) use `ref.attention_ref` directly. DTensor
    inputs (a mesh) run it on each rank's shard (`_mha_mesh`)."""
    if isinstance(q, DTensor):
        return _mha_mesh(q, k, v, q_pos, kv_pos, causal, window, softmax_scale)
    return _mha_local(q, k, v, q_pos, kv_pos, causal, window, softmax_scale)
