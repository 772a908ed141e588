"""Public attention entry point. A CUDA tensor always goes to the
hand-written flash-attention kernels (which launch or raise): the forward
kernel, and the backward kernels when autograd asks for gradients
(`FlashAttentionFn`). A CPU tensor goes to the plain masked version, which
autograd differentiates by itself. There is no switch and no fallback
between the two."""
from __future__ import annotations

from typing import Optional

import torch

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


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True,
        window: Optional[int] = None, softmax_scale: Optional[float] = None
        ) -> torch.Tensor:
    """(B, Sq, Hq, hd) attention in q's dtype.

    On the card the kernel ignores `q_pos` and `kv_pos`: it assumes aligned
    self-attention (query i and key j at positions i and j), exactly as
    `repro`'s Pallas path does. Callers with other positions (decode against
    a cache, cross-attention) use `ref.attention_ref` directly."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                             softmax_scale=softmax_scale)
    return FlashAttentionFn.apply(q, k, v, causal, window, softmax_scale)
