"""Public attention entry point. A CUDA tensor always goes to the
hand-written flash-attention kernel (which launches or raises); a CPU tensor
goes to the plain masked version. There is no switch and no fallback between
the two."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


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
    return flash_attention(q, k, v, causal=causal, window=window,
                           softmax_scale=softmax_scale)
