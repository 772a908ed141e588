"""Plain PyTorch versions of fused attention (GQA + causal + sliding window).

Layout: BSHD — q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd).
Masking is position-based, so the same function covers full-sequence
attention (positions = iota), prefill and decode against a cache (any q/kv
position vectors; a kv slot with a negative position is empty). The
arithmetic is `repro.kernels.flash_attention.ref`'s: q scaled in fp32, fp32
scores, masked entries filled with -1e30, the row sum clamped at 1e-30 so an
empty row gives 0, the output cast to q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def make_mask(
    q_pos: torch.Tensor,     # (B, Sq) int
    kv_pos: torch.Tensor,    # (B, Skv) int; negative = invalid slot
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,     # prefix-LM: bidirectional among the first P positions
) -> torch.Tensor:
    """Boolean (B, Sq, Skv) mask: True = may attend."""
    q = q_pos[:, :, None]
    kv = kv_pos[:, None, :]
    mask = kv >= 0
    if causal:
        cm = kv <= q
        if prefix_len > 0:
            cm = cm | ((kv < prefix_len) & (q < prefix_len))
        mask = mask & cm
    if window is not None:
        mask = mask & ((kv > q - window) | (kv < prefix_len))
    return mask


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention. Returns (B, Sq, Hq, hd) in q's dtype."""
    Hq, hd = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    rep = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5

    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)

    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = make_mask(q_pos, kv_pos, causal=causal, window=window, prefix_len=prefix_len)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.nan_to_num(torch.exp(scores - scores.amax(-1, keepdim=True)))
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
