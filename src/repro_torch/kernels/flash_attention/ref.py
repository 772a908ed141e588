"""Plain PyTorch versions of fused attention (GQA + causal + sliding window).

Layout: BSHD — q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd).
Masking is position-based, so the same function covers full-sequence
attention (positions = iota), prefill and decode against a cache (any q/kv
position vectors; a kv slot with a negative position is empty). The
arithmetic is `repro.kernels.flash_attention.ref`'s: q scaled in fp32, fp32
scores, masked entries filled with -1e30, the row sum clamped at 1e-30 so an
empty row gives 0, the output cast to q's dtype.

`attention_bwd_ref` is the plain version of the CUDA backward: the tests and
chip_smoke.py hold the kernel against it (autograd differentiates
`attention_ref` by itself, which is what a CPU tensor takes).
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


def _work_dtype(q: torch.Tensor) -> torch.dtype:
    # fp32 arithmetic for fp32 and bf16, as repro; float64 stays float64 (tests)
    return torch.float64 if q.dtype == torch.float64 else torch.float32


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
    return_lse: bool = False,
):
    """Reference attention. Returns (B, Sq, Hq, hd) in q's dtype and, with
    `return_lse`, each row's log-sum-exp of the masked scaled scores,
    (B, Hq, Sq) fp32 (the kernel's second output)."""
    Hq, hd = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    rep = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    wt = _work_dtype(q)

    qf = q.to(wt) * scale
    kf, vf = k.to(wt), v.to(wt)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)

    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = make_mask(q_pos, kv_pos, causal=causal, window=window, prefix_len=prefix_len)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    probs = torch.nan_to_num(torch.exp(scores - m))
    denom = probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs / denom, vf).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom))[..., 0].to(wt)
    return out


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
):
    """(dq, dk, dv) of aligned self-attention (query i and key j at positions
    i and j, as the kernel), written out from the formulas the CUDA backward
    computes: P = exp(scale Q K^T - lse) with masked entries 0, dV = P^T dO,
    dP = dO V^T, delta = rowsum(dO * O), dS = P * (dP - delta),
    dQ = scale dS K, dK = scale dS^T Q; GQA sums dK and dV over the query
    heads of each KV head. o and lse are the forward's outputs ((B, Sq, Hq,
    hd), (B, Hq, Sq)). fp32 arithmetic (float64 for float64 inputs); the
    gradients in their inputs' dtypes."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    wt = _work_dtype(q)
    qf, kf, vf, of, dof = (t.to(wt) for t in (q, k, v, o, do))
    kr = kf.repeat_interleave(rep, dim=2)
    vr = vf.repeat_interleave(rep, dim=2)
    pos_q = torch.arange(Sq, device=q.device)[None].expand(B, Sq)
    pos_k = torch.arange(Skv, device=q.device)[None].expand(B, Skv)
    mask = make_mask(pos_q, pos_k, causal=causal, window=window)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    p = torch.where(mask, torch.exp(s - lse.to(wt)[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    delta = (dof * of).sum(-1).transpose(1, 2)                  # (B, Hq, Sq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.view(B, Skv, Hkv, rep, hd).sum(3)
    dv = dv.view(B, Skv, Hkv, rep, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
