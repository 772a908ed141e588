"""Attention glue: projections, RoPE, kernel dispatch and KV caches (port of
`repro.models.attention`, single-device paths).

Caches are position-explicit: every cache keeps a `kv_pos` int32 tensor
beside k/v (-1 marks an empty slot), so all cached attention goes through one
masked path (`kernels/flash_attention/ref.make_mask`). Full-sequence self
attention goes through `fa_ops.mha`, i.e. the CUDA flash-attention kernel on
the card.

Unlike `repro`, whose arrays are immutable, the cache functions here write
into the cache they are given and return it: the caller owns one cache per
batch and nothing keeps the old contents.

A windowed decode step against a long cache (scalar position, `W >= 4 *
window`) attends over the `window` slots that can hold the last `window`
positions instead of the whole cache; `cached_attention.window_slices`
counts those steps (one per layer and step).

The VLM family's prefix-LM mask (bidirectional among the first
`prefix_len` positions, causal after them) has no kernel, in `repro` as here:
full-sequence attention with `prefix_len > 0` takes the masked plain path.

Under a mesh (`rt.mesh`, DTensor activations) q, k and v take `repro`'s
constraint (`_constrain_attn`: heads over "model" when they divide it,
else a sequence-parallel q, batch over the data axes), redistributed
before the (B, S, H*hd) -> (B, S, H, hd) view so that no shard cuts a head;
K1 then runs on each rank's local shard (`fa_ops.mha`). A one-token decode
against a sequence-sharded cache (W >= 65536, a batch the data axes cannot
take) runs `_long_decode_attention`, whose scores stay sharded on the
cache's sequence.

Not ported (ROADMAP.md): the runtime options that pick another cache
layout or score arithmetic (ring caches, `_attention_bf16_scores`,
`opt_cache_dus=False`): the port runs `repro`'s defaults, and nothing in it
asks for the others.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import PartitionSpec as P, batch_entry, data_axes
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import dense_init_, rope
from repro_torch.models.runtime import Runtime, constrain, keep_layout, weight

Pos = Union[int, torch.Tensor]

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Projection weights wq, wk, wv (D, H*hd), wo (Hq*hd, D), plus the
    biases bq, bk, bv when `cfg.qkv_bias`. Also the cross-attention block."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        D, hd, nq, nkv = cfg.d_model, cfg.hd(), cfg.n_heads, cfg.n_kv
        kw = {"device": device, "dtype": dtype}
        self.wq = nn.Parameter(torch.empty(D, nq * hd, **kw))
        self.wk = nn.Parameter(torch.empty(D, nkv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(D, nkv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(nq * hd, D, **kw))
        biases = cfg.qkv_bias
        self.bq = nn.Parameter(torch.zeros(nq * hd, **kw)) if biases else None
        self.bk = nn.Parameter(torch.zeros(nkv * hd, **kw)) if biases else None
        self.bv = nn.Parameter(torch.zeros(nkv * hd, **kw)) if biases else None

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, g)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()


def _linear(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            rt: Runtime) -> torch.Tensor:
    # the bias is added in the compute dtype, after the product, as in repro
    out = h @ weight(w, rt)
    return out if b is None else out + weight(b, rt)


def attn_spec(shape, rt: Runtime, is_query: bool) -> Optional[P]:
    """`repro`'s `_constrain_attn` rule for (B, S, H, hd) attention
    activations: heads over "model" when H divides it, else a
    sequence-parallel q (S divisible by "model"), batch over the data axes
    when B divides them; k/v that cannot head-shard stay batch-only. None
    without `mesh_axes`."""
    if rt.mesh_axes is None:
        return None
    B, S, H, _ = shape
    batch = batch_entry(rt.mesh_axes, B)
    model = rt.mesh_axes.get("model", 1)
    if model > 1 and H % model == 0:
        return P(batch, None, "model", None)
    if is_query and model > 1 and S % model == 0 and S >= model:
        return P(batch, "model", None, None)
    return P(batch, None, None, None)


def _constrain_attn(x: torch.Tensor, rt: Runtime, is_query: bool,
                    heads: Optional[int] = None) -> torch.Tensor:
    """x (B, S, H, hd), or its flat (B, S, H*hd) projection with `heads`
    given, under `attn_spec`. The flat projection is redistributed first
    and viewed after, so each rank's shard holds whole heads."""
    if heads is None:
        return constrain(x, rt, attn_spec(x.shape, rt, is_query))
    B, S, F = x.shape
    spec = attn_spec((B, S, heads, F // heads), rt, is_query)
    if spec is not None:
        x = constrain(x, rt, P(*spec[:3]))
    return x.view(B, S, heads, F // heads)


def _proj_qkv(h: torch.Tensor, p: Attention, cfg: ModelConfig, rt: Runtime):
    q = _constrain_attn(_linear(h, p.wq, p.bq, rt), rt, True, cfg.n_heads)
    k = _constrain_attn(_linear(h, p.wk, p.bk, rt), rt, False, cfg.n_kv)
    v = _constrain_attn(_linear(h, p.wv, p.bv, rt), rt, False, cfg.n_kv)
    return q, k, v


# ---------------------------------------------------------------------------
# full-sequence self attention (forward / prefill)
# ---------------------------------------------------------------------------


def self_attention(h: torch.Tensor, p: Attention, cfg: ModelConfig, rt: Runtime,
                   positions: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None, prefix_len: int = 0) -> torch.Tensor:
    """h (B, S, D), positions (B, S) -> (B, S, D). The attention itself is
    `fa_ops.mha`, the flash-attention kernel on the card, unless a prefix-LM
    mask (`prefix_len > 0`) sends it to the masked plain path."""
    q, k, v = _proj_qkv(h, p, cfg, rt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if prefix_len > 0:      # repro's _prefix_lm_attention: causal, no window
        out = attention_ref(q, k, v, positions, positions, prefix_len=prefix_len)
    else:
        out = fa_ops.mha(q, k, v, positions, positions, causal=causal, window=window)
    B, S = h.shape[:2]
    out = keep_layout(out.reshape(B, S, cfg.n_heads * cfg.hd()))
    return out @ weight(p.wo, rt)


# q-chunking of long masked attention: bounds the (Sq, Skv) scores per chunk
_CHUNK_Q = 512
_CHUNK_THRESHOLD = 8192


def _attend(q, k, v, q_pos, kv_pos, *, causal: bool, window: Optional[int],
            prefix_len: int = 0):
    """Masked attention (the plain version), chunked over q when long."""
    kw = {"causal": causal, "window": window, "prefix_len": prefix_len}
    Sq = q.shape[1]
    if Sq < _CHUNK_THRESHOLD or Sq % _CHUNK_Q != 0:
        return attention_ref(q, k, v, q_pos, kv_pos, **kw)
    return torch.cat([attention_ref(q[:, i:i + _CHUNK_Q], k, v, q_pos[:, i:i + _CHUNK_Q],
                                    kv_pos, **kw)
                      for i in range(0, Sq, _CHUNK_Q)], dim=1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  rt: Runtime) -> Dict[str, torch.Tensor]:
    """Cache for `n_layers` attention layers: k, v (L, B, max_len, Hkv, hd)
    in the compute dtype and kv_pos (L, B, max_len) int32, all slots -1."""
    dev = rt.torch_device()
    shape = (n_layers, batch, max_len, cfg.n_kv, cfg.hd())
    return {
        "k": torch.zeros(shape, dtype=rt.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=rt.compute_dtype, device=dev),
        "kv_pos": torch.full((n_layers, batch, max_len), -1, dtype=torch.int32, device=dev),
    }


def _is_scalar(pos: Pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def _pos_vector(pos: Pos, B: int, device) -> torch.Tensor:
    """Scalar-or-(B,) position -> (B,) int32 (per-slot positions)."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return p.expand(B) if p.dim() == 0 else p


def update_cache_layer(cache_l: Dict[str, torch.Tensor], k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: Pos, use_dus: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """Write S_new tokens starting at absolute position `pos` (scalar or
    per-batch (B,)) into a layer cache (B, W, Hkv, hd), in place; slot =
    position % W. A scalar `pos` whose span does not wrap takes repro's
    dynamic-update-slice branch (a slice assignment whose start is clamped to
    W - S_new, as XLA clamps it); otherwise, or with use_dus=False, its
    scatter branch."""
    B, W = cache_l["k"].shape[:2]
    S_new = k_new.shape[1]
    dev = k_new.device
    if use_dus and _is_scalar(pos) and (S_new == 1 or W % S_new == 0):
        p = int(pos)
        start = min(p % W, W - S_new)
        cache_l["k"][:, start:start + S_new] = k_new
        cache_l["v"][:, start:start + S_new] = v_new
        cache_l["kv_pos"][:, start:start + S_new] = (
            p + torch.arange(S_new, dtype=torch.int32, device=dev))
        return cache_l
    positions = (_pos_vector(pos, B, dev)[:, None]
                 + torch.arange(S_new, dtype=torch.int32, device=dev)[None, :])
    slots = (positions % W).long()
    bidx = torch.arange(B, device=dev)[:, None]
    cache_l["k"][bidx, slots] = k_new
    cache_l["v"][bidx, slots] = v_new
    cache_l["kv_pos"][bidx, slots] = positions
    return cache_l


def cached_attention(x: torch.Tensor, p: Attention, cfg: ModelConfig, rt: Runtime,
                     cache_l: Dict[str, torch.Tensor], pos: Pos, *,
                     window: Optional[int] = None, prefix_len: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode / chunked-prefill attention against a layer cache (written in
    place). x (B, S_new, D); `pos` is the absolute position of x[:, 0], a
    scalar or a per-slot (B,) vector."""
    B, S_new, _ = x.shape
    q, k, v = _proj_qkv(x, p, cfg, rt)
    positions = (_pos_vector(pos, B, x.device)[:, None]
                 + torch.arange(S_new, dtype=torch.int32, device=x.device)[None, :])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    cache_l = update_cache_layer(cache_l, k, v, pos)
    k_c, v_c, pos_c = cache_l["k"], cache_l["v"], cache_l["kv_pos"]
    W = k_c.shape[1]
    # under a mesh a one-token decode against a long cache whose batch the
    # data axes cannot take (so the cache is sequence-sharded) keeps its
    # scores sharded on the sequence (repro attention.py:290-301)
    long_decode = S_new == 1 and rt.mesh_axes is not None and W >= 65536
    if long_decode and batch_entry(rt.mesh_axes, B) is None:
        out = _long_decode_attention(q, k_c, v_c, positions, pos_c, rt, window=window)
    elif _is_scalar(pos) and S_new == 1 and window is not None and W >= 4 * window:
        # windowed decode against a long cache: read the `window` slots from
        # `start` instead of masking the whole cache (repro attention.py:303)
        start = min(max(int(pos) - window + 1, 0), W - window)
        k_c, v_c, pos_c = (t[:, start:start + window] for t in (k_c, v_c, pos_c))
        cached_attention.window_slices += 1
        out = _attend(q, k_c, v_c, positions, pos_c, causal=True, window=window,
                      prefix_len=prefix_len)
    elif long_decode:
        out = _long_decode_attention(q, k_c, v_c, positions, pos_c, rt, window=window)
    else:
        out = _attend(q, k_c, v_c, positions, pos_c, causal=True, window=window,
                      prefix_len=prefix_len)
    out = out.reshape(B, S_new, cfg.n_heads * cfg.hd())
    return out @ weight(p.wo, rt), cache_l


cached_attention.window_slices = 0


def _long_decode_attention(q, k, v, q_pos, kv_pos, rt: Runtime,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a sequence-sharded cache without ever
    gathering K/V (`repro`'s flash-decoding on SPMD): grouped-head einsums
    with no GQA repeat, K/V laid out with their KV heads over "model" when
    those divide it and the sequence over the data axes, else the sequence
    over every axis, and the scores constrained to stay sharded on the
    sequence; the softmax's max and sums over the sharded dim are
    reductions across the ranks. q (B, 1, Hq, hd), k/v (B, W, Hkv, hd),
    q_pos (B, 1), kv_pos (B, W). The products are fp32 on the operands'
    values (`repro` accumulates its storage-dtype operands in fp32)."""
    B, _, Hq, hd = q.shape
    _, W, Hkv, _ = k.shape
    rep = Hq // Hkv
    axes = rt.mesh_axes
    dp, dp_size = data_axes(axes)
    model = axes.get("model", 1)

    def size(names):
        n = 1
        for a in names:
            n *= axes[a]
        return n
    if model > 1 and Hkv % model == 0 and W % max(dp_size, 1) == 0:
        kspec = P(None, dp if dp_size > 1 else None, "model", None)
        head_axes, seq_axes = "model", dp
    else:
        seq_axes, head_axes = dp + ("model",), None
        kspec = P(None, seq_axes if W % size(seq_axes) == 0 else None, None, None)
    qf = (q.float() * hd ** -0.5).to(q.dtype).reshape(B, Hkv, rep, hd)
    kf, vf = constrain(k, rt, kspec), constrain(v, rt, kspec)
    scores = torch.einsum("bgrd,bsgd->bgrs", qf.float(), kf.float())   # (B, Hkv, rep, W)
    seq_ok = bool(seq_axes) and W % size(seq_axes) == 0
    scores = constrain(scores, rt, P(None, head_axes, None, seq_axes if seq_ok else None))
    kvp = kv_pos[:, None, None, :]
    qp = q_pos[:, 0][:, None, None, None]
    mask = (kvp >= 0) & (kvp <= qp)
    if window is not None:
        mask = mask & (kvp > qp - window)
    scores = torch.where(mask, scores, -1e30)
    m = scores.amax(-1, keepdim=True)
    p_ = torch.where(mask, torch.exp(scores - m), 0.0)
    denom = p_.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrs,bsgd->bgrd", (p_ / denom).to(v.dtype).float(), vf.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_attention(x: torch.Tensor, p: Attention, cfg: ModelConfig, rt: Runtime,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x (B, Sq, D) decoder hidden against precomputed encoder K/V (B, Senc,
    Hkv, hd): non-causal, no RoPE, through the masked plain version."""
    B, Sq, _ = x.shape
    hd = cfg.hd()
    q = _linear(x, p.wq, p.bq, rt).view(B, Sq, cfg.n_heads, hd)
    Senc = enc_k.shape[1]
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    kvpos = torch.arange(Senc, dtype=torch.int32, device=x.device)[None].expand(B, Senc)
    out = _attend(q, enc_k, enc_v, qpos, kvpos, causal=False, window=None)
    return out.reshape(B, Sq, cfg.n_heads * hd) @ weight(p.wo, rt)


def encode_cross_kv(enc_out: torch.Tensor, p: Attention, cfg: ModelConfig,
                    rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output once into cross-attention K/V."""
    B, Senc, _ = enc_out.shape
    hd = cfg.hd()
    k = _linear(enc_out, p.wk, p.bk, rt).view(B, Senc, cfg.n_kv, hd)
    v = _linear(enc_out, p.wv, p.bv, rt).view(B, Senc, cfg.n_kv, hd)
    return k, v
