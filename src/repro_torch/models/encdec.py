"""Whisper-style encoder-decoder backbone (port of `repro.models.encdec`; the
conv/mel frontend is a stub, the caller passes precomputed frame embeddings).

Encoder: a bidirectional self-attention stack over the frames, each layer
through the flash-attention kernel on the card. Decoder: causal self
attention + cross attention + MLP, either teacher-forced over a whole
sequence (`decode_stack`, causal flash attention) or against a cache
(`decode_stack_cached`, the masked plain version). With `rt.remat ==
"block"` each layer of `encode` and `decode_stack` runs under
`remat_block`, as `repro` checkpoints them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    Attention,
    cached_attention,
    cross_attention,
    encode_cross_kv,
    init_kv_cache,
    self_attention,
)
from repro_torch.models.layers import MLP, mlp, rmsnorm
from repro_torch.models.runtime import Runtime, remat_block


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.attn = Attention(cfg, **kw)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.mlp = MLP(cfg, cfg.d_ff, **kw)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.reset_parameters(g)
        self.mlp.reset_parameters(g)


class DecoderLayer(EncoderLayer):
    """An encoder layer plus cross attention (`lnx`, `xattn`)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__(cfg, device, dtype)
        kw = {"device": device, "dtype": dtype}
        self.lnx = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.xattn = Attention(cfg, **kw)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        super().reset_parameters(g)
        self.lnx.zero_()
        self.xattn.reset_parameters(g)


def iota_positions(B: int, S: int, device) -> torch.Tensor:
    """(B, S) int32 positions 0 .. S-1 of aligned self-attention."""
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _encoder_layer(x: torch.Tensor, p_l: EncoderLayer, cfg: ModelConfig, rt: Runtime,
                   positions: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p_l.ln1, cfg.norm_eps)
    x = x + self_attention(h, p_l.attn, cfg, rt, positions, causal=False)
    h = rmsnorm(x, p_l.ln2, cfg.norm_eps)
    return x + mlp(h, p_l.mlp, cfg, rt)


def _decoder_layer(x: torch.Tensor, p_l: DecoderLayer, cfg: ModelConfig, rt: Runtime,
                   positions: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p_l.ln1, cfg.norm_eps)
    x = x + self_attention(h, p_l.attn, cfg, rt, positions)
    h = rmsnorm(x, p_l.lnx, cfg.norm_eps)
    ek, ev = encode_cross_kv(enc_out, p_l.xattn, cfg, rt)
    x = x + cross_attention(h, p_l.xattn, cfg, rt, ek, ev)
    h = rmsnorm(x, p_l.ln2, cfg.norm_eps)
    return x + mlp(h, p_l.mlp, cfg, rt)


def encode(frames: torch.Tensor, enc_layers: nn.ModuleList, cfg: ModelConfig,
           rt: Runtime) -> torch.Tensor:
    """frames (B, Senc, D) precomputed embeddings -> encoder output; each
    layer under `remat_block`."""
    B, Senc, _ = frames.shape
    positions = iota_positions(B, Senc, frames.device)
    x = frames.to(rt.compute_dtype)
    for p_l in enc_layers:
        x = remat_block(rt, _encoder_layer, x, p_l, cfg, rt, positions, probe=p_l.ln1)
    return x


def decode_stack(x: torch.Tensor, dec_layers: nn.ModuleList, cfg: ModelConfig,
                 rt: Runtime, positions: torch.Tensor, enc_out: torch.Tensor
                 ) -> torch.Tensor:
    """Teacher-forced decoder; cross K/V projected per layer; each layer
    under `remat_block`."""
    for p_l in dec_layers:
        x = remat_block(rt, _decoder_layer, x, p_l, cfg, rt, positions, enc_out, probe=p_l.ln1)
    return x


# ---------------------------------------------------------------------------
# decode with cache
# ---------------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, rt: Runtime
                      ) -> Dict:
    """{"self": the decoder's KV cache, "cross_k"/"cross_v": (L, B, Senc, Hkv,
    hd) in the compute dtype}."""
    shape = (cfg.num_layers, batch, cfg.encoder_len, cfg.n_kv, cfg.hd())
    dev = rt.torch_device()
    return {
        "self": init_kv_cache(cfg, batch, max_len, cfg.num_layers, rt),
        "cross_k": torch.zeros(shape, dtype=rt.compute_dtype, device=dev),
        "cross_v": torch.zeros(shape, dtype=rt.compute_dtype, device=dev),
    }


def fill_cross_cache(enc_out: torch.Tensor, dec_layers: nn.ModuleList, cfg: ModelConfig,
                     rt: Runtime, cache: Dict) -> Dict:
    """Project the encoder output into every decoder layer's cross K/V once
    (written into `cache`, which is returned)."""
    for i, p_l in enumerate(dec_layers):
        cache["cross_k"][i], cache["cross_v"][i] = encode_cross_kv(enc_out, p_l.xattn, cfg, rt)
    return cache


def decode_stack_cached(x: torch.Tensor, dec_layers: nn.ModuleList, cfg: ModelConfig,
                        rt: Runtime, cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """Decoder against the cache from absolute position `pos` (scalar or
    (B,)); the self cache is written in place."""
    self_c = cache["self"]
    for i, p_l in enumerate(dec_layers):
        layer_c = {name: t[i] for name, t in self_c.items()}     # views
        h = rmsnorm(x, p_l.ln1, cfg.norm_eps)
        a, _ = cached_attention(h, p_l.attn, cfg, rt, layer_c, pos)
        x = x + a
        h = rmsnorm(x, p_l.lnx, cfg.norm_eps)
        x = x + cross_attention(h, p_l.xattn, cfg, rt, cache["cross_k"][i], cache["cross_v"][i])
        h = rmsnorm(x, p_l.ln2, cfg.norm_eps)
        x = x + mlp(h, p_l.mlp, cfg, rt)
    return x, cache
