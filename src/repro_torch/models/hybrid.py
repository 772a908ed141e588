"""Zamba2-style hybrid (port of `repro.models.hybrid`): a Mamba-2 backbone
plus ONE shared attention(+MLP) block applied after every
`shared_attn_every` SSM layers, its weights reused by each application.

`repro` scans each segment of stacked SSM layers with `lax.scan`; here the
stack is a Python loop over `SSMBlock` modules (the mamba2 family's block,
so the same SSD-scan call), with the shared block run after layers
every-1, 2*every-1, ... There are n_app = num_layers // every applications,
each with its own KV-cache layer; the num_layers % every layers left over
run after the last one. Full-sequence attention in the shared block goes
through the flash-attention kernel on the card; its cached attention
(prefill, decode) through the masked plain version, as in `repro`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    Attention,
    cached_attention,
    init_kv_cache,
    self_attention,
)
from repro_torch.models.layers import MLP, mlp, rmsnorm
from repro_torch.models.mamba2 import SSMBlock, init_ssm_cache
from repro_torch.models.runtime import Runtime, remat_block, residual


def n_applications(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.shared_attn_every


class SharedBlock(nn.Module):
    """ln1, attn, ln2, mlp: the one attention block every application reuses."""

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


class HybridLayers(nn.Module):
    """`ssm_layers`: num_layers SSM blocks; `shared`: the shared block."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ssm_layers = nn.ModuleList(SSMBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.shared = SharedBlock(cfg, **kw)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for layer in self.ssm_layers:
            layer.reset_parameters(g)
        self.shared.reset_parameters(g)


def _application(cfg: ModelConfig, layer: int) -> Optional[int]:
    """The shared block's application that follows SSM layer `layer`, if any."""
    every = cfg.shared_attn_every
    return (layer + 1) // every - 1 if (layer + 1) % every == 0 else None


def hybrid_forward(x: torch.Tensor, layers: HybridLayers, cfg: ModelConfig,
                   rt: Runtime, positions: torch.Tensor) -> torch.Tensor:
    """Full sequence. x (B, S, D) -> (B, S, D). With `rt.remat == "block"`
    each SSM layer is recomputed in the backward but for its weight GEMMs
    (`remat_block`); the shared block is not, as in `repro`."""
    shared = layers.shared
    for i, block in enumerate(layers.ssm_layers):
        x = remat_block(rt, block, x, rt, probe=block.ln)
        if _application(cfg, i) is not None:
            h = rmsnorm(x, shared.ln1, cfg.norm_eps)
            x = residual(x + self_attention(h, shared.attn, cfg, rt, positions), rt)
            h = rmsnorm(x, shared.ln2, cfg.norm_eps)
            x = residual(x + mlp(h, shared.mlp, cfg, rt), rt)
    return x


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, rt: Runtime) -> Dict:
    """{"ssm": {"conv", "ssd"} of every SSM layer, "attn": {"k", "v",
    "kv_pos"} of every application}; every leaf is (L, B, ...)."""
    return {"ssm": init_ssm_cache(cfg, batch, cfg.num_layers, rt),
            "attn": init_kv_cache(cfg, batch, max_len, n_applications(cfg), rt)}


def _cached(x: torch.Tensor, layers: HybridLayers, cfg: ModelConfig, rt: Runtime,
            cache: Dict, pos, prefill: bool) -> Tuple[torch.Tensor, Dict]:
    shared, conv, ssd = layers.shared, cache["ssm"]["conv"], cache["ssm"]["ssd"]
    for i, block in enumerate(layers.ssm_layers):
        if prefill:
            x, conv[i], ssd[i] = block.prefill(x, rt, conv[i])
        else:
            x, conv[i], ssd[i] = block.decode(x, rt, conv[i], ssd[i])
        app = _application(cfg, i)
        if app is not None:
            layer_c = {name: t[app] for name, t in cache["attn"].items()}     # views
            h = rmsnorm(x, shared.ln1, cfg.norm_eps)
            a, _ = cached_attention(h, shared.attn, cfg, rt, layer_c, pos)
            x = x + a
            h = rmsnorm(x, shared.ln2, cfg.norm_eps)
            x = x + mlp(h, shared.mlp, cfg, rt)
    return x, cache


def hybrid_prefill(x: torch.Tensor, layers: HybridLayers, cfg: ModelConfig, rt: Runtime,
                   cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """From position 0: the SSM layers' full-sequence forward (their final
    states kept) and the shared block's cache fill; `cache` is written in
    place."""
    return _cached(x, layers, cfg, rt, cache, 0, prefill=True)


def hybrid_decode(x: torch.Tensor, layers: HybridLayers, cfg: ModelConfig, rt: Runtime,
                  cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One token at absolute position `pos` (scalar or (B,)); `cache` is
    written in place."""
    return _cached(x, layers, cfg, rt, cache, pos, prefill=False)
