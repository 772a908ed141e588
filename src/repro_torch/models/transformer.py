"""Decoder stacks of the dense, MoE and VLM families (port of
`repro.models.transformer`).

One pre-norm block serves dense (llama/qwen/smollm), local:global patterned
(gemma3), MoE (mixtral/grok) and VLM (paligemma: a prefix-LM mask) archs. `repro` scans a stack of stacked
parameters and picks each layer's attention with `lax.cond` on a traced
flag; here the stack is a Python loop over `DecoderLayer` modules and the
flag is a Python bool per layer (`global_flags`), so each layer calls the
attention it needs. Full-sequence attention goes through the
flash-attention kernel on the card (`attention.self_attention`); the cached
stack (prefill, decode) and the prefix-LM mask through the masked plain
version, as in `repro`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe
from repro_torch.models.attention import (
    Attention,
    cached_attention,
    init_kv_cache,
    self_attention,
)
from repro_torch.models.layers import MLP, mlp, rmsnorm
from repro_torch.models.runtime import Runtime, remat_block, residual


def global_flags(cfg: ModelConfig, n_layers: int) -> Optional[List[bool]]:
    """Per layer, True where it uses global (full) attention; None without a
    local:global pattern."""
    if cfg.local_global_pattern is None:
        return None
    loc, glob = cfg.local_global_pattern
    return [i % (loc + glob) >= loc for i in range(n_layers)]


def layer_windows(cfg: ModelConfig, n_layers: int) -> List[Optional[int]]:
    """Each layer's attention window: None on global layers, else
    `cfg.sliding_window` (itself None for full attention)."""
    flags = global_flags(cfg, n_layers) or [False] * n_layers
    return [None if flag else cfg.sliding_window for flag in flags]


class DecoderLayer(nn.Module):
    """ln1, attn, ln2, then `mlp` (dense) or `moe` (MoE)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.attn = Attention(cfg, **kw)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        if cfg.family == "moe":
            self.moe = moe.MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg, cfg.d_ff, **kw)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.reset_parameters(g)
        (self.moe if hasattr(self, "moe") else self.mlp).reset_parameters(g)


def _ffn(x: torch.Tensor, p_l: DecoderLayer, cfg: ModelConfig, rt: Runtime
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's second half: x + ffn(ln2(x)), and the layer's aux loss."""
    h = rmsnorm(x, p_l.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = moe.moe_mlp(h, p_l.moe, cfg, rt)
    else:
        out, aux = mlp(h, p_l.mlp, cfg, rt), torch.zeros((), device=x.device)
    return residual(x + out, rt), aux


def decoder_block(x: torch.Tensor, p_l: DecoderLayer, cfg: ModelConfig, rt: Runtime,
                  positions: torch.Tensor, window: Optional[int], prefix_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block. Returns (x, the layer's aux loss)."""
    h = rmsnorm(x, p_l.ln1, cfg.norm_eps)
    x = residual(x + self_attention(h, p_l.attn, cfg, rt, positions, window=window,
                                    prefix_len=prefix_len), rt)
    return _ffn(x, p_l, cfg, rt)


def decoder_stack(x: torch.Tensor, layers: nn.ModuleList, cfg: ModelConfig,
                  rt: Runtime, positions: torch.Tensor, prefix_len: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence stack. x (B, S, D) -> (x, the layers' summed aux loss).
    `prefix_len > 0` (the VLM) puts a prefix-LM mask on every layer.

    With `rt.remat == "block"` each layer runs under `remat_block`: while
    autograd records a graph, the layer's weight GEMMs keep their outputs
    and the rest of the layer is recomputed in the backward, as `repro`'s
    `dots_with_no_batch_dims_saveable` does (on the card the attention
    kernel's forward runs twice per layer and step)."""
    aux = torch.zeros((), device=x.device)
    for p_l, window in zip(layers, layer_windows(cfg, len(layers))):
        x, a = remat_block(rt, decoder_block, x, p_l, cfg, rt, positions, window, prefix_len,
                           probe=p_l.ln1)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# decode (one or few tokens against per-layer caches)
# ---------------------------------------------------------------------------


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                       rt: Runtime) -> Dict[str, torch.Tensor]:
    """The stack's KV cache: `max_len` slots on every layer, windowed or not
    (`repro`'s layout without its ring-cache option)."""
    return init_kv_cache(cfg, batch, max_len, n_layers, rt)


def decoder_stack_decode(x: torch.Tensor, layers: nn.ModuleList, cfg: ModelConfig,
                         rt: Runtime, cache: Dict[str, torch.Tensor], pos,
                         prefix_len: int = 0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The stack against `cache` (written in place) from absolute position
    `pos` (scalar or (B,)). The MoE aux loss is dropped, as in `repro`."""
    for i, (p_l, window) in enumerate(zip(layers, layer_windows(cfg, len(layers)))):
        layer_c = {name: t[i] for name, t in cache.items()}     # views
        h = rmsnorm(x, p_l.ln1, cfg.norm_eps)
        a, _ = cached_attention(h, p_l.attn, cfg, rt, layer_c, pos, window=window,
                                prefix_len=prefix_len)
        x, _ = _ffn(x + a, p_l, cfg, rt)
    return x, cache
