"""Model facade of the port. Only the SSM family (mamba2) is ported; the
other families raise `NotImplementedError` (ROADMAP.md lists them).

    model = Model(cfg, rt)                      # random init from a seed
    cache = init_cache(cfg, rt, batch, max_len)
    logits, cache = model.prefill(tokens, cache)       # last-token logits
    logits, cache = model.decode_step(tokens, cache)   # tokens (B, 1)
    logits = model(tokens)                      # full-sequence scoring

Parameters live on `rt.device` in `rt.param_dtype` and are cast to
`rt.compute_dtype` where they are used, as in `repro`. The logits are fp32
against the tied embedding. prefill and decode_step update `cache` in place
(the engine owns one batched cache) and return it.

The model leaves the process-wide TF32 switches alone. The entry points
(`launch/serve.py`, `chip_smoke.py`) set `torch.backends.cuda.matmul.allow_tf32`
and `torch.backends.cudnn.allow_tf32` to False, so that float32 products run
in full fp32 on the card as they do in `repro`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import embed_init_, rmsnorm
from repro_torch.models.mamba2 import SSMBlock, init_ssm_cache
from repro_torch.models.runtime import Runtime


def _require_ssm(cfg: ModelConfig):
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet; "
            "ROADMAP.md lists the slices still to port")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, rt: Runtime, seed: Optional[int] = 0):
        """Random init from `seed` (a torch.Generator on the device), unless
        `rt.device` is "meta" or `seed` is None (weights loaded later)."""
        super().__init__()
        _require_ssm(cfg)
        dev = rt.torch_device()
        self.cfg, self.rt = cfg, rt
        kw = {"device": dev, "dtype": rt.param_dtype}
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.final_ln = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.layers = nn.ModuleList(
            SSMBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.requires_grad_(False)
        if dev.type != "meta" and seed is not None:
            self.reset_parameters(torch.Generator(dev).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        embed_init_(self.embed, g)
        self.final_ln.zero_()
        for layer in self.layers:
            layer.reset_parameters(g)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # gather then cast: the same values as repro's cast-then-gather
        return self.embed[tokens].to(self.rt.compute_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        return x.float() @ self.embed.float().T

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits (B, S, V), fp32. No loss."""
        x = self._embed(tokens)
        for layer in self.layers:
            x = layer(x, self.rt)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Fill `cache` from position 0; returns (last-token logits (B, V), cache)."""
        x = self._embed(tokens)
        for i, layer in enumerate(self.layers):
            x, cache["conv"][i], cache["ssd"][i] = layer.prefill(
                x, self.rt, cache["conv"][i])
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One autoregressive step. tokens (B, 1) -> logits (B, V)."""
        x = self._embed(tokens)
        for i, layer in enumerate(self.layers):
            x, cache["conv"][i], cache["ssd"][i] = layer.decode(
                x, self.rt, cache["conv"][i], cache["ssd"][i])
        return self._logits(x)[:, 0], cache


def init_cache(cfg: ModelConfig, rt: Runtime, batch: int, max_len: int
               ) -> Dict[str, torch.Tensor]:
    """Decode cache {"conv": (L, B, K-1, C), "ssd": (L, B, H, P, N) fp32}.
    An SSM cache does not grow with `max_len`; the argument keeps repro's
    signature for the families still to port."""
    _require_ssm(cfg)
    return init_ssm_cache(cfg, batch, cfg.num_layers, rt)
