"""Serve-step factories (prefill_step builds its own cache, decode_step)
and token sampling. The steps take the model where `repro`'s take the
params; they are how the encdec and vlm families are served (the engine
serves the decoder-only families)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.runtime import Runtime


def make_prefill_step(cfg: ModelConfig, rt: Runtime, max_len: int) -> Callable:
    """(model, batch) -> (last_logits, cache). The cache (`max_len` decoder
    slots) is made inside the step; batch holds "tokens" (B, S) and, for
    encdec, "frames" (B, encoder_len, d_model), for the vlm "patches"
    (B, prefix_len, d_model), whose positions come before the tokens'."""

    def prefill_step(model: M.Model, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        cache = M.init_cache(cfg, rt, batch["tokens"].shape[0], max_len)
        return model.prefill(batch["tokens"], cache, frames=batch.get("frames"),
                             patches=batch.get("patches"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, rt: Runtime) -> Callable:
    """(model, tokens (B, 1), pos scalar|(B,), cache) -> (logits, cache)."""

    def decode_step(model: M.Model, tokens: torch.Tensor, pos, cache: Dict):
        return model.decode_step(tokens, cache, pos=pos)

    return decode_step


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: Union[float, torch.Tensor] = 0.0) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling. logits (B, V) -> (B,) int64.

    `temperature` is a scalar applied to every row, or a (B,) tensor of
    per-row temperatures (the engine's per-request setting): rows with
    T<=0 decode greedily, rows with T>0 draw from softmax(logits / T) with
    `generator`.
    """
    greedy = logits.argmax(-1)
    t = torch.as_tensor(temperature, dtype=torch.float32)
    if not bool((t > 0).any()):
        return greedy
    t = t.to(logits.device)
    scale = t.clamp_min(1e-6)
    if t.dim() == 1:
        scale = scale[:, None]
    probs = torch.softmax(logits.float() / scale, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(t > 0, sampled, greedy)
