"""Token sampling for the serving engine."""
from __future__ import annotations

from typing import Optional, Union

import torch


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
