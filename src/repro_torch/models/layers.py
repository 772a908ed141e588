"""Shared primitives: norms, RoPE, the MLP, the causal depthwise conv and
init helpers. Plain tensor functions (and the MLP's parameter module);
numerics follow `repro.models.layers` (norms scale by (1 + g) in fp32; RoPE
rotates in fp32; the conv works in fp32 and applies SiLU before the cast
back; GELU is the tanh form, which is `jax.nn.gelu`'s default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init_(t: torch.Tensor, g: torch.Generator,
                scale: Optional[float] = None) -> torch.Tensor:
    """In place: truncated normal on [-2, 2] times the fan-in scale
    (`shape[-2] ** -0.5` unless `scale` is given), as `repro`'s dense_init.
    Drawn by inverting the normal CDF so one generator drives it."""
    fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(t.shape, generator=g, device=t.device, dtype=torch.float32)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
    with torch.no_grad():
        t.copy_(z.clamp_(-2.0, 2.0) * s)
    return t


def embed_init_(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g, device=t.device) * 0.02)
    return t


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + g.float())
    return out.to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2 output norm: rmsnorm(x * silu(z))."""
    xf = x.float() * F.silu(z.float())
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + g.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves. x (B, S, H, hd), positions (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]           # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class MLP(nn.Module):
    """Plain (wi, wo) or gated (wi, wg, wo) 2-layer MLP parameters."""

    def __init__(self, cfg: ModelConfig, d_ff: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.wi = nn.Parameter(torch.empty(cfg.d_model, d_ff, **kw))
        self.wo = nn.Parameter(torch.empty(d_ff, cfg.d_model, **kw))
        self.wg = nn.Parameter(torch.empty(cfg.d_model, d_ff, **kw)) if cfg.glu else None

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for w in (self.wi, self.wo, self.wg):
            if w is not None:
                dense_init_(w, g)


def mlp(h: torch.Tensor, p: MLP, cfg: ModelConfig, rt) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain MLP. h (B, S, D)."""
    from repro_torch.models.runtime import weight
    f = act_fn(cfg.act)
    if cfg.glu:
        u = f(h @ weight(p.wg, rt)) * (h @ weight(p.wi, rt))
    else:
        u = f(h @ weight(p.wi, rt))
    return u @ weight(p.wo, rt)


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel causal 1-D conv. x (B, S, C), w (K, C), b (C,).
    If `state` (B, K-1, C) is given, it is prepended (decode path)."""
    K = w.shape[0]
    S = x.shape[1]
    xf = x.float()
    if state is not None:
        xf = torch.cat([state.float(), xf], dim=1)
    else:
        xf = F.pad(xf, (0, 0, K - 1, 0))
    wf = w.float()
    out = xf[:, 0:S] * wf[0]
    for i in range(1, K):
        out = out + xf[:, i:i + S] * wf[i]
    out = out + b.float()
    return F.silu(out).to(x.dtype)
