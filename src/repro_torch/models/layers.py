"""Shared primitives of the SSM slice: norms, the causal depthwise conv and
init helpers. Plain tensor functions; numerics follow `repro.models.layers`
(norms scale by (1 + g) in fp32; the conv works in fp32 and applies SiLU
before the cast back).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
