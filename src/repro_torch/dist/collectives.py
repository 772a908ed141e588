"""Compressed gradient collectives: int8 quantization with error feedback
(`repro.dist.collectives` for the port).

Gradients are quantized to int8 with one fp32 scale per tensor before the
reduction, a 4x byte reduction against fp32. Plain quantization biases the
update; the error-feedback residual (EF-SGD) carries each step's rounding
error into the next, so the *sum* of compressed gradients over steps tracks
the sum of the true ones.

Gradients and residuals are dicts keyed by parameter name, as
`train_step.make_train_step` hands them to its `grad_transform`; every
function returns new tensors on the gradients' device and never waits for
the card. The caller threads the residual.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q int8, scale fp32
    0-d) with x ~= q * scale and |x - q * scale| <= scale / 2: round to
    nearest, halves to even, as `jnp.round`."""
    xf = x.float()
    # divided by a tensor, not a Python number: CUDA divides by a host
    # scalar as a product with its reciprocal, which can differ from IEEE
    # division (the CPU's, and repro's) in the last bit
    scale = xf.abs().max().clamp_min(1e-30) / xf.new_full((), 127.0)
    q = torch.round(xf / scale).clamp(-127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _one(g: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    corrected = g.float() + e
    finite_at = torch.isfinite(corrected)
    finite = finite_at.all()
    q, scale = quantize_int8(torch.where(finite_at, corrected, 0.0))
    # a non-finite leaf (an overflow step) passes through uncompressed and
    # keeps its residual, so one bad step cannot poison error feedback
    sent = torch.where(finite, dequantize_int8(q, scale).to(g.dtype), g)
    # the residual is measured against what was sent, after the cast to the
    # gradient's dtype: for bf16 gradients the cast's rounding is fed back
    # too, or the sum of compressed gradients drifts from the true sum
    return sent, torch.where(finite, corrected - sent.float(), e)


def compress_grads(grads: Dict[str, torch.Tensor],
                   err: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One error-feedback round: each gradient plus the previous round's
    residual is quantized to int8 (the compressed reduction's wire format)
    and dequantized; the fresh rounding error is the next residual (fp32).
    Pass `err=None` on the first step. A residual from another parameter
    set (other names) raises. Returns (compressed gradients, new residual)."""
    if err is None:
        err = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
               for k, g in grads.items()}
    if err.keys() != grads.keys():
        raise ValueError("the residual's parameters differ from the gradients': "
                         f"{sorted(err.keys() ^ grads.keys())}")
    pairs = {k: _one(g, err[k]) for k, g in grads.items()}
    return {k: s for k, (s, _) in pairs.items()}, {k: e for k, (_, e) in pairs.items()}


def int8_compress_decompress(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stateless round trip (no error feedback): a drop-in `grad_transform`
    for `make_train_step` with a compressed reduction's numerics."""
    return compress_grads(grads, None)[0]


def compressed_bytes(grads: Dict[str, torch.Tensor]) -> int:
    """Wire bytes of one compressed reduction: the int8 payload and one fp32
    scale per tensor."""
    return sum(g.numel() + 4 for g in grads.values())
