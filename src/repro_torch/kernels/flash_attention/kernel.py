"""Wrapper of the hand-written CUDA flash-attention kernel
(csrc/flash_attention.cu).

`flash_attention` checks its inputs, allocates the output and launches the
kernel on PyTorch's current stream. It takes CUDA tensors only; `ops.mha`
sends CPU tensors to the plain version instead. q, k, v are read in place
through their batch and row strides (each head's hd values must be
contiguous, as they are after a reshape of a projection).
`flash_attention.launches` counts the launches, and
`flash_attention.launches_by_case` counts them by call, keyed
(B, Sq, Hq, Hkv, hd, causal, window).

The dtype picks the kernel, by a fixed rule and not as a fallback:
bfloat16 goes to `flash_mma_kernel` (tensor cores, cp.async staging, so its
pointers and batch and row strides must be 16-byte aligned, or the wrapper
raises), float32 to `flash_kernel` (fp32 FMAs on the CUDA cores, so fp32
stays IEEE fp32).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HD_MAX = 256


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry point with its signature, resolved once per process."""
    fn = _build.load("flash_attention").flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Attention for aligned self-attention (query i and key j at positions
    i and j) on the card. q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), all fp32
    or all bf16, hd a multiple of 16 up to 256, Hq a multiple of Hkv.
    Returns (B, Sq, Hq, hd) in q's dtype. `softmax_scale` defaults to
    hd ** -0.5."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if hd % 16 or not 16 <= hd <= HD_MAX:
        raise ValueError(f"flash_attention takes hd a multiple of 16 up to {HD_MAX}, got {hd}")
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention takes B * Hq <= 65535, got {B * Hq}")
    if window is not None and not 0 <= window < 2 ** 31:
        raise ValueError(f"window must be None or in [0, 2**31), got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v must be on one device")
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"flash_attention: {name} needs head stride hd and element "
                             f"stride 1, got strides {t.stride()}")
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
                t.shape[d] > 1 and t.stride(d) % 8 for d in (0, 1))):
            raise ValueError(f"flash_attention: bf16 {name} needs a 16-byte aligned pointer "
                             f"and batch and row strides, got pointer {t.data_ptr():#x} "
                             f"and strides {t.stride()}")
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, hd,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 scale, int(causal), -1 if window is None else window,
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    case = (B, Sq, Hq, Hkv, hd, bool(causal), window)
    flash_attention.launches_by_case[case] = flash_attention.launches_by_case.get(case, 0) + 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_case = {}
