"""Wrapper of the hand-written CUDA SSD scan (csrc/ssd_scan.cu).

`ssd_scan` checks its inputs, allocates the outputs and the C.B^T scratch,
and launches the kernel on PyTorch's current stream. It takes CUDA tensors
only; `ops.ssd` sends CPU tensors to the plain version instead.
`ssd_scan.launches` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q_MAX = 128
N_MAX = 128


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry point with its signature, resolved once per process."""
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, D: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan on the card. x (B,S,H,P) fp32 or bf16; dt (B,S,H)
    fp32; A (H,) fp32; Bm, Cm (B,S,N) in x's dtype; D (H,) fp32.
    All contiguous. Returns y (B,S,H,P) in x's dtype and the final state
    (B,H,P,N) fp32. Chunks are Q = min(chunk, S) tokens."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share fp32 or bf16, got {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise TypeError("dt, A and D must be float32")
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape != (Bsz, S, N)
            or Cm.shape != (Bsz, S, N) or D.shape != (H,)):
        raise ValueError("ssd_scan: inconsistent shapes")
    if not 1 <= Q <= Q_MAX or N > N_MAX or N % 4:
        raise ValueError(f"ssd_scan takes chunk <= {Q_MAX} and N <= {N_MAX}, "
                         f"N % 4 == 0; got Q={Q}, N={N}")
    ins = (x, dt, A, Bm, Cm, D)
    if any(t.device != x.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan: inputs must be contiguous and on one device")

    nc = -(-S // Q)
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    cb = torch.empty((Bsz, nc, Q, Q), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 D.data_ptr(), cb.data_ptr(), y.data_ptr(),
                 state.data_ptr(), Bsz, S, H, P, N, Q, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
