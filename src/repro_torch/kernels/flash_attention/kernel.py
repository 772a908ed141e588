"""Wrapper of the hand-written CUDA flash-attention kernels
(csrc/flash_attention.cu).

`flash_attention` checks its inputs, allocates the output (and, on the fp32
Hopper route, the pre-pass's scratch) and launches the kernels that
`forward_kernels` names on PyTorch's current stream; its `launches` count
wrapper calls. It takes CUDA tensors only; `ops.mha`
sends CPU tensors to the plain version instead. q, k, v are read in place
through their batch and row strides (each head's hd values must be
contiguous, as they are after a reshape of a projection).
`flash_attention.launches` counts the launches, and
`flash_attention.launches_by_case` counts them by call, keyed
(B, Sq, Hq, Hkv, hd, causal, window).

`flash_attention_bwd` is the backward: per wrapper call the CUDA launches
that `backward_kernels` names, in order (fp32 on the Hopper route: a
pre-pass that writes delta and the operands' split copies into scratch, a dQ
kernel, a dK/dV kernel; elsewhere a dQ kernel, which also computes delta,
then a dK/dV kernel); its `launches` and `launches_by_case` count wrapper
calls. `ops.FlashAttentionFn` joins the two for autograd.

The dtype, the head dim and, for fp32, the shape pick the kernels, by a
fixed rule and not as a fallback (`forward_kernels` names the forward's,
`backward_kernels` the backward's; a failed build, tensor-map encode or
launch raises). fp32 takes the Hopper route where `fp32_on_hopper` holds:
hd 64, 128 or 256 and more than `TF32_MMA_KEYS` keys (512 forward, 256
backward); with fewer keys the pre-pass costs more than the Hopper kernels
save (PERF.md):
  * bfloat16 forward at hd 64, 128 and 256 (every full-width config's head
    dim) -> `flash_wgmma_kernel`: Hopper's warpgroup products (wgmma) fed by
    TMA loads from a producer warp;
  * bfloat16 forward at the other head dims -> `flash_mma_kernel` (mma.sync);
  * bfloat16 backward at hd 64, 128 and 256 -> `flash_wgmma_bwd_dq_kernel` +
    `flash_wgmma_bwd_dkdv_kernel` (wgmma fed by TMA, as the forward);
  * bfloat16 backward at the other head dims -> `flash_bf16_bwd_dq_kernel` +
    `flash_bf16_bwd_dkdv_kernel` (mma.sync);
  * float32 forward on the Hopper route -> `flash_wgmma_tf32_fwd_prep_kernel`
    (k in two TF32 terms, v transposed in three, once per call into scratch)
    + `flash_wgmma_tf32_kernel` (TF32 wgmma fed by TMA, split TF32);
  * float32 forward elsewhere -> `flash_tf32_kernel` (each fp32 operand
    split into two TF32 terms, three tensor-core products per fp32 one: as
    close to the function as IEEE fp32; on mma.sync);
  * float32 backward on the Hopper route -> `flash_wgmma_tf32_bwd_prep_kernel`
    (hi and lo TF32 terms of q, k, v and dO, natural and transposed, once per
    call into scratch; delta) + `flash_wgmma_tf32_bwd_dq_kernel` +
    `flash_wgmma_tf32_bwd_dkdv_kernel` (TF32 wgmma fed by TMA, split TF32);
  * float32 backward elsewhere -> `flash_tf32_bwd_dq_kernel` +
    `flash_tf32_bwd_dkdv_kernel` (split TF32 on mma.sync).
The bf16 kernels feed P (and dS) to their products as two bf16 terms each.
Every kernel reads its tiles by 16-byte cp.async or by TMA, so q, k, v need
16-byte aligned pointers and batch and row strides in both dtypes, or the
wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HD_MAX = 256
WGMMA_HDS = (64, 128, 256)       # head dims on the wgmma kernels
# fp32 at this many keys or fewer: the mma.sync kernels, forward and backward
TF32_MMA_KEYS = {"forward": 512, "backward": 256}


def fp32_on_hopper(hd: int, shape: tuple[int, int, int, int, int], backward: bool = False) -> bool:
    """Whether fp32 attention at head dim `hd` and `shape` = (B, Sq, Skv, Hq,
    Hkv) runs its forward (its backward, with `backward`) on the Hopper
    kernels (TF32 wgmma fed by TMA after a pre-pass): `fp32_on_hopper` in
    csrc/flash_attention.cu."""
    skv = shape[2]
    return hd in WGMMA_HDS and skv > TF32_MMA_KEYS["backward" if backward else "forward"]


def forward_kernels(hd: int, dtype: torch.dtype,
                    shape: Optional[tuple[int, int, int, int, int]] = None) -> tuple[str, ...]:
    """The names of the CUDA kernels that `flash_attention` launches at head
    dim `hd`, `dtype` and, for fp32, `shape` = (B, Sq, Skv, Hq, Hkv), in
    launch order: the rule of `Fwd` in csrc/flash_attention.cu. fp32 on the
    Hopper route: the pre-pass (k's and v's split copies), then the forward
    kernel; every other route one kernel."""
    if dtype == torch.float32:
        if shape is None:
            raise ValueError("the fp32 forward's kernels depend on the shape "
                             "(B, Sq, Skv, Hq, Hkv)")
        if fp32_on_hopper(hd, shape):
            return "flash_wgmma_tf32_fwd_prep_kernel", "flash_wgmma_tf32_kernel"
        return ("flash_tf32_kernel",)
    if dtype == torch.bfloat16:
        return ("flash_wgmma_kernel" if hd in WGMMA_HDS else "flash_mma_kernel",)
    raise TypeError(f"flash_attention takes fp32 or bf16, got {dtype}")


def forward_kernel(hd: int, dtype: torch.dtype,
                   shape: Optional[tuple[int, int, int, int, int]] = None) -> str:
    """The forward's main kernel, the last that `forward_kernels` names."""
    return forward_kernels(hd, dtype, shape)[-1]


def backward_kernels(hd: int, dtype: torch.dtype,
                     shape: Optional[tuple[int, int, int, int, int]] = None) -> tuple[str, ...]:
    """The names of the CUDA kernels that `flash_attention_bwd` launches at
    head dim `hd`, `dtype` and, for fp32, `shape` = (B, Sq, Skv, Hq, Hkv), in
    launch order: the rule of `Bwd` in csrc/flash_attention.cu. fp32 on the
    Hopper route: the pre-pass (split copies, delta), the dQ kernel, the
    dK/dV kernel; elsewhere the dQ kernel (which writes delta), then the
    dK/dV kernel."""
    if dtype == torch.float32:
        if shape is None:
            raise ValueError("the fp32 backward's kernels depend on the shape "
                             "(B, Sq, Skv, Hq, Hkv)")
        if fp32_on_hopper(hd, shape, backward=True):
            return tuple(f"flash_wgmma_tf32_bwd_{part}_kernel" for part in ("prep", "dq", "dkdv"))
        route = "tf32"
    elif dtype == torch.bfloat16:
        route = "wgmma" if hd in WGMMA_HDS else "bf16"
    else:
        raise TypeError(f"flash_attention_bwd takes fp32 or bf16, got {dtype}")
    return f"flash_{route}_bwd_dq_kernel", f"flash_{route}_bwd_dkdv_kernel"


def bind(lib: ctypes.CDLL):
    """(forward launch, backward launch, backward scratch bytes, forward
    scratch bytes): the C entry points of a built library with their
    signatures."""
    fwd = lib.flash_attention_launch
    fwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    bwd = lib.flash_attention_bwd_launch
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    bwd_scratch, fwd_scratch = (lib.flash_attention_bwd_scratch_bytes,
                                lib.flash_attention_fwd_scratch_bytes)
    for fn in (bwd_scratch, fwd_scratch):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * 7
    return fwd, bwd, bwd_scratch, fwd_scratch


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of this tree's library, resolved once per process."""
    return bind(_build.load("flash_attention"))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]):
    """Raise on inputs the kernels do not take."""
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
        if not _aligned(t):
            raise ValueError(f"flash_attention: {name} needs a 16-byte aligned pointer and "
                             f"batch and row strides, got pointer {t.data_ptr():#x} and "
                             f"strides {t.stride()} of {t.element_size()}-byte elements")


def _aligned(t: torch.Tensor) -> bool:
    """cp.async moves 16 bytes and TMA takes strides in multiples of 16
    bytes: the pointer and the batch and row strides must be multiples of
    16 bytes."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        t.shape[d] > 1 and t.stride(d) % per for d in (0, 1))


_COUNT_LOCK = threading.Lock()


def _count(fn, q, k, causal, window):
    with _COUNT_LOCK:      # the ranks of a threaded mesh count together
        fn.launches += 1
        case = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], bool(causal), window)
        fn.launches_by_case[case] = fn.launches_by_case.get(case, 0) + 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None, return_lse: bool = False):
    """Attention for aligned self-attention (query i and key j at positions
    i and j) on the card. q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), all fp32
    or all bf16, hd a multiple of 16 up to 256, Hq a multiple of Hkv.
    Returns (B, Sq, Hq, hd) in q's dtype; with `return_lse` also each row's
    log-sum-exp of the masked scaled scores, (B, Hq, Sq) fp32, which the
    backward takes (the output is the same bits either way).
    `softmax_scale` defaults to hd ** -0.5."""
    _check(q, k, v, window)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    if Sq == 0:
        return (out, lse) if return_lse else out
    # the fp32 Hopper route's pre-pass writes k in two TF32 terms and v
    # transposed in three into scratch (84 MB at mixtral-8x7b's (1, 4096,
    # 32/8 heads of 128)); freed when the call returns
    nbytes = _lib()[3](B, Sq, Skv, Hq, Hkv, hd, _DTYPES[q.dtype])
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
               if nbytes else None)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    B, Sq, Skv, Hq, Hkv, hd,
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                    scale, int(causal), -1 if window is None else window,
                    _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    _count(flash_attention, q, k, causal, window)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, softmax_scale: Optional[float] = None):
    """(dq, dk, dv) of `flash_attention(q, k, v, ...)` on the card, given its
    output `o` and log-sum-exp `lse` (`return_lse=True`) and the output's
    gradient `do`. The same inputs as the forward, the same options;
    gradients in q's dtype, contiguous. The CUDA launches that
    `backward_kernels` names (three for fp32 on the Hopper route, else two),
    no atomics: the same inputs give the same bits."""
    _check(q, k, v, window)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be (B, Hq, Sq) fp32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if o.device != q.device or do.device != q.device or lse.device != q.device:
        raise ValueError("flash_attention_bwd: all inputs must be on one device")
    # the kernels read o, do and lse as contiguous, do by cp.async and the
    # bf16 o by 16-byte loads; autograd's do may be a view (a copy makes it
    # contiguous and aligned)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    if not _aligned(do):
        do = do.clone()
    if not _aligned(o):
        o = o.clone()
    dq = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, Hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    # beside delta, the fp32 Hopper route takes scratch for
    # the hi and lo TF32 terms of q, k, v and do, natural and transposed
    # (four floats per element of q, k and do, two of v: 0.64 GB at
    # mixtral-8x7b's (1, 4096, 32/8 heads of 128)); freed when the call returns
    nbytes = _lib()[2](B, Sq, Skv, Hq, Hkv, hd, _DTYPES[q.dtype])
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
               if nbytes else None)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1),
                    scale, int(causal), -1 if window is None else window,
                    _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    _count(flash_attention_bwd, q, k, causal, window)
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.launches_by_case = {}
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_case = {}
