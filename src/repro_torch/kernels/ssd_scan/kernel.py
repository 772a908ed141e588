"""Wrapper of the hand-written CUDA SSD scan (csrc/ssd_scan.cu).

`ssd_scan` checks its inputs, allocates the outputs and the scratch, and
launches on PyTorch's current stream. It takes CUDA tensors only; `ops.ssd`
sends CPU tensors to the plain version instead. `ssd_scan.launches` counts
the wrapper's calls that launched, and `ssd_scan.launches_by_case` counts
them by call, keyed (B, S, H, P, N, chunk). With `return_states` it also
returns the state entering each chunk, which `ssd_scan_bwd`, the backward,
takes; `ssd_scan_bwd.launches` and `.launches_by_case` count its calls
(six CUDA launches each), and `ops.SSDScanFn` joins the two for autograd.

The dtype picks the kernels, by a fixed rule and not as a fallback, and
every one runs on the tensor cores: bfloat16 goes to chunk_state_kernel,
state_pass_kernel and chunk_scan_kernel (bf16 mma.sync), float32 to
chunk_state_tf32_kernel, state_pass_kernel and chunk_scan_tf32_kernel
(split-TF32 mma.sync, three TF32 products per fp32 one): three CUDA
launches per call either way. The backward runs split-TF32 kernels for
both dtypes, on one of two routes by a fixed rule on the shape
(`bwd_on_hopper`, the same rule as ssd_scan.cu's): fp32 at chunks of 128,
64 channels a head and 64 or 128 states, with x 16-byte aligned for TMA,
takes the Hopper kernels (TF32 wgmma fed by TMA) for dx and for dB/dC;
every other shape, and bf16 at every shape, the mma.sync ones
(`backward_kernels` names each route's six launches). Every kernel reads
x, B and C in place through their batch and row strides, so the split
views of a packed projection need no copy.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

Q_MAX = 128
N_MAX = 128
# the shapes the backward's Hopper route takes (ssd_scan.cu's bwd_on_hopper)
HOPPER_Q, HOPPER_P, HOPPER_N = 128, 64, (64, 128)


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points with their signatures, resolved once per process."""
    lib = _build.load("ssd_scan")
    fwd, bwd = lib.ssd_scan_launch, lib.ssd_scan_bwd_launch
    route = lib.ssd_scan_bwd_on_hopper
    fwd.restype = bwd.restype = route.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    route.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
    return fwd, bwd, route


def tma_aligned(x: torch.Tensor) -> bool:
    """x's pointer and its batch and row strides are multiples of 16 bytes
    (4 fp32 values): what x's TMA map needs. A dimension of extent 1 has a
    free stride, as TMA's maps treat it."""
    return (x.data_ptr() % 16 == 0 and (x.shape[1] <= 1 or x.stride(1) % 4 == 0)
            and (x.shape[0] <= 1 or x.stride(0) % 4 == 0))


def bwd_on_hopper(case, dtype, aligned: bool = True) -> bool:
    """The backward's route, a fixed rule on the shape (ssd_scan.cu's
    bwd_on_hopper): fp32 with chunks of Q = 128 (so S >= 128; a ragged last
    chunk is zero-filled by TMA), P = 64 and N in (64, 128), x aligned for
    TMA (`tma_aligned`), B nc H P rows within int32. case = (B, S, H, P, N,
    chunk). bf16 never: its backward keeps the mma.sync kernels."""
    B, S, H, P, N, chunk = case
    Q = min(chunk, S)
    nc = -(-S // Q)
    return (dtype == torch.float32 and Q == HOPPER_Q and P == HOPPER_P and N in HOPPER_N
            and aligned and B * nc * H * P < 2 ** 31)


def backward_kernels(case, dtype, aligned: bool = True):
    """The CUDA kernels one `ssd_scan_bwd` call launches at case (B, S, H,
    P, N, chunk) in `dtype`, in launch order, by `bwd_on_hopper`."""
    t = "float" if dtype == torch.float32 else "bf16"
    front = (f"ssd_bwd_cbds_kernel<{t}>", f"chunk_state_tf32_kernel<true, {t}>",
             "state_pass_kernel<true>")
    if bwd_on_hopper(case, dtype, aligned):
        n = case[4]
        return front + (f"ssd_bwd_dx_kernel<{n}>", f"ssd_bwd_dbc_kernel<{n}>",
                        "ssd_bwd_dbc_sum_kernel")
    return front + (f"ssd_bwd_chunk_tf32_kernel<{t}>", f"ssd_bwd_bc_tf32_kernel<{t}>",
                    f"ssd_bwd_bc_sum_tf32_kernel<{t}>")


def bwd_on_hopper_lib(x: torch.Tensor, N: int, chunk: int) -> bool:
    """ssd_scan.cu's own answer to the route at x's shape, pointer and
    strides (the card tests hold `bwd_on_hopper` to it)."""
    Bsz, S, H, P = x.shape
    return bool(_lib()[2](int(x.dtype == torch.bfloat16), Bsz, S, H, P, N, min(chunk, S),
                          x.data_ptr(), x.stride(0), x.stride(1)))


def _copy_width(t: torch.Tensor, width: int) -> int:
    """Elements per copy (8, 4, 2 or 1, at most 16 bytes): the widest that
    divides the pointer's alignment, the batch and row strides and the row
    width."""
    e = t.element_size()
    for v in (8, 4, 2):
        if (v * e <= 16 and t.data_ptr() % (e * v) == 0 and width % v == 0
                and all(t.shape[d] <= 1 or t.stride(d) % v == 0 for d in (0, 1))):
            return v
    return 1


def _check(x, dt, A, Bm, Cm, D, chunk):
    """Raise on inputs the kernels do not take."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
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
    if any(t.device != x.device for t in (x, dt, A, Bm, Cm, D)):
        raise ValueError("ssd_scan: inputs must be on one device")
    if not all(t.is_contiguous() for t in (dt, A, D)):
        raise ValueError("ssd_scan: dt, A and D must be contiguous")
    if x.stride(3) != 1 or (H > 1 and x.stride(2) != P) or Bm.stride(2) != 1 \
            or Cm.stride(2) != 1:
        raise ValueError(f"ssd_scan: x needs head stride P and element stride 1, Bm and Cm "
                         f"element stride 1; got strides {x.stride()}, {Bm.stride()}, "
                         f"{Cm.stride()}")


_COUNT_LOCK = threading.Lock()


def _count(fn, x, Bm, chunk):
    with _COUNT_LOCK:      # the ranks of a threaded mesh count together
        fn.launches += 1
        case = (*x.shape, Bm.shape[-1], chunk)
        fn.launches_by_case[case] = fn.launches_by_case.get(case, 0) + 1


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, D: torch.Tensor, *, chunk: int = 128,
             return_states: bool = False):
    """Chunked SSD scan on the card. x (B,S,H,P) fp32 or bf16; dt (B,S,H)
    fp32; A (H,) fp32; Bm, Cm (B,S,N) in x's dtype; D (H,) fp32. x, Bm and
    Cm need a contiguous last dimension (x also its head dimension), so the
    split views of a packed projection qualify; dt, A and D contiguous.
    Returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) fp32;
    with `return_states` also the state entering each chunk, h_prev
    (B, nc, H, P, N) fp32 (y and the state are the same bits either way).
    Chunks are Q = min(chunk, S) tokens."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    dev, f32 = x.device, torch.float32
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    # state_pass_kernel leaves h_prev in the scratch it reads the chunk states from
    states = torch.empty((Bsz, nc, H, P, N), dtype=f32, device=dev)
    lq = torch.empty((Bsz, nc, H), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()[0](x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    D.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
                    lq.data_ptr(), Bsz, S, H, P, N, Q,
                    x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                    Cm.stride(0), Cm.stride(1),
                    _copy_width(x, P), _copy_width(Bm, N), _copy_width(Cm, N),
                    int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    _count(ssd_scan, x, Bm, chunk)
    return (y, state, states) if return_states else (y, state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, D: torch.Tensor, h_prev: torch.Tensor, dy: torch.Tensor,
                 dhT: Optional[torch.Tensor] = None, *, chunk: int = 128):
    """Gradients of `ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)` on the card,
    given its `h_prev` (`return_states=True`), y's gradient `dy` (B,S,H,P)
    in x's dtype and the final state's `dhT` (B,H,P,N) fp32 (None: unused).
    The inputs as the forward takes them, x, Bm and Cm read through their
    strides in both dtypes. Returns (dx, ddt, dA, dB, dC, dD): dx, dB, dC
    in x's dtype, contiguous, the others fp32. Six CUDA launches, no
    atomics: the same inputs give the same bits. The kernels: by
    `bwd_on_hopper` (`backward_kernels`)."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    if h_prev.shape != (Bsz, nc, H, P, N) or h_prev.dtype != torch.float32 \
            or not h_prev.is_contiguous():
        raise ValueError(f"ssd_scan_bwd: h_prev must be ({Bsz}, {nc}, {H}, {P}, {N}) fp32 "
                         f"contiguous, got {tuple(h_prev.shape)} {h_prev.dtype}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dhT is not None and (dhT.shape != (Bsz, H, P, N) or dhT.dtype != torch.float32):
        raise ValueError(f"ssd_scan_bwd: dhT must be ({Bsz}, {H}, {P}, {N}) fp32, got "
                         f"{tuple(dhT.shape)} {dhT.dtype}")
    if any(t is not None and t.device != x.device for t in (h_prev, dy, dhT)):
        raise ValueError("ssd_scan_bwd: inputs must be on one device")
    dy = dy.contiguous()
    dhT = None if dhT is None else dhT.contiguous()
    dev, f32 = x.device, torch.float32
    # the backward sums dS and the state terms of dB and dC over each of G
    # groups of heads in one block, then over the groups in order
    G = min(H, 8)
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((Bsz, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dD = torch.empty_like(dA)
    # scratch: C.B^T per chunk, the head groups' parts of dS, L and L_Q, the
    # chunks' state gradients, the head groups' parts of the state terms of
    # dC and dB (and on the Hopper route the dS terms' part after them), the
    # per-chunk parts of dA and dD
    cb = torch.empty((Bsz, nc, Q, Q), dtype=f32, device=dev)
    dsp = torch.empty((Bsz, nc, G, Q, Q), dtype=f32, device=dev)
    cum = torch.empty((Bsz, nc, H, Q), dtype=f32, device=dev)
    lq = torch.empty((Bsz, nc, H), dtype=f32, device=dev)
    dstates = torch.empty((Bsz, nc, H, P, N), dtype=f32, device=dev)
    bcp = torch.empty((2, Bsz, nc, G + 1, Q, N), dtype=f32, device=dev)
    dA_part, dD_part = torch.empty_like(lq), torch.empty_like(lq)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()[1](x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    D.data_ptr(), h_prev.data_ptr(), dy.data_ptr(),
                    None if dhT is None else dhT.data_ptr(),
                    dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                    dC.data_ptr(), dD.data_ptr(), cb.data_ptr(), dsp.data_ptr(),
                    cum.data_ptr(), lq.data_ptr(), dstates.data_ptr(), bcp.data_ptr(),
                    dA_part.data_ptr(), dD_part.data_ptr(), Bsz, S, H, P, N, Q, G,
                    x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                    Cm.stride(0), Cm.stride(1), _copy_width(x, P), _copy_width(Bm, N),
                    _copy_width(Cm, N), _copy_width(dy, P), int(x.dtype == torch.bfloat16),
                    stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err}")
    _count(ssd_scan_bwd, x, Bm, chunk)
    return dx, ddt, dA, dB, dC, dD


ssd_scan.launches = 0
ssd_scan.launches_by_case = {}
ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_by_case = {}
