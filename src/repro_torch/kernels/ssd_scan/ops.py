"""Public SSD entry points. A CUDA tensor always goes to the hand-written
kernels (which launch or raise): the forward kernel, and the backward
kernels when autograd asks for gradients (`SSDScanFn`). A CPU tensor goes
to the plain chunked version, and to the plain backward under autograd.
There is no switch and no fallback between the two."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd_scan.ref import (
    ssd_chunked_bwd_ref,
    ssd_chunked_ref,
    ssd_decode_step_ref,
)


class SSDScanFn(torch.autograd.Function):
    """K2 under autograd. The forward keeps the state entering each chunk
    and the backward takes it with the gradients of y and of the final
    state. By device, a fixed rule: a CUDA tensor gets the kernels
    (`ssd_scan(return_states=True)`, `ssd_scan_bwd`), a CPU tensor the plain
    pair (`ssd_chunked_ref(return_states=True)`, `ssd_chunked_bwd_ref`),
    the pair the kernels are held against."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)      # an unused final state costs nothing
        fwd = ssd_chunked_ref if x.device.type == "cpu" else ssd_scan
        y, hT, h_prev = fwd(x, dt, A, Bm, Cm, D, chunk=chunk, return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h_prev)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        ins = ctx.saved_tensors
        x, h_prev = ins[0], ins[6]
        if dy is None:
            dy = torch.zeros_like(x)
        bwd = ssd_chunked_bwd_ref if x.device.type == "cpu" else ssd_scan_bwd
        grads = bwd(*ins[:6], h_prev, dy, dhT, chunk=ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, ins)), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B,S,H,P) in x's dtype and the final state (B,H,P,N) fp32; through
    `SSDScanFn` when grad mode is on and an input needs a gradient."""
    if x.device.type != "cpu":
        # x, Bm, Cm go in as they are (the kernels read strided views)
        dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, D, chunk)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    return ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)


ssd_decode_step = ssd_decode_step_ref
