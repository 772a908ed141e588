"""Public SSD entry points. A CUDA tensor always goes to the hand-written
kernels (which launch or raise): the forward kernel, and the backward
kernels when autograd asks for gradients (`SSDScanFn`). A CPU tensor goes
to the plain chunked version, and to the plain backward under autograd.
There is no switch and no fallback between the two.

Under a device mesh (DTensor inputs) the scan runs on each rank's local
shard through `local_map`: each head's (P, N) recurrence is independent,
so x (B, S, H, P), dt (B, S, H), A and D (H,) are laid out with their heads
over "model" when H divides it and the batch over the data axes when it
divides them (`kernel_spec`); B and C (B, S, N) are shared by every head
and replicated over "model". The gradients of B and C are then partial
sums over "model" (each rank's heads), those of A and D over the data
axes, and `local_map` hands them back as such."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist.sharding import PartitionSpec as P, batch_entry, mesh_axes, to_placements
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


def kernel_spec(mesh, x_shape):
    """The PartitionSpec of x (B, S, H, P) that K2 runs on under `mesh`:
    heads over "model" when H divides it, batch over the data axes when B
    divides them."""
    axes = mesh_axes(mesh)
    model = axes.get("model", 1)
    B, _, H, _ = x_shape
    batch = batch_entry(axes, B)
    heads = "model" if model > 1 and H % model == 0 else None
    return P(batch, None, heads, None)


def _ssd_mesh(x, dt, A, Bm, Cm, D, chunk):
    """ssd on DTensors: each rank's scan on its heads and batch rows."""
    mesh = x.device_mesh
    b, _, h, _ = kernel_spec(mesh, x.shape)
    pl = {"x": to_placements(mesh, P(b, None, h, None)), "dt": to_placements(mesh, P(b, None, h)),
          "h": to_placements(mesh, P(h)), "bc": to_placements(mesh, P(b, None, None)),
          "state": to_placements(mesh, P(b, h, None, None))}
    x, dt, Bm, Cm = (t.redistribute(mesh, pl[k]) for t, k in
                     ((x, "x"), (dt, "dt"), (Bm, "bc"), (Cm, "bc")))
    A, D = (t.redistribute(mesh, pl["h"]) for t in (A, D))
    names = mesh.mesh_dim_names
    # a replicated input meets sharded work: its gradient is a partial sum
    heads_dim = names.index("model") if h is not None else None
    bc_grad = tuple(Partial() if i == heads_dim else q for i, q in enumerate(pl["bc"]))
    h_grad = tuple(Partial() if q.is_replicate() and pl["x"][i].is_shard(0) else q
                   for i, q in enumerate(pl["h"]))

    def local(x_, dt_, A_, B_, C_, D_):
        return ssd(x_, dt_, A_, B_, C_, D_, chunk=chunk)
    ins = (pl["x"], pl["dt"], pl["h"], pl["bc"], pl["bc"], pl["h"])
    return local_map(local, out_placements=(list(pl["x"]), list(pl["state"])), in_placements=ins,
                     in_grad_placements=(pl["x"], pl["dt"], h_grad, bc_grad, bc_grad, h_grad),
                     device_mesh=mesh)(x, dt, A, Bm, Cm, D)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B,S,H,P) in x's dtype and the final state (B,H,P,N) fp32; through
    `SSDScanFn` when grad mode is on and an input needs a gradient;
    on DTensors through `_ssd_mesh`."""
    if isinstance(x, DTensor):
        return _ssd_mesh(x, dt, A, Bm, Cm, D, chunk)
    if x.device.type != "cpu":
        # x, Bm, Cm go in as they are (the kernels read strided views)
        dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, D, chunk)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    return ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)


ssd_decode_step = ssd_decode_step_ref
