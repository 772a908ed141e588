"""Top-k MoE layer, Mixtral/Grok style, with GShard-style capacity dispatch
(port of `repro.models.moe`).

Each (token, choice) pair is written into a (E, C+1, D) buffer in the
compute dtype, at its slot in its expert's queue (token-major order); pairs
past the capacity C go to the trash slot C and are dropped. The expert FFNs
run as batched products over the expert dim, and the outputs are gathered
back and weighted by the renormalised router weights. The batched products
are `torch.einsum` (repro leaves them to XLA; no Pallas kernel is involved).

`moe_mlp.dropped` counts the (token, choice) pairs that the capacity
dropped, summed over calls. A call with C = T drops nothing and leaves it
alone; any other adds a () tensor on its device, which costs one reduction
and no host sync.

Under a mesh the routing is global, as under `repro`'s GSPMD: the tokens
are gathered on every rank, each computes the same router, top-k, capacity
slots, dispatch buffer and combine on local tensors (`local_map`, all
replicated: DTensor has no rule for the slot cumsum's scatter), and
`moe_mlp.dropped` counts once per mesh, on its first rank, so the drops
equal the unsharded run's. The buffer's (E, C, D) slice takes
`rt.moe_buf_spec` (`repro`'s P(None, dp, None): capacity over the data
axes) and the expert products run on DTensors against `repro`'s expert
layout (experts over "model" when they divide it).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import PartitionSpec as P, to_placements
from repro_torch.models.layers import act_fn, dense_init_
from repro_torch.models.runtime import Runtime, constrain, weight


class MoE(nn.Module):
    """router (D, E), wi / wg (E, D, F), wo (E, F, D); wg only when `cfg.glu`."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        kw = {"device": device, "dtype": dtype}
        self.router = nn.Parameter(torch.empty(D, E, **kw))
        self.wi = nn.Parameter(torch.empty(E, D, Fd, **kw))
        self.wo = nn.Parameter(torch.empty(E, Fd, D, **kw))
        self.wg = nn.Parameter(torch.empty(E, D, Fd, **kw)) if cfg.glu else None

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for w in (self.router, self.wi, self.wo, self.wg):
            if w is not None:
                dense_init_(w, g)


class Routing(NamedTuple):
    probs: torch.Tensor       # (T, E) fp32 router softmax
    top_w: torch.Tensor       # (T, K) fp32, renormalised
    flat_e: torch.Tensor      # (T*K,) expert of each (token, choice), token-major
    slot: torch.Tensor        # (T*K,) slot in that expert's queue; C = dropped
    keep: torch.Tensor        # (T*K,) bool, slot < C
    capacity: int             # C
    aux: torch.Tensor         # () fp32 Switch load-balancing loss


def route(ht: torch.Tensor, p: MoE, cfg: ModelConfig, rt: Runtime) -> Routing:
    """Router, top-k, aux loss and each (token, choice)'s slot. ht (T, D)."""
    return _route(ht, p.router, cfg, rt)


def _route(ht: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, rt: Runtime) -> Routing:
    T = ht.shape[0]
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    logits = (ht @ router.to(rt.compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load balancing on the top-1 choice
    aux = E * torch.sum(probs.mean(0) * F.one_hot(top_i[:, 0], E).float().mean(0))
    # slots per expert; T when T <= 256, so short calls (decode steps) drop nothing
    C = T if T <= 256 else min(max(1, int(cfg.moe.capacity_factor * K * T / E)), T)
    flat_e = top_i.reshape(T * K)
    onehot = F.one_hot(flat_e, E)
    before = torch.cumsum(onehot, dim=0) - onehot          # earlier pairs per expert
    pos = before.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, pos, C)
    return Routing(probs, top_w, flat_e, slot, keep, C, aux)


def _experts(xin: torch.Tensor, p: MoE, cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    """The expert FFNs as batched products: (E, C, D) -> (E, C, D)."""
    f = act_fn(cfg.act)
    wi, wo = weight(p.wi, rt), weight(p.wo, rt)
    if cfg.glu:
        wg = weight(p.wg, rt)
        u = f(torch.einsum("ecd,edf->ecf", xin, wg)) * torch.einsum("ecd,edf->ecf", xin, wi)
    else:
        u = f(torch.einsum("ecd,edf->ecf", xin, wi))
    return torch.einsum("ecf,efd->ecd", u, wo)


def _dispatch(ht, flat_e, slot, E: int, C: int, K: int, dtype):
    """(T, D) tokens into the (E, C+1, D) buffer; slot C is the trash row."""
    buf = torch.zeros((E, C + 1, ht.shape[1]), dtype=dtype, device=ht.device)
    buf[flat_e, slot] = ht.repeat_interleave(K, dim=0).to(dtype)
    return buf


def _combine(eout, flat_e, slot, top_w, keep, K: int, dtype):
    """Gather each (token, choice) back (trash row = 0) and weight: (T, D)."""
    E, _, D = eout.shape
    eout_pad = torch.cat([eout, eout.new_zeros(E, 1, D)], dim=1)
    gathered = eout_pad[flat_e, slot]
    w = (top_w.reshape(-1) * keep).to(dtype)
    return (gathered * w[:, None]).reshape(-1, K, D).sum(1)


def _moe_mlp_mesh(h: torch.Tensor, p: MoE, cfg: ModelConfig, rt: Runtime):
    """moe_mlp on DTensors (see the module docstring)."""
    B, S, D = h.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    mesh = rt.mesh
    rep = {n: list(to_placements(mesh, P(*([None] * n)))) for n in range(4)}  # replicated, n-d
    ht = constrain(h.reshape(B * S, D), rt, P(None, None))        # every token on every rank
    router = constrain(p.router, rt, P(None, None))
    r = local_map(lambda x, w: tuple(_route(x, w, cfg, rt)),
                  out_placements=(rep[2], rep[2], rep[1], rep[1], rep[1], None, rep[0]),
                  in_placements=(rep[2], rep[2]), device_mesh=mesh)(ht, router)
    r = Routing(*r)
    C = r.capacity
    if C < B * S and all(c == 0 for c in mesh.get_coordinate()):
        moe_mlp.dropped = moe_mlp.dropped + (~r.keep.to_local()).sum()
    buf = local_map(lambda x, e, s: _dispatch(x, e, s, E, C, K, rt.compute_dtype),
                    out_placements=rep[3], in_placements=(rep[2], rep[1], rep[1]),
                    device_mesh=mesh)(ht, r.flat_e, r.slot)
    xin = constrain(buf[:, :C], rt, rt.moe_buf_spec)
    eout = constrain(_experts(xin, p, cfg, rt), rt, P(None, None, None))
    out = local_map(lambda y, e, s, w, k: _combine(y, e, s, w, k, K, rt.compute_dtype),
                    out_placements=rep[2], in_placements=(rep[3], rep[1], rep[1], rep[2], rep[1]),
                    device_mesh=mesh)(eout, r.flat_e, r.slot, r.top_w, r.keep)
    return out.reshape(B, S, D), r.aux


def moe_mlp(h: torch.Tensor, p: MoE, cfg: ModelConfig, rt: Runtime
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, D) -> (out (B, S, D), aux loss, a () fp32 tensor)."""
    if rt.mesh is not None:
        return _moe_mlp_mesh(h, p, cfg, rt)
    B, S, D = h.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    ht = h.reshape(T, D)
    r = route(ht, p, cfg, rt)
    C = r.capacity
    if C < T:
        moe_mlp.dropped = moe_mlp.dropped + (~r.keep).sum()

    buf = _dispatch(ht, r.flat_e, r.slot, E, C, K, rt.compute_dtype)
    eout = _experts(buf[:, :C], p, cfg, rt)
    out = _combine(eout, r.flat_e, r.slot, r.top_w, r.keep, K, rt.compute_dtype)
    return out.reshape(B, S, D), r.aux


moe_mlp.dropped = 0
