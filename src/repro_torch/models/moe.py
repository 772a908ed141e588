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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense_init_
from repro_torch.models.runtime import Runtime


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
    T = ht.shape[0]
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    logits = (ht @ p.router.to(rt.compute_dtype)).float()
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


def moe_mlp(h: torch.Tensor, p: MoE, cfg: ModelConfig, rt: Runtime
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, D) -> (out (B, S, D), aux loss, a () fp32 tensor)."""
    B, S, D = h.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    ht = h.reshape(T, D)
    r = route(ht, p, cfg, rt)
    C = r.capacity
    if C < T:
        moe_mlp.dropped = moe_mlp.dropped + (~r.keep).sum()

    # dispatch into (E, C+1, D); slot C is the trash row
    buf = torch.zeros((E, C + 1, D), dtype=rt.compute_dtype, device=h.device)
    buf[r.flat_e, r.slot] = ht.repeat_interleave(K, dim=0).to(rt.compute_dtype)
    xin = buf[:, :C]

    f = act_fn(cfg.act)
    wi, wo = p.wi.to(rt.compute_dtype), p.wo.to(rt.compute_dtype)
    if cfg.glu:
        wg = p.wg.to(rt.compute_dtype)
        u = f(torch.einsum("ecd,edf->ecf", xin, wg)) * torch.einsum("ecd,edf->ecf", xin, wi)
    else:
        u = f(torch.einsum("ecd,edf->ecf", xin, wi))
    eout = torch.einsum("ecf,efd->ecd", u, wo)

    # combine: gather each (token, choice) back (trash row = 0) and weight
    eout_pad = torch.cat([eout, eout.new_zeros(E, 1, D)], dim=1)
    gathered = eout_pad[r.flat_e, r.slot]
    w = (r.top_w.reshape(T * K) * r.keep).to(rt.compute_dtype)
    out = (gathered * w[:, None]).reshape(T, K, D).sum(1)
    return out.reshape(B, S, D), r.aux


moe_mlp.dropped = 0
