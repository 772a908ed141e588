"""Mamba-2 (SSD) block: in_proj -> causal depthwise conv -> SSD -> gated norm
-> out_proj. Full-sequence forward and prefill run the SSD scan through
`ssd_ops.ssd` (the CUDA kernel on the card); decode runs the single-token
recurrence. [arXiv:2405.21060]

Weights keep `repro`'s layout: in_proj is (D, 2*di + 2*N + H) with packed
columns [z | x | B | C | dt], out_proj is (di, D), conv_w is (K, di + 2*N).

Under a mesh `repro`'s rules shard in_proj's packed columns over "model",
across the pack's boundaries, and DTensor would gather each piece the
split cuts. So the packed projection is gathered over "model" once
(batch over the data axes kept), the conv runs on it with its weights
gathered, and z, [x | B | C] and dt are split views of it; x's heads then
take `_constrain_heads` (`opt_ssm_head_tp`: heads over "model", a local
slice with no collective) and K2 runs on each rank's heads
(`ssd_ops.ssd` through `local_map`, B and C replicated).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import (
    causal_depthwise_conv,
    dense_init_,
    gated_rmsnorm,
    rmsnorm,
)
from repro_torch.models.runtime import (
    Runtime,
    batch_axes,
    constrain,
    keep_layout,
    residual,
    weight,
)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.head_dim, s.state_dim


def heads_spec(shape, rt: Runtime):
    """`repro`'s `_constrain_heads` rule for xh (B, S, H, P) (or a 3-d
    (B, S, H)): SSD heads over "model" when H divides it, batch over the
    data axes when B divides them. None without `mesh_axes` or with
    `opt_ssm_head_tp` off."""
    if rt.mesh_axes is None or not rt.opt_ssm_head_tp:
        return None
    model = rt.mesh_axes.get("model", 1)
    B, _, H = shape[:3]
    head_axes = "model" if (model > 1 and H % model == 0) else None
    batch = batch_axes(B, rt)
    return P(batch, None, head_axes, None) if len(shape) == 4 else P(batch, None, head_axes)


def _constrain_heads(xh: torch.Tensor, rt: Runtime) -> torch.Tensor:
    return constrain(xh, rt, heads_spec(xh.shape, rt))


def _replicated(w: torch.Tensor, rt: Runtime) -> torch.Tensor:
    return constrain(w, rt, P(*([None] * w.dim())))


def _conv_mesh(x, w, b, state):
    """The causal conv on each rank's rows (`local_map`): x (B, S, C) is
    sharded on its batch at most, the weights replicated; their gradients
    are partial sums over the data axes that shard x."""
    w_pl = w.placements
    grad_pl = tuple(Partial() if xp.is_shard() else wp for xp, wp in zip(x.placements, w_pl))
    ins = (x.placements, w_pl, w_pl) + ((state.placements,) if state is not None else ())
    grads = (x.placements, grad_pl, grad_pl) + ((state.placements,) if state is not None else ())
    return local_map(lambda x_, w_, b_, *s_: causal_depthwise_conv(x_, w_, b_, *s_),
                     out_placements=list(x.placements), in_placements=ins,
                     in_grad_placements=grads, device_mesh=x.device_mesh)(
        x, w, b, *((state,) if state is not None else ()))


class SSMBlock(nn.Module):
    """One Mamba-2 layer; parameters in `param_dtype` on `device`."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        s, di, H, P, N = _dims(cfg)
        D = cfg.d_model
        conv_ch = di + 2 * N
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.ln = nn.Parameter(torch.zeros(D, **kw))
        self.in_proj = nn.Parameter(torch.empty(D, 2 * di + 2 * N + H, **kw))
        self.conv_w = nn.Parameter(torch.empty(s.conv_width, conv_ch, **kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, **kw))
        self.A_log = nn.Parameter(torch.empty(H, **kw))
        self.D = nn.Parameter(torch.ones(H, **kw))
        self.dt_bias = nn.Parameter(torch.empty(H, **kw))
        self.norm = nn.Parameter(torch.zeros(di, **kw))
        self.out_proj = nn.Parameter(torch.empty(di, D, **kw))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        """`repro`'s init_ssm_block recipe (the numbers differ: another RNG)."""
        H = self.A_log.shape[0]
        dense_init_(self.in_proj, g)
        dense_init_(self.conv_w, g, scale=0.3)
        dense_init_(self.out_proj, g)
        self.ln.zero_()
        self.conv_b.zero_()
        self.norm.zero_()
        self.D.fill_(1.0)
        self.A_log.copy_(torch.log(torch.arange(1, H + 1, dtype=torch.float32)))
        self.dt_bias.fill_(math.log(math.expm1(0.01)))

    # -- shared pieces ------------------------------------------------------

    def _in(self, x: torch.Tensor, rt: Runtime):
        """norm + in_proj; returns z, the conv input [x | B | C] and dt."""
        _, di, H, _, N = _dims(self.cfg)
        h = rmsnorm(x, self.ln, self.cfg.norm_eps)
        proj = h @ weight(self.in_proj, rt)
        if rt.mesh is not None:     # the packed columns, whole on each rank
            proj = constrain(proj, rt, P(batch_axes(x.shape[0], rt), None, None))
        return proj.split([di, di + 2 * N, H], dim=-1)

    def _conv(self, conv_in, rt: Runtime, state=None):
        if rt.mesh is None:
            return causal_depthwise_conv(conv_in, self.conv_w, self.conv_b, state=state)
        return _conv_mesh(conv_in, _replicated(self.conv_w, rt), _replicated(self.conv_b, rt),
                          state)

    def _ssd_args(self, conv_out: torch.Tensor, dt: torch.Tensor):
        _, di, H, P, N = _dims(self.cfg)
        xs, Bm, Cm = conv_out.split([di, N, N], dim=-1)
        dtv = F.softplus(dt.float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())
        return xs.unflatten(-1, (H, P)), dtv, A, Bm, Cm

    def _out(self, x, y, z, rt: Runtime):
        y = gated_rmsnorm(keep_layout(y.flatten(-2)), z, self.norm, self.cfg.norm_eps)
        return residual(x + y @ weight(self.out_proj, rt), rt)

    # -- paths --------------------------------------------------------------

    def forward(self, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
        """Full sequence. x (B, S, D) -> (B, S, D), residual added."""
        z, conv_in, dt = self._in(x, rt)
        conv_out = self._conv(conv_in, rt)
        xh, dtv, A, Bm, Cm = self._ssd_args(conv_out, dt)
        y, _ = ssd_ops.ssd(_constrain_heads(xh, rt), dtv, A, Bm, Cm, self.D,
                           chunk=rt.ssd_chunk)
        return self._out(x, y, z, rt)

    def prefill(self, x: torch.Tensor, rt: Runtime, conv_state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full sequence that also returns the decode cache: the conv tail
        (B, K-1, C) and the final SSD state (B, H, P, N)."""
        K = self.cfg.ssm.conv_width
        S = x.shape[1]
        z, conv_in, dt = self._in(x, rt)
        conv_out = self._conv(conv_in, rt)
        if S >= K - 1:
            new_conv = conv_in[:, S - (K - 1):].to(rt.compute_dtype)
        else:   # prompt shorter than the conv tail: keep the older entries
            new_conv = torch.cat([conv_state[:, S:], conv_in.to(rt.compute_dtype)], 1)
        xh, dtv, A, Bm, Cm = self._ssd_args(conv_out, dt)
        y, hT = ssd_ops.ssd(_constrain_heads(xh, rt), dtv, A, Bm, Cm, self.D,
                            chunk=rt.ssd_chunk)
        return self._out(x, y, z, rt), new_conv, hT

    def decode(self, x: torch.Tensor, rt: Runtime, conv_state: torch.Tensor,
               ssd_state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One token. x (B, 1, D); returns (out, new conv tail, new state)."""
        z, conv_in, dt = self._in(x, rt)
        conv_out = self._conv(conv_in, rt, state=conv_state)
        new_conv = torch.cat([conv_state[:, 1:], conv_in], dim=1)
        xh, dtv, A, Bm, Cm = self._ssd_args(conv_out, dt)
        y, new_state = ssd_ops.ssd_decode_step(
            ssd_state, xh[:, 0], dtv[:, 0], A, Bm[:, 0], Cm[:, 0], self.D)
        return self._out(x, y[:, None], z, rt), new_conv, new_state


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, rt: Runtime) -> dict:
    s, di, H, P, N = _dims(cfg)
    dev = rt.torch_device()
    return {
        "conv": torch.zeros(n_layers, batch, s.conv_width - 1, di + 2 * N,
                            dtype=rt.compute_dtype, device=dev),
        "ssd": torch.zeros(n_layers, batch, H, P, N, dtype=torch.float32, device=dev),
    }
