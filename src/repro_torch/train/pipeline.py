"""GPipe schedule over stage-stacked parameters (`repro.train.pipeline` for
the port).

The layer stack splits into S stages whose parameters are stacked along a
leading stage dim. The schedule runs M + S - 1 ticks: on each, stage 0's
buffer slot takes the next microbatch while one is left, `torch.func.vmap`
over the stage dim applies every stage to its slot, stage S-1's slot drains
into output t - (S-1), and the buffer rolls one slot (stage s -> s+1).
Autograd through the schedule gives the pipelined backward. The stage dim
stays on one device, as `repro`'s does without a `pipe` mesh axis.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def split_stages(layer_params: Dict[str, torch.Tensor], n_layers: int, n_stages: int
                 ) -> Dict[str, torch.Tensor]:
    """Stacked (L, ...) layer params -> (S, L/S, ...) stage-stacked params."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
    per = n_layers // n_stages
    return {k: a.reshape(n_stages, per, *a.shape[1:]) for k, a in layer_params.items()}


def gpipe(stage_params: Dict[str, torch.Tensor], x_mbs: torch.Tensor,
          stage_fn: Callable, n_stages: int) -> torch.Tensor:
    """Run the schedule: stage_params (S, L/S, ...), x_mbs (M, b, ...)
    microbatches, stage_fn(one stage's params, x) -> x. Returns (M, b, ...)
    in microbatch order."""
    M = x_mbs.shape[0]
    buf = x_mbs.new_zeros((n_stages,) + x_mbs.shape[1:])
    vstage = torch.func.vmap(stage_fn, in_dims=(0, 0))
    outs = []
    for t in range(M + n_stages - 1):
        if t < M:                                   # inject into stage 0's slot
            buf = torch.cat([x_mbs[t:t + 1], buf[1:]])
        buf = vstage(stage_params, buf)
        if t >= n_stages - 1:                       # stage S-1 finishes microbatch t-(S-1)
            outs.append(buf[n_stages - 1])
        buf = torch.roll(buf, shifts=1, dims=0)     # stage s's output -> stage s+1
    return torch.stack(outs)


def pipeline_apply(layer_params: Dict[str, torch.Tensor], x: torch.Tensor,
                   block_fn: Callable, n_layers: int, n_stages: int, microbatches: int
                   ) -> torch.Tensor:
    """Split a (B, ...) batch into microbatches, apply each stage's layers
    in order through `gpipe`, and restore batch order. block_fn(params_l,
    x) -> x is one layer; params_l holds layer l's slice of each tensor."""
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    stages = split_stages(layer_params, n_layers, n_stages)
    x_mbs = x.reshape(microbatches, B // microbatches, *x.shape[1:])

    def stage_fn(stage_p, xc):
        for layer in range(n_layers // n_stages):
            xc = block_fn({k: v[layer] for k, v in stage_p.items()}, xc)
        return xc

    return gpipe(stages, x_mbs, stage_fn, n_stages).reshape(B, *x.shape[1:])
