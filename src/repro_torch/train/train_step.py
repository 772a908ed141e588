"""Train-step factory of the port (`repro.train.train_step`): microbatched
gradient accumulation and AdamW.

`make_train_step(...)` returns `train_step(model, opt_state, batch) ->
(model, opt_state, metrics)`. The model's parameters are the trained state:
the step turns on their requires_grad, takes the gradients of `loss_fn` by
autograd, and updates them in place under no_grad (`repro`'s step is a pure
function of a param tree). `batch` holds "tokens" and "labels" (B, S) on the
model's device; metrics are 0-d device tensors, so a step does not wait for
the card.

Under a device mesh (`rt.mesh`) the parameters and the batch are DTensors;
each gradient is redistributed to its parameter's placements (the data
axes' all-reduce or reduce-scatter), microbatch gradients are summed as
such DTensors in `grad_acc_dtype`, and AdamW updates the local shards. The
metrics come back as plain 0-d tensors, the same on every rank.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, loss_fn
from repro_torch.models.runtime import Runtime, mesh_ops
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _split_microbatches(batch: Dict, n_mb: int):
    """Microbatch i holds rows [i B/n, (i+1) B/n) of every entry (a DTensor
    entry keeps its placements)."""
    B = next(iter(batch.values())).shape[0]
    if B % n_mb:
        raise ValueError(f"batch {B} does not split into {n_mb} microbatches")

    def rows(x, i):
        mb = x[i * (B // n_mb):(i + 1) * (B // n_mb)]
        return mb.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else mb
    return [{k: rows(x, i) for k, x in batch.items()} for i in range(n_mb)]


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _plain_device(t: torch.Tensor) -> torch.device:
    return t.to_local().device if isinstance(t, DTensor) else t.device


def make_train_step(
    cfg: ModelConfig,
    rt: Runtime,
    opt: AdamWConfig,
    microbatches: int = 1,
    grad_transform: Optional[Callable] = None,
) -> Callable:
    """grad_transform: optional fn(grads) -> grads (a dict keyed by parameter
    name) applied before the update. With microbatches > 1 the gradients are
    summed in `rt.grad_acc_dtype`, and loss and gradients are divided by the
    count, as in `repro`."""

    def train_step(model: Model, opt_state: Dict, batch: Dict
                   ) -> Tuple[Model, Dict, Dict]:
        params = dict(model.named_parameters())
        leaves = list(params.values())
        if not all(p.requires_grad for p in leaves):
            model.requires_grad_(True)

        def grads_of(mb):
            with mesh_ops(rt):
                loss, _ = loss_fn(model, mb)
                grads = torch.autograd.grad(loss, leaves)
            if rt.mesh is not None:     # the data axes' gradient reduction
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for g, p in zip(grads, leaves)]
            return _plain(loss.detach()), grads

        if microbatches > 1:
            gsum = [torch.zeros_like(p, dtype=rt.grad_acc_dtype,
                                     memory_format=torch.contiguous_format)
                    for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=_plain_device(leaves[0]))
            for mb in _split_microbatches(batch, microbatches):
                loss, grads = grads_of(mb)
                gsum = [a + g.to(rt.grad_acc_dtype) for a, g in zip(gsum, grads)]
                lsum = lsum + loss
            grads = [g.float() / microbatches for g in gsum]
            loss = lsum / microbatches
        else:
            loss, grads = grads_of(batch)
        grads = dict(zip(params, grads))
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, om = adamw_update(params, grads, opt_state, opt)
        return model, opt_state, {"loss": loss, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, rt: Runtime) -> Callable:
    @torch.no_grad()
    def eval_step(model: Model, batch: Dict) -> Dict:
        with mesh_ops(rt):
            loss, metrics = loss_fn(model, batch)
        return {k: _plain(v) for k, v in {"loss": loss, **metrics}.items()}
    return eval_step


@functools.lru_cache(maxsize=None)
def default_microbatches(arch_name: str, seq_len: int, global_batch: int) -> int:
    """`repro`'s per-cell grad-accumulation defaults (sized there for a TPU
    v5e's memory by its dry-run analysis), kept so the two launchers agree."""
    big = {"grok-1-314b": 8, "qwen1.5-32b": 8, "mixtral-8x7b": 8,
           "gemma3-4b": 4, "paligemma-3b": 4}
    return big.get(arch_name, 2 if global_batch >= 256 else 1)
