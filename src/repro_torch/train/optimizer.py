"""AdamW, global-norm clipping and the LR schedule of `repro.train.optimizer`
in torch, on dicts of tensors keyed by the model's parameter names.

Written as `repro` writes them, so a step gives `repro`'s numbers: the step
counter is int32 and the bias corrections `1 - b ** step` are fp32; the
update is `p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)` with weight decay
on every leaf (norms and the embedding included); the global norm adds the
leaves' sums of squares in `repro`'s tree-leaf order (sorted keys, a
stacked layer group as one leaf). Everything stays on the parameters'
device: no step reads a value back to the host. The moments and the
parameters are updated in place (`repro` returns new arrays).

Under a device mesh the parameters, gradients and moments are DTensors of
one layout per leaf: the global norm adds each rank's local sums of
squares (a replicated shard counted once) and reduces them over the whole
mesh in one collective; AdamW, elementwise, then acts on the local shards
(`to_local`). The step counter is the same plain tensor on every rank,
replicated as `opt_state_specs` says.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

Tree = Dict[str, torch.Tensor]


def _local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of a DTensor (its storage), or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _counted_once(t: DTensor) -> bool:
    """True on the one rank of each replica group of `t` that counts its
    shard: coordinate 0 along every mesh dim it is replicated over."""
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements) if isinstance(pl, Replicate))


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(c: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> learning rate (fp32 tensor): linear warmup, then
    cosine decay to `min_lr_ratio * peak_lr` at `total_steps`."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = c.peak_lr * torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - c.warmup_steps)
                           / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
        cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < c.warmup_steps, warm, c.peak_lr * cos)
    return fn


_LAYER = re.compile(r"\.(\d+)(?=\.|$)")


def leaf_order(names) -> List[List[str]]:
    """The parameter names grouped as `repro`'s tree leaves and ordered as
    `jax.tree.leaves` orders them: a name's first numeric component is its
    layer in a stacked group ("layers.3.attn.wq" is layer 3 of the leaf
    layers/attn/wq), leaves by their key paths, a leaf's layers in order."""
    leaves: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name in names:
        m = _LAYER.search(name)
        path = name if m is None else name[:m.start()] + name[m.end():]
        leaves.setdefault(tuple(path.split(".")), []).append(
            (-1 if m is None else int(m.group(1)), name))
    return [[n for _, n in sorted(leaves[p])] for p in sorted(leaves)]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, fp32, added leaf by leaf
    in `repro`'s order. DTensor leaves: each rank adds its shards' sums
    (a replicated shard on one rank of its group only), and one all-reduce
    over the mesh gives every rank the total, a plain 0-d tensor."""
    first = next(iter(tree.values()))
    if not isinstance(first, DTensor):
        total = 0
        for leaf in leaf_order(tree):
            total = total + sum(torch.sum(torch.square(tree[n].float())) for n in leaf)
        return torch.sqrt(total)
    total = torch.zeros((), dtype=torch.float32, device=_local(first).device)
    for leaf in leaf_order(tree):
        for n in leaf:
            if _counted_once(tree[n]):
                total = total + torch.sum(torch.square(_local(tree[n]).float()))
    mesh = first.device_mesh
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim).full_tensor()
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """(tree scaled so its global norm is at most max_norm, the norm before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    names = list(tree)
    scaled = torch._foreach_mul([tree[n].float() for n in names], scale)
    return {n: s.to(tree[n].dtype) for n, s in zip(names, scaled)}, norm


def init_opt_state(params: Tree) -> Dict:
    """{"step": int32 0, "m": zeros, "v": zeros}, the moments fp32 on each
    parameter's device (DTensors of the parameter's layout under a mesh)."""
    dev = next(iter(params.values())).device
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                for n, p in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32, device=dev), "m": zeros(),
            "v": zeros()}


def _groups(names: List[str], tree: Tree, cap: int) -> List[List[str]]:
    """`names` in order, cut into runs of at most `cap` entries (a larger
    leaf is a run of its own)."""
    out, size = [[]], 0
    for n in names:
        numel = _local(tree[n]).numel()
        if out[-1] and size + numel > cap:
            out.append([])
            size = 0
        out[-1].append(n)
        size += numel
    return out


# entries per run of adamw_update's foreach ops: each run's temporaries
# (four fp32 copies at most) stay near 4 GB, so a model whose parameters,
# gradients and moments fill most of the card still steps
GROUP_ENTRIES = 1 << 28


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, opt_state: Dict, c: AdamWConfig
                 ) -> Tuple[Tree, Dict, Dict]:
    """One AdamW step, in place on `params` and the moments. Returns
    (params, opt_state, {"lr", "grad_norm"}) with the metrics as 0-d device
    tensors. The clipped gradients and the update are formed over runs of
    at most GROUP_ENTRIES entries: the same arithmetic per entry, with
    temporaries bounded by a run instead of the whole model. DTensor
    leaves are updated through their local shards (the gradients must have
    their parameters' placements)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = _local(opt_state["step"]) + 1
    lr = lr_schedule(c)(step)
    b1, b2 = c.b1, c.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    for names in _groups(list(params), params, GROUP_ENTRIES):
        p = [_local(params[n]) for n in names]
        # clip_by_global_norm's scaling, in the gradient's dtype, then fp32
        gl = [_local(grads[n]) for n in names]
        g = [x.to(y.dtype).float() for x, y in zip(
            torch._foreach_mul([y.float() for y in gl], scale), gl)]
        del gl
        m = [_local(opt_state["m"][n]) for n in names]
        v = [_local(opt_state["v"][n]) for n in names]
        pf = [x.float() for x in p]
        # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        del g
        # p - lr (mhat / (sqrt(vhat) + eps) + wd p)
        upd = torch._foreach_div(torch._foreach_div(m, bc1),
                                 torch._foreach_add(torch._foreach_sqrt(
                                     torch._foreach_div(v, bc2)), c.eps))
        torch._foreach_add_(upd, torch._foreach_mul(pf, c.weight_decay))
        torch._foreach_mul_(upd, lr)
        new = torch._foreach_sub(pf, upd)
        for x, y in zip(p, new):
            x.copy_(y)
    if isinstance(opt_state["step"], DTensor):
        step = DTensor.from_local(step, opt_state["step"].device_mesh,
                                  opt_state["step"].placements)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
