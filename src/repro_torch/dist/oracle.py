"""Strategy-shardability oracle backed by the sharding rule engine (the
port of `repro.dist.oracle`).

Joint (strategy, architecture) exploration proposes parallelization
strategies directly, so something has to answer "could this strategy
actually be *instantiated* on the runtime?" before the analytical
evaluator spends a step-model pass on it. This module answers with the
production sharding rules themselves (`repro_torch.dist.sharding`): a
proposed (tp, dp, ep) is feasible iff `param_specs` / `batch_specs` lay the
model out on a ("data", "model") = (dp, tp) mesh without leaving a mesh
axis dead —

  * `batch_specs` must shard the global batch over the full "data" axis
    (dp > batch, or dp not dividing it, wastes the axis: infeasible);
  * `param_specs` must consume the "model" axis in at least one weight
    when tp > 1 (a tp wider than every shardable dim is dead silicon);
  * ep > 1 requires expert weights whose E dim the expert axis divides.

DSE workloads (`LLMWorkload`) are not registered runtime configs, so the
oracle synthesizes a same-shape `ModelConfig` (dense or MoE). Where `repro`
takes the parameter shapes from `jax.eval_shape(init_params)`, the port
builds its `Model` on the meta device (no storage, no init) and lays the
shapes out in `repro`'s stacked tree (`param_shapes`, the layout
`models/convert.py` documents). The shape tree and every verdict are
memoized (workloads, configs and strategies are frozen/hashable).

The mesh passed to the rule engine is a duck-typed shim: only `.shape` (a
mapping) and `.axis_names` are read.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple, Union

from repro_torch.configs import ModelConfig, MoEConfig
from repro_torch.dist import sharding as sh


class ShimMesh:
    """Duck-typed mesh: only `.shape` (mapping) and `.axis_names` are
    read by the spec rules — no devices are built."""

    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)


@functools.lru_cache(maxsize=256)
def model_config_for_workload(wl) -> ModelConfig:
    """Synthesize the runtime `ModelConfig` matching an `LLMWorkload`'s
    shape (dense or MoE decoder): the oracle and `export_train_config`
    both need a config the model code accepts."""
    moe = None
    if getattr(wl, "moe_experts", 0):
        moe = MoEConfig(num_experts=wl.moe_experts,
                        top_k=max(wl.moe_topk, 1))
    return ModelConfig(
        name=f"dse-{wl.name}",
        family="moe" if moe is not None else "dense",
        num_layers=wl.n_layers,
        d_model=wl.d_model,
        n_heads=wl.n_heads,
        n_kv=wl.n_kv,
        d_ff=wl.d_ff,
        vocab=wl.vocab,
        moe=moe,
    )


@functools.lru_cache(maxsize=64)
def param_shapes(cfg: ModelConfig) -> Dict:
    """`repro`'s `init_params` tree for `cfg`, shapes only: the port's
    `Model` built on the meta device, each stacked layer group's per-layer
    parameters put back under one leaf with the layer axis first, as
    `models.convert.params_to_jax` does with values. Leaves are
    `sharding.ShapeStruct`."""
    from repro_torch.models.convert import _stacked_groups
    from repro_torch.models.model import Model
    from repro_torch.models.runtime import Runtime

    model = Model(cfg, Runtime(device="meta"))
    groups = _stacked_groups(cfg)
    tree: Dict = {}
    for key, p in model.named_parameters():
        group = next((g for g in groups if key.startswith(g + ".")), None)
        if group is None:
            path, shape = key, tuple(p.shape)
        else:
            _, name = key[len(group) + 1:].split(".", 1)
            path, shape = f"{group}.{name}", (groups[group],) + tuple(p.shape)
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = sh.ShapeStruct(shape)
    return tree


def _spec_axes(spec) -> set:
    out = set()
    for entry in spec:
        if entry is None:
            continue
        out.update((entry,) if isinstance(entry, str) else entry)
    return out


@functools.lru_cache(maxsize=4096)
def check_strategy(cfg_or_wl, tp: int, dp: int, ep: int = 1,
                   batch: int = 1, seq: int = 1) -> Tuple[bool, str]:
    """Shardability verdict for (tp, dp, ep) on `cfg_or_wl` (a
    `ModelConfig` or an `LLMWorkload`). Returns (ok, reason); reason is
    "" on success, else the first failing check:

        "ep_experts"  ep does not divide the expert count (or no experts)
        "dp_batch"    the "data" axis cannot shard the global batch
        "tp_dead"     tp > 1 but no weight consumes the "model" axis
    """
    cfg = (cfg_or_wl if isinstance(cfg_or_wl, ModelConfig)
           else model_config_for_workload(cfg_or_wl))

    n_exp = cfg.moe.num_experts if cfg.moe is not None else 0
    if ep > 1 and (n_exp == 0 or n_exp % ep != 0):
        return False, "ep_experts"

    mesh = ShimMesh({"data": int(dp), "model": int(tp)})

    if dp > 1:
        b_sds = sh.ShapeStruct((int(batch), int(seq)))
        b_spec = sh.batch_specs(mesh, {"tokens": b_sds})["tokens"]
        if "data" not in _spec_axes(b_spec):
            return False, "dp_batch"

    if tp > 1:
        specs = sh.param_specs(mesh, param_shapes(cfg))
        if not any("model" in _spec_axes(s) for s in sh.tree_leaves(specs)):
            return False, "tp_dead"

    return True, ""


def strategy_shardable(wl, strategy,
                       cfg: Union[ModelConfig, None] = None
                       ) -> Tuple[bool, str]:
    """Oracle entry point for a `Strategy` against a workload: checks the
    (tp, dp, ep) mesh layout with the workload's global batch/seq. `cfg`
    overrides the synthesized config (used when the workload came from a
    registered arch)."""
    return check_strategy(cfg if cfg is not None else wl,
                          strategy.tp, strategy.dp, strategy.ep,
                          batch=wl.batch, seq=wl.seq)


__all__ = ["ShimMesh", "check_strategy", "model_config_for_workload",
           "param_shapes", "strategy_shardable"]
