"""Carry weights from the JAX package into the port.

`repro`'s params are a nested dict. The layer groups (`layers` for the
dense, MoE, SSM and VLM families, `enc_layers` and `dec_layers` for encdec,
`layers.ssm_layers` for the hybrid) hold their leaves stacked on axis 0, one
entry per layer, possibly under sub-dicts (`layers.attn.wq`,
`layers.moe.wi`, `enc_layers.attn.wq`). The port keeps one module per layer
with the same per-layer layout, so layer i's tensor is the stacked leaf's
slice [i] (`enc_layers.{i}.attn.wq`, `layers.ssm_layers.{i}.in_proj`);
nothing is transposed or re-split (mamba2's in_proj stays (D, 2*di + 2*N + H)
in the packed column order [z | x | B | C | dt]). Every other leaf
(`embed`, `unembed`, `final_ln`, `enc_ln`, the hybrid's shared block
`layers.shared.*`) is taken as it is.

`params_to_jax` is the exact inverse: the port's state_dict (or any dict
keyed like it, such as the optimizer's moments) back to `repro`'s nested
tree with numpy leaves, each layer group stacked on axis 0. The
checkpoints of `train/checkpoint.py` hold that tree, so each package
restores the other's.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _stacked_groups(cfg: ModelConfig) -> Dict[str, int]:
    """Stacked layer group (dotted path) -> its number of layers."""
    if cfg.family == "hybrid":
        return {"layers.ssm_layers": cfg.num_layers}
    if cfg.family == "encdec":
        return {"enc_layers": cfg.encoder_layers, "dec_layers": cfg.num_layers}
    return {"layers": cfg.num_layers}


def _leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_jax(params_np: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) leaves of a JAX param pytree -> the port's
    state_dict. The tensors share memory with the leaves; `load_state_dict`
    copies them."""
    groups = _stacked_groups(cfg)
    sd = {}
    for path, leaf in _leaves(params_np):
        arr = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        group = next((g for g in groups if path.startswith(g + ".")), None)
        if group is None:
            sd[path] = arr
            continue
        n_layers, name = groups[group], path[len(group) + 1:]
        if arr.shape[0] != n_layers:
            raise ValueError(f"{group}/{name}: {arr.shape[0]} stacked layers, "
                             f"config has {n_layers}")
        for i in range(n_layers):
            sd[f"{group}.{i}.{name}"] = arr[i]
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """The port's state_dict -> `repro`'s param tree: nested dicts of numpy
    arrays (copies on the host), the layers of each stacked group stacked on
    axis 0 in layer order. `params_from_jax(params_to_jax(sd, cfg), cfg)`
    equals `sd` bit for bit."""
    groups = _stacked_groups(cfg)
    flat: Dict[str, np.ndarray] = {}
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        group = next((g for g in groups if key.startswith(g + ".")), None)
        if group is None:
            flat[key] = arr
            continue
        idx, name = key[len(group) + 1:].split(".", 1)
        stacks.setdefault(f"{group}.{name}", {})[int(idx)] = arr
    for path, layers in stacks.items():
        n_layers = groups[next(g for g in groups if path.startswith(g + "."))]
        if sorted(layers) != list(range(n_layers)):
            raise ValueError(f"{path}: layers {sorted(layers)}, config has {n_layers}")
        flat[path] = np.stack([layers[i] for i in range(n_layers)])
    tree: Dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree
