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
    """numpy leaves of a JAX param pytree -> the port's state_dict. The
    tensors share memory with the arrays; `load_state_dict` copies them."""
    groups = _stacked_groups(cfg)
    sd = {}
    for path, leaf in _leaves(params_np):
        arr = torch.as_tensor(np.asarray(leaf))
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
