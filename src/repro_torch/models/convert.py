"""Carry weights from the JAX package into the port.

`repro`'s params are a nested dict. The layer groups (`layers` for the
dense, MoE and SSM families, `enc_layers` and `dec_layers` for encdec) hold
their leaves stacked on axis 0, one entry per layer, possibly under
sub-dicts (`layers.attn.wq`, `layers.moe.wi`, `enc_layers.attn.wq`).
The port keeps one module per layer with the same per-layer layout, so layer
i's tensor is the stacked leaf's slice [i] (`enc_layers.{i}.attn.wq`);
nothing is transposed or re-split (mamba2's in_proj stays (D, 2*di + 2*N + H)
in the packed column order [z | x | B | C | dt]). Other top-level leaves
(`embed`, `unembed`, `final_ln`, `enc_ln`) are taken as they are.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import PORTED_FAMILIES

# stacked layer group -> the config field that counts its layers
_STACKED = {"layers": "num_layers", "enc_layers": "encoder_layers",
            "dec_layers": "num_layers"}


def _leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_jax(params_np: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """numpy leaves of a JAX param pytree -> the port's state_dict. The
    tensors share memory with the arrays; `load_state_dict` copies them."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    sd = {}
    for top, sub in params_np.items():
        if top not in _STACKED:
            sd[top] = torch.as_tensor(np.asarray(sub))
            continue
        n_layers = getattr(cfg, _STACKED[top])
        for name, leaf in _leaves(sub):
            arr = torch.as_tensor(np.asarray(leaf))
            if arr.shape[0] != n_layers:
                raise ValueError(f"{top}/{name}: {arr.shape[0]} stacked layers, "
                                 f"config has {n_layers}")
            for i in range(n_layers):
                sd[f"{top}.{i}.{name}"] = arr[i]
    return sd
