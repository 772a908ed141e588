"""Carry weights from the JAX package into the port.

`repro`'s SSM params are a dict {"embed", "final_ln", "layers": {name:
(L, ...)}} with the layers stacked on axis 0. The port keeps one module per
layer, with the same per-layer layout (in_proj stays (D, 2*di + 2*N + H) in
the packed column order [z | x | B | C | dt]): layer i's tensor is the
stacked leaf's slice [i], nothing is transposed or re-split.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def params_from_jax(params_np: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """numpy leaves of a JAX param pytree -> the port's state_dict. The
    tensors share memory with the arrays; `load_state_dict` copies them."""
    if cfg.family != "ssm":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    sd = {"embed": torch.as_tensor(np.asarray(params_np["embed"])),
          "final_ln": torch.as_tensor(np.asarray(params_np["final_ln"]))}
    for name, leaf in params_np["layers"].items():
        arr = torch.as_tensor(np.asarray(leaf))
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{name}: {arr.shape[0]} stacked layers, "
                             f"config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            sd[f"layers.{i}.{name}"] = arr[i]
    return sd
