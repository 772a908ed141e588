"""Model configuration for the PyTorch port: the fields and the registry that
the ported slice needs, copied from `repro.configs.base` so the port imports
nothing of the JAX package.

Only the SSM family (mamba2-370m) is ported so far; every other arch id
raises `NotImplementedError` (see ROADMAP.md for the order of the slices).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N: SSD state size per head
    head_dim: int = 64            # P: channels per SSD head
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4           # depthwise causal conv width
    chunk: int = 128              # SSD chunk length (the model uses Runtime.ssd_chunk)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # only "ssm" is ported
    num_layers: int
    d_model: int
    vocab: int
    ssm: Optional[SSMConfig] = None
    norm_eps: float = 1e-6

    def param_count(self) -> int:
        """Exact parameter count of the ported SSM model."""
        if self.family != "ssm":
            raise NotImplementedError(self.family)
        D, s = self.d_model, self.ssm
        di, H, N = s.d_inner(D), s.n_heads(D), s.state_dim
        conv_ch = di + 2 * N
        per = (D                                   # ln
               + D * (2 * di + 2 * N + H)          # in_proj (z, x, B, C, dt)
               + s.conv_width * conv_ch + conv_ch  # conv_w, conv_b
               + 3 * H                             # A_log, D, dt_bias
               + di                                # norm
               + di * D)                           # out_proj
        return self.vocab * D + D + self.num_layers * per


# arch id -> module under repro_torch.configs; the port adds ids slice by slice
_ARCH_MODULES = {
    "mamba2-370m": "mamba2_370m",
}

#: arch ids of the JAX package that the port does not serve yet
NOT_PORTED = (
    "whisper-small", "qwen1.5-32b", "qwen2-0.5b", "smollm-135m", "gemma3-4b",
    "mixtral-8x7b", "grok-1-314b", "zamba2-1.2b", "paligemma-3b",
)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; "
            "ROADMAP.md lists the slices still to port")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _module(arch_id).REDUCED
