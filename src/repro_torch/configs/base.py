"""Model configuration for the PyTorch port: the fields and the registry that
the port needs, copied from `repro.configs.base` so the port imports nothing
of the JAX package.

Every family of the JAX package is ported: dense (smollm, qwen, gemma3), MoE
(mixtral, grok), SSM (mamba2), hybrid (zamba2), encoder-decoder (whisper)
and VLM (paligemma).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # capacity factor of the dispatch buffer (models/moe.py)
    capacity_factor: float = 1.25


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
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    vocab: int
    # --- attention (0 heads for attention-free) ---------------------------
    n_heads: int = 0              # query heads
    n_kv: int = 0                 # KV heads (GQA); == n_heads for MHA
    d_ff: int = 0
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None    # None = full attention
    # pattern of local:global layers, e.g. gemma3 (5, 1): 5 local then 1 global
    local_global_pattern: Optional[Tuple[int, int]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k SSM layers
    shared_attn_every: Optional[int] = None
    # --- enc-dec / multimodal ---------------------------------------------
    encoder_layers: int = 0       # whisper
    encoder_len: int = 0          # fixed frontend length (audio frames)
    prefix_len: int = 0           # vlm: image patch embeddings prepended
    tied_embeddings: bool = True  # False: a separate unembed (D, V)
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu (tanh form, as jax.nn.gelu)
    glu: bool = True              # gated MLP

    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def _attn_params(self) -> int:
        hd, nq, nkv, D = self.hd(), self.n_heads, self.n_kv, self.d_model
        p = D * nq * hd + 2 * D * nkv * hd + nq * hd * D
        if self.qkv_bias:
            p += (nq + 2 * nkv) * hd
        return p

    def param_count(self) -> int:
        """Exact parameter count of the ported model, norms included."""
        D, V = self.d_model, self.vocab
        mlp = (3 if self.glu else 2) * D * self.d_ff
        if self.family in ("dense", "moe", "vlm"):
            ffn = mlp
            if self.family == "moe":                   # experts + router
                ffn = self.moe.num_experts * (mlp + D)
            per = 2 * D + self._attn_params() + ffn    # ln1, attn, ln2, ffn
            embeds = V * D * (1 if self.tied_embeddings else 2)
            return embeds + D + self.num_layers * per
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            di, H, N = s.d_inner(D), s.n_heads(D), s.state_dim
            conv_ch = di + 2 * N
            per = (D                                   # ln
                   + D * (2 * di + 2 * N + H)          # in_proj (z, x, B, C, dt)
                   + s.conv_width * conv_ch + conv_ch  # conv_w, conv_b
                   + 3 * H                             # A_log, D, dt_bias
                   + di                                # norm
                   + di * D)                           # out_proj
            # hybrid: one shared block (ln1, attn, ln2, mlp), reused
            shared = (2 * D + self._attn_params() + mlp) if self.family == "hybrid" else 0
            return V * D + D + self.num_layers * per + shared
        if self.family == "encdec":
            attn = self._attn_params()
            enc = 2 * D + attn + mlp                   # ln1, attn, ln2, mlp
            dec = 3 * D + 2 * attn + mlp               # + lnx, xattn
            return (V * D + 2 * D                      # embed, final_ln, enc_ln
                    + self.encoder_layers * enc + self.num_layers * dec)
        raise ValueError(f"unknown family {self.family!r}")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (`configs/shapes.py`); the DSE workloads
    `arch@shape` are built from a ModelConfig and one of these."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# arch id -> module under repro_torch.configs
_ARCH_MODULES = {
    "whisper-small": "whisper_small",
    "qwen1.5-32b": "qwen15_32b",
    "qwen2-0.5b": "qwen2_05b",
    "smollm-135m": "smollm_135m",
    "gemma3-4b": "gemma3_4b",
    "mamba2-370m": "mamba2_370m",
    "mixtral-8x7b": "mixtral_8x7b",
    "grok-1-314b": "grok1_314b",
    "zamba2-1.2b": "zamba2_12b",
    "paligemma-3b": "paligemma_3b",
}


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _module(arch_id).REDUCED
