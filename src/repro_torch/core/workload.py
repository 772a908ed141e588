"""LLM workload descriptors for the DSE (paper §VIII-A, Table II) + bridge
from the runtime's ModelConfig so every assigned architecture is a DSE
benchmark too.

The port's own copy of `repro.core.workload`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

BYTES = 2          # bf16 activations/weights on-wafer


@dataclasses.dataclass(frozen=True)
class GEMMOp:
    name: str
    M: int            # tokens (rows)
    K: int
    N: int
    weight: bool = True          # K x N is a resident weight (vs act x act)

    def flops(self) -> float:
        return 2.0 * self.M * self.K * self.N

    def in_bytes(self) -> float:
        return (self.M * self.K + self.K * self.N) * BYTES

    def out_bytes(self) -> float:
        return self.M * self.N * BYTES


@dataclasses.dataclass(frozen=True)
class LLMWorkload:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    seq: int
    batch: int
    phase: str                     # train | prefill | decode
    moe_experts: int = 0
    moe_topk: int = 0
    gpu_budget: int = 1            # baseline GPU count (area matching)

    # ------------------------------------------------------------------

    def params_bytes(self) -> float:
        D, F, L = self.d_model, self.d_ff, self.n_layers
        per = 4 * D * D + 3 * D * F * max(self.moe_experts, 1)
        return (L * per + 2 * self.vocab * D) * BYTES

    def expert_params_bytes(self) -> float:
        """Bytes of MoE expert weights (the `ep`-shardable slice of
        `params_bytes`); 0 for dense models."""
        if not self.moe_experts:
            return 0.0
        D, F, L = self.d_model, self.d_ff, self.n_layers
        return L * 3 * D * F * self.moe_experts * BYTES

    def active_params(self) -> float:
        D, F, L = self.d_model, self.d_ff, self.n_layers
        e = self.moe_topk if self.moe_experts else 1
        return L * (4 * D * D + 3 * D * F * e) + self.vocab * D

    def tokens_per_step(self) -> int:
        if self.phase == "decode":
            return self.batch
        return self.batch * self.seq

    def layer_ops(self, tp: int = 1, mb_tokens: Optional[int] = None
                  ) -> List[GEMMOp]:
        """One layer's GEMMs under tensor parallelism `tp` (Megatron split:
        heads/ffn sharded; two collectives per layer accounted by chunk_eval).
        M = tokens per microbatch."""
        D, F = self.d_model, self.d_ff
        hd = D // max(self.n_heads, 1)
        M = mb_tokens if mb_tokens is not None else self.tokens_per_step()
        # Attention context length is the full sequence in every phase:
        # decode reads the whole KV cache, and a prefill/train token attends
        # over its prompt no matter how the M tokens are sharded across
        # dp/microbatch splits (M // batch would shrink the KV with the
        # split, underestimating scores/attnv FLOPs and traffic).
        kv_len = self.seq
        e = self.moe_topk if self.moe_experts else 1
        ops = [
            GEMMOp("qkv", M, D, (self.n_heads + 2 * self.n_kv) * hd // tp),
            GEMMOp("scores", M * max(self.n_heads // tp, 1) // max(self.n_heads, 1),
                   hd, kv_len, weight=False),
            GEMMOp("attnv", M * max(self.n_heads // tp, 1) // max(self.n_heads, 1),
                   kv_len, hd, weight=False),
            GEMMOp("attn_out", M, self.n_heads * hd // tp, D),
            GEMMOp("mlp_in", M * e, D, 2 * F // tp),
            GEMMOp("mlp_out", M * e, F // tp, D),
        ]
        return ops

    def layer_ops_batch(self, tp, mb_tokens):
        """Vectorized `layer_ops`: `tp`/`mb_tokens` are (C,) int arrays, the
        result is a dict of (n_ops, C) int arrays M/K/N plus the static
        `weight` flags — column c reproduces layer_ops(tp[c], mb_tokens[c])
        exactly (integer semantics included)."""
        tp = np.asarray(tp, np.int64)
        M = np.asarray(mb_tokens, np.int64)
        D, F = self.d_model, self.d_ff
        hd = D // max(self.n_heads, 1)
        kv_len = np.full_like(M, self.seq)   # full context in every phase
        e = self.moe_topk if self.moe_experts else 1
        heads_tp = np.maximum(self.n_heads // tp, 1)
        m_attn = M * heads_tp // max(self.n_heads, 1)
        zeros = np.zeros_like(M)
        Ms = np.stack([M, m_attn, m_attn, M, M * e, M * e])
        Ks = np.stack([zeros + D, zeros + hd, kv_len,
                       self.n_heads * hd // tp, zeros + D, F // tp])
        Ns = np.stack([(self.n_heads + 2 * self.n_kv) * hd // tp, kv_len,
                       zeros + hd, zeros + D, 2 * F // tp, zeros + D])
        weight = (True, False, False, True, True, True)
        names = ("qkv", "scores", "attnv", "attn_out", "mlp_in", "mlp_out")
        return {"M": Ms, "K": Ks, "N": Ns, "weight": weight, "names": names}

    def flops_per_step(self) -> float:
        mult = 3.0 if self.phase == "train" else 1.0   # fwd+bwd ~ 3x fwd
        return 2.0 * self.active_params() * self.tokens_per_step() * mult

    def kv_bytes_per_layer(self) -> float:
        hd = self.d_model // max(self.n_heads, 1)
        return 2 * self.batch * self.seq * self.n_kv * hd * BYTES

    def act_bytes_per_layer(self, mb_tokens: int) -> float:
        return mb_tokens * self.d_model * BYTES


# ---------------------------------------------------------------------------
# request-level serving descriptor (ISSUE 4 tentpole; consumed by
# repro_torch.core.serving) — one arrival batch of requests, each a prompt to
# prefill and a number of tokens to decode under continuous batching.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RequestMix:
    """Prompt/output length distribution for one serving arrival batch.

    All requests arrive at t=0 in queue order (matching
    `repro_torch.serve.engine.ServeEngine.run`). Frozen + tuple fields so a mix is
    hashable and can key caches alongside `LLMWorkload`.
    """
    prompt_lens: Tuple[int, ...]
    out_lens: Tuple[int, ...]         # max_new_tokens per request

    def __post_init__(self):
        # coerce to tuples so list inputs keep the hashability contract
        object.__setattr__(self, "prompt_lens", tuple(self.prompt_lens))
        object.__setattr__(self, "out_lens", tuple(self.out_lens))
        if len(self.prompt_lens) != len(self.out_lens):
            raise ValueError("prompt_lens and out_lens must align")
        if not self.prompt_lens:
            raise ValueError("RequestMix needs at least one request")
        if min(self.prompt_lens) < 1 or min(self.out_lens) < 1:
            raise ValueError("prompt/output lengths must be >= 1")

    @property
    def n_requests(self) -> int:
        return len(self.prompt_lens)

    @property
    def mean_prompt(self) -> float:
        return float(np.mean(self.prompt_lens))

    @property
    def mean_out(self) -> float:
        return float(np.mean(self.out_lens))

    def total_out_tokens(self) -> int:
        return int(sum(self.out_lens))

    def context_len(self) -> int:
        """Representative mid-generation context (KV length) for sizing the
        steady-state decode step: prompt plus half the generated tokens."""
        return max(1, int(round(self.mean_prompt + 0.5 * self.mean_out)))

    @classmethod
    def uniform(cls, n_requests: int, prompt_len: int,
                out_len: int) -> "RequestMix":
        return cls((prompt_len,) * n_requests, (out_len,) * n_requests)

    @classmethod
    def sampled(cls, rng: np.random.Generator, n_requests: int,
                prompt_range: Tuple[int, int],
                out_range: Tuple[int, int]) -> "RequestMix":
        p = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
        o = rng.integers(out_range[0], out_range[1] + 1, n_requests)
        return cls(tuple(int(x) for x in p), tuple(int(x) for x in o))

    def as_trace(self, tenant=None):
        """Lift this one-batch mix into the timed-arrival frame: a
        `core.traces.RequestTrace` with every request at step 0 under a
        single tenant — the degenerate case `trace_schedule` reduces to
        `continuous_batch_schedule` on. Lazy import: traces layers on top
        of this module."""
        from repro_torch.core.traces import DEFAULT_TENANT, RequestTrace
        return RequestTrace.from_mix(
            self, DEFAULT_TENANT if tenant is None else tenant)


# ---------------------------------------------------------------------------
# paper Table II benchmarks (Megatron-LM / GPT-3 / ZeRO-Infinity scalings)
# ---------------------------------------------------------------------------

def _gpt(name, params_b, layers, hidden, heads, gpus, batch) -> LLMWorkload:
    return LLMWorkload(
        name=name, n_layers=layers, d_model=hidden, n_heads=heads,
        n_kv=heads, d_ff=4 * hidden, vocab=51200, seq=2048, batch=batch,
        phase="train", gpu_budget=gpus)


GPT_BENCHMARKS: Tuple[LLMWorkload, ...] = (
    _gpt("GPT-1.7B", 1.7, 24, 2304, 24, 32, 512),
    _gpt("GPT-3.6B", 3.6, 30, 3072, 32, 64, 512),
    _gpt("GPT-7.5B", 7.5, 36, 4096, 32, 128, 512),
    _gpt("GPT-18B", 18.4, 40, 6144, 48, 256, 1024),
    _gpt("GPT-39B", 39.1, 48, 8192, 64, 512, 1536),
    _gpt("GPT-76B", 76.1, 60, 10240, 80, 1024, 1792),
    _gpt("GPT-145B", 145.6, 80, 12288, 96, 1536, 2304),
    _gpt("GPT-175B", 175.0, 96, 12288, 96, 1000, 2048),
    _gpt("GPT-310B", 310.1, 96, 16384, 128, 1920, 2160),
    _gpt("GPT-530B", 529.6, 105, 20480, 128, 2520, 2520),
    _gpt("GPT-1T", 1008.0, 128, 25600, 160, 3072, 3072),
    _gpt("GPT-2.2T", 2244.5, 192, 32768, 256, 6000, 3072),
    _gpt("GPT-4T", 4066.6, 192, 43008, 432, 12000, 5500),
    _gpt("GPT-9.6T", 9588.2, 195, 65536, 512, 30000, 10000),
    _gpt("GPT-18T", 18436.5, 240, 81920, 620, 60000, 15000),
    _gpt("GPT-32T", 32405.7, 270, 102400, 850, 100000, 20000),
)


def inference_workload(base: LLMWorkload, phase: str, batch: int = 32,
                       seq: int = 2048) -> LLMWorkload:
    return dataclasses.replace(base, phase=phase, batch=batch, seq=seq)


def from_model_config(cfg: ModelConfig, shape: ShapeConfig) -> LLMWorkload:
    """Bridge: assigned runtime architectures as DSE benchmarks."""
    heads = max(cfg.n_heads, 1)
    d_ff = cfg.d_ff
    if cfg.family in ("ssm", "hybrid") and d_ff == 0:
        d_ff = 2 * cfg.d_model      # SSD GEMM-equivalent inner width
    return LLMWorkload(
        name=cfg.name,
        n_layers=cfg.num_layers,
        d_model=cfg.d_model,
        n_heads=heads,
        n_kv=max(cfg.n_kv, 1),
        d_ff=d_ff,
        vocab=cfg.vocab,
        seq=shape.seq_len,
        batch=shape.global_batch,
        phase=shape.kind,
        moe_experts=cfg.moe.num_experts if cfg.moe else 0,
        moe_topk=cfg.moe.top_k if cfg.moe else 0,
        gpu_budget=max(1, cfg.param_count() * 8 // (80 * 2 ** 30)),
    )
