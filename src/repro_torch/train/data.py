"""Synthetic-but-learnable data pipeline (a copy of `repro.train.data`:
NumPy only, the same batches bit for bit).

A fixed order-1 Markov chain over the vocabulary (Zipf-ish stationary
distribution) gives training a real signal: cross-entropy decreases toward
the chain's conditional entropy, so end-to-end examples show genuine learning.
Host-side numpy; deterministic per (seed, step, host) so multi-host shards
never overlap and restarts are reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class MarkovLMDataset:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 4          # out-degree per state: lower = more learnable
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, K = self.vocab, min(self.branching, self.vocab)
        self.succ = rng.integers(0, V, size=(V, K))          # successor table
        w = rng.dirichlet(np.ones(K) * 0.5, size=V)
        self.cum = np.cumsum(w, axis=1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.num_hosts + self.host_id)
        B, S, V = self.batch, self.seq_len, self.vocab
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        u = rng.random((B, S))
        for t in range(S):
            cur = toks[:, t]
            choice = (u[:, t:t + 1] < self.cum[cur]).argmax(axis=1)
            toks[:, t + 1] = self.succ[cur, choice]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def conditional_entropy(self) -> float:
        """Entropy floor (nats/token) the model can converge to."""
        w = np.diff(np.concatenate(
            [np.zeros((self.vocab, 1)), self.cum], axis=1), axis=1)
        ent = -(w * np.log(np.maximum(w, 1e-12))).sum(axis=1)
        return float(ent.mean())


def synthetic_batch(rng: np.random.Generator, cfg, shape) -> Dict[str, np.ndarray]:
    """Uniform-random batch matching input_specs (for benchmarks/smoke)."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int64)
           .astype(np.int32)}
    if shape.kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab, size=(B, S),
                                     dtype=np.int64).astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patches"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        text = S - cfg.prefix_len
        out["tokens"] = out["tokens"][:, :text]
        if "labels" in out:
            out["labels"] = out["labels"][:, :text]
    return out
