"""remat "block" in the port under `repro`'s policy, on the CPU.

`repro` checkpoints each layer with
`jax.checkpoint(..., policy=dots_with_no_batch_dims_saveable)`: the weight
GEMMs' outputs are kept and the rest of the layer is recomputed in the
backward. The port's `runtime.remat_block` does the same with
`torch.utils.checkpoint`'s selective checkpointing (aten.mm and aten.addmm
saved). Over reduced smollm-135m (the decoder stack), mamba2-370m (SSM) and
zamba2-1.2b (hybrid), and reduced whisper-small (the encoder and the
teacher-forced decoder, with `synthetic_batch` frames), the gradients under
"block" equal those of "none" bit for bit; a `TorchDispatchMode` count shows
that the backward under "block" runs no more aten.mm than under "none" (no
weight GEMM is recomputed) but more ops in all (the rest of each layer is),
and `saved_tensors_hooks` that "block" keeps fewer bytes for the backward.
Weights from the model's seed, batches from numpy with a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models.model import Model, loss_fn  # noqa: E402
from repro_torch.models.runtime import CPU_TEST  # noqa: E402
from repro_torch.train.data import MarkovLMDataset, synthetic_batch  # noqa: E402

SEQ, BATCH = 32, 2


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _batch(arch):
    cfg = reduced_config(arch)
    if cfg.family == "encdec":
        shape = ShapeConfig(name="t", kind="train", global_batch=BATCH, seq_len=SEQ)
        b = synthetic_batch(np.random.default_rng(0), cfg, shape)
    else:
        b = MarkovLMDataset(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0).batch_at(0)
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in b.items()}


def _grads(arch, remat, batch):
    """(gradients, aten op counts of the backward, bytes saved for it)."""
    model = Model(reduced_config(arch), dataclasses.replace(CPU_TEST, remat=remat),
                  seed=0).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(model, batch)
    with _CountOps() as ops:
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return grads, ops.counts, sum(saved)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "zamba2-1.2b", "whisper-small"])
def test_remat_block_keeps_the_weight_gemms_and_gives_the_same_gradients(arch):
    batch = _batch(arch)
    g_none, ops_none, bytes_none = _grads(arch, "none", batch)
    g_block, ops_block, bytes_block = _grads(arch, "block", batch)
    assert all(torch.equal(a, b) for a, b in zip(g_none, g_block))
    mm = torch.ops.aten.mm.default
    assert ops_none.get(mm, 0) > 0
    assert ops_block.get(mm, 0) <= ops_none[mm]
    # the rest of each layer is recomputed: more aten ops in the backward
    assert sum(ops_block.values()) > sum(ops_none.values())
    assert bytes_block < bytes_none
