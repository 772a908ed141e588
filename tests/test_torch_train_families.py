"""The port's train step against `repro`'s for the seven archs that
tests/test_torch_train.py does not train: qwen2-0.5b, qwen1.5-32b,
gemma3-4b (local and global layers), mixtral-8x7b and grok-1-314b (MoE,
capacity drops), whisper-small (encoder-decoder, `frames`) and
paligemma-3b (prefix-LM, `patches`), reduced, on the CPU.

Each case runs `_five_steps` of tests/test_torch_train.py (the same weights,
drawn with numpy, on both sides; `repro`'s step jitted without a mesh) on
`synthetic_batch` batches, which give whisper its frames and paligemma its
patches. Tolerances are that test's: loss, grad norm and lr within 1e-5
relative at every step, the final params within rtol 2e-4, atol 2e-5, at
the optimizer setting of `repro`'s own microbatch test (lr 1e-3 behind 100
warmup steps, no clipping, no decay).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.train import data  # noqa: E402
from test_torch_train import BATCH, OPT_REPRO_TEST, SEQ, _close_trees, _five_steps  # noqa: E402

ARCHS = ("qwen2-0.5b", "qwen1.5-32b", "gemma3-4b", "mixtral-8x7b", "grok-1-314b",
         "whisper-small", "paligemma-3b")


def _synthetic_batches(cfg):
    """Step s's batch: `synthetic_batch` from a generator seeded with s, as
    (repro's, the port's); token ids as int64 on the port's side."""
    shape = ShapeConfig(name="t", seq_len=SEQ, global_batch=BATCH, kind="train")

    def batch_at(step):
        b = data.synthetic_batch(np.random.default_rng(step), cfg, shape)
        return ({k: jnp.asarray(v) for k, v in b.items()},
                {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in b.items()})
    return batch_at


@pytest.mark.parametrize("arch,remat,microbatches", [
    pytest.param(arch, remat, mb, id=f"{arch}-{remat}-{mb}")
    for arch in ARCHS for remat, mb in (("none", 1), ("block", 1), ("block", 2))])
def test_train_step_matches_jax_over_five_steps(arch, remat, microbatches):
    ours, theirs, _ = _five_steps(remat, microbatches, OPT_REPRO_TEST, arch,
                                  batches=_synthetic_batches)
    _close_trees(ours, theirs, rtol=2e-4, atol=2e-5)

