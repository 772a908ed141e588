"""The VLM family (paligemma-3b) on its reduced config: the port (CPU,
fp32) against `repro` (CPU, fp32, `use_pallas=True, interpret=True`), on the
same weights carried over by `params_from_jax` (the dense family's draw:
norms' gains redrawn from a seed). The input is a prefix of `prefix_len`
patch embeddings (a stand-in for SigLIP's, drawn from a seed) followed by
text tokens.

Held: `CONFIG` and `REDUCED` field by field; the full-width parameter tree
against `jax.eval_shape` of `init_params` and the exact `param_count`,
2,508,662,784; `forward` over patches + text, `loss_fn` with labels over
the text only, and the serve steps (`make_prefill_step` with patches,
`make_decode_step` from position prefix_len + S, scalar and per-slot) with
their caches, within 1e-4 abs and rel, and the same greedy tokens. The
prefix-LM mask itself: the first patch sees the last one, a text token sees
no later one, and the flash-attention entry point is never called (the mask
stays on the plain path, as in `repro`). The engine refuses the vlm with
`repro`'s message (tests/test_torch_dense.py holds the launcher's refusal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import model as jax_model  # noqa: E402
from repro.serve import serve_step as jax_serve_step  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from test_torch_dense import (  # noqa: E402
    RT,
    RT_J,
    check_configs,
    check_param_tree,
    close,
    make_pair,
)

ARCH = "paligemma-3b"
MAX_LEN = 40
S_TEXT = 12
_loss_j = jax.jit(jax_model.loss_fn, static_argnums=(1, 2))
_forward_j = jax.jit(jax_model.forward, static_argnums=(1, 2))


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return tokens, patches


def test_configs_match_jax():
    check_configs(ARCH)


def test_full_width_meta_model_matches_jax_param_tree():
    check_param_tree(ARCH)
    assert get_config(ARCH).param_count() == 2_508_662_784


def test_forward_and_loss_match_jax(pair, monkeypatch):
    jcfg, params, model = pair
    monkeypatch.setattr(fa_ops, "mha", None)     # the prefix-LM mask never reaches K1
    tokens, patches = _inputs(jcfg, 2, 20, seed=7)
    labels = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    labels[0, :3] = -1
    batch_j = {k: jnp.asarray(v) for k, v in
               (("tokens", tokens), ("patches", patches), ("labels", labels))}
    loss_j, met_j = _loss_j(params, jcfg, RT_J, batch_j)
    logits_j, _ = _forward_j(params, jcfg, RT_J, batch_j)
    batch = {"tokens": torch.from_numpy(tokens).long(), "patches": torch.from_numpy(patches),
             "labels": torch.from_numpy(labels)}
    logits = model(batch["tokens"], patches=batch["patches"])
    assert logits.shape == (2, jcfg.prefix_len + 20, jcfg.vocab)
    close(logits, logits_j)
    loss, met = loss_fn(model, batch)
    close(loss, loss_j)
    close(met["ce"], met_j["ce"])
    assert float(met["tokens"]) == float(met_j["tokens"]) == 37


@pytest.mark.parametrize("vector_pos", [False, True], ids=["scalar", "per_slot"])
def test_serve_steps_match_jax(pair, vector_pos, monkeypatch):
    jcfg, params, model = pair
    monkeypatch.setattr(fa_ops, "mha", None)
    B = 2
    tokens, patches = _inputs(jcfg, B, S_TEXT, seed=9)
    batch_j = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    prefill_j = jax.jit(jax_serve_step.make_prefill_step(jcfg, RT_J, MAX_LEN))
    decode_j = jax.jit(jax_serve_step.make_decode_step(jcfg, RT_J))
    logits_j, cache_j = prefill_j(params, batch_j)
    logits, cache = make_prefill_step(model.cfg, RT, MAX_LEN)(
        model, {"tokens": torch.from_numpy(tokens).long(), "patches": torch.from_numpy(patches)})
    close(logits, logits_j)
    decode = make_decode_step(model.cfg, RT)
    start = jcfg.prefix_len + S_TEXT
    for step in range(4):
        tok = np.argmax(np.asarray(logits_j), -1).astype(np.int32)[:, None]
        assert np.array_equal(logits.argmax(-1).numpy(), tok[:, 0])
        pos = start + step
        if vector_pos:
            pos_j, pos_t = jnp.full((B,), pos, jnp.int32), torch.full((B,), pos, dtype=torch.int32)
        else:
            pos_j, pos_t = jnp.int32(pos), pos
        logits_j, cache_j = decode_j(params, jnp.asarray(tok), pos_j, cache_j)
        logits, cache = decode(model, torch.from_numpy(tok).long(), pos_t, cache)
        close(logits, logits_j)
    for name in ("k", "v"):
        close(cache["attn"][name], cache_j["attn"][name])
    assert np.array_equal(cache["attn"]["kv_pos"].numpy(), np.asarray(cache_j["attn"]["kv_pos"]))


def test_prefix_lm_mask(pair):
    """Changing the last patch moves the first patch's output (the prefix
    is bidirectional); changing a text token moves no earlier position
    (causal after the prefix) and does move its own."""
    _, _, model = pair
    cfg = model.cfg
    P = cfg.prefix_len
    tokens, patches = (torch.from_numpy(a) for a in _inputs(cfg, 1, 8, seed=5))
    tokens = tokens.long()
    base = model(tokens, patches=patches)
    moved = patches.clone()
    moved[:, -1] += 1.0
    out = model(tokens, patches=moved)
    assert (out[:, 0] - base[:, 0]).abs().max() > 1e-3
    t = 4
    other = tokens.clone()
    other[:, t] = (other[:, t] + 1) % cfg.vocab
    out = model(other, patches=patches)
    assert torch.equal(out[:, :P + t], base[:, :P + t])
    assert (out[:, P + t] - base[:, P + t]).abs().max() > 1e-3


def test_engine_refuses_the_vlm_as_jax_does(pair):
    jcfg, params, model = pair
    with pytest.raises(NotImplementedError) as ej:
        JaxServeEngine(jcfg, RT_J, params)
    with pytest.raises(NotImplementedError) as et:
        ServeEngine(model.cfg, RT, model)
    assert str(et.value) == str(ej.value)


def test_vlm_without_patches_raises(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros((1, 3), dtype=torch.long))
