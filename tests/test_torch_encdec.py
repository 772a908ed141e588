"""The whisper slice on the reduced config: the port (CPU, fp32, plain
attention) against `repro` (CPU, fp32, its Pallas flash-attention kernel in
interpret mode on every full-sequence self attention), on the same weights
carried over by `params_from_jax`. The norms' gains and the q/k/v biases,
which `init_params` sets to zero, are redrawn from a seed so that their
arithmetic is held too.

Held: config fields; the full-width parameter tree (names, shapes, count);
prefill, decode-step and teacher-forced `forward` logits and the caches
(1e-4 abs and rel: fp32 values of magnitude ~1 summed in different orders),
at encoder_len 16 and 150 (the JAX kernel pads 150 to 256 and masks the
padded keys); identical greedy tokens over 8 steps through the serve steps;
`update_cache_layer` on its DUS and scatter branches (exact); the MLP, plain
and gated; RoPE (1e-5) and the tanh form of GELU (1e-6); the launcher's
refusal of encdec.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro.serve import serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model, init_cache  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402

TOL = 1e-4
RT_J = dataclasses.replace(JAX_CPU_TEST, use_pallas=True, interpret=True)
RT = CPU_TEST
MAX_LEN = 32
# the JAX model functions, jitted (cfg and rt static): eager dispatch of the
# reference on the CPU is slower than compiling it
_prefill_j = jax.jit(jax_model.prefill, static_argnums=(1, 2))
_decode_j = jax.jit(jax_model.decode_step, static_argnums=(1, 2))
_forward_j = jax.jit(jax_model.forward, static_argnums=(1, 2))


def _configs(encoder_len):
    jcfg, cfg = jax_reduced_config("whisper-small"), reduced_config("whisper-small")
    if encoder_len is not None:
        jcfg = dataclasses.replace(jcfg, encoder_len=encoder_len)
        cfg = dataclasses.replace(cfg, encoder_len=encoder_len)
    return jcfg, cfg


@pytest.fixture(scope="module", params=[None, 150], ids=["enc16", "enc150"])
def pair(request):
    """(jax cfg, jax params, port model on the same weights)."""
    jcfg, cfg = _configs(request.param)
    params = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params_np = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.standard_normal(x.shape).astype(np.float32)
                         if path[-1].key.startswith(("ln", "b", "enc_ln", "final_ln"))
                         else np.asarray(x)), params)
    model = Model(cfg, RT, seed=None)
    model.load_state_dict(params_from_jax(params_np, cfg))
    return jcfg, jax.tree.map(jnp.asarray, params_np), model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _inputs(cfg, B, S, seed=7):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return frames, tokens


def test_configs_match_jax():
    for cfg, jcfg in ((get_config("whisper-small"), jax_get_config("whisper-small")),
                      (reduced_config("whisper-small"), jax_reduced_config("whisper-small"))):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.hd() == jcfg.hd()


def test_full_width_meta_model_matches_jax_param_tree():
    """whisper-small at full width, without allocating: the port's names and
    shapes after params_from_jax equal jax.eval_shape(init_params)."""
    jcfg = jax_get_config("whisper-small")
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    stand_in = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    cfg = get_config("whisper-small")
    sd = params_from_jax(stand_in, cfg)
    model = Model(cfg, Runtime(device="meta"))
    assert all(p.is_meta for p in model.parameters())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert shapes["enc_layers"]["attn"]["wq"].shape == (12, *want["enc_layers.0.attn.wq"])
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port == cfg.param_count() == 238_143_744
    model.load_state_dict(sd, strict=True, assign=True)


def test_prefill_decode_and_forward_logits_match_jax(pair):
    jcfg, params, model = pair
    frames, tokens = _inputs(jcfg, B=2, S=5)
    before = flash_attention.launches
    batch_j = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    logits_j, cache_j = _prefill_j(params, jcfg, RT_J, batch_j,
                                   jax_model.init_cache(jcfg, RT_J, 2, MAX_LEN))
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  init_cache(model.cfg, RT, 2, MAX_LEN),
                                  frames=torch.from_numpy(frames))
    _close(logits, logits_j)
    _close(cache["cross_k"], cache_j["cross_k"])
    _close(cache["cross_v"], cache_j["cross_v"])
    for name in ("k", "v"):
        _close(cache["self"][name], cache_j["self"][name])
    assert np.array_equal(cache["self"]["kv_pos"].numpy(), np.asarray(cache_j["self"]["kv_pos"]))
    pos = tokens.shape[1]
    for _ in range(3):
        tok = np.argmax(np.asarray(logits_j), -1).astype(np.int32)[:, None]
        assert np.array_equal(logits.argmax(-1).numpy(), tok[:, 0])
        logits_j, cache_j = _decode_j(params, jcfg, RT_J, jnp.asarray(tok), jnp.int32(pos),
                                      cache_j)
        logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache, pos=pos)
        _close(logits, logits_j)
        pos += 1
    assert np.array_equal(cache["self"]["kv_pos"].numpy(), np.asarray(cache_j["self"]["kv_pos"]))

    _, teacher = _inputs(jcfg, B=2, S=9, seed=8)
    fwd_j, _ = _forward_j(params, jcfg, RT_J, {"tokens": jnp.asarray(teacher),
                                               "frames": jnp.asarray(frames)})
    _close(model(torch.from_numpy(teacher).long(), frames=torch.from_numpy(frames)), fwd_j)
    assert flash_attention.launches == before        # CPU tensors never launch


def test_serve_steps_greedy_tokens_match_jax(pair):
    """8 greedy tokens through make_prefill_step / make_decode_step."""
    jcfg, params, model = pair
    frames, tokens = _inputs(jcfg, B=3, S=4, seed=9)
    prefill_j = jax.jit(jax_serve_step.make_prefill_step(jcfg, RT_J, MAX_LEN))
    decode_j = jax.jit(jax_serve_step.make_decode_step(jcfg, RT_J))
    prefill = make_prefill_step(model.cfg, RT, MAX_LEN)
    decode = make_decode_step(model.cfg, RT)

    logits_j, cache_j = prefill_j(params, {"tokens": jnp.asarray(tokens),
                                           "frames": jnp.asarray(frames)})
    logits, cache = prefill(model, {"tokens": torch.from_numpy(tokens).long(),
                                    "frames": torch.from_numpy(frames)})
    want, got = [], []
    for step in range(8):
        tok_j = jnp.argmax(logits_j, -1).astype(jnp.int32)[:, None]
        tok = logits.argmax(-1)[:, None]
        want.append(np.asarray(tok_j)[:, 0].tolist())
        got.append(tok[:, 0].tolist())
        pos = tokens.shape[1] + step
        logits_j, cache_j = decode_j(params, tok_j, jnp.int32(pos), cache_j)
        logits, cache = decode(model, tok, pos, cache)
    assert got == want
    _close(logits, logits_j)


UPDATE_CASES = [
    # (pos, S_new): DUS aligned prefill, decode, clamped start, span that does
    # not divide W (scatter), ring wrap, per-slot vector positions (scatter)
    (0, 4), (5, 1), (14, 4), (3, 5), (18, 1), ((3, 9), 2),
]


@pytest.mark.parametrize("use_dus", [True, False], ids=["dus", "scatter"])
def test_update_cache_layer_matches_jax(use_dus):
    B, W, H, hd = 2, 16, 2, 4
    rng = np.random.default_rng(3)
    for pos, S_new in UPDATE_CASES:
        k0 = rng.standard_normal((B, W, H, hd), dtype=np.float32)
        v0 = rng.standard_normal((B, W, H, hd), dtype=np.float32)
        p0 = rng.integers(-1, 40, (B, W)).astype(np.int32)
        kn = rng.standard_normal((B, S_new, H, hd), dtype=np.float32)
        vn = rng.standard_normal((B, S_new, H, hd), dtype=np.float32)
        pj = jnp.asarray(pos, jnp.int32)
        want = jax_attention.update_cache_layer(
            {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "kv_pos": jnp.asarray(p0)},
            jnp.asarray(kn), jnp.asarray(vn), pj, use_dus=use_dus)
        pt = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)
        got = attention.update_cache_layer(
            {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
             "kv_pos": torch.from_numpy(p0.copy())},
            torch.from_numpy(kn), torch.from_numpy(vn), pt, use_dus=use_dus)
        for name in ("k", "v", "kv_pos"):
            assert np.array_equal(got[name].numpy(), np.asarray(want[name])), (pos, S_new, name)


@pytest.mark.parametrize("act,glu", [("gelu", False), ("silu", True)])
def test_mlp_matches_jax(act, glu):
    """whisper's plain GELU MLP, and the gated form the other families use."""
    cfg = dataclasses.replace(reduced_config("whisper-small"), act=act, glu=glu)
    jcfg = dataclasses.replace(jax_reduced_config("whisper-small"), act=act, glu=glu)
    params = jax_layers.init_mlp(jax.random.PRNGKey(2), jcfg, jcfg.d_ff)
    p = layers.MLP(cfg, cfg.d_ff).requires_grad_(False)
    p.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    h = np.random.default_rng(5).standard_normal((2, 3, cfg.d_model), dtype=np.float32)
    _close(layers.mlp(torch.from_numpy(h), p, cfg, RT),
           jax_layers.mlp(jnp.asarray(h), params, jcfg, JAX_CPU_TEST))


def test_rope_and_gelu_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    positions = rng.integers(0, 500, (2, 7)).astype(np.int32)
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(positions), 10000.0),
           jax_layers.rope(jnp.asarray(x), jnp.asarray(positions), 10000.0), 1e-5)
    u = np.linspace(-6, 6, 2001, dtype=np.float32)
    gelu = layers.act_fn("gelu")(torch.from_numpy(u))
    _close(gelu, jax.nn.gelu(jnp.asarray(u)), 1e-6)
    # the erf form (torch's default) is another function: ~1e-3 apart here
    erf_form = torch.nn.functional.gelu(torch.from_numpy(u))
    assert (gelu - erf_form).abs().max().item() > 1e-4


def test_launcher_refuses_encdec_as_jax_does():
    with pytest.raises(SystemExit) as ej:
        jax_launch_serve.main(["--arch", "whisper-small", "--reduced"])
    with pytest.raises(SystemExit) as et:
        launch_serve.main(["--arch", "whisper-small", "--reduced", "--device", "cpu"])
    assert str(et.value) == str(ej.value)
    assert "make_prefill_step" in str(et.value)
