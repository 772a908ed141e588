"""The dense decoder family on its reduced configs: the port
(CPU, fp32, plain attention) against `repro` (CPU, fp32, its Pallas
flash-attention kernel in interpret mode on every full-sequence self
attention), on the same weights carried over by `params_from_jax`. The
norms' gains and the q/k/v biases, which `init_params` sets to zero, are
redrawn from a seed so that their arithmetic is held too.

Held, for the four dense archs (smollm-135m, qwen2-0.5b, qwen1.5-32b,
gemma3-4b; tests/test_torch_moe.py runs the same checks, defined here, on
mixtral-8x7b and grok-1-314b): `CONFIG` and `REDUCED` field by field; the
full-width parameter tree (names, shapes) against `jax.eval_shape` of
`init_params`, and `param_count` against its sum; `forward`, `loss_fn`
(loss, ce, aux), `prefill` and `decode_step` logits (scalar and per-slot
positions) and the caches, within 1e-4 abs and rel (fp32 values of
magnitude ~1 summed in different orders). gemma3's scalar-position decode at
max_len 32 takes the windowed branch (its window is 8), and the test checks
that it ran. The engine's greedy tokens, admit/finish steps and preemption
counts equal repro's under fifo, priority and preempt (gemma3). One
attention layer's windowed decode slice against repro's and against the
whole masked cache, with the slice's start clamped at both ends. The launcher serves a reduced dense arch and refuses vlm and
encdec with repro's message.
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
from repro.models import model as jax_model  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model, init_cache, loss_fn  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = 1e-4
RT_J = dataclasses.replace(JAX_CPU_TEST, use_pallas=True, interpret=True)
RT = CPU_TEST
MAX_LEN = 32
ARCHS = ["smollm-135m", "qwen2-0.5b", "qwen1.5-32b", "gemma3-4b"]
# the JAX model functions, jitted (cfg and rt static): eager dispatch of the
# reference on the CPU is slower than compiling it
_prefill_j = jax.jit(jax_model.prefill, static_argnums=(1, 2))
_decode_j = jax.jit(jax_model.decode_step, static_argnums=(1, 2))
_loss_j = jax.jit(jax_model.loss_fn, static_argnums=(1, 2))
_forward_j = jax.jit(jax_model.forward, static_argnums=(1, 2))


def make_pair(arch, rt=RT):
    """(jax cfg, jax params, port model on the same weights), reduced. The
    weights are drawn with numpy in `init_params`' tree: normal times the
    fan-in scale, 0.02 for the embeddings, 0.1 for the norms' gains and the
    biases (which `init_params` sets to zero)."""
    jcfg = jax_reduced_config(arch)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)

    def draw(path, s):
        name = path[-1].key
        scale = (0.1 if name.startswith(("ln", "b", "final_ln"))
                 else 0.02 if name in ("embed", "unembed") else s.shape[-2] ** -0.5)
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    params_np = jax.tree_util.tree_map_with_path(draw, shapes)
    cfg = reduced_config(arch)
    model = Model(cfg, rt, seed=None)
    model.load_state_dict(params_from_jax(params_np, cfg))
    return jcfg, jax.tree.map(jnp.asarray, params_np), model


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    check_configs(arch)


def check_configs(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (reduced_config(arch), jax_reduced_config(arch))):
        for f in dataclasses.fields(cfg):
            if f.name != "moe":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert (cfg.moe is None) == (jcfg.moe is None)
        if cfg.moe is not None:
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
        assert cfg.hd() == jcfg.hd()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_meta_model_matches_jax_param_tree(arch):
    check_param_tree(arch)


def check_param_tree(arch):
    """Full width, without allocating: the port's names and shapes after
    params_from_jax equal jax.eval_shape(init_params); param_count is the
    exact sum of the tree."""
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    stand_in = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    cfg = get_config(arch)
    sd = params_from_jax(stand_in, cfg)
    model = Model(cfg, Runtime(device="meta"))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert ("unembed" in want) == (not cfg.tied_embeddings)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port == cfg.param_count() == jcfg.param_count()
    if arch == "gemma3-4b":
        assert n_port == 3_879_907_840
    model.load_state_dict(sd, strict=True, assign=True)


def test_forward_and_loss_match_jax(pair):
    check_forward_and_loss(*pair)


def check_forward_and_loss(jcfg, params, model):
    tokens = _tokens(jcfg.vocab, (2, 20), seed=7)
    labels = _tokens(jcfg.vocab, (2, 20), seed=8)
    labels[0, :3] = -1                                  # masked positions
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss_j, met_j) = _loss_j(params, jcfg, RT_J, batch_j)
    logits_j, aux_j = _forward_j(params, jcfg, RT_J, batch_j)
    before = flash_attention.launches
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels)}
    logits, aux = model.forward_with_aux(batch["tokens"])
    close(logits, logits_j)
    close(model(batch["tokens"]), logits_j)
    loss, met = loss_fn(model, batch)
    close(loss, loss_j)
    close(met["ce"], met_j["ce"])
    close(met["aux"], met_j["aux"])
    close(aux, aux_j)
    assert float(met["tokens"]) == float(met_j["tokens"]) == 37
    assert (float(aux) > 0) == (jcfg.family == "moe")
    assert flash_attention.launches == before        # CPU tensors never launch


@pytest.mark.parametrize("vector_pos", [False, True], ids=["scalar", "per_slot"])
def test_prefill_and_decode_match_jax(pair, vector_pos):
    check_prefill_and_decode(*pair, vector_pos)


def check_prefill_and_decode(jcfg, params, model, vector_pos):
    B, S = 2, 12
    tokens = _tokens(jcfg.vocab, (B, S), seed=9)
    logits_j, cache_j = _prefill_j(params, jcfg, RT_J, {"tokens": jnp.asarray(tokens)},
                                   jax_model.init_cache(jcfg, RT_J, B, MAX_LEN))
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  init_cache(model.cfg, RT, B, MAX_LEN))
    close(logits, logits_j)
    for name in ("k", "v"):
        close(cache["attn"][name], cache_j["attn"][name])
    slices = attention.cached_attention.window_slices
    for step in range(4):
        tok = np.argmax(np.asarray(logits_j), -1).astype(np.int32)[:, None]
        assert np.array_equal(logits.argmax(-1).numpy(), tok[:, 0])
        pos = S + step
        if vector_pos:                  # the engine's form: one position per slot
            pos_j, pos_t = jnp.full((B,), pos, jnp.int32), torch.full((B,), pos, dtype=torch.int32)
        else:
            pos_j, pos_t = jnp.int32(pos), pos
        logits_j, cache_j = _decode_j(params, jcfg, RT_J, jnp.asarray(tok), pos_j, cache_j)
        logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache, pos=pos_t)
        close(logits, logits_j)
    assert np.array_equal(cache["attn"]["kv_pos"].numpy(), np.asarray(cache_j["attn"]["kv_pos"]))
    # gemma3 (window 8, 2 local layers of 3): a scalar position against the
    # 32-slot cache (>= 4 * 8) reads an 8-slot slice; nothing else does
    n_local = sum(w is not None for w in transformer.layer_windows(model.cfg, model.cfg.num_layers))
    windowed = model.cfg.sliding_window is not None and MAX_LEN >= 4 * model.cfg.sliding_window
    want = 4 * n_local if windowed and not vector_pos else 0
    assert attention.cached_attention.window_slices - slices == want
    if model.cfg.name.startswith("gemma3"):
        assert want == (0 if vector_pos else 8)


def test_global_flags_match_jax():
    for arch in ("gemma3-4b", "smollm-135m"):
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (reduced_config(arch), jax_reduced_config(arch))):
            flags_j = jax_transformer.global_flags(jcfg, cfg.num_layers)
            flags = transformer.global_flags(cfg, cfg.num_layers)
            assert (flags is None) == (flags_j is None)
            if flags is not None:
                assert flags == np.asarray(flags_j).tolist()
    wins = transformer.layer_windows(get_config("gemma3-4b"), 34)
    assert [i for i, w in enumerate(wins) if w is None] == [5, 11, 17, 23, 29]
    assert set(wins) == {None, 1024}


# (prompt length, priority, interactive, submit_at): under "priority" the
# later high-priority arrivals jump the queue; under "preempt" they evict the
# batch (interactive=False) requests, which re-prefill prompt + output
_JAX_STEPS = {}
ARRIVALS = ((5, 0, False, 0), (14, 0, False, 0), (9, 0, True, 1), (11, 2, True, 2),
            (7, 1, True, 3))
N_NEW = 5


POLICIES = ["fifo", "priority", "preempt"]


@pytest.fixture(scope="module")
def gemma3_pair():
    return make_pair("gemma3-4b")


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_jax(gemma3_pair, policy):
    check_engine(*gemma3_pair, policy)


def check_engine(jcfg, params, model, policy):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n, *_ in ARRIVALS]

    def requests(cls):
        return [cls(rid=i, prompt=prompts[i], max_new_tokens=N_NEW, priority=prio,
                    interactive=inter, submit_at=at)
                for i, (_, prio, inter, at) in enumerate(ARRIVALS)]

    reqs_j = requests(JaxRequest)
    eng_j = JaxServeEngine(jcfg, RT_J, params, slots=2, max_len=MAX_LEN, policy=policy)
    # JaxServeEngine jits its prefill and decode per instance; the engines of
    # the three policies share one config's compiled pair, which changes no value
    eng_j._prefill1, eng_j._decode = _JAX_STEPS.setdefault(
        jcfg.name, (eng_j._prefill1, eng_j._decode))
    out_j = eng_j.run(reqs_j)
    eng = ServeEngine(model.cfg, RT, model, slots=2, max_len=MAX_LEN, policy=policy)
    reqs = requests(Request)
    before = flash_attention.launches
    out = eng.run(reqs)
    assert out == out_j
    record = [(r.admit_step, r.finish_step, r.n_preemptions) for r in reqs]
    assert record == [(r.admit_step, r.finish_step, r.n_preemptions) for r in reqs_j]
    assert (sum(r.n_preemptions for r in reqs) > 0) == (policy == "preempt")
    assert flash_attention.launches == before


@pytest.mark.parametrize("pos", [0, 5, 20, 63])
def test_windowed_decode_slice_matches_jax_and_full_mask(pos):
    """One gemma3 (reduced) attention layer, window 16, a 64-slot cache with
    random contents up to `pos` (empty slots above): the scalar-position
    decode reads the 16 slots from clip(pos - 15, 0, 48) and matches repro's
    windowed branch and the port's per-slot position, which masks the whole
    cache. pos 0 and 63 clamp the slice's start at both ends."""
    jcfg, cfg = jax_reduced_config("gemma3-4b"), reduced_config("gemma3-4b")
    window, B, W = 16, 2, 64
    rng = np.random.default_rng(pos)
    D, hd = cfg.d_model, cfg.hd()
    shapes = {"wq": (D, cfg.n_heads * hd), "wk": (D, cfg.n_kv * hd),
              "wv": (D, cfg.n_kv * hd), "wo": (cfg.n_heads * hd, D)}
    params = {k: (s[0] ** -0.5 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    kv = {n: rng.standard_normal((B, W, cfg.n_kv, hd)).astype(np.float32) for n in ("k", "v")}
    kv["kv_pos"] = np.where(np.arange(W) < pos, np.arange(W), -1).astype(np.int32)[None].repeat(B, 0)
    p = attention.Attention(cfg).requires_grad_(False)
    p.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})

    def port(pos_arg):
        cache_l = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
        return attention.cached_attention(torch.from_numpy(x), p, cfg, RT, cache_l, pos_arg,
                                          window=window)

    out_j, cache_j = jax_attention.cached_attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jcfg, RT_J,
        {n: jnp.asarray(a) for n, a in kv.items()}, jnp.int32(pos), window=window)
    before = attention.cached_attention.window_slices
    out, cache_l = port(pos)
    assert attention.cached_attention.window_slices == before + 1
    out_m, cache_m = port(torch.full((B,), pos, dtype=torch.int32))
    assert attention.cached_attention.window_slices == before + 1
    close(out, out_j)
    close(out, out_m)
    close(cache_l["k"], cache_j["k"])      # the new key and value: fp32 products
    close(cache_l["v"], cache_j["v"])
    assert np.array_equal(cache_l["kv_pos"].numpy(), np.asarray(cache_j["kv_pos"]))
    for name in ("k", "v", "kv_pos"):
        assert torch.equal(cache_l[name], cache_m[name])


def test_launcher_serves_dense_and_refuses_vlm_and_encdec_as_jax_does():
    out = launch_serve.main(["--arch", "gemma3-4b", "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    for arch in ("paligemma-3b", "whisper-small"):
        with pytest.raises(SystemExit) as ej:
            jax_launch_serve.main(["--arch", arch, "--reduced"])
        with pytest.raises(SystemExit) as et:
            launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
        assert str(et.value) == str(ej.value)
