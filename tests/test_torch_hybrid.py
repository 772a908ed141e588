"""The hybrid family (zamba2-1.2b) on its reduced config: the port (CPU,
fp32, plain attention and SSD scan) against `repro` (CPU, fp32, its Pallas
flash-attention and SSD-scan kernels in interpret mode), on the same weights
carried over by `params_from_jax`. The weights are `repro`'s `init_params`
with the leaves it sets to zero (the norms' gains, the conv bias) redrawn
from a seed, so that their arithmetic is held too; SSD chunks of 8, so the
sequences below span several chunks and end ragged.

Held, on the reduced config (4 SSM layers, the shared block after every 2:
two applications) and on a 5-layer variant (one SSM layer left over after
the last application): `CONFIG` and `REDUCED` field by field; the full-width
parameter tree (names, shapes) against `jax.eval_shape` of `init_params`,
and the exact `param_count`, 1,104,937,856 at full width (`repro`'s own
`param_count()` is an approximation there); `forward`, `loss_fn`, `prefill`
and `decode_step` logits (scalar and per-slot positions) and the caches,
within 1e-4 abs and rel (fp32 values of magnitude ~1 summed in different
orders); one SSD call per SSM layer in the forward and the prefill, one
full-sequence attention call per application in the forward and none in
the prefill or decode; the engine's greedy tokens, admit/finish steps and
preemption counts equal repro's under fifo, priority and preempt, and the
engine's slot splice writes every leaf of the nested hybrid cache. The
launcher serves the reduced arch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model, init_cache, loss_fn  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402
from repro_torch.serve.engine import _splice  # noqa: E402
from test_torch_dense import check_engine  # noqa: E402

TOL = 1e-4
CHUNK = 8
RT_J = dataclasses.replace(JAX_CPU_TEST, use_pallas=True, interpret=True, ssd_chunk=CHUNK)
RT = dataclasses.replace(CPU_TEST, ssd_chunk=CHUNK)
MAX_LEN = 48
ARCH = "zamba2-1.2b"
ZAMBA2_PARAMS = 1_104_937_856
# the JAX model functions, jitted (cfg and rt static): eager dispatch of the
# reference on the CPU is slower than compiling it
_prefill_j = jax.jit(jax_model.prefill, static_argnums=(1, 2))
_decode_j = jax.jit(jax_model.decode_step, static_argnums=(1, 2))
_loss_j = jax.jit(jax_model.loss_fn, static_argnums=(1, 2))
_forward_j = jax.jit(jax_model.forward, static_argnums=(1, 2))
# leaves `init_params` sets to zero: redrawn so that their arithmetic shows
_ZERO_INIT = ("ln", "ln1", "ln2", "norm", "conv_b", "final_ln")


def make_pair(num_layers=None, rt=RT):
    """(jax cfg, jax params, port model on the same weights), reduced, with
    `num_layers` SSM layers if given."""
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    params = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)

    def redraw(path, a):
        a = np.asarray(a)
        if path[-1].key in _ZERO_INIT:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    params_np = jax.tree_util.tree_map_with_path(redraw, params)
    model = Model(cfg, rt, seed=None)
    model.load_state_dict(params_from_jax(params_np, cfg))
    return jcfg, jax.tree.map(jnp.asarray, params_np), model


@pytest.fixture(scope="module", params=[None, 5], ids=["reduced", "leftover"])
def pair(request):
    return make_pair(request.param)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_configs_match_jax():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced_config(ARCH), jax_reduced_config(ARCH))):
        for f in dataclasses.fields(cfg):
            if f.name != "ssm":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert hybrid.n_applications(get_config(ARCH)) == 6


def test_full_width_meta_model_matches_jax_param_tree():
    """Full width, without allocating: the port's names and shapes after
    params_from_jax equal jax.eval_shape(init_params), and param_count is
    the exact sum of that tree, norms, conv bias, A_log, D and dt_bias
    included. repro's param_count() folds the MLP in and leaves those out."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    stand_in = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    sd = params_from_jax(stand_in, cfg)
    model = Model(cfg, Runtime(device="meta"))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "layers.shared.attn.wq" in want and "layers.ssm_layers.37.in_proj" in want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port == cfg.param_count() == ZAMBA2_PARAMS
    assert jcfg.param_count() == 1_155_027_968          # repro's approximation
    model.load_state_dict(sd, strict=True, assign=True)


class _Count:
    """Counts the calls of a module-level function and passes them on."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn = 0, getattr(module, name)

        def counted(*a, **kw):
            self.n += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)


def test_forward_and_loss_match_jax(pair, monkeypatch):
    jcfg, params, model = pair
    ssd, mha = _Count(monkeypatch, ssd_ops, "ssd"), _Count(monkeypatch, fa_ops, "mha")
    tokens = _tokens(jcfg.vocab, (2, 20), seed=7)
    labels = _tokens(jcfg.vocab, (2, 20), seed=8)
    labels[0, :3] = -1                                  # masked positions
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    loss_j, met_j = _loss_j(params, jcfg, RT_J, batch_j)
    logits_j, _ = _forward_j(params, jcfg, RT_J, batch_j)
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels)}
    close(model(batch["tokens"]), logits_j)
    assert (ssd.n, mha.n) == (jcfg.num_layers, hybrid.n_applications(jcfg))
    loss, met = loss_fn(model, batch)
    close(loss, loss_j)
    close(met["ce"], met_j["ce"])
    assert float(met["aux"]) == float(met_j["aux"]) == 0.0
    assert float(met["tokens"]) == float(met_j["tokens"]) == 37


@pytest.mark.parametrize("vector_pos", [False, True], ids=["scalar", "per_slot"])
def test_prefill_and_decode_match_jax(pair, vector_pos, monkeypatch):
    jcfg, params, model = pair
    B, S = 2, 19
    tokens = _tokens(jcfg.vocab, (B, S), seed=9)
    logits_j, cache_j = _prefill_j(params, jcfg, RT_J, {"tokens": jnp.asarray(tokens)},
                                   jax_model.init_cache(jcfg, RT_J, B, MAX_LEN))
    ssd, mha = _Count(monkeypatch, ssd_ops, "ssd"), _Count(monkeypatch, fa_ops, "mha")
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  init_cache(model.cfg, RT, B, MAX_LEN))
    assert (ssd.n, mha.n) == (jcfg.num_layers, 0)
    close(logits, logits_j)

    def check_cache():
        for name in ("conv", "ssd"):
            close(cache["ssm"][name], cache_j["ssm"][name])
        for name in ("k", "v"):
            close(cache["attn"][name], cache_j["attn"][name])
        assert np.array_equal(cache["attn"]["kv_pos"].numpy(),
                              np.asarray(cache_j["attn"]["kv_pos"]))

    check_cache()
    assert cache["attn"]["k"].shape[0] == hybrid.n_applications(jcfg)
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
    check_cache()
    assert (ssd.n, mha.n) == (jcfg.num_layers, 0)       # decode runs the recurrence


@pytest.fixture(scope="module")
def reduced_pair():
    return make_pair()


@pytest.mark.parametrize("policy", ["fifo", "priority", "preempt"])
def test_engine_matches_jax(reduced_pair, policy):
    check_engine(*reduced_pair, policy)


def test_engine_splice_writes_every_leaf_of_the_hybrid_cache(reduced_pair):
    """ServeEngine's `_splice` on the nested {"ssm": {conv, ssd}, "attn":
    {k, v, kv_pos}} cache: a B=1 prefill lands in slot 1 of every leaf,
    whose first two axes are (layers or applications, batch), and the
    other slots keep their contents."""
    _, _, model = reduced_pair
    cfg = model.cfg
    cache = init_cache(cfg, RT, 3, MAX_LEN)
    _, cache1 = model.prefill(torch.from_numpy(_tokens(cfg.vocab, (1, 11), seed=3)).long(),
                              init_cache(cfg, RT, 1, MAX_LEN))
    _splice(cache, cache1, 1)
    n_app = hybrid.n_applications(cfg)
    for group, n in (("ssm", cfg.num_layers), ("attn", n_app)):
        for name, leaf in cache[group].items():
            small = cache1[group][name]
            assert leaf.shape[:2] == (n, 3) and small.shape[:2] == (n, 1)
            assert torch.equal(leaf[:, 1:2], small)
            empty = init_cache(cfg, RT, 1, MAX_LEN)[group][name]
            assert torch.equal(leaf[:, 0:1], empty) and torch.equal(leaf[:, 2:3], empty)
            assert not torch.equal(small, empty)


def test_launcher_serves_the_hybrid():
    out = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert all(0 <= t < 256 for v in out.values() for t in v)
