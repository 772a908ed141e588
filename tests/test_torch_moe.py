"""The MoE decoder family on its reduced configs (mixtral-8x7b, grok-1-314b):
the port (CPU, fp32, plain attention) against `repro` (CPU, fp32, its Pallas
flash-attention kernel in interpret mode), on the same weights, through the
checks that tests/test_torch_dense.py defines for every decoder arch
(configs, full-width parameter tree and count, forward, loss_fn with the aux
loss, prefill, decode, the engine under three policies), plus:

- `moe_mlp` against repro's at T <= 256 (capacity C = T, nothing drops), at
  T > 256 with a capacity factor small enough that (token, choice) pairs
  drop (asserted), and without the gated MLP; output and aux within 1e-4;
- `moe_mlp.dropped` counts exactly the pairs that the capacity dropped;
- the windowed decode branch on mixtral, whose layers are all windowed: a
  cache of 4x the window, decoded at scalar positions past the window,
  against repro's (which takes its own windowed branch) and against the
  port's per-slot positions (which mask the whole cache) within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from test_torch_dense import (  # noqa: E402
    POLICIES,
    RT,
    RT_J,
    _decode_j,
    _prefill_j,
    check_configs,
    check_engine,
    check_forward_and_loss,
    check_param_tree,
    check_prefill_and_decode,
    close,
    make_pair,
)

ARCHS = ["mixtral-8x7b", "grok-1-314b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_meta_model_matches_jax_param_tree(arch):
    check_param_tree(arch)


def test_mixtral_depth_cut_parameter_count():
    """mixtral-8x7b does not fit one card in fp32 at its 32 layers; the
    on-card run keeps 4 (the router and the untied unembed count)."""
    cfg = get_config("mixtral-8x7b")
    assert cfg.param_count() == 46_702_792_704
    assert dataclasses.replace(cfg, num_layers=4).param_count() == 6_067_228_672


def test_forward_and_loss_match_jax(pair):
    check_forward_and_loss(*pair)


@pytest.mark.parametrize("vector_pos", [False, True], ids=["scalar", "per_slot"])
def test_prefill_and_decode_match_jax(pair, vector_pos):
    check_prefill_and_decode(*pair, vector_pos)


@pytest.fixture(scope="module")
def mixtral_pair():
    return make_pair("mixtral-8x7b")


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_jax(mixtral_pair, policy):
    check_engine(*mixtral_pair, policy)


MOE_CASES = {
    # id: (B, S, capacity_factor, glu)
    "T40_no_drops": (2, 20, 1.25, True),
    "T300_drops": (2, 150, 0.5, True),
    "T40_no_glu": (2, 20, 1.25, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    B, S, cf, glu = MOE_CASES[case]
    jcfg = jax_reduced_config("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, glu=glu,
                               moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    base = reduced_config("mixtral-8x7b")
    cfg = dataclasses.replace(base, glu=glu,
                              moe=dataclasses.replace(base.moe, capacity_factor=cf))
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    rng = np.random.default_rng(2)
    shapes = {"router": (D, E), "wi": (E, D, Fd), "wo": (E, Fd, D)}
    if glu:
        shapes["wg"] = (E, D, Fd)
    params = {k: (s[-2] ** -0.5 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    out_j, aux_j = jax_moe.moe_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in params.items()},
                                   jcfg, JAX_CPU_TEST)
    p = moe.MoE(cfg).requires_grad_(False)
    p.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    moe.moe_mlp.dropped = 0
    out, aux = moe.moe_mlp(torch.from_numpy(h), p, cfg, RT)
    close(out, out_j)
    close(aux, aux_j)
    n_drop = int(moe.moe_mlp.dropped)
    r = moe.route(torch.from_numpy(h).reshape(B * S, D), p, cfg, RT)
    assert n_drop == int((~r.keep).sum())
    T = B * S
    if T <= 256:
        assert r.capacity == T and n_drop == 0
    else:
        assert r.capacity == int(cf * cfg.moe.top_k * T / E) < T
        assert n_drop > 0
        assert int(r.keep.sum()) <= E * r.capacity


def test_windowed_decode_matches_jax_and_full_mask(mixtral_pair):
    """mixtral reduced (window 16 on every layer) with a 64-slot cache, 4x
    the window, so that each scalar-position decode step reads only the
    window's 16 slots. 24 steps from position 8 move the slice's start past
    0. Against repro's own windowed branch and against the port's per-slot
    positions, which mask the whole cache instead."""
    jcfg, params, model = mixtral_pair
    B, S, n_steps, max_len = 2, 8, 24, 64
    window = jcfg.sliding_window
    assert window == 16 and max_len >= 4 * window
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S + n_steps)).astype(np.int32)

    def roll_port(per_slot):
        cache = init_cache(model.cfg, RT, B, max_len)
        logits, cache = model.prefill(torch.from_numpy(tokens[:, :S]).long(), cache)
        outs = [logits]
        for t in range(S, S + n_steps):
            pos = torch.full((B,), t, dtype=torch.int32) if per_slot else t
            logits, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]).long(),
                                              cache, pos=pos)
            outs.append(logits)
        return torch.stack(outs), cache

    cache_j = jax_model.init_cache(jcfg, RT_J, B, max_len)
    logits_j, cache_j = _prefill_j(params, jcfg, RT_J, {"tokens": jnp.asarray(tokens[:, :S])},
                                   cache_j)
    want = [logits_j]
    for t in range(S, S + n_steps):
        logits_j, cache_j = _decode_j(params, jcfg, RT_J, jnp.asarray(tokens[:, t:t + 1]),
                                      jnp.int32(t), cache_j)
        want.append(logits_j)
    before = attention.cached_attention.window_slices
    sliced, cache = roll_port(per_slot=False)
    assert attention.cached_attention.window_slices - before == n_steps * jcfg.num_layers
    masked, cache_m = roll_port(per_slot=True)
    assert attention.cached_attention.window_slices - before == n_steps * jcfg.num_layers
    close(sliced, np.stack([np.asarray(w) for w in want]))
    close(sliced, masked)
    # layer 1's keys and values sit on layer 0's attention, whose softmax
    # sums 16 terms on one side and 64 (48 of them 0) on the other
    close(cache["attn"]["k"], cache_m["attn"]["k"])
    close(cache["attn"]["v"], cache_m["attn"]["v"])
    assert torch.equal(cache["attn"]["kv_pos"], cache_m["attn"]["kv_pos"])
