"""The whole slice on the reduced mamba2 config: the port (CPU, fp32, plain
SSD) against `repro` (CPU, fp32, the Pallas SSD kernel in interpret mode),
both with SSD chunks of 8 and the same weights.

Held: prefill, decode-step and full-sequence logits (1e-4 abs and rel: fp32
logits of magnitude < 1, summed in different orders), the greedy tokens and
admit/finish steps of a ServeEngine run (identical), and the ValueErrors
of `submit` (identical messages).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model, init_cache  # noqa: E402
from repro_torch.models.runtime import CPU_TEST  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import sample_logits  # noqa: E402

TOL = 1e-4
CHUNK = 8
RT_J = dataclasses.replace(JAX_CPU_TEST, use_pallas=True, interpret=True, ssd_chunk=CHUNK)
RT = dataclasses.replace(CPU_TEST, ssd_chunk=CHUNK)
PROMPT_LENS = (5, 26, 11, 17)
N_NEW = 6
# the JAX model functions, jitted (cfg and rt static): eager dispatch of the
# reference on the CPU is slower than compiling it
_prefill_j = jax.jit(jax_model.prefill, static_argnums=(1, 2))
_decode_j = jax.jit(jax_model.decode_step, static_argnums=(1, 2))
_forward_j = jax.jit(jax_model.forward, static_argnums=(1, 2))


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model on the same weights)."""
    jcfg = jax_reduced_config("mamba2-370m")
    params = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    cfg = reduced_config("mamba2-370m")
    model = Model(cfg, RT, seed=None)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def test_prefill_decode_and_forward_logits_match_jax(pair):
    jcfg, params, model = pair
    tokens = _prompts(jcfg.vocab)[1][None]                    # S=26: 4 chunks
    logits_j, cache_j = _prefill_j(
        params, jcfg, RT_J, {"tokens": jnp.asarray(tokens)},
        jax_model.init_cache(jcfg, RT_J, 1, 64))
    logits, cache = model.prefill(torch.from_numpy(tokens).long(),
                                  init_cache(model.cfg, RT, 1, 64))
    _close(logits, logits_j)
    _close(cache["ssd"], cache_j["ssm"]["ssd"])
    _close(cache["conv"], cache_j["ssm"]["conv"])
    pos = tokens.shape[1]
    for _ in range(3):
        tok = int(np.argmax(np.asarray(logits_j[0])))
        assert int(logits[0].argmax()) == tok
        logits_j, cache_j = _decode_j(
            params, jcfg, RT_J, jnp.asarray([[tok]], jnp.int32), jnp.int32(pos), cache_j)
        logits, cache = model.decode_step(torch.tensor([[tok]]), cache)
        _close(logits, logits_j)
        pos += 1

    batch = np.stack([_prompts(jcfg.vocab)[3][:13], _prompts(jcfg.vocab)[1][:13]])
    fwd_j, _ = _forward_j(params, jcfg, RT_J, {"tokens": jnp.asarray(batch)})
    _close(model(torch.from_numpy(batch).long()), fwd_j)


# (prompt index, priority, interactive, submit_at): under "preempt" the
# late high-priority arrivals evict the batch (interactive=False) requests
ARRIVALS = ((0, 0, False, 0), (1, 0, False, 0), (2, 2, True, 2), (3, 1, True, 3))


@pytest.mark.parametrize("policy", ["fifo", "preempt"])
def test_engine_greedy_tokens_match_jax(pair, policy):
    jcfg, params, model = pair
    prompts = _prompts(jcfg.vocab)

    def requests(cls):
        return [cls(rid=i, prompt=prompts[k], max_new_tokens=N_NEW, priority=prio,
                    interactive=inter, submit_at=at)
                for i, (k, prio, inter, at) in enumerate(ARRIVALS)]

    eng_j = JaxServeEngine(jcfg, RT_J, params, slots=2, max_len=64, policy=policy)
    reqs_j = requests(JaxRequest)
    out_j = eng_j.run(reqs_j)
    eng = ServeEngine(model.cfg, RT, model, slots=2, max_len=64, policy=policy)
    reqs = requests(Request)
    before = ssd_scan.launches
    out = eng.run(reqs)
    assert out == out_j
    assert all(len(v) == N_NEW for v in out.values())
    record = [(r.admit_step, r.finish_step, r.n_preemptions) for r in reqs]
    assert record == [(r.admit_step, r.finish_step, r.n_preemptions) for r in reqs_j]
    assert sum(r.n_preemptions for r in reqs) == (2 if policy == "preempt" else 0)
    assert eng.n_admits == len(prompts) + sum(r.n_preemptions for r in reqs)
    assert ssd_scan.launches == before               # CPU tensors never launch


def test_submit_errors_match_jax(pair):
    jcfg, params, model = pair
    eng_j = JaxServeEngine(jcfg, RT_J, params, slots=2, max_len=16)
    eng = ServeEngine(model.cfg, RT, model, slots=2, max_len=16)
    bad = [dict(rid=0, prompt=np.zeros(12, np.int32), max_new_tokens=8),
           dict(rid=1, prompt=np.zeros(3, np.int32), max_new_tokens=2, submit_at=-1)]
    for kw in bad:
        with pytest.raises(ValueError) as ej:
            eng_j.submit(JaxRequest(**kw))
        with pytest.raises(ValueError) as et:
            eng.submit(Request(**kw))
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="policy"):
        ServeEngine(model.cfg, RT, model, policy="lifo")


def test_sample_logits_greedy_and_temperature():
    logits = torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, 0.0]])
    assert sample_logits(logits).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    draws = {tuple(sample_logits(logits, g, torch.tensor([2.0, 0.0])).tolist())
             for _ in range(50)}
    assert all(d[1] == 0 for d in draws)            # T=0 row stays greedy
    assert {d[0] for d in draws} <= {0, 1, 2} and len({d[0] for d in draws}) > 1

