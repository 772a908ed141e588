"""Trace replay: the port's copy of the serving part of `core.traces`
(`repro_torch.core.traces`) against `repro.core.traces`, and
`ServeEngine.replay_trace` against the schedule.

Held: the three generators give `repro`'s traces for the same seeds and
arguments (one and two tenants); `trace_schedule` gives `repro`'s schedule
bit for bit (every field) under fifo, priority and preempt, on bursty,
diurnal and Poisson traces; a trace round-trips through JSON. The port's
`replay_trace` on a reduced dense model (smollm-135m) and on reduced
zamba2-1.2b (fp32, CPU) records the admit steps, finish steps and
preemption counts of `repro`'s `trace_schedule` bit for bit under all
three policies, its greedy tokens equal `repro`'s engine's replay of the
same trace, and a request that was preempted and resumed decodes the same
tokens as it does alone (`tests/test_traces.py`'s checks of the JAX engine).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import traces as jax_traces  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import replay_trace as jax_replay_trace  # noqa: E402
from repro_torch.core import traces  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, replay_trace  # noqa: E402
from test_torch_dense import RT_J  # noqa: E402
from test_torch_dense import make_pair as make_dense_pair  # noqa: E402
from test_torch_hybrid import RT as RT_HYBRID  # noqa: E402
from test_torch_hybrid import RT_J as RT_J_HYBRID  # noqa: E402
from test_torch_hybrid import make_pair as make_hybrid_pair  # noqa: E402

POLICIES = ["fifo", "priority", "preempt"]
MAX_LEN = 64
SLOTS = 3


def _tenants(mod):
    return (mod.TenantClass("chat", ttft_s=5.0, tpot_s=0.1, priority=2, interactive=True),
            mod.TenantClass("batch", ttft_s=1e4, tpot_s=1e3, priority=0, interactive=False))


def _trace(mod, kind="spike", n=12, seed=11, **kw):
    """tests/test_traces.py's replay trace (narrow prompt and output ranges)
    built by `mod`, the port's traces module or repro's."""
    return mod.synth_trace(kind, n, seed=seed, tenants=_tenants(mod), shares=(0.5, 0.5),
                           prompt_ranges=((4, 8), (4, 8)), out_ranges=((2, 5), (4, 8)), **kw)


@pytest.mark.parametrize("kind", ["poisson", "spike", "diurnal"])
def test_generators_give_jax_traces(kind):
    for seed in (0, 3):
        assert (traces.synth_trace(kind, 40, seed=seed).to_dict()
                == jax_traces.synth_trace(kind, 40, seed=seed).to_dict())
        assert (_trace(traces, kind, 40, seed).to_dict()
                == _trace(jax_traces, kind, 40, seed).to_dict())
    with pytest.raises(ValueError, match="unknown trace kind"):
        traces.synth_trace("bursty", 4)


def test_trace_json_round_trip():
    t = _trace(traces, n=24, seed=9)
    assert traces.RequestTrace.from_json(t.to_json()) == t
    assert hash(t) == hash(traces.RequestTrace.from_dict(t.to_dict()))
    with pytest.raises(ValueError, match="nondecreasing"):
        traces.RequestTrace((3, 1), (4, 4), (2, 2), (0, 0))


@pytest.mark.parametrize("policy", POLICIES)
def test_trace_schedule_matches_jax_bitwise(policy):
    cases = [("spike", dict(rate=0.4, spike_factor=6.0, spike_len=8, gap_len=24)),
             ("diurnal", dict(rate=0.3, period=64)), ("poisson", dict(rate=1.5))]
    for kind, kw in cases:
        for slots in (1, 3, 8):
            t, tj = _trace(traces, kind, 60, 5, **kw), _trace(jax_traces, kind, 60, 5, **kw)
            s, sj = traces.trace_schedule(t, slots, policy), jax_traces.trace_schedule(tj, slots,
                                                                                       policy)
            assert (s.n_steps, s.n_decode_steps, s.n_preemptions) == (
                sj.n_steps, sj.n_decode_steps, sj.n_preemptions)
            for f in ("admit_step", "finish_step", "decode_tokens", "event_step", "event_req",
                      "event_ctx", "first_event"):
                np.testing.assert_array_equal(getattr(s, f), getattr(sj, f), f)
    with pytest.raises(ValueError, match="disaggregated"):
        traces.trace_schedule(t, 2, "disaggregated")


_REPLAY_KW = dict(rate=0.4, spike_factor=6.0, spike_len=8, gap_len=24)


@pytest.fixture(scope="module", params=["smollm-135m", "zamba2-1.2b"])
def replay_pair(request):
    """(jax cfg, jax params, port model, jax runtime, port runtime)."""
    if request.param == "zamba2-1.2b":
        return (*make_hybrid_pair(), RT_J_HYBRID, RT_HYBRID)
    from test_torch_dense import RT
    return (*make_dense_pair(request.param), RT_J, RT)


@pytest.mark.parametrize("policy", POLICIES)
def test_replay_matches_the_schedule_and_jax(replay_pair, policy):
    jcfg, params, model, rt_j, rt = replay_pair
    t = _trace(traces, **_REPLAY_KW)
    reqs = replay_trace(ServeEngine(model.cfg, rt, model, slots=SLOTS, max_len=MAX_LEN,
                                    policy=policy), t)
    s = jax_traces.trace_schedule(_trace(jax_traces, **_REPLAY_KW), SLOTS, policy)
    np.testing.assert_array_equal([r.admit_step for r in reqs], s.admit_step)
    np.testing.assert_array_equal([r.finish_step for r in reqs], s.finish_step)
    assert sum(r.n_preemptions for r in reqs) == s.n_preemptions
    assert (s.n_preemptions > 0) == (policy == "preempt")
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    if policy == "preempt":         # the tokens too, against repro's engine
        eng_j = JaxServeEngine(jcfg, rt_j, params, slots=SLOTS, max_len=MAX_LEN,
                               policy=policy)
        reqs_j = jax_replay_trace(eng_j, _trace(jax_traces, **_REPLAY_KW))
        assert [r.output for r in reqs] == [r.output for r in reqs_j]


def test_preempted_request_decodes_the_same_tokens(replay_pair):
    _, _, model, _, rt = replay_pair
    t = _trace(traces, **_REPLAY_KW)
    assert traces.trace_schedule(t, SLOTS, "preempt").n_preemptions >= 1
    eng = ServeEngine(model.cfg, rt, model, slots=SLOTS, max_len=MAX_LEN, policy="preempt")
    reqs = replay_trace(eng, t, rng=np.random.default_rng(4))
    victims = [r for r in reqs if r.n_preemptions > 0]
    assert victims
    for v in victims:
        solo = ServeEngine(model.cfg, rt, model, slots=1, max_len=MAX_LEN).run(
            [Request(0, v.prompt, v.max_new_tokens)])[0]
        assert solo == v.output
