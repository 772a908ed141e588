"""The serving half of the port's DSE loop on the CPU, against `repro`.

`repro_torch.core.serving`, `heterogeneity` and the DSE half of `traces`
are NumPy copies whose per-step evaluations go through the port's
evaluator (the float64 torch program for the analytical fidelity, on the
CPU here); `repro` runs its NumPy pipeline (REPRO_COMPILED_EVAL=0: its
compiled evaluator does not run on this JAX). Every float of every result
is held hex-equal (`float.hex`) to `repro`'s: the schedules, the metric
arrays, `evaluate_serving_batch`, the three hetero evaluators at every
granularity, `evaluate_trace_serving_batch` under every policy, the policy
candidates, and `RequestMix.as_trace`. The three shipped serving specs run
through the port's campaign to ROADMAP's budgets and hypervolumes with
`repro`'s trace bit for bit, and a resumed run equals the uninterrupted
one bit for bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import heterogeneity as j_het  # noqa: E402
from repro.core import serving as j_srv  # noqa: E402
from repro.core import traces as j_tr  # noqa: E402
from repro.core import workload as j_wl  # noqa: E402
from repro.core.design_space import decode_batch as j_decode_batch  # noqa: E402
from repro.core.evaluator import clear_eval_cache as j_clear  # noqa: E402
from repro.core.validator import validate_batch as j_validate_batch  # noqa: E402
from repro.explore import Campaign as JCampaign  # noqa: E402
from repro.explore import CampaignSpec as JSpec  # noqa: E402
from repro_torch.core import heterogeneity as het  # noqa: E402
from repro_torch.core import serving as srv  # noqa: E402
from repro_torch.core import traces as tr  # noqa: E402
from repro_torch.core import workload as wlm  # noqa: E402
from repro_torch.core.design_space import decode_batch  # noqa: E402
from repro_torch.core.evaluator import clear_eval_cache  # noqa: E402
from repro_torch.core.fidelity import AnalyticalBackend  # noqa: E402
from repro_torch.core.validator import validate_batch  # noqa: E402
from repro_torch.explore import Campaign, CampaignSpec, ExplorationLoop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "examples", "campaigns")
# ROADMAP's baselines: (evaluations, hypervolume to 3 decimals)
BASELINES = {"gpt175b_serving_slo": (10, 34.370),
             "gpt175b_hetero_serving": (6, 19.458),
             "gpt175b_trace_serving": (8, 19.204)}
CPU = AnalyticalBackend(device="cpu")


@pytest.fixture(autouse=True)
def _numpy_reference(monkeypatch):
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    j_clear()
    clear_eval_cache()


def _hexed(o):
    """A result as nested plain data, every float as its hex bit pattern."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return {f.name: _hexed(getattr(o, f.name)) for f in dataclasses.fields(o)}
    if isinstance(o, dict):
        return {k: _hexed(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_hexed(v) for v in o]
    if isinstance(o, np.ndarray):
        return [_hexed(v) for v in o.tolist()]
    if isinstance(o, (bool, np.bool_)):
        return bool(o)
    if isinstance(o, (int, np.integer)):
        return int(o)
    if isinstance(o, (float, np.floating)):
        return float(o).hex()
    return o


def _designs(n, seed):
    """The first n valid designs of a seeded draw, in both packages."""
    U = np.random.default_rng(seed).random((8 * n, 13))
    ours = [r.design for r in validate_batch(decode_batch(U)) if r.ok][:n]
    theirs = [r.design for r in j_validate_batch(j_decode_batch(U)) if r.ok][:n]
    assert [str(d) for d in ours] == [str(d) for d in theirs] and len(ours) == n
    return ours, theirs


def _tenants(mod):
    return (mod.TenantClass("chat", ttft_s=4.0, tpot_s=0.08, priority=2, interactive=True),
            mod.TenantClass("batch", ttft_s=1e4, tpot_s=1e3, priority=0, interactive=False))


def _trace(mod, kind="spike", n=24, seed=3):
    if kind == "spike":
        return mod.spike_trace(n, tenants=_tenants(mod), shares=(0.5, 0.5), seed=seed)
    if kind == "poisson":
        return mod.poisson_trace(n, rate=0.3, tenants=_tenants(mod), shares=(0.6, 0.4),
                                 seed=seed)
    return mod.RequestMix.uniform(n, 512, 32).as_trace()


WL = 7                                  # GPT_BENCHMARKS[7]: GPT-175B


# ---------------------------------------------------------------------------
# core.serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [1, 3, 8])
def test_schedules_and_metrics_equal_repro(slots):
    rng = np.random.default_rng(slots)
    mix = wlm.RequestMix.sampled(np.random.default_rng(slots), 13, (64, 2048), (1, 96))
    jmix = j_wl.RequestMix.sampled(np.random.default_rng(slots), 13, (64, 2048), (1, 96))
    assert mix.prompt_lens == jmix.prompt_lens and mix.out_lens == jmix.out_lens
    for ours, theirs in ((srv.continuous_batch_schedule(mix, slots),
                          j_srv.continuous_batch_schedule(jmix, slots)),
                         (srv._continuous_batch_schedule_ref(mix, slots),
                          j_srv._continuous_batch_schedule_ref(jmix, slots))):
        assert _hexed(ours) == _hexed(theirs)
    sched, jsched = (srv.continuous_batch_schedule(mix, slots),
                     j_srv.continuous_batch_schedule(jmix, slots))
    tp, td = rng.random(5) * 2, rng.random(5) * 0.1
    slo, jslo = srv.ServingSLO(3.0, 0.05), j_srv.ServingSLO(3.0, 0.05)
    assert _hexed(srv.serving_metrics(sched, mix, slo, tp, 1000, td)) == \
        _hexed(j_srv.serving_metrics(jsched, jmix, jslo, tp, 1000, td))
    tpre = rng.random(13)
    kv = rng.random(13) * 0.01
    assert _hexed(srv.disaggregated_metrics(mix, slo, slots, tpre, kv, 0.03)) == \
        _hexed(j_srv.disaggregated_metrics(jmix, jslo, slots, tpre, kv, 0.03))


@pytest.mark.parametrize("slots", [4, 8])
def test_evaluate_serving_batch_equals_repro(slots):
    ours, theirs = _designs(6, seed=11)
    mix = wlm.RequestMix.uniform(12, 1024, 48)
    jmix = j_wl.RequestMix.uniform(12, 1024, 48)
    got = srv.evaluate_serving_batch(ours, wlm.GPT_BENCHMARKS[WL], mix,
                                     srv.ServingSLO(5.0, 0.05), slots=slots,
                                     fidelity=CPU, max_strategies=8)
    want = j_srv.evaluate_serving_batch(theirs, j_wl.GPT_BENCHMARKS[WL], jmix,
                                        j_srv.ServingSLO(5.0, 0.05), slots=slots,
                                        max_strategies=8)
    assert any(r.feasible for r in want)
    assert _hexed(got) == _hexed(want)
    # the scalar wrapper and the evaluator's forwarder give the same result
    from repro_torch.core.evaluator import evaluate_serving_batch
    one = srv.evaluate_serving(ours[0], wlm.GPT_BENCHMARKS[WL], mix,
                               srv.ServingSLO(5.0, 0.05), slots=slots, fidelity=CPU,
                               max_strategies=8)
    fwd = evaluate_serving_batch(ours[:1], wlm.GPT_BENCHMARKS[WL], mix,
                                 srv.ServingSLO(5.0, 0.05), slots=slots, fidelity=CPU,
                                 max_strategies=8)
    assert _hexed(one) == _hexed(got[0]) == _hexed(fwd[0])


# ---------------------------------------------------------------------------
# core.heterogeneity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("granularity", ["core", "reticle", "wafer"])
def test_hetero_evaluators_equal_repro(granularity):
    ours, theirs = _designs(2, seed=5)
    wl, jwl = wlm.GPT_BENCHMARKS[WL], j_wl.GPT_BENCHMARKS[WL]
    base = wlm.inference_workload(wl, "decode", batch=8, seq=2048)
    jbase = j_wl.inference_workload(jwl, "decode", batch=8, seq=2048)
    got = het.evaluate_hetero(ours[0], ours[1], base, granularity, 0.4, n_wafers=8,
                              fidelity=CPU)
    want = j_het.evaluate_hetero(theirs[0], theirs[1], jbase, granularity, 0.4,
                                 n_wafers=8)
    assert _hexed(got) == _hexed(want)
    mix, jmix = wlm.RequestMix.uniform(8, 1024, 64), j_wl.RequestMix.uniform(8, 1024, 64)
    got = het.evaluate_hetero_serving(ours[0], ours[1], wl, granularity, 0.5, mix,
                                      srv.ServingSLO(10.0, 0.1), slots=4, n_wafers=8,
                                      fidelity=CPU)
    want = j_het.evaluate_hetero_serving(theirs[0], theirs[1], jwl, granularity, 0.5,
                                         jmix, j_srv.ServingSLO(10.0, 0.1), slots=4,
                                         n_wafers=8)
    assert _hexed(got) == _hexed(want)
    got = het.evaluate_hetero_trace_serving(ours[0], ours[1], wl, granularity, 0.5,
                                            _trace(tr), slots=4, window_steps=16,
                                            n_wafers=8, fidelity=CPU)
    want = j_het.evaluate_hetero_trace_serving(theirs[0], theirs[1], jwl, granularity,
                                               0.5, _trace(j_tr), slots=4,
                                               window_steps=16, n_wafers=8)
    assert _hexed(got) == _hexed(want)
    assert het.wafer_split(8, 0.99) == j_het.wafer_split(8, 0.99)


# ---------------------------------------------------------------------------
# core.traces, the DSE half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["spike", "poisson", "mix"])
@pytest.mark.parametrize("policy", ["fifo", "priority", "preempt"])
def test_trace_schedules_and_metrics_equal_repro(kind, policy):
    t, jt = _trace(tr, kind), _trace(j_tr, kind)
    ref = tr._trace_schedule_ref(t, 4, policy)
    assert _hexed(ref) == _hexed(j_tr._trace_schedule_ref(jt, 4, policy))
    assert _hexed(ref) == _hexed(tr.trace_schedule(t, 4, policy))
    rng = np.random.default_rng(len(kind))
    tp, td = rng.random(4) * 2, rng.random(4) * 0.1
    assert _hexed(tr.trace_serving_metrics(ref, t, tp, 700, td, window_steps=16)) == \
        _hexed(j_tr.trace_serving_metrics(j_tr.trace_schedule(jt, 4, policy), jt, tp,
                                          700, td, window_steps=16))
    tpre, kv = rng.random(t.n_requests), rng.random(t.n_requests) * 0.01
    assert _hexed(tr.trace_disaggregated_metrics(t, 4, tpre, kv, 0.04, 16)) == \
        _hexed(j_tr.trace_disaggregated_metrics(jt, 4, tpre, kv, 0.04, 16))
    assert (t.mean_prompt, t.mean_out, t.total_out_tokens(), t.context_len()) == \
        (jt.mean_prompt, jt.mean_out, jt.total_out_tokens(), jt.context_len())
    assert (t.mix().prompt_lens, t.mix().out_lens) == (jt.mix().prompt_lens,
                                                      jt.mix().out_lens)


def test_evaluate_trace_serving_batch_every_policy_equals_repro():
    ours, theirs = _designs(3, seed=5)
    t, jt = _trace(tr), _trace(j_tr)
    cands = [tr.PolicyDesign(ours[i % 3], p) for i, p in enumerate(tr.POLICIES)]
    jcands = [j_tr.PolicyDesign(theirs[i % 3], p) for i, p in enumerate(j_tr.POLICIES)]
    got = tr.evaluate_trace_serving_batch(cands, wlm.GPT_BENCHMARKS[WL], t, slots=4,
                                          window_steps=16, fidelity=CPU, max_strategies=8)
    want = j_tr.evaluate_trace_serving_batch(jcands, j_wl.GPT_BENCHMARKS[WL], jt, slots=4,
                                             window_steps=16, max_strategies=8)
    assert [r.policy for r in got] == list(tr.POLICIES)
    assert any(r.feasible for r in want)
    assert _hexed(got) == _hexed(want)
    plain = tr.evaluate_trace_serving(ours[0], wlm.GPT_BENCHMARKS[WL], t, slots=4,
                                      policy="priority", window_steps=16, fidelity=CPU,
                                      max_strategies=8)
    jplain = j_tr.evaluate_trace_serving(theirs[0], j_wl.GPT_BENCHMARKS[WL], jt, slots=4,
                                         policy="priority", window_steps=16,
                                         max_strategies=8)
    assert _hexed(plain) == _hexed(jplain)
    assert "policy=" in cands[0].describe() and cands[0].describe() == jcands[0].describe()


@pytest.mark.parametrize("policies", [tuple(tr.POLICIES), ("priority", "disaggregated")])
def test_sample_policy_candidates_equal_repro(policies):
    pts, cands = tr.sample_policy_candidates(np.random.default_rng(2), 16, policies)
    jpts, jcands = j_tr.sample_policy_candidates(np.random.default_rng(2), 16, policies)
    assert pts.shape == (16, 14) and np.array_equal(pts, jpts)
    assert [(str(c.design), c.policy) for c in cands] == \
        [(str(c.design), c.policy) for c in jcands]
    with pytest.raises(ValueError, match="policy"):
        tr.PolicyDesign(cands[0].design, "lifo")


def test_request_mix_as_trace_equals_repro():
    mix = wlm.RequestMix((100, 2000, 7), (5, 1, 64))
    jmix = j_wl.RequestMix((100, 2000, 7), (5, 1, 64))
    t, jt = mix.as_trace(), jmix.as_trace()
    assert isinstance(t, tr.RequestTrace)
    assert json.loads(t.to_json()) == json.loads(jt.to_json())
    assert t == tr.RequestTrace.from_mix(mix, tr.DEFAULT_TENANT)
    solo = tr.TenantClass("solo", ttft_s=1.0, tpot_s=0.01)
    assert json.loads(mix.as_trace(solo).to_json()) == \
        json.loads(jmix.as_trace(j_tr.TenantClass("solo", ttft_s=1.0,
                                                  tpot_s=0.01)).to_json())
    assert t.tenants[0].slo() == srv.ServingSLO(t.tenants[0].ttft_s, t.tenants[0].tpot_s)
    # the degenerate trace's schedule is the one-batch schedule
    a, b = tr.trace_schedule(t, 2, "fifo"), srv.continuous_batch_schedule(mix, 2)
    assert (a.n_decode_steps, a.admit_step.tolist(), a.finish_step.tolist()) == \
        (b.n_decode_steps, b.admit_step.tolist(), b.finish_step.tolist())


# ---------------------------------------------------------------------------
# the three shipped serving specs through the port's campaign
# ---------------------------------------------------------------------------


def _spec_path(name):
    return os.path.join(SPECS, f"{name}.json")


def _hex_trace(t):
    return ([[float(v).hex() for v in x] for x in t.xs],
            [[float(a).hex(), float(b).hex()] for a, b in t.ys],
            [float(h).hex() for h in t.hv], [str(d) for d in t.designs])


@pytest.mark.parametrize("name", list(BASELINES))
def test_serving_campaign_matches_repro(name):
    want = JCampaign(JSpec.from_json(_spec_path(name))).run()
    got = Campaign(CampaignSpec.from_json(_spec_path(name)), device="cpu").run()
    n_evals, hv = BASELINES[name]
    assert got.finished and got.n_evals == want.n_evals == n_evals
    assert round(got.hv_final, 3) == round(want.hv_final, 3) == hv
    assert _hex_trace(got.trace) == _hex_trace(want.trace)
    assert got.front == want.front
    assert got.stage_cache == want.stage_cache
    assert got.objective_stats == want.objective_stats


def test_trace_serving_resume_is_bit_identical(tmp_path):
    spec = CampaignSpec.from_json(_spec_path("gpt175b_trace_serving"))
    full = Campaign(spec, device="cpu").run()
    ckpt = str(tmp_path / "run.ckpt")
    clear_eval_cache()
    part = Campaign(spec, device="cpu").run(checkpoint_path=ckpt, max_steps=1)
    assert not part.finished
    assert ExplorationLoop.load_state(ckpt)[1].steps == 1
    clear_eval_cache()
    resumed = Campaign.resume(ckpt, device="cpu").run(checkpoint_path=ckpt)
    assert resumed.finished and resumed.n_evals == full.n_evals == 8
    assert _hex_trace(resumed.trace) == _hex_trace(full.trace)
    assert resumed.objective_stats == full.objective_stats
