"""Joint strategy–architecture exploration in the port against `repro`, on the
CPU: the shardability oracle's verdicts for all ten archs, the pinned
(joint) evaluator hex-equal to the port's NumPy pinned path and to
`repro`'s `evaluate_joint_batch` on its NumPy pipeline
(REPRO_COMPILED_EVAL=0: `repro`'s compiled evaluator does not run on this
JAX), pinned points replaying the grid argmin bit for bit,
`validate_joint_batch`'s verdicts, joint campaigns (a small one and the
shipped gpt175b_joint_dse) with the same points bit for bit plus a resume,
and `export` (the JSON, its verdicts, and the port's launcher running an
exported config)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.core import compiler as jc  # noqa: E402
from repro.core import design_space as jds  # noqa: E402
from repro.core import evaluator as jev  # noqa: E402
from repro.core import validator as jv  # noqa: E402
from repro.core import workload as jw  # noqa: E402
from repro.dist import oracle as j_oracle  # noqa: E402
from repro.explore import Campaign as JCampaign  # noqa: E402
from repro.explore import CampaignSpec as JSpec  # noqa: E402
from repro.explore import export as j_export  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import evaluator as ev  # noqa: E402
from repro_torch.core import workload as tw  # noqa: E402
from repro_torch.core.compiler import Strategy  # noqa: E402
from repro_torch.core.design_space import (  # noqa: E402
    DesignBatch, JointDesign, StrategySpace, WSCDesign, decode, decode_joint_batch, sample,
    sample_joint)
from repro_torch.core.compiler import pinned_resource_ok  # noqa: E402
from repro_torch.core.eval_compiled import (  # noqa: E402
    dispatch_fused_eval_pinned, lane_stats, strategy_arrays)
from repro_torch.core.fidelity import AnalyticalBackend  # noqa: E402
from repro_torch.core.validator import validate, validate_joint_batch  # noqa: E402
from repro_torch.dist import oracle  # noqa: E402
from repro_torch.explore import Campaign, CampaignSpec, ExplorationLoop, FidelitySchedule  # noqa: E402
from repro_torch.explore import export  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINT_SPEC = os.path.join(ROOT, "examples", "campaigns", "gpt175b_joint_dse.json")
CPU = AnalyticalBackend(device="cpu")
WL = tw.GPT_BENCHMARKS[0]                                 # GPT-1.7B train


def _hex(x):
    return float(x).hex()


def _result(r):
    """Every field of an EvalResult, floats as hex."""
    step = None
    if r.step is not None:
        s = r.step
        step = (_hex(s.step_time_s), _hex(s.throughput), _hex(s.power_w),
                _hex(s.pipeline_eff), _hex(s.energy_j), s.feasible, s.reason,
                sorted((k, _hex(v)) for k, v in s.breakdown.items()))
    st = None if r.strategy is None else dataclasses.astuple(r.strategy)
    return (_hex(r.throughput), _hex(r.power_w), st, step, r.n_wafers, r.feasible, r.reason)


def _j_wl(wl):
    return jw.LLMWorkload(**dataclasses.asdict(wl))


def _j_point(p):
    return jds.JointDesign(jds.WSCDesign(**dataclasses.asdict(p.design)),
                           jc.Strategy(**dataclasses.asdict(p.strategy)))


def _designs(n=32, seed=11):
    rng = np.random.default_rng(seed)
    return [r.design for r in (validate(decode(u)) for u in sample(rng, n)) if r.ok]


def _random_points(wl, n, seed, ep_max=1):
    """Designs under random strategies, a few of them impossible."""
    rng = np.random.default_rng(seed)
    designs = _designs(n=2 * n, seed=seed)[:n]
    pts = []
    for i, d in enumerate(designs):
        s = Strategy(tp=int(2 ** rng.integers(0, 5)), pp=int(2 ** rng.integers(0, 4)),
                     dp=int(2 ** rng.integers(0, 4)), microbatches=int(2 ** rng.integers(0, 4)),
                     ep=int(2 ** rng.integers(0, int(np.log2(ep_max)) + 1)),
                     recompute=bool(rng.integers(0, 2)),
                     schedule=("1f1b", "gpipe")[int(rng.integers(0, 2))])
        if i % 7 == 3:
            s = dataclasses.replace(s, tp=1 << 18)       # more cells than cores
        pts.append(JointDesign(d, s))
    return pts


def _workload(kind):
    wl = WL
    if kind.startswith("moe"):
        wl = dataclasses.replace(wl, moe_experts=8, moe_topk=2)
    if kind.endswith("decode") or kind.endswith("prefill"):
        wl = tw.inference_workload(wl, kind.split("-")[-1], batch=32, seq=2048)
    return wl


# ------------------- the shardability oracle --------------------------------

_GRID = [(tp, dp, ep) for tp in (1, 2, 16, 1 << 20) for dp in (1, 2, 3, 16)
         for ep in (1, 2, 3, 8)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_oracle_verdicts_equal_repro(arch):
    """Full and reduced configs over a (tp, dp, ep) grid that reaches every
    verdict (ok, ep_experts, dp_batch and, at tp = 2^20, tp_dead)."""
    seen = set()
    for ours, theirs in ((get_config(arch), j_get_config(arch)),
                         (reduced_config(arch), j_reduced_config(arch))):
        for tp, dp, ep in _GRID:
            got = oracle.check_strategy(ours, tp, dp, ep, batch=16, seq=8)
            assert got == j_oracle.check_strategy(theirs, tp, dp, ep, batch=16, seq=8), (
                tp, dp, ep)
            seen.add(got[1])
    assert {"", "dp_batch", "tp_dead", "ep_experts"} <= seen


def test_oracle_on_workloads_equals_repro():
    """`strategy_shardable` on the benchmark workloads (the synthesized
    configs, a MoE variant included) and `model_config_for_workload`."""
    seen = set()
    wls = list(tw.GPT_BENCHMARKS[:8]) + [dataclasses.replace(WL, moe_experts=8, moe_topk=2),
                                         dataclasses.replace(WL, batch=3)]
    for wl in wls:
        cfg = oracle.model_config_for_workload(wl)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            j_oracle.model_config_for_workload(_j_wl(wl)))
        for tp, dp, ep in _GRID:
            s = Strategy(tp, 1, dp, 1, ep=ep)
            got = oracle.strategy_shardable(wl, s)
            assert got == j_oracle.strategy_shardable(
                _j_wl(wl), jc.Strategy(**dataclasses.asdict(s)))
            seen.add(got[1])
    assert {"", "dp_batch", "tp_dead", "ep_experts"} <= seen


# ------------------- pinned evaluation ---------------------------------------


@pytest.mark.parametrize("kind", ["train", "decode", "prefill", "moe-train", "moe-decode"])
def test_pinned_evaluation_hex_equal(kind, monkeypatch):
    """The port's torch program on the CPU == the port's NumPy pinned path
    == `repro`'s evaluate_joint_batch (NumPy), every field; the fused
    dispatch gives the same rows for device pick indices."""
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    wl = _workload(kind)
    pts = _random_points(wl, 24, seed=5, ep_max=8 if kind.startswith("moe") else 1)
    geom = DesignBatch.from_designs([p.design for p in pts])
    nw = ev._wafers_for_budget_batch(geom, wl)
    strategies = [p.strategy for p in pts]
    got = CPU.evaluate_batch(geom, wl, nw, 8, strategies=strategies)
    ref = CPU.evaluate_batch_ref(geom, wl, nw, 8, strategies=strategies)
    assert [_result(r) for r in got] == [_result(r) for r in ref]
    ev.clear_eval_cache()
    jev.clear_eval_cache()
    mine = ev.evaluate_joint_batch(pts, wl, fidelity=CPU, max_strategies=8)
    theirs = jev.evaluate_joint_batch([_j_point(p) for p in pts], _j_wl(wl), max_strategies=8)
    assert [_result(r) for r in mine] == [_result(r) for r in theirs]
    assert [_result(r) for r in mine] == [_result(r) for r in got]
    reasons = {r.reason for r in got}
    assert "strategy_resources" in reasons and "" in reasons
    if kind.startswith("moe"):
        assert any("ep" in r.step.breakdown for r in got if r.feasible)
    js = torch.tensor([5, 0, 17, 3])
    calls = lane_stats()["jit_calls"]
    cols = strategy_arrays(strategies)
    res_ok = pinned_resource_ok(wl, geom, nw, *cols[:4])[js.numpy()]
    rows = dispatch_fused_eval_pinned(geom, wl, nw, strategies, js, max_strategies=8).finish(
        nw[js.numpy()], [strategies[j] for j in js.tolist()], 3, res_ok=res_ok)
    assert lane_stats()["jit_calls"] == calls + 1 and lane_stats()["n_lanes"] == 1
    assert [_result(r) for r in rows] == [_result(got[j]) for j in (5, 0, 17)]
    ev.clear_eval_cache()
    picks, fused = ev.evaluate_pool_fused_joint(pts, wl, js, 3, max_strategies=8)
    assert picks == [5, 0, 17]
    assert [_result(r) for r in fused] == [_result(got[j]) for j in picks]


def test_joint_pinned_replays_grid_argmin_bit_exact():
    """Each design pinned to its own grid winner reproduces the grid-mode
    objectives bit for bit (the contract that makes joint and grid
    hypervolumes comparable)."""
    designs = _designs()
    ev.clear_eval_cache()
    grid = ev.evaluate_design_batch(designs, WL, fidelity=CPU, max_strategies=8)
    feas = [r for r in grid if r.feasible]
    assert len(feas) >= 8
    pts = [JointDesign(d, r.strategy) for d, r in zip(designs, grid) if r.feasible]
    joint = ev.evaluate_joint_batch(pts, WL, fidelity=CPU, max_strategies=8)
    assert [_result(r) for r in joint] == [_result(r) for r in feas]
    again = ev.evaluate_joint_batch(pts, WL, fidelity=CPU, max_strategies=8)
    assert [_result(r) for r in again] == [_result(r) for r in joint]


# ------------------- joint validation ----------------------------------------


def test_validate_joint_batch_verdicts_equal_repro():
    """repro's verdict cases (pp, ep_experts, tokens; cores, memory,
    batch_div; GPipe vs 1F1B vs recompute at a long sequence), plus joint
    samples from the workload's strategy space, with the oracle's verdicts
    among them."""
    d = validate(WSCDesign()).design
    wl_tiny = dataclasses.replace(WL, seq=1)
    wl_long = dataclasses.replace(WL, seq=1 << 16)
    cases = [
        (wl_tiny, None, [Strategy(2, 2, 2, 2), Strategy(1, 32, 1, 1), Strategy(1, 1, 1, 1, ep=2),
                         Strategy(1, 1, 512, 32)]),
        (WL, None, [Strategy(1 << 18, 1, 1, 1), Strategy(1, 1, 512, 1), Strategy(1, 1, 1, 3),
                    Strategy(1 << 12, 1, 1, 1)]),
        (wl_long, 1, [Strategy(1, 2, 1, 8), Strategy(1, 2, 1, 8, schedule="gpipe"),
                      Strategy(1, 2, 1, 8, schedule="gpipe", recompute=True)]),
    ]
    space = StrategySpace.for_workload(WL, 1 << 19)
    us = sample_joint(np.random.default_rng(3), 64, space)
    cases.append((WL, None, [p.strategy for p in decode_joint_batch(us, space)]))
    reasons = set()
    for wl, nw, strategies in cases:
        pts = [JointDesign(d, s) for s in strategies]
        if wl is WL and nw is None and len(strategies) == 64:
            pts = decode_joint_batch(us, space)
        got = validate_joint_batch(pts, wl, n_wafers=nw)
        want = jv.validate_joint_batch([_j_point(p) for p in pts], _j_wl(wl), n_wafers=nw)
        assert [(r.ok, r.reason) for r in got] == [(r.ok, r.reason) for r in want]
        assert [dataclasses.asdict(r.design) if r.design else None for r in got] == \
            [dataclasses.asdict(r.design) if r.design else None for r in want]
        reasons |= {r.reason for r in got}
    assert {"strategy_pp", "strategy_ep_experts", "strategy_tokens", "strategy_cores",
            "strategy_memory", "strategy_batch_div", "strategy_tp_dead", ""} <= reasons


# ------------------- joint campaigns -----------------------------------------


def _joint_spec(cls, fid, **over):
    kw = dict(name="t-joint", workload="GPT-1.7B", scenario="train", strategy="mfmobo",
              strategy_mode="joint",
              fidelity=fid(f1="analytical", f0="analytical", d1=2, d0=2, k=2),
              n_evals_f0=5, n_evals_f1=6, q=2, n_candidates=16, max_strategies=6, seed=7)
    kw.update(over)
    return cls(**kw)


def _hex_trace(tr):
    return ([[_hex(v) for v in x] for x in tr.xs], [[_hex(a), _hex(b)] for a, b in tr.ys],
            [_hex(h) for h in tr.hv], [str(d) for d in tr.designs])


@pytest.mark.parametrize("which", ["small", "gpt175b_joint_dse"])
def test_joint_campaign_matches_repro(which, monkeypatch):
    """The same joint points (architecture and strategy), objectives and
    hypervolume curve as `repro`, bit for bit; gpt175b_joint_dse at
    ROADMAP's baseline (28 evaluations, hypervolume 79.826)."""
    from repro.explore import FidelitySchedule as JFid
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    if which == "small":
        mine, theirs = _joint_spec(CampaignSpec, FidelitySchedule), _joint_spec(JSpec, JFid)
    else:
        mine, theirs = CampaignSpec.from_json(JOINT_SPEC), JSpec.from_json(JOINT_SPEC)
    jev.clear_eval_cache()
    want = JCampaign(theirs).run()
    ev.clear_eval_cache()
    got = Campaign(mine, device="cpu").run()
    assert got.finished and got.n_evals == want.n_evals == mine.loop_config().total_evals()
    assert all(isinstance(p, JointDesign) for p in got.trace.designs)
    assert _hex_trace(got.trace) == _hex_trace(want.trace)
    assert got.front == want.front and got.stage_cache == want.stage_cache
    assert got.objective_stats == want.objective_stats
    assert all("tp=" in p["describe"] for p in got.front)
    if which != "small":
        assert got.n_evals == 28 and round(got.hv_final, 3) == 79.826


def test_joint_checkpoint_resume_bit_identical(tmp_path):
    spec = _joint_spec(CampaignSpec, FidelitySchedule)
    ck = str(tmp_path / "joint.ckpt.pkl")
    ev.clear_eval_cache()
    full = Campaign(spec, device="cpu").run()
    ev.clear_eval_cache()
    part = Campaign(spec, device="cpu").run(checkpoint_path=ck, max_steps=2)
    assert not part.finished
    assert ExplorationLoop.load_state(ck)[1].steps == 2
    ev.clear_eval_cache()
    resumed = Campaign.resume(ck, device="cpu").run(checkpoint_path=ck)
    assert resumed.finished and _hex_trace(resumed.trace) == _hex_trace(full.trace)


# ------------------- export --------------------------------------------------


def test_export_roundtrip_and_launcher_run(tmp_path):
    """The exported JSON is `repro`'s, round-trips, validates, and runs the
    port's launcher for 2 reduced steps on the CPU (`repro`'s own launcher
    cannot run on this tree)."""
    from repro_torch.launch import train as launch_train
    d = validate(WSCDesign()).design
    point = JointDesign(d, Strategy(tp=1, pp=1, dp=1, microbatches=1))
    path = str(tmp_path / "export.json")
    cfg = export.export_train_config(point, "smollm-135m", steps=2, batch=2, seq=32,
                                     reduced=True, path=path)
    assert cfg == j_export.export_train_config(_j_point(point), "smollm-135m", steps=2,
                                               batch=2, seq=32, reduced=True)
    assert export.EXPORT_VERSION == j_export.EXPORT_VERSION
    loaded = export.load_train_config(path)
    assert loaded == cfg == export.load_train_config(open(path).read())
    assert export.validate_train_config(loaded) == (True, "")
    assert export.train_argv(loaded) == j_export.train_argv(loaded)
    with pytest.raises(ValueError, match="version"):
        export.load_train_config('{"version": 2}')
    out = launch_train.main(export.train_argv(loaded) + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "100"])
    assert [m["step"] for m in out["metrics"]] == [0, 1]
    assert np.isfinite([float(m["loss"]) for m in out["metrics"]]).all()


def test_export_rejects_bad_arithmetic_and_arch():
    s = Strategy(tp=1, pp=1, dp=3, microbatches=1)
    cfg = export.export_train_config(s, "smollm-135m", batch=8, seq=32)
    assert export.validate_train_config(cfg) == (False, "dp_batch_divide")
    cfg = export.export_train_config(Strategy(1, 1, 2, 3), "smollm-135m", batch=8, seq=32)
    assert export.validate_train_config(cfg) == (False, "microbatch_divide")
    assert export.validate_train_config(dict(cfg, arch="gpt-nonesuch")) == (False, "unknown_arch")
    assert export.validate_train_config(dict(cfg, steps=0)) == (False, "non_positive_axis")
    with pytest.raises(ValueError, match="unknown arch"):
        export.export_train_config(s, "gpt-nonesuch")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_export_validates_every_arch_as_repro(arch):
    """Every arch validates at (tp 2, dp 2), and the verdicts at the other
    strategies (dist_dp_batch, dist_tp_dead, dist_ep_experts, the
    arithmetic ones) equal `repro`'s, reduced and full."""
    verdicts = set()
    for s in (Strategy(2, 1, 2, 1), Strategy(1, 1, 1, 1), Strategy(1 << 20, 1, 1, 1),
              Strategy(1, 1, 16, 1), Strategy(2, 1, 2, 2, ep=2), Strategy(1, 1, 2, 8)):
        for reduced in (True, False):
            cfg = export.export_train_config(s, arch, batch=8, seq=64, reduced=reduced)
            got = export.validate_train_config(cfg)
            assert got == j_export.validate_train_config(cfg), (s, reduced)
            verdicts.add(got)
    assert (True, "") in verdicts and (False, "dist_tp_dead") in verdicts
