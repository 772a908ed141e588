"""The port's analytical evaluator (`repro_torch.core.eval_compiled`)
against `repro`'s NumPy pipeline on the CPU: every float of every result
hex-equal (`float.hex`, i.e. the int64 bit pattern) to
`AnalyticalBackend().evaluate_batch_ref`, and every design's selected
strategy rows equal to `feasible_strategy_arrays_ref`, for train, prefill
and decode workloads, several strategy caps, and designs with and without
a feasible strategy. The fused path (device pick indices) equals the batch
path. The port's copies of the NumPy stack (workloads, validator,
reference pipeline) agree with `repro`'s exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPE_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_shape as j_get_shape  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro.core.compiler import feasible_strategy_arrays_ref  # noqa: E402
from repro.core.design_space import DesignBatch as JDesignBatch  # noqa: E402
from repro.core.design_space import decode_batch as j_decode_batch  # noqa: E402
from repro.core.fidelity import AnalyticalBackend as JAnalytical  # noqa: E402
from repro.core.validator import validate_batch as j_validate_batch  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.core import eval_compiled as E  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402
from repro_torch.core.design_space import DesignBatch, decode_batch  # noqa: E402
from repro_torch.core.evaluator import evaluate_design_batch, evaluate_pool_fused  # noqa: E402
from repro_torch.core.fidelity import AnalyticalBackend  # noqa: E402
from repro_torch.core.validator import validate_batch  # noqa: E402

CPU = "cpu"


def _designs(seed: int, n: int, nw_hi: int = 9):
    rng = np.random.default_rng(seed)
    U = rng.random((n, 13))
    nw = rng.integers(1, nw_hi, size=n).astype(np.int64)
    return U, decode_batch(U), nw


def _hex(v) -> str:
    return float(np.float64(v)).hex()


def _fingerprint(r):
    """Every float hex-exact, plus the discrete fields."""
    out = {"feasible": r.feasible, "n_wafers": r.n_wafers,
           "reason": r.reason,
           "strategy": None if r.strategy is None else list(
               dataclasses.astuple(r.strategy))}
    if r.feasible:
        out.update(throughput=_hex(r.throughput), power_w=_hex(r.power_w),
                   step_time_s=_hex(r.step.step_time_s),
                   pipeline_eff=_hex(r.step.pipeline_eff),
                   energy_j=_hex(r.step.energy_j),
                   breakdown={k: _hex(v)
                              for k, v in r.step.breakdown.items()})
    return out


def _workload(case, idx):
    wl = twl.GPT_BENCHMARKS[idx]
    return wl if case == "train" else twl.inference_workload(wl, case, 8, 2048)


def _j_workload(case, idx):
    wl = jwl.GPT_BENCHMARKS[idx]
    return wl if case == "train" else jwl.inference_workload(wl, case, 8, 2048)


@pytest.mark.parametrize("cap", [8, 24])
@pytest.mark.parametrize("idx", [0, 7, 15])
@pytest.mark.parametrize("case", ["train", "prefill", "decode"])
def test_hex_equal_to_repro_numpy_pipeline(case, idx, cap):
    """Against `repro`'s reference and the port's copy of it: one seed per
    case, 48 designs on 1-8 wafers each."""
    U, designs, nw = _designs(7 + idx, 48)
    geom = DesignBatch.from_designs(designs)
    got = E.evaluate_batch_compiled(geom, _workload(case, idx), nw, cap,
                                    device=CPU)
    ref = JAnalytical().evaluate_batch_ref(
        JDesignBatch.from_designs(j_decode_batch(U)), _j_workload(case, idx),
        nw, max_strategies=cap)
    copy = AnalyticalBackend(device=CPU).evaluate_batch_ref(
        geom, _workload(case, idx), nw, max_strategies=cap)
    assert len(got) == len(ref) == 48
    for i, (g, r, c) in enumerate(zip(got, ref, copy)):
        assert _fingerprint(g) == _fingerprint(r) == _fingerprint(c), i


@pytest.mark.parametrize("cap", [1, 4, 24])
def test_hex_equal_with_designs_that_have_no_feasible_strategy(cap):
    """GPT-1T training on single wafers: many designs have no strategy in
    the grid that fits (the Strategy(1,1,1,1) fallback), and some have no
    feasible one at all."""
    U, designs, _ = _designs(31, 64)
    nw = np.ones(64, np.int64)
    wl = twl.GPT_BENCHMARKS[10]
    geom = DesignBatch.from_designs(designs)
    got = E.evaluate_batch_compiled(geom, wl, nw, cap, device=CPU)
    ref = JAnalytical().evaluate_batch_ref(
        JDesignBatch.from_designs(j_decode_batch(U)), jwl.GPT_BENCHMARKS[10],
        nw, max_strategies=cap)
    prog = E._program_for(wl, cap, CPU)
    budget = (geom.buffer_kb * 1024.0 * geom.total_cores
              + geom.dram_gb_per_reticle * 1e9 * geom.n_reticles)
    n_fit = ((prog._chunks_o[None] * prog._tp_o[None]
              <= geom.total_cores[:, None])
             & (prog._need_o[None] <= budget[:, None])).sum(1)
    assert (n_fit == 0).any() and (n_fit > 0).any()
    reasons = {r.reason for r in ref}
    assert "no_feasible_strategy" in reasons and "" in reasons
    for i, (g, r) in enumerate(zip(got, ref)):
        assert _fingerprint(g) == _fingerprint(r), i


@pytest.mark.parametrize("cap", [8, 24])
@pytest.mark.parametrize("case", ["train", "decode"])
def test_strategy_selection_equals_feasible_strategy_arrays(case, cap):
    """The in-program selection (cumsum + searchsorted over the sorted,
    pow2-padded grid) names the rows `feasible_strategy_arrays_ref` lists,
    in its order, with its cap and its (1,1,1,1) fallback; pad rows are
    never selected."""
    wl = _workload(case, 12)
    prog = E._program_for(wl, cap, CPU)
    G = len(feasible_strategy_arrays_ref(_j_workload(case, 12), 2 ** 62,
                                         np.inf, 10 ** 9))
    assert (prog._need_o[G:] == np.inf).all()
    _, designs, nw = _designs(11, 24, nw_hi=4)
    geom = DesignBatch.from_designs(designs)
    arrs, nwt = prog._upload(E.geom_arrays(geom), nw)
    sel, selmask = (t.numpy() for t in prog._select(arrs, nwt))
    for i in range(len(designs)):
        tc = int(geom.total_cores[i]) * int(nw[i])
        sram = geom.buffer_kb[i] * 1024.0 * geom.total_cores[i] * nw[i]
        dram = (geom.dram_gb_per_reticle[i] * 1e9 * geom.n_reticles[i]
                * nw[i])
        want = feasible_strategy_arrays_ref(_j_workload(case, 12), tc,
                                            float(sram + dram), cap)
        rows = sel[i][selmask[i]]
        assert (rows < G).all()
        got = np.stack([prog._tp_o[rows], prog._pp_o[rows],
                        prog._dp_o[rows], prog._mb_o[rows]], axis=1)
        np.testing.assert_array_equal(got, want, err_msg=f"design {i}")


@pytest.mark.parametrize("case", ["train", "decode"])
def test_fused_dispatch_matches_batch_path(case):
    wl = _workload(case, 0)
    _, designs, nw = _designs(5, 12)
    js = np.array([7, 2, 9, 2], np.int64)
    pend = E.dispatch_fused_eval(DesignBatch.from_designs(designs), wl, nw,
                                 torch.tensor(js), 24)
    fused = pend.finish(nw[js], q=3)
    direct = E.evaluate_batch_compiled(
        DesignBatch.from_designs([designs[j] for j in js]), wl, nw[js], 24,
        device=CPU)
    assert len(fused) == 3
    for f, d in zip(fused, direct):
        assert _fingerprint(f) == _fingerprint(d)


def test_evaluate_pool_fused_matches_design_batch():
    """The evaluator entry: fused picks give the same results (and cache
    traffic) as evaluating the picked designs, through the registry."""
    from repro_torch.core.evaluator import clear_eval_cache
    wl = _workload("train", 0)
    _, designs, _ = _designs(6, 16)
    js_dev = torch.tensor([3, 11, 5, 0])
    clear_eval_cache()
    js, fused = evaluate_pool_fused(designs, wl, js_dev, 3,
                                    max_strategies=8)
    assert js == [3, 11, 5]
    clear_eval_cache()
    direct = evaluate_design_batch([designs[j] for j in js], wl,
                                   fidelity=AnalyticalBackend(device=CPU),
                                   max_strategies=8)
    for f, d in zip(fused, direct):
        assert _fingerprint(f) == _fingerprint(d)


def test_warm_evaluator_kernels_memoizes():
    wl = _workload("decode", 1)
    assert E.warm_evaluator_kernels(wl, 8, device=CPU) == 1
    assert E.warm_evaluator_kernels(wl, 8, device=CPU) == 0
    assert E.warm_evaluator_kernels(wl, 8, device=CPU, force=True) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_config_workloads_equal_repro(arch):
    """`arch@shape` campaign workloads are built from the port's configs;
    they equal `repro`'s field for field (the port's exact param count
    gives the same area-matched GPU budget)."""
    for shape in SHAPE_IDS:
        got = twl.from_model_config(get_config(arch), get_shape(shape))
        want = jwl.from_model_config(j_get_config(arch), j_get_shape(shape))
        assert dataclasses.astuple(got) == dataclasses.astuple(want), shape


def test_validator_copy_equals_repro():
    rng = np.random.default_rng(9)
    U = rng.random((160, 13))
    got = validate_batch(decode_batch(U))
    want = j_validate_batch(j_decode_batch(U))
    assert any(g.ok for g in got) and not all(g.ok for g in got)
    for g, w in zip(got, want):
        assert (g.ok, g.reason) == (w.ok, w.reason)
        if g.ok:
            assert (dataclasses.astuple(g.design)
                    == dataclasses.astuple(w.design))
            assert g.wafer_yield == w.wafer_yield


def test_evaluator_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, designs, nw = _designs(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA"):
        E.evaluate_batch_compiled(DesignBatch.from_designs(designs),
                                  _workload("train", 0), nw)
    with pytest.raises(RuntimeError, match="no CUDA"):
        evaluate_design_batch(designs, _workload("train", 0))
