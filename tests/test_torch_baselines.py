"""The port's §IX baselines (`repro_torch.core.baselines`: the H100-like GPU
cluster, the WSE2-like and Dojo-like WSCs) against `repro`'s on the inputs of
tests/test_core_system_models.py, every float hex-equal: the GPT benchmarks,
their decode variants with and without MQA, other GPU budgets, and the
workload bridges of all ten archs at train_4k and decode_32k."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_shape as j_get_shape  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core import workload as jw  # noqa: E402
from repro.core.evaluator import clear_eval_cache as j_clear  # noqa: E402
from repro.core.validator import validate as j_validate  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import workload as tw  # noqa: E402
from repro_torch.core.evaluator import clear_eval_cache  # noqa: E402
from repro_torch.core.validator import validate  # noqa: E402


def _hex(x):
    return float(x).hex()


def _gpu(j_wl, t_wl, **kw):
    want = jb.gpu_cluster_eval(j_wl, **kw)
    got = tb.gpu_cluster_eval(t_wl, **kw)
    assert [_hex(v) for v in got] == [_hex(v) for v in want]
    return got


def _result(r):
    step = None
    if r.step is not None:
        s = r.step
        step = (_hex(s.step_time_s), _hex(s.throughput), _hex(s.power_w),
                _hex(s.pipeline_eff), _hex(s.energy_j), s.feasible, s.reason,
                sorted((k, _hex(v)) for k, v in s.breakdown.items()))
    st = None if r.strategy is None else dataclasses.astuple(r.strategy)
    return (_hex(r.throughput), _hex(r.power_w), st, step, r.n_wafers,
            r.feasible, r.reason)


def test_gpu_spec_is_repro_s():
    assert dataclasses.asdict(tb.GPUSpec()) == dataclasses.asdict(jb.GPUSpec())
    assert tb.H100_AREA_MM2 == jb.H100_AREA_MM2


@pytest.mark.parametrize("i", range(len(jw.GPT_BENCHMARKS)))
def test_gpu_cluster_on_the_gpt_benchmarks(i):
    """Train, decode (MHA and MQA) and prefill, and 1000/4000 GPUs."""
    j_wl, t_wl = jw.GPT_BENCHMARKS[i], tw.GPT_BENCHMARKS[i]
    assert dataclasses.asdict(j_wl) == dataclasses.asdict(t_wl)
    _gpu(j_wl, t_wl)
    _gpu(dataclasses.replace(j_wl, gpu_budget=j_wl.gpu_budget * 2),
         dataclasses.replace(t_wl, gpu_budget=t_wl.gpu_budget * 2))
    for phase in ("decode", "prefill"):
        jd = jw.inference_workload(j_wl, phase, batch=32, seq=2048)
        td = tw.inference_workload(t_wl, phase, batch=32, seq=2048)
        for mqa in (False, True):
            _gpu(jd, td, mqa=mqa)
        for n in (1000, 4000):
            _gpu(dataclasses.replace(jd, gpu_budget=n),
                 dataclasses.replace(td, gpu_budget=n))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gpu_cluster_on_every_arch_bridge(arch):
    for shape_id in ("train_4k", "decode_32k"):
        j_wl = jw.from_model_config(j_get_config(arch), j_get_shape(shape_id))
        t_wl = tw.from_model_config(get_config(arch), get_shape(shape_id))
        assert dataclasses.asdict(j_wl) == dataclasses.asdict(t_wl)
        for mqa in (False, True):
            thpt, power = _gpu(j_wl, t_wl, mqa=mqa)
            assert thpt > 0 and power > 0


@pytest.mark.parametrize("name", ["WSE2_LIKE", "DOJO_LIKE"])
def test_wsc_baselines_validate_and_evaluate(name):
    """The design points are `repro`'s, validate the same way, and score
    the same through `wsc_baseline_eval` and `evaluate_design`, on GPT-1.7B
    at the test's cap and on three more benchmarks at the default cap."""
    from repro.core.evaluator import evaluate_design as j_eval
    from repro_torch.core.evaluator import evaluate_design as t_eval
    jd, td = getattr(jb, name), getattr(tb, name)
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    jv, tv = j_validate(jd), validate(td)
    assert tv.ok and (tv.ok, tv.reason) == (jv.ok, jv.reason)
    assert dataclasses.asdict(tv.design) == dataclasses.asdict(jv.design)
    j_clear()
    clear_eval_cache()
    got = t_eval(tv.design, tw.GPT_BENCHMARKS[0], max_strategies=8)
    assert got.feasible and got.throughput > 0
    assert _result(got) == _result(j_eval(jv.design, jw.GPT_BENCHMARKS[0], max_strategies=8))
    for i in (0, 3, 7):
        assert _result(tb.wsc_baseline_eval(tv.design, tw.GPT_BENCHMARKS[i])) == \
            _result(jb.wsc_baseline_eval(jv.design, jw.GPT_BENCHMARKS[i]))
