"""Heterogeneous WSC modeling for LLM inference (paper §V-B, §IX-E).

prefill_ratio splits compute resources between the prefill and decode
stages; `hetero` granularity sets where the split lives and what the
KV-cache transfer between stages costs:

    core     same reticle, software-scheduled      -> NoC bisection
    reticle  different reticles, one wafer          -> inter-reticle links
    wafer    different wafers                       -> inter-wafer NIs

`evaluate_hetero` scores the split as a matched-rate pipeline of the two
stages including the KV transfer (the paper's model); each stage's design
can tune its stacking-DRAM bandwidth independently (reticle/wafer
granularity). `evaluate_hetero_serving` re-scores the same disaggregation
with the coupled request-level model (repro_torch.core.serving): prefills run on
their own stage so decode never stalls, but each request's admission to the
decode pool is gated by its prefill completion plus the KV-cache transfer —
so TTFT/TPOT/SLO goodput are first-class instead of rate-matched stage
throughputs.

The port's own copy of `repro.core.heterogeneity` (imports rewritten).
It scores each stage through the scalar `evaluator.evaluate_design`
(NumPy). CPU parity: tests/test_torch_serving.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import components as C
from repro_torch.core.design_space import WSCDesign
from repro_torch.core.evaluator import Fidelity, evaluate_design, get_backend
from repro_torch.core.serving import (
    RequestMix,
    ServingSLO,
    disaggregated_metrics,
    serving_workloads,
)
from repro_torch.core.workload import LLMWorkload, inference_workload


@dataclasses.dataclass
class HeteroResult:
    throughput: float           # tokens/s end-to-end
    power_w: float
    prefill_tps: float
    decode_tps: float
    kv_transfer_s: float
    granularity: str


def wafer_split(n_wafers: int, prefill_ratio: float) -> Tuple[int, int]:
    """Wafer-granularity resource split with the area budget respected:
    nw_p + nw_d == n_wafers always. (The old `max(1, n_wafers - nw_p)`
    fallback let the two stages claim n_wafers + 1 wafers at extreme
    prefill ratios — silently granting extra silicon vs the area-matched
    budget.) Each stage needs at least one whole wafer."""
    if n_wafers < 2:
        raise ValueError(
            "wafer-granularity heterogeneity needs n_wafers >= 2 "
            f"(got {n_wafers}); use core/reticle granularity instead")
    nw_p = min(max(1, round(n_wafers * prefill_ratio)), n_wafers - 1)
    return nw_p, n_wafers - nw_p


def _kv_transfer_bw(design: WSCDesign, granularity: str) -> float:
    if granularity == "core":
        return design.reticle_bisection_Bps()
    if granularity == "reticle":
        # stage boundary crosses the wafer's inter-reticle bisection
        return design.inter_reticle_bw_Bps() * min(design.reticle_array)
    # wafer-level: KV leaves through the facing edge's network interfaces
    # at protocol-achievable utilization — the paper's inter-wafer
    # bottleneck (§IX-E)
    n_ni = design.reticle_array[0]
    return 0.5 * n_ni * C.INTER_WAFER_BW_PER_NI


def evaluate_hetero(design_prefill: WSCDesign, design_decode: WSCDesign,
                    wl_base: LLMWorkload, granularity: str,
                    prefill_ratio: float, out_tokens: int = 2048,
                    n_wafers: int = 1, fidelity: Fidelity = "analytical",
                    gnn_params: Optional[Dict] = None) -> HeteroResult:
    """Evaluate a prefill/decode split. At core/reticle granularity both
    stages share the wafer (resource fractions); at wafer granularity each
    stage gets whole wafers. `fidelity` is a registered backend name (or a
    FidelityBackend instance) — resolved up front so typos fail loudly."""
    fidelity = get_backend(fidelity)
    wl_p = inference_workload(wl_base, "prefill", batch=wl_base.batch,
                              seq=wl_base.seq)
    wl_d = inference_workload(wl_base, "decode", batch=wl_base.batch,
                              seq=wl_base.seq)

    if granularity == "wafer":
        nw_p, nw_d = wafer_split(n_wafers, prefill_ratio)
        rp = evaluate_design(design_prefill, wl_p, fidelity, gnn_params,
                             n_wafers=nw_p)
        rd = evaluate_design(design_decode, wl_d, fidelity, gnn_params,
                             n_wafers=nw_d)
        scale_p = scale_d = 1.0
    else:
        rp = evaluate_design(design_prefill, wl_p, fidelity, gnn_params,
                             n_wafers=n_wafers)
        rd = evaluate_design(design_decode, wl_d, fidelity, gnn_params,
                             n_wafers=n_wafers)
        scale_p, scale_d = prefill_ratio, 1.0 - prefill_ratio

    # prefill produces prompts (seq tokens each); decode consumes them,
    # emitting out_tokens per prompt
    prefill_prompts_s = rp.throughput * scale_p / max(wl_base.seq, 1)
    decode_tokens_s = rd.throughput * scale_d
    decode_prompts_s = decode_tokens_s / max(out_tokens, 1)

    # KV transfer between stages per prompt
    kv_bytes = wl_base.kv_bytes_per_layer() * wl_base.n_layers / max(
        wl_base.batch, 1)
    bw = _kv_transfer_bw(design_decode, granularity)
    kv_s_per_prompt = kv_bytes / max(bw, 1.0)
    kv_prompts_s = 1.0 / max(kv_s_per_prompt, 1e-12)

    # core-level heterogeneity: flexible scheduling boosts utilization but
    # adds intra-reticle traffic + control overhead (paper §IX-E)
    eff = {"core": 0.92, "reticle": 1.0, "wafer": 1.0}[granularity]
    prompts_s = eff * min(prefill_prompts_s, decode_prompts_s, kv_prompts_s)
    thpt = prompts_s * out_tokens
    power = rp.power_w * scale_p + rd.power_w * scale_d
    return HeteroResult(
        throughput=thpt, power_w=power,
        prefill_tps=rp.throughput * scale_p,
        decode_tps=decode_tokens_s,
        kv_transfer_s=kv_s_per_prompt,
        granularity=granularity)


# ---------------------------------------------------------------------------
# coupled request-level re-score
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HeteroServingResult:
    feasible: bool
    goodput_tok_s: float
    throughput_tok_s: float
    ttft_s: float                  # mean over the mix's requests
    tpot_s: float
    slo_attainment: float
    power_w: float
    kv_transfer_s: float           # mean per-request stage transfer
    n_decode_steps: int
    granularity: str
    reason: str = ""


def evaluate_hetero_serving(design_prefill: WSCDesign,
                            design_decode: WSCDesign,
                            wl_base: LLMWorkload, granularity: str,
                            prefill_ratio: float, mix: RequestMix,
                            slo: ServingSLO, slots: int = 8,
                            n_wafers: int = 1,
                            fidelity: Fidelity = "analytical",
                            gnn_params: Optional[Dict] = None
                            ) -> HeteroServingResult:
    """Re-score a prefill/decode disaggregation with the coupled request
    model instead of independent rate-matched stage throughputs: per-request
    prefill times on the prefill stage's resource share, per-request
    KV-cache shipping across the stage boundary, and a decode pool that only
    admits a request once its KV has landed and a slot is free."""
    fidelity = get_backend(fidelity)
    wl_p, wl_d, p_ref = serving_workloads(wl_base, mix, slots)

    if granularity == "wafer":
        nw_p, nw_d = wafer_split(n_wafers, prefill_ratio)
        rp = evaluate_design(design_prefill, wl_p, fidelity, gnn_params,
                             n_wafers=nw_p)
        rd = evaluate_design(design_decode, wl_d, fidelity, gnn_params,
                             n_wafers=nw_d)
        scale_p = scale_d = 1.0
    else:
        rp = evaluate_design(design_prefill, wl_p, fidelity, gnn_params,
                             n_wafers=n_wafers)
        rd = evaluate_design(design_decode, wl_d, fidelity, gnn_params,
                             n_wafers=n_wafers)
        scale_p, scale_d = prefill_ratio, 1.0 - prefill_ratio
    if not (rp.feasible and rd.feasible):
        return HeteroServingResult(
            feasible=False, goodput_tok_s=0.0, throughput_tok_s=0.0,
            ttft_s=float("inf"), tpot_s=float("inf"), slo_attainment=0.0,
            power_w=float("inf"), kv_transfer_s=float("inf"),
            n_decode_steps=0, granularity=granularity,
            reason="prefill_infeasible" if not rp.feasible
            else "decode_infeasible")

    # stage step times on the stage's actual resource share; core-level
    # scheduling flexibility costs control overhead (paper §IX-E), modeled
    # as time inflation rather than a rate discount
    eff = {"core": 0.92, "reticle": 1.0, "wafer": 1.0}[granularity]
    t_p_ref = rp.step.step_time_s / max(scale_p, 1e-9) / eff
    t_d = rd.step.step_time_s / max(scale_d, 1e-9) / eff

    plens = np.asarray(mix.prompt_lens, np.float64)
    t_prefill = t_p_ref * plens / max(p_ref, 1)
    # per-request K+V cache: the canonical per-layer formula, rescaled from
    # the workload's (batch, seq) footprint to one prompt of plens tokens
    kv_per_token = (wl_base.kv_bytes_per_layer() * wl_base.n_layers
                    / max(wl_base.batch * wl_base.seq, 1))
    kv_bytes = kv_per_token * plens
    bw = _kv_transfer_bw(design_decode, granularity)
    kv_s = kv_bytes / max(bw, 1.0)

    m = disaggregated_metrics(mix, slo, slots, t_prefill, kv_s, t_d)
    power = rp.power_w * scale_p + rd.power_w * scale_d
    return HeteroServingResult(
        feasible=True,
        goodput_tok_s=m["goodput_tok_s"],
        throughput_tok_s=m["throughput_tok_s"],
        ttft_s=m["ttft_s"], tpot_s=m["tpot_s"],
        slo_attainment=m["slo_attainment"],
        power_w=power,
        kv_transfer_s=float(np.mean(kv_s)),
        n_decode_steps=m["n_decode_steps"],
        granularity=granularity)


def evaluate_hetero_trace_serving(design_prefill: WSCDesign,
                                  design_decode: WSCDesign,
                                  wl_base: LLMWorkload, granularity: str,
                                  prefill_ratio: float, trace,
                                  slots: int = 8, window_steps: int = 64,
                                  n_wafers: Optional[int] = None,
                                  fidelity: Fidelity = "analytical",
                                  gnn_params: Optional[Dict] = None):
    """Timed-arrival, multi-tenant counterpart of `evaluate_hetero_serving`:
    the "disaggregated" routing policy of a trace-serving campaign
    (DESIGN.md §14). Stage evaluation and the resource split are identical;
    the coupled request model is `traces.trace_disaggregated_metrics` —
    prompts prefill on their own stage in priority-then-arrival order as
    they *arrive*, KV ships across the stage boundary, and the decode pool
    admits by priority once the KV lands. Returns a
    `traces.TraceServingResult` so disaggregated points score in the same
    frame as the shared-pool policies."""
    from repro_torch.core.traces import (
        TraceServingResult,
        _per_tenant,
        trace_disaggregated_metrics,
        trace_serving_workloads,
    )

    fidelity = get_backend(fidelity)
    wl_p, wl_d, p_ref = trace_serving_workloads(wl_base, trace, slots)

    if granularity == "wafer":
        nw_p, nw_d = wafer_split(n_wafers if n_wafers is not None else 2,
                                 prefill_ratio)
        rp = evaluate_design(design_prefill, wl_p, fidelity, gnn_params,
                             n_wafers=nw_p)
        rd = evaluate_design(design_decode, wl_d, fidelity, gnn_params,
                             n_wafers=nw_d)
        scale_p = scale_d = 1.0
    else:
        rp = evaluate_design(design_prefill, wl_p, fidelity, gnn_params,
                             n_wafers=n_wafers)
        rd = evaluate_design(design_decode, wl_d, fidelity, gnn_params,
                             n_wafers=n_wafers)
        scale_p, scale_d = prefill_ratio, 1.0 - prefill_ratio
    if not (rp.feasible and rd.feasible):
        from repro_torch.core.traces import _infeasible
        return _infeasible("disaggregated", rd.n_wafers,
                           "prefill_infeasible" if not rp.feasible
                           else "decode_infeasible")

    eff = {"core": 0.92, "reticle": 1.0, "wafer": 1.0}[granularity]
    t_p_ref = rp.step.step_time_s / max(scale_p, 1e-9) / eff
    t_d = rd.step.step_time_s / max(scale_d, 1e-9) / eff

    plens = np.asarray(trace.prompt_lens, np.float64)
    t_prefill = t_p_ref * plens / max(p_ref, 1)
    kv_per_token = (wl_base.kv_bytes_per_layer() * wl_base.n_layers
                    / max(wl_base.batch * wl_base.seq, 1))
    kv_s = kv_per_token * plens / max(
        _kv_transfer_bw(design_decode, granularity), 1.0)

    m = trace_disaggregated_metrics(trace, slots, t_prefill, kv_s, t_d,
                                    window_steps=window_steps)
    power = rp.power_w * scale_p + rd.power_w * scale_d
    energy = power * m["total_time_s"]
    return TraceServingResult(
        feasible=True, policy="disaggregated",
        goodput_tok_s=m["goodput_tok_s"],
        interactive_goodput_tok_s=m["interactive_goodput_tok_s"],
        worst_window_goodput_tok_s=m["worst_window_goodput_tok_s"],
        throughput_tok_s=m["throughput_tok_s"],
        ttft_s=m["ttft_s"], ttft_max_s=m["ttft_max_s"],
        tpot_s=m["tpot_s"], tpot_max_s=m["tpot_max_s"],
        slo_attainment=m["slo_attainment"],
        total_time_s=m["total_time_s"],
        n_steps=m["n_steps"], n_decode_steps=m["n_decode_steps"],
        n_preemptions=0, power_w=power, energy_j=energy,
        n_wafers=rd.n_wafers,
        per_tenant=_per_tenant(trace, m["met"], m["ttft"], m["tpot"],
                               m["total_time_s"]))


def hetero_serving_objectives(wl_base: LLMWorkload, mix: RequestMix,
                              slo: ServingSLO, *, granularity: str,
                              prefill_ratio: float = 0.5, slots: int = 8,
                              n_wafers: int = 8,
                              fidelity: Fidelity = "analytical",
                              gnn_params: Optional[Dict] = None):
    """(goodput, power-per-wafer) explorer objective for the disaggregated
    serving scenario — thin constructor for the campaign Objectives
    protocol (`repro_torch.explore.objectives.HeteroServingObjective`, lazy
    import: repro_torch.explore layers on top of this module). Campaigns declare
    the same thing with `scenario="hetero"` + a `HeteroSpec`."""
    from repro_torch.explore.objectives import HeteroServingObjective
    return HeteroServingObjective(
        wl_base, mix, slo, granularity=granularity,
        prefill_ratio=prefill_ratio, slots=slots, n_wafers=n_wafers,
        fidelity=fidelity, gnn_params=gnn_params)
