"""Request-level serving evaluation: analytical continuous batching.

The per-step evaluators score isolated prefill/decode `LLMWorkload`s; real
serving interleaves them: a fixed pool of decode slots runs batched decode
steps, finished slots are immediately refilled from the request queue, and
each admission runs a single-prompt prefill that stalls decode — exactly
`repro_torch.serve.engine.ServeEngine`'s loop. This module composes the existing
per-step evaluations — through the fidelity registry, batched over the
candidate axis — into request-level metrics: TTFT, TPOT, tokens/s goodput
under a `ServingSLO`, for a `RequestMix` (DESIGN.md §8).

Key decomposition: decode steps all take the same time and admissions
happen at step boundaries, so the *discrete* schedule — which step each
request is admitted/finishes at, and how many prefills precede each step —
depends only on (mix, slots), never on the design. `continuous_batch_schedule`
computes it once by mirroring `ServeEngine.step`/`_admit` semantics
(cross-validated against a real engine run in repro's tests/test_serving.py);
`serving_metrics` then broadcasts wall-clock TTFT/TPOT/goodput over the
candidate axis as pure array math against per-design step times.

`disaggregated_metrics` is the coupled-request counterpart for
prefill/decode disaggregation (heterogeneity.py): prefills run on their own
stage so decode never stalls, but admission is gated by prefill completion
plus the KV-cache transfer between stages.

The port's own copy of `repro.core.serving` (imports rewritten). Its two
per-step evaluations go through the port's `evaluate_design_batch`, so
with the analytical fidelity they run the float64 torch evaluator
(`core/eval_compiled.py`) on the backend's device. CPU parity:
tests/test_torch_serving.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.design_space import WSCDesign
from repro_torch.core.fidelity import EvalResult, FidelityBackend, get_backend
from repro_torch.core.workload import LLMWorkload, RequestMix

Fidelity = Union[str, FidelityBackend]


@dataclasses.dataclass(frozen=True)
class ServingSLO:
    """Service-level objective: a request counts toward goodput only if its
    time-to-first-token and time-per-output-token both meet the bound."""
    ttft_s: float
    tpot_s: float


@dataclasses.dataclass
class BatchSchedule:
    """Design-independent discrete schedule of one arrival batch under
    continuous batching with `slots` decode slots (ServeEngine semantics:
    admissions fill free slots in queue order at the start of each step;
    the admitted request's first token comes from its prefill; each decode
    step then generates one token per live slot)."""
    slots: int
    n_decode_steps: int
    admit_step: np.ndarray        # (R,) step at whose start r is admitted
    finish_step: np.ndarray       # (R,) step at whose end r completes
    decode_tokens: np.ndarray     # (R,) decode steps r occupies: max(out-1,1)


def continuous_batch_schedule(mix: RequestMix, slots: int) -> BatchSchedule:
    """Mirror `ServeEngine.step`/`_admit` on the request mix. The decode
    step count is the quantity cross-validated against a real engine run.

    Since the trace subsystem landed this is the degenerate case of
    `core.traces.trace_schedule` — every request arrives at step 0, one
    tenant, FIFO admission — and delegates to it (property-tested bitwise
    equal to the original loop, kept as `_continuous_batch_schedule_ref`,
    so the loop's behavior and the fig11b numbers are provably unchanged)."""
    from repro_torch.core.traces import RequestTrace, trace_schedule

    if slots < 1:
        raise ValueError("slots must be >= 1")
    if mix.n_requests == 0:
        return BatchSchedule(slots=slots, n_decode_steps=0,
                             admit_step=np.zeros(0, np.int64),
                             finish_step=np.zeros(0, np.int64),
                             decode_tokens=np.zeros(0, np.int64))
    ts = trace_schedule(RequestTrace.from_mix(mix), slots, "fifo")
    return BatchSchedule(slots=slots, n_decode_steps=ts.n_decode_steps,
                         admit_step=ts.admit_step,
                         finish_step=ts.finish_step,
                         decode_tokens=ts.decode_tokens)


def _continuous_batch_schedule_ref(mix: RequestMix,
                                   slots: int) -> BatchSchedule:
    """The original per-step loop, kept as the reference for the
    degenerate-case bitwise property test in repro's tests/test_traces.py."""
    if slots < 1:
        raise ValueError("slots must be >= 1")
    R = mix.n_requests
    decode_tokens = np.maximum(np.asarray(mix.out_lens, np.int64) - 1, 1)
    admit_step = np.zeros(R, np.int64)
    finish_step = np.zeros(R, np.int64)
    active: Dict[int, List[int]] = {}      # slot -> [rid, remaining]
    nxt = 0
    step = 0
    while nxt < R or active:
        for slot in range(slots):
            if slot not in active and nxt < R:
                admit_step[nxt] = step
                active[slot] = [nxt, int(decode_tokens[nxt])]
                nxt += 1
        for slot in list(active):
            active[slot][1] -= 1
            if active[slot][1] == 0:
                finish_step[active[slot][0]] = step
                del active[slot]
        step += 1
    return BatchSchedule(slots=slots, n_decode_steps=step,
                         admit_step=admit_step, finish_step=finish_step,
                         decode_tokens=decode_tokens)


def serving_metrics(sched: BatchSchedule, mix: RequestMix, slo: ServingSLO,
                    t_prefill_ref: np.ndarray, prompt_ref: int,
                    t_decode: np.ndarray) -> Dict[str, np.ndarray]:
    """Wall-clock request metrics for C candidates, broadcast over the
    candidate axis. `t_prefill_ref` (C,) is the prefill latency at prompt
    length `prompt_ref` — prefill is token-throughput bound, so per-request
    prefill time scales linearly with prompt length. `t_decode` (C,) is the
    batched decode step time. Returns (C,)/(C, R) arrays."""
    tp_ref = np.asarray(t_prefill_ref, np.float64).reshape(-1, 1)
    td = np.asarray(t_decode, np.float64).reshape(-1, 1)
    plens = np.asarray(mix.prompt_lens, np.float64)[None, :]
    t_p = tp_ref * plens / max(prompt_ref, 1)              # (C, R)
    cum_tp = np.cumsum(t_p, axis=1)                        # admission order

    # first token comes out of the admission prefill itself; before it, the
    # request waited through admit_step decode steps and every earlier
    # prefill (admission order == queue order)
    ttft = sched.admit_step[None, :] * td + cum_tp

    # prefill seconds elapsed by the end of step k = cumulative prefill time
    # of the last request admitted at a step <= k (admit_step nondecreasing)
    last_adm = np.searchsorted(sched.admit_step,
                               np.arange(sched.n_decode_steps),
                               side="right") - 1
    cum_tp_by_step = cum_tp[:, last_adm]                   # (C, n_steps)
    completion = ((sched.finish_step[None, :] + 1) * td
                  + cum_tp_by_step[:, sched.finish_step])
    # TPOT as a request observes it: decode-phase wall time (including
    # stalls from later admissions' prefills) per generated token
    tpot = (completion - ttft) / np.maximum(sched.decode_tokens[None, :], 1)

    total_time = cum_tp[:, -1] + sched.n_decode_steps * td[:, 0]
    out_toks = np.asarray(mix.out_lens, np.float64)[None, :]
    met = (ttft <= slo.ttft_s) & (tpot <= slo.tpot_s)
    return {
        "ttft": ttft, "tpot": tpot, "met": met,
        "total_time": total_time,
        "throughput": out_toks.sum() / np.maximum(total_time, 1e-12),
        "goodput": (out_toks * met).sum(axis=1)
        / np.maximum(total_time, 1e-12),
        "slo_attainment": met.mean(axis=1),
    }


# ---------------------------------------------------------------------------
# design evaluation: per-step evals (fidelity registry, batched) -> requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingResult:
    feasible: bool
    goodput_tok_s: float
    throughput_tok_s: float
    ttft_s: float                 # mean over requests
    ttft_max_s: float
    tpot_s: float                 # mean over requests
    tpot_max_s: float
    slo_attainment: float
    total_time_s: float
    n_decode_steps: int
    power_w: float
    energy_j: float
    n_wafers: int
    prefill: Optional[EvalResult]
    decode: Optional[EvalResult]
    reason: str = ""


def serving_workloads(wl_base: LLMWorkload, mix: RequestMix, slots: int
                      ) -> Tuple[LLMWorkload, LLMWorkload, int]:
    """The two per-step workloads serving composes: a single-prompt prefill
    at the mix's mean prompt length (the engine prefills one request at a
    time) and a `slots`-wide decode step at the mid-generation context."""
    p_ref = max(1, int(round(mix.mean_prompt)))
    wl_p = dataclasses.replace(wl_base, phase="prefill", batch=1, seq=p_ref)
    wl_d = dataclasses.replace(wl_base, phase="decode", batch=slots,
                               seq=mix.context_len())
    return wl_p, wl_d, p_ref


def _infeasible(nw: int, reason: str) -> ServingResult:
    return ServingResult(
        feasible=False, goodput_tok_s=0.0, throughput_tok_s=0.0,
        ttft_s=float("inf"), ttft_max_s=float("inf"), tpot_s=float("inf"),
        tpot_max_s=float("inf"), slo_attainment=0.0,
        total_time_s=float("inf"), n_decode_steps=0, power_w=float("inf"),
        energy_j=0.0, n_wafers=nw, prefill=None, decode=None, reason=reason)


def evaluate_serving_batch(designs: Sequence[WSCDesign],
                           wl_base: LLMWorkload, mix: RequestMix,
                           slo: ServingSLO, *, slots: int = 8,
                           fidelity: Fidelity = "analytical",
                           gnn_params: Optional[Dict] = None,
                           n_wafers=None,
                           max_strategies: int = 24) -> List[ServingResult]:
    """Request-level serving metrics for N designs: two registry-batched
    per-step evaluations (prefill, decode) + the shared discrete schedule,
    composed per candidate as array math."""
    from repro_torch.core.evaluator import evaluate_design_batch

    backend = get_backend(fidelity)
    designs = list(designs)
    if not designs:
        return []
    wl_p, wl_d, p_ref = serving_workloads(wl_base, mix, slots)
    rps = evaluate_design_batch(designs, wl_p, fidelity=backend,
                                gnn_params=gnn_params, n_wafers=n_wafers,
                                max_strategies=max_strategies)
    rds = evaluate_design_batch(designs, wl_d, fidelity=backend,
                                gnn_params=gnn_params, n_wafers=n_wafers,
                                max_strategies=max_strategies)
    sched = continuous_batch_schedule(mix, slots)

    feas = [i for i in range(len(designs))
            if rps[i].feasible and rds[i].feasible]
    feas_set = set(feas)
    results: List[Optional[ServingResult]] = [None] * len(designs)
    for i in range(len(designs)):
        if i not in feas_set:
            reason = ("prefill_" if not rps[i].feasible else "decode_") \
                + "infeasible"
            results[i] = _infeasible(rps[i].n_wafers, reason)
    if not feas:
        return results                      # type: ignore[return-value]

    t_p = np.array([rps[i].step.step_time_s for i in feas])
    t_d = np.array([rds[i].step.step_time_s for i in feas])
    e_p = np.array([rps[i].step.energy_j for i in feas])
    e_d = np.array([rds[i].step.energy_j for i in feas])
    m = serving_metrics(sched, mix, slo, t_p, p_ref, t_d)

    # energy: each prefill costs its prompt-scaled share of the reference
    # prefill step; each decode step costs the batched decode step's energy
    plens_sum = float(np.sum(mix.prompt_lens))
    energy = e_p * plens_sum / p_ref + e_d * sched.n_decode_steps
    power = energy / np.maximum(m["total_time"], 1e-12)

    for j, i in enumerate(feas):
        results[i] = ServingResult(
            feasible=True,
            goodput_tok_s=float(m["goodput"][j]),
            throughput_tok_s=float(m["throughput"][j]),
            ttft_s=float(m["ttft"][j].mean()),
            ttft_max_s=float(m["ttft"][j].max()),
            tpot_s=float(m["tpot"][j].mean()),
            tpot_max_s=float(m["tpot"][j].max()),
            slo_attainment=float(m["slo_attainment"][j]),
            total_time_s=float(m["total_time"][j]),
            n_decode_steps=sched.n_decode_steps,
            power_w=float(power[j]),
            energy_j=float(energy[j]),
            n_wafers=rds[i].n_wafers,
            prefill=rps[i], decode=rds[i])
    return results                          # type: ignore[return-value]


def evaluate_serving(design: WSCDesign, wl_base: LLMWorkload,
                     mix: RequestMix, slo: ServingSLO,
                     **kw) -> ServingResult:
    """Scalar wrapper: `evaluate_serving_batch` with a batch of one."""
    return evaluate_serving_batch([design], wl_base, mix, slo, **kw)[0]


def serving_objectives(wl_base: LLMWorkload, mix: RequestMix,
                       slo: ServingSLO, *, slots: int = 8,
                       fidelity: Fidelity = "analytical",
                       gnn_params: Optional[Dict] = None):
    """Batch-aware (SLO goodput, power-per-wafer) objective for the
    explorer; infeasible designs map to (0, peak wafer power). Subsumed by
    the campaign Objectives protocol — thin constructor for
    `repro_torch.explore.objectives.ServingObjective` (lazy import: repro_torch.explore
    layers on top of this module)."""
    from repro_torch.explore.objectives import ServingObjective
    return ServingObjective(wl_base, mix, slo, slots=slots,
                            fidelity=fidelity, gnn_params=gnn_params)


# ---------------------------------------------------------------------------
# disaggregated (prefill/decode split) coupled request model
# ---------------------------------------------------------------------------


def disaggregated_metrics(mix: RequestMix, slo: ServingSLO, slots: int,
                          t_prefill: np.ndarray, kv_s: np.ndarray,
                          t_decode: float) -> Dict[str, float]:
    """Coupled request model for prefill/decode disaggregation: prompts
    prefill serially on the prefill stage (no decode stall), then the KV
    cache ships to the decode stage, and the request joins the decode pool
    when a slot frees. Admission stays in queue order (head-blocking, like
    the engine). `t_prefill`/`kv_s` are per-request seconds on the stages'
    actual resource shares; `t_decode` is the batched decode step time."""
    if slots < 1:
        raise ValueError("slots must be >= 1")
    R = mix.n_requests
    t_p = np.asarray(t_prefill, np.float64)
    kv = np.broadcast_to(np.asarray(kv_s, np.float64), (R,))
    ttft = np.cumsum(t_p)                  # first token from prefill stage
    ready = ttft + kv                      # decode-eligible time
    dtoks = np.maximum(np.asarray(mix.out_lens, np.int64) - 1, 1)
    completion = np.zeros(R)
    active: Dict[int, List[int]] = {}
    nxt = 0
    t = 0.0
    n_steps = 0
    while nxt < R or active:
        while (nxt < R and len(active) < slots
               and ready[nxt] <= t + 1e-12):
            slot = next(s for s in range(slots) if s not in active)
            active[slot] = [nxt, int(dtoks[nxt])]
            nxt += 1
        if not active:
            t = float(ready[nxt])
            continue
        t += t_decode
        n_steps += 1
        for slot in list(active):
            active[slot][1] -= 1
            if active[slot][1] == 0:
                completion[active[slot][0]] = t
                del active[slot]
    tpot = (completion - ttft) / dtoks
    total_time = float(max(completion.max(), ttft[-1]))
    out_toks = np.asarray(mix.out_lens, np.float64)
    met = (ttft <= slo.ttft_s) & (tpot <= slo.tpot_s)
    return {
        "ttft_s": float(ttft.mean()), "ttft_max_s": float(ttft.max()),
        "tpot_s": float(tpot.mean()), "tpot_max_s": float(tpot.max()),
        "total_time_s": total_time,
        "n_decode_steps": n_steps,
        "throughput_tok_s": float(out_toks.sum() / max(total_time, 1e-12)),
        "goodput_tok_s": float((out_toks * met).sum()
                               / max(total_time, 1e-12)),
        "slo_attainment": float(met.mean()),
    }


__all__ = [
    "BatchSchedule", "RequestMix", "ServingResult", "ServingSLO",
    "continuous_batch_schedule", "disaggregated_metrics",
    "evaluate_serving", "evaluate_serving_batch", "serving_metrics",
    "serving_objectives", "serving_workloads",
]
