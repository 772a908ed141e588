"""Hierarchical Evaluation Engine (paper §VI, Fig. 6).

evaluate_design(design, workload, fidelity) walks tile -> op -> chunk level
and searches the parallel-strategy space (TP x DP x PP x micro-batch),
returning the best-throughput feasible (throughput, power) point. It is the
scalar *reference* path: explicit ChunkGraphs, per-graph latency through the
fidelity backend's `chunk_latency`.

evaluate_design_batch(designs, workload, fidelity) dispatches to the
fidelity backend registry (repro_torch.core.fidelity, DESIGN.md §4b): every
registered fidelity — analytical closed form, padded-graph GNN, lockstep
simulator — scores the whole flattened (design, strategy) candidate axis in
one array pass. There is no scalar per-design fallback; an unknown fidelity
raises with the registered list.

Fidelities (paper §VII: f1 = analytical, f0 = GNN; CA-sim for validation):
    "analytical"  fast equivalent-bandwidth NoC model
    "gnn"         GNN congestion model (needs trained params)
    "sim"         cycle-approximate NoC simulator (ground truth)

All entry points share a cross-call eval cache keyed by
(design, workload, fidelity, system size, params version) so repeated
explorer visits to the same point never recompile or re-evaluate
(DESIGN.md §6).

The port's copy of `repro.core.evaluator`. What differs:

  * `_digest_params` walks a dict/list/tuple tree of tensors and arrays in
    `jax.tree_util` order (dict keys sorted) and hashes the same bytes per
    leaf, so cache keys do not depend on which framework holds the params.
  * `evaluate_pool_fused` hands the acquire's device index tensor straight
    to `eval_compiled.dispatch_fused_eval`, with no host sync between
    proposal and evaluation; reading the indices back comes after.
  * `evaluate_pool_fused_joint` does the same with the joint pool's
    pinned strategy columns (`eval_compiled.dispatch_fused_eval_pinned`).
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import components as C
from repro_torch.core.evalcache import (
    DiskSegmentEvalCache,
    EvalCacheBackend,
    InMemoryEvalCache,
)
from repro_torch.core.chunk_eval import evaluate_step
from repro_torch.core.compiler import (
    ChunkGraph,
    compile_chunk,
    enumerate_strategies,
    strategy_sort_key,
)
from repro_torch.core.compiler import pinned_resource_ok as \
    compiler_pinned_resource_ok
from repro_torch.core.design_space import DesignBatch, WSCDesign
from repro_torch.core.fidelity import (
    EvalResult,
    FidelityBackend,
    get_backend,
    registered_backends,
)
from repro_torch.core.workload import LLMWorkload

H100_AREA_MM2 = 814.0

_strategy_order = strategy_sort_key        # kept name: search-order heuristic

Fidelity = Union[str, FidelityBackend]


def wafers_for_budget(design: WSCDesign, wl: LLMWorkload) -> int:
    """Area-matched system size: same total silicon as the GPU baseline
    (paper: 'total area of the WSCs consistent with the corresponding number
    of GPUs')."""
    total = wl.gpu_budget * H100_AREA_MM2
    return max(1, round(total / max(design.wafer_area_mm2(), 1.0)))


def _wafers_for_budget_batch(geom: DesignBatch, wl: LLMWorkload) -> np.ndarray:
    total = wl.gpu_budget * H100_AREA_MM2
    return np.maximum(
        1, np.round(total / np.maximum(geom.wafer_area_mm2, 1.0))
    ).astype(np.int64)


# ---------------------------------------------------------------------------
# cross-call eval cache (DESIGN.md §6/§11) — replaces the old per-call
# compile_cache: WSCDesign and LLMWorkload are frozen/hashable, so the
# full evaluation outcome is memoized across explorer iterations. The
# store itself is a pluggable `EvalCacheBackend` (repro_torch.core.evalcache):
# the default is the bounded in-memory LRU; fleet workers install a
# `DiskSegmentEvalCache` so concurrent workers and successive campaigns
# share evaluations through a common cache directory.
# ---------------------------------------------------------------------------

_EVAL_CACHE_MAX = 100_000
_BACKEND: EvalCacheBackend = InMemoryEvalCache(max_entries=_EVAL_CACHE_MAX)

# GNN params are unhashable pytrees, so cache keys carry an explicit
# version element per params object. Two mechanisms, one pin table:
#
#  * `gnn_params_token` — process-local monotonic counter. The params are
#    pinned (strong ref) while tokenized, so a live object's id cannot be
#    reused; once a pin is evicted its token is *retired* — the counter
#    never hands it out again — so a new object reusing the freed id can
#    never alias the old object's cache entries (the failure mode of the
#    previous id()-keyed scheme).
#  * `gnn_params_digest` — content hash of the pytree's array leaves,
#    memoized on the same pin. This is what cache KEYS use: digests are
#    stable across processes (required by the shared disk backend, where a
#    per-process counter would alias entries between workers) and across
#    re-pins, while calibration replacing the pytree still lands in a
#    fresh namespace because the content changed.
_PARAMS_TOKENS: Dict[int, Tuple[int, str, object]] = {}
_PARAMS_TOKENS_MAX = 16
_params_counter = itertools.count(1)


def _leaves(tree):
    """Leaves of a params tree in `jax.tree_util.tree_flatten` order: dict
    values by sorted key, list and tuple items in order, None empty."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _digest_params(gnn_params) -> str:
    h = hashlib.sha1()
    for leaf in _leaves(gnn_params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _pin_params(gnn_params) -> Tuple[int, str]:
    pid = id(gnn_params)
    entry = _PARAMS_TOKENS.get(pid)
    if entry is None:
        if len(_PARAMS_TOKENS) >= _PARAMS_TOKENS_MAX:
            _PARAMS_TOKENS.pop(next(iter(_PARAMS_TOKENS)))
        entry = (next(_params_counter), _digest_params(gnn_params),
                 gnn_params)
        _PARAMS_TOKENS[pid] = entry
    return entry[0], entry[1]


def gnn_params_token(gnn_params) -> Optional[int]:
    """Process-local monotonic version token for a params pytree
    (None -> None). A params object keeps its token for as long as it stays
    pinned; calling this after mutating-and-replacing params (e.g. online
    calibration) naturally yields a new token for the new object."""
    if gnn_params is None:
        return None
    return _pin_params(gnn_params)[0]


def gnn_params_digest(gnn_params) -> Optional[str]:
    """Content digest of a params pytree (None -> None): stable across
    processes and runs, so it is the params element of eval-cache keys —
    a worker fleet sharing a disk cache agrees on the namespace of every
    entry (DESIGN.md §11)."""
    if gnn_params is None:
        return None
    return _pin_params(gnn_params)[1]


def _cache_key(design: WSCDesign, wl: LLMWorkload, fidelity: str,
               n_wafers: int, max_strategies: int, gnn_params,
               strategy=None) -> Tuple:
    # Grid-mode keys keep the historical 6-tuple shape so existing disk
    # caches stay valid; joint mode (pinned Strategy, frozen/hashable)
    # appends the strategy so the same design under two strategies never
    # aliases one entry.
    if strategy is None:
        return (design, wl, fidelity, n_wafers, max_strategies,
                gnn_params_digest(gnn_params))
    return (design, wl, fidelity, n_wafers, max_strategies,
            gnn_params_digest(gnn_params), strategy)


def get_eval_cache_backend() -> EvalCacheBackend:
    return _BACKEND


def set_eval_cache_backend(backend: EvalCacheBackend) -> EvalCacheBackend:
    """Install a cache backend (e.g. a fleet worker pointing a
    `DiskSegmentEvalCache` at the shared cache directory). Returns the
    previous backend so callers can restore it."""
    global _BACKEND
    prev = _BACKEND
    _BACKEND = backend
    return prev


def configure_eval_cache(cache_dir: Optional[str] = None,
                         max_entries: int = _EVAL_CACHE_MAX
                         ) -> EvalCacheBackend:
    """Convenience: install the disk-segment backend rooted at `cache_dir`
    (shared, persistent), or a fresh bounded in-memory LRU when
    `cache_dir` is None."""
    if cache_dir is None:
        set_eval_cache_backend(InMemoryEvalCache(max_entries=max_entries))
    else:
        set_eval_cache_backend(
            DiskSegmentEvalCache(cache_dir, max_entries=max_entries))
    return _BACKEND


def clear_eval_cache() -> None:
    _BACKEND.clear()
    _PARAMS_TOKENS.clear()


def eval_cache_stats() -> Dict[str, int]:
    # `entries` == `size` (live cache entries); both names kept — `size`
    # predates campaign reporting, `entries` is the documented key campaign
    # traces diff per fidelity stage (DESIGN.md §9). Backends add
    # `evictions` (LRU) and, for the disk backend, segment/merge counters.
    s = _BACKEND.stats()
    s["size"] = s["entries"]
    return s


# ---------------------------------------------------------------------------
# scalar reference path (graph-based)
# ---------------------------------------------------------------------------


def evaluate_design(design: WSCDesign, wl: LLMWorkload,
                    fidelity: Fidelity = "analytical",
                    gnn_params: Optional[Dict] = None,
                    n_wafers: Optional[int] = None,
                    max_strategies: int = 24) -> EvalResult:
    backend = get_backend(fidelity)
    nw = n_wafers if n_wafers is not None else wafers_for_budget(design, wl)
    key = _cache_key(design, wl, backend.name, nw, max_strategies,
                     gnn_params)
    hit = _BACKEND.get(key)
    if hit is not None:
        return hit

    # memory_model="grid": the scalar path must stay element-identical to
    # the batched grid (`feasible_strategy_arrays`), which bakes the frozen
    # legacy memory check; the recompute-aware v2 model is the joint path.
    strategies = enumerate_strategies(design, wl, n_wafers=nw,
                                      memory_model="grid")
    strategies = sorted(strategies, key=_strategy_order)[:max_strategies]

    graph_cache: Dict[Tuple[int, int, int], Tuple[ChunkGraph, float]] = {}
    best: Optional[EvalResult] = None
    for s in strategies:
        mb_count = s.microbatches if wl.phase == "train" else 1
        mb_tokens = max(wl.tokens_per_step() // (s.dp * mb_count), 1)
        cores_per_chunk = max(design.total_cores() * nw // s.chunks(), 1)
        gkey = (s.tp, mb_tokens, cores_per_chunk)
        if gkey not in graph_cache:
            graph = compile_chunk(design, wl, s.tp, mb_tokens,
                                  cores_per_chunk)
            lat = backend.chunk_latency(graph, design, gnn_params)
            graph_cache[gkey] = (graph, lat)
        graph, lat = graph_cache[gkey]
        step = evaluate_step(design, wl, s, lat, graph, nw)
        if not step.feasible:
            continue
        cand = EvalResult(step.throughput, step.power_w, s, step, nw, True)
        if best is None or cand.throughput > best.throughput:
            best = cand
    if best is None:
        best = EvalResult(0.0, float("inf"), None, None, nw, False,
                          "no_feasible_strategy")
    return _BACKEND.put(key, best)


# ---------------------------------------------------------------------------
# batched path: registry dispatch (DESIGN.md §4/§4b)
# ---------------------------------------------------------------------------


def evaluate_design_batch(designs: Sequence[WSCDesign], wl: LLMWorkload,
                          fidelity: Fidelity = "analytical",
                          gnn_params: Optional[Dict] = None,
                          n_wafers: Optional[Union[int, np.ndarray]] = None,
                          max_strategies: int = 24) -> List[EvalResult]:
    """Evaluate N designs at once through the fidelity backend registry:
    every fidelity runs its vectorized pipeline over the flattened
    (design, strategy) candidate axis. Cache hits are filtered out first;
    only the misses reach the backend."""
    backend = get_backend(fidelity)
    designs = list(designs)
    if not designs:
        return []

    geom0 = DesignBatch.from_designs(designs)
    if n_wafers is None:
        nw = _wafers_for_budget_batch(geom0, wl)
    else:
        nw = np.broadcast_to(np.asarray(n_wafers, np.int64),
                             (len(designs),)).copy()

    keys = [_cache_key(d, wl, backend.name, int(nw[i]), max_strategies,
                       gnn_params)
            for i, d in enumerate(designs)]
    results: List[Optional[EvalResult]] = [_BACKEND.get(k) for k in keys]
    todo = [i for i, r in enumerate(results) if r is None]
    if todo:
        fresh = backend.evaluate_batch(geom0.take(np.asarray(todo)), wl,
                                       nw[todo], max_strategies, gnn_params)
        for i, r in zip(todo, fresh):
            results[i] = r
        # one batched cache write (single segment append on disk backends)
        _BACKEND.set_many([(keys[i], results[i]) for i in todo])
    return results            # type: ignore[return-value]


def evaluate_pool_fused(pool_designs: Sequence[WSCDesign], wl: LLMWorkload,
                        js_dev, q_eff: int,
                        gnn_params: Optional[Dict] = None,
                        n_wafers: Optional[int] = None,
                        max_strategies: int = 24
                        ) -> Tuple[List[int], List[EvalResult]]:
    """Fused propose→evaluate for the analytical fidelity (DESIGN.md §12):
    `js_dev` is the device index tensor the q-EHVI acquire produced
    (`mfmobo._acquire_batch_device`); the torch evaluator gathers those
    candidate-pool rows and scores them on the same device stream, so the
    host never synchronizes between proposal and evaluation. Returns
    (first q_eff pick indices, their EvalResults).

    Cache protocol (same counters as `evaluate_design_batch`): one `get`
    per pick — hits keep the cached result, misses take the fused
    program's rows — then one batched `set_many` write for the misses.
    The evaluation itself is NOT skipped on hits (it already ran inside
    the fused program); that is the documented consulted-vs-bypassed
    trade: re-scoring q rows in-program is cheaper than a host round-trip
    to decide whether to score them. Values are interchangeable because
    the torch pipeline is bit-identical to the reference (on the CPU;
    chip_smoke.py phase 17 counts any difference on the card)."""
    from repro_torch.core import eval_compiled

    pool = list(pool_designs)
    geom = DesignBatch.from_designs(pool)
    if n_wafers is None:
        nw = _wafers_for_budget_batch(geom, wl)
    else:
        nw = np.broadcast_to(np.asarray(n_wafers, np.int64),
                             (len(pool),)).copy()
    pending = eval_compiled.dispatch_fused_eval(
        geom, wl, nw, js_dev, max_strategies=max_strategies)
    # one host sync for the indices — the fused evaluation is already
    # queued behind the acquire by the time this completes
    js_all = js_dev.cpu().numpy()
    js = [int(j) for j in js_all[:q_eff]]
    fresh = pending.finish(nw[js_all], q_eff)
    keys = [_cache_key(pool[j], wl, "analytical", int(nw[j]),
                       max_strategies, gnn_params) for j in js]
    results: List[EvalResult] = []
    new = []
    for k, r in zip(keys, fresh):
        hit = _BACKEND.get(k)
        if hit is None:
            results.append(r)
            new.append((k, r))
        else:
            results.append(hit)
    if new:
        _BACKEND.set_many(new)
    return js, results


# ---------------------------------------------------------------------------
# joint (strategy-pinned) path: strategy–architecture co-exploration
# (DESIGN.md §13) — each point carries its own Strategy, no grid argmin
# ---------------------------------------------------------------------------


def evaluate_joint_batch(points, wl: LLMWorkload,
                         fidelity: Fidelity = "analytical",
                         gnn_params: Optional[Dict] = None,
                         n_wafers: Optional[Union[int, np.ndarray]] = None,
                         max_strategies: int = 24) -> List[EvalResult]:
    """Evaluate N (design, strategy) joint points at once: each design is
    scored under its pinned Strategy (`JointDesign.strategy`), skipping the
    per-design strategy-grid argmin. Same cache protocol as
    `evaluate_design_batch`; keys carry the pinned Strategy so a design
    evaluated under two strategies occupies two entries."""
    backend = get_backend(fidelity)
    points = list(points)
    if not points:
        return []
    designs = [p.design for p in points]
    strategies = [p.strategy for p in points]

    geom0 = DesignBatch.from_designs(designs)
    if n_wafers is None:
        nw = _wafers_for_budget_batch(geom0, wl)
    else:
        nw = np.broadcast_to(np.asarray(n_wafers, np.int64),
                             (len(points),)).copy()

    keys = [_cache_key(d, wl, backend.name, int(nw[i]), max_strategies,
                       gnn_params, strategy=strategies[i])
            for i, d in enumerate(designs)]
    results: List[Optional[EvalResult]] = [_BACKEND.get(k) for k in keys]
    todo = [i for i, r in enumerate(results) if r is None]
    if todo:
        fresh = backend.evaluate_batch(
            geom0.take(np.asarray(todo)), wl, nw[todo], max_strategies,
            gnn_params, strategies=[strategies[i] for i in todo])
        for i, r in zip(todo, fresh):
            results[i] = r
        _BACKEND.set_many([(keys[i], results[i]) for i in todo])
    return results            # type: ignore[return-value]


def evaluate_pool_fused_joint(pool_points, wl: LLMWorkload,
                              js_dev, q_eff: int,
                              gnn_params: Optional[Dict] = None,
                              n_wafers: Optional[int] = None,
                              max_strategies: int = 24
                              ) -> Tuple[List[int], List[EvalResult]]:
    """Joint-mode counterpart of `evaluate_pool_fused`: the candidate pool
    is (design, strategy) points, and the fused program gathers both the
    geometry rows and the pinned strategy columns by the device pick
    indices. Same get-per-pick / batched set_many cache protocol."""
    from repro_torch.core import eval_compiled

    points = list(pool_points)
    designs = [p.design for p in points]
    strategies = [p.strategy for p in points]
    geom = DesignBatch.from_designs(designs)
    if n_wafers is None:
        nw = _wafers_for_budget_batch(geom, wl)
    else:
        nw = np.broadcast_to(np.asarray(n_wafers, np.int64),
                             (len(points),)).copy()
    pending = eval_compiled.dispatch_fused_eval_pinned(
        geom, wl, nw, strategies, js_dev, max_strategies=max_strategies)
    js_all = js_dev.cpu().numpy()
    js = [int(j) for j in js_all[:q_eff]]
    # grid resource-fit gate over the pool, gathered to the pick order —
    # the same host-computed mask the batch pinned path applies
    cols = eval_compiled.strategy_arrays(strategies)
    res_ok = compiler_pinned_resource_ok(wl, geom, nw, cols[0], cols[1],
                                         cols[2], cols[3])[js_all]
    fresh = pending.finish(nw[js_all], [strategies[j] for j in js_all],
                           q_eff, res_ok=res_ok)
    keys = [_cache_key(designs[j], wl, "analytical", int(nw[j]),
                       max_strategies, gnn_params,
                       strategy=strategies[j]) for j in js]
    results: List[EvalResult] = []
    new = []
    for k, r in zip(keys, fresh):
        hit = _BACKEND.get(k)
        if hit is None:
            results.append(r)
            new.append((k, r))
        else:
            results.append(hit)
    if new:
        _BACKEND.set_many(new)
    return js, results


def evaluate_objectives(design: WSCDesign, wl: LLMWorkload,
                        fidelity: Fidelity = "analytical",
                        gnn_params: Optional[Dict] = None
                        ) -> Tuple[float, float]:
    """(throughput, power) pair for the explorer; infeasible -> (0, peak)."""
    r = evaluate_design(design, wl, fidelity=fidelity, gnn_params=gnn_params)
    if not r.feasible:
        return 0.0, C.WAFER_POWER_W
    return r.throughput, r.power_w / max(r.n_wafers, 1)


def evaluate_objectives_batch(designs: Sequence[WSCDesign], wl: LLMWorkload,
                              fidelity: Fidelity = "analytical",
                              gnn_params: Optional[Dict] = None
                              ) -> List[Tuple[float, float]]:
    out = []
    for r in evaluate_design_batch(designs, wl, fidelity=fidelity,
                                   gnn_params=gnn_params):
        if not r.feasible:
            out.append((0.0, C.WAFER_POWER_W))
        else:
            out.append((r.throughput, r.power_w / max(r.n_wafers, 1)))
    return out


def evaluate_serving_batch(designs: Sequence[WSCDesign],
                           wl_base: LLMWorkload, mix, slo, **kw):
    """Request-level serving metrics (TTFT / TPOT / SLO goodput) for N
    designs through the fidelity registry — the serving counterpart of
    `evaluate_design_batch`. Thin forwarder to `repro_torch.core.serving`
    (imported lazily: serving composes this module's batched per-step
    evaluations, so a top-level import would be circular)."""
    from repro_torch.core import serving
    return serving.evaluate_serving_batch(designs, wl_base, mix, slo, **kw)


def evaluate_trace_serving_batch(designs, wl_base: LLMWorkload, trace,
                                 **kw):
    """Trace-driven multi-tenant serving metrics (per-tenant SLO goodput,
    worst-window goodput, admission/routing policies) for N designs — the
    timed-arrival counterpart of `evaluate_serving_batch`. Thin forwarder
    to `repro_torch.core.traces` (lazy import, same layering as serving)."""
    from repro_torch.core import traces
    return traces.evaluate_trace_serving_batch(designs, wl_base, trace,
                                               **kw)


def serving_objectives(wl_base: LLMWorkload, mix, slo, **kw):
    """Batch-aware (SLO goodput, power) explorer objective — forwarder to
    `repro_torch.core.serving.serving_objectives` (lazy import, see
    above)."""
    from repro_torch.core import serving
    return serving.serving_objectives(wl_base, mix, slo, **kw)


def batched_objectives(wl: LLMWorkload, fidelity: Fidelity = "analytical",
                       gnn_params: Optional[Dict] = None):
    """Batch-aware (throughput, power-per-wafer) objective for the
    explorer. Subsumed by the campaign Objectives protocol — this is now a
    thin constructor for `repro_torch.explore.objectives.EvaluatorObjective`
    (lazy import: repro_torch.explore layers on top of this module). `fidelity`
    may be a registered name or a FidelityBackend instance."""
    from repro_torch.explore.objectives import EvaluatorObjective
    return EvaluatorObjective(wl, fidelity, gnn_params=gnn_params)


__all__ = [
    "EvalResult", "Fidelity", "batched_objectives", "clear_eval_cache",
    "configure_eval_cache", "eval_cache_stats", "evaluate_design",
    "evaluate_design_batch", "evaluate_joint_batch", "evaluate_objectives",
    "evaluate_objectives_batch", "evaluate_pool_fused",
    "evaluate_pool_fused_joint", "evaluate_serving_batch",
    "evaluate_trace_serving_batch",
    "get_backend", "get_eval_cache_backend", "gnn_params_digest",
    "gnn_params_token", "registered_backends", "serving_objectives",
    "set_eval_cache_backend", "wafers_for_budget",
]
