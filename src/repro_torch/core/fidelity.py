"""Pluggable fidelity backends for the evaluation engine (DESIGN.md §3/§4b).

Every chunk-latency fidelity (paper §VI-C/§VII: f1 = analytical, f0 = GNN,
CA-sim = ground truth) is a `FidelityBackend` registered by name. A backend
exposes the scalar reference path (`chunk_latency`, a walk over an explicit
ChunkGraph — what `evaluator.evaluate_design` uses) and the batched path
(`evaluate_batch`, the whole (design, strategy) candidate axis in array
form — what `evaluator.evaluate_design_batch` dispatches to). The registry
makes the fidelity axis open: `register_backend` accepts anything that
quacks, and unknown names fail loudly with the registered list.

The batched graph fidelities never materialize ChunkGraph objects. The
transfers `compile_chunk` emits are row all-gathers whose structure depends
only on the (gh, gw) NoC grid, so `compiler.row_allgather_pattern` tables
(pairs, injection sequences, link sets, per-pair routes) plus per-candidate
scalars (flit count, producer interval/duration, NoC bandwidth) reconstruct
exactly the per-transfer link graphs / packet sets the scalar path builds —
see `_transfer_lanes`. The GNN backend then scores every lane in one padded
`gnn_forward_batch` call per grid bucket; the sim backend runs every lane
through one lockstep `simulate_batch` pass per bucket.

The port's copy of `repro.core.fidelity`. What differs:

  * `AnalyticalBackend.evaluate_batch` runs the torch program
    (`repro_torch.core.eval_compiled`) on the backend's device, the card
    unless it is built with `device="cpu"`; `evaluate_batch_ref` is the
    NumPy reference, copied verbatim. Its pinned-strategy (joint) mode
    raises: it waits for ROADMAP item 13.
  * `GNNBackend` runs the port's torch `noc_gnn` on the backend's device,
    the card unless it is built with `device="cpu"`; params on another
    device (or `repro`'s tree with numpy leaves) are carried there first.
    Without params it gives the analytical result, as `repro`'s does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Tuple, Union

import numpy as np

from repro_torch.core.chunk_eval import (
    StepResult,
    evaluate_step_batch,
    step_result_at,
)
from repro_torch.core.compiler import (
    ChunkGraph,
    RowAllGatherPattern,
    Strategy,
    feasible_strategy_arrays,
    grid_for_batch,
    pinned_resource_ok,
    row_allgather_pattern,
)
from repro_torch.core.design_space import DesignBatch, WSCDesign
from repro_torch.core.noc_analytical import (
    chunk_latency_cycles,
    chunk_latency_cycles_closed,
    row_allgather_byte_hops,
)
from repro_torch.core.noc_gnn import (
    LinkGraphBatch,
    chunk_latency_cycles_gnn,
    gnn_forward_batch,
    gnn_params_on,
    next_pow2,
)
from repro_torch.core.noc_sim import chunk_latency_cycles_sim, simulate_batch
from repro_torch.core.tile_eval import evaluate_tile_batch
from repro_torch.core.workload import BYTES, LLMWorkload


@dataclasses.dataclass
class EvalResult:
    throughput: float
    power_w: float
    strategy: Optional[Strategy]
    step: Optional[StepResult]
    n_wafers: int
    feasible: bool
    reason: str = ""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class FidelityBackend(Protocol):
    """One chunk-latency fidelity. `chunk_latency` is the scalar reference
    (explicit ChunkGraph walk); `evaluate_batch` scores N designs' full
    strategy spaces as one array pass and must reproduce the scalar search
    (same winner, float-tolerance objectives)."""

    name: str

    def chunk_latency(self, graph: ChunkGraph, design: WSCDesign,
                      gnn_params: Optional[Dict] = None) -> float: ...

    def evaluate_batch(self, geom: DesignBatch, wl: LLMWorkload,
                       n_wafers: np.ndarray, max_strategies: int = 24,
                       gnn_params: Optional[Dict] = None,
                       strategies: Optional[List[Strategy]] = None
                       ) -> List[EvalResult]: ...


_REGISTRY: Dict[str, FidelityBackend] = {}


def register_backend(backend: FidelityBackend) -> FidelityBackend:
    """Register (or replace) a backend under `backend.name`."""
    _REGISTRY[backend.name] = backend
    return backend


def registered_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(fidelity: Union[str, FidelityBackend]) -> FidelityBackend:
    """Resolve a fidelity name (or pass a backend instance through). Unknown
    names raise with the registered list so typos fail loudly instead of
    silently degrading to some default."""
    if not isinstance(fidelity, str):
        return fidelity
    backend = _REGISTRY.get(fidelity)
    if backend is None:
        raise ValueError(
            f"unknown fidelity {fidelity!r}; registered backends: "
            f"{', '.join(registered_backends())}")
    return backend


# ---------------------------------------------------------------------------
# shared candidate axis: every design's strategy list flattened onto one
# (design, strategy) axis with the tile stage already evaluated
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CandidateAxis:
    geom: DesignBatch              # per-design geometry (N rows)
    cg: DesignBatch                # candidate-axis geometry (C rows)
    nw: np.ndarray                 # (N,) wafers per design
    nw_c: np.ndarray               # (C,)
    offsets: np.ndarray            # (N+1,) candidate ranges per design
    didx: np.ndarray               # (C,) design index per candidate
    tp: np.ndarray
    pp: np.ndarray
    dp: np.ndarray
    mb: np.ndarray
    mb_tokens: np.ndarray          # (C,)
    cores_per_chunk: np.ndarray    # (C,) true chunk grid size
    gh: np.ndarray                 # (C,) capped NoC grid (compile_chunk cap)
    gw: np.ndarray
    n_cores: np.ndarray            # (C,) gh * gw
    tiles: Dict[str, np.ndarray]   # (n_ops, C) tile stage outputs
    out_bytes: np.ndarray          # (n_ops, C) producer output bytes
    sram_bits_layer: np.ndarray    # (C,)
    noc_bytes_layer: np.ndarray    # (C,)
    # pinned-strategy (joint) mode: the original Strategy per design plus
    # the extra knob columns; None in grid mode (ISSUE 9)
    pinned: Optional[List[Strategy]] = None
    ep: Optional[np.ndarray] = None
    rc: Optional[np.ndarray] = None


def build_candidate_axis(geom: DesignBatch, wl: LLMWorkload, nw: np.ndarray,
                         max_strategies: int,
                         strategies: Optional[List[Strategy]] = None
                         ) -> CandidateAxis:
    """Flatten per-design strategy lists and run the tile stage — the part
    of the pipeline every fidelity shares (DESIGN.md §4). Per-core tiles are
    sized by the TRUE chunk grid; the NoC grid is the capped representative
    one (compile_chunk's hierarchical scale reduction).

    When `strategies` is given (joint mode, one Strategy per design) the
    grid enumeration is skipped entirely: the candidate axis is exactly one
    pinned candidate per design, with the ep/recompute extras threaded
    through to the chunk-level model."""
    designs = geom.designs

    if strategies is not None:
        counts = np.ones(len(designs), np.int64)
        offsets = np.arange(len(designs) + 1, dtype=np.int64)
        didx = np.arange(len(designs), dtype=np.int64)
        tp = np.array([s.tp for s in strategies], np.int64)
        pp = np.array([s.pp for s in strategies], np.int64)
        dp = np.array([s.dp for s in strategies], np.int64)
        mb = np.array([s.microbatches for s in strategies], np.int64)
    else:
        sram_total = geom.buffer_kb * 1024.0 * geom.total_cores * nw
        dram_total = geom.dram_gb_per_reticle * 1e9 * geom.n_reticles * nw
        strat_arrays = [
            feasible_strategy_arrays(wl, int(geom.total_cores[i] * nw[i]),
                                     float(sram_total[i] + dram_total[i]),
                                     max_strategies)
            for i in range(len(designs))
        ]
        counts = np.array([len(a) for a in strat_arrays], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        didx = np.repeat(np.arange(len(designs), dtype=np.int64), counts)
        sa = np.concatenate(strat_arrays, axis=0)
        tp, pp, dp, mb = sa[:, 0], sa[:, 1], sa[:, 2], sa[:, 3]

    cg = geom.take(didx)                     # candidate-axis geometry
    nw_c = nw[didx]
    chunks = pp * dp
    mb_count = mb if wl.phase == "train" else np.ones_like(mb)
    mb_tokens = np.maximum(wl.tokens_per_step() // (dp * mb_count), 1)
    cores_per_chunk = np.maximum(cg.total_cores * nw_c // chunks, 1)

    gh_t, gw_t = grid_for_batch(cores_per_chunk)
    gh, gw = grid_for_batch(np.minimum(cores_per_chunk, 64))
    n_cores = gh * gw
    ops = wl.layer_ops_batch(tp, mb_tokens)
    tile_M = np.maximum(ops["M"] // gh_t, 1)
    tile_N = np.maximum(ops["N"] // gw_t, 1)
    tiles = evaluate_tile_batch(tile_M, ops["K"], tile_N,
                                cg.mac[None, :], cg.buffer_kb[None, :],
                                cg.buffer_bw[None, :],
                                cg.dataflow_code[None, :])

    out_bytes = (ops["M"] * ops["N"]).astype(np.float64) * BYTES
    sram_bits_layer = (tiles["sram_read_bits"]
                       + tiles["sram_write_bits"]).sum(axis=0) * n_cores
    noc_bytes_layer = row_allgather_byte_hops(out_bytes[:-1], gh, gw)

    return CandidateAxis(
        geom=geom, cg=cg, nw=nw, nw_c=nw_c, offsets=offsets, didx=didx,
        tp=tp, pp=pp, dp=dp, mb=mb, mb_tokens=mb_tokens,
        cores_per_chunk=cores_per_chunk, gh=gh, gw=gw, n_cores=n_cores,
        tiles=tiles, out_bytes=out_bytes, sram_bits_layer=sram_bits_layer,
        noc_bytes_layer=noc_bytes_layer,
        pinned=list(strategies) if strategies is not None else None,
        ep=(np.array([s.ep for s in strategies], np.int64)
            if strategies is not None else None),
        rc=(np.array([s.recompute for s in strategies], bool)
            if strategies is not None else None))


def _finish(ax: CandidateAxis, wl: LLMWorkload, lat: np.ndarray
            ) -> List[EvalResult]:
    """Chunk-level stage + per-design best-feasible reduction (first max
    wins, matching the scalar search order — candidates are already
    strategy-sorted). In pinned mode (ax.pinned) there is exactly one
    candidate per design and no argmin: the EvalResult carries the original
    searched Strategy. A pinned strategy that fails the grid resource-fit
    arithmetic (cores / memory capacity, `compiler.pinned_resource_ok`)
    reports "strategy_resources"; one that fails the step model's
    power/finiteness check reports "strategy_infeasible"."""
    step = evaluate_step_batch(ax.cg, wl, ax.tp, ax.pp, ax.dp, ax.mb, lat,
                               ax.sram_bits_layer, ax.noc_bytes_layer,
                               ax.nw_c, ep=ax.ep, recompute=ax.rc)
    results: List[EvalResult] = []
    if ax.pinned is not None:
        res_ok = pinned_resource_ok(wl, ax.geom, ax.nw, ax.tp, ax.pp, ax.dp,
                                    ax.mb)
        for i, s in enumerate(ax.pinned):
            if not (res_ok[i] and step["feasible"][i]):
                results.append(EvalResult(
                    0.0, float("inf"), s, None, int(ax.nw[i]), False,
                    "strategy_resources" if not res_ok[i]
                    else "strategy_infeasible"))
                continue
            sr = step_result_at(step, i)
            results.append(EvalResult(sr.throughput, sr.power_w, s, sr,
                                      int(ax.nw[i]), True))
        return results
    thpt = np.where(step["feasible"], step["throughput"], -1.0)
    for i in range(len(ax.geom.designs)):
        lo, hi = ax.offsets[i], ax.offsets[i + 1]
        if hi == lo or not step["feasible"][lo:hi].any():
            results.append(EvalResult(0.0, float("inf"), None, None,
                                      int(ax.nw[i]), False,
                                      "no_feasible_strategy"))
            continue
        j = lo + int(np.argmax(thpt[lo:hi]))
        sr = step_result_at(step, j)
        results.append(EvalResult(
            sr.throughput, sr.power_w,
            Strategy(int(ax.tp[j]), int(ax.pp[j]), int(ax.dp[j]),
                     int(ax.mb[j])),
            sr, int(ax.nw[i]), True))
    return results


# ---------------------------------------------------------------------------
# (candidate, transfer) lanes for the graph fidelities
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _GridLanes:
    """All (unique candidate, transfer) lanes sharing one NoC grid. Each
    lane is one row-all-gather transfer: uniform per-packet flit count,
    producer interval/duration, and the lane's NoC bandwidth — everything
    the pattern tables need to reconstruct the scalar path's link graph
    (featurize_transfer) and packet set (packets_for_transfer)."""
    pattern: RowAllGatherPattern
    u_lane: np.ndarray             # (B,) unique-candidate index per lane
    flits: np.ndarray              # (B,) flits per packet (uniform in lane)
    interval: np.ndarray           # (B,) producer output interval (cycles)
    dur: np.ndarray                # (B,) producer duration, >= 1
    noc_bw: np.ndarray             # (B,) bits/cycle


@dataclasses.dataclass
class _TransferLanes:
    uniq_first: np.ndarray         # (U,) candidate index of each unique rep
    inverse: np.ndarray            # (C,) candidate -> unique index
    n_unique: int
    buckets: List[_GridLanes]


def _transfer_lanes(ax: CandidateAxis) -> _TransferLanes:
    """Dedupe candidates that share a compiled graph — the batch analogue of
    the scalar path's per-design `graph_cache` keyed by
    (tp, mb_tokens, cores_per_chunk) — then group the per-transfer lanes of
    the unique candidates by NoC grid width.

    Row decomposition: every route of a row all-gather is horizontal, so the
    (gh, gw) transfer graph is gh disjoint copies of the (1, gw) path graph
    with identical features, packets, and injections. Per-edge GNN
    predictions and per-row simulations are therefore equal across rows, and
    a transfer's makespan on the full grid equals its makespan on one row —
    lanes run on the (1, gw) pattern, a gh-fold compute reduction."""
    key = np.stack([ax.didx, ax.tp, ax.mb_tokens, ax.cores_per_chunk],
                   axis=1)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    U = len(first)
    gw_u = ax.gw[first]
    nc_u = ax.n_cores[first].astype(np.float64)
    bw_u = ax.cg.noc_bw[first].astype(np.float64)

    n_transfers = ax.out_bytes.shape[0] - 1
    per_pair = ax.out_bytes[:-1, first] / nc_u        # (T, U)
    flits = np.maximum(np.ceil(per_pair * 8.0 / bw_u), 1.0)
    interval = ax.tiles["out_interval_cycles"][:-1, first]
    dur = np.maximum(ax.tiles["cycles"][:-1, first], 1.0)

    buckets: List[_GridLanes] = []
    for gw0 in np.unique(gw_u[gw_u > 1]):
        members = np.flatnonzero(gw_u == gw0)
        shape = (n_transfers, len(members))
        buckets.append(_GridLanes(
            pattern=row_allgather_pattern(1, int(gw0)),
            u_lane=np.broadcast_to(members, shape).ravel(),
            flits=flits[:, members].ravel(),
            interval=interval[:, members].ravel(),
            dur=dur[:, members].ravel(),
            noc_bw=np.broadcast_to(bw_u[members], shape).ravel()))
    return _TransferLanes(uniq_first=first, inverse=inv, n_unique=U,
                          buckets=buckets)


def _pattern_features(b: _GridLanes) -> Tuple[np.ndarray, np.ndarray]:
    """Node/edge feature tensors for every lane of one grid bucket —
    bit-identical to `featurize_transfer` on the corresponding compiled
    chunk (all packets of a row all-gather share one flit count, so
    link_flits = flits * flows and inj = flits * (gw - 1))."""
    pat = b.pattern
    B = len(b.flits)
    n, E = pat.n_cores, len(pat.links)
    node_x = np.empty((B, n, 3), np.float64)
    node_x[:, :, 0] = (b.flits * (pat.gw - 1) / b.dur)[:, None]
    node_x[:, :, 1] = pat.out_deg[None, :] / 4.0
    node_x[:, :, 2] = pat.in_deg[None, :] / 4.0
    edge_x = np.empty((B, E, 3), np.float64)
    edge_x[:, :, 0] = np.log1p(b.flits[:, None] * pat.flows[None, :])
    edge_x[:, :, 1] = (b.noc_bw / 4096.0)[:, None]
    edge_x[:, :, 2] = np.log1p(pat.flows)[None, :]
    return node_x.astype(np.float32), edge_x.astype(np.float32)


def _gnn_lane_makespans(params: Dict, b: _GridLanes) -> np.ndarray:
    """Eq. 6 for every lane of one bucket: one padded vmapped forward pass
    scores all lanes' link graphs, then the per-packet reconstruction
    (inject + flits + hops + summed predicted waits, max over packets) runs
    as array math against the pattern's route table. The forward only sees
    (flits, dur, noc_bw) — lanes sharing that triple (common across designs
    and strategies) are collapsed before the forward."""
    pat = b.pattern
    fkey = np.stack([b.flits, b.dur, b.noc_bw], axis=1)
    uniq, uinv = np.unique(fkey, axis=0, return_inverse=True)
    ub = _GridLanes(pattern=pat, u_lane=np.zeros(0), flits=uniq[:, 0],
                    interval=np.zeros(len(uniq)), dur=uniq[:, 1],
                    noc_bw=uniq[:, 2])
    node_x, edge_x = _pattern_features(ub)
    F, E = len(uniq), len(pat.links)
    Fp = next_pow2(F)               # bounded set of shapes per pattern
    if Fp > F:
        node_x = np.concatenate(
            [node_x, np.zeros((Fp - F,) + node_x.shape[1:], np.float32)])
        edge_x = np.concatenate(
            [edge_x, np.zeros((Fp - F,) + edge_x.shape[1:], np.float32)])
    batch = LinkGraphBatch(
        node_x=node_x, edge_x=edge_x,
        senders=np.broadcast_to(pat.senders, (Fp, E)),
        receivers=np.broadcast_to(pat.receivers, (Fp, E)),
        edge_mask=np.ones((Fp, E), np.float32),
        n_nodes=pat.n_cores, n_edges_real=np.full(Fp, E, np.int64))
    wait = gnn_forward_batch(params, batch)[:F].astype(np.float64)
    wait_pad = np.concatenate([wait, np.zeros((F, 1))], axis=1)
    pkt_wait = wait_pad[:, pat.route_eids].sum(axis=2)          # (F, P)
    t = uniq[:, 0][:, None] + pat.route_len[None, :] + pkt_wait
    inject = pat.seq[None, :].astype(np.float64) * b.interval[:, None]
    return np.max(inject + t[uinv], axis=1)


def _sim_lane_makespans(b: _GridLanes) -> np.ndarray:
    """Lockstep simulation of every lane of one bucket: per-lane packets in
    the (inject, index) order `simulate`'s heap pops, per-lane link slots
    disjoint by construction. A lane's outcome only depends on
    (flits, interval), so duplicate lanes simulate once."""
    pat = b.pattern
    fkey = np.stack([b.flits, b.interval], axis=1)
    uniq, uinv = np.unique(fkey, axis=0, return_inverse=True)
    B = len(uniq)
    P, E = len(pat.src), len(pat.links)
    inject = pat.seq[None, :].astype(np.float64) * uniq[:, 1][:, None]
    order = np.argsort(inject, axis=1, kind="stable")
    inj_s = np.take_along_axis(inject, order, axis=1)
    route_eids_s = pat.route_eids[order]                        # (B, P, L)
    route_len_s = pat.route_len[order]
    slots = route_eids_s.astype(np.int64) \
        + (np.arange(B, dtype=np.int64) * E)[:, None, None]
    flits = np.broadcast_to(uniq[:, 0][:, None], (B, P))
    res = simulate_batch(flits, inj_s, slots, route_len_s,
                         np.full(B, P, np.int64), B * E)
    return res.makespan[uinv]


def _graph_latency(ax: CandidateAxis, lane_fn) -> np.ndarray:
    """Per-candidate chunk latency for a graph fidelity: true-grid tile
    cycles plus the per-transfer comm makespans `lane_fn` computes for the
    unique candidates, gathered back to the full candidate axis."""
    lanes = _transfer_lanes(ax)
    comm = np.zeros(lanes.n_unique)
    for b in lanes.buckets:
        np.add.at(comm, b.u_lane, lane_fn(b))
    return ax.tiles["cycles"].sum(axis=0) + comm[lanes.inverse]


# ---------------------------------------------------------------------------
# the three built-in backends
# ---------------------------------------------------------------------------


class AnalyticalBackend:
    """f1: equivalent-bandwidth NoC model, closed form on the batch axis.

    `evaluate_batch` runs the torch program (repro_torch.core.eval_compiled)
    on `device`, hex-equal on the CPU to the NumPy reference kept as
    `evaluate_batch_ref` (tests/test_torch_eval.py). The registered
    instance runs on the card; build `AnalyticalBackend(device="cpu")` to
    run on the CPU."""

    name = "analytical"

    def __init__(self, device="cuda"):
        self.device = device

    def chunk_latency(self, graph: ChunkGraph, design: WSCDesign,
                      gnn_params: Optional[Dict] = None) -> float:
        return chunk_latency_cycles(graph, design)

    def evaluate_batch(self, geom: DesignBatch, wl: LLMWorkload,
                       n_wafers: np.ndarray, max_strategies: int = 24,
                       gnn_params: Optional[Dict] = None,
                       strategies: Optional[List[Strategy]] = None
                       ) -> List[EvalResult]:
        from repro_torch.core import eval_compiled
        if strategies is not None:
            raise NotImplementedError(
                "pinned-strategy (joint) evaluation waits for ROADMAP "
                "item 13")
        return eval_compiled.evaluate_batch_compiled(
            geom, wl, np.asarray(n_wafers, np.int64), max_strategies,
            device=self.device)

    def evaluate_batch_ref(self, geom: DesignBatch, wl: LLMWorkload,
                           n_wafers: np.ndarray, max_strategies: int = 24,
                           gnn_params: Optional[Dict] = None,
                           strategies: Optional[List[Strategy]] = None
                           ) -> List[EvalResult]:
        """NumPy reference pipeline (kept verbatim as the oracle for the
        torch path)."""
        ax = build_candidate_axis(geom, wl, n_wafers, max_strategies,
                                  strategies)
        lat = chunk_latency_cycles_closed(ax.tiles["cycles"], ax.out_bytes,
                                          ax.gh, ax.gw, ax.cg.noc_bw)
        return _finish(ax, wl, lat)


class GNNBackend:
    """f0: learned congestion model, on `device` (the registered instance on
    the card; build `GNNBackend(device="cpu")` to run on the CPU). Without
    params it degrades to the analytical estimate, exactly like the scalar
    path."""

    name = "gnn"

    def __init__(self, device="cuda"):
        self.device = device

    def chunk_latency(self, graph: ChunkGraph, design: WSCDesign,
                      gnn_params: Optional[Dict] = None) -> float:
        if gnn_params is None:
            return chunk_latency_cycles(graph, design)
        return chunk_latency_cycles_gnn(
            gnn_params_on(gnn_params, self.device), graph, design)

    def evaluate_batch(self, geom: DesignBatch, wl: LLMWorkload,
                       n_wafers: np.ndarray, max_strategies: int = 24,
                       gnn_params: Optional[Dict] = None,
                       strategies: Optional[List[Strategy]] = None
                       ) -> List[EvalResult]:
        if gnn_params is None:
            return AnalyticalBackend(device=self.device).evaluate_batch(
                geom, wl, n_wafers, max_strategies, strategies=strategies)
        params = gnn_params_on(gnn_params, self.device)
        ax = build_candidate_axis(geom, wl, n_wafers, max_strategies,
                                  strategies)
        lat = _graph_latency(
            ax, lambda b: _gnn_lane_makespans(params, b))
        return _finish(ax, wl, lat)


class SimBackend:
    """Cycle-approximate simulator (ground truth)."""

    name = "sim"

    def chunk_latency(self, graph: ChunkGraph, design: WSCDesign,
                      gnn_params: Optional[Dict] = None) -> float:
        return chunk_latency_cycles_sim(graph, design)

    def evaluate_batch(self, geom: DesignBatch, wl: LLMWorkload,
                       n_wafers: np.ndarray, max_strategies: int = 24,
                       gnn_params: Optional[Dict] = None,
                       strategies: Optional[List[Strategy]] = None
                       ) -> List[EvalResult]:
        ax = build_candidate_axis(geom, wl, n_wafers, max_strategies,
                                  strategies)
        lat = _graph_latency(ax, _sim_lane_makespans)
        return _finish(ax, wl, lat)


register_backend(AnalyticalBackend())
register_backend(GNNBackend())
register_backend(SimBackend())


def evaluate_serving_batch(designs, wl, mix, slo, **kw):
    """Request-level serving evaluation (TTFT / TPOT / SLO goodput) against
    any registered backend — every fidelity that can score per-step
    prefill/decode workloads can score a serving workload. Forwarder to
    `repro_torch.core.serving` (lazy import: serving builds on this
    registry)."""
    from repro_torch.core.serving import evaluate_serving_batch as _impl
    return _impl(designs, wl, mix, slo, **kw)


def evaluate_trace_serving_batch(designs, wl, trace, **kw):
    """Trace-driven, multi-tenant serving evaluation (timed arrivals,
    per-tenant SLOs, admission/routing policies) against any registered
    backend — the timed counterpart of `evaluate_serving_batch`. Forwarder
    to `repro_torch.core.traces` (lazy import: traces builds on this
    registry)."""
    from repro_torch.core.traces import evaluate_trace_serving_batch as _impl
    return _impl(designs, wl, trace, **kw)
