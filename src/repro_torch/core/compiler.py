"""Workload Compiler (paper §VI-A).

(1) Operator-graph generation: the LLM is segmented into model chunks by the
    parallel strategy (TP x PP x DP); compute resources divide evenly.
(2) Partition/allocation: each chunk's representative layer chain (uniform
    LLM stacks) is partitioned over the chunk's 2-D core grid.
(3) Task scheduling: ops are tiled per core (tile_eval) and inter-op
    redistribution transfers are generated at core granularity.
(4) Mapping & routing: logical cores map row-major onto the physical array;
    transfers take XY routes; per-link volumes and injection rates feed the
    op-level NoC estimators (analytical / GNN / simulator).

DRAM access and inter-chunk (TP/PP/DP) communication are handled at the
chunk level (paper §VI-D), not here.

The port's own copy of `repro.core.compiler`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.design_space import WSCDesign, floor_log2
from repro_torch.core.tile_eval import TileResult, evaluate_tile
from repro_torch.core.workload import BYTES, GEMMOp, LLMWorkload


@dataclasses.dataclass
class OpNode:
    op: GEMMOp
    tile: TileResult               # per-core tile evaluation
    grid: Tuple[int, int]          # (gh, gw) logical core grid


@dataclasses.dataclass
class Transfer:
    src_op: int
    dst_op: int
    pairs: List[Tuple[int, int, float]]    # (src_core, dst_core, bytes)

    def total_bytes(self) -> float:
        return sum(p[2] for p in self.pairs)


@dataclasses.dataclass
class ChunkGraph:
    array: Tuple[int, int]                 # physical chunk grid (H, W)
    ops: List[OpNode]
    transfers: List[Transfer]
    link_loads: np.ndarray                 # (n_links,) bytes per directed link
    link_flows: np.ndarray                 # (n_links,) flow count per link
    link_index: Dict[Tuple[int, int], int] # (core_u, core_v) -> link id
    n_cores: int
    routes: Optional[Dict[Tuple[int, int], List[Tuple[int, int]]]] = \
        dataclasses.field(default=None)                          # pair->hops

    def injection_rates(self, noc_bw_bits: int) -> np.ndarray:
        """flits/cycle injected per core, averaged over the chunk runtime.
        A chunk whose ops report zero compute cycles has no defined runtime
        to average over — injection is zero, not divided by a fake cycle."""
        inj = np.zeros(self.n_cores)
        total_cycles = sum(o.tile.cycles for o in self.ops)
        if total_cycles <= 0.0:
            return inj
        flit_bytes = noc_bw_bits / 8.0
        for t in self.transfers:
            for s, _, b in t.pairs:
                inj[s] += b / max(flit_bytes, 1.0)
        return inj / total_cycles


def _grid_for(n_cores: int) -> Tuple[int, int]:
    gh = 2 ** (int(math.log2(max(n_cores, 1))) // 2)
    return gh, max(n_cores // gh, 1)


def grid_for_batch(n_cores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized `_grid_for` over an int array."""
    n = np.maximum(np.asarray(n_cores, np.int64), 1)
    gh = np.int64(1) << (floor_log2(n) // 2)
    return gh, np.maximum(n // gh, 1)


def _xy_route(src: int, dst: int, W: int) -> List[Tuple[int, int]]:
    """XY (row-first) route as a list of directed core-to-core hops."""
    r1, c1 = divmod(src, W)
    r2, c2 = divmod(dst, W)
    hops = []
    c = c1
    while c != c2:
        nc = c + (1 if c2 > c else -1)
        hops.append((r1 * W + c, r1 * W + nc))
        c = nc
    r = r1
    while r != r2:
        nr = r + (1 if r2 > r else -1)
        hops.append((r * W + c2, nr * W + c2))
        r = nr
    return hops


def compile_chunk(design: WSCDesign, wl: LLMWorkload, tp: int,
                  mb_tokens: int, cores_per_chunk: int,
                  grid_cap: int = 64) -> ChunkGraph:
    """Compile one model chunk's representative layer onto its core region.

    Hierarchical scale reduction (paper §VI): per-core tiles are sized by the
    TRUE chunk grid (cores_per_chunk), while the NoC graph is built on a
    capped representative grid — congestion patterns at equal per-core tile
    size are grid-size invariant for the row-redistribution pattern."""
    gh_t, gw_t = _grid_for(cores_per_chunk)
    gh, gw = _grid_for(min(cores_per_chunk, grid_cap))
    n_cores = gh * gw
    H, W = gh, gw

    ops = wl.layer_ops(tp=tp, mb_tokens=mb_tokens)
    nodes: List[OpNode] = []
    for op in ops:
        # per-core tile: split M over gh_t, N over gw_t (true grid)
        tile_gemm = GEMMOp(op.name,
                           max(op.M // gh_t, 1), op.K, max(op.N // gw_t, 1),
                           op.weight)
        tr = evaluate_tile(tile_gemm, design.mac_num, design.buffer_kb,
                           design.buffer_bw, design.dataflow)
        nodes.append(OpNode(op, tr, (gh_t, gw_t)))

    # inter-op redistribution: producer (a, b) -> consumers (a, b') in its
    # row (the next GEMM contracts over the previous output dim, so each
    # consumer needs the full row block = row-wise all-gather pattern)
    transfers: List[Transfer] = []
    link_index: Dict[Tuple[int, int], int] = {}
    loads: List[float] = []
    flows: List[float] = []
    routes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}

    def link_id(u, v):
        key = (u, v)
        if key not in link_index:
            link_index[key] = len(loads)
            loads.append(0.0)
            flows.append(0.0)
        return link_index[key]

    for i in range(len(nodes) - 1):
        out_b = nodes[i].op.out_bytes()
        # row all-gather: each producer's tile (out_b / n_cores) goes to the
        # other gw-1 consumers in its row; total moved = (gw-1) x out_b
        per_pair = out_b / n_cores if gw > 1 else 0.0
        pairs = []
        if gw > 1:
            for a in range(gh):
                for b in range(gw):
                    src = a * W + b
                    for b2 in range(gw):
                        if b2 == b:
                            continue
                        dst = a * W + b2
                        pairs.append((src, dst, per_pair))
                        if (src, dst) not in routes:
                            routes[(src, dst)] = _xy_route(src, dst, W)
                        for (u, v) in routes[(src, dst)]:
                            lid = link_id(u, v)
                            loads[lid] += per_pair
                            flows[lid] += 1.0
        transfers.append(Transfer(i, i + 1, pairs))

    return ChunkGraph(array=(H, W), ops=nodes, transfers=transfers,
                      link_loads=np.array(loads), link_flows=np.array(flows),
                      link_index=link_index, n_cores=n_cores, routes=routes)


# ---------------------------------------------------------------------------
# row-all-gather transfer pattern (DESIGN.md §4b) — the design-independent
# structure of the transfers `compile_chunk` emits on a (gh, gw) grid:
# pair list, per-source injection sequence, link set and per-pair routes.
# The batched gnn/sim fidelity backends featurize/simulate from these tables
# instead of materializing ChunkGraph objects; `featurize_transfer` /
# `packets_for_transfer` remain the scalar reference the tables are tested
# against.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowAllGatherPattern:
    gh: int
    gw: int
    n_cores: int
    src: np.ndarray          # (P,) producer core per pair, compile order
    dst: np.ndarray          # (P,)
    seq: np.ndarray          # (P,) per-source injection sequence number
    links: np.ndarray        # (E, 2) directed links, sorted lexicographically
    senders: np.ndarray      # (E,) int32 — links[:, 0]
    receivers: np.ndarray    # (E,) int32 — links[:, 1]
    flows: np.ndarray        # (E,) float64 — pair routes crossing each link
    out_deg: np.ndarray      # (n_cores,) float64
    in_deg: np.ndarray       # (n_cores,) float64
    route_eids: np.ndarray   # (P, Lmax) int32 link ids per hop, pad = E
    route_len: np.ndarray    # (P,) int32


_PATTERN_CACHE: Dict[Tuple[int, int], RowAllGatherPattern] = {}


def row_allgather_pattern(gh: int, gw: int) -> RowAllGatherPattern:
    """Memoized transfer structure of one `compile_chunk` inter-op edge on a
    (gh, gw) grid. Pair / sequence order matches `compile_chunk`'s loops and
    `packets_for_transfer`'s per-source numbering exactly; link order matches
    `featurize_transfer`'s `sorted(link_flits)`."""
    key = (int(gh), int(gw))
    hit = _PATTERN_CACHE.get(key)
    if hit is not None:
        return hit
    gh, gw = key
    W = gw
    n_cores = gh * gw
    srcs: List[int] = []
    dsts: List[int] = []
    seqs: List[int] = []
    routes: List[List[Tuple[int, int]]] = []
    link_flows: Dict[Tuple[int, int], float] = {}
    if gw > 1:
        for a in range(gh):
            for b in range(gw):
                src = a * W + b
                seq = 0
                for b2 in range(gw):
                    if b2 == b:
                        continue
                    dst = a * W + b2
                    hops = _xy_route(src, dst, W)
                    srcs.append(src)
                    dsts.append(dst)
                    seqs.append(seq)
                    seq += 1
                    routes.append(hops)
                    for hop in hops:
                        link_flows[hop] = link_flows.get(hop, 0.0) + 1.0
    links = sorted(link_flows)
    eid = {l: i for i, l in enumerate(links)}
    E = len(links)
    out_deg = np.zeros(n_cores)
    in_deg = np.zeros(n_cores)
    for u, v in links:
        out_deg[u] += 1
        in_deg[v] += 1
    lmax = max((len(r) for r in routes), default=0)
    route_eids = np.full((len(routes), max(lmax, 1)), E, np.int32)
    route_len = np.zeros(len(routes), np.int32)
    for i, r in enumerate(routes):
        route_len[i] = len(r)
        for j, hop in enumerate(r):
            route_eids[i, j] = eid[hop]
    pat = RowAllGatherPattern(
        gh=gh, gw=gw, n_cores=n_cores,
        src=np.array(srcs, np.int32), dst=np.array(dsts, np.int32),
        seq=np.array(seqs, np.int32),
        links=np.array(links, np.int32).reshape(-1, 2),
        senders=np.array([u for u, _ in links], np.int32),
        receivers=np.array([v for _, v in links], np.int32),
        flows=np.array([link_flows[l] for l in links], np.float64),
        out_deg=out_deg, in_deg=in_deg,
        route_eids=route_eids, route_len=route_len)
    if len(_PATTERN_CACHE) > 256:
        _PATTERN_CACHE.pop(next(iter(_PATTERN_CACHE)))
    _PATTERN_CACHE[key] = pat
    return pat


# ---------------------------------------------------------------------------
# parallel strategy enumeration (paper §VI-A last paragraph)
# ---------------------------------------------------------------------------


SCHEDULES = ("1f1b", "gpipe")


@dataclasses.dataclass(frozen=True)
class Strategy:
    tp: int
    pp: int
    dp: int
    microbatches: int
    # joint-search extensions (ISSUE 9): expert parallelism, activation
    # recomputation and the pipeline schedule. Defaults reproduce the
    # legacy 4-field strategies, so grid-mode campaigns and their cached
    # EvalResults are unchanged.
    ep: int = 1
    recompute: bool = False
    schedule: str = "1f1b"

    def chunks(self) -> int:
        return self.pp * self.dp


def strategy_memory_need(wl: LLMWorkload, tp, pp, dp, mb,
                         ep=1, recompute=False, gpipe=False):
    """System-wide memory footprint of a strategy (bytes), recompute- and
    schedule-aware. NumPy-polymorphic: scalars or broadcastable arrays.

    Terms (the v2 model — the legacy grid keeps the frozen PR 2 check so
    existing campaign traces replay bit-identically, see `_strategy_grid`):
      * weights+optimizer: dp replicas each hold params/pp; `opt_mult`
        (weights+grads+Adam moments) applies uniformly — the legacy check
        only applied it on the train branch;
      * MoE expert weights additionally divide by `ep`;
      * activations: each pipeline stage keeps one microbatch's
        activations per resident layer; recompute keeps only the stage
        boundary activation; GPipe keeps all `mb` microbatches in flight,
        1F1B at most `pp`;
      * KV cache (inference): splits across replicas, constant total.
    """
    pp = np.maximum(pp, 1)
    ep = np.maximum(ep, 1)
    train = wl.phase == "train"
    opt_mult = 6.0 if train else 1.0   # weights + grads + 2 Adam moments
    p_bytes = wl.params_bytes()
    p_exp = wl.expert_params_bytes()
    w_shard = np.where(ep > 1, (p_bytes - p_exp) + p_exp / ep, p_bytes)
    need = dp * w_shard * opt_mult / pp
    mb_count = mb if train else np.ones_like(np.asarray(mb))
    mb_tokens = np.maximum(wl.tokens_per_step() // (dp * mb_count), 1)
    layers_per_stage = np.maximum(wl.n_layers // pp, 1)
    stored_layers = np.where(recompute, 1, layers_per_stage)
    inflight = np.where(gpipe, mb_count, np.minimum(mb_count, pp))
    act = (wl.act_bytes_per_layer(mb_tokens) * stored_layers * inflight
           * pp * dp)
    need = need + act
    if not train:
        need = need + wl.kv_bytes_per_layer() * wl.n_layers
    return need


def pinned_resource_ok(wl: LLMWorkload, geom, n_wafers, tp, pp, dp, mb
                       ) -> np.ndarray:
    """Resource-fit mask for pinned (joint-mode) strategies: the exact
    feasibility arithmetic the grid path applies at enumeration
    (`feasible_strategy_arrays` / the compiled grid body) — core count
    (chunks x tp must fit the system) and the frozen legacy memory check —
    evaluated for one pinned strategy per design. Using the grid's own
    formulas (not the v2 model) keeps the replay contract intact: a
    strategy the grid argmin crowned can never be rejected here, while a
    physically impossible pinned point (cores or memory) can no longer be
    scored feasible. The recompute/schedule-aware v2 model gates the
    *search* side (`validator.validate_joint_batch`).

    One deliberate asymmetry: when *nothing* in the enumeration grid fits a
    system, `feasible_strategy_arrays` falls back to Strategy(1,1,1,1) and
    grid mode evaluates it anyway — so a pinned (1,1,1,1) is accepted
    exactly when that fallback would have fired, and only then.

    `geom` is a DesignBatch (duck-typed: buffer_kb / total_cores /
    dram_gb_per_reticle / n_reticles arrays); tp/pp/dp/mb are (N,) int
    arrays. Shared by the NumPy (`fidelity._finish`) and compiled
    (`eval_compiled`) pinned paths, so the two gates agree bitwise."""
    nw = np.asarray(n_wafers, np.int64)
    tp = np.asarray(tp, np.int64)
    pp = np.asarray(pp, np.int64)
    dp = np.asarray(dp, np.int64)
    mb = np.asarray(mb, np.int64)
    tc = np.asarray(geom.total_cores, np.int64) * nw
    sram_total = geom.buffer_kb * 1024.0 * geom.total_cores * nw
    dram_total = geom.dram_gb_per_reticle * 1e9 * geom.n_reticles * nw
    budget = sram_total + dram_total
    p_bytes = wl.params_bytes()
    if wl.phase == "train":
        need = dp * p_bytes * 6.0 / np.maximum(pp, 1)
    else:
        need = (dp * p_bytes / np.maximum(pp, 1)
                + wl.kv_bytes_per_layer() * wl.n_layers)
    fits = (pp * dp * tp <= tc) & (tp <= tc) & (need <= budget)
    g = _strategy_grid(wl)
    grid_has_fit = ((g["chunks"][None, :] * g["tp"][None, :]
                     <= tc[:, None])
                    & (g["tp"][None, :] <= tc[:, None])
                    & (g["need"][None, :] <= budget[:, None])).any(axis=1)
    is_fallback = (tp == 1) & (pp == 1) & (dp == 1) & (mb == 1)
    return fits | (is_fallback & ~grid_has_fit)


def derived_strategy_caps(wl: LLMWorkload, total_cores: int
                          ) -> Dict[str, int]:
    """Largest power-of-two value of each strategy axis the design/workload
    pair admits — replaces the historical magic constants (tp <= 4096,
    pp <= 64) with caps derived from the actual core count and layer
    count. `ep` caps at the expert count (1 for dense models)."""
    def p2(n: int) -> int:
        return 1 << max(int(n), 1).bit_length() - 1

    return {
        "tp": p2(max(total_cores, 1)),
        "pp": p2(min(wl.n_layers, max(total_cores, 1))),
        "dp": p2(max(wl.batch, 1)),
        "ep": p2(max(wl.moe_experts, 1)),
        "microbatches": 32 if wl.phase == "train" else 1,
    }


def enumerate_strategies(design: WSCDesign, wl: LLMWorkload,
                         n_wafers: int = 1,
                         memory_model: str = "v2") -> List[Strategy]:
    """All (TP, DP, PP, micro-batch) combos satisfying memory capacity
    (paper: iterate all combinations that satisfy the memory constraint).

    Caps are derived from the design (`total_cores`) and workload
    (`n_layers`, `batch`) — a 128-layer model can use pp=128, a
    million-core system tp > 4096. `memory_model` picks the feasibility
    check: "v2" (default) is the recompute-aware `strategy_memory_need`;
    "grid" is the frozen legacy check that `feasible_strategy_arrays` /
    the compiled evaluator bake in (kept so the scalar path stays
    element-identical to grid-mode evaluation and recorded campaign
    traces). Since ISSUE 9 this is a seeding/fallback path — joint-mode
    campaigns search the strategy axis directly (design_space.
    StrategySpace) and validate through `validator.validate_joint_batch`.
    """
    total_cores = design.total_cores() * n_wafers
    sram_total = design.buffer_kb * 1024.0 * total_cores
    dram_total = design.dram_gb_per_reticle() * 1e9 * design.n_reticles() * n_wafers
    mem_budget = sram_total + dram_total
    p_bytes = wl.params_bytes()
    opt_mult = 6.0 if wl.phase == "train" else 1.0   # weights+grads+adam
    out: List[Strategy] = []
    pows = [2 ** i for i in range(0, 17)]
    for pp in [p for p in pows if p <= wl.n_layers]:
        for dp in [d for d in pows if d <= max(wl.batch, 1)]:
            for tp in pows:
                chunks = pp * dp
                if chunks * tp > total_cores or tp > total_cores:
                    continue
                for mb in (1, 2, 4, 8, 16, 32):
                    if wl.phase != "train" and mb > 1:
                        continue
                    if wl.batch % (dp * (mb if wl.phase == "train" else 1)):
                        continue
                    if memory_model == "v2":
                        need = float(strategy_memory_need(wl, tp, pp, dp, mb))
                    else:
                        # frozen legacy check (see _strategy_grid)
                        need = dp * p_bytes * opt_mult / max(pp, 1)
                        if wl.phase != "train":
                            need = dp * p_bytes / max(pp, 1)
                            need += wl.kv_bytes_per_layer() * wl.n_layers
                    if need > mem_budget:
                        continue
                    out.append(Strategy(tp, pp, dp, mb))
    return out or [Strategy(1, 1, 1, 1)]


def strategy_sort_key(s: Strategy) -> Tuple:
    """Search-order heuristic: prefer modest TP, deep pipelines last."""
    return (abs(math.log2(max(s.tp, 1)) - 5), s.pp, -s.microbatches)


# --------------------------------------------------------------------------
# batched strategy enumeration (DESIGN.md §4) — the design-independent part
# of `enumerate_strategies` precomputed once per workload as a combo grid,
# so per-design feasibility is a couple of vectorized comparisons.
# --------------------------------------------------------------------------

_STRATEGY_GRID_CACHE: Dict[Tuple, Dict[str, np.ndarray]] = {}


def _strategy_grid(wl) -> Dict[str, np.ndarray]:
    key = (wl.n_layers, wl.batch, wl.phase, wl.params_bytes(),
           wl.kv_bytes_per_layer())
    hit = _STRATEGY_GRID_CACHE.get(key)
    if hit is not None:
        return hit
    p_bytes = wl.params_bytes()
    opt_mult = 6.0 if wl.phase == "train" else 1.0
    pows = [2 ** i for i in range(0, 17)]
    tps, pps, dps, mbs, needs = [], [], [], [], []
    # Caps derive from the workload (pp <= n_layers, tp unbounded up to the
    # per-design core-count mask applied later); the memory column `need`
    # stays the frozen PR 2 formula — this grid is the grid-mode replay
    # contract (recorded campaign traces, fig8 fixtures) and must keep the
    # exact historical feasibility bits. The recompute-aware v2 model
    # (`strategy_memory_need`) lives in the joint-search path.
    for pp in [p for p in pows if p <= wl.n_layers]:
        for dp in [d for d in pows if d <= max(wl.batch, 1)]:
            for tp in pows:
                if wl.phase == "train":
                    need = dp * p_bytes * opt_mult / max(pp, 1)
                else:
                    need = (dp * p_bytes / max(pp, 1)
                            + wl.kv_bytes_per_layer() * wl.n_layers)
                for mb in (1, 2, 4, 8, 16, 32):
                    if wl.phase != "train" and mb > 1:
                        continue
                    if wl.batch % (dp * (mb if wl.phase == "train" else 1)):
                        continue
                    tps.append(tp); pps.append(pp); dps.append(dp)
                    mbs.append(mb); needs.append(need)
    tp = np.array(tps, np.int64)
    pp = np.array(pps, np.int64)
    dp = np.array(dps, np.int64)
    mb = np.array(mbs, np.int64)
    need = np.array(needs, np.float64)
    # stable sort by strategy_sort_key; lexsort primary = last key
    order = np.lexsort((-mb, pp, np.abs(np.log2(np.maximum(tp, 1)) - 5.0)))
    grid = {"tp": tp, "pp": pp, "dp": dp, "mb": mb, "need": need,
            "chunks": pp * dp, "order": order}
    if len(_STRATEGY_GRID_CACHE) > 64:
        _STRATEGY_GRID_CACHE.pop(next(iter(_STRATEGY_GRID_CACHE)))
    _STRATEGY_GRID_CACHE[key] = grid
    return grid


def feasible_strategy_arrays(wl, total_cores: int, mem_budget: float,
                             max_strategies: int) -> np.ndarray:
    """(k, 4) int64 array of [tp, pp, dp, microbatches], sorted by
    `strategy_sort_key` and capped — element-wise identical to
    sorted(enumerate_strategies(...), key=strategy_sort_key)[:cap], with the
    same Strategy(1,1,1,1) fallback when nothing is feasible."""
    g = _strategy_grid(wl)
    mask = ((g["chunks"] * g["tp"] <= total_cores)
            & (g["tp"] <= total_cores) & (g["need"] <= mem_budget))
    idx = g["order"][mask[g["order"]]][:max_strategies]
    if len(idx) == 0:
        return np.array([[1, 1, 1, 1]], np.int64)
    return np.stack([g["tp"][idx], g["pp"][idx], g["dp"][idx],
                     g["mb"][idx]], axis=1)


# NumPy oracle alias for the torch strategy-grid selection
# (repro_torch.core.eval_compiled reproduces the mask, the sorted order, the cap
# and the (1,1,1,1) fallback bit-exactly in-program)
feasible_strategy_arrays_ref = feasible_strategy_arrays
