"""Cycle-approximate NoC simulator — the ground-truth oracle standing in for
the paper's extended BookSim2 (§VIII-A; see DESIGN.md §3 for the fidelity
argument). Wormhole-approximate queueing at packet granularity:

  - each directed mesh link transmits 1 flit/cycle (flit = noc_bw bits);
  - a packet's head advances hop-by-hop, queueing on per-link next-free
    times (contention), paying 1 router-cycle per hop;
  - serialization (flit count) is paid on each link's occupancy and once on
    delivery (wormhole pipelining);
  - per-link waiting times are accumulated — they are the GNN's regression
    targets, and packet latencies validate Eq. 6 reconstruction.

The port's own copy of `repro.core.noc_sim`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.compiler import ChunkGraph, _xy_route
from repro_torch.core.design_space import WSCDesign


@dataclasses.dataclass
class Packet:
    src: int
    dst: int
    flits: int
    inject: float


@dataclasses.dataclass
class SimResult:
    makespan: float
    avg_latency: float
    link_wait: Dict[Tuple[int, int], float]     # avg waiting per link
    link_util: Dict[Tuple[int, int], float]


def packets_for_transfer(graph: ChunkGraph, design: WSCDesign, t_idx: int
                         ) -> List[Packet]:
    t = graph.transfers[t_idx]
    interval = graph.ops[t.src_op].tile.out_interval_cycles
    flit_bits = design.noc_bw
    pkts = []
    per_src_seq: Dict[int, int] = {}
    for s, d, b in t.pairs:
        seq = per_src_seq.get(s, 0)
        per_src_seq[s] = seq + 1
        flits = max(int(np.ceil(b * 8.0 / flit_bits)), 1)
        pkts.append(Packet(s, d, flits, inject=seq * interval))
    return pkts


def simulate(packets: List[Packet], W: int) -> SimResult:
    """Event-ordered single-pass queueing simulation."""
    link_free: Dict[Tuple[int, int], float] = {}
    wait_sum: Dict[Tuple[int, int], float] = {}
    wait_cnt: Dict[Tuple[int, int], int] = {}
    busy: Dict[Tuple[int, int], float] = {}

    done_t = []
    # process in inject order (heap keyed by current head time)
    heap = [(p.inject, i) for i, p in enumerate(packets)]
    heapq.heapify(heap)
    while heap:
        t0, i = heapq.heappop(heap)
        p = packets[i]
        t = t0
        for hop in _xy_route(p.src, p.dst, W):
            free = link_free.get(hop, 0.0)
            start = max(t, free)
            wait_sum[hop] = wait_sum.get(hop, 0.0) + (start - t)
            wait_cnt[hop] = wait_cnt.get(hop, 0) + 1
            link_free[hop] = start + p.flits          # serialization occupancy
            busy[hop] = busy.get(hop, 0.0) + p.flits
            t = start + 1.0                            # head advances (wormhole)
        done_t.append(t + p.flits)                     # tail arrives

    makespan = max(done_t) if done_t else 0.0
    lat = [dt - p.inject for dt, p in zip(done_t, packets)]
    link_wait = {k: wait_sum[k] / max(wait_cnt[k], 1) for k in wait_sum}
    util = {k: busy[k] / max(makespan, 1.0) for k in busy}
    return SimResult(makespan=makespan,
                     avg_latency=float(np.mean(lat)) if lat else 0.0,
                     link_wait=link_wait, link_util=util)


# ---------------------------------------------------------------------------
# vectorized multi-lane simulation (DESIGN.md §4b)
#
# B independent packet sets ("lanes" — e.g. one per (design, transfer)
# candidate) advance in lockstep: the packet loop and the hop loop stay
# sequential (each lane's queueing is inherently ordered) but every step is
# one NumPy op over all lanes at once, against per-link next-free-time
# arrays indexed by a global slot id. Lanes must use disjoint slot ranges,
# which also makes the scatter writes collision-free. Per lane the arithmetic
# and ordering are identical to `simulate`, so results match bit-for-bit.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimBatchResult:
    makespan: np.ndarray       # (B,)
    avg_latency: np.ndarray    # (B,)
    wait_sum: np.ndarray       # (n_slots,) total waiting per link slot
    wait_cnt: np.ndarray       # (n_slots,) packets that crossed each slot
    busy: np.ndarray           # (n_slots,) flit-cycles of occupancy


def simulate_batch(flits: np.ndarray, inject: np.ndarray,
                   route_slots: np.ndarray, route_len: np.ndarray,
                   n_pkts: np.ndarray, n_slots: int) -> SimBatchResult:
    """Lockstep simulation of B independent lanes.

    flits/inject: (B, P) per-packet, already sorted by (inject, index) within
    each lane (the order `simulate`'s heap pops); route_slots: (B, P, L)
    global link-slot ids per hop (disjoint ranges per lane, entries beyond
    route_len unread); route_len: (B, P); n_pkts: (B,) real packets per lane.
    """
    flits = np.asarray(flits, np.float64)
    inject = np.asarray(inject, np.float64)
    route_len = np.asarray(route_len, np.int64)
    n_pkts = np.asarray(n_pkts, np.int64)
    B, P = flits.shape
    # slot n_slots is a scratch slot for masked-off lanes
    link_free = np.zeros(n_slots + 1)
    wait_sum = np.zeros(n_slots + 1)
    wait_cnt = np.zeros(n_slots + 1, np.int64)
    busy = np.zeros(n_slots + 1)
    makespan = np.zeros(B)
    lat_sum = np.zeros(B)
    for p in range(P):
        act = p < n_pkts
        if not act.any():
            break
        t = inject[:, p].copy()
        fl = flits[:, p]
        rl = route_len[:, p]
        for l in range(int(rl.max(initial=0))):
            valid = act & (l < rl)
            slot = np.where(valid, route_slots[:, p, l], n_slots)
            free = link_free[slot]
            start = np.maximum(t, free)
            wait_sum[slot] += np.where(valid, start - t, 0.0)
            wait_cnt[slot] += valid
            link_free[slot] = np.where(valid, start + fl, free)
            busy[slot] += np.where(valid, fl, 0.0)
            t = np.where(valid, start + 1.0, t)
        done = t + fl
        makespan = np.where(act, np.maximum(makespan, done), makespan)
        lat_sum += np.where(act, done - inject[:, p], 0.0)
    return SimBatchResult(
        makespan=makespan,
        avg_latency=lat_sum / np.maximum(n_pkts, 1),
        wait_sum=wait_sum[:n_slots], wait_cnt=wait_cnt[:n_slots],
        busy=busy[:n_slots])


def simulate_many(packet_lists: List[List[Packet]], Ws: List[int]
                  ) -> List[SimResult]:
    """Run B independent `simulate` calls as one `simulate_batch` pass.
    Lane i reproduces `simulate(packet_lists[i], Ws[i])` bit-for-bit."""
    B = len(packet_lists)
    if B == 0:
        return []
    lanes = []
    for pkts, W in zip(packet_lists, Ws):
        order = sorted(range(len(pkts)), key=lambda i: (pkts[i].inject, i))
        routes = [_xy_route(pkts[i].src, pkts[i].dst, W) for i in order]
        links = sorted({h for r in routes for h in r})
        eid = {l: j for j, l in enumerate(links)}
        lanes.append((pkts, order, routes, links, eid))
    P = max(len(p) for p, *_ in lanes)
    L = max((len(r) for _, _, rs, _, _ in lanes for r in rs), default=0)
    offs = np.concatenate([[0], np.cumsum([len(l[3]) for l in lanes])])
    n_slots = int(offs[-1])
    flits = np.zeros((B, P))
    inject = np.zeros((B, P))
    route_slots = np.zeros((B, P, max(L, 1)), np.int64)
    route_len = np.zeros((B, P), np.int64)
    n_pkts = np.array([len(p) for p, *_ in lanes], np.int64)
    for b, (pkts, order, routes, links, eid) in enumerate(lanes):
        for j, (i, r) in enumerate(zip(order, routes)):
            flits[b, j] = pkts[i].flits
            inject[b, j] = pkts[i].inject
            route_len[b, j] = len(r)
            for l, hop in enumerate(r):
                route_slots[b, j, l] = offs[b] + eid[hop]
    out = simulate_batch(flits, inject, route_slots, route_len, n_pkts,
                         n_slots)
    results = []
    for b, (pkts, _, _, links, _) in enumerate(lanes):
        lo = int(offs[b])
        ws = out.wait_sum[lo:lo + len(links)]
        wc = out.wait_cnt[lo:lo + len(links)]
        bz = out.busy[lo:lo + len(links)]
        mk = float(out.makespan[b])
        link_wait = {l: ws[j] / max(wc[j], 1)
                     for j, l in enumerate(links) if wc[j] > 0}
        util = {l: bz[j] / max(mk, 1.0)
                for j, l in enumerate(links) if bz[j] > 0}
        results.append(SimResult(
            makespan=mk,
            avg_latency=float(out.avg_latency[b]) if len(pkts) else 0.0,
            link_wait=link_wait, link_util=util))
    return results


def chunk_latency_cycles_sim(graph: ChunkGraph, design: WSCDesign) -> float:
    """High-fidelity chunk latency: compute + simulated comm makespans."""
    total = 0.0
    for i, node in enumerate(graph.ops):
        total += node.tile.cycles
        if i < len(graph.transfers) and graph.transfers[i].pairs:
            pkts = packets_for_transfer(graph, design, i)
            total += simulate(pkts, graph.array[1]).makespan
    return total
