"""Op-level analytical NoC model (paper §VI-C, low fidelity / f1).

Per-link volumes from the Workload Compiler -> equivalent bandwidth per link
(noc_bw / #flows sharing it) -> per-edge communication delay -> chunk latency
as the longest path over the (chain-structured) logic core graph in
topological order. DRAM access + inter-chunk sync belong to chunk_eval.

Two entry points (DESIGN.md §4):
  - `chunk_latency_cycles(graph, design)` walks an explicit ChunkGraph —
    the reference path, used by the sim/GNN fidelities and tests;
  - `chunk_latency_cycles_closed(...)` is the batched closed form for the
    row-all-gather graphs `compile_chunk` emits, broadcasting over a leading
    candidate axis without materializing any graph.

The port's own copy of `repro.core.noc_analytical`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.compiler import ChunkGraph, _xy_route
from repro_torch.core.design_space import WSCDesign


def transfer_delays(graph: ChunkGraph, design: WSCDesign) -> List[float]:
    """Per-transfer communication delay in cycles (equivalent-bandwidth)."""
    flows = graph.link_flows
    bw_bytes = design.noc_bw / 8.0          # bytes per cycle per link
    W = graph.array[1]
    routes = graph.routes or {}
    delays = []
    for t in graph.transfers:
        if not t.pairs:
            delays.append(0.0)
            continue
        # bottleneck flow count + hop count per pair, then one array op
        b = np.empty(len(t.pairs))
        fmax = np.empty(len(t.pairs))
        hops_n = np.empty(len(t.pairs))
        for i, (s, d, bb) in enumerate(t.pairs):
            hops = routes.get((s, d)) or _xy_route(s, d, W)
            f = 1.0
            for hop in hops:
                f = max(f, max(flows[graph.link_index[hop]], 1.0))
            b[i] = bb
            fmax[i] = f
            hops_n[i] = len(hops)
        eq_bw = bw_bytes / fmax
        pair_cycles = b / np.maximum(eq_bw, 1e-9) + hops_n
        delays.append(float(pair_cycles.max()))
    return delays


def chunk_latency_cycles(graph: ChunkGraph, design: WSCDesign) -> float:
    """Longest path over the chain: node compute + edge comm delays."""
    comm = transfer_delays(graph, design)
    total = 0.0
    for i, node in enumerate(graph.ops):
        total += node.tile.cycles
        if i < len(comm):
            total += comm[i]
    return total


def row_allgather_comm_cycles(out_bytes: np.ndarray, gh: np.ndarray,
                              gw: np.ndarray, noc_bw: np.ndarray,
                              n_transfers: int) -> np.ndarray:
    """Closed-form equivalent-bandwidth delay of the row all-gather transfers
    `compile_chunk` generates, summed over the op chain.

    For a (gh, gw) grid every producer tile (out_bytes / n_cores) goes to the
    gw-1 other columns of its row along XY routes, for all n_transfers
    inter-op edges at once, so the most loaded link (the row middle) carries
    n_transfers * floor(gw/2) * ceil(gw/2) flows and the worst pair is the
    full-span one (gw-1 hops through that middle link). Matches
    `transfer_delays` on the corresponding explicit graph bit-for-bit.

    out_bytes: (n_transfers, C) producer output bytes per inter-op edge;
    gh/gw/noc_bw: (C,). Returns (C,) total comm cycles.
    """
    gh = np.asarray(gh, np.int64)
    gw = np.asarray(gw, np.int64)
    bw_bytes = np.asarray(noc_bw, np.float64) / 8.0
    n_cores = gh * gw
    maxflow = np.float64(n_transfers) * (gw // 2) * ((gw + 1) // 2)
    eq_bw = bw_bytes / np.maximum(maxflow, 1.0)
    per_pair = np.asarray(out_bytes, np.float64) / n_cores
    comm = per_pair / np.maximum(eq_bw, 1e-9) + (gw - 1)
    return np.where(gw > 1, comm, 0.0).sum(axis=0)


def row_allgather_byte_hops(out_bytes: np.ndarray, gh: np.ndarray,
                            gw: np.ndarray) -> np.ndarray:
    """Closed-form `link_loads.sum()` of the row all-gather transfers: every
    (src, dst) row pair moves out_bytes/n_cores over |dst-src| hops, and the
    ordered pair distances on a row of gw cores sum to gw (gw^2 - 1) / 3.
    Feeds the NoC term of the energy model; keep in sync with
    `row_allgather_comm_cycles` and compile_chunk's pair generation.

    out_bytes: (n_transfers, C); gh/gw: (C,). Returns (C,) total byte-hops.
    """
    gh = np.asarray(gh, np.int64)
    gw = np.asarray(gw, np.int64)
    per_pair = np.where(gw > 1,
                        np.asarray(out_bytes, np.float64) / (gh * gw), 0.0)
    return (per_pair * (gh * (gw * (gw * gw - 1)) / 3.0)).sum(axis=0)


# NumPy oracle aliases for the torch pipeline (repro_torch.core.eval_compiled)
row_allgather_comm_cycles_ref = row_allgather_comm_cycles
row_allgather_byte_hops_ref = row_allgather_byte_hops


def chunk_latency_cycles_closed(tile_cycles: np.ndarray, out_bytes: np.ndarray,
                                gh: np.ndarray, gw: np.ndarray,
                                noc_bw: np.ndarray) -> np.ndarray:
    """Batched analytical chunk latency for compile_chunk-shaped chunks.

    tile_cycles: (n_ops, C) per-core tile cycles; out_bytes: (n_ops, C)
    producer output bytes (the last row feeds no transfer). Equals
    `chunk_latency_cycles(compile_chunk(...), design)` per candidate.
    """
    tile_cycles = np.asarray(tile_cycles, np.float64)
    n_ops = tile_cycles.shape[0]
    comm = row_allgather_comm_cycles(out_bytes[:-1], gh, gw, noc_bw,
                                     n_transfers=n_ops - 1)
    return tile_cycles.sum(axis=0) + comm
