"""Chunk-level evaluation (paper §VI-D): TP collectives, PP stage transfers,
DP weight-update traffic, DRAM access, pipeline (micro-batch) efficiency —
combined with the op-level chunk latency into step time, throughput and
power (action-energy accounting, §VI-E).

The core math lives in `evaluate_step_batch`, which broadcasts every term
over a leading candidate axis given a `DesignBatch` (DESIGN.md §4); the
scalar `evaluate_step` delegates to it with a length-1 batch.

The port's own copy of `repro.core.chunk_eval`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import components as C
from repro_torch.core.compiler import ChunkGraph, Strategy
from repro_torch.core.design_space import DesignBatch, WSCDesign
from repro_torch.core.workload import BYTES, LLMWorkload


@dataclasses.dataclass
class StepResult:
    step_time_s: float
    throughput: float              # tokens/s
    power_w: float                 # average dynamic + static (per system)
    pipeline_eff: float
    breakdown: Dict[str, float]    # seconds per component
    energy_j: float
    feasible: bool = True
    reason: str = ""


def evaluate_step_batch(geom: DesignBatch, wl: LLMWorkload,
                        tp: np.ndarray, pp: np.ndarray, dp: np.ndarray,
                        mb: np.ndarray, chunk_latency_cycles: np.ndarray,
                        sram_bits_layer: np.ndarray,
                        noc_bytes_layer: np.ndarray, n_wafers: np.ndarray,
                        peak_power_w: Optional[float] = None,
                        legacy_dram_energy: bool = False,
                        ep: Optional[np.ndarray] = None,
                        recompute: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
    """Batched chunk-level model over C candidates.

    geom holds the per-candidate design geometry (already gathered to the
    candidate axis); tp/pp/dp/mb are the strategy knobs; chunk_latency_cycles,
    sram_bits_layer (SRAM bits moved per layer across the chunk grid) and
    noc_bytes_layer (NoC byte-hops per layer) come from the tile/NoC stage.
    Returns a dict of (C,) arrays: step_time_s, throughput, power_w,
    pipeline_eff, energy_j, feasible, plus the per-component breakdown terms
    (compute_s/tp_s/pp_s/dram_s/dp_s are per-microbatch stage seconds).

    Joint-search extras (ISSUE 9): `ep` (expert parallel degree) and
    `recompute` (activation recomputation) are optional (C,) arrays. Every
    extra term is `np.where`-guarded so a lane with ep=1/recompute=False is
    bitwise identical to the legacy model (x + 0.0 == x, where(False, _, y)
    == y) — the grid-mode replay contract is preserved by construction.
    Recompute re-runs the forward in the backward pass (bwd 3x -> 4x,
    training only); ep shards the expert weights and adds per-layer
    dispatch/combine all-to-all over the inter-reticle fabric.
    """
    tp = np.asarray(tp, np.int64)
    pp = np.asarray(pp, np.int64)
    dp = np.asarray(dp, np.int64)
    mb = np.asarray(mb, np.int64)
    nw = np.asarray(n_wafers, np.int64)
    lat = np.asarray(chunk_latency_cycles, np.float64)

    train = wl.phase == "train"
    bwd_mult = 3.0 if train else 1.0
    if recompute is not None and train:
        bwd_mult = np.where(np.asarray(recompute, bool), 4.0, 3.0)
    ep_arr = None if ep is None else np.maximum(np.asarray(ep, np.int64), 1)
    mb_count = mb if train else np.ones_like(mb)
    mb_tokens = np.maximum(wl.tokens_per_step() // (dp * mb_count), 1)
    layers_per_stage = np.maximum(wl.n_layers // pp, 1)
    chunks = pp * dp
    act_bytes = (mb_tokens * wl.d_model).astype(np.float64) * BYTES
    p_bytes = wl.params_bytes()

    # --- per-microbatch stage time -----------------------------------------
    compute_s = lat * layers_per_stage / C.CLOCK_HZ * bwd_mult

    # TP all-reduce: 2 collectives per layer over the TP group (Megatron)
    cores_per_chunk = geom.total_cores * nw // np.maximum(chunks, 1)
    tp_vol = 2.0 * (tp - 1) / tp * act_bytes * 2.0
    tp_bw = np.where(cores_per_chunk <= geom.cores_per_reticle,
                     geom.reticle_bisection_Bps, geom.inter_reticle_bw_Bps)
    tp_s = np.where(tp <= 1, 0.0, tp_vol / np.maximum(tp_bw, 1.0)) \
        * layers_per_stage * bwd_mult

    pp_s = np.where(
        pp <= 1, 0.0,
        act_bytes / np.maximum(geom.inter_reticle_bw_Bps, 1.0)) * bwd_mult

    # DRAM: weight/KV streaming beyond SRAM capacity (per microbatch, chunk)
    sram_per_chunk = (geom.buffer_kb * 1024.0 * geom.total_cores * nw
                      / np.maximum(chunks, 1))
    w_bytes = p_bytes / np.maximum(pp, 1)
    if ep_arr is not None:
        # expert weights shard over the ep group (dense slice replicated)
        p_exp = wl.expert_params_bytes()
        w_bytes = np.where(ep_arr > 1,
                           ((p_bytes - p_exp) + p_exp / ep_arr)
                           / np.maximum(pp, 1), w_bytes)
    # KV-cache traffic per step (per chunk): a decode step streams the whole
    # resident cache to score one new token per sequence and appends that
    # token's K/V (per-token KV read + write); a prefill step writes the
    # whole prompt's K/V once. Training keeps no cache.
    kv_total = wl.kv_bytes_per_layer() * wl.n_layers / np.maximum(pp, 1)
    if wl.phase == "decode":
        kv_read, kv_write = kv_total, kv_total / max(wl.seq, 1)
    elif wl.phase == "prefill":
        kv_read, kv_write = 0.0, kv_total
    else:
        kv_read = kv_write = 0.0
    spill = np.maximum(w_bytes + kv_read - sram_per_chunk, 0.0)
    reticles_per_chunk = np.maximum(
        geom.n_reticles * nw / np.maximum(chunks, 1), 1e-9)
    stacked_bw = geom.dram_bw_Bps_per_reticle * reticles_per_chunk
    n_edge = 2 * (geom.ret_h + geom.ret_w)
    offchip_bw = n_edge * C.OFFCHIP_BW_PER_CTRL / np.maximum(chunks, 1)
    transit = geom.inter_reticle_bw_Bps * np.minimum(geom.ret_h, geom.ret_w) \
        / np.maximum(chunks, 1)
    dram_bw = np.where(geom.dram_on, stacked_bw,
                       np.minimum(offchip_bw, transit))
    # KV writes hit DRAM only when the cache cannot live in SRAM beside the
    # weights (otherwise appends land in the on-wafer buffers)
    kv_in_dram = (w_bytes + kv_total) > sram_per_chunk
    dram_traffic = spill + np.where(kv_in_dram, kv_write, 0.0)
    dram_s = np.where(dram_traffic <= 0, 0.0,
                      dram_traffic / np.maximum(dram_bw, 1.0))

    stage_s = compute_s + tp_s + pp_s + dram_s
    a2a_vol = None
    ep_s = np.zeros_like(stage_s)
    if ep_arr is not None:
        # MoE dispatch+combine all-to-all per layer (fwd, x2 directions,
        # top-k routed copies), over the inter-reticle fabric
        topk = max(wl.moe_topk, 1)
        a2a_vol = np.where(ep_arr > 1,
                           4.0 * (ep_arr - 1) / ep_arr * act_bytes * topk,
                           0.0)
        ep_s = (a2a_vol / np.maximum(geom.inter_reticle_bw_Bps, 1.0)
                * layers_per_stage * bwd_mult)
        stage_s = stage_s + ep_s

    # --- pipeline + step ----------------------------------------------------
    eff = mb_count / (mb_count + pp - 1.0)
    iter_s = stage_s * mb_count / eff
    # DP gradient all-reduce (training only)
    grad_vol = 2.0 * (dp - 1) / dp * w_bytes
    wafers_per_replica = np.maximum(nw / dp, 1e-9)
    dp_bw = np.where(wafers_per_replica >= 1.0,
                     n_edge * C.INTER_WAFER_BW_PER_NI,
                     geom.inter_reticle_bw_Bps
                     * np.minimum(geom.ret_h, geom.ret_w))
    dp_s = np.where((dp <= 1) | (not train), 0.0,
                    grad_vol / np.maximum(dp_bw, 1.0))
    step_s = iter_s + dp_s
    tokens = wl.tokens_per_step()
    throughput = tokens / np.maximum(step_s, 1e-12)

    # --- energy (action accounting, §VI-E) ----------------------------------
    E = C.ENERGY
    e_mac = wl.flops_per_step() / 2.0 * E.mac * 1e-12
    e_sram = (np.asarray(sram_bits_layer, np.float64) * wl.n_layers
              * mb_count * dp * bwd_mult * E.sram_read_bit * 1e-12)
    e_noc = (np.asarray(noc_bytes_layer, np.float64) * 8 * wl.n_layers
             * mb_count * dp * bwd_mult * E.noc_bit_hop * 1e-12)
    ir_bytes = (2.0 * (tp - 1) / np.maximum(tp, 1) * mb_tokens * wl.d_model
                * BYTES * 2 * wl.n_layers * mb_count * dp * bwd_mult)
    ir_bytes = ir_bytes + p_bytes * 2 * (dp > 1)
    if a2a_vol is not None:
        ir_bytes = ir_bytes + a2a_vol * wl.n_layers * mb_count * dp
    e_ir = ir_bytes * 8 * geom.ir_energy_pj_per_bit * 1e-12
    # DRAM energy charges the same per-step traffic as the latency term
    # above (SRAM pool sized per system — nw wafers — plus KV streaming).
    # legacy_dram_energy=True reproduces the inherited asymmetric model
    # bit-for-bit (capacity sized per wafer, no nw factor; KV ignored) so
    # the pre-fix behavior stays testable.
    if legacy_dram_energy:
        dram_bytes = np.maximum(
            p_bytes / np.maximum(pp, 1)
            - geom.buffer_kb * 1024.0 * geom.total_cores
            / np.maximum(chunks, 1),
            0.0) * mb_count * dp
    else:
        dram_bytes = dram_traffic * mb_count * dp
    e_dram = dram_bytes * 8 * np.where(geom.dram_on, E.dram_bit,
                                       E.offchip_bit) * 1e-12
    static_w = geom.static_power_w * nw
    energy = e_mac + e_sram + e_noc + e_ir + e_dram + static_w * step_s

    bad = ~(np.isfinite(step_s) & np.isfinite(energy))
    power = np.where(bad, np.inf, energy / np.maximum(step_s, 1e-12))
    limit = (peak_power_w if peak_power_w is not None
             else C.WAFER_POWER_W * nw)
    feasible = ~bad & (power <= limit) & np.isfinite(power)
    return {
        "step_time_s": np.where(bad, np.inf, step_s),
        "throughput": np.where(bad, 0.0, throughput),
        "power_w": power,
        "pipeline_eff": eff,
        "energy_j": np.where(bad, 0.0, energy),
        "feasible": feasible,
        "non_finite": bad,
        # per-microbatch stage components (for the winner's breakdown)
        "compute_s": compute_s, "tp_s": tp_s, "pp_s": pp_s,
        "dram_s": dram_s, "dp_s": dp_s, "ep_s": ep_s,
        "mb_count": mb_count,
    }


# NumPy oracle alias for the torch pipeline (repro_torch.core.eval_compiled)
evaluate_step_batch_ref = evaluate_step_batch


def step_result_at(out: Dict[str, np.ndarray], i: int) -> StepResult:
    """Materialize candidate i of an `evaluate_step_batch` result as the
    scalar StepResult (with its seconds-per-component breakdown)."""
    if bool(out["non_finite"][i]):
        return StepResult(float("inf"), 0.0, float("inf"),
                          float(out["pipeline_eff"][i]), {}, 0.0,
                          feasible=False, reason="non_finite")
    eff = float(out["pipeline_eff"][i])
    mbc = float(out["mb_count"][i])
    feasible = bool(out["feasible"][i])
    bd = {"compute": float(out["compute_s"][i]) * mbc / eff,
          "tp": float(out["tp_s"][i]) * mbc / eff,
          "pp": float(out["pp_s"][i]) * mbc / eff,
          "dram": float(out["dram_s"][i]) * mbc / eff,
          "dp": float(out["dp_s"][i])}
    ep_s = float(out["ep_s"][i]) if "ep_s" in out else 0.0
    if ep_s:
        # only when expert parallelism is active — grid-mode breakdowns
        # (and their recorded fingerprints) keep the legacy key set
        bd["ep"] = ep_s * mbc / eff
    return StepResult(
        step_time_s=float(out["step_time_s"][i]),
        throughput=float(out["throughput"][i]),
        power_w=float(out["power_w"][i]),
        pipeline_eff=eff,
        breakdown=bd,
        energy_j=float(out["energy_j"][i]),
        feasible=feasible,
        reason="" if feasible else "power",
    )


# batch-of-one geometry views, memoized per (hashable) design so the scalar
# path doesn't recompute the derived geometry once per strategy
_GEOM_CACHE: Dict[WSCDesign, DesignBatch] = {}


def _geom_for(design: WSCDesign) -> DesignBatch:
    g = _GEOM_CACHE.get(design)
    if g is None:
        if len(_GEOM_CACHE) >= 4096:
            _GEOM_CACHE.pop(next(iter(_GEOM_CACHE)))
        g = DesignBatch.from_designs([design])
        _GEOM_CACHE[design] = g
    return g


def evaluate_step(design: WSCDesign, wl: LLMWorkload, s: Strategy,
                  chunk_latency_cycles: float, graph: ChunkGraph,
                  n_wafers: int, peak_power_w: Optional[float] = None,
                  legacy_dram_energy: bool = False) -> StepResult:
    """Combine op-level chunk latency with chunk-level comm/DRAM/pipeline.
    Scalar wrapper over `evaluate_step_batch` (batch of one)."""
    geom = _geom_for(design)
    sram_bits_layer = sum(o.tile.sram_read_bits + o.tile.sram_write_bits
                          for o in graph.ops) * graph.n_cores
    noc_bytes_layer = float(graph.link_loads.sum())
    out = evaluate_step_batch(
        geom, wl, np.asarray([s.tp]), np.asarray([s.pp]), np.asarray([s.dp]),
        np.asarray([s.microbatches]), np.asarray([chunk_latency_cycles]),
        np.asarray([sram_bits_layer]), np.asarray([noc_bytes_layer]),
        np.asarray([n_wafers]), peak_power_w,
        legacy_dram_energy=legacy_dram_energy,
        ep=np.asarray([s.ep]), recompute=np.asarray([s.recompute]))
    return step_result_at(out, 0)
