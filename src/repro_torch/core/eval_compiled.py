"""The analytical evaluation pipeline on the device, in torch float64 (the
port of `repro.core.eval_compiled`).

The analytical f1 backend scores N designs by enumerating each design's
feasible parallel strategies (`compiler.feasible_strategy_arrays`), running
the tile model (`tile_eval.evaluate_tile_batch`), the closed-form
row-all-gather NoC costs (`noc_analytical`) and the chunk-level step model
(`chunk_eval.evaluate_step_batch`), and keeping each design's best feasible
strategy. `_EvalProgram` runs that whole pipeline as batched torch ops on
one device, and `dispatch_fused_eval` takes the device-resident candidate
indices the q-EHVI acquire produces (`mfmobo._acquire_batch_device`), so a
synchronous MFMOBO iteration reads nothing back between proposal and
evaluation.

Bit-exactness contract: every expression mirrors its NumPy reference
(`evaluate_tile_batch`, `evaluate_step_batch`, `row_allgather_comm_cycles`,
`row_allgather_byte_hops`, `feasible_strategy_arrays`; the copies keep
them as `*_ref`) operation for operation, in the same association order,
in float64. The pipeline uses only exactly-rounded operations (+ - * /,
min, max, integer arithmetic; the one log2 sits in `_floor_log2`, which
corrects it by +-1 to the exact integer). Eager torch rounds once per
operation as NumPy does, so on the CPU the results are hex-equal to the
NumPy pipeline (`tests/test_torch_eval.py`). Three rules keep it so:

  * every value is float64 or int64 on purpose: torch gives float32 for an
    int64 tensor times a Python float and for int64 / int64, where NumPy
    gives float64, so integers are cast before they meet a float;
  * no division by a Python scalar: on CUDA, torch divides by a host
    scalar as a multiply by its reciprocal, which is not IEEE division,
    and `scalar / tensor` is a reciprocal times the scalar on every
    device. Divisors and scalar numerators are float64 tensors on the
    device (`_EvalProgram._c`);
  * no fused operation (`addcmul`, `lerp`, matmul, `torch.compile`) where
    the reference has separate ones.

The strategy axis is the workload's sorted strategy grid, padded to a power
of two with never-feasible rows; each design's first `max_strategies`
feasible rows are picked in the program by a cumsum and a searchsorted,
with the same Strategy(1,1,1,1) fallback as `feasible_strategy_arrays`.

Joint mode (one pinned Strategy per design, no grid argmin) runs the same
`_eval_core` through `_body_pinned`, with the expert-parallel and recompute
terms of `chunk_eval.evaluate_step_batch` (`extras`); a pinned strategy
with ep = 1 and no recompute reproduces its grid row bit for bit.

Left out of this port: `repro`'s `pmap` host lanes. The program runs on one
device; `lane_stats` reports one lane, with `repro`'s keys, for the fleet's
per-campaign report. There is no switch back to NumPy: the analytical
backend always runs this program, and the NumPy pipeline is the reference
the tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import components as C
from repro_torch.core.chunk_eval import StepResult
from repro_torch.core.compiler import Strategy, _strategy_grid
from repro_torch.core.design_space import DesignBatch
from repro_torch.core.workload import BYTES, LLMWorkload
from repro_torch.device import resolve_device, to_device

F64 = torch.float64
I64 = torch.int64


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# exact integer helpers (mirrors of design_space.floor_log2,
# compiler.grid_for_batch and tile_eval._ceil_div, with the same
# correction steps, so the results are integer-exact)
# ---------------------------------------------------------------------------


def _floor_log2(n):
    n = torch.clamp_min(n.to(I64), 1)
    e = torch.floor(torch.log2(n.to(F64))).to(I64)
    one = torch.ones_like(n)
    e = torch.where(torch.bitwise_left_shift(one, torch.clamp_max(e + 1, 62))
                    <= n, e + 1, e)
    e = torch.where(torch.bitwise_left_shift(one, torch.clamp_max(e, 62))
                    > n, e - 1, e)
    return e


def _grid_for(n):
    n = torch.clamp_min(n.to(I64), 1)
    gh = torch.bitwise_left_shift(torch.ones_like(n), _floor_log2(n) // 2)
    return gh, torch.clamp_min(n // gh, 1)


def _ceil_div(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# one program per (workload, max_strategies, device)
# ---------------------------------------------------------------------------

# geometry fields the pipeline consumes, in DesignBatch attribute order
_GEOM_FIELDS = (
    "dataflow_code", "mac", "buffer_kb", "buffer_bw", "noc_bw",
    "total_cores", "cores_per_reticle", "n_reticles", "ret_h", "ret_w",
    "reticle_bisection_Bps", "inter_reticle_bw_Bps",
    "dram_bw_Bps_per_reticle", "dram_gb_per_reticle", "dram_on",
    "static_power_w", "ir_energy_pj_per_bit",
)

# the winner fields a program returns, packed into one float64 tensor so
# that reading them back is one device-to-host copy
_OUT_FIELDS = ("any_feasible", "sel_g", "throughput", "power_w",
               "step_time_s", "pipeline_eff", "energy_j", "compute_s",
               "tp_s", "pp_s", "dram_s", "dp_s", "mb_count")
# the pinned (joint) program's per-point fields, packed the same way
_PIN_FIELDS = ("feasible", "throughput", "power_w", "step_time_s",
               "pipeline_eff", "energy_j", "compute_s", "tp_s", "pp_s",
               "dram_s", "dp_s", "ep_s", "mb_count")

# dispatch accounting with `repro`'s keys: the program runs on one device,
# so every dispatch is one unsharded call
_LANE_STATS = {"n_lanes": 1, "sharded_calls": 0, "rows_sharded": 0,
               "jit_calls": 0, "rows_jit": 0}


def lane_stats():
    """Dispatch counters with `repro`'s keys: one lane, every call
    unsharded (`jit_calls` counts them, `rows_jit` their rows)."""
    return dict(_LANE_STATS)


def _count(rows: int) -> None:
    _LANE_STATS["jit_calls"] += 1
    _LANE_STATS["rows_jit"] += int(rows)

_PROGRAMS: Dict[Tuple, "_EvalProgram"] = {}
_PROGRAMS_MAX = 16


def _program_for(wl: LLMWorkload, max_strategies: int,
                 device) -> "_EvalProgram":
    dev = resolve_device(device)
    key = (wl, int(max_strategies), str(dev))
    prog = _PROGRAMS.get(key)
    if prog is None:
        if len(_PROGRAMS) >= _PROGRAMS_MAX:
            _PROGRAMS.pop(next(iter(_PROGRAMS)))
        prog = _EvalProgram(wl, max_strategies, dev)
        _PROGRAMS[key] = prog
    return prog


def _to_dev(v: np.ndarray, device) -> torch.Tensor:
    """bool stays bool, integers become int64 and floats float64 (what the
    NumPy arrays hold)."""
    a = np.asarray(v)
    dtype = (torch.bool if a.dtype == np.bool_ else
             I64 if np.issubdtype(a.dtype, np.integer) else F64)
    return to_device(a, dtype, device)


class _EvalProgram:
    """One workload's analytical pipeline on one device: the sorted
    strategy grid (pow2-padded with never-feasible rows) held on the device
    beside its host copy, plus the batch and fused-gather entry points."""

    def __init__(self, wl: LLMWorkload, max_strategies: int,
                 device: torch.device):
        self.wl = wl
        self.K = int(max_strategies)
        self.device = device

        g = _strategy_grid(wl)
        order = g["order"]
        tp_o = g["tp"][order]
        pp_o = g["pp"][order]
        dp_o = g["dp"][order]
        mb_o = g["mb"][order]
        G = len(order)
        pad = _pow2(max(G, 1)) - G
        big = np.int64(1) << 31          # pad rows: product stays < 2^63
        self._tp_o = np.concatenate([tp_o, np.full(pad, big)])
        self._pp_o = np.concatenate([pp_o, np.full(pad, big)])
        self._dp_o = np.concatenate([dp_o, np.full(pad, 1, np.int64)])
        self._mb_o = np.concatenate([mb_o, np.full(pad, 1, np.int64)])
        self._need_o = np.concatenate([g["need"][order],
                                       np.full(pad, np.inf)])
        self._chunks_o = np.concatenate([g["chunks"][order],
                                         np.full(pad, big)])
        fb = np.flatnonzero((tp_o == 1) & (pp_o == 1) & (dp_o == 1)
                            & (mb_o == 1))
        self._fb_idx = int(fb[0])        # Strategy(1,1,1,1) always exists
        self._grid = {k: _to_dev(getattr(self, f"_{k}_o"), device)
                      for k in ("tp", "pp", "dp", "mb", "need", "chunks")}

        # workload scalars, as Python numbers (exact float64 constants)
        self._train = wl.phase == "train"
        self._bwd = 3.0 if self._train else 1.0
        self._tokens = wl.tokens_per_step()
        self._p_bytes = wl.params_bytes()
        self._p_exp = wl.expert_params_bytes()
        self._kvtot_num = wl.kv_bytes_per_layer() * wl.n_layers
        self._e_mac = wl.flops_per_step() / 2.0 * C.ENERGY.mac * 1e-12
        self._consts: Dict[float, torch.Tensor] = {}

    def _c(self, x: float) -> torch.Tensor:
        """A float64 scalar on the device: the operand of every division by
        a constant (see the module docstring). Filled on the device, so
        making one reads nothing back."""
        t = self._consts.get(x)
        if t is None:
            t = self._consts[x] = torch.full((), float(x), dtype=F64,
                                             device=self.device)
        return t

    # -- the pipeline ------------------------------------------------------

    def _select(self, arrs: Dict[str, torch.Tensor], nw: torch.Tensor):
        """Each design's first K feasible rows of the sorted grid (mirrors
        feasible_strategy_arrays' mask + order + cap + fallback): (N, K)
        grid rows and the (N, K) mask of the slots that hold one."""
        K = self.K
        g = self._grid
        total_cores = arrs["total_cores"]
        Gp = g["tp"].shape[0]
        tc = total_cores * nw                              # (N,) int64
        sram_total = arrs["buffer_kb"].to(F64) * 1024.0 * total_cores * nw
        dram_total = (arrs["dram_gb_per_reticle"] * 1e9
                      * arrs["n_reticles"] * nw)
        budget = sram_total + dram_total                   # (N,) float64
        mask = ((g["chunks"][None, :] * g["tp"][None, :] <= tc[:, None])
                & (g["tp"][None, :] <= tc[:, None])
                & (g["need"][None, :] <= budget[:, None]))  # (N, Gp)
        csum = torch.cumsum(mask.to(I64), dim=1)
        count = csum[:, -1]
        ks = torch.arange(K, device=self.device)
        targets = (ks + 1).expand(len(nw), K).contiguous()
        pos = torch.searchsorted(csum, targets, side="left")
        sel = torch.clamp_max(pos, Gp - 1)                 # (N, K)
        selmask = ks[None, :] < count[:, None]
        first = (count == 0)[:, None] & (ks[None, :] == 0)
        return torch.where(first, self._fb_idx, sel), selmask | first

    def _body(self, arrs: Dict[str, torch.Tensor], nw: torch.Tensor):
        """Strategy selection, the candidate model and each design's winner
        (first max wins, as np.argmax) for N designs, packed as
        (len(_OUT_FIELDS), N) float64."""
        g = self._grid
        sel, selmask = self._select(arrs, nw)
        cand = self._eval_core(arrs, nw, g["tp"][sel], g["pp"][sel],
                               g["dp"][sel], g["mb"][sel])

        live = cand["feasible"] & selmask
        rank = torch.where(live, cand["throughput"], -1.0)
        jw = torch.argmax(rank, dim=1)[:, None]

        out = {"any_feasible": live.any(dim=1),
               "sel_g": torch.gather(sel, 1, jw)[:, 0]}
        for k in _OUT_FIELDS[2:]:
            out[k] = torch.gather(cand[k], 1, jw)[:, 0]
        return torch.stack([out[k].to(F64) for k in _OUT_FIELDS])

    def _body_pinned(self, arrs: Dict[str, torch.Tensor], nw: torch.Tensor,
                     strat: Tuple[torch.Tensor, ...]):
        """Joint-mode body: one pinned strategy per design, no grid argmin.
        `strat` = (tp, pp, dp, mb, ep, recompute) as (N,) tensors. Packed
        as (len(_PIN_FIELDS), N) float64."""
        tp, pp, dp, mb, ep, rc = (s[:, None] for s in strat)
        cand = self._eval_core(arrs, nw, tp, pp, dp, mb, (ep, rc))
        return torch.stack([cand[k][:, 0].to(F64) for k in _PIN_FIELDS])

    def _eval_core(self, arrs, nw, tp, pp, dp, mb, extras=None):
        """Candidate axis + tile/NoC/chunk-step model for (N, K) strategy
        columns, in the NumPy reference's operation order. `extras` is None
        (grid mode) or the (ep, recompute) columns of the pinned mode, whose
        terms follow `evaluate_step_batch`'s `ep=` / `recompute=` branches
        operation for operation."""
        wl = self.wl
        c = self._c

        code = arrs["dataflow_code"]
        mac = arrs["mac"]
        buffer_kb = arrs["buffer_kb"]
        buffer_bw = arrs["buffer_bw"]
        noc_bw = arrs["noc_bw"]
        total_cores = arrs["total_cores"]

        # --- candidate axis (build_candidate_axis mirror), shapes (N, K)
        zi = torch.zeros_like(tp)        # int broadcast helper
        chunks = pp * dp
        mb_count = mb if self._train else torch.ones_like(mb)
        mb_tokens = torch.clamp_min((zi + self._tokens) // (dp * mb_count), 1)
        tcn = (total_cores * nw)[:, None]
        cores_per_chunk = torch.clamp_min(tcn // chunks, 1)
        gh_t, gw_t = _grid_for(cores_per_chunk)
        gh, gw = _grid_for(torch.clamp_max(cores_per_chunk, 64))
        n_cores = gh * gw

        # layer_ops_batch mirror: the 6 GEMMs of one layer under tp
        D, F = wl.d_model, wl.d_ff
        hd = D // max(wl.n_heads, 1)
        e = wl.moe_topk if wl.moe_experts else 1
        heads_tp = torch.clamp_min((zi + wl.n_heads) // tp, 1)
        M = mb_tokens
        m_attn = M * heads_tp // max(wl.n_heads, 1)
        kv_len = wl.seq
        ops = (
            (M, zi + D, (zi + (wl.n_heads + 2 * wl.n_kv) * hd) // tp),
            (m_attn, zi + hd, zi + kv_len),
            (m_attn, zi + kv_len, zi + hd),
            (M, (zi + wl.n_heads * hd) // tp, zi + D),
            (M * e, zi + D, (zi + 2 * F) // tp),
            (M * e, (zi + F) // tp, zi + D),
        )

        # tile stage per op (evaluate_tile_batch mirror), accumulated in
        # the same sequential order as the NumPy axis-0 sums
        bbw = buffer_bw[:, None]
        mac2 = mac[:, None]
        code2 = code[:, None]
        ws = code2 == 0
        os_ = code2 == 2
        pr = torch.bitwise_left_shift(torch.ones_like(mac2),
                                      _floor_log2(mac2) // 2)
        pc = torch.clamp_min(mac2, 1) // pr
        buf_bits = buffer_kb[:, None].to(F64) * 1024 * 8

        def sel3(a, b, c_):
            return torch.where(ws, a, torch.where(os_, b, c_))

        # NoC closed form shared terms (row_allgather_* mirrors)
        bw_bytes = noc_bw[:, None].to(F64) / c(8.0)
        n_transfers = len(ops) - 1
        maxflow = (gw // 2).to(F64) * float(n_transfers) * ((gw + 1) // 2)
        eq_bw = bw_bytes / torch.clamp_min(maxflow, 1.0)
        hop_fac = (gh * (gw * (gw * gw - 1))).to(F64) / c(3.0)

        cycles_sum = sram_sum = comm_sum = hops_sum = None
        for oi, (Mo, Ko, No) in enumerate(ops):
            tM = torch.clamp_min(torch.clamp_min(Mo // gh_t, 1), 1)
            tK = torch.clamp_min(Ko, 1)
            tN = torch.clamp_min(torch.clamp_min(No // gw_t, 1), 1)
            u1 = sel3(tK, tM, tM)
            u2 = sel3(tN, tN, tK)
            stream = sel3(tM, tK, tN)
            t1 = _ceil_div(u1, pr)
            t2 = _ceil_div(u2, pc)
            compute = (t1 * t2).to(F64) * stream
            Mf, Kf, Nf = tM.to(F64), tK.to(F64), tN.to(F64)
            reads = sel3(Kf * Nf + Mf * Kf * t2,
                         Mf * Kf * t2 + Kf * Nf * t1,
                         Mf * Kf + Kf * Nf * t1)
            writes = sel3(Mf * Nf * t1, Mf * Nf, Mf * Nf * t2)
            stat1 = sel3(torch.minimum(tK, pr), torch.minimum(tM, pr),
                         torch.minimum(tM, pr))
            stat2 = sel3(torch.minimum(tN, pc), torch.minimum(tN, pc),
                         torch.minimum(tK, pc))
            stat_bits = (stat1 * stat2).to(F64) * BYTES * 8
            cap_factor = torch.clamp_min(
                stat_bits / torch.clamp_min(buf_bits, 1), 1.0)
            read_bits = reads * BYTES * 8 * cap_factor
            write_bits = writes * BYTES * 8
            rw = read_bits + write_bits
            mem_cycles = rw / torch.clamp_min(bbw, 1)
            cyc = torch.maximum(compute, mem_cycles)
            cycles_sum = cyc if cycles_sum is None else cycles_sum + cyc
            sram_sum = rw if sram_sum is None else sram_sum + rw
            if oi < n_transfers:         # producer feeds a transfer
                out_b = (Mo * No).to(F64) * BYTES
                per_pair = out_b / n_cores
                comm = per_pair / torch.clamp_min(eq_bw, 1e-9) + (gw - 1)
                comm = torch.where(gw > 1, comm, 0.0)
                comm_sum = comm if comm_sum is None else comm_sum + comm
                pph = torch.where(gw > 1, out_b / (gh * gw), 0.0)
                hop = pph * hop_fac
                hops_sum = hop if hops_sum is None else hops_sum + hop

        lat = cycles_sum + comm_sum
        sram_bits_layer = sram_sum * n_cores
        noc_bytes_layer = hops_sum

        # --- chunk-level step model (evaluate_step_batch mirror) ---------
        nw2 = nw[:, None]
        bwd = self._bwd
        ep2 = None
        if extras is not None:
            ep2 = torch.clamp_min(extras[0], 1)
            if self._train:
                # recompute re-runs the forward in the backward: 3x -> 4x
                bwd = torch.where(extras[1], c(4.0), c(3.0))
        layers_per_stage = torch.clamp_min((zi + wl.n_layers) // pp, 1)
        act_bytes = (mb_tokens * wl.d_model).to(F64) * BYTES
        p_bytes = self._p_bytes
        chunks1 = torch.clamp_min(chunks, 1).to(F64)
        pp1 = torch.clamp_min(pp, 1).to(F64)

        compute_s = lat * layers_per_stage / c(C.CLOCK_HZ) * bwd
        cpc_step = total_cores[:, None] * nw2 // torch.clamp_min(chunks, 1)
        tp_vol = (tp - 1).to(F64) * 2.0 / tp * act_bytes * 2.0
        tp_bw = torch.where(cpc_step <= arrs["cores_per_reticle"][:, None],
                            arrs["reticle_bisection_Bps"][:, None],
                            arrs["inter_reticle_bw_Bps"][:, None])
        tp_s = torch.where(tp <= 1, 0.0,
                           tp_vol / torch.clamp_min(tp_bw, 1.0)) \
            * layers_per_stage * bwd
        ir_bw = arrs["inter_reticle_bw_Bps"][:, None]
        pp_s = torch.where(pp <= 1, 0.0,
                           act_bytes / torch.clamp_min(ir_bw, 1.0)) * bwd

        sram_per_chunk = (buffer_kb[:, None].to(F64) * 1024.0
                          * total_cores[:, None] * nw2 / chunks1)
        w_bytes = c(p_bytes) / pp1
        if ep2 is not None:
            # expert weights shard over the ep group (dense slice replicated)
            p_exp = self._p_exp
            w_bytes = torch.where(
                ep2 > 1, (c(p_bytes - p_exp) + c(p_exp) / ep2.to(F64)) / pp1,
                w_bytes)
        kv_total = c(self._kvtot_num) / pp1
        zero = c(0.0)
        if wl.phase == "decode":
            kv_read, kv_write = kv_total, kv_total / c(max(wl.seq, 1))
        elif wl.phase == "prefill":
            kv_read, kv_write = zero, kv_total
        else:
            kv_read = kv_write = zero
        spill = torch.clamp_min(w_bytes + kv_read - sram_per_chunk, 0.0)
        reticles_per_chunk = torch.clamp_min(
            (arrs["n_reticles"][:, None] * nw2).to(F64) / chunks1, 1e-9)
        stacked_bw = (arrs["dram_bw_Bps_per_reticle"][:, None]
                      * reticles_per_chunk)
        ret_h = arrs["ret_h"][:, None]
        ret_w = arrs["ret_w"][:, None]
        n_edge = 2 * (ret_h + ret_w)
        offchip_bw = n_edge.to(F64) * C.OFFCHIP_BW_PER_CTRL / chunks1
        transit = ir_bw * torch.minimum(ret_h, ret_w) / chunks1
        dram_on = arrs["dram_on"][:, None]
        dram_bw = torch.where(dram_on, stacked_bw,
                              torch.minimum(offchip_bw, transit))
        kv_in_dram = (w_bytes + kv_total) > sram_per_chunk
        dram_traffic = spill + torch.where(kv_in_dram, kv_write, zero)
        dram_s = torch.where(dram_traffic <= 0, 0.0,
                             dram_traffic / torch.clamp_min(dram_bw, 1.0))

        stage_s = compute_s + tp_s + pp_s + dram_s
        a2a_vol = ep_s = None
        if ep2 is not None:
            # MoE dispatch+combine all-to-all per layer over the
            # inter-reticle fabric (zero where ep = 1: x + 0.0 == x)
            topk = max(wl.moe_topk, 1)
            a2a_vol = torch.where(
                ep2 > 1, (ep2 - 1).to(F64) * 4.0 / ep2.to(F64) * act_bytes
                * topk, 0.0)
            ep_s = (a2a_vol / torch.clamp_min(ir_bw, 1.0) * layers_per_stage
                    * bwd)
            stage_s = stage_s + ep_s
        eff = mb_count.to(F64) / ((mb_count + pp).to(F64) - 1.0)
        iter_s = stage_s * mb_count / eff
        grad_vol = (dp - 1).to(F64) * 2.0 / dp * w_bytes
        wafers_per_replica = torch.clamp_min(nw2.to(F64) / dp.to(F64), 1e-9)
        dp_bw = torch.where(wafers_per_replica >= 1.0,
                            n_edge.to(F64) * C.INTER_WAFER_BW_PER_NI,
                            ir_bw * torch.minimum(ret_h, ret_w))
        dp_s = torch.where((dp <= 1) | (not self._train), 0.0,
                           grad_vol / torch.clamp_min(dp_bw, 1.0))
        step_s = iter_s + dp_s
        throughput = c(self._tokens) / torch.clamp_min(step_s, 1e-12)

        E = C.ENERGY
        e_sram = (sram_bits_layer * wl.n_layers * mb_count * dp * bwd
                  * E.sram_read_bit * 1e-12)
        e_noc = (noc_bytes_layer * 8 * wl.n_layers * mb_count * dp * bwd
                 * E.noc_bit_hop * 1e-12)
        ir_bytes = ((tp - 1).to(F64) * 2.0 / torch.clamp_min(tp, 1)
                    * mb_tokens * wl.d_model * BYTES * 2 * wl.n_layers
                    * mb_count * dp * bwd)
        ir_bytes = ir_bytes + (dp > 1).to(F64) * (p_bytes * 2)
        if a2a_vol is not None:
            ir_bytes = ir_bytes + a2a_vol * wl.n_layers * mb_count * dp
        e_ir = ir_bytes * 8 * arrs["ir_energy_pj_per_bit"][:, None] * 1e-12
        dram_bytes = dram_traffic * mb_count * dp
        e_dram = dram_bytes * 8 * torch.where(
            dram_on, c(E.dram_bit), c(E.offchip_bit)) * 1e-12
        static_w = arrs["static_power_w"][:, None] * nw2
        energy = (self._e_mac + e_sram + e_noc + e_ir + e_dram
                  + static_w * step_s)

        bad = ~(torch.isfinite(step_s) & torch.isfinite(energy))
        power = torch.where(bad, torch.inf,
                            energy / torch.clamp_min(step_s, 1e-12))
        limit = C.WAFER_POWER_W * nw2.to(F64)
        feasible = ~bad & (power <= limit) & torch.isfinite(power)

        cand = {
            "feasible": feasible,
            "throughput": torch.where(bad, 0.0, throughput),
            "power_w": power,
            "step_time_s": torch.where(bad, torch.inf, step_s),
            "pipeline_eff": eff,
            "energy_j": torch.where(bad, 0.0, energy),
            "compute_s": compute_s,
            "tp_s": tp_s,
            "pp_s": pp_s,
            "dram_s": dram_s,
            "dp_s": dp_s,
            "mb_count": mb_count,
        }
        if ep_s is not None:
            cand["ep_s"] = ep_s
        return cand

    # -- host-side entry points --------------------------------------------

    def _upload(self, arrs: Dict[str, np.ndarray], nw: np.ndarray):
        return ({k: _to_dev(v, self.device) for k, v in arrs.items()},
                _to_dev(np.asarray(nw, np.int64), self.device))

    def run_batch(self, arrs: Dict[str, np.ndarray], nw: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        """Evaluate N designs; returns the winner arrays on the host."""
        with torch.no_grad():
            packed = self._body(*self._upload(arrs, nw))
        _count(len(nw))
        return _unpack(packed.cpu().numpy())

    def dispatch_fused(self, arrs: Dict[str, np.ndarray], nw: np.ndarray,
                       js_dev: torch.Tensor) -> "_PendingEval":
        """Gather and evaluate the candidate-pool rows that the device
        index tensor `js_dev` names, without reading the indices back.
        Returns a pending handle; `finish` is the one device-to-host
        copy."""
        ja, jn = self._upload(arrs, nw)
        with torch.no_grad():
            packed = self._body({k: v.index_select(0, js_dev)
                                 for k, v in ja.items()},
                                jn.index_select(0, js_dev))
        _count(js_dev.shape[0])
        return _PendingEval(self, packed)

    def results_from(self, out: Dict[str, np.ndarray], nw: np.ndarray
                     ) -> List["EvalResult"]:
        """Materialize EvalResult/StepResult rows from the winner arrays:
        the same construction `fidelity._finish` + `step_result_at` do."""
        from repro_torch.core.fidelity import EvalResult
        res: List[EvalResult] = []
        for i in range(len(nw)):
            if not bool(out["any_feasible"][i]):
                res.append(EvalResult(0.0, float("inf"), None, None,
                                      int(nw[i]), False,
                                      "no_feasible_strategy"))
                continue
            g = int(out["sel_g"][i])
            sr = _step_at(out, i)
            res.append(EvalResult(
                sr.throughput, sr.power_w,
                Strategy(int(self._tp_o[g]), int(self._pp_o[g]),
                         int(self._dp_o[g]), int(self._mb_o[g])),
                sr, int(nw[i]), True))
        return res

    # -- pinned-strategy (joint mode) entry points -------------------------

    def _upload_strat(self, strat) -> Tuple[torch.Tensor, ...]:
        return tuple(_to_dev(s, self.device) for s in strat)

    def run_batch_pinned(self, arrs: Dict[str, np.ndarray], nw: np.ndarray,
                         strat) -> Dict[str, np.ndarray]:
        """Evaluate N (design, strategy) pairs; `strat` is the
        (tp, pp, dp, mb, ep, recompute) array tuple (`strategy_arrays`)."""
        with torch.no_grad():
            packed = self._body_pinned(*self._upload(arrs, nw),
                                       self._upload_strat(strat))
        _count(len(nw))
        return _unpack_pinned(packed.cpu().numpy())

    def dispatch_fused_pinned(self, arrs: Dict[str, np.ndarray],
                              nw: np.ndarray, strat, js_dev: torch.Tensor
                              ) -> "_PendingPinnedEval":
        """Gather and evaluate the joint-pool rows, geometry and pinned
        strategy columns alike, that the device index tensor `js_dev`
        names, without reading the indices back (the joint counterpart of
        `dispatch_fused`)."""
        ja, jn = self._upload(arrs, nw)
        st = self._upload_strat(strat)
        with torch.no_grad():
            packed = self._body_pinned(
                {k: v.index_select(0, js_dev) for k, v in ja.items()},
                jn.index_select(0, js_dev),
                tuple(s.index_select(0, js_dev) for s in st))
        _count(js_dev.shape[0])
        return _PendingPinnedEval(self, packed)

    def results_from_pinned(self, out: Dict[str, np.ndarray],
                            nw: np.ndarray, strategies,
                            res_ok: Optional[np.ndarray] = None
                            ) -> List["EvalResult"]:
        """Materialize pinned-mode EvalResults: the construction the NumPy
        `_finish` does in pinned mode ("strategy_resources" when the
        host-computed grid resource-fit mask `res_ok` rejects the point,
        "strategy_infeasible" on a power/finiteness failure)."""
        from repro_torch.core.fidelity import EvalResult
        res: List[EvalResult] = []
        for i, s in enumerate(strategies):
            fit = res_ok is None or bool(res_ok[i])
            if not (fit and bool(out["feasible"][i])):
                res.append(EvalResult(0.0, float("inf"), s, None,
                                      int(nw[i]), False,
                                      "strategy_resources" if not fit
                                      else "strategy_infeasible"))
                continue
            sr = _step_at(out, i)
            res.append(EvalResult(sr.throughput, sr.power_w, s, sr,
                                  int(nw[i]), True))
        return res


def _step_at(out: Dict[str, np.ndarray], i: int) -> StepResult:
    """Row i of a program's host arrays as the feasible StepResult that
    `chunk_eval.step_result_at` builds: per-microbatch stage seconds scaled
    to the step, and an "ep" entry only where the all-to-all term (pinned
    mode's `ep_s`) is nonzero."""
    eff = float(out["pipeline_eff"][i])
    mbc = float(out["mb_count"][i])
    bd = {"compute": float(out["compute_s"][i]) * mbc / eff,
          "tp": float(out["tp_s"][i]) * mbc / eff,
          "pp": float(out["pp_s"][i]) * mbc / eff,
          "dram": float(out["dram_s"][i]) * mbc / eff,
          "dp": float(out["dp_s"][i])}
    if "ep_s" in out and float(out["ep_s"][i]):
        bd["ep"] = float(out["ep_s"][i]) * mbc / eff
    return StepResult(
        step_time_s=float(out["step_time_s"][i]),
        throughput=float(out["throughput"][i]),
        power_w=float(out["power_w"][i]),
        pipeline_eff=eff, breakdown=bd,
        energy_j=float(out["energy_j"][i]),
        feasible=True, reason="")


def _unpack(packed: np.ndarray) -> Dict[str, np.ndarray]:
    out = dict(zip(_OUT_FIELDS, packed))
    out["any_feasible"] = out["any_feasible"].astype(bool)
    out["sel_g"] = out["sel_g"].astype(np.int64)
    return out


def _unpack_pinned(packed: np.ndarray) -> Dict[str, np.ndarray]:
    out = dict(zip(_PIN_FIELDS, packed))
    out["feasible"] = out["feasible"].astype(bool)
    return out


@dataclasses.dataclass
class _PendingEval:
    """In-flight fused evaluation: the work is queued on the device;
    `finish` reads it back (one copy) and builds EvalResults for the first
    q picks (position-aligned with the pick indices)."""
    prog: _EvalProgram
    packed: torch.Tensor

    def finish(self, nw_picks: np.ndarray, q: int) -> List["EvalResult"]:
        host = {k: v[:q] for k, v in _unpack(self.packed.cpu().numpy()).items()}
        return self.prog.results_from(host, nw_picks[:q])


@dataclasses.dataclass
class _PendingPinnedEval:
    """In-flight fused pinned-strategy evaluation (joint mode)."""
    prog: _EvalProgram
    packed: torch.Tensor

    def finish(self, nw_picks: np.ndarray, strategies, q: int,
               res_ok: Optional[np.ndarray] = None) -> List["EvalResult"]:
        host = {k: v[:q] for k, v in
                _unpack_pinned(self.packed.cpu().numpy()).items()}
        return self.prog.results_from_pinned(
            host, nw_picks[:q], strategies[:q],
            res_ok if res_ok is None else res_ok[:q])


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def geom_arrays(geom: DesignBatch) -> Dict[str, np.ndarray]:
    return {k: getattr(geom, k) for k in _GEOM_FIELDS}


def evaluate_batch_compiled(geom: DesignBatch, wl: LLMWorkload,
                            n_wafers: np.ndarray, max_strategies: int = 24,
                            device="cuda") -> List["EvalResult"]:
    """Analytical `evaluate_batch` on `device`: hex-equal on the CPU to the
    NumPy reference (`AnalyticalBackend.evaluate_batch_ref`)."""
    prog = _program_for(wl, max_strategies, device)
    nw = np.asarray(n_wafers, np.int64)
    return prog.results_from(prog.run_batch(geom_arrays(geom), nw), nw)


def strategy_arrays(strategies) -> Tuple[np.ndarray, ...]:
    """Columnize a list of Strategy into the (tp, pp, dp, mb, ep, recompute)
    array tuple the pinned program consumes."""
    return (np.array([s.tp for s in strategies], np.int64),
            np.array([s.pp for s in strategies], np.int64),
            np.array([s.dp for s in strategies], np.int64),
            np.array([s.microbatches for s in strategies], np.int64),
            np.array([s.ep for s in strategies], np.int64),
            np.array([s.recompute for s in strategies], np.bool_))


def evaluate_pinned_compiled(geom: DesignBatch, wl: LLMWorkload,
                             n_wafers: np.ndarray, strategies,
                             max_strategies: int = 24,
                             device="cuda") -> List["EvalResult"]:
    """Joint-mode `evaluate_batch` on `device`: each design under its
    pinned Strategy (no grid argmin), hex-equal on the CPU to the NumPy
    pinned path of `AnalyticalBackend.evaluate_batch_ref`, with the same
    host-side grid resource-fit gate (`compiler.pinned_resource_ok`)."""
    from repro_torch.core.compiler import pinned_resource_ok

    prog = _program_for(wl, max_strategies, device)
    nw = np.asarray(n_wafers, np.int64)
    cols = strategy_arrays(strategies)
    out = prog.run_batch_pinned(geom_arrays(geom), nw, cols)
    res_ok = pinned_resource_ok(wl, geom, nw, *cols[:4])
    return prog.results_from_pinned(out, nw, strategies, res_ok)


def dispatch_fused_eval_pinned(pool_geom: DesignBatch, wl: LLMWorkload,
                               nw_pool: np.ndarray, strategies,
                               js_dev: torch.Tensor,
                               max_strategies: int = 24
                               ) -> _PendingPinnedEval:
    """Joint-mode fused propose -> evaluate: gather the pool rows that the
    device indices `js_dev` name, with their pinned strategy columns, and
    evaluate them on that device without a host round-trip."""
    prog = _program_for(wl, max_strategies, js_dev.device)
    return prog.dispatch_fused_pinned(geom_arrays(pool_geom),
                                      np.asarray(nw_pool, np.int64),
                                      strategy_arrays(strategies), js_dev)


def dispatch_fused_eval(pool_geom: DesignBatch, wl: LLMWorkload,
                        nw_pool: np.ndarray, js_dev: torch.Tensor,
                        max_strategies: int = 24) -> _PendingEval:
    """Fused propose -> evaluate: evaluate the pool rows that the device
    indices `js_dev` (the acquire's output) select, on their device,
    without a host round-trip between acquisition and evaluation."""
    prog = _program_for(wl, max_strategies, js_dev.device)
    return prog.dispatch_fused(geom_arrays(pool_geom),
                               np.asarray(nw_pool, np.int64), js_dev)


_WARMED: set = set()


def warm_evaluator_kernels(wl: LLMWorkload, max_strategies: int = 24,
                           force: bool = False, device="cuda") -> int:
    """Run the program once on a few designs, so the first launch of each
    of its kernels stays out of a timed region. Memoized per (workload,
    cap, device); `force=True` runs it again. Returns the warm-ups run."""
    from repro_torch.core.design_space import decode_batch

    prog = _program_for(wl, max_strategies, device)
    key = (wl, prog.K, str(prog.device))
    if key in _WARMED and not force:
        return 0
    _WARMED.add(key)
    geom = DesignBatch.from_designs(decode_batch(np.full((4, 13), 0.5)))
    nw = np.ones(4, np.int64)
    prog.run_batch(geom_arrays(geom), nw)
    js = torch.arange(2, device=prog.device)
    prog.dispatch_fused(geom_arrays(geom), nw, js).finish(nw, 2)
    return 1


__all__ = [
    "dispatch_fused_eval", "dispatch_fused_eval_pinned",
    "evaluate_batch_compiled", "evaluate_pinned_compiled", "geom_arrays",
    "lane_stats", "strategy_arrays", "warm_evaluator_kernels",
]
