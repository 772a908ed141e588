"""Design Point Validator (paper §V-E): area, power, yield, SRAM-compiler
feasibility, and TSV stress constraints. Resolves the redundancy (spares per
row) needed for the 0.9 yield target as a side effect.

`validate` is the scalar reference; `validate_batch` applies the same
constraint chain to N designs with vectorized geometry (DesignBatch) and one
batched yield resolution — the candidate-generation hot path in the
exploration loop.

The port's own copy of `repro.core.validator`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import components as C
from repro_torch.core.design_space import DesignBatch, WSCDesign
from repro_torch.core.yield_model import (YIELD_TARGET, min_spares_for_target,
                                          min_spares_for_target_batch)


@dataclasses.dataclass
class ValidationResult:
    ok: bool
    reason: str = ""
    design: Optional[WSCDesign] = None       # with spares_per_row resolved
    wafer_yield: float = 0.0


def sram_feasible(buffer_kb: int, buffer_bw: int) -> bool:
    """SRAM-compiler feasibility: tiny macros can't supply very wide ports,
    huge macros can't be both dense and wide (paper: 'some combinations of
    SRAM configurations are infeasible')."""
    if buffer_bw > 64 * buffer_kb:          # > 64 bits/cycle per KB: too wide
        return False
    if buffer_kb >= 1024 and buffer_bw > 2048:
        return False
    return True


def validate(d: WSCDesign, peak_power_w: float = C.WAFER_POWER_W
             ) -> ValidationResult:
    # --- SRAM constraint ----------------------------------------------------
    if not sram_feasible(d.buffer_kb, d.buffer_bw):
        return ValidationResult(False, "sram_infeasible")

    # --- stress constraint (TSV area ratio) ----------------------------------
    if d.use_stacked_dram:
        ratio = d.tsv_area_mm2() / max(d.reticle_area_mm2(), 1e-9)
        if ratio > C.TSV_AREA_RATIO_MAX:
            return ValidationResult(False, "tsv_stress")

    # --- reticle area constraint ---------------------------------------------
    r_area = d.reticle_area_mm2()
    if r_area > C.RETICLE_AREA_MM2:
        return ValidationResult(False, "reticle_area")

    # --- wafer area constraint ----------------------------------------------
    if d.wafer_area_mm2() > C.WAFER_AREA_MM2:
        return ValidationResult(False, "wafer_area")

    # --- yield constraint (resolve redundancy) -------------------------------
    ch, cw = d.core_dims_mm()
    spares, wy = min_spares_for_target(
        ch, cw, d.core_array,
        (d.core_array[0] * ch, d.core_array[1] * cw),
        d.tsv_area_mm2(), d.n_reticles(), d.integration,
        target=YIELD_TARGET)
    if spares < 0:
        return ValidationResult(False, "yield")
    resolved = dataclasses.replace(d, spares_per_row=spares)
    # re-check reticle area with the spare columns added
    if resolved.reticle_area_mm2() > C.RETICLE_AREA_MM2:
        return ValidationResult(False, "reticle_area_with_spares")
    if resolved.wafer_area_mm2() > C.WAFER_AREA_MM2:
        return ValidationResult(False, "wafer_area_with_spares")

    # --- static power sanity (dynamic power checked post-evaluation) --------
    if resolved.static_power_w() > peak_power_w:
        return ValidationResult(False, "static_power")

    return ValidationResult(True, "", resolved, wy)


def validate_batch(designs: Sequence[WSCDesign],
                   peak_power_w: float = C.WAFER_POWER_W
                   ) -> List[ValidationResult]:
    """Vectorized `validate`: result i matches validate(designs[i]) — same
    constraint order, same first-failing reason, same resolved spares (the
    scalar spares resolver delegates to the batched one, so the two paths
    agree bitwise)."""
    designs = list(designs)
    if not designs:
        return []
    N = len(designs)
    db = DesignBatch.from_designs(designs)
    reason = np.full(N, "", object)

    def fail(mask: np.ndarray, why: str) -> None:
        hit = mask & (reason == "")
        reason[hit] = why

    fail((db.buffer_bw > 64 * db.buffer_kb)
         | ((db.buffer_kb >= 1024) & (db.buffer_bw > 2048)), "sram_infeasible")
    tsv_area = np.where(db.dram_on,
                        C.tsv_area_mm2(db.dram_bw_Bps_per_reticle), 0.0)
    fail(db.dram_on & (tsv_area / np.maximum(db.reticle_area_mm2, 1e-9)
                       > C.TSV_AREA_RATIO_MAX), "tsv_stress")
    fail(db.reticle_area_mm2 > C.RETICLE_AREA_MM2, "reticle_area")
    fail(db.wafer_area_mm2 > C.WAFER_AREA_MM2, "wafer_area")

    # --- yield resolution for the survivors ---------------------------------
    spares = np.zeros(N, np.int64)
    wy = np.zeros(N)
    live = reason == ""
    if live.any():
        idx = np.flatnonzero(live)
        side = np.sqrt(db.core_area_mm2[idx])       # core_dims_mm: square
        s_res, w_res = min_spares_for_target_batch(
            side, side, db.core_h[idx], db.core_w[idx],
            db.core_h[idx] * side, db.core_w[idx] * side,
            tsv_area[idx], db.n_reticles[idx], db.integ_code[idx] == 1,
            target=YIELD_TARGET)
        spares[idx] = s_res
        wy[idx] = w_res
        fail(live & (spares < 0), "yield")

        # --- re-check areas / static power with the spare columns added -----
        phy = (4.0 * db.inter_reticle_bw_Bps) * 8e-9 * np.where(
            db.integ_code == 1, C.IR_AREA_UM2_PER_GBPS["infosow"],
            C.IR_AREA_UM2_PER_GBPS["die_stitching"]) * 1e-6
        base2 = (db.core_w + np.maximum(spares, 0)) * db.core_h \
            * db.core_area_mm2 + phy
        r_area2 = np.where(
            db.dram_on,
            base2 / np.maximum(1.0 - C.tsv_area_ratio(db.dram_bw_tbps), 1e-3),
            base2)
        fail((reason == "") & (r_area2 > C.RETICLE_AREA_MM2),
             "reticle_area_with_spares")
        fail((reason == "") & (db.n_reticles * r_area2 > C.WAFER_AREA_MM2),
             "wafer_area_with_spares")

        dram_gb2 = np.where(db.dram_on,
                            C.dram_gb_at_bw(db.dram_bw_tbps) * r_area2 / 100.0,
                            0.0)
        static2 = C.core_static_w(db.mac, db.buffer_kb) * db.total_cores \
            + C.DRAM_STATIC_W_PER_GB * dram_gb2 * db.n_reticles
        fail((reason == "") & (static2 > peak_power_w), "static_power")

    out: List[ValidationResult] = []
    for i, d in enumerate(designs):
        if reason[i]:
            out.append(ValidationResult(False, str(reason[i])))
        else:
            out.append(ValidationResult(
                True, "", dataclasses.replace(d, spares_per_row=int(spares[i])),
                float(wy[i])))
    return out


# ---------------------------------------------------------------------------
# joint (design, strategy) validation — strategy–architecture co-exploration
# ---------------------------------------------------------------------------


def validate_joint_batch(points, wl, peak_power_w: float = C.WAFER_POWER_W,
                         use_oracle: bool = True,
                         n_wafers=None) -> List[ValidationResult]:
    """Vectorized validation of N `JointDesign` points: the architecture
    half goes through `validate_batch` unchanged (same constraint order and
    reasons), then surviving points get their pinned Strategy checked —
    static legality and resource fit first (vectorized), then the
    shardability oracle (`param_specs`/`batch_specs` instantiable on a
    (dp, tp) mesh). The oracle is not ported yet: with `use_oracle` (the
    default) a point that passes the vectorized checks raises
    NotImplementedError until ROADMAP item 13 brings it. Strategy failure
    reasons, in precedence order:

        "strategy_pp"           pp exceeds the workload's layer count
        "strategy_tokens"       dp x microbatches over-splits the step
        "strategy_batch_div"    dp x microbatches does not divide the
                                global batch (grid-mode enumeration's
                                divisibility constraint)
        "strategy_cores"        tp x pp x dp exceeds the system's cores
                                (area-matched wafer count, or `n_wafers`)
        "strategy_memory"       the recompute/schedule/ep-aware v2 memory
                                footprint (`compiler.strategy_memory_need`)
                                exceeds the system's SRAM+DRAM capacity —
                                this is where recompute (saves activation
                                memory at 4x backward cost) and the GPipe
                                schedule (keeps all microbatches in
                                flight) become live search trade-offs
        "strategy_ep"/"strategy_unshardable"/...  oracle verdicts,
            prefixed "strategy_" (ep_experts, dp_batch, tp_dead)

    `n_wafers` overrides the per-design system size; by default each
    design gets the same area-matched wafer count evaluation will use
    (`evaluator.wafers_for_budget` on the spares-resolved design)."""
    points = list(points)
    if not points:
        return []
    import numpy as _np

    from repro_torch.core.compiler import strategy_memory_need

    arch = validate_batch([p.design for p in points],
                          peak_power_w=peak_power_w)

    tp = _np.array([p.strategy.tp for p in points], _np.int64)
    pp = _np.array([p.strategy.pp for p in points], _np.int64)
    dp = _np.array([p.strategy.dp for p in points], _np.int64)
    mb = _np.array([p.strategy.microbatches for p in points], _np.int64)
    ep = _np.array([p.strategy.ep for p in points], _np.int64)
    rc = _np.array([p.strategy.recompute for p in points], bool)
    gp = _np.array([p.strategy.schedule == "gpipe" for p in points], bool)
    mb_count = mb if wl.phase == "train" else _np.ones_like(mb)

    # system size and capacity: the spares-resolved design where arch
    # validation succeeded (matching what evaluation will score), the raw
    # design otherwise (value unused — the arch reason wins below)
    resolved = [ar.design if ar.ok else p.design
                for p, ar in zip(points, arch)]
    if n_wafers is None:
        from repro_torch.core.evaluator import wafers_for_budget
        nw = _np.array([wafers_for_budget(d, wl) for d in resolved],
                       _np.int64)
    else:
        nw = _np.broadcast_to(_np.asarray(n_wafers, _np.int64),
                              (len(points),))
    total_cores = _np.array([d.total_cores() for d in resolved],
                            _np.int64) * nw
    mem_budget = _np.array(
        [d.buffer_kb * 1024.0 * d.total_cores()
         + d.dram_gb_per_reticle() * 1e9 * d.n_reticles()
         for d in resolved]) * nw
    need = strategy_memory_need(wl, tp, pp, dp, mb, ep=ep, recompute=rc,
                                gpipe=gp)

    reason = _np.full(len(points), "", object)
    reason[(reason == "") & (pp > wl.n_layers)] = "strategy_pp"
    reason[(reason == "") & (dp * mb_count > wl.tokens_per_step())] = \
        "strategy_tokens"
    reason[(reason == "") & (wl.batch % (dp * mb_count) != 0)] = \
        "strategy_batch_div"
    reason[(reason == "")
           & ((pp * dp * tp > total_cores) | (tp > total_cores))] = \
        "strategy_cores"
    reason[(reason == "") & (need > mem_budget)] = "strategy_memory"

    out: List[ValidationResult] = []
    for i, (p, ar) in enumerate(zip(points, arch)):
        if not ar.ok:
            out.append(ar)
            continue
        why = str(reason[i])
        if not why and use_oracle:
            raise NotImplementedError(
                "the shardability oracle (repro's dist/oracle.py) is not "
                "ported yet: joint-mode validation waits for ROADMAP item 13")
        if why:
            out.append(ValidationResult(False, why))
        else:
            out.append(ar)
    return out
