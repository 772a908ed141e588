"""WSC design-space construction (paper §V, Table I).

Candidate values (Table I):
    dataflow          WS | IS | OS
    mac_num           8 .. 4096            (per core)
    buffer_size       32 .. 2048 KB
    buffer_bw         32 .. 4096 bit/cycle
    noc_bw            32 .. 4096 bit/cycle
    inter_reticle_bw  0.2 .. 2.0 x reticle bisection bw
    stacking_DRAM_bw  0.25 .. 4 TB/s/100mm^2 (optional)
    stacking_DRAM sz  8 .. 40 GB (linear trade with bw)
    integration       die_stitching | InFO-SoW
    inter_wafer_bw    100 GB/s per network interface
    off_chip_mem_bw   160 GB/s per memory controller
    core/reticle arrays: 1 .. max under area constraints
Heterogeneous params (§V-B): prefill_ratio, hetero granularity.

The port's own copy of `repro.core.design_space`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import components as C

DATAFLOWS = ("WS", "IS", "OS")
INTEGRATIONS = ("die_stitching", "infosow")

MAC_RANGE = (8, 4096)
BUF_KB_RANGE = (32, 2048)
BUF_BW_RANGE = (32, 4096)
NOC_BW_RANGE = (32, 4096)
IR_RATIO_RANGE = (0.2, 2.0)
DRAM_BW_RANGE = C.DRAM_BW_RANGE


@dataclasses.dataclass(frozen=True)
class WSCDesign:
    # core level
    dataflow: str = "WS"
    mac_num: int = 512
    buffer_kb: int = 256
    buffer_bw: int = 1024          # bits/cycle
    noc_bw: int = 512              # bits/cycle
    # reticle level
    core_array: Tuple[int, int] = (8, 8)
    inter_reticle_bw_ratio: float = 1.0
    use_stacked_dram: bool = True
    dram_bw_tbps_per_100mm2: float = 1.0
    # wafer level
    reticle_array: Tuple[int, int] = (8, 8)
    integration: str = "infosow"
    # heterogeneity (inference only; §V-B)
    prefill_ratio: float = 0.5
    hetero: str = "none"           # none | core | reticle | wafer
    # resolved by the validator (spares needed for the yield target)
    spares_per_row: int = 1

    # ---------------- derived geometry ------------------------------------

    def core_area_mm2(self) -> float:
        return C.core_area_mm2(self.mac_num, self.buffer_kb, self.buffer_bw,
                               self.noc_bw)

    def core_dims_mm(self) -> Tuple[float, float]:
        a = self.core_area_mm2()
        s = math.sqrt(a)
        return (s, s)

    def cores_per_reticle(self) -> int:
        return self.core_array[0] * self.core_array[1]

    def reticle_bisection_Bps(self) -> float:
        """Bisection bandwidth of the core-array NoC (bits/cycle -> B/s)."""
        w = min(self.core_array)
        return w * self.noc_bw / 8.0 * C.CLOCK_HZ

    def inter_reticle_bw_Bps(self) -> float:
        return self.inter_reticle_bw_ratio * self.reticle_bisection_Bps()

    def reticle_compute_area_mm2(self) -> float:
        h, w = self.core_array
        spare_cols = self.spares_per_row
        return (w + spare_cols) * h * self.core_area_mm2()

    def dram_bw_Bps_per_reticle(self) -> float:
        if not self.use_stacked_dram:
            return 0.0
        return (self.dram_bw_tbps_per_100mm2 * 1e12
                * self.reticle_area_mm2() / 100.0)

    def dram_gb_per_reticle(self) -> float:
        if not self.use_stacked_dram:
            return 0.0
        return (C.dram_gb_at_bw(self.dram_bw_tbps_per_100mm2)
                * self.reticle_area_mm2() / 100.0)

    def tsv_area_mm2(self) -> float:
        if not self.use_stacked_dram:
            return 0.0
        return C.tsv_area_mm2(self.dram_bw_Bps_per_reticle())

    def reticle_area_mm2(self) -> float:
        """Compute + inter-reticle PHY + TSV keep-out."""
        phy = C.inter_reticle_area_mm2(
            4 * self.inter_reticle_bw_Bps(), self.integration)
        # TSV area depends on reticle area (bw per mm^2): solve fixed point
        base = self.reticle_compute_area_mm2() + phy
        if not self.use_stacked_dram:
            return base
        ratio = C.tsv_area_ratio(self.dram_bw_tbps_per_100mm2)
        return base / max(1.0 - ratio, 1e-3)

    def n_reticles(self) -> int:
        return self.reticle_array[0] * self.reticle_array[1]

    def wafer_area_mm2(self) -> float:
        return self.n_reticles() * self.reticle_area_mm2()

    def total_cores(self) -> int:
        return self.cores_per_reticle() * self.n_reticles()

    def core_flops(self) -> float:
        return C.core_peak_flops(self.mac_num)

    def reticle_flops(self) -> float:
        return self.core_flops() * self.cores_per_reticle()

    def wafer_flops(self) -> float:
        return self.reticle_flops() * self.n_reticles()

    def sram_per_reticle_bytes(self) -> float:
        return self.cores_per_reticle() * self.buffer_kb * 1024.0

    def static_power_w(self) -> float:
        per_core = C.core_static_w(self.mac_num, self.buffer_kb)
        dram = (C.DRAM_STATIC_W_PER_GB * self.dram_gb_per_reticle()
                * self.n_reticles())
        return per_core * self.total_cores() + dram

    def describe(self) -> str:
        return (f"{self.dataflow} mac={self.mac_num} buf={self.buffer_kb}KB "
                f"bw={self.buffer_bw}/{self.noc_bw}b "
                f"cores={self.core_array} ret={self.reticle_array} "
                f"ir={self.inter_reticle_bw_ratio:.2f}x "
                f"dram={'%.2fTB/s' % self.dram_bw_tbps_per_100mm2 if self.use_stacked_dram else 'off'} "
                f"{self.integration}")


# ---------------------------------------------------------------------------
# sampling / encoding for the explorer
# ---------------------------------------------------------------------------

# normalized [0,1]^d encoding: log-scaled for the exponential-range knobs
DIMS = ("dataflow", "mac", "buf_kb", "buf_bw", "noc_bw", "core_h", "core_w",
        "ir_ratio", "dram_on", "dram_bw", "ret_h", "ret_w", "integration")


def _log_scale(u: float, lo: float, hi: float) -> float:
    return lo * (hi / lo) ** u


def _log_unscale(v: float, lo: float, hi: float) -> float:
    return math.log(v / lo) / math.log(hi / lo)


def _pow2(v: float, lo: int, hi: int) -> int:
    p = int(round(math.log2(max(v, lo))))
    return int(min(max(2 ** p, lo), hi))


def decode(u: np.ndarray, max_core_dim: int = 32, max_ret_dim: int = 12
           ) -> WSCDesign:
    """[0,1]^13 -> WSCDesign (nearest feasible grid values)."""
    u = np.clip(np.asarray(u, dtype=np.float64), 0.0, 1.0)
    return WSCDesign(
        dataflow=DATAFLOWS[min(int(u[0] * 3), 2)],
        mac_num=_pow2(_log_scale(u[1], *MAC_RANGE), *MAC_RANGE),
        buffer_kb=_pow2(_log_scale(u[2], *BUF_KB_RANGE), *BUF_KB_RANGE),
        buffer_bw=_pow2(_log_scale(u[3], *BUF_BW_RANGE), *BUF_BW_RANGE),
        noc_bw=_pow2(_log_scale(u[4], *NOC_BW_RANGE), *NOC_BW_RANGE),
        core_array=(1 + int(u[5] * (max_core_dim - 1) + 0.5),
                    1 + int(u[6] * (max_core_dim - 1) + 0.5)),
        inter_reticle_bw_ratio=round(
            IR_RATIO_RANGE[0] + u[7] * (IR_RATIO_RANGE[1] - IR_RATIO_RANGE[0]), 2),
        use_stacked_dram=bool(u[8] >= 0.5),
        dram_bw_tbps_per_100mm2=round(
            _log_scale(u[9], *DRAM_BW_RANGE), 3),
        reticle_array=(1 + int(u[10] * (max_ret_dim - 1) + 0.5),
                       1 + int(u[11] * (max_ret_dim - 1) + 0.5)),
        integration=INTEGRATIONS[min(int(u[12] * 2), 1)],
    )


def encode(d: WSCDesign, max_core_dim: int = 32, max_ret_dim: int = 12
           ) -> np.ndarray:
    return np.array([
        DATAFLOWS.index(d.dataflow) / 2.0,
        _log_unscale(d.mac_num, *MAC_RANGE),
        _log_unscale(d.buffer_kb, *BUF_KB_RANGE),
        _log_unscale(d.buffer_bw, *BUF_BW_RANGE),
        _log_unscale(d.noc_bw, *NOC_BW_RANGE),
        (d.core_array[0] - 1) / (max_core_dim - 1),
        (d.core_array[1] - 1) / (max_core_dim - 1),
        (d.inter_reticle_bw_ratio - IR_RATIO_RANGE[0])
        / (IR_RATIO_RANGE[1] - IR_RATIO_RANGE[0]),
        1.0 if d.use_stacked_dram else 0.0,
        _log_unscale(d.dram_bw_tbps_per_100mm2, *DRAM_BW_RANGE),
        (d.reticle_array[0] - 1) / (max_ret_dim - 1),
        (d.reticle_array[1] - 1) / (max_ret_dim - 1),
        0.0 if d.integration == INTEGRATIONS[0] else 1.0,
    ])


def sample(rng: np.random.Generator, n: int) -> np.ndarray:
    """n raw points in [0,1]^13 (validator filters infeasible decodes)."""
    return rng.random((n, len(DIMS)))


def space_size_estimate() -> float:
    """Cardinality of the discrete grid (paper quotes ~8.4e14 feasible)."""
    return (3                      # dataflow
            * 10 * 7 * 8 * 8       # mac, buf, buf_bw, noc_bw (pow2 steps)
            * 32 * 32              # core array
            * 19                   # ir ratio grid 0.2..2.0 step .1
            * (1 + 13)             # dram off / bw grid
            * 12 * 12              # reticle array
            * 2)                   # integration


# ---------------------------------------------------------------------------
# batched (struct-of-arrays) backend — see DESIGN.md §4
# ---------------------------------------------------------------------------


def floor_log2(n: np.ndarray) -> np.ndarray:
    """Exact floor(log2(n)) for positive int arrays (float-log corrected)."""
    n = np.maximum(np.asarray(n, dtype=np.int64), 1)
    e = np.floor(np.log2(n.astype(np.float64))).astype(np.int64)
    # one ulp of float error can push e off by one either way
    e = np.where((np.int64(1) << np.minimum(e + 1, 62)) <= n, e + 1, e)
    e = np.where((np.int64(1) << np.minimum(e, 62)) > n, e - 1, e)
    return e


def decode_batch(U: np.ndarray, max_core_dim: int = 32, max_ret_dim: int = 12
                 ) -> List[WSCDesign]:
    """Vectorized decode of (N, 13) raw points; element i == decode(U[i])."""
    U = np.clip(np.atleast_2d(np.asarray(U, dtype=np.float64)), 0.0, 1.0)

    def pow2_col(u, lo, hi):
        v = np.maximum(lo * (hi / lo) ** u, lo)
        p = np.round(np.log2(v)).astype(np.int64)
        return np.clip(np.int64(1) << p, lo, hi)

    df = np.minimum((U[:, 0] * 3).astype(np.int64), 2)
    mac = pow2_col(U[:, 1], *MAC_RANGE)
    buf = pow2_col(U[:, 2], *BUF_KB_RANGE)
    bbw = pow2_col(U[:, 3], *BUF_BW_RANGE)
    nbw = pow2_col(U[:, 4], *NOC_BW_RANGE)
    ch = 1 + (U[:, 5] * (max_core_dim - 1) + 0.5).astype(np.int64)
    cw = 1 + (U[:, 6] * (max_core_dim - 1) + 0.5).astype(np.int64)
    ir = np.round(IR_RATIO_RANGE[0]
                  + U[:, 7] * (IR_RATIO_RANGE[1] - IR_RATIO_RANGE[0]), 2)
    don = U[:, 8] >= 0.5
    dbw = np.round(DRAM_BW_RANGE[0]
                   * (DRAM_BW_RANGE[1] / DRAM_BW_RANGE[0]) ** U[:, 9], 3)
    rh = 1 + (U[:, 10] * (max_ret_dim - 1) + 0.5).astype(np.int64)
    rw = 1 + (U[:, 11] * (max_ret_dim - 1) + 0.5).astype(np.int64)
    ig = np.minimum((U[:, 12] * 2).astype(np.int64), 1)
    return [WSCDesign(dataflow=DATAFLOWS[df[i]], mac_num=int(mac[i]),
                      buffer_kb=int(buf[i]), buffer_bw=int(bbw[i]),
                      noc_bw=int(nbw[i]), core_array=(int(ch[i]), int(cw[i])),
                      inter_reticle_bw_ratio=float(ir[i]),
                      use_stacked_dram=bool(don[i]),
                      dram_bw_tbps_per_100mm2=float(dbw[i]),
                      reticle_array=(int(rh[i]), int(rw[i])),
                      integration=INTEGRATIONS[ig[i]])
            for i in range(len(U))]


def encode_batch(designs: Sequence[WSCDesign], max_core_dim: int = 32,
                 max_ret_dim: int = 12) -> np.ndarray:
    """Vectorized encode: row i == encode(designs[i]). Returns (N, 13)."""
    def log_u(v, lo, hi):
        return np.log(np.asarray(v, np.float64) / lo) / math.log(hi / lo)

    cols = np.stack([
        np.array([DATAFLOWS.index(d.dataflow) for d in designs], np.float64) / 2.0,
        log_u([d.mac_num for d in designs], *MAC_RANGE),
        log_u([d.buffer_kb for d in designs], *BUF_KB_RANGE),
        log_u([d.buffer_bw for d in designs], *BUF_BW_RANGE),
        log_u([d.noc_bw for d in designs], *NOC_BW_RANGE),
        (np.array([d.core_array[0] for d in designs], np.float64) - 1)
        / (max_core_dim - 1),
        (np.array([d.core_array[1] for d in designs], np.float64) - 1)
        / (max_core_dim - 1),
        (np.array([d.inter_reticle_bw_ratio for d in designs]) - IR_RATIO_RANGE[0])
        / (IR_RATIO_RANGE[1] - IR_RATIO_RANGE[0]),
        np.array([1.0 if d.use_stacked_dram else 0.0 for d in designs]),
        log_u([d.dram_bw_tbps_per_100mm2 for d in designs], *DRAM_BW_RANGE),
        (np.array([d.reticle_array[0] for d in designs], np.float64) - 1)
        / (max_ret_dim - 1),
        (np.array([d.reticle_array[1] for d in designs], np.float64) - 1)
        / (max_ret_dim - 1),
        np.array([0.0 if d.integration == INTEGRATIONS[0] else 1.0
                  for d in designs]),
    ], axis=1)
    return cols


@dataclasses.dataclass
class DesignBatch:
    """Struct-of-arrays view of N designs: the vector encoding plus every
    derived geometry quantity the evaluation stack needs, all computed with
    vectorized NumPy so downstream kernels broadcast over a leading batch
    axis instead of calling per-design methods (DESIGN.md §4)."""
    designs: List[WSCDesign]
    # raw knobs
    dataflow_code: np.ndarray      # (N,) 0=WS 1=IS 2=OS
    mac: np.ndarray                # (N,) int64
    buffer_kb: np.ndarray
    buffer_bw: np.ndarray
    noc_bw: np.ndarray
    core_h: np.ndarray
    core_w: np.ndarray
    ir_ratio: np.ndarray
    dram_on: np.ndarray            # (N,) bool
    dram_bw_tbps: np.ndarray
    ret_h: np.ndarray
    ret_w: np.ndarray
    integ_code: np.ndarray         # 0=die_stitching 1=infosow
    spares_per_row: np.ndarray
    # derived geometry (all float64 unless noted)
    core_area_mm2: np.ndarray
    cores_per_reticle: np.ndarray  # int64
    n_reticles: np.ndarray         # int64
    total_cores: np.ndarray        # int64
    reticle_bisection_Bps: np.ndarray
    inter_reticle_bw_Bps: np.ndarray
    reticle_area_mm2: np.ndarray
    wafer_area_mm2: np.ndarray
    dram_bw_Bps_per_reticle: np.ndarray
    dram_gb_per_reticle: np.ndarray
    static_power_w: np.ndarray
    ir_energy_pj_per_bit: np.ndarray

    def __len__(self) -> int:
        return len(self.designs)

    @staticmethod
    def from_designs(designs: Sequence[WSCDesign]) -> "DesignBatch":
        designs = list(designs)
        df = np.array([DATAFLOWS.index(d.dataflow) for d in designs], np.int64)
        mac = np.array([d.mac_num for d in designs], np.int64)
        buf_kb = np.array([d.buffer_kb for d in designs], np.int64)
        buf_bw = np.array([d.buffer_bw for d in designs], np.int64)
        noc_bw = np.array([d.noc_bw for d in designs], np.int64)
        ch = np.array([d.core_array[0] for d in designs], np.int64)
        cw = np.array([d.core_array[1] for d in designs], np.int64)
        ir = np.array([d.inter_reticle_bw_ratio for d in designs], np.float64)
        don = np.array([d.use_stacked_dram for d in designs], bool)
        dbw = np.array([d.dram_bw_tbps_per_100mm2 for d in designs], np.float64)
        rh = np.array([d.reticle_array[0] for d in designs], np.int64)
        rw = np.array([d.reticle_array[1] for d in designs], np.int64)
        ig = np.array([INTEGRATIONS.index(d.integration) for d in designs],
                      np.int64)
        spares = np.array([d.spares_per_row for d in designs], np.int64)

        # components helpers are dtype-polymorphic: same formulas/constants
        # as the scalar WSCDesign methods, applied to the whole batch
        core_area = C.core_area_mm2(mac, buf_kb, buf_bw, noc_bw)

        cpr = ch * cw
        nret = rh * rw
        total = cpr * nret
        bisect = np.minimum(ch, cw) * noc_bw / 8.0 * C.CLOCK_HZ
        ir_bw = ir * bisect

        # --- reticle area fixed point (WSCDesign.reticle_area_mm2) ---------
        phy = (4.0 * ir_bw) * 8e-9 * np.where(
            ig == 1, C.IR_AREA_UM2_PER_GBPS["infosow"],
            C.IR_AREA_UM2_PER_GBPS["die_stitching"]) * 1e-6
        compute_a = (cw + spares) * ch * core_area
        base = compute_a + phy
        tsv_ratio = C.tsv_area_ratio(dbw)
        r_area = np.where(don, base / np.maximum(1.0 - tsv_ratio, 1e-3), base)

        dram_bw_Bps = np.where(don, dbw * 1e12 * r_area / 100.0, 0.0)
        dram_gb = np.where(don, C.dram_gb_at_bw(dbw) * r_area / 100.0, 0.0)

        per_core_w = C.core_static_w(mac, buf_kb)
        static_w = per_core_w * total + C.DRAM_STATIC_W_PER_GB * dram_gb * nret

        ir_pj = np.where(ig == 1, C.IR_ENERGY_PJ_PER_BIT["infosow"],
                         C.IR_ENERGY_PJ_PER_BIT["die_stitching"])

        return DesignBatch(
            designs=designs, dataflow_code=df, mac=mac, buffer_kb=buf_kb,
            buffer_bw=buf_bw, noc_bw=noc_bw, core_h=ch, core_w=cw,
            ir_ratio=ir, dram_on=don, dram_bw_tbps=dbw, ret_h=rh, ret_w=rw,
            integ_code=ig, spares_per_row=spares, core_area_mm2=core_area,
            cores_per_reticle=cpr, n_reticles=nret, total_cores=total,
            reticle_bisection_Bps=bisect, inter_reticle_bw_Bps=ir_bw,
            reticle_area_mm2=r_area, wafer_area_mm2=nret * r_area,
            dram_bw_Bps_per_reticle=dram_bw_Bps, dram_gb_per_reticle=dram_gb,
            static_power_w=static_w, ir_energy_pj_per_bit=ir_pj)

    def take(self, idx: np.ndarray) -> "DesignBatch":
        """Gather rows (with repetition) — used to expand designs to the
        flattened (design, strategy) candidate axis."""
        idx = np.asarray(idx, np.int64)
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "designs":
                kw[f.name] = [self.designs[i] for i in idx]
            else:
                kw[f.name] = v[idx]
        return DesignBatch(**kw)


# ---------------------------------------------------------------------------
# joint (architecture, strategy) search space — ISSUE 9 tentpole.
#
# The parallelization strategy stops being a dense grid scored inside the
# evaluator and becomes extra normalized dimensions appended to the 13-dim
# architecture encoding, so MFMOBO proposes joint points directly.
# Power-of-two axes (tp/pp/dp/ep) encode as exponent fractions of a
# workload-derived cap; microbatch count indexes the discrete choice list;
# recompute and the pipeline schedule are threshold bits.
# ---------------------------------------------------------------------------

STRATEGY_DIMS = ("tp", "pp", "dp", "ep", "microbatches", "recompute",
                 "schedule")
MB_CHOICES = (1, 2, 4, 8, 16, 32)


def _exp_of(v: int) -> int:
    return max(int(v), 1).bit_length() - 1


@dataclasses.dataclass(frozen=True)
class StrategySpace:
    """Bounds of the strategy axes for one workload: max exponent of each
    power-of-two split and the microbatch choice list. Frozen/hashable so a
    space can key caches and compare for checkpoint-resume equality."""
    tp_exp: int = 16
    pp_exp: int = 6
    dp_exp: int = 9
    ep_exp: int = 0
    mb_choices: Tuple[int, ...] = MB_CHOICES
    train: bool = True

    @property
    def n_dims(self) -> int:
        return len(STRATEGY_DIMS)

    @classmethod
    def for_workload(cls, wl, total_cores: int) -> "StrategySpace":
        """Derive the axis caps from the workload and the largest system
        under search (`compiler.derived_strategy_caps`)."""
        from repro_torch.core.compiler import derived_strategy_caps
        caps = derived_strategy_caps(wl, total_cores)
        train = wl.phase == "train"
        mbs = tuple(m for m in MB_CHOICES
                    if m <= caps["microbatches"]) or (1,)
        return cls(tp_exp=_exp_of(caps["tp"]), pp_exp=_exp_of(caps["pp"]),
                   dp_exp=_exp_of(caps["dp"]), ep_exp=_exp_of(caps["ep"]),
                   mb_choices=mbs, train=train)

    # -- JSON round-trip (CampaignSpec strategy-space bounds) --------------

    def to_json(self) -> Dict:
        return {"tp_exp": self.tp_exp, "pp_exp": self.pp_exp,
                "dp_exp": self.dp_exp, "ep_exp": self.ep_exp,
                "mb_choices": list(self.mb_choices), "train": self.train}

    @classmethod
    def from_json(cls, obj: Dict) -> "StrategySpace":
        return cls(tp_exp=int(obj["tp_exp"]), pp_exp=int(obj["pp_exp"]),
                   dp_exp=int(obj["dp_exp"]), ep_exp=int(obj["ep_exp"]),
                   mb_choices=tuple(int(m) for m in obj["mb_choices"]),
                   train=bool(obj["train"]))

    # -- codec -------------------------------------------------------------

    def decode_arrays(self, Us: np.ndarray) -> Dict[str, np.ndarray]:
        """(N, 7) strategy columns -> dict of per-axis arrays. Row i equals
        the scalar `decode_strategy(Us[i])`."""
        Us = np.clip(np.atleast_2d(np.asarray(Us, np.float64)), 0.0, 1.0)
        tp = np.int64(1) << np.round(Us[:, 0] * self.tp_exp).astype(np.int64)
        pp = np.int64(1) << np.round(Us[:, 1] * self.pp_exp).astype(np.int64)
        dp = np.int64(1) << np.round(Us[:, 2] * self.dp_exp).astype(np.int64)
        ep = np.int64(1) << np.round(Us[:, 3] * self.ep_exp).astype(np.int64)
        mbi = np.round(Us[:, 4] * (len(self.mb_choices) - 1)).astype(np.int64)
        mb = np.asarray(self.mb_choices, np.int64)[mbi]
        if not self.train:
            mb = np.ones_like(mb)
        rc = (Us[:, 5] >= 0.5) if self.train else np.zeros(len(Us), bool)
        gpipe = Us[:, 6] >= 0.5
        return {"tp": tp, "pp": pp, "dp": dp, "ep": ep, "mb": mb,
                "recompute": rc, "gpipe": gpipe}

    def decode_strategy(self, u_s: np.ndarray):
        """(7,) strategy columns -> compiler.Strategy."""
        from repro_torch.core.compiler import Strategy
        a = self.decode_arrays(np.asarray(u_s)[None, :])
        return Strategy(int(a["tp"][0]), int(a["pp"][0]), int(a["dp"][0]),
                        int(a["mb"][0]), ep=int(a["ep"][0]),
                        recompute=bool(a["recompute"][0]),
                        schedule="gpipe" if a["gpipe"][0] else "1f1b")

    def encode_strategy(self, s) -> np.ndarray:
        """compiler.Strategy -> (7,) columns; decode_strategy round-trips any
        strategy inside the caps."""
        def frac(v, cap):
            return _exp_of(v) / cap if cap else 0.0

        mb = min(self.mb_choices, key=lambda m: abs(m - s.microbatches))
        mbi = self.mb_choices.index(mb)
        mb_f = mbi / (len(self.mb_choices) - 1) if len(self.mb_choices) > 1 \
            else 0.0
        return np.array([
            frac(s.tp, self.tp_exp), frac(s.pp, self.pp_exp),
            frac(s.dp, self.dp_exp), frac(s.ep, self.ep_exp), mb_f,
            1.0 if s.recompute else 0.0,
            1.0 if s.schedule == "gpipe" else 0.0])

    def encode_batch(self, strategies) -> np.ndarray:
        return np.stack([self.encode_strategy(s) for s in strategies]) \
            if strategies else np.zeros((0, self.n_dims))


@dataclasses.dataclass(frozen=True)
class JointDesign:
    """One joint (architecture, strategy) search point."""
    design: WSCDesign
    strategy: "object"             # compiler.Strategy (lazy to avoid cycle)

    def describe(self) -> str:
        s = self.strategy
        sched = f" {s.schedule}" if s.schedule != "1f1b" else ""
        rc = " rc" if s.recompute else ""
        ep = f" ep={s.ep}" if s.ep > 1 else ""
        return (f"{self.design.describe()} | tp={s.tp} pp={s.pp} dp={s.dp} "
                f"mb={s.microbatches}{ep}{rc}{sched}")


def joint_dims(space: StrategySpace) -> int:
    return len(DIMS) + space.n_dims


def sample_joint(rng: np.random.Generator, n: int,
                 space: StrategySpace) -> np.ndarray:
    """n raw points in [0,1]^(13+7) (joint validator filters infeasible)."""
    return rng.random((n, joint_dims(space)))


def decode_joint_batch(U: np.ndarray, space: StrategySpace,
                       max_core_dim: int = 32, max_ret_dim: int = 12
                       ) -> List[JointDesign]:
    """Vectorized joint decode: architecture columns through `decode_batch`,
    strategy columns through the space codec."""
    from repro_torch.core.compiler import Strategy
    U = np.atleast_2d(np.asarray(U, np.float64))
    designs = decode_batch(U[:, :len(DIMS)], max_core_dim, max_ret_dim)
    a = space.decode_arrays(U[:, len(DIMS):])
    return [JointDesign(d, Strategy(
        int(a["tp"][i]), int(a["pp"][i]), int(a["dp"][i]), int(a["mb"][i]),
        ep=int(a["ep"][i]), recompute=bool(a["recompute"][i]),
        schedule="gpipe" if a["gpipe"][i] else "1f1b"))
        for i, d in enumerate(designs)]


def encode_joint_batch(points: Sequence[JointDesign], space: StrategySpace,
                       max_core_dim: int = 32, max_ret_dim: int = 12
                       ) -> np.ndarray:
    """Row i == concat(encode(design_i), encode_strategy(strategy_i))."""
    if not points:
        return np.zeros((0, joint_dims(space)))
    arch = encode_batch([p.design for p in points], max_core_dim,
                        max_ret_dim)
    strat = space.encode_batch([p.strategy for p in points])
    return np.concatenate([arch, strat], axis=1)
