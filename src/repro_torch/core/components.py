"""Component Estimator (paper §VI-E): analytical area/power/energy tables for
WSC basic modules, calibrated to the paper's published constants and public
references (Aladdin/Orion3-style action energies, Cerebras/Dojo/GRS interconnect
numbers), all at 14 nm / 1 GHz / 0.9 V (paper §VIII-A).

The paper builds this table with an SRAM compiler + Synopsys DC + DREAMPlace;
offline we ship an analytic fit with the same interface — an updatable
area-power table (the paper itself frames it that way).

The port's own copy of `repro.core.components`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# ---------------------------------------------------------------------------
# constants (14 nm, 1 GHz)
# ---------------------------------------------------------------------------

CLOCK_HZ = 1e9

# MAC: bf16 FMA incl. operand regs/pipeline, 14nm synthesis-class numbers
MAC_AREA_MM2 = 4.0e-4            # 400 um^2
MAC_ENERGY_PJ = 0.8              # per MAC (= 2 flops)

# SRAM (ssg, 0.9V): density incl. periphery; energies per bit.
# 0.09 um^2/bit = published 14nm high-density macro incl. periphery
# (bitcell 0.064 um^2 x ~1.4 overhead) — needed for the paper's
# SRAM-resident inference scenario (Fig. 11a) to be area-feasible.
SRAM_MM2_PER_KB = 0.75e-3
SRAM_READ_PJ_PER_BIT = 0.06
SRAM_WRITE_PJ_PER_BIT = 0.08
SRAM_STATIC_W_PER_MB = 0.015
# banking/port overhead: wider read ports cost area (SRAM-compiler feasibility
# constraint lives in validator.py)
SRAM_BW_AREA_FACTOR = 0.12       # area multiplier per log2(bw/256b)

# NoC router: 5-port, 8 VCs x 4 buffers (paper), Orion3-class
ROUTER_BASE_MM2 = 0.015
ROUTER_BW_EXP = 1.1              # area ~ (bw/128)^1.1
ROUTER_ENERGY_PJ_PER_BIT_HOP = 0.045
LINK_ENERGY_PJ_PER_BIT_MM = 0.06
ROUTER_STATIC_W = 0.012

# RISC-V control core per compute core
CTRL_AREA_MM2 = 0.05
CTRL_STATIC_W = 0.01

# inter-reticle PHY (paper §VIII-A)
IR_AREA_UM2_PER_GBPS = {"infosow": 3900.0, "die_stitching": 1300.0}
IR_ENERGY_PJ_PER_BIT = {"infosow": 1.5, "die_stitching": 0.45}

# 3D-stacked DRAM via TSV (paper: 5um TSV, 15um pitch). Effective signaling
# is calibrated to 5 Gbps/TSV (DDR pins) so the paper's own sweep range —
# 0.25..4 TB/s/100mm^2 "within the stress constraint" of 1.5% TSV area —
# is self-consistent: at 4 TB/s/100mm^2 the TSV field is 1.44% of area.
TSV_PITCH_UM = 15.0
TSV_GBPS = 5.0
DRAM_ENERGY_PJ_PER_BIT = 3.5
DRAM_STATIC_W_PER_GB = 0.05
# capacity/bandwidth linear trade (paper fits existing configs): at max bw
# (4 TB/s/100mm2) capacity tops at 8 GB/100mm2-class stacks; at 0.25 TB/s, 40 GB
DRAM_BW_RANGE = (0.25, 4.0)      # TB/s per 100 mm^2
DRAM_GB_RANGE = (40.0, 8.0)      # GB at the respective bw endpoints

# off-chip DRAM + inter-wafer (paper Table I)
OFFCHIP_BW_PER_CTRL = 160e9      # B/s
OFFCHIP_CTRL_AREA_MM2 = 6.0
OFFCHIP_ENERGY_PJ_PER_BIT = 10.0
INTER_WAFER_BW_PER_NI = 100e9    # B/s
NI_ENERGY_PJ_PER_BIT = 5.0

# physical limits (paper §VIII-A)
RETICLE_MM = (26.0, 33.0)
RETICLE_AREA_MM2 = RETICLE_MM[0] * RETICLE_MM[1]
WAFER_MM = (215.0, 215.0)
WAFER_AREA_MM2 = WAFER_MM[0] * WAFER_MM[1]
WAFER_POWER_W = 15000.0
TSV_AREA_RATIO_MAX = 0.015       # stress constraint


# ---------------------------------------------------------------------------
# derived component models
# ---------------------------------------------------------------------------


# the numeric helpers below are dtype-polymorphic: scalars in -> (np) scalar
# out, arrays in -> arrays out, so design_space.DesignBatch shares the exact
# same formulas (and constants) as the scalar WSCDesign methods.


def sram_area_mm2(buffer_kb: float, buffer_bw_bits: int) -> float:
    base = buffer_kb * SRAM_MM2_PER_KB
    widen = np.maximum(0.0, np.log2(np.maximum(buffer_bw_bits, 256) / 256.0))
    return base * (1.0 + SRAM_BW_AREA_FACTOR * widen)


def router_area_mm2(noc_bw_bits: int) -> float:
    return ROUTER_BASE_MM2 * (noc_bw_bits / 128.0) ** ROUTER_BW_EXP


def core_area_mm2(mac_num: int, buffer_kb: float, buffer_bw: int,
                  noc_bw: int) -> float:
    # operand-distribution networks grow super-linearly with array size
    # (broadcast wiring / accumulation trees) — the "module efficiency"
    # penalty of very large cores (paper §IX-A)
    dist = np.where(np.asarray(mac_num) > 512, (mac_num / 512.0) ** 0.10, 1.0)
    a = (mac_num * MAC_AREA_MM2 * dist
         + sram_area_mm2(buffer_kb, buffer_bw)
         + router_area_mm2(noc_bw)
         + CTRL_AREA_MM2)
    return a * 1.10                      # 10% place&route overhead


def core_peak_flops(mac_num: int) -> float:
    return 2.0 * mac_num * CLOCK_HZ


def core_static_w(mac_num: int, buffer_kb: float) -> float:
    return (buffer_kb / 1024.0 * SRAM_STATIC_W_PER_MB
            + ROUTER_STATIC_W + CTRL_STATIC_W
            + mac_num * 2e-6)


def dram_gb_at_bw(bw_tbps_per_100mm2: float) -> float:
    """Linear capacity/bandwidth trade-off (paper fits existing configs)."""
    lo_bw, hi_bw = DRAM_BW_RANGE
    lo_gb, hi_gb = DRAM_GB_RANGE
    t = (bw_tbps_per_100mm2 - lo_bw) / (hi_bw - lo_bw)
    t = np.clip(t, 0.0, 1.0)
    return lo_gb + t * (hi_gb - lo_gb)


def tsv_area_mm2(dram_bw_Bps: float) -> float:
    """TSV keep-out area for a given stacked-DRAM bandwidth."""
    tsvs = (dram_bw_Bps * 8.0) / (TSV_GBPS * 1e9)
    return tsvs * (TSV_PITCH_UM * 1e-3) ** 2


def tsv_area_ratio(dram_bw_tbps_per_100mm2: float) -> float:
    """TSV field area per unit reticle area at the given stacked-DRAM
    bandwidth density — the fixed-point factor in reticle sizing."""
    return (dram_bw_tbps_per_100mm2 * 1e12 / 100.0) * 8.0 \
        / (TSV_GBPS * 1e9) * (TSV_PITCH_UM * 1e-3) ** 2


def inter_reticle_area_mm2(bw_Bps: float, integration: str) -> float:
    return bw_Bps * 8e-9 * IR_AREA_UM2_PER_GBPS[integration] * 1e-6


@dataclasses.dataclass(frozen=True)
class ActionEnergies:
    """pJ per action — Aladdin-style power accounting (paper §VI-E)."""
    mac: float = MAC_ENERGY_PJ
    sram_read_bit: float = SRAM_READ_PJ_PER_BIT
    sram_write_bit: float = SRAM_WRITE_PJ_PER_BIT
    noc_bit_hop: float = ROUTER_ENERGY_PJ_PER_BIT_HOP + LINK_ENERGY_PJ_PER_BIT_MM
    dram_bit: float = DRAM_ENERGY_PJ_PER_BIT
    offchip_bit: float = OFFCHIP_ENERGY_PJ_PER_BIT
    ni_bit: float = NI_ENERGY_PJ_PER_BIT

    def ir_bit(self, integration: str) -> float:
        return IR_ENERGY_PJ_PER_BIT[integration]


ENERGY = ActionEnergies()
