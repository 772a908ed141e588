"""Tile-level evaluation (paper §VI-B): fixed-dataflow loop-nest model for a
GEMM tile on one core (Timeloop/MAESTRO-style, simplified to the three
canonical dataflows).

For a core with `mac` MACs arranged as a pr x pc array and an SRAM of
`buffer_kb`, a (M, K, N) GEMM tile yields:
    - compute cycles (with dataflow-dependent utilization),
    - SRAM traffic (data reuse bounded by buffer capacity),
    - the output-production interval used by the NoC estimators.

The core math lives in `evaluate_tile_batch`, which broadcasts over a
leading batch axis (DESIGN.md §4); `evaluate_tile` is the scalar wrapper.

The port's own copy of `repro.core.tile_eval`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.design_space import floor_log2
from repro_torch.core.workload import BYTES, GEMMOp

# dataflow codes shared with design_space.DATAFLOWS order
DATAFLOW_CODE = {"WS": 0, "IS": 1, "OS": 2}


@dataclasses.dataclass(frozen=True)
class TileResult:
    cycles: float
    util: float
    sram_read_bits: float
    sram_write_bits: float
    out_interval_cycles: float     # avg cycles between output flit batches


def _ceil_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return -(-np.asarray(a, np.int64) // np.asarray(b, np.int64))


def pe_dims(mac: np.ndarray):
    """Vectorized PE-array factorization: pr x pc with pr = 2^(log2(mac)//2)."""
    pr = np.int64(1) << (floor_log2(mac) // 2)
    return pr, np.maximum(np.asarray(mac, np.int64), 1) // pr


def evaluate_tile_batch(M: np.ndarray, K: np.ndarray, N: np.ndarray,
                        mac: np.ndarray, buffer_kb: np.ndarray,
                        buffer_bw: np.ndarray, dataflow_code: np.ndarray
                        ) -> Dict[str, np.ndarray]:
    """Batched tile model. All inputs broadcastable arrays; `dataflow_code`
    follows DATAFLOW_CODE (0=WS, 1=IS, 2=OS). Returns a dict of float64
    arrays: cycles, util, sram_read_bits, sram_write_bits,
    out_interval_cycles."""
    M = np.maximum(np.asarray(M, np.int64), 1)
    K = np.maximum(np.asarray(K, np.int64), 1)
    N = np.maximum(np.asarray(N, np.int64), 1)
    mac = np.asarray(mac, np.int64)
    code = np.asarray(dataflow_code, np.int64)
    M, K, N, mac, buffer_kb, buffer_bw, code = np.broadcast_arrays(
        M, K, N, mac, np.asarray(buffer_kb, np.float64),
        np.asarray(buffer_bw, np.int64), code)
    pr, pc = pe_dims(mac)

    ws, os_ = code == 0, code == 2             # IS is the select default
    # spatial mapping per dataflow: which two dims are laid across the array
    u1 = np.select([ws, os_], [K, M], default=M)          # IS: M
    u2 = np.select([ws, os_], [N, N], default=K)          # IS: K
    stream = np.select([ws, os_], [M, K], default=N)      # IS: N

    util = (np.minimum(u1, pr) / pr) * (np.minimum(u2, pc) / pc)
    t1, t2 = _ceil_div(u1, pr), _ceil_div(u2, pc)
    compute_cycles = (t1 * t2).astype(np.float64) * stream

    # SRAM traffic: stationary operand loaded once; streaming operand
    # re-read once per stationary tile swap
    Mf, Kf, Nf = (M.astype(np.float64), K.astype(np.float64),
                  N.astype(np.float64))
    reads = np.select(
        [ws, os_],
        [Kf * Nf + Mf * Kf * t2, Mf * Kf * t2 + Kf * Nf * t1],
        default=Mf * Kf + Kf * Nf * t1)
    writes = np.select([ws, os_], [Mf * Nf * t1, Mf * Nf],
                       default=Mf * Nf * t2)

    # buffer capacity check: if the stationary tile exceeds SRAM, extra
    # re-fetches (capacity factor)
    buf_bits = buffer_kb * 1024 * 8
    stat1 = np.select([ws, os_], [np.minimum(K, pr), np.minimum(M, pr)],
                      default=np.minimum(M, pr))
    stat2 = np.select([ws, os_], [np.minimum(N, pc), np.minimum(N, pc)],
                      default=np.minimum(K, pc))
    stat_bits = (stat1 * stat2).astype(np.float64) * BYTES * 8
    cap_factor = np.maximum(1.0, stat_bits / np.maximum(buf_bits, 1))

    read_bits = reads * BYTES * 8 * cap_factor
    write_bits = writes * BYTES * 8
    mem_cycles = (read_bits + write_bits) / np.maximum(buffer_bw, 1)

    cycles = np.maximum(compute_cycles, mem_cycles)
    n_out_batches = np.maximum(t1 * t2, 1)
    return {
        "cycles": cycles,
        "util": util.astype(np.float64),
        "sram_read_bits": read_bits,
        "sram_write_bits": write_bits,
        "out_interval_cycles": cycles / n_out_batches,
    }


# NumPy oracle alias for the torch pipeline (repro_torch.core.eval_compiled):
# the implementation above IS the reference; the compiled path mirrors it
# op for op and is property-tested bit-exact against this name.
evaluate_tile_batch_ref = evaluate_tile_batch


def evaluate_tile(op: GEMMOp, mac: int, buffer_kb: float, buffer_bw: int,
                  dataflow: str) -> TileResult:
    """Scalar wrapper: delegates to the batched kernel with a length-1 axis."""
    r = evaluate_tile_batch(np.asarray([op.M]), np.asarray([op.K]),
                            np.asarray([op.N]), np.asarray([mac]),
                            np.asarray([buffer_kb], np.float64),
                            np.asarray([buffer_bw]),
                            np.asarray([DATAFLOW_CODE[dataflow]]))
    return TileResult(
        cycles=float(r["cycles"][0]),
        util=float(r["util"][0]),
        sram_read_bits=float(r["sram_read_bits"][0]),
        sram_write_bits=float(r["sram_write_bits"][0]),
        out_interval_cycles=float(r["out_interval_cycles"][0]),
    )
