#!/usr/bin/env python3
"""K2's fp32 forward (with states) and backward at the two training shapes,
on one NVIDIA card, through the `chip_smoke.py` of the tree it is run from.

    cd <a checkout of the repo> && python3 <path>/scripts/k2_train_timing.py LABEL

LABEL names the tree in the output. The script builds the tree's CUDA
sources, then at mamba2-370m's (8, 256, 32, 64, 128) and zamba2-1.2b's
(8, 256, 64, 64, 64) shapes, Q = 128, on strided views of one packed
tensor as the trainer passes them, prints `chip_smoke.time_k2_train`'s
lines (device time of the kernels, their bounds, the plain versions and
`SSDScanFn`'s pair) and each kernel's device time from one profiled call.
Run from two checkouts in one machine session (A, B, B, A) to compare two
versions of K2 on the same card.
"""
import re
import subprocess
import sys
import time
from pathlib import Path

TREE = Path.cwd()
sys.path[:0] = [str(TREE / "src"), str(TREE)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_train_timing: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    label = sys.argv[1] if len(sys.argv) > 1 else TREE.name
    t0 = time.time()
    _build.build_all()
    print(f"tree {label}: built in {time.time() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for case in ((8, 256, 32, 64, 128, 128), (8, 256, 64, 64, 64, 128)):
        print(f"  {case}", flush=True)
        c.time_k2_train(torch, case)
        B, S, H, P, N, chunk = case
        args = c.strided_views(torch, case, c.ssd_inputs(torch, case, torch.float32))
        dy = torch.randn(B, S, H, P, generator=torch.Generator("cuda").manual_seed(1),
                         device="cuda")
        _, _, h_prev = ssd_scan(*args, chunk=chunk, return_states=True)
        for name, fn in (("forward", lambda: ssd_scan(*args, chunk=chunk, return_states=True)),
                         ("backward", lambda: ssd_scan_bwd(*args, h_prev, dy, chunk=chunk))):
            _, by_name, counts = c.device_breakdown(torch, fn, reps=3)
            print(f"    {name} by kernel: " + "; ".join(
                f"{re.sub(r'^void |[(]anonymous namespace[)]::|[(].*$', '', k)} "
                f"{ms / counts[k]:.4f} ms" for k, ms in sorted(by_name.items(),
                                                              key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
