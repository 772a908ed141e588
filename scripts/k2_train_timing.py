#!/usr/bin/env python3
"""K2's fp32 forward (with states) and backward at the two training shapes,
on one NVIDIA card, through the `chip_smoke.py` of the tree it is run from.

    cd <a checkout of the repo> && python3 <path>/scripts/k2_train_timing.py LABEL

LABEL names the tree in the output. The script builds the tree's CUDA
sources, then at mamba2-370m's (8, 256, 32, 64, 128) and zamba2-1.2b's
(8, 256, 64, 64, 64) shapes, Q = 128, on strided views of one packed
tensor as the trainer passes them, prints the backward's route (the
kernels `kernel.backward_kernels` names, in a tree that has the route
rule; else the six mma.sync kernels), `chip_smoke.time_k2_train`'s lines
(device time of the kernels, their bounds, the plain versions and
`SSDScanFn`'s pair) and each kernel's device time from one profiled call.
Then, for the paths the route rule leaves on the mma.sync kernels, the
bf16 backward at the mesh's shard (4, 256, 16, 64, 128) and the fp32
backward at (8, 256, 32, 64, 32), an N outside the rule, it prints the
device time of the backward, and at every shape a SHA-256 prefix of the
forward's outputs and of the backward's gradients: equal digests from two
trees are the same bits. Run from two checkouts in one machine session (A,
B, B, A) to compare two versions of K2 on the same card.
"""
import hashlib
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
    try:
        from repro_torch.kernels.ssd_scan.kernel import backward_kernels
    except ImportError:                 # a tree from before the route rule
        backward_kernels = None
    for case in ((8, 256, 32, 64, 128, 128), (8, 256, 64, 64, 64, 128)):
        route = ("the six mma.sync kernels (no route rule in this tree)" if backward_kernels is None
                 else ", ".join(backward_kernels(case, torch.float32)))
        print(f"  {case}; backward route: {route}", flush=True)
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
        print_digests(torch, c, case, torch.float32, label)
    for case, dtype in (((4, 256, 16, 64, 128, 128), torch.bfloat16),
                        ((8, 256, 32, 64, 32, 128), torch.float32)):
        B, S, H, P, N, chunk = case
        args = c.strided_views(torch, case, c.ssd_inputs(torch, case, dtype))
        dy = torch.randn(B, S, H, P, generator=torch.Generator("cuda").manual_seed(1),
                         device="cuda").to(dtype)
        _, _, h_prev = ssd_scan(*args, chunk=chunk, return_states=True)
        ms = c.graph_ms(torch, lambda: ssd_scan_bwd(*args, h_prev, dy, chunk=chunk))
        print(f"  {case} {str(dtype)[6:]} (the mma.sync route): backward {ms:.4f} ms")
        print_digests(torch, c, case, dtype, label)
    return 0


def print_digests(torch, c, case, dtype, label):
    """SHA-256 prefixes of the forward's (y, final state, states) and the
    backward's six gradients at `case` on the strided views, dy from seed 1."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    B, S, H, P, N, chunk = case
    args = c.strided_views(torch, case, c.ssd_inputs(torch, case, dtype))
    dy = torch.randn(B, S, H, P, generator=torch.Generator("cuda").manual_seed(1),
                     device="cuda").to(dtype)
    fwd = ssd_scan(*args, chunk=chunk, return_states=True)
    bwd = ssd_scan_bwd(*args, fwd[2], dy, chunk=chunk)

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]
    print(f"    digest {label} {case} {str(dtype)[6:]}: forward {digest(fwd)} "
          f"backward {digest(bwd)}")


if __name__ == "__main__":
    sys.exit(main())
