#!/usr/bin/env python3
"""K1 in bf16 on one NVIDIA card, through the kernels of the tree it is run
from, at the two shards of the mesh path (chip_smoke.py phase 23) and at
the four whole-layer cases of mixtral-8x7b, gemma3-4b and whisper-small
(`chip_smoke.K1_BF16_LAYERS`).

    cd <a checkout of the repo> && python3 <path>/scripts/k1_bf16_bwd_timing.py LABEL

LABEL names the tree in the output. The script builds the tree's CUDA
sources, then runs `chip_smoke.time_k1_local` at each case: the forward and
the backward held against the plain version (the backward by
`hold_flash_bwd`'s long bf16 rule, two runs bit for bit), their device
times beside the bound, the split-bf16 scheme's own floor, the plain
version's and scaled_dot_product_attention's, and the backward's device
time split by CUDA kernel (one call under torch.profiler; a kernel the
profiler misses is left out). The measuring code is this
script's own checkout's `chip_smoke.py`; only the kernels come from the
tree it is run from. Run from two checkouts one after the other on one
card (A, B, B, A) to compare two versions of K1.
"""
import subprocess
import sys
import time
from pathlib import Path

TREE = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHARDS = {"mixtral-8x7b shard": (1, 4096, 16, 4, 128, True, 4096),
          "smollm-135m shard": (4, 256, 9, 3, 64, True, None)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_bf16_bwd_timing: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    sys.path.insert(0, str(TREE / "src"))     # ahead of chip_smoke's own checkout
    import repro_torch
    from repro_torch.kernels import _build
    if not Path(repro_torch.__file__).resolve().is_relative_to(TREE.resolve()):
        print(f"k1_bf16_bwd_timing: repro_torch from {repro_torch.__file__}, not {TREE}",
              file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else TREE.name
    t0 = time.time()
    _build.build_all()
    print(f"tree {label}: built in {time.time() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    for name, case in {**SHARDS, **c.K1_BF16_LAYERS}.items():
        print(f"  {label} {name} {case}", flush=True)
        c.time_k1_local(torch, case)
        kw = {"causal": case[5], "window": case[6]}
        q, k, v, _ = c.flash_inputs(torch, case, torch.bfloat16)
        do = c.flash_inputs(torch, case, torch.bfloat16, seed=c.SEED + 1)[0]
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        _, split, _ = c.device_breakdown(
            torch, lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), reps=1)
        print("    backward by kernel: " + ", ".join(
            f"{n.replace('(anonymous namespace)::', '').removeprefix('void ').split('(')[0]} "
            f"{ms:.4f} ms" for n, ms in sorted(split.items())), flush=True)
        del q, k, v, do, o, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
