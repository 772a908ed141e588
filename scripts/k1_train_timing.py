#!/usr/bin/env python3
"""K1's fp32 forward (with lse) and backward at the five training cases of
whisper-small, gemma3-4b and mixtral-8x7b and at smollm-135m's (the
launcher's default), on one NVIDIA card, through the kernels of the tree it
is run from.

    cd <a checkout of the repo> && python3 <path>/scripts/k1_train_timing.py LABEL

LABEL names the tree in the output. The script builds the tree's CUDA
sources, then at each case prints the device time of the forward and of
the backward (`chip_smoke.graph_ms`: calls captured in a CUDA graph), the
forward's and the backward's device time by kernel (pre-pass and main
kernels; one call each under torch.profiler) and their
error, as max|d| / max|ref| of o, dq, dk and dv, against the fp32
plain version (the backward on the kernel's own o and lse, as chip_smoke's
`hold_flash_bwd` holds it) and against float64 (the function's own o and
lse), with the count of entries that miss |d| <= 2e-5 (|ref| + max|ref|)
against each, and the fp32 plain version's own error against float64. Run
from two checkouts one after the other on one card (A, B, B, A) to compare two
versions of K1 on the same card.
"""
import subprocess
import sys
import time
from pathlib import Path

TREE = Path.cwd()
sys.path[:0] = [str(TREE / "src"), str(TREE)]

CASES = {"whisper-small encoder": (8, 1500, 12, 12, 64, False, None),
         "whisper-small decoder": (8, 448, 12, 12, 64, True, None),
         "gemma3-4b local": (1, 4096, 8, 4, 256, True, 1024),
         "gemma3-4b global": (1, 4096, 8, 4, 256, True, None),
         "mixtral-8x7b": (1, 4096, 32, 8, 128, True, 4096),
         "smollm-135m": (8, 256, 9, 3, 64, True, None)}


def errors(got, ref):
    """(max|d| / max|ref|, entries missing |d| <= 2e-5 (|ref| + max|ref|))."""
    d = (got.double() - ref.double()).abs()
    m = ref.double().abs().max()
    return (d.max() / m).item(), int((d > 2e-5 * (ref.double().abs() + m)).sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_train_timing: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = sys.argv[1] if len(sys.argv) > 1 else TREE.name
    t0 = time.time()
    _build.build_all()
    print(f"tree {label}: built in {time.time() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for name, case in CASES.items():
        kw = {"causal": case[5], "window": case[6]}
        q, k, v, pos = c.flash_inputs(torch, case, torch.float32)
        do = c.flash_inputs(torch, case, torch.float32, seed=c.SEED + 1)[0]
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        f_ms = c.graph_ms(torch, lambda: flash_attention(q, k, v, return_lse=True, **kw))
        b_ms = c.graph_ms(torch, lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))
        line = [f"  {label} {name} {case}: forward {f_ms:.4f} ms, backward {b_ms:.4f} ms"]
        for part, fn in (("forward", lambda: flash_attention(q, k, v, return_lse=True, **kw)),
                         ("backward", lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))):
            _, by_name, counts = c.device_breakdown(torch, fn, reps=1)
            line.append(f"    {part} by kernel (one profiled call): " + ", ".join(
                f"{n.replace('(anonymous namespace)::', '').removeprefix('void ').split('(')[0]} "
                f"{ms:.4f} ms x{counts[n]}"
                for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])))
        plain = (attention_ref(q, k, v, pos, pos, **kw),
                 *attention_bwd_ref(q, k, v, o, lse, do, **kw))
        t64 = [t.double() for t in (q, k, v, do)]
        o64, lse64 = attention_ref(*t64[:3], pos, pos, return_lse=True, **kw)
        exact = (o64, *attention_bwd_ref(*t64[:3], o64, lse64, t64[3], **kw))
        for part, g, r32, r64 in zip(("o", "dq", "dk", "dv"), (o, *grads), plain, exact):
            e32, n32 = errors(g, r32)
            e64, n64 = errors(g, r64)
            p64, _ = errors(r32, r64)
            line.append(f"    {part}: against fp32 plain {e32:.3g} ({n32} miss), against "
                        f"float64 {e64:.3g} ({n64} miss); the fp32 plain version against "
                        f"float64 {p64:.3g}")
        print("\n".join(line), flush=True)
        del q, k, v, do, o, lse, grads, plain, t64, o64, lse64, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
