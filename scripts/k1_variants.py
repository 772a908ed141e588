#!/usr/bin/env python3
"""Variants of K1's CUDA source built side by side and timed in one process
on one NVIDIA card, to choose between designs of a kernel.

    python3 scripts/k1_variants.py VARIANTS.json [--backward]

VARIANTS.json maps a variant's name to [tree, [[old, new], ...]]: the
variant is `csrc/` of K1 in `tree` (a checkout's root; "" for this one)
with each `old` text replaced by `new` (each must occur). Every variant's
`flash_attention.cu` keeps only the head dims 64, 128 and 256 in its
dispatch, so the variants build in parallel in about half a minute. The
script prints each variant's ptxas registers and spills and any wgmma
serialization warning, then, in the order A B ... B A, holds every variant
to chip_smoke.py's long bf16 rule at six small cases (a miss is printed,
not fatal: a knock-out variant computes another function) and times it
(CUDA graph, `chip_smoke.graph_ms`) at the seven shapes of
`scripts/k1_bf16_fwd_timing.py`, and last each variant's best time per
shape. With --backward it holds and times K1's bf16 backward instead: the
held cases run `chip_smoke.hold_flash_bwd` (its long bf16 rule, two runs bit
for bit; a miss is printed), the timed ones are the six cases of
`scripts/k1_bf16_bwd_timing.py`, the backward timed on each variant's own
forward's o and lse. Variants are bound with ctypes (`kernel.bind`: the
C interface of this tree, so a variant's tree must share it) and swapped
into `kernel._lib`.
Builds go to `.archive/var/` (gitignored).
"""
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

CSRC = Path("src/repro_torch/kernels/flash_attention/csrc")
OUT = ROOT / ".archive" / "var"
HOLD = ([(2, 200, 7, 1, hd, True, 50) for hd in (64, 128, 256)]
        + [(1, 333, 2, 2, hd, False, None) for hd in (64, 128, 256)])


def write_variant(name, tree, subs):
    """The variant's sources under OUT/name; returns its .cu path."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    texts = {f.name: f.read_text() for f in ((ROOT / tree) / CSRC).iterdir() if f.is_file()}
    texts["flash_attention.cu"] = re.sub(
        r"    case (\d+): return L<\d+>::run\(dtype, a\);\n",
        lambda m: m.group(0) if m.group(1) in ("64", "128", "256") else "",
        texts["flash_attention.cu"])
    for old, new in subs:
        hits = [f for f, t in texts.items() if old in t]
        if not hits:
            raise SystemExit(f"variant {name}: text not found: {old[:80]!r}")
        for f in hits:
            texts[f] = texts[f].replace(old, new)
    for f, t in texts.items():
        (d / f).write_text(t)
    return d / "flash_attention.cu"


def bind(path):
    from repro_torch.kernels.flash_attention.kernel import bind as bind_lib
    return bind_lib(ctypes.CDLL(str(path)))


def backward_rounds(torch, c, kernel, libs):
    """--backward: every variant held at HOLD's cases by hold_flash_bwd and
    timed at the backward timing script's six cases, A B .. B A."""
    from k1_bf16_bwd_timing import SHARDS
    shapes = {**SHARDS, **c.K1_BF16_LAYERS}
    times = {name: {} for name in libs}
    for rnd, name in enumerate(list(libs) + list(reversed(list(libs)))):
        fns = bind(libs[name])
        kernel._lib = lambda fns=fns: fns
        held = True
        for case in HOLD if rnd < len(libs) else ():
            try:
                c.hold_flash_bwd(torch, case, "bf16", small=False)
            except RuntimeError as e:
                print(f"  {name} {case}: {e}")
                held = False
        for sname, case in shapes.items():
            q, k, v, _ = c.flash_inputs(torch, case, torch.bfloat16)
            do = c.flash_inputs(torch, case, torch.bfloat16, seed=c.SEED + 1)[0]
            kw = {"causal": case[5], "window": case[6]}
            o, lse = kernel.flash_attention(q, k, v, return_lse=True, **kw)
            times[name].setdefault(sname, []).append(c.graph_ms(
                torch, lambda: kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)))
            del q, k, v, do, o, lse
        print(f"round {rnd} {name}: held {held}; "
              + ", ".join(f"{s} {times[name][s][-1]:.4f}" for s in shapes), flush=True)
    for name in libs:
        print(f"{name} (best of 2): "
              + ", ".join(f"{s} {min(times[name][s]):.4f}" for s in shapes))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_variants: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from k1_bf16_fwd_timing import SHAPES, long_rule
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    variants = json.loads(Path(sys.argv[1]).read_text())
    t0 = time.time()
    procs = {}
    for name, (tree, subs) in variants.items():
        cu = write_variant(name, tree, subs)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: build failed\n{log[-5000:]}")
            continue
        for line in log.splitlines():
            if "wgmma.mma_async instructions are serialized" in line:
                print(f"  {name}: {line[:200]}")
        for k, (regs, st, ld, _) in sorted(c.ptxas_table(log, c.fwd_name).items()):
            if k.startswith(("flash_wgmma_kernel", "flash_mma_kernel")):
                print(f"  {name} {k}: {regs} registers, {st}/{ld} bytes spilled")
        for k, (regs, st, ld, _) in sorted(c.ptxas_table(log, c.bwd_name).items()):
            if "--backward" in sys.argv and k.startswith("flash_wgmma_bwd"):
                print(f"  {name} {k}: {regs} registers, {st}/{ld} bytes spilled")
        libs[name] = OUT / name / "flash_attention.so"
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if "--backward" in sys.argv:
        backward_rounds(torch, c, kernel, libs)
        return 0

    cases = HOLD + list(SHAPES.values())
    inputs = {case: c.flash_inputs(torch, case, torch.bfloat16) for case in cases}
    refs = {}
    times = {name: {} for name in libs}
    for rnd, name in enumerate(list(libs) + list(reversed(list(libs)))):
        fns = bind(libs[name])
        kernel._lib = lambda fns=fns: fns
        held = True
        for case in cases:
            q, k, v, pos = inputs[case]
            kw = {"causal": case[5], "window": case[6]}
            out = kernel.flash_attention(q, k, v, **kw)
            if case not in refs:
                refs[case] = attention_ref(q, k, v, pos, pos, **kw).float()
            ok, err, _ = long_rule(torch, out, refs[case])
            if not ok:
                print(f"  {name} {case}: outside the rule, max|d| {err:.3g}")
                held = False
        for sname, case in SHAPES.items():
            q, k, v, _ = inputs[case]
            ms = c.graph_ms(torch, lambda: kernel.flash_attention(q, k, v, causal=case[5],
                                                                  window=case[6]))
            times[name].setdefault(sname, []).append(ms)
        print(f"round {rnd} {name}: held {held}; "
              + ", ".join(f"{s} {times[name][s][-1]:.4f}" for s in SHAPES), flush=True)
    for name in libs:
        print(f"{name} (best of 2): "
              + ", ".join(f"{s} {min(times[name][s]):.4f}" for s in SHAPES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
