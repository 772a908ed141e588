#!/usr/bin/env python3
"""K1's bf16 forward on one NVIDIA card, through the kernels of the tree it
is run from, at the bf16 shapes of the port's paths: mixtral-8x7b's layer
and its 2x2 mesh shard, gemma3-4b's global and local layers, zamba2-1.2b's
shared block, whisper-small's encoder and smollm-135m's mesh shard.

    cd <a checkout of the repo> && python3 <path>/scripts/k1_bf16_fwd_timing.py LABEL [--hold]

LABEL names the tree in the output. The script builds the tree's CUDA
sources, then at each shape holds the forward to chip_smoke.py's long bf16
rule (each element within 1e-2 |ref| + 1e-4 max|ref| of the plain version)
and prints the CUDA kernel that ran (by the profiler), its device time
(CUDA graph, `chip_smoke.graph_ms`) without and with the log-sum-exp, the
first 16 hex digits of the SHA-256 of the output's and the log-sum-exp's
bytes (two trees that print the same digests gave the same bits), the
eager back-to-back time, the bound (bf16 tensor-core peak or the bytes),
the split-bf16 scheme's own floor (P V in two bf16 products: 1.5x the
function's tensor-core work) and scaled_dot_product_attention's time (K/V
repeated, BHSD copies made beforehand, a boolean mask where the window
bites). It also times the host side of one call at a tiny shape, where
the launch and its Python dominate. With --hold it first runs the
forward's checks at every head-dim class of the Hopper kernel (hd 64, 128,
256): causal with a window, non-causal, ragged S, GQA, strided views, the
log-sum-exp, window=1 and a repeat bit for bit. The measuring code is this
script's own checkout's `chip_smoke.py`; only the kernels come from the tree
it is run from. Run from two checkouts one after the other on one card
(A, B, B, A) to compare two versions of K1.
"""
import hashlib
import subprocess
import sys
import time
from pathlib import Path

TREE = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = {"mixtral-8x7b layer": (1, 4096, 32, 8, 128, True, 4096),
          "mixtral-8x7b mesh shard": (1, 4096, 16, 4, 128, True, 4096),
          "gemma3-4b global": (1, 4096, 8, 4, 256, True, None),
          "gemma3-4b local": (1, 4096, 8, 4, 256, True, 1024),
          "zamba2-1.2b shared block": (1, 4096, 32, 32, 64, True, None),
          "whisper-small encoder": (4, 1500, 12, 12, 64, False, None),
          "smollm-135m mesh shard": (4, 256, 9, 3, 64, True, None)}


def long_rule(torch, out, ref):
    """(holds, max|d|, max|ref|) of chip_smoke.py phase 7's long bf16 rule."""
    err = (out.float() - ref.float()).abs()
    mref = ref.float().abs().max().item()
    return bool((err <= 1e-2 * ref.float().abs() + 1e-4 * mref).all()), err.max().item(), mref


def hold(torch, c):
    """The forward's checks at hd 64, 128 and 256; raises on a failure."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cases = []
    for hd in (64, 128, 256):
        cases += [(2, 200, 7, 1, hd, True, 50), (1, 200, 2, 2, hd, False, None),
                  (2, 333, 4, 2, hd, True, None), (1, 1, 2, 1, hd, True, None),
                  (1, 64, 2, 2, hd, False, None)]
    for case in cases:
        B, S, Hq, Hkv, hd, causal, window = case
        q, k, v, pos = c.flash_inputs(torch, case, torch.bfloat16)
        o, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        ref, lse_ref = attention_ref(q, k, v, pos, pos, causal=causal, window=window,
                                     return_lse=True)
        ok, err, mref = long_rule(torch, o, ref)
        dlse = (lse - lse_ref).abs().max().item()
        # the same values as one packed (B, S, Hq + 2 Hkv, hd) tensor, read
        # in place through its strides
        packed = torch.cat([q, k, v], 2)
        qs, ks, vs = packed.split([Hq, Hkv, Hkv], 2)
        o_s = flash_attention(qs, ks, vs, causal=causal, window=window)
        again = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        print(f"  {case}: max|d| {err:.3g} (max|ref| {mref:.3g}) |dlse| {dlse:.3g}; "
              f"strided bitwise {torch.equal(o_s, o)}; repeat bitwise {torch.equal(again, o)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        c.check(ok and torch.isfinite(o).all().item(), f"flash_attention {case} bf16")
        c.check(dlse <= 1e-5 * max(1.0, lse_ref.abs().max().item()), f"lse {case}")
        c.check(torch.equal(o_s, o) and torch.equal(again, o), f"{case}: strided, repeat bitwise")
    for hd in (64, 128, 256):
        q, k, v, pos = c.flash_inputs(torch, (1, 300, 4, 2, hd, True, 50), torch.bfloat16)
        for scale in (-0.3, 0.0):
            out = flash_attention(q, k, v, causal=True, window=50, softmax_scale=scale)
            ok, err, _ = long_rule(torch, out, attention_ref(q, k, v, pos, pos, causal=True,
                                                             window=50, softmax_scale=scale))
            c.check(ok, f"softmax_scale {scale} at hd {hd}: max|d| {err:.3g}")
    print("  softmax_scale -0.3 and 0: ok (hd 64, 128, 256)")
    for hd in (64, 128, 256):
        q, k, v, _ = c.flash_inputs(torch, (1, 300, 2, 2, hd, True, 1), torch.bfloat16)
        out = flash_attention(q, k, v, causal=True, window=1)
        c.check(torch.equal(out, v), f"window=1 at hd {hd}: each row its own value")
    print("  window=1: each row equals its own value bit for bit (hd 64, 128, 256)")


def timing(torch, c, label, name, case):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, S, Hq, Hkv, hd, causal, window = case
    kw = {"causal": causal, "window": window}
    q, k, v, pos = c.flash_inputs(torch, case, torch.bfloat16)
    o = flash_attention(q, k, v, **kw)
    ok, err, mref = long_rule(torch, o, attention_ref(q, k, v, pos, pos, **kw))
    c.check(ok, f"flash_attention {case} bf16")
    _, by_name, _ = c.device_breakdown(torch, lambda: flash_attention(q, k, v, **kw), reps=1)
    ran = sorted({n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                  for n in by_name})
    _, lse = flash_attention(q, k, v, return_lse=True, **kw)
    digest = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()
                            + lse.cpu().numpy().tobytes()).hexdigest()[:16]
    ms = c.graph_ms(torch, lambda: flash_attention(q, k, v, **kw))
    ms_lse = c.graph_ms(torch, lambda: flash_attention(q, k, v, return_lse=True, **kw))
    eager = c.time_ms(torch, lambda: flash_attention(q, k, v, **kw), iters=20)
    nbytes, flops = c.flash_work(case, "bf16")
    t_bytes, t_ops = nbytes / c.PEAK_BYTES_S * 1e3, flops / c.PEAK_FLOPS["bf16"] * 1e3
    bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    floor = 1.5 * t_ops
    rep = Hq // Hkv
    qt, kt, vt = (t.repeat_interleave(r, 2).transpose(1, 2).contiguous()
                  for t, r in ((q, 1), (k, rep), (v, rep)))
    mask = None
    if window is not None and window < S:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    sdpa = c.graph_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None))
    print(f"  {label} {name} {case}: {'+'.join(ran)} {ms:.4f} ms (with lse {ms_lse:.4f}, "
          f"eager {eager:.4f}); bound {bound:.5f} ms ({by}, {bound / ms:.1%}); split-bf16 floor "
          f"{floor:.5f} ms ({floor / ms:.1%}); scaled_dot_product_attention {sdpa:.4f} ms "
          f"({ms / sdpa:.2f}x){' (boolean window mask)' if mask is not None else ''}; "
          f"max|d| {err:.3g} (max|ref| {mref:.3g}); sha256 of o and lse {digest}", flush=True)
    del q, k, v, o, qt, kt, vt, mask
    torch.cuda.empty_cache()


def host_cost(torch, c, label):
    """Host us of one eager call at a tiny shape, by hd (no sync inside)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    line = []
    for hd in (64, 128, 256, 80):
        q, k, v, _ = c.flash_inputs(torch, (1, 128, 1, 1, hd, True, None), torch.bfloat16)
        for _ in range(20):
            flash_attention(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            flash_attention(q, k, v)
        host = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        line.append(f"hd {hd} {host:.1f} us")
    print(f"  {label} host time per call at (1, 128, 1/1 heads): " + ", ".join(line))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_bf16_fwd_timing: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    sys.path.insert(0, str(TREE / "src"))     # ahead of chip_smoke's own checkout
    import repro_torch
    from repro_torch.kernels import _build
    if not Path(repro_torch.__file__).resolve().is_relative_to(TREE.resolve()):
        print(f"k1_bf16_fwd_timing: repro_torch from {repro_torch.__file__}, not {TREE}",
              file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else TREE.name
    t0 = time.time()
    logs = _build.build_all()
    print(f"tree {label}: built in {time.time() - t0:.1f} s")
    for log in logs.values():
        for k, (regs, st, ld, _) in sorted(c.ptxas_table(log, c.fwd_name).items()):
            # K1's bf16 forward at the head dims of SHAPES
            if k.startswith(("flash_wgmma_kernel<", "flash_mma_kernel<")) and \
                    k.split("<")[1].split(",")[0].rstrip(">") in ("64", "128", "256"):
                print(f"  {k}: {regs} registers, {st}/{ld} bytes spilled")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if "--hold" in sys.argv:
        hold(torch, c)
    host_cost(torch, c, label)
    for name, case in SHAPES.items():
        timing(torch, c, label, name, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
