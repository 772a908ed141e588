#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. card: name and power limit (nvidia-smi), compute capability 9.0;
  2. build: every CUDA source of the port, compiled with nvcc, timed, with
     the registers and spills of every tensor-core kernel (none may spill
     at the serving shapes' instantiations: K1 at hd=64, the K2 kernels);
  3. the SSD-scan kernel against its plain PyTorch version on the card, at
     the JAX kernel tests' shapes and the serving shapes, fp32 and bf16
     (bf16 reaches the tensor-core kernels, fp32 the CUDA-core ones), and
     bf16 again through strided views cut from one (B, S, H*P + 2N) tensor,
     as the model passes them, equal bit for bit to the contiguous call;
  4. the kernel's time beside the plain version's and its bound (device
     time: calls captured in a CUDA graph and replayed between CUDA
     events; the eager back-to-back time, which the wrapper's Python can
     pace, printed beside);
  5. the main path: mamba2-370m at full width (48 layers, random weights
     from a seed, bf16 compute) serving 8 requests x 32 greedy tokens on 4
     slots through ServeEngine; the kernel's launch count (wrapper calls,
     three CUDA launches each in bf16) must be 48 per prefill;
 5b. where the time goes: host time of one prefill and of 8 decode steps,
     then the same work under torch.profiler for device time by kernel;
  6. card against CPU: the same weights (full width cut to 2 layers, fp32)
     give the same greedy tokens and close logits on both devices;
  7. the flash-attention kernel against its plain PyTorch version on the
     card, at the JAX kernel tests' shapes and at long shapes (the whisper
     encoder's, its decoder's teacher-forced one, a GQA and an hd=256
     windowed one), fp32 and bf16, and the bf16 tensor-core kernel at
     every head-dim class (16, 48, 80, 128, 144, 256) with ragged S, GQA 7,
     causal plus window; window=1 gives each row its own value;
  8. the kernel's time (bf16, measured as in 4) at the whisper encoder's
     shape and the three other long shapes, each beside its bound; at the
     encoder's shape and the causal 448 one also beside PyTorch's
     scaled_dot_product_attention (the library yardstick, timed here
     only), at the encoder's beside the plain version;
  9. the second path: whisper-small at full width (12 + 12 layers, random
     weights from a seed, bf16 compute) serving 4 requests of 1500 frames
     through make_prefill_step and 32 greedy make_decode_step steps; the
     kernel's launch count must be 12 per prefill; then where the time of
     one prefill and of 8 decode steps goes;
 10. card against CPU: whisper cut to 2 + 2 layers, fp32, the same weights
     give the same greedy tokens and close prefill, decode and teacher-forced
     forward logits on both devices.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a card, or without the repo's
sources beside it, the script fails before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): device memory and bf16/fp32 rates
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


MMA_KERNELS = ("flash_mma_kernel", "chunk_state_kernel", "state_pass_kernel",
               "chunk_scan_kernel")


def ptxas_report(log):
    """{tensor-core kernel name (with its head dim): [registers, spill store
    bytes, spill load bytes]} from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # mangled: <length><name>, then I Li<hd> E for a head-dim template
            k = re.search(r"\d(" + "|".join(MMA_KERNELS) + r")(ILi(\d+)E)?", m.group(1))
            name = k and k.group(1) + (f"<{k.group(3)}>" if k.group(3) else "")
            if name:
                out[name] = [0, 0, 0]
        elif name and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            out[name][1:] = [int(st), int(ld)]
        elif name and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def ssd_inputs(torch, case, dtype, seed=SEED):
    """The JAX kernel tests' input distribution, drawn on the card."""
    B, S, H, P, N, _ = case
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
    Bm = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    Cm = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    D = torch.linspace(0.2, 1.0, H, device="cuda")
    return x, dt.to(dtype).float(), A, Bm, Cm, D


def strided_views(torch, case, args):
    """x, Bm, Cm of `args` copied into one packed (B, S, H*P + 2N) tensor and
    cut from it as views, as models/mamba2.py passes the conv output."""
    B, S, H, P, N, _ = case
    x, dt, A, Bm, Cm, D = args
    packed = torch.cat([x.flatten(-2), Bm, Cm], -1)
    xs, Bs, Cs = packed.split([H * P, N, N], -1)
    return xs.unflatten(-1, (H, P)), dt, A, Bs, Cs, D


def ssd_work(case, dtype_name):
    """Bytes (each input read once, each output written once) and FLOPs of
    one scan, as counted for the bound."""
    B, S, H, P, N, chunk = case
    Q = min(chunk, S)
    nc = -(-S // Q)
    e = 2 if dtype_name == "bf16" else 4
    nbytes = (2 * B * S * H * P * e          # x in, y out
              + 2 * B * S * N * e            # B, C
              + B * S * H * 4 + 2 * H * 4    # dt, A, D
              + B * H * P * N * 4)           # final state
    flops = B * nc * (2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * N * P))
    return nbytes, flops


def flash_inputs(torch, case, dtype, seed=SEED):
    """q, k, v of the JAX flash tests' distribution (standard normal), drawn
    on the card, and the aligned positions."""
    B, S, Hq, Hkv, hd, _, _ = case
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device="cuda").to(dtype)
               for h in (Hq, Hkv, Hkv))
    pos = torch.arange(S, device="cuda")[None].expand(B, S)
    return q, k, v, pos


def flash_work(case, dtype_name):
    """Bytes (q, k, v read once, o written once) and FLOPs (QK^T and PV over
    the (query, key) pairs the mask keeps) of one call, for the bound."""
    B, S, Hq, Hkv, hd, causal, window = case
    e = 2 if dtype_name == "bf16" else 4
    nbytes = (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd) * e
    pairs = 0
    for i in range(S):
        lo = 0 if window is None else max(0, i - window + 1)
        pairs += (i + 1 if causal else S) - lo
    return nbytes, 4 * B * Hq * pairs * hd


def time_ms(torch, fn, iters, reps=7):
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def graph_ms(torch, fn, calls=20, reps=7):
    """Device time of one call of `fn`: `calls` calls captured in one CUDA
    graph, replayed between CUDA events (median of `reps`), so no host
    dispatch sits in the timed region. A wrapper whose Python takes longer
    than its kernels would make time_ms measure the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(torch, graph.replay, iters=1, reps=reps) / calls
    del graph
    return ms


def device_breakdown(torch, fn, reps=3):
    """Host ms of `fn` (median of `reps`, no profiler), then one run under
    torch.profiler: device ms and launches by kernel name. Returns
    (wall_ms, {name: ms}, {name: launches})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, counts = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            counts[e.name] = counts.get(e.name, 0) + 1
    return statistics.median(walls), by_name, counts


def kernel_share(by_name, counts, parts):
    """{part: (ms, launches)} summed over every kernel name containing part."""
    return {part: (sum(ms for k, ms in by_name.items() if part in k),
                   sum(n for k, n in counts.items() if part in k)) for part in parts}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.models.model import Model, init_cache
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap} devices {torch.cuda.device_count()}")
    check(cap == (9, 0), f"compute capability {cap}, want (9, 0)")

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    report = {k: v for log in logs.values() for k, v in ptxas_report(log).items()}
    for k, (regs, st, ld) in sorted(report.items()):
        print(f"  {k}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    if report:                      # nvcc ran (no library was built before)
        for k in ("flash_mma_kernel<64>",) + MMA_KERNELS[1:]:
            check(k in report and report[k][1:] == [0, 0], f"{k} has no spills")

    phase("3. SSD-scan kernel against its plain version")
    small = [(1, 32, 2, 8, 8, 8), (2, 64, 4, 16, 16, 16),
             (1, 100, 2, 16, 8, 32), (2, 128, 2, 32, 16, 128)]
    full = (1, 1024, 32, 64, 128, 128)
    serving = [full, (2, 1000, 32, 64, 128, 128), (1, 37, 32, 64, 128, 128)]
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    # small cases: the JAX kernel tests' abs+rel tolerances. Serving shapes:
    # errors of fp32 sums grow with the size of the terms, so y (fp32) and
    # the fp32 state are held to 3e-4 * max|ref|. y in bf16 is held element
    # by element to 1e-2 * |ref| + 3e-4 * max|ref|: both sides round the
    # same fp32 sums (apart by at most the fp32 bound) to bf16, whose step
    # is at most 2^-7 of the value, so they can land one step apart.
    err_full = None
    for case in small + serving:
        for dname in list(dtypes) + ["bf16 strided"]:
            dtype = dtypes[dname.split()[0]]
            args = ssd_inputs(torch, case, dtype)
            if dname == "bf16 strided":
                y_c, h_c = ssd_scan(*args, chunk=case[-1])
                args = strided_views(torch, case, args)
            y, h = ssd_scan(*args, chunk=case[-1])
            torch.cuda.synchronize()
            y0, h0 = ssd_chunked_ref(*args, chunk=case[-1])
            ey = (y.float() - y0.float()).abs().max().item()
            eh = (h - h0).abs().max().item()
            my, mh = y0.float().abs().max().item(), h0.abs().max().item()
            if dname == "bf16 strided":
                check(torch.equal(y, y_c) and torch.equal(h, h_c),
                      f"ssd_scan {case}: strided views give the contiguous call's y and state")
            if case in small:
                tol = 3e-4 if dname == "fp32" else 4e-2
                ok = (torch.allclose(y.float(), y0.float(), rtol=tol, atol=tol)
                      and torch.allclose(h, h0, rtol=tol, atol=tol))
                rule = f"allclose {tol:g}"
            else:
                ay, th = 3e-4 * max(1.0, my), 3e-4 * max(1.0, mh)
                if dname == "fp32":
                    ok_y, rule = ey <= ay, f"|dy|<={ay:.3g}"
                else:
                    dy = (y.float() - y0.float()).abs()
                    ok_y = bool((dy <= 1e-2 * y0.float().abs() + ay).all())
                    rule = f"|dy|<=1e-2|y|+{ay:.3g}"
                ok = ok_y and eh <= th
                rule += f" |dh|<={th:.3g}"
            print(f"  {case} {dname}: max|dy| {ey:.3g} (max|y| {my:.3g}), "
                  f"max|dh| {eh:.3g} (max|h| {mh:.3g}) [{rule}] {'ok' if ok else 'FAIL'}")
            check(ok, f"ssd_scan {case} {dname}")
            check(torch.isfinite(y).all().item() and torch.isfinite(h).all().item(),
                  f"ssd_scan {case} {dname} finite")
            if case == full and dname == "bf16 strided":
                err_full = ey

    phase("4. SSD-scan timing at the full-width prefill shape (bf16)")
    args = ssd_inputs(torch, full, torch.bfloat16)
    kc_ms = graph_ms(torch, lambda: ssd_scan(*args, chunk=128))
    args = strided_views(torch, full, args)          # as the model passes them
    k_ms = graph_ms(torch, lambda: ssd_scan(*args, chunk=128))
    ke_ms = time_ms(torch, lambda: ssd_scan(*args, chunk=128), iters=20)
    p_ms = graph_ms(torch, lambda: ssd_chunked_ref(*args, chunk=128), calls=5, reps=5)
    nbytes, flops = ssd_work(full, "bf16")
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  kernel {k_ms:.4f} ms on strided views ({kc_ms:.4f} ms on contiguous "
          f"tensors; eager back-to-back {ke_ms:.4f} ms), plain {p_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
          f"H100 SXM peaks), {bound_ms / k_ms:.1%} of the bound")
    # the model's entry point on the strided views: the three kernels and no copy
    _, _, counts = device_breakdown(torch, lambda: ssd_ops.ssd(*args, chunk=128), reps=1)
    others = [k for k in counts if not any(m in k for m in MMA_KERNELS[1:])]
    print(f"  ops.ssd on the strided views: {sum(counts.values())} device kernels, "
          f"{len(others)} besides the three K2 kernels")
    check(not others and sorted(counts.values()) == [1, 1, 1],
          "ops.ssd launches the three K2 kernels once each and copies nothing")

    phase("5. serve mamba2-370m at full width (48 layers, bf16 compute)")
    cfg = get_config("mamba2-370m")
    rt = Runtime()
    t0 = time.perf_counter()
    model = Model(cfg, rt, seed=SEED)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {sum(p.numel() for p in model.parameters()):,} params, "
          f"init {time.perf_counter() - t0:.2f} s")
    finite = []

    def watch(fn):
        def wrapped(*a):
            logits, cache = fn(*a)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return wrapped

    model.prefill = watch(model.prefill)
    model.decode_step = watch(model.decode_step)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 1025, size=8)
    check(any(n % 128 for n in lens), "some prompt lengths are not multiples of 128")
    n_new, slots = 32, 4
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    ServeEngine(cfg, rt, model, slots=slots, max_len=1100).run(
        [Request(rid=0, prompt=rng.integers(0, cfg.vocab, 64), max_new_tokens=2)])
    torch.cuda.synchronize()
    finite.clear()
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)), max_new_tokens=n_new)
            for i, n in enumerate(lens)]
    engine = ServeEngine(cfg, rt, model, slots=slots, max_len=1100)
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ssd_scan.launches
    check(flash_attention.launches == 0, "the mamba2 path runs no attention")
    n_tok = sum(len(v) for v in outs.values())
    print(f"  prompt lengths {lens.tolist()}")
    print(f"  {len(reqs)} requests, {slots} slots -> {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.1f} tok/s)")
    print(f"  prefill {1e3 * statistics.mean(engine.prefill_s):.2f} ms/request "
          f"(mean over {len(engine.prefill_s)}), decode "
          f"{1e3 * statistics.mean(engine.decode_s):.2f} ms/step "
          f"(mean over {len(engine.decode_s)} steps of {slots} slots), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  ssd_scan launches {launches} = {cfg.num_layers} x {engine.n_admits} prefills "
          "(wrapper calls; in bf16 each makes three CUDA launches, chunk_state_kernel, "
          "state_pass_kernel and chunk_scan_kernel)")
    check(sorted(outs) == list(range(len(reqs))), "every request returns")
    check(all(len(v) == n_new for v in outs.values()), f"{n_new} tokens per request")
    check(all(0 <= t < cfg.vocab for v in outs.values() for t in v), "tokens within vocab")
    check(len(finite) > 0 and all(bool(f) for f in finite), "every logit finite")
    check(launches == cfg.num_layers * engine.n_admits > 0,
          "one kernel launch per layer per prefill")

    phase("5b. where the time goes: one 512-token prefill, 8 decode steps of 4 slots")
    prompt512 = torch.as_tensor(rng.integers(0, cfg.vocab, 512), device="cuda")[None]
    cache4 = init_cache(cfg, rt, slots, 1100)
    last4 = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, 1)), device="cuda")
    windows = {
        "prefill": lambda: model.prefill(prompt512, init_cache(cfg, rt, 1, 1100)),
        "decode x8": lambda: [model.decode_step(last4, cache4) for _ in range(8)],
    }
    for name, fn in windows.items():
        wall_ms, by_name, counts = device_breakdown(torch, fn)
        dev_ms = sum(by_name.values())
        if not by_name:
            print(f"  {name}: host {wall_ms:.2f} ms; the profiler recorded no device "
                  "time (device share not measured)")
            continue
        print(f"  {name}: host {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
              f"({dev_ms / wall_ms:.1%}; idle {1 - dev_ms / wall_ms:.1%}), "
              f"{len(by_name)} kernel names")
        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {ms:8.3f} ms  {k[:90]}")
        k2 = kernel_share(by_name, counts, MMA_KERNELS[1:])
        k2_ms = sum(ms for ms, _ in k2.values())
        print("    K2 (" + " + ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in k2.items())
              + f") = {k2_ms:.3f} ms, {k2_ms / dev_ms:.1%} of device time; "
              f"{sum(n for k, n in counts.items() if 'copy' in k)} launches of copy kernels")

    phase("6. card against CPU on the same weights (2 layers, fp32)")
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    rt_cpu = Runtime(device="cpu", compute_dtype=torch.float32)
    rt_gpu = Runtime(device="cuda", compute_dtype=torch.float32)
    m_cpu = Model(cfg2, rt_cpu, seed=SEED + 1)
    m_gpu = Model(cfg2, rt_gpu, seed=None)
    m_gpu.load_state_dict(m_cpu.state_dict())
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, 300))[None]
    toks, worst, scale = {}, 0.0, 0.0
    logits_by = {}
    for name, m, rtx in (("cpu", m_cpu, rt_cpu), ("cuda", m_gpu, rt_gpu)):
        logits, cache = m.prefill(prompt.to(rtx.device), init_cache(cfg2, rtx, 1, 512))
        seq, all_logits = [], [logits.cpu()]
        for _ in range(4):
            seq.append(int(logits[0].argmax()))
            logits, cache = m.decode_step(torch.tensor([[seq[-1]]], device=rtx.device), cache)
            all_logits.append(logits.cpu())
        seq.append(int(logits[0].argmax()))
        toks[name], logits_by[name] = seq, all_logits
    for a, b in zip(logits_by["cpu"], logits_by["cuda"]):
        worst = max(worst, (a - b).abs().max().item())
        scale = max(scale, a.abs().max().item())
    # fp32 on both sides (no TF32): the sums differ only in order
    tol = 1e-4 * max(1.0, scale)
    print(f"  greedy cpu {toks['cpu']} cuda {toks['cuda']}; max|dlogits| {worst:.3g} "
          f"(max|logits| {scale:.3g}, tol {tol:.3g})")
    check(toks["cpu"] == toks["cuda"], "same greedy tokens on card and CPU")
    check(worst <= tol, "logits within tolerance")

    phase("7. flash-attention kernel against its plain version")
    flash_small = [(1, 64, 4, 4, 16, True, None), (2, 128, 4, 2, 32, True, None),
                   (1, 96, 8, 1, 16, True, None), (2, 128, 4, 4, 64, True, 32),
                   (1, 256, 2, 2, 16, False, None), (1, 80, 3, 1, 16, True, 24)]
    encoder = (4, 1500, 12, 12, 64, False, None)     # whisper-small's encoder
    flash_long = [encoder,
                  (4, 448, 12, 12, 64, True, None),  # its decoder, teacher-forced
                  (1, 2048, 14, 2, 64, True, None),  # qwen2-0.5b's heads (GQA 7)
                  (1, 1024, 8, 4, 256, True, 512)]   # gemma3-4b's head dim, windowed
    # small cases: the JAX flash tests' tolerances (abs and rel). Long shapes:
    # both sides compute the same fp32 function in another order (hd terms
    # per score, up to S terms per softmax sum), whose results differ by
    # ~1e-6 of the output's scale here, so fp32 is held to 1e-4 * max|ref|.
    # bf16 outputs are those fp32 values rounded to bf16, whose step is at
    # most 2^-7 of the value, so they can land one step apart: each element
    # is held to 1e-2 * |ref| + 1e-4 * max|ref|.
    err_flash = None
    for case in flash_small + flash_long:
        for dname, dtype in dtypes.items():
            q, k, v, pos = flash_inputs(torch, case, dtype)
            out = flash_attention(q, k, v, causal=case[5], window=case[6])
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6]).float()
            err = (out.float() - ref).abs()
            mref = ref.abs().max().item()
            if case in flash_small:
                tol = 2e-5 if dname == "fp32" else 2e-2
                ok = torch.allclose(out.float(), ref, rtol=tol, atol=tol)
                rule = f"allclose {tol:g}"
            elif dname == "fp32":
                ok, rule = err.max().item() <= 1e-4 * mref, f"|d|<={1e-4 * mref:.3g}"
            else:
                ok = bool((err <= 1e-2 * ref.abs() + 1e-4 * mref).all())
                rule = f"|d|<=1e-2|ref|+{1e-4 * mref:.3g}"
            print(f"  {case} {dname}: max|d| {err.max().item():.3g} (max|ref| {mref:.3g}) "
                  f"[{rule}] {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {case} {dname}")
            check(torch.isfinite(out).all().item(), f"flash_attention {case} {dname} finite")
            if case == encoder and dname == "bf16":
                err_flash = err.max().item()
    # the bf16 tensor-core kernel at every head-dim class (BK = 64 keys up to
    # hd = 128, 32 above; q in registers up to 128), S = 200 ragged against
    # the 64-row tiles, under the long shapes' bf16 rule
    mma_hds = (16, 48, 80, 128, 144, 256)
    for case in ([(2, 200, 7, 1, hd, True, 50) for hd in mma_hds]
                 + [(1, 200, 2, 2, hd, False, None) for hd in mma_hds]):
        q, k, v, pos = flash_inputs(torch, case, torch.bfloat16)
        out = flash_attention(q, k, v, causal=case[5], window=case[6])
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6]).float()
        err = (out.float() - ref).abs()
        mref = ref.abs().max().item()
        ok = bool((err <= 1e-2 * ref.abs() + 1e-4 * mref).all())
        print(f"  {case} bf16: max|d| {err.max().item():.3g} (max|ref| {mref:.3g}) "
              f"[|d|<=1e-2|ref|+{1e-4 * mref:.3g}] {'ok' if ok else 'FAIL'}")
        check(ok and torch.isfinite(out).all().item(), f"flash_attention {case} bf16")
    for dname, dtype in dtypes.items():
        q, k, v, _ = flash_inputs(torch, (1, 64, 2, 2, 16, True, 1), dtype)
        out = flash_attention(q, k, v, causal=True, window=1)
        check(torch.isfinite(out).all().item() and torch.equal(out, v),
              f"window=1 ({dname}): each row is its own value, finite")
    print("  window=1: finite, each row equals its own value (fp32, bf16)")

    phase("8. flash-attention timing at the long shapes (bf16)")
    for case in flash_long:
        causal, window = case[5], case[6]
        q, k, v, pos = flash_inputs(torch, case, torch.bfloat16)
        t_ms = graph_ms(torch, lambda: flash_attention(q, k, v, causal=causal, window=window))
        te_ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=causal, window=window),
                        iters=20)
        nbytes, flops = flash_work(case, "bf16")
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
        b_ms = max(t_bytes, t_ops)
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        line = (f"  {case}: kernel {t_ms:.4f} ms (eager back-to-back {te_ms:.4f} ms), "
                f"bound {b_ms:.5f} ms ({b_by}: "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; H100 SXM peaks), "
                f"{b_ms / t_ms:.1%} of the bound")
        if case[2] == case[3] and window is None:    # one plain SDPA call computes it
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # BHSD, beforehand
            l_ms = graph_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            line += f"; scaled_dot_product_attention {l_ms:.4f} ms"
            del qt, kt, vt
        if case == encoder:
            fp_ms = graph_ms(torch, lambda: attention_ref(q, k, v, pos, pos, causal=False),
                             calls=3, reps=5)
            line += f"; plain {fp_ms:.4f} ms"
            fk_ms, fl_ms, fbound_ms, fbound_by = t_ms, l_ms, b_ms, b_by
        print(line)
        del q, k, v

    phase("9. serve whisper-small at full width (12 + 12 layers, bf16 compute)")
    cfg_w = get_config("whisper-small")
    t0 = time.perf_counter()
    model_w = Model(cfg_w, rt, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model_w.parameters())
    print(f"  {cfg_w.name}: {n_params:,} params, init {time.perf_counter() - t0:.2f} s")
    check(n_params == cfg_w.param_count() == 238_143_744, "whisper-small parameter count")
    n_req, n_prompt, n_steps, max_len = 4, 4, 32, 448
    g = torch.Generator("cuda").manual_seed(SEED)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg_w.vocab, (n_req, n_prompt)),
                                       device="cuda"),
             "frames": torch.randn(n_req, cfg_w.encoder_len, cfg_w.d_model, generator=g,
                                   device="cuda")}
    prefill_step = make_prefill_step(cfg_w, rt, max_len)
    decode_step = make_decode_step(cfg_w, rt)

    def serve(n):
        """One prefill of the batch, then n greedy decode steps; returns the
        host seconds of each and the tokens (B, 1 + n) on the host."""
        t0 = time.perf_counter()
        logits, cache = prefill_step(model_w, batch)
        tok = logits.argmax(-1)[:, None]
        toks, fin = [tok.cpu()], [torch.isfinite(logits).all()]
        t_pre, t_dec = time.perf_counter() - t0, []
        for step in range(n):
            t0 = time.perf_counter()
            logits, cache = decode_step(model_w, tok, n_prompt + step, cache)
            tok = logits.argmax(-1)[:, None]
            toks.append(tok.cpu())
            t_dec.append(time.perf_counter() - t0)
            fin.append(torch.isfinite(logits).all())
        return t_pre, t_dec, torch.cat(toks, 1), all(bool(f) for f in fin)

    serve(2)                        # warm-up (cuBLAS handles, allocator), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = flash_attention.launches = 0
    t_pre, t_dec, toks, finite_w = serve(n_steps)
    torch.cuda.synchronize()
    launches_w = flash_attention.launches
    check(ssd_scan.launches == 0, "the whisper path runs no SSD scan")
    wall = t_pre + sum(t_dec)
    print(f"  {n_req} requests x {cfg_w.encoder_len} frames, prompt {n_prompt} tokens, "
          f"max_len {max_len}: prefill {1e3 * t_pre:.2f} ms per batch, decode "
          f"{1e3 * statistics.mean(t_dec):.2f} ms/step (mean of {n_steps}), "
          f"{toks.numel()} tokens in {wall:.3f} s ({toks.numel() / wall:.1f} tok/s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  flash_attention launches {launches_w} = {cfg_w.encoder_layers} x 1 prefill; "
          f"request 0 tokens {toks[0, :12].tolist()}...")
    check(toks.shape == (n_req, 1 + n_steps), f"{1 + n_steps} tokens per request")
    check(bool(((toks >= 0) & (toks < cfg_w.vocab)).all()), "tokens within vocab")
    check(finite_w, "every logit finite")
    check(launches_w == cfg_w.encoder_layers > 0, "one kernel launch per encoder layer per prefill")

    _, cache_w = prefill_step(model_w, batch)
    last_w = toks[:, -1:].to("cuda")
    windows_w = {
        "prefill": lambda: prefill_step(model_w, batch),
        "decode x8": lambda: [decode_step(model_w, last_w, n_prompt + i, cache_w)
                              for i in range(8)],
    }
    for name, fn in windows_w.items():
        wall_ms, by_name, counts = device_breakdown(torch, fn)
        dev_ms = sum(by_name.values())
        if not by_name:
            print(f"  {name}: host {wall_ms:.2f} ms; the profiler recorded no device time "
                  "(device share not measured)")
            continue
        k1, k1_n = kernel_share(by_name, counts, ("flash_mma_kernel",))["flash_mma_kernel"]
        print(f"  {name} (B={n_req}): host {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
              f"({dev_ms / wall_ms:.1%}; idle {1 - dev_ms / wall_ms:.1%}), "
              f"{len(by_name)} kernel names")
        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:8.3f} ms  {k[:90]}")
        print(f"    K1 flash_mma_kernel {k1:.3f} ms x{k1_n}, {k1 / dev_ms:.1%} of device time")
    del model_w

    phase("10. card against CPU on the same weights (whisper, 2 + 2 layers, fp32)")
    cfg_w2 = dataclasses.replace(cfg_w, num_layers=2, encoder_layers=2)
    w_cpu = Model(cfg_w2, rt_cpu, seed=SEED + 1)
    w_gpu = Model(cfg_w2, rt_gpu, seed=None)
    w_gpu.load_state_dict(w_cpu.state_dict())
    frames = torch.from_numpy(
        rng.standard_normal((1, cfg_w2.encoder_len, cfg_w2.d_model)).astype(np.float32))
    prompt = torch.as_tensor(rng.integers(0, cfg_w2.vocab, (1, 4)))
    teacher = torch.as_tensor(rng.integers(0, cfg_w2.vocab, (1, 16)))
    res = {}
    for name, m, rtx in (("cpu", w_cpu, rt_cpu), ("cuda", w_gpu, rt_gpu)):
        dev = rtx.device
        flash_attention.launches = 0
        logits, cache = make_prefill_step(cfg_w2, rtx, 64)(
            m, {"tokens": prompt.to(dev), "frames": frames.to(dev)})
        seq, all_logits = [], [logits.cpu()]
        for step in range(4):
            seq.append(int(logits[0].argmax()))
            logits, cache = make_decode_step(cfg_w2, rtx)(
                m, torch.tensor([[seq[-1]]], device=dev), 4 + step, cache)
            all_logits.append(logits.cpu())
        seq.append(int(logits[0].argmax()))
        fwd = m(teacher.to(dev), frames=frames.to(dev)).cpu()
        res[name] = (seq, torch.stack(all_logits), fwd, flash_attention.launches)
    worst = (res["cpu"][1] - res["cuda"][1]).abs().max().item()
    scale = res["cpu"][1].abs().max().item()
    worst_f = (res["cpu"][2] - res["cuda"][2]).abs().max().item()
    scale_f = res["cpu"][2].abs().max().item()
    # fp32 on both sides (no TF32): the sums differ only in order
    tol, tol_f = 1e-4 * max(1.0, scale), 1e-4 * max(1.0, scale_f)
    print(f"  greedy cpu {res['cpu'][0]} cuda {res['cuda'][0]}; prefill+decode "
          f"max|dlogits| {worst:.3g} (max|logits| {scale:.3g}, tol {tol:.3g}); forward "
          f"max|dlogits| {worst_f:.3g} (max|logits| {scale_f:.3g}, tol {tol_f:.3g}); "
          f"kernel launches on the card {res['cuda'][3]} (2 encoder x 2 calls + 2 causal "
          "decoder layers)")
    check(res["cpu"][0] == res["cuda"][0], "same greedy tokens on card and CPU")
    check(worst <= tol and worst_f <= tol_f, "logits within tolerance")
    check(res["cpu"][3] == 0 and res["cuda"][3] == 2 * 2 + 2, "kernel launches on the card only")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    record = {"kernels": [{
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
        "launches": launches,
        "max_abs_err": err_full,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,     # no single PyTorch call computes the SSD scan
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        "launches": launches_w,
        "max_abs_err": err_flash,
        "ms": fk_ms,
        "plain_ms": fp_ms,
        "bound_ms": fbound_ms,
        "bound_by": fbound_by,
        "library_ms": fl_ms,    # scaled_dot_product_attention, timed only
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
