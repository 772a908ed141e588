#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. card: name and power limit (nvidia-smi), compute capability 9.0;
  2. build: every CUDA source of the port, compiled with nvcc, timed, with
     the registers and spills of every tensor-core kernel (none may spill
     at the serving shapes' instantiations: K1 at hd=64, 128 and 256, the K2
     kernels);
  3. the SSD-scan kernel against its plain PyTorch version on the card, at
     the JAX kernel tests' shapes and the serving shapes (mamba2-370m's and
     zamba2-1.2b's: H=64, N=64, S=1024, a ragged 1000 and its forward's
     4096), fp32 and bf16 (bf16 reaches the tensor-core kernels, fp32 the
     CUDA-core ones), and bf16 again through strided views cut from one
     (B, S, H*P + 2N) tensor, as the model passes them, equal bit for bit to
     the contiguous call;
  4. the kernel's time at mamba2's S=1024 prefill shape and zamba2's S=1024
     and S=4096 shapes beside the plain version's and its bound (device
     time: calls captured in a CUDA graph and replayed between CUDA
     events; the eager back-to-back time, which the wrapper's Python can
     pace, printed beside);
  5. the main path: mamba2-370m at full width (48 layers, random weights
     from a seed, bf16 compute) serving 8 requests x 32 greedy tokens on 4
     slots through ServeEngine; the kernel's launch count (wrapper calls,
     three CUDA launches each in bf16) must be 48 per prefill; then the
     kernel is held against its plain version (bf16, contiguous and
     strided, phase 3's rule) and timed at every shape the path ran;
 5b. where the time goes: host time of one prefill and of 8 decode steps,
     then the same work under torch.profiler for device time by kernel;
  6. card against CPU: the same weights (full width cut to 2 layers, fp32)
     give the same greedy tokens and close logits on both devices;
  7. the flash-attention kernel against its plain PyTorch version on the
     card, at the JAX kernel tests' shapes and at long shapes (the whisper
     encoder's, its decoder's teacher-forced one, a GQA and an hd=256
     windowed one), fp32 and bf16, and the bf16 tensor-core kernel at
     every head-dim class (16, 48, 80, 128, 144, 256) with ragged S, GQA 7,
     causal plus window; window=1 gives each row its own value; bf16 at the
     four full-sequence forward shapes of the decoder paths (gemma3-4b's
     local and global layers, mixtral-8x7b's, zamba2-1.2b's shared block:
     MHA, 32 heads of 64, causal, 4096 tokens);
  8. the kernel's time (bf16, measured as in 4) at the whisper encoder's
     shape, the three other long shapes and the four decoder forward
     shapes, each beside its bound; at the encoder's shape, the causal 448
     one and the decoder shapes also beside PyTorch's
     scaled_dot_product_attention (the library yardstick, timed here only;
     the windowed shape gets a boolean mask, and is also timed causal
     without its window; the backend SDPA picks is printed), at the
     encoder's and the decoder shapes beside the plain version;
  9. the second path: whisper-small at full width (12 + 12 layers, random
     weights from a seed, bf16 compute) serving 4 requests of 1500 frames
     through make_prefill_step and 32 greedy make_decode_step steps; the
     kernel's launch count must be 12 per prefill; then where the time of
     one prefill and of 8 decode steps goes;
 10. card against CPU: whisper cut to 2 + 2 layers, fp32, the same weights
     give the same greedy tokens and close prefill, decode and teacher-forced
     forward logits on both devices;
 11. the third path: gemma3-4b at full width (34 layers, 8/4 heads of 256,
     window 1024 on 29 local layers; random weights from a seed, bf16
     compute): (a) Model.forward and loss_fn over one 4096-token sequence,
     34 kernel launches per forward; (b) ServeEngine serving 8 requests
     (prompts of 64-2048 tokens, 32 greedy tokens each) on 4 slots with
     max_len 4096, no kernel launch; (c) make_prefill_step/make_decode_step,
     4 prompts of 512, max_len 8192, 8 decode steps at a scalar position,
     which take the windowed decode branch on every local layer; then where
     the time of a 2048-token prefill, 8 engine decode steps and the forward
     goes;
 12. the fourth path: mixtral-8x7b at full width cut to 4 of its 32 layers
     (46.7 B parameters do not fit one card): (a) and (b) as in 11, 4
     kernel launches per forward, the (token, choice) pairs the capacity
     dropped counted; then where the time goes;
 13. card against CPU, fp32, the same weights: gemma3 cut to 6 layers (one
     local:global period) and mixtral cut to 1; the same greedy tokens,
     prefill, decode and forward logits within 1e-4 * max(1, max|logits|),
     the kernel launched on the card only;
 14. the fifth path: zamba2-1.2b at full width (38 SSM layers, the shared
     attention block after every 6: 6 applications; random weights from a
     seed, bf16 compute): (a) and (b) as in 11, with 6 K1 launches and 38
     K2 calls per forward and 38 K2 calls per admission; (c) replay_trace of
     a bursty two-tenant trace (12 requests, prompts of 64-512, outputs of
     8-32) on 4 slots under preempt, whose admit steps, finish steps and
     preemptions must equal core.traces.trace_schedule's bit for bit; K2
     held and timed at every shape (a)-(c) ran, as in 5; then where the
     time goes;
 15. the sixth path: paligemma-3b at full width (18 layers, 8/1 heads of
     256, vocab 257216, 256 patch embeddings from a seed standing in for
     SigLIP's): (a) forward and loss_fn over 256 patches + 3840 text
     tokens, (b) make_prefill_step/make_decode_step, 4 requests of 256
     patches + 64 tokens, 32 greedy steps; the prefix-LM mask stays on the
     plain path, so no kernel launches; then where the time goes;
 16. card against CPU, fp32, the same weights: zamba2 cut to 7 layers (one
     application and one layer left over) and paligemma cut to 2; the same
     greedy tokens, prefill, decode and forward logits within
     1e-4 * max(1, max|logits|), the kernels launched on the card only.
The line before the last is the kernels' JSON record: the SSD scan once per
path and shape it ran (mamba2-370m's prefills; zamba2-1.2b's forward,
prefills and replay) and the flash-attention kernel
once per path and shape (the whisper encoder, gemma3-4b's local and global
layers, mixtral-8x7b, zamba2-1.2b), each with the launches of its path's run
and the error and times at its shape; the last line is
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


def hold_ssd(torch, case, dname, small=False):
    """Call the SSD-scan kernel at `case` in `dname` ("fp32", "bf16", or
    "bf16 strided": through strided views, required equal bit for bit to
    the contiguous call) and hold it against its plain version. Small cases
    take the JAX kernel tests' abs+rel tolerances. Other shapes: errors of
    fp32 sums grow with the size of the terms, so y (fp32) and the fp32
    state are held to 3e-4 * max|ref|. y in bf16 is held element by element
    to 1e-2 * |ref| + 3e-4 * max|ref|: both sides round the same fp32 sums
    (apart by at most the fp32 bound) to bf16, whose step is at most 2^-7
    of the value, so they can land one step apart. Returns max|dy|."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    dtype = torch.float32 if dname == "fp32" else torch.bfloat16
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
    if small:
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
    return ey


def time_ssd(torch, case, verbose=True):
    """The SSD-scan kernel's device time in bf16 at `case` through the
    strided views (as the model passes them), the plain version's, and the
    bound; with `verbose`, the contiguous call's and the eager times beside.
    Returns the kernels record's numbers at that shape but the error."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    args = ssd_inputs(torch, case, torch.bfloat16)
    kc_ms = graph_ms(torch, lambda: ssd_scan(*args, chunk=case[-1])) if verbose else None
    args = strided_views(torch, case, args)
    k_ms = graph_ms(torch, lambda: ssd_scan(*args, chunk=case[-1]))
    p_ms = graph_ms(torch, lambda: ssd_chunked_ref(*args, chunk=case[-1]), calls=5, reps=5)
    nbytes, flops = ssd_work(case, "bf16")
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    line = f"  {case}: kernel {k_ms:.4f} ms on strided views"
    if verbose:
        ke_ms = time_ms(torch, lambda: ssd_scan(*args, chunk=case[-1]), iters=20)
        line += f" ({kc_ms:.4f} ms on contiguous tensors; eager back-to-back {ke_ms:.4f} ms)"
    print(line + f", plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; H100 SXM peaks), "
          f"{bound_ms / k_ms:.1%} of the bound")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}           # no single PyTorch call computes the SSD scan


def ssd_at_path_shapes(torch, arch, path, by_case, held):
    """Hold the SSD-scan kernel (bf16 and bf16 through strided views, the
    serving rule of phase 3) against its plain version at every shape
    `path` ran (`by_case`: ssd_scan.launches_by_case of its run) and time
    it there. `held` maps the shapes checked and timed before to their
    record numbers and gains the new ones. Returns the kernels record's K2
    entries of this path, one per shape ("ssd_scan/<arch> S=<S>"), each with
    its launches."""
    print(f"  K2 at every shape of the {path} path: {len(by_case)} shapes, "
          f"{sum(by_case.values())} wrapper calls")
    entries = []
    for case in sorted(by_case):
        if case not in held:
            err = max(hold_ssd(torch, case, d) for d in ("bf16", "bf16 strided"))
            held[case] = {"max_abs_err": err, **time_ssd(torch, case, verbose=False)}
        entries.append({
            "name": f"ssd_scan/{arch} S={case[1]}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
            "path": path,
            "shape": "(B, S, H, P, N, chunk) = " + str(case),
            "launches": by_case[case],
            **held[case],
        })
    return entries


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


def print_breakdown(torch, name, fn, k1_name="flash_mma_kernel"):
    """Host ms of `fn`, its device time by kernel and its idle share (as in
    phase 5b), with K1's share. Returns (host ms, device ms)."""
    wall_ms, by_name, counts = device_breakdown(torch, fn)
    dev_ms = sum(by_name.values())
    if not by_name:
        print(f"  {name}: host {wall_ms:.2f} ms; the profiler recorded no device time "
              "(device share not measured)")
        return wall_ms, None
    k1, k1_n = kernel_share(by_name, counts, (k1_name,))[k1_name]
    k2 = kernel_share(by_name, counts, MMA_KERNELS[1:])
    k2_ms = sum(ms for ms, _ in k2.values())
    print(f"  {name}: host {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
          f"({dev_ms / wall_ms:.1%}; idle {1 - dev_ms / wall_ms:.1%}), "
          f"{len(by_name)} kernel names, {sum(counts.values())} launches")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:8.3f} ms x{counts[k]:<5d} {k[:90]}")
    print(f"    K1 {k1_name} {k1:.3f} ms x{k1_n}, {k1 / dev_ms:.1%} of device time; K2 "
          + " + ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in k2.items())
          + f" = {k2_ms:.3f} ms, {k2_ms / dev_ms:.1%}")
    return wall_ms, dev_ms


def router_probs(model, tokens):
    """Layer 0's router probabilities (T, E) over the forward of `tokens`,
    recomputed through the port's own functions: phase 13 reports from them
    the MoE choices that differ between the devices."""
    from repro_torch.models import encdec, moe
    from repro_torch.models.attention import self_attention
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import layer_windows
    cfg, rt, p_l = model.cfg, model.rt, model.layers[0]
    x = model._embed(tokens)
    positions = encdec.iota_positions(*tokens.shape, tokens.device)
    h = rmsnorm(x, p_l.ln1, cfg.norm_eps)
    x = x + self_attention(h, p_l.attn, cfg, rt, positions,
                           window=layer_windows(cfg, 1)[0])
    h = rmsnorm(x, p_l.ln2, cfg.norm_eps)
    return moe.route(h.reshape(-1, cfg.d_model), p_l.moe, cfg, rt).probs


def decoder_path(cfg, rt, count_drops=False):
    """(a) Model.forward and loss_fn over one (1, 4096) sequence, K1 once per
    attention layer per forward (the hybrid: once per application of its
    shared block, and K2 once per SSM layer); (b) ServeEngine: 8 requests
    with prompt lengths from seed 0 in 64-2048, 32 greedy tokens each, 4
    slots, max_len 4096, no K1 (the hybrid: K2 once per SSM layer per
    admission). The launch counts are set to 0 before (a) and read after
    (b). With `count_drops`, the (token, choice) pairs that the forward's MoE
    capacity dropped are counted (`moe_mlp.dropped`). Returns (model, K1
    launches by case, K2 wrapper calls by case)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.models import moe
    from repro_torch.models.hybrid import n_applications
    from repro_torch.models.model import Model, loss_fn
    from repro_torch.serve.engine import Request, ServeEngine
    is_hybrid = cfg.family == "hybrid"
    k1_fwd = n_applications(cfg) if is_hybrid else cfg.num_layers
    k2_fwd = cfg.num_layers if is_hybrid else 0
    t0 = time.perf_counter()
    model = Model(cfg, rt, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {n_params:,} params ({n_params * 4 / 1e9:.1f} GB fp32), "
          f"init {time.perf_counter() - t0:.2f} s")
    check(n_params == cfg.param_count(), "parameter count")
    rng = np.random.default_rng(SEED)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 4097)), device="cuda")
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    slots, n_new, max_len = 4, 32, 4096
    # warm-up (cuBLAS, allocator), not counted
    model(batch["tokens"][:, :256])
    ServeEngine(cfg, rt, model, slots=slots, max_len=max_len).run(
        [Request(rid=0, prompt=rng.integers(0, cfg.vocab, 64), max_new_tokens=2)])
    torch.cuda.synchronize()
    flash_attention.launches, flash_attention.launches_by_case = 0, {}
    ssd_scan.launches, ssd_scan.launches_by_case = 0, {}
    moe.moe_mlp.dropped = 0
    t0 = time.perf_counter()
    logits = model(batch["tokens"])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    drops = int(moe.moe_mlp.dropped)
    per_fwd, per_fwd_k2 = flash_attention.launches, ssd_scan.launches
    fin = torch.isfinite(logits).all().item()
    del logits
    t0 = time.perf_counter()
    loss, met = loss_fn(model, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t0) * 1e3
    print(f"  (a) forward over (1, 4096): {fwd_ms:.1f} ms host, K1 launches {per_fwd} "
          f"(= {k1_fwd} attention layers), K2 wrapper calls {per_fwd_k2} (= {k2_fwd} SSM "
          f"layers); loss_fn {loss_ms:.1f} ms: loss {loss.item():.4f}, "
          f"ce {met['ce'].item():.4f} (ln V = {np.log(cfg.vocab):.4f}), aux {met['aux'].item():.4f}")
    if count_drops:
        E, K = cfg.moe.num_experts, cfg.moe.top_k
        cap = min(max(1, int(cfg.moe.capacity_factor * K * 4096 / E)), 4096)
        print(f"    capacity {cap} slots per expert per layer (T = 4096 > 256): {drops} of "
              f"{K * 4096 * cfg.num_layers} (token, choice) pairs dropped over "
              f"{cfg.num_layers} layers")
    check(per_fwd == k1_fwd, "K1 once per attention layer per forward")
    check(flash_attention.launches == 2 * k1_fwd, "K1 once per attention layer in loss_fn's "
          "forward")
    check(per_fwd_k2 == k2_fwd and ssd_scan.launches == 2 * k2_fwd,
          "K2 once per SSM layer per forward, in loss_fn's too")
    check(fin and bool(torch.isfinite(loss)), "finite logits and loss")

    finite = []

    def watch(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            finite.append(torch.isfinite(out[0]).all())
            return out
        return wrapped

    model.prefill, model.decode_step = watch(model.prefill), watch(model.decode_step)
    lens = np.random.default_rng(SEED).integers(64, 2049, size=8)
    finite.clear()
    before, before_k2 = flash_attention.launches, ssd_scan.launches
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)), max_new_tokens=n_new)
            for i, n in enumerate(lens)]
    engine = ServeEngine(cfg, rt, model, slots=slots, max_len=max_len)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in outs.values())
    print(f"  (b) prompt lengths {lens.tolist()}; {len(reqs)} requests, {slots} slots, max_len "
          f"{max_len} -> {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s); prefill "
          f"{1e3 * statistics.mean(engine.prefill_s):.2f} ms/request (mean of "
          f"{len(engine.prefill_s)}), decode {1e3 * statistics.mean(engine.decode_s):.2f} ms/step "
          f"(mean of {len(engine.decode_s)}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
          f"{flash_attention.launches - before}, K2 wrapper calls "
          f"{ssd_scan.launches - before_k2} (= {k2_fwd} x {engine.n_admits} admissions)")
    del model.prefill, model.decode_step                 # back to the methods
    check(sorted(outs) == list(range(len(reqs))), "every request returns")
    check(all(len(v) == n_new for v in outs.values()), f"{n_new} tokens per request")
    check(all(0 <= t < cfg.vocab for v in outs.values() for t in v), "tokens within vocab")
    check(len(finite) > 0 and all(bool(f) for f in finite), "every logit finite")
    check(flash_attention.launches == before, "serving (prefill, decode) launches no K1")
    check(ssd_scan.launches - before_k2 == k2_fwd * engine.n_admits,
          "K2 once per SSM layer per admission, none in a decode step")
    return (model, dict(flash_attention.launches_by_case),
            dict(ssd_scan.launches_by_case))


def decoder_breakdown(model, cfg, rt):
    """Where the time goes: one 2048-token prefill (B=1, max_len 4096), 8
    engine-style decode steps (4 slots, per-slot positions), the forward
    over (1, 4096)."""
    import numpy as np
    import torch
    from repro_torch.models.model import init_cache
    rng = np.random.default_rng(SEED + 2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 2048)), device="cuda")
    seq = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 4096)), device="cuda")
    cache4 = init_cache(cfg, rt, 4, 4096)
    last4 = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 1)), device="cuda")
    pos4 = torch.tensor([700, 1500, 2300, 3100], dtype=torch.int32, device="cuda")
    print_breakdown(torch, "prefill, 2048 tokens", lambda: model.prefill(
        prompt, init_cache(cfg, rt, 1, 4096)))
    print_breakdown(torch, "8 decode steps, 4 slots", lambda: [
        model.decode_step(last4, cache4, pos=pos4 + i) for i in range(8)])
    print_breakdown(torch, "forward, (1, 4096)", lambda: model(seq))


def main() -> int:
    import numpy as np
    import torch
    from torch.nn.attention import SDPBackend

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import traces
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.models import attention
    from repro_torch.models.model import Model, init_cache, loss_fn
    from repro_torch.models.runtime import Runtime
    from repro_torch.models.transformer import layer_windows
    from repro_torch.serve.engine import Request, ServeEngine, replay_trace
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
        for k in ("flash_mma_kernel<64>", "flash_mma_kernel<128>",
                  "flash_mma_kernel<256>") + MMA_KERNELS[1:]:
            check(k in report and report[k][1:] == [0, 0], f"{k} has no spills")

    phase("3. SSD-scan kernel against its plain version")
    small = [(1, 32, 2, 8, 8, 8), (2, 64, 4, 16, 16, 16),
             (1, 100, 2, 16, 8, 32), (2, 128, 2, 32, 16, 128)]
    full = (1, 1024, 32, 64, 128, 128)
    zamba2_ssd = (1, 1024, 64, 64, 64, 128)       # zamba2-1.2b: H = 64, N = 64
    zamba2_fwd = (1, 4096, 64, 64, 64, 128)       # its forward over 4096 tokens
    serving = [full, (2, 1000, 32, 64, 128, 128), (1, 37, 32, 64, 128, 128),
               zamba2_ssd, (1, 1000, 64, 64, 64, 128), zamba2_fwd]
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    err_ssd = {}
    for case in small + serving:
        for dname in ("fp32", "bf16", "bf16 strided"):
            ey = hold_ssd(torch, case, dname, small=case in small)
            if case in serving and dname == "bf16 strided":
                err_ssd[case] = ey

    phase("4. SSD-scan timing at the prefill and forward shapes of mamba2 and zamba2 (bf16)")
    ssd_timed = {}      # case -> the kernels record's numbers at that shape
    for case in (full, zamba2_ssd, zamba2_fwd):
        ssd_timed[case] = {"max_abs_err": err_ssd[case], **time_ssd(torch, case)}
        # the model's entry point on the strided views: the three kernels and no copy
        args = strided_views(torch, case, ssd_inputs(torch, case, torch.bfloat16))
        _, _, counts = device_breakdown(torch, lambda: ssd_ops.ssd(*args, chunk=128), reps=1)
        others = [k for k in counts if not any(m in k for m in MMA_KERNELS[1:])]
        print(f"    ops.ssd on the strided views: {sum(counts.values())} device kernels, "
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
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
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
    ssd_scan.launches_by_case = {}
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_case_k2 = ssd_scan.launches, dict(ssd_scan.launches_by_case)
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
    k2_record = ssd_at_path_shapes(torch, cfg.name, "mamba2-370m serving (phase 5)",
                                   by_case_k2, ssd_timed)

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
    # the full-sequence forwards' shapes, bf16 only (their paths compute in
    # bf16): gemma3-4b's local layers and its global ones, mixtral-8x7b's
    gemma3_local, gemma3_global = (1, 4096, 8, 4, 256, True, 1024), (1, 4096, 8, 4, 256, True, None)
    mixtral = (1, 4096, 32, 8, 128, True, 4096)
    zamba2_attn = (1, 4096, 32, 32, 64, True, None)  # zamba2-1.2b's shared block (MHA)
    flash_decoder = [gemma3_local, gemma3_global, mixtral, zamba2_attn]
    err_by_case = {}
    # small cases: the JAX flash tests' tolerances (abs and rel). Long shapes:
    # both sides compute the same fp32 function in another order (hd terms
    # per score, up to S terms per softmax sum), whose results differ by
    # ~1e-6 of the output's scale here, so fp32 is held to 1e-4 * max|ref|.
    # bf16 outputs are those fp32 values rounded to bf16, whose step is at
    # most 2^-7 of the value, so they can land one step apart: each element
    # is held to 1e-2 * |ref| + 1e-4 * max|ref|.
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
                err_by_case[case] = err.max().item()
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
    for case in flash_decoder:
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
        err_by_case[case] = err.max().item()
        del q, k, v, out, ref, err
    for dname, dtype in dtypes.items():
        q, k, v, _ = flash_inputs(torch, (1, 64, 2, 2, 16, True, 1), dtype)
        out = flash_attention(q, k, v, causal=True, window=1)
        check(torch.isfinite(out).all().item() and torch.equal(out, v),
              f"window=1 ({dname}): each row is its own value, finite")
    print("  window=1: finite, each row equals its own value (fp32, bf16)")

    phase("8. flash-attention timing at the long shapes (bf16)")
    timed = {}       # case -> the kernels record's numbers at that shape
    for case in flash_long + flash_decoder:
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
        if (case[2] == case[3] and window is None) or case in flash_decoder:
            # one SDPA call computes it: BHSD copies (KV heads repeated for
            # GQA) made beforehand; a window that cuts keys off becomes a
            # boolean mask, one that does not (mixtral: 4096 >= S) is causal
            rep = case[2] // case[3]
            qt, kt, vt = (t.repeat_interleave(r, 2).transpose(1, 2).contiguous()
                          for t, r in ((q, 1), (k, rep), (v, rep)))
            mask = None
            if window is not None and window < case[1]:
                i = torch.arange(case[1], device="cuda")
                mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
            line += "; scaled_dot_product_attention "
            if case in flash_decoder:
                # eager: at these shapes a call takes far longer than its dispatch
                l_ms = time_ms(torch, sdpa, iters=10)
                backend = SDPBackend(torch._fused_sdp_choice(
                    qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)).name
                _, by_name, _ = device_breakdown(torch, sdpa, reps=1)
                top = max(by_name, key=by_name.get)[:60] if by_name else "not recorded"
                line += (f"{l_ms:.4f} ms ({'boolean mask' if mask is not None else 'is_causal'}; "
                         f"backend {backend}, its largest kernel: {top})")
                if mask is not None:
                    # the mask keeps SDPA off its flash kernels and skips no
                    # tile; causal without the window does more work than
                    # asked (every key up to the query) on a flash kernel
                    c_ms = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), iters=10)
                    line += f"; SDPA is_causal without the window {c_ms:.4f} ms"
            else:
                l_ms = graph_ms(torch, sdpa)
                line += f"{l_ms:.4f} ms"
            del qt, kt, vt, mask
        if case == encoder or case in flash_decoder:
            pl_ms = graph_ms(torch, lambda: attention_ref(q, k, v, pos, pos, causal=causal,
                                                          window=window), calls=3, reps=5)
            line += f"; plain {pl_ms:.4f} ms"
        if case == encoder or case in flash_decoder:
            timed[case] = {"ms": t_ms, "plain_ms": pl_ms, "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": l_ms}      # scaled_dot_product_attention, timed only
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
    flash_attention.launches_by_case = {}
    t_pre, t_dec, toks, finite_w = serve(n_steps)
    torch.cuda.synchronize()
    launches_w = flash_attention.launches
    check(flash_attention.launches_by_case == {encoder: launches_w},
          "every launch of the whisper path at the encoder's shape (timed in phase 8)")
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

    phase("11. gemma3-4b at full width (34 layers, bf16 compute)")
    del model, m_cpu, m_gpu, cache4, cache_w, w_cpu, w_gpu   # the earlier paths' weights
    torch.cuda.empty_cache()
    cfg_g = get_config("gemma3-4b")
    check(cfg_g.param_count() == 3_879_907_840, "gemma3-4b parameter count")
    model_g, by_case_g, by_case_k2 = decoder_path(cfg_g, rt)
    check(by_case_k2 == {}, "the gemma3 path runs no SSD scan")
    check(by_case_g == {gemma3_local: 2 * 29, gemma3_global: 2 * 5},
          "forward and loss_fn launch K1 at the two shapes timed in phase 8: 29 local "
          "and 5 global layers each")
    # (c) the serve steps at a scalar position: the windowed decode branch
    n_local = sum(w is not None for w in layer_windows(cfg_g, cfg_g.num_layers))
    tokens_c = torch.as_tensor(rng.integers(0, cfg_g.vocab, (4, 512)), device="cuda")
    prefill_c, decode_c = make_prefill_step(cfg_g, rt, 8192), make_decode_step(cfg_g, rt)
    before, slices = flash_attention.launches, attention.cached_attention.window_slices
    t0 = time.perf_counter()
    logits, cache_c = prefill_c(model_g, {"tokens": tokens_c})
    tok = logits.argmax(-1)[:, None]
    toks, fin, t_pre, t_dec = [tok.cpu()], [torch.isfinite(logits).all()], None, []
    t_pre = time.perf_counter() - t0
    for step in range(8):
        t0 = time.perf_counter()
        logits, cache_c = decode_c(model_g, tok, 512 + step, cache_c)
        tok = logits.argmax(-1)[:, None]
        toks.append(tok.cpu())
        t_dec.append(time.perf_counter() - t0)
        fin.append(torch.isfinite(logits).all())
    slices = attention.cached_attention.window_slices - slices
    print(f"  (c) make_prefill_step, 4 x 512 tokens, max_len 8192: {1e3 * t_pre:.2f} ms; 8 "
          f"make_decode_step steps at scalar positions 512..519: "
          f"{1e3 * statistics.mean(t_dec):.2f} ms/step; windowed decode branch taken "
          f"{slices} times (= {n_local} local layers x 8 steps); K1 launches "
          f"{flash_attention.launches - before}; request 0 tokens "
          f"{torch.cat(toks, 1)[0].tolist()}")
    check(slices == n_local * 8 and n_local == 29, "the windowed branch on every local layer")
    check(flash_attention.launches == before, "the serve steps launch no K1")
    check(all(bool(f) for f in fin), "every logit finite")
    del cache_c
    decoder_breakdown(model_g, cfg_g, rt)
    del model_g
    torch.cuda.empty_cache()

    phase("12. mixtral-8x7b at full width, 4 of its 32 layers (bf16 compute)")
    cfg_full = get_config("mixtral-8x7b")
    cfg_m = dataclasses.replace(cfg_full, num_layers=4)
    print(f"  depth cut: {cfg_full.param_count():,} parameters at 32 layers "
          f"({cfg_full.param_count() * 4 / 1e9:.0f} GB fp32, "
          f"{cfg_full.param_count() * 2 / 1e9:.0f} GB bf16) do not fit one card's 80 GB; "
          "4 layers keep every width")
    model_m, by_case_m, by_case_k2 = decoder_path(cfg_m, rt, count_drops=True)
    check(by_case_k2 == {}, "the mixtral path runs no SSD scan")
    check(by_case_m == {mixtral: 2 * 4}, "forward and loss_fn launch K1 at the shape timed "
          "in phase 8, once per layer each")
    decoder_breakdown(model_m, cfg_m, rt)
    del model_m
    torch.cuda.empty_cache()

    phase("13. card against CPU on the same weights (gemma3 6 layers, mixtral 1 layer, fp32)")
    for cfg_c, n_prompt in ((dataclasses.replace(cfg_g, num_layers=6), 1100),
                            (dataclasses.replace(cfg_full, num_layers=1), 300)):
        t0 = time.perf_counter()
        m_gpu = Model(cfg_c, rt_gpu, seed=SEED + 3)
        m_cpu = Model(cfg_c, rt_cpu, seed=None)
        m_cpu.load_state_dict(m_gpu.state_dict())
        prompt = torch.as_tensor(rng.integers(0, cfg_c.vocab, (1, n_prompt)))
        res = {}
        for name, m, rtx in (("cpu", m_cpu, rt_cpu), ("cuda", m_gpu, rt_gpu)):
            dev = rtx.device
            flash_attention.launches = 0
            logits, cache = m.prefill(prompt.to(dev), init_cache(cfg_c, rtx, 1, 4096))
            seq, all_logits = [], [logits.cpu()]
            for step in range(4):
                seq.append(int(logits[0].argmax()))
                logits, cache = m.decode_step(torch.tensor([[seq[-1]]], device=dev), cache,
                                              pos=n_prompt + step)
                all_logits.append(logits.cpu())
            seq.append(int(logits[0].argmax()))
            fwd = m(prompt.to(dev)).cpu()
            res[name] = (seq, torch.cat(all_logits), fwd, flash_attention.launches,
                         router_probs(m, prompt.to(dev)).cpu() if cfg_c.moe else None)
        worst = (res["cpu"][1] - res["cuda"][1]).abs().max().item()
        scale = res["cpu"][1].abs().max().item()
        worst_f = (res["cpu"][2] - res["cuda"][2]).abs().max().item()
        scale_f = res["cpu"][2].abs().max().item()
        tol, tol_f = 1e-4 * max(1.0, scale), 1e-4 * max(1.0, scale_f)
        line = (f"  {cfg_c.name}, {cfg_c.num_layers} layers, prompt {n_prompt}: greedy cpu "
                f"{res['cpu'][0]} cuda {res['cuda'][0]}; prefill+decode max|dlogits| {worst:.3g} "
                f"(max|logits| {scale:.3g}, tol {tol:.3g}); forward max|dlogits| {worst_f:.3g} "
                f"(max|logits| {scale_f:.3g}, tol {tol_f:.3g}); K1 launches cpu "
                f"{res['cpu'][3]} cuda {res['cuda'][3]}")
        if cfg_c.moe:
            k = cfg_c.moe.top_k
            flips = int((res["cpu"][4].topk(k).indices != res["cuda"][4].topk(k).indices).sum())
            top = res["cpu"][4].topk(k + 1).values
            gap = (top[:, k - 1] - top[:, k]).min().item()
            line += (f"; MoE top-{k} choices of the forward that differ between the devices: "
                     f"{flips} (smallest gap between router probabilities {k} and {k + 1} "
                     f"in order: {gap:.3g})")
        print(line + f"; {time.perf_counter() - t0:.1f} s")
        check(res["cpu"][0] == res["cuda"][0], "same greedy tokens on card and CPU")
        check(worst <= tol and worst_f <= tol_f, "logits within tolerance")
        check(res["cpu"][3] == 0 and res["cuda"][3] == cfg_c.num_layers,
              "K1 launched on the card only, once per layer of the forward")
        del m_gpu, m_cpu, res
        torch.cuda.empty_cache()

    phase("14. zamba2-1.2b at full width (38 SSM layers, the shared attention block "
          "after every 6; bf16 compute)")
    cfg_z = get_config("zamba2-1.2b")
    check(cfg_z.param_count() == 1_104_937_856, "zamba2-1.2b parameter count")
    model_z, by_case_z, by_case_k2 = decoder_path(cfg_z, rt)
    check(by_case_k2.get(zamba2_fwd) == 2 * cfg_z.num_layers, "forward and loss_fn call K2 at the "
          "shape timed in phase 4, once per SSM layer each")
    check(by_case_z == {zamba2_attn: 2 * 6}, "forward and loss_fn launch K1 at the shape "
          "timed in phase 8, once per application of the shared block each")
    # (c) a bursty two-tenant trace replayed under preempt: the engine's
    # schedule must equal the NumPy trace_schedule bit for bit
    tenants = (traces.TenantClass("chat", ttft_s=5.0, tpot_s=0.1, priority=2),
               traces.TenantClass("batch", ttft_s=1e4, tpot_s=1e3, interactive=False))
    trace = traces.synth_trace("spike", 12, seed=SEED, tenants=tenants, shares=(0.5, 0.5),
                               prompt_ranges=((64, 512), (64, 512)),
                               out_ranges=((8, 32), (8, 32)))
    sched = traces.trace_schedule(trace, 4, "preempt")
    engine_z = ServeEngine(cfg_z, rt, model_z, slots=4, max_len=1024, policy="preempt")
    ssd_scan.launches = flash_attention.launches = 0
    ssd_scan.launches_by_case = {}
    t0 = time.perf_counter()
    reqs = replay_trace(engine_z, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    print(f"  (c) replay_trace of a spike trace, 12 requests (arrival steps "
          f"{list(trace.arrival_steps)}), 4 slots, preempt: {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.1f} tok/s), {engine_z.t} clock steps, {len(engine_z.decode_s)} "
          f"decode steps, {engine_z.n_admits} admissions, preemptions "
          f"{sum(r.n_preemptions for r in reqs)} (trace_schedule: {sched.n_preemptions}); "
          f"K2 wrapper calls {ssd_scan.launches} (= {cfg_z.num_layers} x {engine_z.n_admits} "
          f"admissions), K1 launches {flash_attention.launches}")
    check([r.admit_step for r in reqs] == sched.admit_step.tolist()
          and [r.finish_step for r in reqs] == sched.finish_step.tolist()
          and sum(r.n_preemptions for r in reqs) == sched.n_preemptions >= 1,
          "the replay's admit steps, finish steps and preemptions equal trace_schedule's")
    check(all(len(r.output) == r.max_new_tokens for r in reqs), "every request completes")
    check(ssd_scan.launches == cfg_z.num_layers * engine_z.n_admits
          and flash_attention.launches == 0, "K2 once per SSM layer per admission, no K1")
    del engine_z
    for case, n in ssd_scan.launches_by_case.items():       # (a), (b) and (c) together
        by_case_k2[case] = by_case_k2.get(case, 0) + n
    k2_record += ssd_at_path_shapes(
        torch, cfg_z.name, "zamba2-1.2b forward, loss_fn, serving and replay (phase 14)",
        by_case_k2, ssd_timed)
    decoder_breakdown(model_z, cfg_z, rt)
    del model_z
    torch.cuda.empty_cache()

    phase("15. paligemma-3b at full width (18 layers, a prefix-LM mask over 256 patch "
          "embeddings; bf16 compute)")
    cfg_p = get_config("paligemma-3b")
    P = cfg_p.prefix_len
    t0 = time.perf_counter()
    model_p = Model(cfg_p, rt, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model_p.parameters())
    print(f"  {cfg_p.name}: {n_params:,} params ({n_params * 4 / 1e9:.1f} GB fp32), init "
          f"{time.perf_counter() - t0:.2f} s; the patches stand in for SigLIP's (seed {SEED})")
    check(n_params == cfg_p.param_count() == 2_508_662_784, "paligemma-3b parameter count")
    g = torch.Generator("cuda").manual_seed(SEED)
    seq = torch.as_tensor(rng.integers(0, cfg_p.vocab, (1, 4096 - P + 1)), device="cuda")
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:],
             "patches": torch.randn(1, P, cfg_p.d_model, generator=g, device="cuda")}
    model_p(batch["tokens"][:, :64], patches=batch["patches"])    # warm-up, not counted
    torch.cuda.synchronize()
    ssd_scan.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    logits = model_p(batch["tokens"], patches=batch["patches"])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fin = logits.shape == (1, 4096, cfg_p.vocab) and bool(torch.isfinite(logits).all())
    del logits
    t0 = time.perf_counter()
    loss, met = loss_fn(model_p, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t0) * 1e3
    print(f"  (a) forward over {P} patches + {4096 - P} text tokens: {fwd_ms:.1f} ms host; "
          f"loss_fn {loss_ms:.1f} ms: loss {loss.item():.4f}, ce {met['ce'].item():.4f} "
          f"(ln V = {np.log(cfg_p.vocab):.4f}) over {int(met['tokens'])} text labels")
    check(fin and bool(torch.isfinite(loss)) and int(met["tokens"]) == 4096 - P,
          "finite logits of (1, 4096, V) and a finite loss over the text")
    n_req, n_prompt, n_steps = 4, 64, 32
    max_len = P + n_prompt + n_steps
    batch_s = {"tokens": torch.as_tensor(rng.integers(0, cfg_p.vocab, (n_req, n_prompt)),
                                         device="cuda"),
               "patches": torch.randn(n_req, P, cfg_p.d_model, generator=g, device="cuda")}
    prefill_p, decode_p = make_prefill_step(cfg_p, rt, max_len), make_decode_step(cfg_p, rt)

    def serve_p(n):
        """One prefill of the batch, then n greedy decode steps from
        position P + n_prompt; returns host seconds, the tokens and finiteness."""
        t0 = time.perf_counter()
        logits, cache = prefill_p(model_p, batch_s)
        tok = logits.argmax(-1)[:, None]
        toks, fin = [tok.cpu()], [torch.isfinite(logits).all()]
        t_pre, t_dec = time.perf_counter() - t0, []
        for step in range(n):
            t0 = time.perf_counter()
            logits, cache = decode_p(model_p, tok, P + n_prompt + step, cache)
            tok = logits.argmax(-1)[:, None]
            toks.append(tok.cpu())
            t_dec.append(time.perf_counter() - t0)
            fin.append(torch.isfinite(logits).all())
        return t_pre, t_dec, torch.cat(toks, 1), all(bool(f) for f in fin), cache

    serve_p(2)                      # warm-up, not counted (no kernel runs on this path)
    t_pre, t_dec, toks, finite_p, cache_p = serve_p(n_steps)
    torch.cuda.synchronize()
    print(f"  (b) {n_req} requests x ({P} patches + {n_prompt} tokens), max_len {max_len}: "
          f"prefill {1e3 * t_pre:.2f} ms per batch, decode {1e3 * statistics.mean(t_dec):.2f} "
          f"ms/step (mean of {n_steps}); request 0 tokens {toks[0, :12].tolist()}...; K1 "
          f"launches {flash_attention.launches}, K2 wrapper calls {ssd_scan.launches} over "
          "(a) and (b)")
    check(toks.shape == (n_req, 1 + n_steps) and finite_p, "finite logits, every token")
    check(bool(((toks >= 0) & (toks < cfg_p.vocab)).all()), "tokens within vocab")
    check(flash_attention.launches == 0 and ssd_scan.launches == 0,
          "the prefix-LM path launches no kernel (the mask stays on the plain path)")
    last_p = toks[:, -1:].to("cuda")
    print_breakdown(torch, f"prefill, B={n_req} x {P + n_prompt}", lambda: prefill_p(
        model_p, batch_s))
    print_breakdown(torch, f"8 decode steps, B={n_req}", lambda: [
        decode_p(model_p, last_p, P + n_prompt + n_steps - 8 + i, cache_p) for i in range(8)])
    print_breakdown(torch, "forward, 256 + 3840", lambda: model_p(
        batch["tokens"], patches=batch["patches"]))
    del model_p, cache_p, batch, batch_s
    torch.cuda.empty_cache()

    phase("16. card against CPU on the same weights (zamba2 7 layers, paligemma 2 layers, "
          "fp32)")
    for cfg_c, n_prompt in ((dataclasses.replace(cfg_z, num_layers=7), 300),
                            (dataclasses.replace(cfg_p, num_layers=2), 64)):
        t0 = time.perf_counter()
        m_gpu = Model(cfg_c, rt_gpu, seed=SEED + 4)
        m_cpu = Model(cfg_c, rt_cpu, seed=None)
        m_cpu.load_state_dict(m_gpu.state_dict())
        prompt = torch.as_tensor(rng.integers(0, cfg_c.vocab, (1, n_prompt)))
        extra = {}
        if cfg_c.prefix_len:
            extra["patches"] = torch.from_numpy(rng.standard_normal(
                (1, cfg_c.prefix_len, cfg_c.d_model)).astype(np.float32))
        start = cfg_c.prefix_len + n_prompt
        res = {}
        for name, m, rtx in (("cpu", m_cpu, rt_cpu), ("cuda", m_gpu, rt_gpu)):
            dev = rtx.device
            flash_attention.launches = ssd_scan.launches = 0
            inputs = {k: v.to(dev) for k, v in extra.items()}
            logits, cache = make_prefill_step(cfg_c, rtx, start + 8)(
                m, {"tokens": prompt.to(dev), **inputs})
            seq, all_logits = [], [logits.cpu()]
            for step in range(4):
                seq.append(int(logits[0].argmax()))
                logits, cache = make_decode_step(cfg_c, rtx)(
                    m, torch.tensor([[seq[-1]]], device=dev), start + step, cache)
                all_logits.append(logits.cpu())
            seq.append(int(logits[0].argmax()))
            fwd = m(prompt.to(dev), **inputs).cpu()
            res[name] = (seq, torch.cat(all_logits), fwd, flash_attention.launches,
                         ssd_scan.launches)
        worst = (res["cpu"][1] - res["cuda"][1]).abs().max().item()
        scale = res["cpu"][1].abs().max().item()
        worst_f = (res["cpu"][2] - res["cuda"][2]).abs().max().item()
        scale_f = res["cpu"][2].abs().max().item()
        tol, tol_f = 1e-4 * max(1.0, scale), 1e-4 * max(1.0, scale_f)
        print(f"  {cfg_c.name}, {cfg_c.num_layers} layers, prompt {n_prompt}"
              f"{f' after {cfg_c.prefix_len} patches' if cfg_c.prefix_len else ''}: greedy cpu "
              f"{res['cpu'][0]} cuda {res['cuda'][0]}; prefill+decode max|dlogits| {worst:.3g} "
              f"(max|logits| {scale:.3g}, tol {tol:.3g}); forward max|dlogits| {worst_f:.3g} "
              f"(max|logits| {scale_f:.3g}, tol {tol_f:.3g}); K1 launches cpu {res['cpu'][3]} "
              f"cuda {res['cuda'][3]}, K2 calls cpu {res['cpu'][4]} cuda {res['cuda'][4]}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(res["cpu"][0] == res["cuda"][0], "same greedy tokens on card and CPU")
        check(worst <= tol and worst_f <= tol_f, "logits within tolerance")
        is_hybrid = cfg_c.family == "hybrid"
        check(res["cpu"][3:] == (0, 0) and res["cuda"][3:] == (
            (1, 2 * cfg_c.num_layers) if is_hybrid else (0, 0)),
            "kernels on the card only: the hybrid's K1 once in the forward (one application), "
            "K2 once per SSM layer in the prefill and in the forward")
        del m_gpu, m_cpu, res
        torch.cuda.empty_cache()

    print(f"total {time.perf_counter() - t_start:.1f} s")
    # K2 once per path and shape (phases 5 and 14): launches from that
    # path's run (wrapper calls, three CUDA launches each in bf16), the other
    # numbers at that shape
    record = {"kernels": k2_record}
    # K1 once per path and shape: launches from that path's run, the other
    # numbers at that shape (phases 7 and 8)
    for name, path, case, n in (
            ("flash_attention", "whisper-small encoder (phase 9)", encoder, launches_w),
            ("flash_attention/gemma3-4b local", "gemma3-4b forward and loss_fn (phase 11)",
             gemma3_local, by_case_g[gemma3_local]),
            ("flash_attention/gemma3-4b global", "gemma3-4b forward and loss_fn (phase 11)",
             gemma3_global, by_case_g[gemma3_global]),
            ("flash_attention/mixtral-8x7b", "mixtral-8x7b, 4 of 32 layers, forward and "
             "loss_fn (phase 12)", mixtral, by_case_m[mixtral]),
            ("flash_attention/zamba2-1.2b", "zamba2-1.2b forward and loss_fn (phase 14)",
             zamba2_attn, by_case_z[zamba2_attn])):
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
            "path": path,
            "shape": "(B, S, Hq, Hkv, hd, causal, window) = " + str(case),
            "launches": n,
            "max_abs_err": err_by_case[case],
            **timed[case],
        })
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
