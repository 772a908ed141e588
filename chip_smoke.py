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
     1e-4 * max(1, max|logits|), the kernels launched on the card only;
 17. the DSE main path (no hand-written kernel runs on it): (a) the GP pair
     fit, 3 condition_on and the greedy q-EHVI acquire (q = 1, 2, 4) at the
     quick campaign's sizes (n = 8, 11, 14, d = 13, 32 candidates) on the
     card under torch.cuda.set_sync_debug_mode("error"), picking the same
     candidates as on the CPU, predictions within 2e-3 and 5e-3; (b) the
     float64 analytical evaluator on 512 sampled designs for the three
     campaigns' workloads (GPT-1.7B and GPT-175B training, smollm-135m
     decode) at caps 8 and 24 against the NumPy pipeline: the same
     feasibility and strategy rows, every float within 1e-12 relative, the
     count of fields not hex-equal printed; the fused dispatch on device
     indices equals the batch path; (c) quick_train_mfmobo,
     gpt175b_train_dse and smollm_inference_decode through
     `python -m repro_torch.explore` on the card and on the CPU: exactly
     14, 28 and 8 evaluations, hypervolume beside ROADMAP's baseline, wall
     time, candidates/s, the evaluated designs against the CPU run's; the
     quick campaign resumed from its step-4 checkpoint on the card equals
     the uninterrupted run bit for bit; (d) host and device time, launches
     and idle share of one pair fit, one acquire at q = 2 and 4, one fused
     and one 512-design evaluation, and the fit and acquire on the CPU.
     Its figures are printed as one JSON line ({"dse": ...}).
 18. the serving campaigns and the GNN f0 fidelity (no hand-written kernel
     runs on them): (a) the GNN forward over 20 simulator-labeled transfer
     graphs of 2 designs x GPT-1.7B (core.calibration.build_calibration_set)
     from init_gnn(0) on the card against the same params on the CPU,
     |d log1p(wait)| within 1e-5 of max(1, |log1p(wait)|), and twice on the
     card bitwise equal (the aggregation is a fixed-order one-hot product);
     (b) train_gnn on that dataset (4 epochs, val_frac 0.25) on the card and
     the CPU: the loss per epoch side by side (within 1e-3 relative, and
     decreasing), the held-out Kendall tau, ms per step, a second card run
     equal bit for bit; (c) gpt175b_serving_slo, gpt175b_hetero_serving and
     gpt175b_trace_serving through `python -m repro_torch.explore` on the
     card and the CPU: exactly 10, 6 and 8 evaluations, ROADMAP's
     hypervolumes 34.370, 19.458 and 19.204, the CPU run's designs; the
     float64 evaluator on 512 sampled designs at the six serving workloads
     against the NumPy pipeline, fields not hex-equal counted; (d)
     quick_train_mfmobo with f0 = "gnn", calibrate_on_handover and (b)'s
     params through the CLI on the card: 14 evaluations, one calibration
     record, resumed from its step-3 checkpoint bit for bit; (e) host and
     device time, launches and idle share of the GNN lanes of one grid
     bucket, one train step, the scalar chunk_latency (one forward and one
     device-to-host copy per transfer) and one evaluate_serving_batch of 32
     designs; K1 and K2 launches over the phase (0). One JSON line
     ({"gnn_serving": ...}).
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


def dse_breakdown(torch, name, fn):
    """Host ms of `fn`, its device time, launches and idle share (the
    profiler run of phase 5b), with its busiest kernels. Returns a dict."""
    wall_ms, by_name, counts = device_breakdown(torch, fn)
    dev_ms = sum(by_name.values())
    n = sum(counts.values())
    if not by_name:
        print(f"  {name}: host {wall_ms:.2f} ms; the profiler recorded no device time "
              "(device share not measured)")
        return {"host_ms": wall_ms, "device_ms": None, "launches": None}
    print(f"  {name}: host {wall_ms:.2f} ms, device busy {dev_ms:.3f} ms "
          f"(idle {1 - dev_ms / wall_ms:.1%}), {n} launches "
          f"({1e3 * wall_ms / n:.1f} us of host time each), {len(by_name)} kernel names")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        print(f"    {ms:8.3f} ms x{counts[k]:<5d} {k[:90]}")
    return {"host_ms": wall_ms, "device_ms": dev_ms, "launches": n,
            "idle": 1 - dev_ms / wall_ms}


def dse_path(torch, np):
    """Phase 17: the DSE main path of the port on the card (see the module
    docstring). Returns the figures it prints, as a dict."""
    import tempfile

    import repro_torch.core.mfmobo as M
    from repro_torch.core import eval_compiled
    from repro_torch.core.design_space import DIMS, DesignBatch, decode_batch
    from repro_torch.core.evaluator import _wafers_for_budget_batch, clear_eval_cache
    from repro_torch.core.fidelity import AnalyticalBackend
    from repro_torch.explore import CampaignSpec, ExplorationLoop, resolve_workload
    from repro_torch.explore.__main__ import main as explore_main
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    t_phase = time.perf_counter()
    out = {}
    specs = {n: ROOT / "examples" / "campaigns" / f"{n}.json" for n in (
        "quick_train_mfmobo", "gpt175b_train_dse", "smollm_inference_decode")}
    baseline = {"quick_train_mfmobo": (14, 64.819), "gpt175b_train_dse": (28, 86.410),
                "smollm_inference_decode": (8, 85.796)}
    rng = np.random.default_rng(SEED + 17)
    d = len(DIMS)
    ref = M.hv_ref(15000.0)
    M.warm_optimizer_kernels(n_candidates=32, q=4, device="cuda")

    # (a) GP pair fit, predict, condition_on and acquire: card against CPU
    n_cases = []
    for n in (8, 11, 14):
        X = rng.random((n, d))
        Y = np.stack([1e4 * (1 + rng.random(n)), 1e3 * (2 + rng.random(n))], 1)
        ev = M.obj_space([tuple(y) for y in Y])
        cand = rng.random((32, d))
        xs_new = rng.random((3, d))
        picks = {}
        for dev in ("cpu", "cuda"):
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                models = M._fit_models(X, Y, device=dev)
                js = {q: M._acquire_batch_device(models, cand, ev, ref, q=q)
                      for q in (1, 2, 4)}
                g = models[0]
                for x in xs_new:
                    g = g.condition_on(x, 0.5)
            finally:
                if dev == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
            picks[dev] = ({q: j.tolist() for q, j in js.items()},
                          [m.predict(cand) for m in models], g.predict(cand))
        err = max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                  for ga, gb in zip(picks["cuda"][1], picks["cpu"][1])
                  for a, b in zip(ga, gb))
        err_c = max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                    for a, b in zip(picks["cuda"][2], picks["cpu"][2]))
        print(f"  (a) n={n}, d={d}, 32 candidates: picks cuda {picks['cuda'][0]} cpu "
              f"{picks['cpu'][0]}; predict max rel diff {err:.3g} (tol 2e-3), after 3 "
              f"condition_on {err_c:.3g} (tol 5e-3); no host sync in fit, acquire or "
              "condition_on (sync debug mode 'error')")
        check(picks["cuda"][0] == picks["cpu"][0], "same acquired indices on card and CPU")
        check(err <= 2e-3 and err_c <= 5e-3, "GP predictions within tolerance")
        n_cases.append(n)

    # (b) the analytical evaluator against the NumPy pipeline, 512 designs
    be_ref = AnalyticalBackend(device="cpu")
    n_designs = 512
    U = rng.random((n_designs, 13))
    designs = decode_batch(U)
    geom = DesignBatch.from_designs(designs)
    eval_ms = {}
    for name, path in specs.items():
        wl = resolve_workload(CampaignSpec.from_json(str(path)))
        nw = _wafers_for_budget_batch(geom, wl)
        for cap in (8, 24):
            eval_compiled.warm_evaluator_kernels(wl, cap, device="cuda")
            t0 = time.perf_counter()
            got = eval_compiled.evaluate_batch_compiled(geom, wl, nw, cap, device="cuda")
            t_cuda = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = be_ref.evaluate_batch_ref(geom, wl, nw, cap)
            t_ref = time.perf_counter() - t0
            n_fields = n_hex = 0
            rel = 0.0
            for g, w in zip(got, want):
                check(g.feasible == w.feasible and g.strategy == w.strategy
                      and g.reason == w.reason, "same feasibility and strategy rows")
                if not w.feasible:
                    continue
                a = [g.throughput, g.power_w, g.step.step_time_s, g.step.pipeline_eff,
                     g.step.energy_j, *g.step.breakdown.values()]
                b = [w.throughput, w.power_w, w.step.step_time_s, w.step.pipeline_eff,
                     w.step.energy_j, *w.step.breakdown.values()]
                for x, y in zip(a, b):
                    n_fields += 1
                    n_hex += float(x).hex() != float(y).hex()
                    rel = max(rel, abs(x - y) / max(abs(y), 1e-300))
            n_feas = sum(w.feasible for w in want)
            print(f"  (b) {wl.name} {wl.phase}, cap {cap}: {n_designs} designs "
                  f"({n_feas} feasible), masks and strategy rows equal; {n_hex} of "
                  f"{n_fields} float64 fields not hex-equal, max rel diff {rel:.3g} "
                  f"(tol 1e-12); cuda {1e3 * t_cuda:.1f} ms host, NumPy {1e3 * t_ref:.1f} ms")
            check(rel <= 1e-12, "float64 fields within 1e-12 relative")
            eval_ms[f"{name}/{cap}"] = (1e3 * t_cuda, 1e3 * t_ref, n_hex, n_fields, rel)
        # the fused dispatch on device indices equals the batch path
        js = torch.tensor([5, 300, 17, 5], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = eval_compiled.dispatch_fused_eval(geom, wl, nw, js, 24)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        fused = pend.finish(nw[[5, 300, 17, 5]], 4)
        direct = eval_compiled.evaluate_batch_compiled(
            DesignBatch.from_designs([designs[j] for j in (5, 300, 17, 5)]), wl,
            nw[[5, 300, 17, 5]], 24, device="cuda")
        check([dataclasses.astuple(f.step) if f.step else None for f in fused]
              == [dataclasses.astuple(f.step) if f.step else None for f in direct]
              and [f.strategy for f in fused] == [f.strategy for f in direct],
              "fused dispatch equals the batch path")
        print(f"  (b) {wl.name}: fused dispatch on device indices [5, 300, 17, 5] "
              "equals the batch path, no host sync before finish")
    out["eval_ms"] = eval_ms

    # (c) the three campaigns through the CLI on the card, beside the CPU run
    flash_attention.launches = ssd_scan.launches = 0
    campaigns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in specs.items():
            res = {}
            for dev in ("cuda", "cpu"):
                clear_eval_cache()
                ck, js_out = f"{tmp}/{name}.{dev}.ckpt", f"{tmp}/{name}.{dev}.json"
                code = explore_main([str(path), "--device", dev, "--checkpoint", ck,
                                     "--out", js_out])
                check(code == 0, f"{name} on {dev} exits 0")
                with open(js_out) as f:
                    r = json.load(f)
                st = ExplorationLoop.load_state(ck)[1]
                res[dev] = (r, [x.tobytes() for x in st.X1 + st.X0])
            r, xs = res["cuda"]
            same = [a == b for a, b in zip(xs, res["cpu"][1])]
            first_diff = same.index(False) if not all(same) else None
            n_ev, hv_base = baseline[name]
            print(f"  (c) {name}: {r['n_evals']} evaluations (want {n_ev}), hypervolume "
                  f"{r['hv_final']:.3f} (ROADMAP baseline {hv_base:.3f}; CPU run "
                  f"{res['cpu'][0]['hv_final']:.3f}), wall {r['wall_s']:.2f} s, "
                  f"{r['candidates_per_sec']:.2f} candidates/s (CPU run "
                  f"{res['cpu'][0]['wall_s']:.2f} s, "
                  f"{res['cpu'][0]['candidates_per_sec']:.2f}/s); evaluated designs (f1 "
                  f"then f0) equal to the CPU run's: {sum(same)}/{len(same)}"
                  + ("" if first_diff is None else f" (first differs at {first_diff})"))
            check(r["finished"] and r["n_evals"] == n_ev, f"{name}: exact budget")
            campaigns[name] = {"n_evals": r["n_evals"], "hv": r["hv_final"],
                               "wall_s": r["wall_s"], "cand_per_s": r["candidates_per_sec"],
                               "cpu_wall_s": res["cpu"][0]["wall_s"],
                               "designs_equal_cpu": sum(same)}
        # resume quick_train_mfmobo from its step-4 checkpoint on the card
        quick = specs["quick_train_mfmobo"]
        ck = f"{tmp}/resume.ckpt"
        clear_eval_cache()
        check(explore_main([str(quick), "--device", "cuda", "--max-steps", "4",
                            "--checkpoint", ck, "--out", f"{tmp}/r.json"]) == 0, "step 4")
        check(ExplorationLoop.load_state(ck)[1].steps == 4, "checkpoint at step 4")
        clear_eval_cache()
        check(explore_main(["--resume", ck, "--device", "cuda", "--out", f"{tmp}/r.json"])
              == 0, "resume")
        tr_r = ExplorationLoop.load_state(ck)[1].trace
        tr_full = ExplorationLoop.load_state(f"{tmp}/quick_train_mfmobo.cuda.ckpt")[1].trace

        def hexed(t):
            return ([[float(v).hex() for v in x] for x in t.xs],
                    [[float(a).hex(), float(b).hex()] for a, b in t.ys],
                    [float(h).hex() for h in t.hv])
        print(f"  (c) quick_train_mfmobo resumed on the card from its step-4 checkpoint: "
              f"{tr_r.n_evals} evaluations, trace bit-identical to the uninterrupted run: "
              f"{hexed(tr_r) == hexed(tr_full)}")
        check(hexed(tr_r) == hexed(tr_full), "resume is bit-identical on the card")
    print(f"  kernel launches during the campaigns: K1 {flash_attention.launches}, K2 "
          f"{ssd_scan.launches} (the DSE path runs no hand-written kernel)")
    out["campaigns"] = campaigns

    # (d) where the time goes
    X = rng.random((14, d))
    Y = np.stack([1e4 * (1 + rng.random(14)), 1e3 * (2 + rng.random(14))], 1)
    ev = M.obj_space([tuple(y) for y in Y])
    cand = rng.random((32, d))
    models = M._fit_models(X, Y, device="cuda")
    wl = resolve_workload(CampaignSpec.from_json(str(specs["quick_train_mfmobo"])))
    nw = _wafers_for_budget_batch(geom, wl)
    js = M._acquire_batch_device(models, cand, ev, ref, q=2)
    out["fit"] = dse_breakdown(torch, "pair fit (n=14, 80 Adam steps)",
                               lambda: M._fit_models(X, Y, device="cuda"))
    cpu_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        models_c = M._fit_models(X, Y, device="cpu")
        t1 = time.perf_counter()
        M._acquire_batch(models_c, cand, ev, ref, q=4)
        cpu_ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    out["cpu_fit_ms"], out["cpu_acquire_q4_ms"] = (statistics.median(c) for c in zip(*cpu_ms))
    print(f"  the same pair fit on this machine's CPU: {out['cpu_fit_ms']:.2f} ms; acquire "
          f"q=4 there: {out['cpu_acquire_q4_ms']:.2f} ms (host clock, median of 3)")
    for q in (2, 4):
        out[f"acquire_q{q}"] = dse_breakdown(
            torch, f"acquire q={q} (32 candidates)",
            lambda: M._acquire_batch_device(models, cand, ev, ref, q=q))
    out["fused_eval"] = dse_breakdown(
        torch, "fused evaluation, 2 picks of a 32-design pool, cap 8",
        lambda: eval_compiled.dispatch_fused_eval(
            DesignBatch.from_designs(designs[:32]), wl, nw[:32], js, 8).finish(nw, 2))
    out["batch_eval_512"] = dse_breakdown(
        torch, "batch evaluation, 512 designs, cap 24",
        lambda: eval_compiled.evaluate_batch_compiled(geom, wl, nw, 24, device="cuda"))
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")
    return out


def gnn_serving_path(torch, np):
    """Phase 18: the serving campaigns and the GNN f0 fidelity with online
    calibration on the card (see the module docstring). Returns the figures
    it prints, as a dict."""
    import pickle
    import tempfile

    from repro_torch.core import noc_gnn as G
    from repro_torch.core import eval_compiled, fidelity
    from repro_torch.core.calibration import build_calibration_set
    from repro_torch.core.compiler import compile_chunk
    from repro_torch.core.design_space import DesignBatch, WSCDesign, decode_batch
    from repro_torch.core.evaluator import _wafers_for_budget_batch, clear_eval_cache
    from repro_torch.core.serving import evaluate_serving_batch, serving_workloads
    from repro_torch.core.traces import trace_serving_workloads
    from repro_torch.core.validator import validate, validate_batch
    from repro_torch.core.workload import GPT_BENCHMARKS
    from repro_torch.explore import CampaignSpec, ExplorationLoop, resolve_workload
    from repro_torch.explore.__main__ import main as explore_main
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    t_phase = time.perf_counter()
    flash_attention.launches = ssd_scan.launches = 0
    out = {}
    camp = ROOT / "examples" / "campaigns"

    # (a) the GNN forward: card against CPU on the same params, and twice on
    # the card (the aggregation order is fixed, so the waits are bitwise equal)
    wl = GPT_BENCHMARKS[0]                       # GPT-1.7B
    designs = [validate(WSCDesign()).design, validate(WSCDesign(mac_num=256)).design]
    t0 = time.perf_counter()
    ds = build_calibration_set(designs, wl)
    t_label = time.perf_counter() - t0
    batch = G.pad_link_graphs(ds, with_target=True)
    p_cpu = G.init_gnn(SEED, device="cpu")
    p_gpu = G.gnn_params_on(p_cpu, "cuda")
    w_cpu = G.gnn_forward_batch(p_cpu, batch)
    w1, w2 = G.gnn_forward_batch(p_gpu, batch), G.gnn_forward_batch(p_gpu, batch)
    real = batch.edge_mask > 0
    a = np.log1p(w1[real].astype(np.float64))
    b = np.log1p(w_cpu[real].astype(np.float64))
    err = float(np.abs(a - b).max())
    rel = float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
    same = w1.tobytes() == w2.tobytes()
    print(f"  (a) {len(ds)} simulator-labeled transfer graphs of 2 designs x {wl.name} "
          f"({t_label:.2f} s on the host), padded to (G, nodes, edges) = {w1.shape[0]}, "
          f"{batch.n_nodes}, {w1.shape[1]}: max |d log1p(wait)| card vs CPU {err:.3g} "
          f"({rel:.3g} of max(1, |log1p(wait)|), tol 1e-5); two card runs bitwise equal: "
          f"{same}")
    check(rel <= 1e-5, "GNN forward on the card within 1e-5 of the CPU's")
    check(same, "GNN waits bitwise equal across two card runs")
    out["forward"] = {"graphs": len(ds), "max_abs_dlog1p": err, "max_rel": rel,
                      "bitwise_repeat": same}

    # (b) train_gnn on the card beside the CPU, and again on the card
    kw = dict(epochs=4, lr=3e-3, seed=SEED, val_frac=0.25)
    runs = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu), ("cuda again", p_gpu)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[dev] = G.train_gnn(p, ds, **kw)
        torch.cuda.synchronize()
        runs[dev] += (time.perf_counter() - t0,)
    (p_tr, h, t_tr), (_, hc, t_trc) = runs["cuda"], runs["cpu"]
    n_val = min(max(1, round(kw["val_frac"] * len(ds))), len(ds) - 1)   # train_gnn's split
    n_steps = kw["epochs"] * (len(ds) - n_val)
    drift = max(abs(x - y) / abs(y) for x, y in zip(h.train_loss, hc.train_loss))
    repeat = (runs["cuda again"][1].train_loss == h.train_loss and all(
        torch.equal(x, y) for x, y in zip(G._flatten(runs["cuda again"][0]), G._flatten(p_tr))))
    print(f"  (b) train_gnn, {kw['epochs']} epochs, val_frac 0.25 ({n_steps} Adam steps): "
          "loss per epoch card / CPU " + ", ".join(
              f"{x:.6g} / {y:.6g}" for x, y in zip(h.train_loss, hc.train_loss))
          + f" (max rel diff {drift:.3g}, tol 1e-3); held-out Kendall tau (best epoch "
          f"{h.best_epoch}) {h.best_val_kendall_tau:.4f} (CPU {hc.best_val_kendall_tau:.4f}); "
          f"wall {t_tr:.3f} s card, {t_trc:.3f} s CPU ({1e3 * t_tr / n_steps:.2f} / "
          f"{1e3 * t_trc / n_steps:.2f} ms per step with setup and validation); a second card "
          f"run bitwise equal: {repeat}")
    check(h.train_loss[-1] < h.train_loss[0], "train_gnn loss decreases on the card")
    check(drift <= 1e-3, "card training losses within 1e-3 of the CPU's")
    check(repeat, "train_gnn repeats bit for bit on the card")
    out["train"] = {"loss": h.train_loss, "cpu_loss": hc.train_loss, "max_rel": drift,
                    "kendall_tau": h.best_val_kendall_tau, "steps": n_steps,
                    "wall_s": t_tr, "cpu_wall_s": t_trc, "bitwise_repeat": repeat}

    # (c) the serving specs through the CLI on the card, beside the CPU run,
    # and the float64 evaluator at their serving workloads against NumPy
    baseline = {"gpt175b_serving_slo": (10, 34.370), "gpt175b_hetero_serving": (6, 19.458),
                "gpt175b_trace_serving": (8, 19.204)}
    campaigns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (n_ev, hv_base) in baseline.items():
            res = {}
            for dev in ("cuda", "cpu"):
                clear_eval_cache()
                ck, js_out = f"{tmp}/{name}.{dev}.ckpt", f"{tmp}/{name}.{dev}.json"
                code = explore_main([str(camp / f"{name}.json"), "--device", dev,
                                     "--checkpoint", ck, "--out", js_out])
                check(code == 0, f"{name} on {dev} exits 0")
                with open(js_out) as f:
                    r = json.load(f)
                tr = ExplorationLoop.load_state(ck)[1].trace
                res[dev] = (r, [(np.asarray(x).tobytes(), str(d))
                                for x, d in zip(tr.xs, tr.designs)])
            r, xs = res["cuda"]
            same = sum(x == y for x, y in zip(xs, res["cpu"][1]))
            print(f"  (c) {name}: {r['n_evals']} evaluations (want {n_ev}), hypervolume "
                  f"{r['hv_final']:.3f} (ROADMAP baseline {hv_base:.3f}), wall "
                  f"{r['wall_s']:.2f} s, {r['candidates_per_sec']:.2f} candidates/s (CPU run "
                  f"{res['cpu'][0]['wall_s']:.2f} s); evaluated designs equal to the CPU "
                  f"run's: {same}/{len(xs)}")
            check(r["finished"] and r["n_evals"] == n_ev, f"{name}: exact budget")
            check(round(r["hv_final"], 3) == hv_base, f"{name}: ROADMAP's hypervolume")
            check(same == len(xs) == len(res["cpu"][1]), f"{name}: the CPU run's designs")
            campaigns[name] = {"n_evals": r["n_evals"], "hv": r["hv_final"],
                               "wall_s": r["wall_s"], "cpu_wall_s": res["cpu"][0]["wall_s"],
                               "designs_equal_cpu": same}
    out["campaigns"] = campaigns
    n_designs = 512
    geom = DesignBatch.from_designs(decode_batch(
        np.random.default_rng(SEED + 18).random((n_designs, 13))))
    hexes = {}
    for name in baseline:
        spec = CampaignSpec.from_json(str(camp / f"{name}.json"))
        base = resolve_workload(spec)
        if spec.trace is not None:
            wls = trace_serving_workloads(base, spec.trace.trace(), spec.trace.slots)[:2]
        else:
            wls = serving_workloads(base, spec.serving.mix(), spec.serving.slots)[:2]
        for w in wls:
            nw = _wafers_for_budget_batch(geom, w)
            got = eval_compiled.evaluate_batch_compiled(geom, w, nw, spec.max_strategies,
                                                        device="cuda")
            want = fidelity.AnalyticalBackend(device="cpu").evaluate_batch_ref(
                geom, w, nw, spec.max_strategies)
            n_fields = n_hex = 0
            worst = 0.0
            for g, e in zip(got, want):
                check(g.feasible == e.feasible and g.strategy == e.strategy,
                      "same feasibility and strategy rows")
                if not e.feasible:
                    continue
                for x, y in zip(
                        [g.throughput, g.power_w, g.step.step_time_s, g.step.pipeline_eff,
                         g.step.energy_j, *g.step.breakdown.values()],
                        [e.throughput, e.power_w, e.step.step_time_s, e.step.pipeline_eff,
                         e.step.energy_j, *e.step.breakdown.values()]):
                    n_fields += 1
                    n_hex += float(x).hex() != float(y).hex()
                    worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
            key = f"{name}/{w.phase} batch {w.batch} seq {w.seq}"
            hexes[key] = (n_hex, n_fields)
            print(f"  (c) {key}, cap {spec.max_strategies}: {n_designs} designs "
                  f"({sum(e.feasible for e in want)} feasible), {n_hex} of {n_fields} "
                  f"float64 fields not hex-equal, max rel diff {worst:.3g} (tol 1e-12)")
            check(worst <= 1e-12, "float64 fields within 1e-12 relative")
    out["hex_mismatches"] = hexes

    # (d) quick_train_mfmobo with f0 = gnn and calibration at the handover,
    # from (b)'s params, through the CLI on the card; resumed from step 3
    with open(camp / "quick_train_mfmobo.json") as f:
        raw = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/params.pkl", "wb") as f:
            pickle.dump(G.gnn_params_to_jax(p_tr), f)
        raw["name"] = "quick-train-gnn-calibrated"
        raw["fidelity"].update({"f0": "gnn", "calibrate_on_handover": True,
                                "params_path": f"{tmp}/params.pkl",
                                "calibration": {"n_designs": 1, "epochs": 2}})
        with open(f"{tmp}/spec.json", "w") as f:
            json.dump(raw, f)
        clear_eval_cache()
        check(explore_main([f"{tmp}/spec.json", "--device", "cuda", "--checkpoint",
                            f"{tmp}/full.ckpt", "--out", f"{tmp}/full.json"]) == 0, "gnn run")
        with open(f"{tmp}/full.json") as f:
            r = json.load(f)
        clear_eval_cache()
        check(explore_main([f"{tmp}/spec.json", "--device", "cuda", "--max-steps", "3",
                            "--checkpoint", f"{tmp}/part.ckpt", "--out", f"{tmp}/p.json"])
              == 0, "gnn run to step 3")
        clear_eval_cache()
        check(explore_main(["--resume", f"{tmp}/part.ckpt", "--device", "cuda", "--out",
                            f"{tmp}/p.json"]) == 0, "gnn resume")

        def hexed(t):
            return ([[float(v).hex() for v in x] for x in t.xs],
                    [[float(a).hex(), float(b).hex()] for a, b in t.ys],
                    [float(h).hex() for h in t.hv])
        tr_full = ExplorationLoop.load_state(f"{tmp}/full.ckpt")[1].trace
        tr_res = ExplorationLoop.load_state(f"{tmp}/part.ckpt")[1].trace
        bitwise = hexed(tr_full) == hexed(tr_res)
    print(f"  (d) quick_train_mfmobo with f0 = gnn and calibrate_on_handover (n_designs 1, "
          f"2 epochs): {r['n_evals']} evaluations (want 14), hypervolume {r['hv_final']:.3f}, "
          f"{len(r['calibration'])} calibration record ({r['calibration'][0]['n_graphs']} "
          f"graphs, {r['calibration'][0]['train_s']:.3f} s, held-out Kendall tau "
          f"{r['calibration'][0]['val_kendall_tau']}), wall {r['wall_s']:.2f} s; resumed "
          f"from its step-3 checkpoint: trace bit-identical {bitwise}")
    check(r["finished"] and r["n_evals"] == 14, "gnn campaign: exact budget")
    check(len(r["calibration"]) == 1, "gnn campaign: one calibration record")
    check(bitwise, "gnn campaign resume is bit-identical on the card")
    out["gnn_campaign"] = {"n_evals": r["n_evals"], "hv": r["hv_final"],
                           "wall_s": r["wall_s"], "calibration": r["calibration"],
                           "resume_bitwise": bitwise}

    # (e) where the time goes
    pool = [v.design for v in validate_batch(decode_batch(
        np.random.default_rng(SEED + 180).random((256, 13)))) if v.ok][:32]
    ax = fidelity.build_candidate_axis(DesignBatch.from_designs(pool), wl,
                                       _wafers_for_budget_batch(
                                           DesignBatch.from_designs(pool), wl), 8)
    bucket = max(fidelity._transfer_lanes(ax).buckets, key=lambda b: len(b.flits))
    n_uniq = len(np.unique(np.stack([bucket.flits, bucket.dur, bucket.noc_bw], 1), axis=0))
    out["forward_bucket"] = dse_breakdown(
        torch, f"GNN lanes of one grid bucket (32 designs x {wl.name}, cap 8: "
        f"{len(bucket.flits)} lanes, {n_uniq} unique -> {G.next_pow2(n_uniq)} padded graphs "
        f"of {bucket.pattern.n_cores} nodes, {len(bucket.pattern.links)} edges)",
        lambda: fidelity._gnn_lane_makespans(p_gpu, bucket))
    g0 = ds[0]
    b0 = G._upload(G.pad_link_graphs([g0], n_nodes=G.next_pow2(g0.n_nodes),
                                     n_edges=G.next_pow2(len(g0.links)), with_target=True),
                   G.params_device(p_gpu), 0)
    leaves = [t.detach().clone().requires_grad_(True) for t in G._flatten(p_gpu)]
    mom = [torch.zeros_like(t) for t in leaves]
    var = [torch.zeros_like(t) for t in leaves]
    steps = [0]

    def one_step():
        steps[0] += 1
        with G._ieee_fp32():
            G._train_step(leaves, mom, var, steps[0], 3e-3, b0)
    out["train_step"] = dse_breakdown(
        torch, f"one train step ({G.next_pow2(g0.n_nodes)} nodes, "
        f"{G.next_pow2(len(g0.links))} edges)", one_step)
    chunk = compile_chunk(designs[0], wl, tp=16, mb_tokens=4096, cores_per_chunk=64)
    n_fwd = sum(1 for i, t in enumerate(chunk.transfers)
                if t.pairs and i < len(chunk.ops)
                and G.featurize_transfer(chunk, designs[0], i).links)
    gnn = fidelity.GNNBackend(device="cuda")
    out["scalar_chunk"] = dse_breakdown(
        torch, f"scalar chunk_latency of one compiled chunk ({n_fwd} transfers: {n_fwd} "
        "forwards, each ending in a device-to-host copy)",
        lambda: gnn.chunk_latency(chunk, designs[0], p_gpu))
    out["scalar_chunk"]["syncs"] = n_fwd
    spec = CampaignSpec.from_json(str(camp / "gpt175b_serving_slo.json"))
    be = fidelity.AnalyticalBackend(device="cuda")

    def serve32():
        clear_eval_cache()
        evaluate_serving_batch(pool, resolve_workload(spec), spec.serving.mix(),
                               spec.serving.slo(), slots=spec.serving.slots, fidelity=be,
                               max_strategies=spec.max_strategies)
    out["serving_eval_32"] = dse_breakdown(
        torch, "evaluate_serving_batch, 32 designs, GPT-175B (two workloads), cap 8", serve32)
    print(f"  kernel launches during phase 18: K1 {flash_attention.launches}, K2 "
          f"{ssd_scan.launches} (no hand-written kernel is on this path)")
    check(flash_attention.launches == 0 and ssd_scan.launches == 0,
          "phase 18 launches neither K1 nor K2")
    out["k1_k2_launches"] = [flash_attention.launches, ssd_scan.launches]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 18: {out['phase_s']:.1f} s")
    return out


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

    phase("17. the DSE main path on the card: GP, q-EHVI acquire, the float64 analytical "
          "evaluator, three campaigns through python -m repro_torch.explore")
    dse = dse_path(torch, np)
    print(json.dumps({"dse": dse}, default=float))

    phase("18. the serving campaigns and the GNN f0 fidelity with online calibration on the "
          "card")
    print(json.dumps({"gnn_serving": gnn_serving_path(torch, np)}, default=float))

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
