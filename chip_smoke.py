#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. card: name and power limit (nvidia-smi), compute capability 9.0;
  2. build: every CUDA source of the port, compiled with nvcc, timed, with
     the registers and spills of every tensor-core kernel (none may spill
     at the serving shapes' instantiations: K1's bf16 forward at hd=64, 128
     and 256, `flash_wgmma_kernel` with one, two and three consumer
     warpgroups, whose wgmma products ptxas must not serialize, the K2
     kernels; nor at the training ones: K1's fp32 forward on Hopper, the
     kernels `kernel.forward_kernels` names for more than 512 keys
     (`flash_wgmma_tf32_fwd_prep_kernel`, `flash_wgmma_tf32_kernel`), at hd
     64, 128 and 256 with one and two consumer warpgroups, its mma.sync
     `flash_tf32_kernel` at hd 64 (fewer keys: whisper's decoder, smollm),
     and its backward, the kernels `kernel.backward_kernels(64, fp32)`
     names for more than 256 keys (`flash_wgmma_tf32_bwd_prep_kernel`,
     `flash_wgmma_tf32_bwd_dq_kernel`, `flash_wgmma_tf32_bwd_dkdv_kernel`)
     at hd 64, 128 and 256 with every number of consumer warpgroups their
     grid rule takes; nor K1's bf16 backward at hd 64, 128 and 256,
     `flash_wgmma_bwd_dq_kernel` and `flash_wgmma_bwd_dkdv_kernel`, the
     same way; every other instantiation printed), and, where the toolkit
     has cuobjdump, the count of HMMA TF32 instructions in the split-TF32
     forward's SASS and of bf16 m16n8k16 ones (HMMA.16816.F32.BF16, and no
     TF32) in the mma.sync bf16 backward's (`flash_bf16_bwd_*`, the other
     head dims), and HGMMA (wgmma) and UTMALDG (TMA) instructions, and no
     HMMA, in `flash_wgmma_kernel`'s, the fp32 Hopper forward's and the
     Hopper backwards' (bf16, and fp32), pre-passes aside;
     K2's split-TF32 kernels (the fp32 forward's and the backward's, both
     dtypes) printed with their HMMA TF32 counts and held to no spills, and
     the fp32 backward's Hopper kernels (`ssd_bwd_dx_kernel`,
     `ssd_bwd_dbc_kernel` at N 64 and 128, `ssd_bwd_dbc_sum_kernel`) to no
     spills, the first two with HGMMA and UTMALDG and no HMMA;
  3. the SSD-scan kernel against its plain PyTorch version on the card, at
     the JAX kernel tests' shapes and the serving shapes (mamba2-370m's and
     zamba2-1.2b's: H=64, N=64, S=1024, a ragged 1000 and its forward's
     4096), fp32 and bf16 (bf16 reaches the bf16 tensor-core kernels, fp32
     the split-TF32 ones), and bf16 again through strided views cut from one
     (B, S, H*P + 2N) tensor, as the model passes them, equal bit for bit to
     the contiguous call;
  4. the kernel's time at mamba2's S=1024 prefill shape and zamba2's S=1024
     and S=4096 shapes beside the plain version's and its bound (device
     time: calls captured in a CUDA graph and replayed between CUDA
     events; the eager back-to-back time, which the wrapper's Python can
     pace, printed beside), and `ops.ssd` on the strided views in bf16 and
     fp32 launching its three kernels and no copy;
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
     windowed one), fp32 (split TF32: `flash_wgmma_tf32_kernel` after its
     pre-pass at hd 64, 128, 256 over more than 512 keys, else
     `flash_tf32_kernel`) and bf16 (`flash_wgmma_kernel` at hd 64, 128,
     256, `flash_mma_kernel` at the others: `kernel.forward_kernels`'s
     rule), and the bf16 tensor-core
     kernels at every head-dim class (16, 48, 64, 80, 128, 144, 256) with
     ragged S = 200, GQA 7, causal plus window and non-causal; window=1
     gives each row its own value bit for bit in both dtypes; bf16 at the
     four full-sequence forward shapes of the decoder paths (gemma3-4b's
     local and global layers, mixtral-8x7b's, zamba2-1.2b's shared block:
     MHA, 32 heads of 64, causal, 4096 tokens), with the log-sum-exp
     against the plain logsumexp there and at the encoder's shape, and
     mixtral's run twice bit for bit;
  8. the kernel's time (bf16, measured as in 4; the kernel named by the
     rule) at the whisper encoder's
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
 19. training (K1 forward and backward on every layer): (a) K1's backward
     (fp32 at hd 64, 128 and 256 over more than 256 keys:
     `flash_wgmma_tf32_bwd_prep_kernel` (the operands' split TF32 copies,
     delta), `flash_wgmma_tf32_bwd_dq_kernel`, then
     `flash_wgmma_tf32_bwd_dkdv_kernel`, split-TF32 wgmma fed by TMA; fp32
     elsewhere (smollm's 256 keys too): `flash_tf32_bwd_dq_kernel` with delta, then
     `flash_tf32_bwd_dkdv_kernel`, split-TF32 mma.sync;
     bf16 at hd 64, 128 and 256: `flash_wgmma_bwd_dq_kernel` with delta,
     then `flash_wgmma_bwd_dkdv_kernel`, wgmma fed by TMA with P and dS in
     two bf16 terms; `kernel.backward_kernels`'s rule) against its plain
     version
     `attention_bwd_ref` on the kernel's own o and lse, at the JAX flash
     tests' cases, ragged S = 200 with GQA 7, causal and window 50 at hd 64,
     128 and 256, a non-causal hd 256 one and the training shape (8, 256,
     9/3 heads of 64, causal), under phase 7's rules relative to the largest
     reference gradient; two runs bit for bit; the forward's output with its
     lse the same bits as without, the lse against the plain version's;
     (b) K1 forward (with lse) and backward at the training shape, fp32,
     device time beside both bounds (IEEE fp32 operations on the CUDA
     cores, and the split-TF32 route's own: three TF32 products per fp32
     one, or bytes, whichever is larger), the plain version and
     scaled_dot_product_attention forward, forward + backward through
     autograd and its backward alone (the difference; timed only), and K1's
     forward + backward through `FlashAttentionFn` beside SDPA's; (c) `repro_torch.launch.train.main` for smollm-135m at full width
     (random weights from seed 0, fp32, remat "block", batch 8 x 256): 16
     steps, a checkpoint every 8, a failure injected before step 10: one
     restart, a contiguous log, the final checkpoint at step 16, 60 K1
     forward and 30 backward calls per step run, the loss curve, and an
     uninterrupted run with every loss equal bit for bit; (d) the same
     weights cut to 2 layers trained 3 steps on the card and the CPU: losses
     within 1e-5, grad norms within 1e-4 relative; (e) host and device time
     of one step, idle share, launches, the largest device items, K1's
     forward and backward shares (the kernels of either route by the rule's
     names; the forward's share must not be 0), tokens/s.
 20. SSM and hybrid training (K2 forward and backward on every SSM layer,
     K1's on zamba2's shared block): (a) K2's backward (six kernels on the
     tensor cores, fp32 sums for both dtypes; fp32 at Q = 128, P = 64, N 64
     or 128 on the Hopper route, `kernel.bwd_on_hopper`, the rest on the
     split-TF32 mma.sync kernels: the route printed, Python's rule and
     ssd_scan.cu's held equal) against
     `ssd_chunked_bwd_ref` on the forward's own states, at the JAX kernel
     tests' shapes, a ragged S = 1000, (1, 200, 4 heads of 64, N 64), (2,
     300, 4 heads of 64, N 128) and the two training shapes (8, 256,
     32 heads of 64, N 128; 8, 256, 64 heads of 64, N 64), fp32 and bf16,
     contiguous and strided, and with a nonzero final-state gradient, under
     phase 3's rules relative to each reference gradient's largest
     magnitude; two runs bit for bit; the forward with its states the same
     bits as without; (b) K2's fp32 forward (with states) and backward at
     both training shapes on the strided views: device time beside both
     bounds (IEEE fp32 on the CUDA cores; split TF32's own, three TF32
     products per fp32 one or the bytes, whichever is larger, the record's)
     and the plain versions, and `SSDScanFn`'s forward + backward through
     autograd; the backward by kernel (one profiled call: the kernels its
     rule names), the Hopper dx kernel and dB/dC stage beside their own
     split-TF32 bounds; (c)
     `repro_torch.launch.train.main` for mamba2-370m at full width (random
     weights from seed 0, fp32, remat "block", batch 8 x 256): 10 steps, a
     checkpoint every 5, a failure injected before step 7: one restart, a
     contiguous log, the final checkpoint at step 10, 96 K2 forward and 48
     backward calls per step run, falling losses, and an uninterrupted run
     with every loss equal bit for bit; (d) zamba2-1.2b at full width
     through the launcher, 4 steps: 76 K2 forward, 38 backward, 6 K1
     forward and 6 backward calls per step, finite losses; (e) mamba2 cut
     to 2 layers (8 x 256) and zamba2 to 6 (one application, 2 x 256)
     trained 3 steps on the card and the CPU: losses within 1e-5, grad
     norms within 1e-4 relative; (f) host and device time of one step of
     each: idle share, launches, the largest device items, K2's forward and
     backward shares by kernel name (the backward's must count its Hopper
     kernels and not be 0), tokens/s (one JSON line, {"ssm_training": ...}).
 21. every family trains (K1's fp32 forward with its lse and its backward
     on every self-attention layer): (a) K1 at the five training cases,
     whisper-small's encoder (8, 1500, 12 heads of 64, non-causal) and
     decoder (8, 448, causal), gemma3-4b's local (1, 4096, 8/4 heads of
     256, window 1024) and global layers, mixtral-8x7b's (1, 4096, 32/8
     heads of 128, window 4096): the backward held by phase 19's long rule,
     two runs bit for bit, the forward against the plain version, both
     timed beside both bounds, the plain versions and
     scaled_dot_product_attention on EFFICIENT_ATTENTION (a boolean mask
     where the window bites; a case no backend takes is printed so);
     (b)-(d) whisper-small whole (12 + 12 layers, batch 8, 1500 frames,
     448 tokens), gemma3-4b cut to 12 of 34 layers (10 local, 2 global) and
     mixtral-8x7b to 2 of 32 (batch 1 x 4096 each) at full width, random
     weights from seed 0, fp32, remat "block", 3 steps of make_train_step
     on synthetic_batch: finite losses and grad norms, K1's calls per step
     by case equal to the layer pattern's, host ms and peak memory per
     step, the step's loss and gradients twice from the same weights and
     batch compared bit for bit (the tensors that differ printed), mixtral's
     capacity drops, where one step's time goes; (e) whisper at 2 + 2
     layers (1 x 64 tokens, 1500 frames), gemma3 at 6 (5 local, 1 global;
     1 x 1100) and mixtral at 1 (1 x 300) from the same numpy weights
     (params_from_jax): one train step on the card and the CPU, loss within
     1e-5 and grad norm within 1e-4 relative; (f) int8 compress_grads over
     two rounds on smollm-135m's full-width gradients, card and CPU bit for
     bit; 5 full-width smollm steps with and without
     int8_compress_decompress; pipeline_apply (8 layers of width 768, 2
     stages x 4 microbatches and 4 x 8) against the sequential layers,
     outputs and gradients. One JSON line ({"families_training": ...}).
 22. the rest of the DSE (no hand-written kernel runs on it; K1 and K2
     launches over the phase must be 0): (a) gpt175b_joint_dse through
     `python -m repro_torch.explore` on the card and the CPU: exactly 28
     evaluations, ROADMAP's hypervolume 79.826, the CPU run's joint points
     (f1 then f0, encoded architecture and strategy) all equal; resumed from
     its step-2 checkpoint on the card, the uninterrupted trace bit for
     bit; (b) the pinned (joint) evaluator on 512 valid joint points of
     GPT-175B (`_valid_candidates_joint`, the shardability oracle
     included), and the same designs under random ep up to 8 on an
     8-expert variant, on the card against the port's NumPy pinned path:
     float64 fields not hex-equal counted (must be 0); the fused pinned
     dispatch on device indices, under set_sync_debug_mode("error"), and
     `evaluate_pool_fused_joint` equal to the batch path; host and device
     time, launches and idle share of one 512-point batch; (c)
     fleet_quick_grid as a fleet of 2 spawned workers sharing the card:
     6/6 campaigns, 52 evaluations, 0 crashes, every front equal to a
     serial run of the same campaign on the card; then the same with the
     first campaign's worker killed through the crash hook: 1 crash, that
     campaign requeued and resumed from its checkpoint, the same fronts;
     wall seconds of both runs and the shared cache's hits; (d) the §IX
     baselines: WSE2_LIKE and DOJO_LIKE on the 16 GPT benchmarks through
     the card's batch evaluator against the CPU program (hex-equal) and
     against `wsc_baseline_eval` (the scalar NumPy path, 8 benchmarks,
     within 1e-12), their throughput over `gpu_cluster_eval`'s (host
     NumPy). One JSON line ({"dse_rest": ...}).
 23. the mesh path: `python -m repro_torch.launch.train --data 2 --model 2
     --backend threaded`, a 2x2 ("data", "model") DeviceMesh of four ranks
     that are threads of this process sharing the card (torch's threaded
     group: NCCL refuses two ranks on one device, and gloo processes on
     the card die in torch's functional all-gather), bf16, remat "block": (a)
     smollm-135m, (b) mamba2-370m at full width with their depth cut
     (MESH_PATHS says why), 5 steps of 8 x 256, (c) mixtral-8x7b at full
     width, 1 of 32 layers, 5 steps of 1 x 4096. Each run's K1 and K2
     calls per step and rank at each rank's local shapes (smollm's 9/3
     heads replicated over "model", its batch halved; mamba2's 16 of 32
     SSD heads; mixtral's 16/4 heads); its losses against the same run on
     one rank (bf16, within 2e-2: five steps of (a) and (b), (c)'s first,
     from the same weights, its top-2 routing parting the trajectories
     after); in (a) a `--fail-at` resume bit for bit;
     the collectives of one step on each rank by kind, its host ms,
     tokens/s and peak memory, one step's device time by kernel and idle
     share (K1's backward by kernel: `flash_wgmma_bwd_dq_kernel`,
     `flash_wgmma_bwd_dkdv_kernel`). Then K1 and K2 forward and backward held
     against their plain versions and timed at those local shapes (bf16),
     beside their bounds, the plain versions and SDPA's (K1), K1's backward
     also beside the split-bf16 scheme's own floor; and K1 in bf16, held
     and timed the same way, at four whole layers (K1_BF16_LAYERS:
     mixtral-8x7b, gemma3-4b's local and global layers, whisper-small's
     encoder). One JSON line ({"mesh": ...}).
The line before the last is the kernels' JSON record: the SSD scan once per
path and shape it ran (mamba2-370m's prefills; zamba2-1.2b's forward,
prefills and replay) and the flash-attention kernel
once per path and shape (the whisper encoder, gemma3-4b's local and global
layers, mixtral-8x7b, zamba2-1.2b, and K1's forward and backward on the
training path of phase 19), and K2's fp32 forward and backward on the two
training paths of phase 20, and K1's forward and backward at the five
training cases of phase 21, and K1's and K2's forward and backward at the
mesh path's local shapes of phase 23, each with the launches of its path's
run and
the error and times at its shape; the last line is
{"ok": true, "device": {...}}. Without a card, or without the repo's
sources beside it, the script fails before printing any result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): device memory, the bf16 and TF32
# tensor-core rates and the fp32 CUDA-core rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}


MMA_KERNELS = ("flash_mma_kernel", "chunk_state_kernel", "state_pass_kernel",
               "chunk_scan_kernel")
K1_FP32 = "flash_tf32_kernel"       # K1's fp32 forward on mma.sync (split TF32)
# K1's fp32 forward on Hopper: its pre-pass and the TF32 wgmma kernel
K1_FP32_HOPPER = ("flash_wgmma_tf32_fwd_prep_kernel", "flash_wgmma_tf32_kernel")
K1_WGMMA = "flash_wgmma_kernel"     # K1's bf16 forward at hd 64, 128, 256 (wgmma fed by TMA)
# K2's split-TF32 kernels: the fp32 forward's (with state_pass_kernel<false>)
# and the backward's for both dtypes (with state_pass_kernel<true>)
K2_FWD_TF32 = ("chunk_state_tf32_kernel<false, float>", "chunk_scan_tf32_kernel")
K2_BWD_TF32 = tuple(f"{k}<{arg}{t}>" for t in ("float", "bf16") for k, arg in (
    ("ssd_bwd_cbds_kernel", ""), ("chunk_state_tf32_kernel", "true, "),
    ("ssd_bwd_chunk_tf32_kernel", ""), ("ssd_bwd_bc_tf32_kernel", ""),
    ("ssd_bwd_bc_sum_tf32_kernel", "")))
K2_TRAIN = K2_FWD_TF32 + K2_BWD_TF32
# the profiler's names of K2's fp32 forward and of its backward, either dtype
K2_FWD_PROFILE = ("chunk_state_tf32_kernel<false", "state_pass_kernel<false>",
                  "chunk_scan_tf32_kernel")
K2_BWD_PROFILE = ("ssd_bwd_", "chunk_state_tf32_kernel<true", "state_pass_kernel<true>")


def ptxas_table(log, name_of):
    """{name_of(mangled name): [registers, spill store bytes, spill load
    bytes, static shared memory bytes]} from nvcc's -Xptxas -v output, for
    the kernels name_of names (it returns None for the others). The
    kernels' dynamic shared memory is set at launch, not in the log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = name_of(m.group(1))
            if name:
                out[name] = [0, 0, 0, 0]
        elif name and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            out[name][1:3] = [int(st), int(ld)]
        elif name and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name][3] = int(smem.group(1)) if smem else 0
    return out


def fwd_name(mangled):
    """"<tensor-core forward kernel><hd>" (K1_WGMMA: "<hd, warpgroups>") of
    a mangled name, or None: <length><name>, then I Li<hd> E for a head-dim
    template (Li<n> E after it for a second argument)."""
    k = re.search(r"\d(" + "|".join(MMA_KERNELS + (K1_FP32, K1_WGMMA) + K1_FP32_HOPPER)
                  + r")(ILi(\d+)E(?:Li(\d+)E)?)?", mangled)
    args = k and k.group(3) and k.group(3) + (f", {k.group(4)}" if k.group(4) else "")
    return k and k.group(1) + (f"<{args}>" if args else "")


def k1_fwd_name(cfg):
    """The CUDA kernel of K1's bf16 forward at `cfg`'s attention head dim
    (the rule of `kernel.forward_kernel`)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import forward_kernel
    return forward_kernel(cfg.hd(), torch.bfloat16)


# K1's bf16 forward instantiations on the Hopper path: (hd, consumer warpgroups)
K1_WGMMA_INST = tuple(f"{K1_WGMMA}<{hd}, {n}>" for hd, n in (
    (64, 1), (64, 2), (64, 3), (128, 1), (128, 2), (256, 1), (256, 2)))
# K1's fp32 forward on Hopper: the pre-pass at hd 64, 128, 256 and the
# forward kernel at every number of consumer warpgroups its grid rule takes
K1_FP32_HOPPER_INST = (tuple(f"{K1_FP32_HOPPER[0]}<{hd}>" for hd in (64, 128, 256))
                       + tuple(f"{K1_FP32_HOPPER[1]}<{hd}, {n}>" for hd in (64, 128, 256)
                               for n in (1, 2)))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


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


def chunk_pairs(case):
    """(T, the first chunk's rows, the last chunk's rows) of `case`'s chunks:
    T is the number of causal pairs s <= t within a chunk, summed over the
    chunks; a ragged last chunk counts its real rows only."""
    _, S, _, _, _, chunk = case
    Q = min(chunk, S)
    rows = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    return sum(q * (q + 1) // 2 for q in rows), rows[0], rows[-1]


def ssd_work(case, dtype_name):
    """Bytes (each input read once, each output written once) and the FLOPs
    one scan needs: per sequence C B^T over the causal pairs (2 T N), per
    head the masked M x (2 T P), each chunk's state from its rows (2 S N P)
    and the entering state's term in every chunk but the first, whose
    entering state is zero (2 (S - q0) N P)."""
    B, S, H, P, N, chunk = case
    T, q0, _ = chunk_pairs(case)
    e = 2 if dtype_name == "bf16" else 4
    nbytes = (2 * B * S * H * P * e          # x in, y out
              + 2 * B * S * N * e            # B, C
              + B * S * H * 4 + 2 * H * 4    # dt, A, D
              + B * H * P * N * 4)           # final state
    flops = B * (2 * T * N + H * (2 * T * P + 2 * S * N * P + 2 * (S - q0) * N * P))
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


def device_breakdown(torch, fn, reps=3, calls=1, until=bool):
    """Host ms of `fn` (median of `reps`, no profiler), then `calls` runs in
    one torch.profiler session: device ms and launches by kernel name,
    summed over the runs. On the H100 the profiler now and then records no
    device event of a session, or misses its first kernels, so a session
    whose launches by name fail `until` (by default: none recorded) is
    taken again, up to three in all; a fault of the program repeats in
    every session. Returns (wall_ms, {name: ms}, {name: launches}) of the
    last session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name, counts = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                counts[e.name] = counts.get(e.name, 0) + 1
        if until(counts):
            break
    return statistics.median(walls), by_name, counts


def kernel_share(by_name, counts, parts):
    """{part: (ms, launches)} summed over every kernel name containing part."""
    return {part: (sum(ms for k, ms in by_name.items() if part in k),
                   sum(n for k, n in counts.items() if part in k)) for part in parts}


def k1_fp32_names(backward):
    """The CUDA kernels of K1's fp32 forward (backward) at every head dim and
    on either side of the shape rule, by `kernel.forward_kernels`
    (`kernel.backward_kernels`): the Hopper route's at hd 64, 128 and 256
    over many keys, the mma.sync kernels elsewhere."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (HD_MAX, backward_kernels,
                                                             forward_kernels)
    rule = backward_kernels if backward else forward_kernels
    return tuple(sorted({n for hd in range(16, HD_MAX + 1, 16)
                         for skv in (1, 4096) for n in rule(hd, torch.float32, (1, 1, skv, 1, 1))}))


def k1_train_shares(by_name, counts):
    """{"K1 forward": (ms, launches), "K1 backward": (ms, launches)} of a
    profiled fp32 training step, each summed over the kernels of its route
    on either side of the rule (`k1_fp32_names`): CUDA launches, a pre-pass
    counted as one."""
    out = {}
    for label, names in (("K1 forward", k1_fp32_names(False)),
                         ("K1 backward", k1_fp32_names(True))):
        parts = kernel_share(by_name, counts, names).values()
        out[label] = (sum(ms for ms, _ in parts), sum(n for _, n in parts))
    return out


def print_breakdown(torch, name, fn, k1_name):
    """Host ms of `fn`, its device time by kernel and its idle share (as in
    phase 5b), with the share of K1's forward kernel `k1_name`. Returns
    (host ms, device ms)."""
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
    k1 = k1_fwd_name(cfg)
    print_breakdown(torch, "prefill, 2048 tokens", lambda: model.prefill(
        prompt, init_cache(cfg, rt, 1, 4096)), k1)
    print_breakdown(torch, "8 decode steps, 4 slots", lambda: [
        model.decode_step(last4, cache4, pos=pos4 + i) for i in range(8)], k1)
    print_breakdown(torch, "forward, (1, 4096)", lambda: model(seq), k1)


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


BWD_KERNEL = re.compile(
    r"\d(flash_(?:tf32|bf16|wgmma|wgmma_tf32)_bwd_\w+?_kernel)ILi(\d+)E(?:Li(\d+)E)?")
FWD_TF32 = re.compile(r"\d(" + K1_FP32 + r")ILi(\d+)E")
# K1's bf16 backward on Hopper (hd 64, 128, 256): (hd, consumer warpgroups)
# of the dQ kernel's and of the dK/dV kernel's instantiations, every one
# that the grid rule can take
K1_BWD_WGMMA_NWG = (((64, 1), (64, 2), (64, 3), (128, 1), (128, 2), (256, 1)),
                    ((64, 1), (64, 2), (128, 1), (128, 2), (256, 1)))


def k1_bwd_names(hd):
    """The CUDA kernels of K1's bf16 backward at head dim `hd`, the dQ
    kernel first (the rule of `kernel.backward_kernels`)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import backward_kernels
    return backward_kernels(hd, torch.bfloat16)


def k1_bwd_wgmma_inst():
    """The names of K1_BWD_WGMMA_NWG's instantiations."""
    return tuple(f"{name}<{hd}, {n}>" for name, inst in zip(k1_bwd_names(64), K1_BWD_WGMMA_NWG)
                 for hd, n in inst)


# K1's fp32 backward on Hopper (hd 64, 128, 256): (hd, consumer warpgroups)
# of the dQ and the dK/dV kernels' instantiations, every one that their grid
# rule can take
K1_BWD_TF32_NWG = ((64, 1), (64, 2), (128, 1), (128, 2), (256, 1))


def k1_bwd_tf32_inst():
    """The names of K1's fp32 backward instantiations on Hopper: the
    pre-pass at hd 64, 128 and 256, then the dQ and dK/dV kernels at
    K1_BWD_TF32_NWG (the kernels `kernel.backward_kernels(64, fp32)` names
    over 4096 keys)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HDS, backward_kernels
    prep, dq, kv = backward_kernels(64, torch.float32, (1, 4096, 4096, 1, 1))
    return (tuple(f"{prep}<{hd}>" for hd in WGMMA_HDS)
            + tuple(f"{name}<{hd}, {n}>" for name in (dq, kv) for hd, n in K1_BWD_TF32_NWG))


def bwd_name(mangled):
    """"flash_tf32_bwd_*_kernel<hd>", "flash_bf16_bwd_dq_kernel<hd>",
    "flash_bf16_bwd_dkdv_kernel<hd, groups>",
    "flash_wgmma_bwd_*_kernel<hd, warpgroups>",
    "flash_wgmma_tf32_bwd_prep_kernel<hd>" or
    "flash_wgmma_tf32_bwd_*_kernel<hd, warpgroups>" of a mangled backward
    kernel, or None."""
    k = BWD_KERNEL.search(mangled)
    return k and f"{k.group(1)}<{k.group(2)}{f', {k.group(3)}' if k.group(3) else ''}>"


def k1_tf32_name(mangled):
    """"<K1 split-TF32 or bf16-backward kernel><template arguments>" of a
    mangled name, or None."""
    f = FWD_TF32.search(mangled)
    return f"{f.group(1)}<{f.group(2)}>" if f else bwd_name(mangled)


def sass_hmma_counts():
    """{kernel name: [HMMA instructions, of them TF32, of them bf16
    m16n8k16 (HMMA.16816.F32.BF16), HGMMA (wgmma) instructions, UTMALDG
    (TMA load) instructions]} from cuobjdump -sass of the built
    flash-attention and SSD-scan libraries (K1's split-TF32, bf16 backward
    and Hopper forward kernels, K2's), or None where the toolkit has no
    cuobjdump."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = {}

    def k1_name(mangled):
        n = fwd_name(mangled)
        return n if n and n.startswith((K1_WGMMA,) + K1_FP32_HOPPER) else k1_tf32_name(mangled)

    for stem, name_of in (("flash_attention", k1_name), ("ssd_scan", k2_name)):
        lib = _build._lib_path(next(s for s in _build.sources() if s.stem == stem))
        sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = name_of(m.group(1))
                if name:
                    out[name] = [0, 0, 0, 0, 0]
            elif name and "HMMA" in line:
                out[name][0] += 1
                out[name][1] += "TF32" in line
                out[name][2] += "HMMA.16816.F32.BF16" in line
            elif name:
                out[name][3] += " HGMMA." in line
                out[name][4] += " UTMALDG." in line
    return out


def flash_bwd_work(case, dtype_name):
    """Bytes (q, k, v, o, dO and lse read once, dq, dk, dv written once: four
    q-sized and four kv-sized tensors) and FLOPs (the five products QK^T,
    dO V^T, P^T dO, dS^T Q, dS K over the (query, key) pairs the mask keeps)
    of one backward, for the bound."""
    B, S, Hq, Hkv, hd, causal, window = case
    e = 2 if dtype_name == "bf16" else 4
    nbytes = (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd) * e + B * Hq * S * 4
    flops = flash_work(case, dtype_name)[1] // 4 * 10
    return nbytes, flops


def hold_flash_bwd(torch, case, dname, small):
    """K1's backward at `case` in `dname` against its plain version on the
    kernel's own o and lse; two runs bit for bit; the forward with its lse
    the same bits as without, the lse against the plain version's. The rule
    is phase 7's, relative to the largest reference gradient: small cases
    |d| <= tol (|ref| + max|ref|) (tol 2e-5 fp32, 2e-2 bf16); others fp32
    |d| <= 1e-4 max|ref|, bf16 |d| <= 1e-2 |ref| + 1e-4 max|ref| (the two
    sides round fp32 sums taken in other orders to bf16). Returns the
    largest |d| over dq, dk, dv."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    dtype = torch.float32 if dname == "fp32" else torch.bfloat16
    causal, window = case[5], case[6]
    q, k, v, pos = flash_inputs(torch, case, dtype)
    do = flash_inputs(torch, case, dtype, seed=SEED + 1)[0]
    o0 = flash_attention(q, k, v, causal=causal, window=window)
    o, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    _, lse_ref = attention_ref(q, k, v, pos, pos, causal=causal, window=window, return_lse=True)
    refs = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    worst, line, ok = 0.0, [], True
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        r = r.float()
        err = (g.float() - r).abs()
        mref = r.abs().max().item()
        if small:
            tol = 2e-5 if dname == "fp32" else 2e-2
            ok_g = bool((err <= tol * (r.abs() + mref)).all())
        elif dname == "fp32":
            ok_g = err.max().item() <= 1e-4 * mref
        else:
            ok_g = bool((err <= 1e-2 * r.abs() + 1e-4 * mref).all())
        ok = ok and ok_g and bool(torch.isfinite(g).all())
        worst = max(worst, err.max().item())
        line.append(f"{name} {err.max().item():.3g}/{mref:.3g}")
    dlse = (lse - lse_ref).abs().max().item()
    bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    print(f"  {case} {dname}: max|d|/max|ref| " + ", ".join(line)
          + f"; |dlse| {dlse:.3g}; rerun bitwise {bits}; o with lse bitwise "
          f"{torch.equal(o, o0)} [{'small' if small else 'long'} rule] "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"flash_attention_bwd {case} {dname}")
    check(bits, f"flash_attention_bwd {case} {dname}: two runs bit for bit")
    check(torch.equal(o, o0), f"flash_attention {case} {dname}: return_lse keeps o's bits")
    check(dlse <= 1e-5 * max(1.0, lse_ref.abs().max().item()), f"lse {case} {dname}")
    return worst


def time_k1_train(torch, case):
    """K1 at a training case, fp32: the forward (with lse) held against the
    plain version (|d| <= 1e-4 max|ref|); device time of the forward with
    its lse and of the backward beside both bounds (IEEE fp32 operations on
    the CUDA cores, and the split-TF32 route's own: three TF32 products per
    fp32 one, or the bytes, whichever is larger: the record's), the plain
    version's, and scaled_dot_product_attention's on EFFICIENT_ATTENTION
    (K/V repeated for GQA, BHSD copies made beforehand; a boolean mask where
    the window bites): forward, forward + backward through autograd and the
    backward alone (their difference; timed only); then K1's forward +
    backward through `FlashAttentionFn` beside SDPA's. Returns ({"forward
    (with lse)": record numbers, "backward": ...}, the forward's max|d|)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    B, S, Hq, Hkv, hd, causal, window = case
    kw = {"causal": causal, "window": window}
    q, k, v, pos = flash_inputs(torch, case, torch.float32)
    do = flash_inputs(torch, case, torch.float32, seed=SEED + 1)[0]
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    ref = attention_ref(q, k, v, pos, pos, **kw)
    err_fwd = (o - ref).abs().max().item()
    check(err_fwd <= 1e-4 * ref.abs().max().item(), f"flash_attention {case} fp32")
    del ref
    f_ms = graph_ms(torch, lambda: flash_attention(q, k, v, return_lse=True, **kw))
    b_ms = graph_ms(torch, lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))
    pf_ms = graph_ms(torch, lambda: attention_ref(q, k, v, pos, pos, return_lse=True, **kw),
                     calls=3, reps=5)
    pb_ms = graph_ms(torch, lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw),
                     calls=3, reps=5)
    rep = Hq // Hkv
    qt, kt, vt = (t.repeat_interleave(r, 2).transpose(1, 2).contiguous().requires_grad_()
                  for t, r in ((q, 1), (k, rep), (v, rep)))
    dot = do.transpose(1, 2).contiguous()
    mask, is_causal = None, causal
    if window is not None and window < S:
        i = torch.arange(S, device="cuda")
        mask, is_causal = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window), False

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                 is_causal=is_causal)
    lf_ms = lfb_ms = None
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        try:
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
            torch.cuda.synchronize()
            taken = True
        except RuntimeError as e:             # the library yardstick only: no kernel of the port
            print(f"    scaled_dot_product_attention: EFFICIENT_ATTENTION does not take {case} "
                  f"fp32 ({str(e).splitlines()[0][:120]}); no library time")
            taken = False
        if taken:
            # captured in a CUDA graph like the kernels (eager, the host's
            # autograd dispatch would set the pace)
            lf_ms = graph_ms(torch, sdpa)
            lfb_ms = graph_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    kfb_ms = graph_ms(torch, lambda: torch.autograd.grad(
        fa_ops.mha(qg, kg, vg, pos, pos, **kw), (qg, kg, vg), do))
    out = {}
    fwd_work = flash_work(case, "fp32")
    fwd_work = (fwd_work[0] + B * Hq * S * 4, fwd_work[1])    # and the lse written
    for name, ms, p_ms, l_ms, (nbytes, flops) in (
            ("forward (with lse)", f_ms, pf_ms, lf_ms, fwd_work),
            ("backward", b_ms, pb_ms, lfb_ms, flash_bwd_work(case, "fp32"))):
        fp32_ms = flops / PEAK_FLOPS["fp32"] * 1e3
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, 3 * flops / PEAK_FLOPS["tf32"] * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        if l_ms is None:
            lib = "not timed (no backend)"
        elif name[0] == "f":
            lib = f"forward {l_ms:.4f} ms"
        else:
            lib = (f"backward alone {lfb_ms - lf_ms:.4f} ms (forward + backward {lfb_ms:.4f} "
                   f"less forward {lf_ms:.4f})")
        print(f"    {name}: kernel {ms:.4f} ms; bounds (H100 SXM peaks): fp32 on the CUDA cores "
              f"{fp32_ms:.5f} ms ({flops / 1e9:.3f} GFLOP at 67 TFLOP/s, {fp32_ms / ms:.1%}), "
              f"split TF32 {bound:.5f} ms ({by}: 3 x {flops / 1e9:.3f} GFLOP at 495 TFLOP/s, "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s; {bound / ms:.1%}); plain {p_ms:.4f} ms; "
              f"scaled_dot_product_attention {lib} (EFFICIENT_ATTENTION, K/V repeated for "
              f"GQA, BHSD{', boolean window mask' if mask is not None else ''})")
        out[name] = {"ms": ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": l_ms}
    print(f"    forward + backward through autograd: K1 (FlashAttentionFn) {kfb_ms:.4f} ms, SDPA "
          + (f"{lfb_ms:.4f} ms ({kfb_ms / lfb_ms:.2f}x)" if lfb_ms else "not timed"))
    del q, k, v, o, lse, do, qt, kt, vt, dot, qg, kg, vg, mask
    torch.cuda.empty_cache()
    return out, err_fwd


def train_path(torch, np):
    """Phase 19: K1's backward held and timed; the trainer at full width
    through `repro_torch.launch.train.main` with an injected failure; card
    against CPU; where one step's time goes. Returns the kernels record's
    two K1 entries of the training path."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import Model
    from repro_torch.models.runtime import Runtime
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import MarkovLMDataset
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("smollm-135m")
    B, S = 8, 256
    train_case = (B, S, cfg.n_heads, cfg.n_kv, cfg.hd(), True, None)
    print("  (a) K1 backward against its plain version")
    small = [(1, 64, 4, 4, 16, True, None), (2, 128, 4, 2, 32, True, None),
             (1, 96, 8, 1, 16, True, None), (2, 128, 4, 4, 64, True, 32),
             (1, 256, 2, 2, 16, False, None), (1, 80, 3, 1, 16, True, 24)]
    longer = ([(2, 200, 7, 1, hd, True, 50) for hd in (64, 128, 256)]
              + [(1, 200, 2, 2, 256, False, None), train_case])
    err_train = 0.0
    for case in small + longer:
        for dname in ("fp32", "bf16"):
            e = hold_flash_bwd(torch, case, dname, small=case in small)
            if case == train_case and dname == "fp32":
                err_train = e

    print("  (b) K1 at the training shape, fp32 (the trainer's dtype), device time")
    out, err_fwd = time_k1_train(torch, train_case)

    steps, every, fail = 16, 8, 10
    print(f"  (c) python -m repro_torch.launch.train --arch smollm-135m at full width, {steps} "
          f"steps, a checkpoint every {every}, a failure injected before step {fail}")
    base = ["--arch", cfg.name, "--batch", str(B), "--seq", str(S), "--steps", str(steps),
            "--log-every", "4"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        flash_attention.launches = flash_attention_bwd.launches = 0
        flash_attention.launches_by_case, flash_attention_bwd.launches_by_case = {}, {}
        t0 = time.perf_counter()
        res = launch_train.main(base + ["--ckpt-dir", f"{tmp}/a", "--ckpt-every", str(every),
                                        "--fail-at", str(fail)])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        n_f, n_b = flash_attention.launches, flash_attention_bwd.launches
        by_f = dict(flash_attention.launches_by_case)
        log = [m["step"] for m in res["metrics"]]
        ran = steps + fail % every              # the steps after the rollback run again
        print(f"    {wall_a:.1f} s; restarts {res['restarts']}; checkpoints "
              f"{ckpt.list_checkpoints(f'{tmp}/a')}; K1 forward {n_f}, backward {n_b} "
              f"calls over {ran} steps ({n_f / ran:g} and {n_b / ran:g} per step)")
        check(res["restarts"] == 1, "one restart")
        check(log == list(range(steps)), "a contiguous metric log")
        check(ckpt.list_checkpoints(f"{tmp}/a")[-1] == steps, "a final checkpoint at the last step")
        check(n_f == ran * 2 * cfg.num_layers and n_b == ran * cfg.num_layers
              and by_f == {train_case: n_f},
              "60 K1 forward (remat: twice per layer) and 30 backward calls per step")
        losses = [m["loss"] for m in res["metrics"]]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], "finite, falling losses")
        print("    loss curve: " + " ".join(f"{x:.4f}" for x in losses[::4])
              + f" ... {losses[-1]:.4f}")
        t0 = time.perf_counter()
        clean = launch_train.main(base + ["--ckpt-dir", f"{tmp}/b", "--ckpt-every", "1000"])
        wall_b = time.perf_counter() - t0
        same = [m["loss"] for m in clean["metrics"]] == losses
        print(f"    uninterrupted run: {wall_b:.1f} s, final loss {clean['metrics'][-1]['loss']!r} "
              f"against {losses[-1]!r}: every loss bitwise equal {same}")
        check(clean["restarts"] == 0 and same, "the resumed run equals an uninterrupted one bit "
              "for bit")
        model, st = clean["params"], clean["opt_state"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print("  (d) card against CPU: the same weights cut to 2 layers, fp32, 3 steps")
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=steps)
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=S, batch=B, seed=0)
    src = Model(cfg2, Runtime(device="cuda", compute_dtype=torch.float32), seed=SEED)
    curves = {}
    for dev in ("cuda", "cpu"):
        rt = Runtime(device=dev, compute_dtype=torch.float32, remat="block")
        m2 = Model(cfg2, rt, seed=None)
        m2.load_state_dict(src.state_dict())
        st2 = init_opt_state(dict(m2.requires_grad_(True).named_parameters()))
        step2 = make_train_step(cfg2, rt, opt)
        t0 = time.perf_counter()
        curve = []
        for s in range(3):
            batch = {kk: torch.as_tensor(vv).long().to(dev) for kk, vv in ds.batch_at(s).items()}
            m2, st2, mm = step2(m2, st2, batch)
            curve.append((mm["loss"].item(), mm["grad_norm"].item()))
        curves[dev] = curve
        print(f"    {dev}: " + ", ".join(f"loss {a:.6f} gnorm {g:.6f}" for a, g in curve)
              + f" ({time.perf_counter() - t0:.1f} s)")
        del m2, st2
    dl = max(abs(a - c) / abs(c) for (a, _), (c, _) in zip(curves["cuda"], curves["cpu"]))
    dg = max(abs(a - c) / abs(c) for (_, a), (_, c) in zip(curves["cuda"], curves["cpu"]))
    print(f"    largest relative difference: loss {dl:.3g} (<= 1e-5), grad norm {dg:.3g} (<= 1e-4)")
    check(dl <= 1e-5 and dg <= 1e-4, "card against CPU")
    del src

    print("  (e) where the time goes: one full-width training step (8 x 256 tokens)")
    step = make_train_step(cfg, model.rt, opt)
    batch = {kk: torch.as_tensor(vv).long().cuda() for kk, vv in ds.batch_at(steps).items()}

    def one_step():
        step(model, st, batch)
    wall_ms, by_name, counts = device_breakdown(torch, one_step)
    dev_ms = sum(by_name.values())
    if not by_name:
        print(f"    host {wall_ms:.2f} ms; the profiler recorded no device time")
    else:
        parts = k1_train_shares(by_name, counts)
        print(f"    host {wall_ms:.2f} ms ({B * S / wall_ms * 1e3:.0f} tokens/s), device busy "
              f"{dev_ms:.2f} ms (idle {1 - dev_ms / wall_ms:.1%}), {len(by_name)} kernel names, "
              f"{sum(counts.values())} launches")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"      {ms:8.3f} ms x{counts[kname]:<5d} {kname[:90]}")
        for label, (ms, n) in parts.items():
            print(f"    {label} {ms:.3f} ms x{n}, {ms / dev_ms:.1%} of device time")
        check(parts["K1 forward"][0] > 0, "the step's K1 forward share, by the rule's kernel names")
    del model, st
    torch.cuda.empty_cache()
    entry = {"route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
             "path": "smollm-135m training, python -m repro_torch.launch.train (phase 19 (c))",
             "shape": "(B, S, Hq, Hkv, hd, causal, window) = " + str(train_case) + ", fp32"}
    return [{"name": "flash_attention/smollm-135m training", **entry, "launches": n_f,
             "max_abs_err": err_fwd, **out["forward (with lse)"]},
            {"name": "flash_attention_bwd/smollm-135m training", **entry, "launches": n_b,
             "max_abs_err": err_train, **out["backward"]}]


K2_TF32 = re.compile(r"\d(chunk_state_tf32_kernel|chunk_scan_tf32_kernel|ssd_bwd_\w+?_kernel"
                     r"|state_pass_kernel)(?:I(?:Lb([01])E)?(f|13__nv_bfloat16)?(?:Li(\d+)E)?E)?")


def k2_name(mangled):
    """"<kernel><template arguments>" of K2's split-TF32 kernels (the fp32
    forward's and the backward's, the Hopper backward's at its N) and of
    its state passes, from a mangled name, or None."""
    k = K2_TF32.search(mangled)
    if not k:
        return None
    args = ([] if k.group(2) is None else ["true" if k.group(2) == "1" else "false"]) + (
        [] if not k.group(3) else ["float" if k.group(3) == "f" else "bf16"]) + (
        [] if not k.group(4) else [k.group(4)])
    return k.group(1) + (f"<{', '.join(args)}>" if args else "")


def ssd_bwd_work(case, dtype_name, final_state=False):
    """Bytes (x, dy, B, C, dt, A, D, the forward's states and dhT read once;
    dx, dB, dC, ddt, dA, dD written once) and the FLOPs one backward needs,
    over the causal pairs of each chunk (T, `chunk_pairs`): per sequence
    C B^T recomputed and its two gradients dC and dB (6 T N); per head
    dy x^T for dS and M^T dy for dx (4 T P), U = sum_t e^L_t dy_t^T C_t and
    dC's inter term in every chunk but the first, whose entering state is
    zero and whose state gradient nothing reads (4 (S - q0) N P), and dx's
    and dB's state terms where the gradient of the state leaving the chunk
    is nonzero: every chunk but the last, or all with dhT (4 S' N P)."""
    B, S, H, P, N, chunk = case
    T, q0, q_last = chunk_pairs(case)
    nc = -(-S // min(chunk, S))
    e = 2 if dtype_name == "bf16" else 4
    nbytes = (3 * B * S * H * P * e + 4 * B * S * N * e + 2 * B * S * H * 4 + 4 * H * 4
              + B * nc * H * P * N * 4 + (B * H * P * N * 4 if final_state else 0))
    s_state = S if final_state else S - q_last
    flops = B * (6 * T * N + H * (4 * T * P + 4 * (S - q0) * N * P + 4 * s_state * N * P))
    return nbytes, flops


def k2_bwd_stage_work(case, final_state=False):
    """{stage: (bytes, FLOPs)} of the fp32 backward's two Hopper stages at
    `case`, counted as ssd_bwd_work counts (each input read once, each
    output written once; causal pairs only; no state term, and no state
    read, where the state is zero: h_prev in every chunk but the first, dH
    in every chunk but the last, or in all with dhT): the dx kernel reads x,
    dy, dt, L, C, B, C B^T, h_prev and dH and writes dx, ddt and the chunks'
    parts of dA and dD, for M' (dt x) and M'^T dy (4 T P a head), C h_prev^T
    (2 (S - q0) N P) and B dH^T (2 S' N P); the dB/dC stage
    (ssd_bwd_dbc_kernel + its sum) reads x, dy, dt, L, B, C, h_prev, dH and
    dS once a chunk and writes dB, dC, dA and dD, for dS B and dS^T C (4 T
    N) and the state terms (2 (S - q0) N P and 2 S' N P a head)."""
    B, S, H, P, N, chunk = case
    T, q0, q_last = chunk_pairs(case)
    Q = min(chunk, S)
    nc = -(-S // Q)
    xs, bc, qq = B * S * H * P * 4, B * S * N * 4, B * nc * Q * Q * 4
    st = B * H * P * N * 4 * ((nc - 1) + (nc if final_state else nc - 1))
    small = B * S * H * 4 * 2 + B * nc * H * 4 * 2
    states = 2 * (S - q0) * N * P + 2 * (S if final_state else S - q_last) * N * P
    dx = (3 * xs + st + 2 * bc + qq + small, B * H * (4 * T * P + states))
    dbc = (2 * xs + st + 4 * bc + qq + small, B * (4 * T * N + H * states))
    return {"dx (ssd_bwd_dx_kernel)": dx,
            "dB/dC (ssd_bwd_dbc_kernel + ssd_bwd_dbc_sum_kernel)": dbc}


def k2_train_cases(B=8, S=256):
    """{arch: (B, S, H, P, N, chunk)}: K2 at mamba2-370m's and zamba2-1.2b's
    training shapes."""
    from repro_torch.configs import get_config
    out = {}
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = get_config(arch)
        s = cfg.ssm
        out[cfg.name] = (B, S, s.n_heads(cfg.d_model), s.head_dim, s.state_dim, 128)
    return out


def k2_bwd_hopper_names(torch):
    """The kernels K2's fp32 backward launches at the training shapes on the
    Hopper route and not on the mma.sync one, by `kernel.backward_kernels`."""
    from repro_torch.kernels.ssd_scan.kernel import backward_kernels
    names = {}
    for case in k2_train_cases().values():
        old = backward_kernels(case, torch.float32, aligned=False)
        names.update(dict.fromkeys(k for k in backward_kernels(case, torch.float32)
                                   if k not in old))
    return tuple(names)


def hold_ssd_bwd(torch, case, dname, final_state):
    """K2's backward at `case` in `dname` ("fp32", "bf16", either with
    " strided": x, B, C as views of one packed tensor), given the kernel
    forward's states, against `ssd_chunked_bwd_ref` given the plain
    forward's, with the final state's gradient or without; two runs bit for
    bit; the forward with its states the same bits as without, and its
    states (fp32 in both dtypes) within phase 3's fp32 rule of the plain
    forward's. The gradients' rule is phase 3's, relative to each reference
    gradient's largest magnitude: fp32 gradients (and the fp32 ddt, dA, dD
    of a bf16 call) |d| <= 3e-4 max|ref|; bf16 dx, dB, dC
    |d| <= 1e-2 |ref| + 3e-4 max|ref|. Returns the largest |d| over the six."""
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
    dtype = torch.float32 if dname.startswith("fp32") else torch.bfloat16
    args = ssd_inputs(torch, case, dtype)
    if dname.endswith("strided"):
        args = strided_views(torch, case, args)
    g = torch.Generator("cuda").manual_seed(SEED + 1)
    B, S, H, P, N, chunk = case
    dy = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
    dhT = torch.randn(B, H, P, N, generator=g, device="cuda") if final_state else None
    y0, h0 = ssd_scan(*args, chunk=chunk)
    y, h, h_prev = ssd_scan(*args, chunk=chunk, return_states=True)
    grads = ssd_scan_bwd(*args, h_prev, dy, dhT, chunk=chunk)
    again = ssd_scan_bwd(*args, h_prev, dy, dhT, chunk=chunk)
    torch.cuda.synchronize()
    hp_ref = ssd_chunked_ref(*args, chunk=chunk, return_states=True)[2]
    e_states, m_states = (h_prev - hp_ref).abs().max().item(), hp_ref.abs().max().item()
    refs = ssd_chunked_bwd_ref(*args, hp_ref, dy, dhT, chunk=chunk)
    worst, line, ok = 0.0, [], True
    for name, gk, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads, refs):
        err = (gk.float() - r).abs()
        mref = r.abs().max().item()
        tol = 3e-4 * mref + (1e-2 * r.abs() if gk.dtype == torch.bfloat16 else 0.0)
        ok = ok and bool((err <= tol).all()) and bool(torch.isfinite(gk).all())
        worst = max(worst, err.max().item())
        line.append(f"{name} {err.max().item():.3g}/{mref:.3g}")
    bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    same = torch.equal(y, y0) and torch.equal(h, h0)
    states_ok = e_states <= 3e-4 * max(1.0, m_states)
    hopper = K.bwd_on_hopper(case, dtype, K.tma_aligned(args[0]))
    check(hopper == K.bwd_on_hopper_lib(args[0], N, chunk), f"{case} {dname}: one route rule")
    print(f"  {case} {dname}{' +dhT' if final_state else ''} "
          f"({'Hopper' if hopper else 'mma.sync'} route): max|d|/max|ref| "
          + ", ".join(line) + f"; states {e_states:.3g}/{m_states:.3g}; rerun bitwise {bits}; "
          f"forward with states bitwise {same} {'ok' if ok and states_ok else 'FAIL'}")
    check(states_ok, f"ssd_scan {case} {dname}: the states entering each chunk")
    check(ok, f"ssd_scan_bwd {case} {dname}")
    check(bits, f"ssd_scan_bwd {case} {dname}: two runs bit for bit")
    check(same, f"ssd_scan {case} {dname}: return_states keeps y's and the state's bits")
    return worst


def time_k2_train(torch, case):
    """K2 at a training shape, fp32, on strided views of one packed tensor
    (as the trainer passes them): device time of the forward with its
    states, of the backward and of SSDScanFn's forward + backward through
    autograd, each beside the plain version's and both bounds (IEEE fp32
    on the CUDA cores; split TF32's own, the record's). Returns ({"forward": record
    numbers, "backward": ...}, the forward's max|dy| against the plain
    version)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
    B, S, H, P, N, chunk = case
    args = strided_views(torch, case, ssd_inputs(torch, case, torch.float32))
    dy = torch.randn(B, S, H, P, generator=torch.Generator("cuda").manual_seed(SEED + 1),
                     device="cuda")
    y, _, h_prev = ssd_scan(*args, chunk=chunk, return_states=True)
    y_ref, _, hp_ref = ssd_chunked_ref(*args, chunk=chunk, return_states=True)
    err_fwd = (y - y_ref).abs().max().item()
    check(err_fwd <= 3e-4 * y_ref.abs().max().item(), f"ssd_scan {case} fp32 on the views")
    check((h_prev - hp_ref).abs().max().item() <= 3e-4 * hp_ref.abs().max().item(),
          f"ssd_scan {case} fp32: the states entering each chunk")
    f_ms = graph_ms(torch, lambda: ssd_scan(*args, chunk=chunk, return_states=True))
    b_ms = graph_ms(torch, lambda: ssd_scan_bwd(*args, h_prev, dy, chunk=chunk))
    pf_ms = graph_ms(torch, lambda: ssd_chunked_ref(*args, chunk=chunk, return_states=True),
                     calls=3, reps=5)
    pb_ms = graph_ms(torch, lambda: ssd_chunked_bwd_ref(*args, hp_ref, dy, chunk=chunk),
                     calls=3, reps=5)
    packed = torch.cat([args[0].flatten(-2), args[3], args[4]], -1).requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (args[1], args[2], args[5])]

    def fn_pair():
        xs, Bs, Cs = packed.split([H * P, N, N], -1)
        out, _ = ssd_ops.ssd(xs.unflatten(-1, (H, P)), leaves[0], leaves[1], Bs, Cs,
                             leaves[2], chunk=chunk)
        return torch.autograd.grad(out, [packed] + leaves, dy)
    fb_ms = graph_ms(torch, fn_pair)
    nb_f, fl_f = ssd_work(case, "fp32")
    Q = min(chunk, S)
    nb_f += B * -(-S // Q) * H * P * N * 4                  # and the states written
    out = {}
    for name, ms, p_ms, (nbytes, flops) in (
            ("forward (with states)", f_ms, pf_ms, (nb_f, fl_f)),
            ("backward", b_ms, pb_ms, ssd_bwd_work(case, "fp32"))):
        # two bounds, as phase 19 (b) gives K1's: IEEE fp32 operations on the
        # CUDA cores, and the route's own, three TF32 products per fp32 one or
        # the bytes, whichever is larger (the record's)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        fp32_ms = max(t_bytes, flops / PEAK_FLOPS["fp32"] * 1e3)
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"    {name}: kernel {ms:.4f} ms; bounds (H100 SXM peaks): fp32 on the CUDA cores "
              f"{fp32_ms:.5f} ms ({flops / 1e9:.3f} GFLOP at 67 TFLOP/s, {fp32_ms / ms:.1%}), "
              f"split TF32 {bound:.5f} ms ({by}: 3 x {flops / 1e9:.3f} GFLOP at 495 TFLOP/s, "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s; {bound / ms:.1%}); plain {p_ms:.4f} ms; no "
              "library call computes it")
        out[name] = {"ms": ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None}
    print(f"    SSDScanFn forward + backward through autograd (the trainer's call, on the "
          f"packed tensor's views): {fb_ms:.4f} ms (kernels alone {f_ms + b_ms:.4f} ms)")
    from repro_torch.kernels.ssd_scan.kernel import backward_kernels
    want = set(backward_kernels(case, torch.float32))

    def bare(kname):
        return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", kname)
    # two calls a session, each kernel's ms a launch (it launches once a call)
    _, by_name, counts = device_breakdown(
        torch, lambda: ssd_scan_bwd(*args, h_prev, dy, chunk=chunk), reps=1, calls=2,
        until=lambda c: {bare(k) for k in c} == want)
    short = {bare(k): v / counts[k] for k, v in by_name.items()}
    print("    backward by kernel (ms a launch, two profiled calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(short.items(), key=lambda kv: -kv[1])))
    check(set(short) == want,
          f"ssd_scan_bwd {case} fp32 on the views launches the kernels its rule names "
          f"(missing {sorted(want - set(short))}, besides them {sorted(set(short) - want)})")
    stage_ms = {"dx (ssd_bwd_dx_kernel)": short.get(f"ssd_bwd_dx_kernel<{N}>", 0.0),
                "dB/dC (ssd_bwd_dbc_kernel + ssd_bwd_dbc_sum_kernel)":
                    short.get(f"ssd_bwd_dbc_kernel<{N}>", 0.0)
                    + short.get("ssd_bwd_dbc_sum_kernel", 0.0)}
    for stage, (nbytes, flops) in k2_bwd_stage_work(case).items():
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
        bound = max(t_bytes, t_ops)
        ms = stage_ms[stage]
        print(f"      {stage}: {ms:.4f} ms; split-TF32 bound {bound:.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e6:.2f} MB, "
              f"3 x {flops / 1e9:.3f} GFLOP; {bound / ms if ms else 0:.1%})")
    return out, err_fwd


def k2_step_breakdown(torch, name, model, opt, batch, tokens):
    """Host ms of one training step, its device time by kernel, idle share,
    launches, the largest items, K2's kernels by name and the shares of its
    forward (chunk_state_tf32_kernel<false, ...>, state_pass_kernel<false>,
    chunk_scan_tf32_kernel) and backward (the ssd_bwd_* kernels,
    chunk_state_tf32_kernel<true, ...>, state_pass_kernel<true>), and K1's.
    Returns a dict of those figures."""
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(model.cfg, model.rt, opt)
    st = init_opt_state(dict(model.named_parameters()))

    def one_step():
        step(model, st, batch)
    wall_ms, by_name, counts = device_breakdown(torch, one_step)
    dev_ms = sum(by_name.values())
    res = {"host_ms": wall_ms, "tokens_per_s": tokens / wall_ms * 1e3}
    if not by_name:
        print(f"    {name}: host {wall_ms:.2f} ms; the profiler recorded no device time")
        return res
    def share(keep):
        names = [k for k in by_name if keep(k)]
        return sum(by_name[k] for k in names), sum(counts[k] for k in names)
    k2f, n_f = share(lambda k: any(m in k for m in K2_FWD_PROFILE))
    k2b, n_b = share(lambda k: any(m in k for m in K2_BWD_PROFILE))
    # fp32 at the training shapes: K2's backward on the Hopper route
    hop, n_h = share(lambda k: any(m.split("<")[0] in k for m in k2_bwd_hopper_names(torch)))
    check(k2b > 0 and hop > 0, f"{name}: K2's backward share counts its Hopper kernels")
    parts = k1_train_shares(by_name, counts)
    res.update(device_ms=dev_ms, idle=1 - dev_ms / wall_ms, launches=sum(counts.values()),
               k2_forward_ms=k2f, k2_backward_ms=k2b, k2_backward_hopper_ms=hop,
               k1_ms=parts["K1 forward"][0] +
               parts["K1 backward"][0])
    print(f"    {name}: host {wall_ms:.2f} ms ({res['tokens_per_s']:.0f} tokens/s), device busy "
          f"{dev_ms:.2f} ms (idle {res['idle']:.1%}), {len(by_name)} kernel names, "
          f"{res['launches']} launches")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"      {ms:8.3f} ms x{counts[kname]:<5d} {kname[:90]}")
    print(f"    K2 forward ({n_f} launches) {k2f:.3f} ms, {k2f / dev_ms:.1%}; K2 backward "
          f"({n_b} launches) {k2b:.3f} ms, {k2b / dev_ms:.1%} (of it the Hopper route's dx and "
          f"dB/dC kernels {hop:.3f} ms, {n_h} launches); K1 forward + backward "
          f"{res['k1_ms']:.3f} ms, {res['k1_ms'] / dev_ms:.1%} of device time")
    for kname in sorted(k for k in by_name if any(m in k for m in K2_FWD_PROFILE + K2_BWD_PROFILE)):
        short = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", kname)
        print(f"      K2 {short}: {by_name[kname]:.3f} ms x{counts[kname]}")
    return res


def ssm_train_path(torch, np):
    """Phase 20: K2's backward held and timed; mamba2-370m at full width
    through `repro_torch.launch.train.main` with an injected failure;
    zamba2-1.2b at full width; card against CPU; where one step's time goes.
    Returns the kernels record's K2 entries of the two training paths."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.launch import train as launch_train
    from repro_torch.models.hybrid import n_applications
    from repro_torch.models.model import Model
    from repro_torch.models.runtime import Runtime
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import MarkovLMDataset
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg_m, cfg_z = get_config("mamba2-370m"), get_config("zamba2-1.2b")
    B, S = 8, 256
    cases = k2_train_cases(B, S)
    print(f"  (a) K2 backward against its plain version; training shapes {cases}")
    small = [(1, 32, 2, 8, 8, 8), (2, 64, 4, 16, 16, 16), (1, 100, 2, 16, 8, 32),
             (2, 128, 2, 32, 16, 128)]
    err_bwd = {}
    # fp32 at Q = 128, P = 64, N 64 or 128 takes the Hopper route (the
    # training shapes, S = 1000 and the ragged and long cases), the small
    # cases and bf16 the mma.sync one
    for case in small + [(1, 1000, 32, 64, 128, 128), (1, 200, 4, 64, 64, 128),
                         (2, 300, 4, 64, 128, 128)] + list(cases.values()):
        for dname in ("fp32", "bf16", "fp32 strided", "bf16 strided"):
            e = hold_ssd_bwd(torch, case, dname, final_state=False)
            if dname == "fp32 strided":
                err_bwd[case] = e
    for case in (small[2], (2, 300, 4, 64, 128, 128), cases[cfg_m.name]):     # a nonzero dhT
        for dname in ("fp32", "bf16 strided"):
            hold_ssd_bwd(torch, case, dname, final_state=True)

    print("  (b) K2 at the training shapes, fp32 (the trainer's dtype), device time")
    timed, err_fwd = {}, {}
    for arch, case in cases.items():
        print(f"   {arch} {case}:")
        timed[arch], err_fwd[arch] = time_k2_train(torch, case)

    counters = (ssd_scan, ssd_scan_bwd, flash_attention, flash_attention_bwd)

    def reset():
        for c in counters:
            c.launches, c.launches_by_case = 0, {}

    steps, every, fail = 10, 5, 7
    print(f"  (c) python -m repro_torch.launch.train --arch mamba2-370m at full width, {steps} "
          f"steps, a checkpoint every {every}, a failure injected before step {fail}")
    base = ["--batch", str(B), "--seq", str(S), "--steps", str(steps), "--log-every", "2"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssm_train_")
    try:
        reset()
        t0 = time.perf_counter()
        res = launch_train.main(["--arch", cfg_m.name] + base + [
            "--ckpt-dir", f"{tmp}/a", "--ckpt-every", str(every), "--fail-at", str(fail)])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        n_m = tuple(c.launches for c in counters)
        by_f = dict(ssd_scan.launches_by_case)
        ran = steps + fail % every              # the steps after the rollback run again
        L = cfg_m.num_layers
        saved = ckpt.list_checkpoints(f"{tmp}/a")
        print(f"    {wall_a:.1f} s; restarts {res['restarts']}; checkpoints {saved}; K2 forward "
              f"{n_m[0]}, backward {n_m[1]} calls over {ran} steps ({n_m[0] / ran:g} and "
              f"{n_m[1] / ran:g} per step); K1 {n_m[2]} + {n_m[3]}")
        check(res["restarts"] == 1, "one restart")
        check([m["step"] for m in res["metrics"]] == list(range(steps)), "a contiguous log")
        check(saved[-1] == steps, "a final checkpoint at the last step")
        check(n_m == (ran * 2 * L, ran * L, 0, 0) and by_f == {cases[cfg_m.name]: n_m[0]},
              f"{2 * L} K2 forward (remat: twice per layer) and {L} backward calls per step")
        losses = [m["loss"] for m in res["metrics"]]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], "finite, falling losses")
        print("    loss curve: " + " ".join(f"{x:.4f}" for x in losses[::2])
              + f" ... {losses[-1]:.4f}")
        shutil.rmtree(f"{tmp}/a", ignore_errors=True)
        t0 = time.perf_counter()
        clean = launch_train.main(["--arch", cfg_m.name] + base + [
            "--ckpt-dir", f"{tmp}/b", "--ckpt-every", "0"])
        wall_b = time.perf_counter() - t0
        same = [m["loss"] for m in clean["metrics"]] == losses
        print(f"    uninterrupted run: {wall_b:.1f} s, final loss {clean['metrics'][-1]['loss']!r} "
              f"against {losses[-1]!r}: every loss bitwise equal {same}")
        check(clean["restarts"] == 0 and same,
              "the resumed run equals an uninterrupted one bit for bit")
        model_m = clean["params"]
        shutil.rmtree(f"{tmp}/b", ignore_errors=True)

        z_steps = 4
        print(f"  (d) python -m repro_torch.launch.train --arch zamba2-1.2b at full width, "
              f"{z_steps} steps")
        reset()
        t0 = time.perf_counter()
        res_z = launch_train.main(["--arch", cfg_z.name, "--batch", str(B), "--seq", str(S),
                                   "--steps", str(z_steps), "--log-every", "1",
                                   "--ckpt-dir", f"{tmp}/z", "--ckpt-every", "0"])
        torch.cuda.synchronize()
        wall_z = time.perf_counter() - t0
        n_z = tuple(c.launches for c in counters)
        Lz, apps = cfg_z.num_layers, n_applications(cfg_z)
        losses_z = [m["loss"] for m in res_z["metrics"]]
        print(f"    {wall_z:.1f} s (no checkpoint); K2 forward {n_z[0]}, "
              f"backward {n_z[1]}; K1 forward {n_z[2]}, backward {n_z[3]} over {z_steps} steps "
              f"({n_z[0] / z_steps:g}, {n_z[1] / z_steps:g}, {n_z[2] / z_steps:g}, "
              f"{n_z[3] / z_steps:g} per step); losses " + " ".join(f"{x:.4f}" for x in losses_z))
        check(n_z == (z_steps * 2 * Lz, z_steps * Lz, z_steps * apps, z_steps * apps),
              f"{2 * Lz} K2 forward and {Lz} backward, {apps} K1 forward and {apps} backward "
              "calls per step")
        check(len(losses_z) == z_steps and all(np.isfinite(losses_z)), "finite zamba2 losses")
        model_z = res_z["params"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print("  (e) card against CPU: the same weights cut in depth, fp32, 3 steps")
    for cfg, n_layers, batch in ((cfg_m, 2, B), (cfg_z, 6, 2)):
        cfg2 = dataclasses.replace(cfg, num_layers=n_layers)
        opt = AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=steps)
        ds2 = MarkovLMDataset(vocab=cfg.vocab, seq_len=S, batch=batch, seed=0)
        src = Model(cfg2, Runtime(device="cuda", compute_dtype=torch.float32), seed=SEED)
        curves, calls = {}, {}
        for dev in ("cuda", "cpu"):
            rt = Runtime(device=dev, compute_dtype=torch.float32, remat="block")
            m2 = Model(cfg2, rt, seed=None)
            m2.load_state_dict(src.state_dict())
            st2 = init_opt_state(dict(m2.requires_grad_(True).named_parameters()))
            step2 = make_train_step(cfg2, rt, opt)
            reset()
            t0 = time.perf_counter()
            curve = []
            for s in range(3):
                b2 = {kk: torch.as_tensor(vv).long().to(dev) for kk, vv in ds2.batch_at(s).items()}
                m2, st2, mm = step2(m2, st2, b2)
                curve.append((mm["loss"].item(), mm["grad_norm"].item()))
            curves[dev], calls[dev] = curve, tuple(c.launches for c in counters)
            print(f"    {cfg.name}, {n_layers} layers, {batch} x {S}, {dev}: "
                  + ", ".join(f"loss {a:.6f} gnorm {g:.6f}" for a, g in curve)
                  + f"; K2 {calls[dev][0]} + {calls[dev][1]}, K1 {calls[dev][2]} + "
                  f"{calls[dev][3]} ({time.perf_counter() - t0:.1f} s)")
            del m2, st2
        dl = max(abs(a - c) / abs(c) for (a, _), (c, _) in zip(curves["cuda"], curves["cpu"]))
        dg = max(abs(a - c) / abs(c) for (_, a), (_, c) in zip(curves["cuda"], curves["cpu"]))
        apps = n_applications(cfg2) if cfg2.family == "hybrid" else 0
        print(f"    largest relative difference: loss {dl:.3g} (<= 1e-5), grad norm {dg:.3g} "
              "(<= 1e-4)")
        check(dl <= 1e-5 and dg <= 1e-4, f"{cfg.name}: card against CPU")
        check(calls["cpu"] == (0, 0, 0, 0) and calls["cuda"] == (
            6 * n_layers, 3 * n_layers, 3 * apps, 3 * apps), "the kernels on the card only")
        del src
    torch.cuda.empty_cache()

    print("  (f) where the time goes: one full-width training step (8 x 256 tokens)")
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=steps)
    steps_out = {}
    for name, model in ((cfg_m.name, model_m), (cfg_z.name, model_z)):
        ds_f = MarkovLMDataset(vocab=model.cfg.vocab, seq_len=S, batch=B, seed=0)
        batch = {kk: torch.as_tensor(vv).long().cuda() for kk, vv in ds_f.batch_at(steps).items()}
        steps_out[name] = k2_step_breakdown(torch, name, model, opt, batch, B * S)
    del model_m, model_z
    torch.cuda.empty_cache()
    print(json.dumps({"ssm_training": steps_out}, default=float))

    entries = []
    for arch, n_f, n_b in ((cfg_m.name, n_m[0], n_m[1]), (cfg_z.name, n_z[0], n_z[1])):
        entry = {"route": "cuda", "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
                 "path": f"{arch} training, python -m repro_torch.launch.train (phase 20 "
                         f"({'c' if arch == cfg_m.name else 'd'}))",
                 "shape": "(B, S, H, P, N, chunk) = " + str(cases[arch]) + ", fp32"}
        entries += [{"name": f"ssd_scan/{arch} training", **entry, "launches": n_f,
                     "max_abs_err": err_fwd[arch], **timed[arch]["forward (with states)"]},
                    {"name": f"ssd_scan_bwd/{arch} training", **entry, "launches": n_b,
                     "max_abs_err": err_bwd[cases[arch]], **timed[arch]["backward"]}]
    return entries


def k1_train_cases(cfg, B, S):
    """{K1 case: (forward, backward) wrapper calls} of one training step of
    `cfg` at B x S with remat "block", from its layer pattern: every
    self-attention layer runs K1 forward twice (the forward and its
    recompute) and backward once; whisper's encoder at its 1500 frames
    (non-causal), its decoder causal; a decoder layer with its window."""
    from repro_torch.models.transformer import layer_windows
    hd, out = cfg.hd(), {}

    def add(case, n):
        f, b = out.get(case, (0, 0))
        out[case] = (f + 2 * n, b + n)
    if cfg.family == "encdec":
        add((B, cfg.encoder_len, cfg.n_heads, cfg.n_kv, hd, False, None), cfg.encoder_layers)
        add((B, S, cfg.n_heads, cfg.n_kv, hd, True, None), cfg.num_layers)
    else:
        for w in layer_windows(cfg, cfg.num_layers):
            add((B, S, cfg.n_heads, cfg.n_kv, hd, True, w), 1)
    return out


def synthetic_on(torch, np, cfg, B, S, seed):
    """`synthetic_batch` of `cfg` at B x S from a numpy generator seeded
    with `seed` (whisper's frames, token ids as int64), as tensors on the
    card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.data import synthetic_batch
    b = synthetic_batch(np.random.default_rng(seed), cfg,
                        ShapeConfig(name="train", seq_len=S, global_batch=B, kind="train"))
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v))
            for k, v in b.items()}


def numpy_state(torch, np, cfg, seed):
    """The port's state dict of `cfg` drawn with numpy and carried through
    `repro`'s param tree (params_to_jax, then params_from_jax): both
    devices get these bits. The scales are tests/test_torch_train.py's (the
    fan-in's, 0.02 for the embeddings, 0.1 for the norms, the biases and
    every 1-D leaf); the draws are uniform of unit variance, each tensor
    filled in 8 parts by 8 threads with generators spawned from `seed`
    (1-2 B parameters take seconds, not a minute)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.models.model import Model
    from repro_torch.models.runtime import Runtime
    meta = Model(cfg, Runtime(device="meta", compute_dtype=torch.float32), seed=None)
    shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    seeds = iter(np.random.SeedSequence(seed).spawn(8 * len(shapes)))
    sd, parts = {}, []
    for name, shape in shapes.items():
        leaf = name.split(".")[-1]
        scale = (0.1 if leaf.startswith(("ln", "b", "final_ln")) or len(shape) == 1
                 else 0.02 if leaf in ("embed", "unembed") else shape[-2] ** -0.5)
        sd[name] = np.empty(shape, np.float32)
        flat = sd[name].reshape(-1)
        parts += [(flat[i * flat.size // 8:(i + 1) * flat.size // 8], next(seeds), scale)
                  for i in range(8)]

    def fill(part):
        x, ss, scale = part
        np.random.default_rng(ss).random(out=x, dtype=np.float32)
        x -= np.float32(0.5)
        x *= np.float32(12 ** 0.5 * scale)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, parts))
    return params_from_jax(params_to_jax(sd, cfg), cfg)


def train_family(torch, np, cfg, B, S, steps=3):
    """(b)-(d) of phase 21: `cfg` at full width (random weights from
    SEED), fp32, remat "block", `steps` steps of make_train_step on
    synthetic_batch batches: loss, grad norm, host ms (ending in the read of
    the loss), peak memory and K1's calls by case per step, the last held to
    the layer pattern's (`k1_train_cases`); the step's loss and gradients
    computed twice from the same weights and batch, compared bit for bit;
    the MoE capacity drops of one forward; where one step's time goes.
    Returns (the figures, {case: (forward, backward) calls over the steps})."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.models import moe
    from repro_torch.models.model import Model, loss_fn
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    rt = Runtime(device="cuda", compute_dtype=torch.float32, remat="block")
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    model = Model(cfg, rt, seed=SEED).requires_grad_(True)
    st = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, rt, AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40))
    torch.cuda.synchronize()
    print(f"    {cfg.param_count():,} parameters ({cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "")
          + f"), batch {B} x {S}; weights and AdamW state on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30 - before:.2f} GiB ({before:.2f} GiB "
          "allocated before them, in the peaks below)")
    expect = k1_train_cases(cfg, B, S)
    counters = (flash_attention, flash_attention_bwd)
    total = {case: (0, 0) for case in expect}
    res = {"params": cfg.param_count(), "layers": cfg.num_layers, "batch": [B, S],
           "loss": [], "grad_norm": [], "host_ms": [], "peak_gib": []}
    for s in range(steps):
        batch = {k: v.cuda() for k, v in synthetic_on(torch, np, cfg, B, S, SEED + s).items()}
        for c in counters:
            c.launches, c.launches_by_case = 0, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, st, m = step(model, st, batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        host_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {case: (flash_attention.launches_by_case.get(case, 0),
                      flash_attention_bwd.launches_by_case.get(case, 0))
               for case in set(expect) | set(flash_attention.launches_by_case)
               | set(flash_attention_bwd.launches_by_case)}
        for case, (f, b) in got.items():
            total[case] = (total.get(case, (0, 0))[0] + f, total.get(case, (0, 0))[1] + b)
        print(f"    step {s}: loss {loss:.6f}, grad norm {gnorm:.6f}; host {host_ms:.1f} ms; "
              f"peak {peak:.2f} GiB; K1 forward, backward calls by case "
              + ", ".join(f"{case}: {f}, {b}" for case, (f, b) in sorted(got.items(), key=str)))
        check(np.isfinite(loss) and np.isfinite(gnorm), f"{cfg.name} step {s}: finite")
        check(got == expect, f"{cfg.name} step {s}: K1 calls by case {got}, the layer "
              f"pattern gives {expect}")
        for k, x in (("loss", loss), ("grad_norm", gnorm), ("host_ms", host_ms), ("peak_gib", peak)):
            res[k].append(x)
    batch = {k: v.cuda() for k, v in synthetic_on(torch, np, cfg, B, S, SEED + steps).items()}
    names, leaves = zip(*model.named_parameters())

    def loss_and_grads():
        loss, _ = loss_fn(model, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    l1, g1 = loss_and_grads()
    g1 = [g.cpu() for g in g1]
    l2, g2 = loss_and_grads()
    differ = []
    for name, a, b in zip(names, g1, g2):
        b = b.cpu()
        if not torch.equal(a, b):
            differ.append((name, (a - b).abs().max().item()))
    del g1, g2
    res["repeat_bitwise"] = torch.equal(l1, l2) and not differ
    print(f"    the step's loss and gradients twice from the same weights and batch: loss "
          f"bitwise {torch.equal(l1, l2)} ({l1.item()!r}, {l2.item()!r}); "
          f"{len(names) - len(differ)} of {len(names)} gradients bitwise equal"
          + (f"; differ (largest |d|): {differ[:12]}" if differ else ""))
    if cfg.moe:
        moe.moe_mlp.dropped = 0
        with torch.no_grad():
            model(batch["tokens"])
        dropped, pairs = int(moe.moe_mlp.dropped), B * S * cfg.moe.top_k * cfg.num_layers
        res["moe_dropped"] = dropped
        print(f"    MoE capacity (factor {cfg.moe.capacity_factor}) drops {dropped} of {pairs} "
              f"(token, choice) pairs in one forward ({dropped / pairs:.2%})")

    def one_step():
        step(model, st, batch)
    wall_ms, by_name, counts = device_breakdown(torch, one_step, reps=1)
    dev_ms = sum(by_name.values())
    res["step_host_ms"] = wall_ms
    if not by_name:
        print(f"    one step: host {wall_ms:.2f} ms; the profiler recorded no device time")
    else:
        parts = k1_train_shares(by_name, counts)
        res.update(device_ms=dev_ms, idle=1 - dev_ms / wall_ms, launches=sum(counts.values()),
                   k1_forward_ms=parts["K1 forward"][0], k1_backward_ms=parts["K1 backward"][0])
        print(f"    one step: host {wall_ms:.2f} ms ({B * S / wall_ms * 1e3:.0f} tokens/s), device "
              f"busy {dev_ms:.2f} ms (idle {1 - dev_ms / wall_ms:.1%}), {len(by_name)} kernel "
              f"names, {res['launches']} launches")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"      {ms:8.3f} ms x{counts[kname]:<5d} {kname[:90]}")
        for label, (ms, n) in parts.items():
            print(f"    {label} {ms:.3f} ms x{n}, {ms / dev_ms:.1%} of device time")
        check(parts["K1 forward"][0] > 0,
              f"{cfg.name}: the step's K1 forward share, by the rule's kernel names")
    del model, st, batch
    torch.cuda.empty_cache()
    return res, total


def card_against_cpu_step(torch, np, cfg, B, S):
    """(e) of phase 21: one train step of `cfg` (fp32, remat "block") from
    the same numpy weights and synthetic batch on the card and on the CPU:
    the loss within 1e-5 and the grad norm within 1e-4 relative (phase
    19's rule); the largest gradient difference per leaf printed; K1 on the
    card only, as the layer pattern gives."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.models.model import Model
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    t0 = time.perf_counter()
    sd = numpy_state(torch, np, cfg, SEED + 5)
    batch = synthetic_on(torch, np, cfg, B, S, SEED + 7)
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40)
    out = {}
    for dev in ("cuda", "cpu"):
        rt = Runtime(device=dev, compute_dtype=torch.float32, remat="block")
        model = Model(cfg, rt, seed=None)
        model.load_state_dict(sd)
        st = init_opt_state(dict(model.requires_grad_(True).named_parameters()))
        kept = {}

        def keep(grads):
            kept.update({k: g.cpu() for k, g in grads.items()})
            return grads
        for c in (flash_attention, flash_attention_bwd):
            c.launches, c.launches_by_case = 0, {}
        t1 = time.perf_counter()
        _, _, m = make_train_step(cfg, rt, opt, grad_transform=keep)(
            model, st, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (m["loss"].item(), m["grad_norm"].item(), kept,
                    {case: (flash_attention.launches_by_case.get(case, 0),
                            flash_attention_bwd.launches_by_case.get(case, 0))
                     for case in set(flash_attention.launches_by_case)
                     | set(flash_attention_bwd.launches_by_case)},
                    time.perf_counter() - t1)
        del model, st
    torch.cuda.empty_cache()
    (lg, ng, gg, kg, tg), (lc, nc, gc, kc, tc) = out["cuda"], out["cpu"]
    dl, dn = abs(lg - lc) / abs(lc), abs(ng - nc) / abs(nc)
    # relative to the largest gradient entry of the model: some leaves'
    # gradients are rounding noise around 0 (whisper's cross-attention key
    # bias shifts every score of a query alike, which softmax ignores)
    top = max(g.abs().max().item() for g in gc.values())
    worst = max(((gg[k] - gc[k]).abs().max().item() / top, k) for k in gc)
    print(f"    {cfg.name}, {cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "")
          + f", {B} x {S}: loss cuda {lg:.7f} cpu {lc:.7f} (relative {dl:.3g} <= 1e-5), grad "
          f"norm {ng:.6f} / {nc:.6f} ({dn:.3g} <= 1e-4); largest gradient difference "
          f"{worst[0]:.3g} of the largest |g| ({worst[1]}); K1 calls cuda {kg}, cpu {kc}; "
          f"step {tg:.1f} s on the card, {tc:.1f} s on the CPU ({time.perf_counter() - t0:.1f} s "
          "with the draws)")
    check(dl <= 1e-5 and dn <= 1e-4, f"{cfg.name}: card against CPU")
    check(kc == {} and kg == k1_train_cases(cfg, B, S), f"{cfg.name}: K1 on the card only")
    return {"loss_rel": dl, "grad_norm_rel": dn, "worst_grad_rel": worst[0]}


def int8_and_gpipe(torch, np):
    """(f) of phase 21: `compress_grads` over two rounds on smollm-135m's
    full-width gradients, card against CPU bit for bit; 5 full-width steps
    with and without `int8_compress_decompress`; `pipeline_apply` on the
    card against the sequential application, outputs and gradients."""
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import (
        compress_grads,
        compressed_bytes,
        int8_compress_decompress,
    )
    from repro_torch.models.model import Model, loss_fn
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.data import MarkovLMDataset
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.pipeline import pipeline_apply
    from repro_torch.train.train_step import make_train_step
    cfg = get_config("smollm-135m")
    B, S = 8, 256
    rt = Runtime(device="cuda", compute_dtype=torch.float32, remat="block")
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=S, batch=B, seed=0)

    def batch_at(s):
        return {k: torch.as_tensor(v).long().cuda() for k, v in ds.batch_at(s).items()}
    model = Model(cfg, rt, seed=SEED).requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    grads = []
    for s in range(2):
        loss, _ = loss_fn(model, batch_at(s))
        grads.append(dict(zip(names, torch.autograd.grad(loss, leaves))))
    t0 = time.perf_counter()
    err, rounds = None, []
    for g in grads:
        sent, err = compress_grads(g, err)
        rounds.append((sent, err))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err_c, differ, n = None, [], 0
    for r, (g, (sent, err)) in enumerate(zip(grads, rounds)):
        sent_c, err_c = compress_grads({k: v.cpu() for k, v in g.items()}, err_c)
        for k in g:
            for what, a, b in (("sent", sent[k].cpu(), sent_c[k]), ("residual", err[k].cpu(),
                                                                     err_c[k])):
                n += 1
                if not torch.equal(a, b):
                    differ.append((r, k, what, (a.float() - b.float()).abs().max().item()))
    same = n - len(differ)
    wire, full = compressed_bytes(grads[0]), sum(4 * v.numel() for v in grads[0].values())
    print(f"    compress_grads, two rounds of error feedback over smollm-135m's {len(names)} "
          f"full-width gradients ({full / 1e6:.1f} MB fp32, {wire / 1e6:.1f} MB on the wire): "
          f"{ms:.1f} ms on the card (host clock); sent values and residuals bitwise equal to "
          f"the CPU's: {same} of {n}" + (f"; differ (round, leaf, what, max|d|): {differ[:6]}"
                                           if differ else ""))
    check(not differ, "compress_grads: card and CPU bit for bit")
    del grads, rounds, err, err_c, model
    curves = {}
    for label, transform in (("uncompressed", None), ("int8", int8_compress_decompress)):
        model = Model(cfg, rt, seed=SEED).requires_grad_(True)
        st = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, rt, AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40),
                               grad_transform=transform)
        curve = []
        for s in range(5):
            model, st, m = step(model, st, batch_at(s))
            curve.append((m["loss"].item(), m["grad_norm"].item()))
        curves[label] = curve
        del model, st
    for label, curve in curves.items():
        print(f"    5 full-width smollm-135m steps, {label}: "
              + ", ".join(f"loss {a:.6f} gnorm {g:.6f}" for a, g in curve))
    check(all(np.isfinite(x) for c in curves.values() for p in c for x in p),
          "finite int8 and uncompressed steps")
    torch.cuda.empty_cache()
    L, d, Bp = 8, 768, 64
    g = torch.Generator("cuda").manual_seed(SEED)
    base = {"w": torch.randn(L, d, d, generator=g, device="cuda") * d ** -0.5,
            "b": torch.randn(L, d, generator=g, device="cuda") * 0.1}
    x = torch.randn(Bp, d, generator=g, device="cuda")
    tgt = torch.randn(Bp, d, generator=g, device="cuda")

    def block(p_l, h):
        return torch.tanh(h @ p_l["w"] + p_l["b"])

    def sequential(p, h):
        for layer in range(L):
            h = block({k: v[layer] for k, v in p.items()}, h)
        return h

    def run(fn):
        p = {k: v.clone().requires_grad_() for k, v in base.items()}
        out = fn(p, x)
        grads = torch.autograd.grad(((out - tgt) ** 2).mean(), list(p.values()))
        return out.detach(), dict(zip(p, grads))
    seq_out, seq_g = run(sequential)
    for stages, mbs in ((2, 4), (4, 8)):
        out, grads = run(lambda p, h: pipeline_apply(p, h, block, L, stages, mbs))
        d_out = (out - seq_out).abs().max().item()
        d_g = {k: (grads[k] - seq_g[k]).abs().max().item() for k in grads}
        ok = (torch.allclose(out, seq_out, rtol=1e-5, atol=1e-5)
              and all(torch.allclose(grads[k], seq_g[k], rtol=1e-4, atol=1e-5) for k in grads))
        print(f"    pipeline_apply, {L} layers of width {d}, batch {Bp}, {stages} stages x {mbs} "
              f"microbatches ({mbs + stages - 1} ticks) against the sequential layers: max|d| "
              f"output {d_out:.3g}, gradients " + ", ".join(f"{k} {v:.3g}" for k, v in d_g.items())
              + f" [tests/test_pipeline.py's tolerances] {'ok' if ok else 'FAIL'}")
        check(ok, f"pipeline_apply ({stages}, {mbs}) on the card")
    return {"int8_curves": curves}


FAMILIES = (("whisper-small", None, 8, 448), ("gemma3-4b", 12, 1, 4096),
            ("mixtral-8x7b", 2, 1, 4096))


def families_train_path(torch, np):
    """Phase 21: K1's fp32 forward and backward at the five training cases
    of whisper-small, gemma3-4b and mixtral-8x7b, held and timed; the three
    trained at full width through make_train_step; card against CPU; int8
    compression and GPipe on the card. Returns the kernels record's K1
    entries of the three training paths."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    cfgs = {}
    for arch, n_layers, B, S in FAMILIES:
        full = get_config(arch)
        cfgs[arch] = (full if n_layers is None else dc.replace(full, num_layers=n_layers), B, S)
    full_g, full_m = get_config("gemma3-4b"), get_config("mixtral-8x7b")
    print(f"  depth cuts (fp32 AdamW holds 16 bytes a parameter, 80 GB on the card): gemma3-4b "
          f"{full_g.param_count():,} parameters at 34 layers -> {cfgs['gemma3-4b'][0].param_count():,} "
          f"at 12 (10 local, 2 global: its 5:1 pattern), its fp32 logits over 262144 rows "
          f"at 4096 tokens 4.3 GB; mixtral-8x7b {full_m.param_count():,} at 32 -> "
          f"{cfgs['mixtral-8x7b'][0].param_count():,} at 2; whisper-small whole")
    cases = {}
    for arch, (cfg, B, S) in cfgs.items():
        for case in k1_train_cases(cfg, B, S):
            label = (arch + (" encoder" if not case[5] else " decoder") if cfg.family == "encdec"
                     else arch + ("" if arch.startswith("mixtral") else
                                  " local" if case[6] else " global"))
            cases[case] = (label, arch)
    check(len(cases) == 5, f"five K1 training cases: {sorted(cases, key=str)}")
    print(f"  (a) K1 fp32 forward and backward at the five training cases {sorted(cases, key=str)}")
    err_bwd, timed = {}, {}
    for case, (label, _) in cases.items():
        print(f"   {label} {case}:")
        err_bwd[case] = hold_flash_bwd(torch, case, "fp32", small=False)
        timed[case] = time_k1_train(torch, case)
    figures, launches = {}, {}
    for tag, (arch, (cfg, B, S)) in zip("bcd", cfgs.items()):
        print(f"  ({tag}) {arch} at full width, make_train_step on synthetic_batch, fp32, remat "
              f"\"block\", 3 steps")
        figures[arch], by_case = train_family(torch, np, cfg, B, S)
        for case, n in by_case.items():
            launches[case] = (n, f"{arch} training, make_train_step on synthetic_batch "
                                 f"(phase 21 ({tag}))")
    print("  (e) card against CPU on the same numpy weights: one train step each, fp32")
    cut = {"whisper-small": (dc.replace(cfgs["whisper-small"][0], num_layers=2,
                                        encoder_layers=2), 1, 64),
           "gemma3-4b": (dc.replace(full_g, num_layers=6), 1, 1100),
           "mixtral-8x7b": (dc.replace(full_m, num_layers=1), 1, 300)}
    figures["card_against_cpu"] = {arch: card_against_cpu_step(torch, np, *c)
                                   for arch, c in cut.items()}
    print("  (f) int8 gradient compression and the GPipe schedule on the card")
    figures["int8_gpipe"] = int8_and_gpipe(torch, np)
    print(json.dumps({"families_training": figures}, default=float))
    entries = []
    for case, (label, arch) in cases.items():
        (n_f, n_b), path = launches[case]
        entry = {"route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:87", "path": path,
                 "shape": "(B, S, Hq, Hkv, hd, causal, window) = " + str(case) + ", fp32"}
        out, err_fwd = timed[case]
        entries += [{"name": f"flash_attention/{label} training", **entry, "launches": n_f,
                     "max_abs_err": err_fwd, **out["forward (with lse)"]},
                    {"name": f"flash_attention_bwd/{label} training", **entry, "launches": n_b,
                     "max_abs_err": err_bwd[case], **out["backward"]}]
    return entries

# phase 23: training across a 2x2 ("data", "model") mesh of four ranks that
# share the card: (arch, layers, batch, seq, extra launcher flags). Depth is
# cut: four ranks' DTensor dispatch under one interpreter lock takes 1.14 s
# per smollm layer and step and 0.77 s per mamba2 layer and step (34 and 37
# s a step at full depth on an H100 80GB HBM3 at 700 W, PERF.md §6), which
# at 30 and 48 layers would take the script past its time limit. mixtral at one layer diverges
# at the launcher's lr 3e-3 (its grad norm 19 -> 75 in five steps, a CPU
# rehearsal), which would amplify bf16's rounding differences between the
# mesh and one rank: it trains at 3e-4
MESH_PATHS = (("smollm-135m", 4, 8, 256, ()), ("mamba2-370m", 6, 8, 256, ()),
              ("mixtral-8x7b", 1, 1, 4096, ("--lr", "3e-4")))
MESH_STEPS = 5
# K1's bf16 backward beside SDPA's at whole layers, (B, S, Hq, Hkv, hd,
# causal, window): the training cases of phase 21 in the mesh's dtype
K1_BF16_LAYERS = {"mixtral-8x7b": (1, 4096, 32, 8, 128, True, 4096),
                  "gemma3-4b local": (1, 4096, 8, 4, 256, True, 1024),
                  "gemma3-4b global": (1, 4096, 8, 4, 256, True, None),
                  "whisper-small encoder": (8, 1500, 12, 12, 64, False, None)}


def cfg_family(arch):
    from repro_torch.configs import get_config
    return get_config(arch).family


def mesh_argv(arch, layers, B, S, ck, *extra, mesh=True):
    """The launcher's argv of a phase 23 run (without `mesh`: one rank)."""
    argv = ["--arch", arch, "--steps", str(MESH_STEPS), "--batch", str(B), "--seq", str(S),
            "--log-every", "1", "--ckpt-dir", ck, *extra]
    argv += ["--layers", str(layers)] if layers else []
    return argv + (["--data", "2", "--model", "2", "--backend", "threaded"] if mesh else [])


def mesh_step_figures(torch, argv):
    """One rank of the launcher's mesh per thread (the threaded group, as
    the main path), built from the launcher's own pieces, at argv's run,
    after the main path warmed DTensor's caches: one step timed (host
    clock, all ranks at once; tokens/s; the four ranks' peak memory above
    what the process held before), one counting the collectives each rank
    issues by kind (`CollectiveCounter`), one under torch.profiler (device
    time by kernel, idle share). Returns those figures."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import CollectiveCounter, make_mesh_shape, run_threaded
    from repro_torch.models.model import Model
    from repro_torch.train.data import MarkovLMDataset
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    args = launch_train._parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    box = {}
    held = torch.cuda.memory_allocated()        # what earlier phases still hold
    # the profiler starts and stops in the main thread (as device_breakdown's
    # does) while every rank, a thread of its own, is parked at `gate` with
    # the device idle: the profiled step runs between the two. A stop while
    # ranks still launched or tore down killed the process twice (SIGSEGV,
    # then SIGABRT in torch.profiler's stop_trace; ROADMAP queue 3)
    gate = threading.Barrier(5, timeout=600)

    def rank_fn(rank):
        try:
            return rank_steps(rank)
        except BaseException:
            gate.abort()                        # wake the main thread and the other ranks
            raise

    def rank_steps(rank):
        torch.cuda.set_device(0)
        mesh = make_mesh_shape((2, 2), ("data", "model"), "cuda")
        rt = launch_train.mesh_runtime(cfg, args, mesh)
        model = Model(cfg, rt, seed=0).requires_grad_(True)
        st = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, rt, AdamWConfig(peak_lr=args.lr, warmup_steps=5,
                                                    total_steps=args.steps))
        ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=0)
        b = {k: torch.from_numpy(v).long().cuda() for k, v in ds.batch_at(0).items()}
        b = sh.distribute_tree(mesh, b, sh.batch_specs(mesh, b))
        dist.barrier()
        torch.cuda.synchronize()
        if rank == 0:
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        step(model, st, b)
        torch.cuda.synchronize()
        dist.barrier()
        ms = (time.perf_counter() - t0) * 1e3
        with CollectiveCounter() as comm:       # a dispatch mode: not timed
            step(model, st, b)
        torch.cuda.synchronize()
        if rank == 0:
            box["peak"] = torch.cuda.max_memory_allocated() - held
        gate.wait()                             # all parked: the profiler starts
        gate.wait()                             # it has started
        dist.barrier()
        t0 = time.perf_counter()
        step(model, st, b)
        torch.cuda.synchronize()
        dist.barrier()
        if rank == 0:
            box["wall"] = (time.perf_counter() - t0) * 1e3
        gate.wait()                             # all parked: the profiler stops
        gate.wait()                             # it has stopped
        return comm.counts, ms

    def meet(what):
        try:
            gate.wait()
        except threading.BrokenBarrierError:
            ranks.join()
            check(False, f"the ranks {what}")

    ranks = threading.Thread(target=lambda: box.update(outs=run_threaded(4, rank_fn)))
    ranks.start()
    meet("reached the profiled step")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        meet("saw the profiler start")
        meet("ran the profiled step")
        torch.cuda.synchronize()
    meet("saw the profiler stop")
    ranks.join()
    check("outs" in box, "every rank ran its steps")
    box["prof"] = prof
    outs = box["outs"]
    counts, ms = outs[0]
    check(all(o[0] == counts for o in outs), "every rank issues the same collectives")
    by_name, launches = {}, {}
    for e in box["prof"].events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launches[e.name] = launches.get(e.name, 0) + 1
    dev = sum(by_name.values())
    wall = box["wall"]
    k1 = kernel_share(by_name, launches, (k1_fwd_name(cfg),) + k1_bwd_names(cfg.hd()))
    k2 = kernel_share(by_name, launches, ("chunk_state", "state_pass", "chunk_scan", "ssd_bwd"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    fig = {"collectives_per_step_per_rank": counts, "step_ms": ms,
           "tokens_per_s": args.batch * args.seq / (ms / 1e3),
           "peak_gib_all_ranks": box["peak"] / 2 ** 30,
           "profiled_step": {"host_ms": wall, "device_busy_ms": dev,
                             "idle_share": 1 - dev / wall if wall else None,
                             "launches": sum(launches.values()),
                             "k1_ms": sum(v[0] for v in k1.values()),
                             "k1_by_kernel": k1,
                             "k2_ms": sum(v[0] for v in k2.values()),
                             "top": [(k[:80], v, launches[k]) for k, v in top]}}
    print(f"    collectives per step and rank: {counts} ({args.layers} layers); step "
          f"{ms:.1f} ms (host clock, four ranks at once), {fig['tokens_per_s']:.0f} tokens/s, "
          f"peak {fig['peak_gib_all_ranks']:.2f} GiB (all four ranks); one profiled step: host "
          f"{wall:.1f} ms, device busy {dev:.1f} ms "
          f"(idle {fig['profiled_step']['idle_share']:.1%}), {fig['profiled_step']['launches']} "
          f"launches, K1 {fig['profiled_step']['k1_ms']:.2f} ms ("
          + ", ".join(f"{k} {v:.3f} ms x{n}" for k, (v, n) in k1.items() if n)
          + f"), K2 {fig['profiled_step']['k2_ms']:.2f} ms")
    for k, v in top:
        print(f"      {v:8.3f} ms x{launches[k]:<5d} {k[:90]}")
    return fig


def time_k1_local(torch, case):
    """K1 in bf16 at a rank's local shape of the mesh path (or another bf16
    case): the forward held to phase 7's long bf16 rule, the backward by
    `hold_flash_bwd`; device time of the forward with its lse and of the
    backward beside the plain versions', the bound (bf16 tensor-core peak
    or the bytes; the backward's five products) and
    scaled_dot_product_attention's (default backend, K/V repeated, BHSD
    copies made beforehand, a boolean mask where the window bites; the
    backward alone is forward + backward less the forward); the backward
    also beside the split-bf16 scheme's own tensor-core floor (ten bf16
    products per kept (query, key) pair: S and dP in both kernels, P^T dO,
    dS^T Q and dS K in two terms each). Returns ({"forward (with lse)":
    numbers, "backward": ...}, the forward's max|d|, the backward's)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    B, S, Hq, Hkv, hd, causal, window = case
    kw = {"causal": causal, "window": window}
    q, k, v, pos = flash_inputs(torch, case, torch.bfloat16)
    do = flash_inputs(torch, case, torch.bfloat16, seed=SEED + 1)[0]
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    ref = attention_ref(q, k, v, pos, pos, **kw).float()
    err = (o.float() - ref).abs()
    ok = bool((err <= 1e-2 * ref.abs() + 1e-4 * ref.abs().max()).all())
    err_fwd = err.max().item()
    print(f"    {case} bf16 forward: max|d| {err_fwd:.3g} (max|ref| {ref.abs().max().item():.3g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok and torch.isfinite(o).all().item(), f"flash_attention {case} bf16 (mesh shard)")
    del ref, err
    err_bwd = hold_flash_bwd(torch, case, "bf16", small=False)
    f_ms = graph_ms(torch, lambda: flash_attention(q, k, v, return_lse=True, **kw))
    b_ms = graph_ms(torch, lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))
    pf_ms = graph_ms(torch, lambda: attention_ref(q, k, v, pos, pos, return_lse=True, **kw),
                     calls=3, reps=5)
    pb_ms = graph_ms(torch, lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw),
                     calls=3, reps=5)
    rep = Hq // Hkv
    qt, kt, vt = (t.repeat_interleave(r, 2).transpose(1, 2).contiguous().requires_grad_()
                  for t, r in ((q, 1), (k, rep), (v, rep)))
    dot = do.transpose(1, 2).contiguous()
    mask, is_causal = None, causal
    if window is not None and window < S:
        i = torch.arange(S, device="cuda")
        mask, is_causal = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window), False

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                 is_causal=is_causal)
    lf_ms = graph_ms(torch, sdpa)
    lfb_ms = graph_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    fwd_work = flash_work(case, "bf16")
    fwd_work = (fwd_work[0] + B * Hq * S * 4, fwd_work[1])    # and the lse written
    out = {}
    for name, ms, p_ms, l_ms, (nbytes, flops) in (
            ("forward (with lse)", f_ms, pf_ms, lf_ms, fwd_work),
            ("backward", b_ms, pb_ms, lfb_ms - lf_ms, flash_bwd_work(case, "bf16"))):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        out[name] = {"ms": ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": l_ms}
        floor = ""
        if name == "backward":
            fl = out[name]["split_bf16_floor_ms"] = 2 * flops / PEAK_FLOPS["bf16"] * 1e3
            floor = f"; split-bf16 floor {fl:.5f} ms ({fl / ms:.1%})"
        print(f"    {name}: kernel {ms:.4f} ms; bound {bound:.5f} ms ({by}: {flops / 1e9:.3f} "
              f"GFLOP at 989 TFLOP/s bf16, {nbytes / 1e6:.2f} MB at 3.35 TB/s; {bound / ms:.1%})"
              f"{floor}; plain {p_ms:.4f} ms; scaled_dot_product_attention {l_ms:.4f} ms"
              f"{' (boolean window mask)' if mask is not None else ''}")
    del q, k, v, o, lse, do, qt, kt, vt, dot, mask
    torch.cuda.empty_cache()
    return out, err_fwd, err_bwd


def time_k2_local(torch, case):
    """K2 in bf16 at a rank's local shape of the mesh path, on strided views
    of one packed tensor: the forward held by `hold_ssd`, the backward by
    `hold_ssd_bwd`; device time of the forward with its states and of the
    backward beside the plain versions' and the bound (bf16 tensor-core
    peak or the bytes). Returns ({"forward (with states)": numbers,
    "backward": ...}, the forward's max|dy|, the backward's max|d|)."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
    B, S, H, P, N, chunk = case
    err_fwd = hold_ssd(torch, case, "bf16 strided")
    err_bwd = hold_ssd_bwd(torch, case, "bf16 strided", final_state=False)
    args = strided_views(torch, case, ssd_inputs(torch, case, torch.bfloat16))
    dy = torch.randn(B, S, H, P, generator=torch.Generator("cuda").manual_seed(SEED + 1),
                     device="cuda").to(torch.bfloat16)
    _, _, h_prev = ssd_scan(*args, chunk=chunk, return_states=True)
    hp_ref = ssd_chunked_ref(*args, chunk=chunk, return_states=True)[2]
    f_ms = graph_ms(torch, lambda: ssd_scan(*args, chunk=chunk, return_states=True))
    b_ms = graph_ms(torch, lambda: ssd_scan_bwd(*args, h_prev, dy, chunk=chunk))
    pf_ms = graph_ms(torch, lambda: ssd_chunked_ref(*args, chunk=chunk, return_states=True),
                     calls=3, reps=5)
    pb_ms = graph_ms(torch, lambda: ssd_chunked_bwd_ref(*args, hp_ref, dy, chunk=chunk),
                     calls=3, reps=5)
    nb_f, fl_f = ssd_work(case, "bf16")
    nb_f += B * -(-S // min(chunk, S)) * H * P * N * 4          # and the states written
    out = {}
    for name, ms, p_ms, (nbytes, flops) in (
            ("forward (with states)", f_ms, pf_ms, (nb_f, fl_f)),
            ("backward", b_ms, pb_ms, ssd_bwd_work(case, "bf16"))):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        print(f"    {name}: kernel {ms:.4f} ms; bound {bound:.5f} ms ({by}: {flops / 1e9:.3f} "
              f"GFLOP at 989 TFLOP/s bf16, {nbytes / 1e6:.2f} MB at 3.35 TB/s; {bound / ms:.1%}); "
              f"plain {p_ms:.4f} ms; no library call computes it")
        out[name] = {"ms": ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None}
    return out, err_fwd, err_bwd


def mesh_path(torch, np):
    """Phase 23: training across a 2x2 ("data", "model") mesh of four ranks
    sharing the card, each a thread of this process on torch's threaded
    group (fixed: NCCL refuses two ranks on one device, and gloo processes
    sharing the card die in torch's functional all-gather, ROADMAP queue
    3), through
    `python -m repro_torch.launch.train --data 2 --model 2 --backend
    threaded`, bf16 compute: (a) smollm-135m (4 of 30 layers) and (b)
    mamba2-370m (6 of 48) at full width, 5 steps of 8 x 256; (c)
    mixtral-8x7b at full width, 1 of 32 layers, 1 x 4096 (MESH_PATHS says
    why the depth is cut). For each: K1's and K2's launches per step and
    rank at each rank's local shapes, the losses against the same run on
    one rank (bf16, within 2e-2: all five steps of (a) and (b), the first
    of (c), whose top-2 routing parts the trajectories), a `--fail-at`
    resume bit for bit in (a),
    collectives per step by kind, step ms, tokens/s, peak memory and one
    profiled step; then K1 and K2 held against their plain versions and
    timed at the local shapes, and K1 at K1_BF16_LAYERS. Returns the
    kernels record's entries."""
    import shutil
    import tempfile

    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            flash_attention_bwd, forward_kernel)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.launch import train as launch_train
    from repro_torch.models.runtime import Runtime
    kernels = (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)
    tmp = tempfile.mkdtemp(prefix="mesh_path_")
    figures, local_cases = {}, {}
    try:
        for tag, (arch, layers, B, S, flags) in zip("abc", MESH_PATHS):
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  ({tag}) {arch} at full width{f', {layers} layer(s)' if layers else ''}, "
                  f"{MESH_STEPS} steps of {B} x {S}, bf16, on a 2x2 mesh of four threaded ranks "
                  "sharing the card (python -m repro_torch.launch.train --backend threaded)")
            argv = mesh_argv(arch, layers, B, S, os.path.join(tmp, f"{tag}-run"), "--ckpt-every",
                             "0", *flags)
            for fn in kernels:
                fn.launches, fn.launches_by_case = 0, {}
            t0 = time.perf_counter()
            run = launch_train.main(argv)                   # the main path
            wall = time.perf_counter() - t0
            counts = {fn.__name__: (fn.launches, dict(fn.launches_by_case)) for fn in kernels}
            # keep the metrics only: rank 0's model and AdamW state go
            metrics, restarts = run["metrics"], run["restarts"]
            del run
            losses = [m["loss"] for m in metrics]
            check(len(losses) == MESH_STEPS and all(np.isfinite(losses)) and restarts == 0,
                  f"{arch}: {MESH_STEPS} finite steps on the mesh")
            per_step = {name: n / (MESH_STEPS * 4) for name, (n, _) in counts.items()}
            k1_name, k2_name = "flash_attention", "ssd_scan"
            used = k2_name if arch.startswith("mamba2") else k1_name
            check(counts[used][0] > 0 and counts[used + "_bwd"][0] > 0,
                  f"{arch}: {used} and its backward launched on the mesh path")
            for name, (n, by_case) in counts.items():
                for case, m in by_case.items():
                    local_cases.setdefault((name.replace("_bwd", ""), case), {})[name] = (m, arch)
            print(f"    {wall:.1f} s; losses {[round(x, 5) for x in losses]}; launches per step "
                  f"and rank {per_step}; local shapes "
                  + "; ".join(f"{name} {sorted(by_case)}" for name, (_, by_case) in counts.items()
                              if by_case))
            one_args = launch_train._parser().parse_args(mesh_argv(
                arch, layers, B, S, os.path.join(tmp, f"{tag}-one"), "--ckpt-every", "0", *flags,
                mesh=False))
            one = launch_train.train_rank(one_args, rt=Runtime(compute_dtype=torch.bfloat16,
                                                               remat="block"))
            ref = [m["loss"] for m in one["metrics"]]
            del one
            diffs = [abs(a - b) for a, b in zip(losses, ref)]
            diff = max(diffs)
            print(f"    one rank, bf16: losses {[round(x, 5) for x in ref]}; |dloss| by step "
                  f"{[float(f'{d:.3g}') for d in diffs]}")
            # the MoE's top-2 choice is discrete: a bf16 rounding apart (the
            # mesh adds row-parallel partial sums in bf16) flips near-tied
            # tokens' experts, and the trajectories part after the first
            # update (on an H100 80GB HBM3 at 700 W: 1.9e-3 at step 1, 0.028
            # at step 5; the fp32 CPU test holds five mesh steps to repro's
            # within 1e-5 with the same drops): mixtral's first step, from
            # the same weights and batch, is held; the dense and SSM runs'
            # five are
            held = diffs[:1] if cfg_family(arch) == "moe" else diffs
            check(max(held) <= 2e-2, f"{arch}: the mesh's losses within 2e-2 of one rank's (bf16"
                  f"{', the first step' if len(held) == 1 else ''})")
            fig = {"losses": losses, "one_rank_losses": ref, "max_abs_dloss": diff,
                   "launches_per_step_and_rank": per_step, "wall_s": wall}
            if tag == "a":
                # 3 steps, a checkpoint after step 2, a failure before it: steps
                # 0-2 run again from the checkpoint; the lr's warmup (5 steps)
                # makes them the main run's first 3 steps
                t0 = time.perf_counter()
                argv3 = mesh_argv(arch, layers, B, S, os.path.join(tmp, f"{tag}-fail"),
                                  "--ckpt-every", "2", "--fail-at", "2", *flags)
                argv3[argv3.index("--steps") + 1] = "3"
                resumed = launch_train.main(argv3)
                same = ([(m["loss"], m["grad_norm"], m["lr"]) for m in resumed["metrics"]]
                        == [(m["loss"], m["grad_norm"], m["lr"]) for m in metrics[:3]])
                n_restarts = resumed["restarts"]
                del resumed
                print(f"    --steps 3 --ckpt-every 2 --fail-at 2: restarts {n_restarts}, "
                      f"the 3 steps bit for bit {same}, {time.perf_counter() - t0:.1f} s")
                check(n_restarts == 1 and same,
                      f"{arch}: the mesh run resumes after an injected failure bit for bit")
                fig["resume_bitwise"] = same
            gc.collect()
            torch.cuda.empty_cache()
            fig.update(mesh_step_figures(torch, argv))
            figures[arch] = fig
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    entries = []
    for (kind, case), by_fn in sorted(local_cases.items(), key=str):
        arch = next(iter(by_fn.values()))[1]
        print(f"  {kind} at {arch}'s local shape {case} (bf16)")
        if kind == "flash_attention":
            out, e_f, e_b = time_k1_local(torch, case)
            shape = "(B, S, Hq, Hkv, hd, causal, window) = " + str(case) + ", bf16, per rank"
            parts = (("flash_attention", "forward (with lse)", e_f),
                     ("flash_attention_bwd", "backward", e_b))
            cuda_kernels = {"flash_attention": [forward_kernel(case[4], torch.bfloat16)],
                            "flash_attention_bwd": list(k1_bwd_names(case[4]))}
            src, tpu = ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:87")
        else:
            out, e_f, e_b = time_k2_local(torch, case)
            shape = "(B, S, H, P, N, chunk) = " + str(case) + ", bf16, per rank, strided views"
            parts = (("ssd_scan", "forward (with states)", e_f), ("ssd_scan_bwd", "backward", e_b))
            cuda_kernels = {"ssd_scan": list(MMA_KERNELS[1:]),
                            "ssd_scan_bwd": [k for k in K2_BWD_TF32 if k.endswith("bf16>")]
                            + ["state_pass_kernel<true>"]}
            src, tpu = ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/kernel.py:72")
        for fn_name, part, err in parts:
            n = by_fn.get(fn_name, (0, arch))[0]
            nums = dict(out[part])
            # a computed yardstick beside the bound: the figures carry it,
            # the kernels record only what this run measured and bound_ms
            floor = nums.pop("split_bf16_floor_ms", None)
            if floor is not None:
                figures.setdefault("k1_split_bf16_floor_ms", {})[f"{arch} shard"] = floor
            entries.append({"name": f"{fn_name}/{arch} mesh 2x2 rank shard", "route": "cuda",
                            "source": src, "replaces": tpu,
                            "path": f"{arch} training on a 2x2 mesh (phase 23)", "shape": shape,
                            "cuda_kernels": cuda_kernels[fn_name], "launches": n,
                            "max_abs_err": err, **nums})
    print("  K1 in bf16 at whole layers of mixtral-8x7b, gemma3-4b and whisper-small (held and "
          "timed; no run of this phase trains them in bf16)")
    figures["k1_bf16_layers"] = {}
    for name, case in K1_BF16_LAYERS.items():
        print(f"  {name} {case}")
        out, _, e_b = time_k1_local(torch, case)
        figures["k1_bf16_layers"][name] = {"case": case, "backward_max_abs_err": e_b, **out}
    print(json.dumps({"mesh": figures}, default=float))
    return entries


def _front(res):
    """A campaign result dict's front, hypervolume curve (hex) and budget."""
    return ([(p["throughput"], p["power_per_wafer"]) for p in res["front"]],
            [float(h).hex() for h in res["hv"]], res["n_evals"])


def _eval_fields(r):
    """An EvalResult's float64 fields, in a fixed order."""
    if not r.feasible:
        return []
    s = r.step
    return [r.throughput, r.power_w, s.step_time_s, s.pipeline_eff, s.energy_j,
            *(s.breakdown[k] for k in sorted(s.breakdown))]


def _hex_diff(got, want):
    """(float64 fields compared, fields not hex-equal, max rel diff), after
    checking that both hold the same number of rows, at least one, and that
    feasibility, reason and strategy agree row by row."""
    check(len(got) == len(want) > 0, f"{len(got)} rows against {len(want)}, want equal and > 0")
    n = n_hex = 0
    rel = 0.0
    for g, w in zip(got, want):
        check(g.feasible == w.feasible and g.reason == w.reason
              and g.strategy == w.strategy and g.n_wafers == w.n_wafers,
              "same feasibility, reason, strategy and system size")
        for x, y in zip(_eval_fields(g), _eval_fields(w)):
            n += 1
            n_hex += float(x).hex() != float(y).hex()
            rel = max(rel, abs(x - y) / max(abs(y), 1e-300))
    return n, n_hex, rel


def dse_rest_path(torch, np):
    """Phase 22: the rest of the DSE on the card (see the module docstring).
    Returns the figures it prints, as a dict."""
    import os
    import tempfile

    from repro_torch.core import baselines, eval_compiled
    from repro_torch.core.compiler import pinned_resource_ok
    from repro_torch.core.design_space import DesignBatch
    from repro_torch.core.evaluator import (
        _wafers_for_budget_batch, clear_eval_cache, evaluate_design_batch,
        evaluate_pool_fused_joint)
    from repro_torch.core.fidelity import AnalyticalBackend
    from repro_torch.core.mfmobo import _valid_candidates_joint
    from repro_torch.core.validator import validate
    from repro_torch.core.workload import GPT_BENCHMARKS
    from repro_torch.explore import (Campaign, CampaignSpec, ExplorationLoop, FleetSpec,
                                     resolve_workload, run_fleet)
    from repro_torch.explore import fleet as fleet_mod
    from repro_torch.explore.__main__ import main as explore_main
    from repro_torch.explore.campaign import resolve_strategy_space
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    t_phase = time.perf_counter()
    out = {}
    flash_attention.launches = ssd_scan.launches = 0
    joint = ROOT / "examples" / "campaigns" / "gpt175b_joint_dse.json"
    grid = ROOT / "examples" / "campaigns" / "fleet_quick_grid.json"
    hv_base = 79.826

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the joint campaign through the CLI on the card and the CPU
        res = {}
        for dev in ("cuda", "cpu"):
            clear_eval_cache()
            ck, js_out = f"{tmp}/joint.{dev}.ckpt", f"{tmp}/joint.{dev}.json"
            check(explore_main([str(joint), "--device", dev, "--checkpoint", ck,
                                "--out", js_out]) == 0, f"gpt175b_joint_dse on {dev} exits 0")
            with open(js_out) as f:
                r = json.load(f)
            st = ExplorationLoop.load_state(ck)[1]
            res[dev] = (r, [x.tobytes() for x in st.X1 + st.X0], st.trace)
        r, xs, tr_full = res["cuda"]
        same = [a == b for a, b in zip(xs, res["cpu"][1])]
        print(f"  (a) gpt175b_joint_dse: {r['n_evals']} evaluations (want 28), hypervolume "
              f"{r['hv_final']:.3f} (ROADMAP baseline {hv_base:.3f}; CPU run "
              f"{res['cpu'][0]['hv_final']:.3f}), wall {r['wall_s']:.2f} s, "
              f"{r['candidates_per_sec']:.2f} candidates/s (CPU run "
              f"{res['cpu'][0]['wall_s']:.2f} s); evaluated joint points (f1 then f0) equal "
              f"to the CPU run's: {sum(same)}/{len(same)}; front strategies: "
              + "; ".join(p["describe"].split(" | ")[-1] for p in r["front"][:3]))
        check(r["finished"] and r["n_evals"] == 28, "gpt175b_joint_dse: exact budget")
        check(round(r["hv_final"], 3) == hv_base, "gpt175b_joint_dse: ROADMAP's hypervolume")
        check(all(same) and len(same) == 28, "the CPU run's joint points")
        ck = f"{tmp}/resume.ckpt"
        clear_eval_cache()
        check(explore_main([str(joint), "--device", "cuda", "--max-steps", "2",
                            "--checkpoint", ck, "--out", f"{tmp}/r.json"]) == 0, "step 2")
        check(ExplorationLoop.load_state(ck)[1].steps == 2, "checkpoint at step 2")
        clear_eval_cache()
        check(explore_main(["--resume", ck, "--device", "cuda", "--out", f"{tmp}/r.json"])
              == 0, "resume")
        tr_r = ExplorationLoop.load_state(ck)[1].trace

        def hexed(t):
            return ([[float(v).hex() for v in x] for x in t.xs],
                    [[float(a).hex(), float(b).hex()] for a, b in t.ys],
                    [float(h).hex() for h in t.hv], [str(p) for p in t.designs])
        print(f"  (a) resumed on the card from its step-2 checkpoint: {tr_r.n_evals} "
              f"evaluations, trace bit-identical to the uninterrupted run: "
              f"{hexed(tr_r) == hexed(tr_full)}")
        check(hexed(tr_r) == hexed(tr_full), "joint resume is bit-identical on the card")
        out["joint"] = {"n_evals": r["n_evals"], "hv": r["hv_final"], "wall_s": r["wall_s"],
                        "cand_per_s": r["candidates_per_sec"],
                        "cpu_wall_s": res["cpu"][0]["wall_s"], "points_equal_cpu": sum(same)}

        # (b) the pinned evaluator on 512 valid joint points against NumPy
        spec = CampaignSpec.from_json(str(joint))
        wl = resolve_workload(spec)
        space = resolve_strategy_space(spec, wl)
        _, pts = _valid_candidates_joint(np.random.default_rng(SEED + 22), 512, space, wl)
        geom = DesignBatch.from_designs([p.design for p in pts])
        nw = _wafers_for_budget_batch(geom, wl)
        strategies = [p.strategy for p in pts]
        # the same designs under random strategies, ep up to 8, on a MoE
        # variant of the workload (8 experts, top-2): the expert terms
        rng = np.random.default_rng(SEED + 23)
        wl_moe = dataclasses.replace(wl, moe_experts=8, moe_topk=2)
        moe_strat = [dataclasses.replace(s, ep=int(2 ** rng.integers(0, 4))) for s in strategies]
        be_ref = AnalyticalBackend(device="cpu")
        eval_compiled.warm_evaluator_kernels(wl, 24, device="cuda")
        pinned = {}
        for name, w, st in (("GPT-175B", wl, strategies), ("GPT-175B x 8 experts", wl_moe,
                                                            moe_strat)):
            nw_w = _wafers_for_budget_batch(geom, w)
            t0 = time.perf_counter()
            got = eval_compiled.evaluate_pinned_compiled(geom, w, nw_w, st, 24, device="cuda")
            t_cuda = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = be_ref.evaluate_batch_ref(geom, w, nw_w, 24, strategies=st)
            t_ref = time.perf_counter() - t0
            n, n_hex, rel = _hex_diff(got, want)
            reasons = sorted({x.reason or "ok" for x in want})
            print(f"  (b) {name}: 512 joint points ({sum(x.feasible for x in want)} feasible; "
                  f"{', '.join(reasons)}), rows equal; {n_hex} of {n} float64 fields not "
                  f"hex-equal (want 0), max rel diff {rel:.3g}; cuda {1e3 * t_cuda:.1f} ms "
                  f"host, NumPy {1e3 * t_ref:.1f} ms")
            check(n_hex == 0, "pinned evaluation hex-equal to the NumPy pinned path")
            pinned[name] = (n_hex, n, 1e3 * t_cuda, 1e3 * t_ref)
        out["pinned"] = pinned
        # the fused dispatch on device indices equals the batch path
        picks = [5, 300, 17, 5]
        js = torch.tensor(picks, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = eval_compiled.dispatch_fused_eval_pinned(geom, wl, nw, strategies, js, 24)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cols = eval_compiled.strategy_arrays(strategies)
        res_ok = pinned_resource_ok(wl, geom, nw, *cols[:4])[picks]
        fused = pend.finish(nw[picks], [strategies[j] for j in picks], 4, res_ok=res_ok)
        direct = eval_compiled.evaluate_pinned_compiled(
            DesignBatch.from_designs([pts[j].design for j in picks]), wl, nw[picks],
            [strategies[j] for j in picks], 24, device="cuda")
        check(len(direct) == len(picks) and _hex_diff(fused, direct)[1] == 0,
              "fused pinned dispatch equals the batch path")
        clear_eval_cache()
        js2, via = evaluate_pool_fused_joint(pts, wl, js, 3, max_strategies=24)
        check(js2 == picks[:3] and _hex_diff(via, direct[:3])[1] == 0,
              "evaluate_pool_fused_joint equals the batch path")
        print("  (b) fused pinned dispatch on device indices [5, 300, 17, 5] equals the batch "
              "path, no host sync before finish")
        out["pinned_batch_512"] = dse_breakdown(
            torch, "pinned evaluation, 512 joint points of GPT-175B",
            lambda: eval_compiled.evaluate_pinned_compiled(geom, wl, nw, strategies, 24,
                                                           device="cuda"))

        # (c) the quick grid as a fleet of 2 workers on the card
        fs = FleetSpec.from_json(str(grid))
        serial = {}
        t0 = time.perf_counter()
        for c in fs.campaigns:
            clear_eval_cache()
            serial[c.name] = _front(Campaign(c, device="cuda").run().to_dict())
        t_serial = time.perf_counter() - t0
        fleets = {}
        for run in ("plain", "killed"):
            f = dataclasses.replace(fs, cache_dir=f"{tmp}/{run}/ec",
                                    checkpoint_dir=f"{tmp}/{run}/ck", compile_cache_dir=None)
            crash = fs.campaigns[0].name
            if run == "killed":
                os.environ[fleet_mod._CRASH_ENV] = f"{crash}:{tmp}/crashed.marker"
            try:
                fr = run_fleet(f, device="cuda")
            finally:
                os.environ.pop(fleet_mod._CRASH_ENV, None)
            done = [c for c in fr.campaigns if c]
            equal = sum(_front(c) == serial[c["spec"]["name"]] for c in done)
            hits = sum(sc["hits"] for c in done for sc in c["stage_cache"].values())
            looks = sum(sc["hits"] + sc["misses"] for c in done for sc in c["stage_cache"].values())
            resumed = [c["spec"]["name"] for c in done if c["resumed"]]
            print(f"  (c) fleet {fs.name!r} ({run}): {len(done)}/{len(fr.campaigns)} campaigns on "
                  f"{fs.workers} workers sharing cuda:0, {fr.n_evals} evaluations (want 52), "
                  f"{fr.crashes} crashes, errors {fr.errors}; fronts equal to serial card runs: "
                  f"{equal}/{len(done)}; wall {fr.wall_s:.2f} s ({fr.fleet_candidates_per_sec:.2f} "
                  f"candidates/s); shared cache {hits}/{looks} hits; resumed {resumed}")
            check(len(done) == 6 and fr.n_evals == 52 and not fr.errors, "fleet: 6/6, 52 evals")
            check(equal == 6, "fleet fronts equal to the serial runs")
            if run == "plain":
                check(fr.crashes == 0, "no crash")
            else:
                check(fr.crashes == 1 and resumed == [crash], "one crash, requeued and resumed")
            fleets[run] = {"wall_s": fr.wall_s, "n_evals": fr.n_evals, "crashes": fr.crashes,
                           "cache_hits": hits, "cache_lookups": looks}
        print(f"  (c) the same six campaigns one after another in this process on the card: "
              f"{t_serial:.2f} s")
        fleets["serial_s"] = t_serial
        out["fleet"] = fleets

    # (d) the §IX baselines
    gpu = [baselines.gpu_cluster_eval(w) for w in GPT_BENCHMARKS]
    card, cpu_b = AnalyticalBackend(device="cuda"), AnalyticalBackend(device="cpu")
    base = {}
    for name in ("WSE2_LIKE", "DOJO_LIKE"):
        v = validate(getattr(baselines, name))
        check(v.ok, f"{name} validates")
        clear_eval_cache()
        on_card = [evaluate_design_batch([v.design], w, fidelity=card)[0] for w in GPT_BENCHMARKS]
        clear_eval_cache()
        on_cpu = [evaluate_design_batch([v.design], w, fidelity=cpu_b)[0] for w in GPT_BENCHMARKS]
        n, n_hex, _ = _hex_diff(on_card, on_cpu)
        clear_eval_cache()          # the scalar path shares the batch path's cache keys
        t0 = time.perf_counter()
        scalar = [baselines.wsc_baseline_eval(v.design, w) for w in GPT_BENCHMARKS[:8]]
        t_scalar = time.perf_counter() - t0
        n_s, n_hex_s, rel_s = _hex_diff(on_card[:8], scalar)
        ratio = [x.throughput / g[0] for x, g in zip(on_card, gpu)]
        print(f"  (d) {name}: the card's batch evaluator on the 16 GPT benchmarks against the "
              f"CPU program: {n_hex} of {n} float64 fields not hex-equal (want 0); against "
              f"wsc_baseline_eval (the scalar NumPy path, 8 benchmarks, {t_scalar:.1f} s): same "
              f"strategies, {n_hex_s} of {n_s} not hex-equal, max rel diff {rel_s:.3g}; "
              f"throughput over the H100-like cluster's (gpu_cluster_eval): "
              + ", ".join(f"{w.name} {x:.3f}" for w, x in zip(GPT_BENCHMARKS[:8], ratio)))
        check(n_hex == 0, f"{name}: card against CPU hex-equal")
        check(rel_s <= 1e-12, f"{name}: the batch path equals the scalar one")
        base[name] = {"hex": n_hex, "fields": n, "scalar_hex": n_hex_s, "ratio": ratio}
    print("  (d) gpu_cluster_eval (host NumPy, no device work): "
          + ", ".join(f"{w.name} {t:.4g} tok/s {p:.4g} W" for w, (t, p) in
                      zip(GPT_BENCHMARKS[:4], gpu)) + ", ...")
    out["baselines"] = base
    print(f"  kernel launches during phase 22: K1 {flash_attention.launches}, K2 "
          f"{ssd_scan.launches} (no hand-written kernel lies on the DSE path)")
    check(flash_attention.launches == 0 and ssd_scan.launches == 0, "phase 22 launches no kernel")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 22: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import numpy as np
    import torch
    from torch.nn.attention import SDPBackend

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    faulthandler.enable()           # a crash prints every thread's stack to stderr
    from repro_torch.configs import get_config
    from repro_torch.core import traces
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention, forward_kernel
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
    report = {k: v for log in logs.values() for k, v in ptxas_table(log, fwd_name).items()}
    for k, (regs, st, ld, smem) in sorted(report.items()):
        print(f"  {k}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, "
              f"{smem} bytes static shared memory")
    if report:                      # nvcc ran (no library was built before)
        serial = [line for log in logs.values() for line in log.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
        print(f"  ptxas: {len(serial)} wgmma serialization warnings")
        check(not serial, "ptxas keeps the wgmma products asynchronous (no serialization)")
        for k in K1_WGMMA_INST + K1_FP32_HOPPER_INST + (f"{K1_FP32}<64>",) + MMA_KERNELS[1:]:
            check(k in report and report[k][1:3] == [0, 0], f"{k} has no spills")
    bwd = {k: v for log in logs.values() for k, v in ptxas_table(log, bwd_name).items()}
    # the training path's instantiations (fp32 at hd 64: the forward, and
    # the backward kernels `backward_kernels(64, fp32)` names, at every hd
    # and number of consumer warpgroups of their rule), and the bf16
    # backward's on Hopper at hd 64, 128 and 256 (the mesh trains in bf16)
    k1_train = [f"{K1_FP32}<64>"]
    k1_bwd_tf32 = k1_bwd_tf32_inst()
    k1_bwd_bf16 = k1_bwd_wgmma_inst()
    k2_hopper = k2_bwd_hopper_names(torch)      # the dx kernel and the dB/dC stage, at N 64, 128
    if bwd:
        print(f"  K1 backward: {len(bwd)} instantiations")
        for k, (regs, st, ld, smem) in sorted(bwd.items()):
            print(f"  {k}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, "
                  f"{smem} bytes static shared memory (the tiles' is dynamic, set at launch)")
        for k in k1_bwd_tf32 + k1_bwd_bf16:
            check(k in bwd and bwd[k][1:3] == [0, 0], f"{k} has no spills")
    hmma = sass_hmma_counts()
    if hmma is None:
        print("  cuobjdump not in the toolkit: SASS HMMA counts not read")
    else:
        print(f"  SASS of the split-TF32 forward ({len(hmma)} instantiations read): "
              + ", ".join(f"{k} {n} HMMA ({n32} TF32)" for k, (n, n32, *_) in hmma.items()
                          if k in k1_train))
        for k in k1_train:
            check(hmma.get(k, [0] * 5)[1] > 0, f"{k} runs TF32 mma on the tensor cores")
        # the mma.sync bf16 backward, at the other head dims
        k1_bwd_mma = [k for k in hmma if k.startswith(k1_bwd_names(80))]
        print("  SASS of K1's bf16 backward on mma.sync: "
              + ", ".join(f"{k} {n} HMMA ({nb} HMMA.16816.F32.BF16, {n32} TF32)"
                          for k, (n, n32, nb, *_) in hmma.items() if k in k1_bwd_mma))
        check(len(k1_bwd_mma) > 0, "the mma.sync bf16 backward is built")
        for k in k1_bwd_mma:
            n, n32, nb, *_ = hmma[k]
            check(nb > 0 and n32 == 0, f"{k} runs bf16 m16n8k16 mma and no TF32 mma")
        print("  SASS of K2's split-TF32 kernels: "
              + ", ".join(f"{k} {n} HMMA ({n32} TF32)" for k, (n, n32, *_) in sorted(hmma.items())
                          if k in K2_TRAIN))
        for k in K2_TRAIN:
            check(hmma.get(k, [0] * 5)[1] > 0, f"{k} runs TF32 mma on the tensor cores")
        print("  SASS of K2's fp32 backward on Hopper: "
              + ", ".join(f"{k} {hg} HGMMA, {tma} UTMALDG, {n} HMMA"
                          for k, (n, _, _, hg, tma) in sorted(hmma.items()) if k in k2_hopper))
        for k in (k for k in k2_hopper if "_sum_" not in k):
            n, _, _, hg, tma = hmma.get(k, [0] * 5)
            check(hg > 0 and tma > 0 and n == 0,
                  f"{k} runs wgmma (HGMMA) on tiles TMA loads (UTMALDG), no mma.sync (HMMA)")
        k1_hopper = K1_WGMMA_INST + k1_bwd_bf16 + tuple(
            k for k in K1_FP32_HOPPER_INST + k1_bwd_tf32 if "_prep_" not in k)
        print("  SASS of K1's bf16 and fp32 forward and backward on Hopper: "
              + ", ".join(f"{k} {hg} HGMMA, {tma} UTMALDG, {n} HMMA"
                          for k, (n, _, _, hg, tma) in sorted(hmma.items()) if k in k1_hopper))
        for k in k1_hopper:
            n, _, _, hg, tma = hmma.get(k, [0] * 5)
            check(hg > 0 and tma > 0 and n == 0,
                  f"{k} runs wgmma (HGMMA) on tiles TMA loads (UTMALDG), no mma.sync (HMMA)")
    k2 = {k: v for log in logs.values() for k, v in ptxas_table(log, k2_name).items()}
    if k2:
        print("  K2's split-TF32 kernels and state passes (the fp32 forward's, the "
              "backward's): " + ", ".join(f"{k} {r} registers ({st}/{ld} bytes spilled)"
                                         for k, (r, st, ld, _) in sorted(k2.items())))
        for k in K2_TRAIN + k2_hopper + ("state_pass_kernel<false>", "state_pass_kernel<true>"):
            check(k in k2 and k2[k][1:3] == [0, 0], f"{k} has no spills")

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
        # the model's entry point on the strided views, bf16 and fp32: the
        # three kernels of the dtype and no copy
        for dname, dtype, names in (("bf16", torch.bfloat16, MMA_KERNELS[1:]),
                                    ("fp32", torch.float32, K2_FWD_PROFILE)):
            args = strided_views(torch, case, ssd_inputs(torch, case, dtype))
            def besides(c):
                return [k for k in c if not any(m in k for m in names)]
            _, _, counts = device_breakdown(
                torch, lambda: ssd_ops.ssd(*args, chunk=128), reps=1,
                until=lambda c: not besides(c) and sorted(c.values()) == [1, 1, 1])
            others = besides(counts)
            print(f"    ops.ssd ({dname}) on the strided views: {sum(counts.values())} device "
                  f"kernels, {len(others)} besides the three K2 kernels")
            check(not others and sorted(counts.values()) == [1, 1, 1],
                  f"ops.ssd ({dname}) launches the three K2 kernels once each and copies nothing")

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
                _, lse = flash_attention(q, k, v, causal=False, return_lse=True)
                _, lse_ref = attention_ref(q, k, v, pos, pos, causal=False, return_lse=True)
                dlse = (lse - lse_ref).abs().max().item()
                print(f"  {case} bf16 lse ({forward_kernel(case[4], torch.bfloat16)}): |dlse| "
                      f"{dlse:.3g}")
                check(dlse <= 1e-5 * max(1.0, lse_ref.abs().max().item()), f"lse {case} bf16")
    # the bf16 tensor-core kernels at every head-dim class: flash_wgmma_kernel
    # at 64, 128, 256 (BK = 128 keys up to hd = 128, 64 above; 64 to 192 query
    # rows), flash_mma_kernel at the others (BK = 64 keys up to hd = 128, 32
    # above; q in registers up to 128), S = 200 ragged against the tiles,
    # under the long shapes' bf16 rule
    mma_hds = (16, 48, 64, 80, 128, 144, 256)
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
        out, lse = flash_attention(q, k, v, causal=case[5], window=case[6], return_lse=True)
        torch.cuda.synchronize()
        ref, lse_ref = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6],
                                     return_lse=True)
        ref = ref.float()
        err = (out.float() - ref).abs()
        mref = ref.abs().max().item()
        ok = bool((err <= 1e-2 * ref.abs() + 1e-4 * mref).all())
        dlse = (lse - lse_ref).abs().max().item()
        line = (f"  {case} bf16 ({forward_kernel(case[4], torch.bfloat16)}): max|d| "
                f"{err.max().item():.3g} (max|ref| {mref:.3g}) [|d|<=1e-2|ref|+{1e-4 * mref:.3g}] "
                f"{'ok' if ok else 'FAIL'}; |dlse| {dlse:.3g}")
        if case == mixtral:
            again = flash_attention(q, k, v, causal=case[5], window=case[6])
            line += f"; a second run bit for bit {torch.equal(again, out)}"
            check(torch.equal(again, out), f"flash_attention {case} bf16: two runs bit for bit")
            del again
        print(line)
        check(ok and torch.isfinite(out).all().item(), f"flash_attention {case} bf16")
        check(dlse <= 1e-5 * max(1.0, lse_ref.abs().max().item()), f"lse {case} bf16")
        err_by_case[case] = err.max().item()
        del q, k, v, out, ref, err, lse, lse_ref
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
        line = (f"  {case}: {forward_kernel(case[4], torch.bfloat16)} {t_ms:.4f} ms "
                f"(eager back-to-back {te_ms:.4f} ms), "
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
        k1_name = k1_fwd_name(cfg_w)
        k1, k1_n = kernel_share(by_name, counts, (k1_name,))[k1_name]
        print(f"  {name} (B={n_req}): host {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
              f"({dev_ms / wall_ms:.1%}; idle {1 - dev_ms / wall_ms:.1%}), "
              f"{len(by_name)} kernel names")
        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:8.3f} ms  {k[:90]}")
        print(f"    K1 {k1_name} {k1:.3f} ms x{k1_n}, {k1 / dev_ms:.1%} of device time")
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
    k1 = k1_fwd_name(cfg_p)
    print_breakdown(torch, f"prefill, B={n_req} x {P + n_prompt}", lambda: prefill_p(
        model_p, batch_s), k1)
    print_breakdown(torch, f"8 decode steps, B={n_req}", lambda: [
        decode_p(model_p, last_p, P + n_prompt + n_steps - 8 + i, cache_p) for i in range(8)], k1)
    print_breakdown(torch, "forward, 256 + 3840", lambda: model_p(
        batch["tokens"], patches=batch["patches"]), k1)
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

    phase("19. training on the card: K1's backward against its plain version and timed; "
          "smollm-135m at full width through python -m repro_torch.launch.train with an "
          "injected failure; card against CPU; where one step's time goes")
    t19 = time.perf_counter()
    k1_train_record = train_path(torch, np)
    print(f"  phase 19: {time.perf_counter() - t19:.1f} s")

    phase("20. SSM and hybrid training on the card: K2's backward against its plain version "
          "and timed; mamba2-370m at full width through python -m repro_torch.launch.train with "
          "an injected failure; zamba2-1.2b at full width; card against CPU; where one step's "
          "time goes")
    t20 = time.perf_counter()
    k2_train_record = ssm_train_path(torch, np)
    print(f"  phase 20: {time.perf_counter() - t20:.1f} s")

    phase("21. every family trains on the card: K1's fp32 forward and backward at the five "
          "training cases of whisper-small, gemma3-4b and mixtral-8x7b; the three at full width "
          "through make_train_step; card against CPU; int8 compression and GPipe")
    t21 = time.perf_counter()
    k1_families_record = families_train_path(torch, np)
    print(f"  phase 21: {time.perf_counter() - t21:.1f} s")

    phase("22. the rest of the DSE on the card: gpt175b_joint_dse through python -m "
          "repro_torch.explore, the pinned evaluator, fleet_quick_grid on 2 workers, the §IX "
          "baselines")
    print(json.dumps({"dse_rest": dse_rest_path(torch, np)}, default=float))

    phase("23. the mesh path: smollm-135m (4 layers), mamba2-370m (6 layers) and "
          "mixtral-8x7b (1 layer) at full width trained on a 2x2 (data, model) mesh of four "
          "threaded ranks sharing the card, K1 and K2 on each rank's shard")
    t23 = time.perf_counter()
    mesh_record = mesh_path(torch, np)
    print(f"  phase 23: {time.perf_counter() - t23:.1f} s")

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
            "cuda_kernels": [forward_kernel(case[4], torch.bfloat16)],
            "launches": n,
            "max_abs_err": err_by_case[case],
            **timed[case],
        })
    # K1 forward and backward on the training path (phase 19)
    record["kernels"] += k1_train_record
    # K2 forward and backward on the two training paths (phase 20)
    record["kernels"] += k2_train_record
    # K1 forward and backward at the five training cases of phase 21
    record["kernels"] += k1_families_record
    # K1 and K2 forward and backward at the mesh path's local shapes (phase 23)
    record["kernels"] += mesh_record
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
