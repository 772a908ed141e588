// Flash attention for Hopper (sm_90a), forward and backward, CUDA C++ with
// plain C entry points.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py:87. Same function: for aligned
// self-attention (query row i and key j sit at positions i and j),
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, h / rep]
// over the keys j that the mask keeps: j < Skv, j <= i when causal, and
// j > i - window when a window is given. GQA maps query head h to KV head
// h / rep (rep = Hq / Hkv) without repeating K or V. As on the TPU: scores
// and the softmax state (m, l, acc) are fp32, masked scores are -1e30 and
// their p is 0, l is clamped at 1e-30 (an empty row gives 0, not NaN), and
// the output is cast to q's dtype. The TPU kernel has no backward; the
// backward here is the gradient of the same function (see below).
//
// The kernels of a call are chosen by dtype, head dim and, for fp32, the
// number of keys, by a fixed rule (not a fallback; a failed tensor-map
// encode or launch is returned; the wrapper's kernel.forward_kernels and
// kernel.backward_kernels name them; fp32_on_hopper below):
//   * bfloat16 forward at hd 64, 128 and 256 (every full-width config's head
//     dim) -> flash_wgmma_kernel, Hopper's wgmma fed by TMA;
//   * bfloat16 forward at the other head dims -> flash_mma_kernel, bf16
//     mma.sync m16n8k16;
//   * bfloat16 backward at hd 64, 128 and 256 -> flash_wgmma_bwd_dq_kernel
//     (dQ and delta), then flash_wgmma_bwd_dkdv_kernel (dK, dV), wgmma fed
//     by TMA with split-bf16 P and dS;
//   * bfloat16 backward at the other head dims -> flash_bf16_bwd_dq_kernel,
//     then flash_bf16_bwd_dkdv_kernel, bf16 mma.sync m16n8k16 with
//     split-bf16 P and dS;
//   * float32 forward at hd 64, 128 and 256 over more than 512 keys ->
//     flash_wgmma_tf32_fwd_prep_kernel (k's and v's split copies), then
//     flash_wgmma_tf32_kernel, split-TF32 wgmma fed by TMA;
//   * float32 forward elsewhere (other head dims; 512 keys or fewer, where
//     the pre-pass costs more than it saves) -> flash_tf32_kernel,
//     split-TF32 mma.sync m16n8k8;
//   * float32 backward at hd 64, 128 and 256 over more than 256 keys ->
//     flash_wgmma_tf32_bwd_prep_kernel (split copies, delta),
//     flash_wgmma_tf32_bwd_dq_kernel (dQ), then
//     flash_wgmma_tf32_bwd_dkdv_kernel (dK, dV), split-TF32 wgmma fed by TMA;
//   * float32 backward elsewhere -> flash_tf32_bwd_dq_kernel, then
//     flash_tf32_bwd_dkdv_kernel, split-TF32 mma.sync m16n8k8.
//
// What bounds them on this card: at the whisper encoder's shape (B=4,
// S=1500, 12 heads of 64, bf16) the forward does 2.8e10 FLOP on 37 MB, so
// operations set its least time (0.028 ms at the tensor cores' 989 TFLOP/s).
// At the training shape (B=8, S=256, 9/3 heads of 64, causal, fp32) the
// forward does 0.61 GFLOP on 12.6 MB and the backward 1.52 GFLOP (five
// products) on 25.2 MB. IEEE fp32 on the CUDA cores (67 TFLOP/s) would bound
// them by operations at 9.0 and 22.6 us; the split-TF32 route does three
// TF32 products for each fp32 one at 495 TFLOP/s, 3.7 and 9.2 us, so the
// forward's least time is set by its bytes (3.8 us) and the backward's by
// its operations.
//
// Split TF32. A TF32 product keeps 11 significant bits of each operand; one
// such product misses the fp32 rules (|d| <= 1e-4 max|ref| at long rows) by
// ~5x. Each fp32 operand is split in registers into hi = tf32(x) and lo =
// tf32(x - hi), rounded to nearest as cvt.rna.tf32.f32 rounds, and a
// product takes lo_a hi_b + hi_a lo_b + hi_a hi_b (the lo_a lo_b term,
// ~2^-22 of the product, is dropped): ~22 bits per operand, as close to the
// function as IEEE fp32 itself, for three tensor-core products. In the
// backward's sums over the query rows (dK, dV) each k-step's products go
// into a zeroed accumulator that is added to the running sum in IEEE fp32
// (`mma3_sum`): the tensor cores' own accumulation rounds toward zero, a
// bias that grows along the rep x 4096-long sums. The products over the
// head dim (S, dP), dQ and the forward's O += P V accumulate on the tensor
// cores: at the training cases (1500-4096 keys) flash_tf32_kernel's o keeps
// within 1e-5 of max|o| of float64 and dQ within 6e-6 of max|dQ|, and IEEE
// adds in that forward cost 8-32 % of its time (flash_wgmma_tf32_kernel
// adds per tile, below). The forward's P V splits V in
// three terms (hi + mid + lo is exactly v): four products, so a row whose
// only live key has p = 1 returns that key's v bit for bit, as IEEE fp32
// does.
//
// The m16n8k8 accumulator is not its A operand's layout: a lane holds
// columns 2t and 2t+1 of an 8-wide n-tile (t = lane % 4), where the A
// fragment wants k-columns t and t+4. P (dS, P^T, dS^T) goes from the
// accumulator straight to the A fragment by permuting the keys (queries)
// inside each group of 8: physical key 2t plays k-index t and key 2t+1
// plays t+4, and the B fragment (V, K, dO or Q) reads its rows 2t and 2t+1
// in that same order. A sum over keys does not depend on their order, so
// no value is shuffled.
//
// flash_wgmma_kernel (bf16, hd 64, 128, 256). It computes what
// flash_mma_kernel does (below), with Hopper's own machinery. At mixtral's
// layer (1, 4096, 32/8 heads of 128, causal) the function is 137 GFLOP on
// 84 MB: operations bound it (0.139 ms at 989 TFLOP/s), and the split P
// below makes the tensor cores' own floor 1.5x that. Design:
//   * Grid (ceil(Sq/BQ), B*Hq), the longest causal walks first; a block has
//     NWG consumer warpgroups of 64 query rows (BQ = 64 NWG) and a producer.
//     NWG is a rule on the grid: the most whose blocks still fill the 132
//     SMs (3 only at hd 64, where 160 registers a thread suffice; 2; else
//     1). Beside 2 or 3 consumers the producer is a whole warpgroup that
//     gives its registers to them (setmaxnreg: 24 / 240, 24 / 160); beside 1
//     it is one warp.
//   * The producer's one thread loads Q once and the live K and V tiles
//     (BK = 128 keys up to hd = 128, 64 at hd 256) into a 2-stage ring by
//     TMA (cp.async.bulk.tensor), on full/empty mbarriers, K and V with
//     their own, so K runs a tile ahead. Tensor maps over the (hd, H, S, B)
//     views of q, k, v, encoded on the host per call from the caller's
//     pointers and strides, 64-column boxes with the 128-byte swizzle; TMA
//     fills rows past S with zeros.
//   * Consumers: S = Q K^T by wgmma m64nBKk16 from shared memory (both
//     operands K-major as stored). The online softmax in the accumulator's
//     registers: row maxima over raw scores, p = 2^(s * scale * log2 e - m)
//     by one FFMA and ex2.approx.ftz; masks only in tiles that cross an
//     edge, where masked keys get p = 0 and no part in the maximum. O is
//     rescaled on every tile (by exactly 1 where a row's maximum did not
//     move). A negative scale is taken by negating Q in shared memory once.
//   * O += (P_hi + P_lo) V by two register-A wgmma per 16 keys (P split as in
//     flash_mma_kernel: the accumulator's registers are the A fragment), V
//     the B operand read MN-major (wgmma's transpose bit).
//   * Each warpgroup runs S, softmax, P V in turn; the two or three
//     warpgroups of a block interleave on the tensor cores. Issuing tile
//     t + 1's S before tile t's P V (FlashAttention-3's in-warpgroup overlap)
//     and strict ping-pong between warpgroups by named barriers were both
//     slower on the H100 (PERF.md).
//   * Epilogue as flash_mma_kernel's.
//
// flash_mma_kernel (bf16). Grid (ceil(Sq/64), B*Hq), tiles with the most
// causal work first; 4 warps, each owning 16 of the block's 64 query rows.
//   * Q is staged once by cp.async; for hd <= 128 it goes to registers as
//     A fragments (ldmatrix.x4) for the whole K loop, above that it is
//     re-read from shared memory per K tile so the fp32 O accumulator
//     (16 x hd per warp) fits in registers.
//   * K and V tiles (64 keys for hd <= 128, 32 above) are double-buffered
//     by cp.async.cg 16-byte copies: tile j+1 is in flight while tile j is
//     computed. Rows are padded by 16 bytes, so the 8 row addresses of an
//     ldmatrix fall on distinct banks. Keys at or past Skv and q rows at or
//     past Sq are zero-filled (src-size 0), so no stale value meets p = 0.
//   * S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 accumulate); K is read
//     with ldmatrix, since it is [key][d] already. The scale (times log2 e)
//     is applied to the fp32 scores, not folded into bf16 q, which would
//     round q unless the scale were a power of two.
//   * Online softmax in registers: a row lives in a quad of 4 lanes of the
//     accumulator layout, so its max and sum reduce with __shfl_xor over 1
//     and 2. The exponential is ex2.approx.ftz.f32 (relative error ~2^-22,
//     the hardware unit exp2f also uses, without exp2f's handling of
//     subnormal results: those flush to 0, where p would be below 1e-38
//     anyway) on the scores pre-scaled by log2 e.
//   * O += P V with P split into two bf16 terms, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi): one bf16 P would round p to 8 bits and miss
//     the bf16 rule at long rows (PERF.md); the two products into the same
//     fp32 accumulator keep ~16 bits, for 1.5x the tensor-core work. The S
//     accumulator registers become the A fragments (the FlashAttention-2
//     register layout); V is read with ldmatrix.trans.
//   * Epilogue: l reduced over the quad and clamped at 1e-30, O cast to
//     bf16 once; rows of a ragged q tail are never written.
//
// The split-TF32 kernels are bound by instruction issue, not by the tensor
// cores: each product needs its operands split (about four instructions per
// value) beside the HMMAs themselves. Under a causal mask the warp that owns
// a sequence's last rows (or, for dK/dV, first keys) walks the most tiles,
// and that walk sets the kernel's time at the training shape. So: blocks
// are ordered longest walk first across the whole grid (row or key tiles on
// grid y), and the longest walks are split over more warps, with
// fixed-order sums at the end.
//
// flash_tf32_kernel (fp32). Grid (B*Hq, ceil(Sq/64)); 8 warps in two groups
// of 4 over the block's 64 query rows (16 per warp): group 0 walks the even
// K/V tiles of the rows' key range, group 1 the odd ones, each with its own
// double buffer and named barrier (bar.sync 1 or 2, 128 threads). Tiles of
// 32 keys (16 above hd = 128), fp32 in shared memory with rows padded by 16
// bytes (HD + 4 floats), so a warp's 32-bit fragment loads fall on 32 banks.
// Q stays in shared memory and is re-read and split per tile. S = Q K^T in
// three products, scaled by scale * log2 e in fp32, the softmax of
// flash_mma_kernel, O += P V in four (above). At the end group 1 hands its
// (m, l, O) to group 0 through shared memory, which rescales both to the
// larger m and writes O and the LSE.
//
// The backward: with P = exp(scale Q K^T - lse) (lse from the forward,
// masked entries 0), dP = dO V^T, delta = rowsum(dO * O) and
// dS = P * (dP - delta): dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
// Deterministic, with no atomics: every gradient element is summed by one
// lane in a fixed order, then the warps' sums are added in a fixed order,
// so two runs give the same bits. Both pairs do seven products where five
// are needed (the dQ kernel recomputes S and dP): the fused alternative
// writes dQ partials per key tile to memory for a second pass.
//
// bf16 backward (FlashAttention-2's dataflow on mma.sync m16n8k16). bf16
// operands go from shared memory straight into the fragments: ldmatrix for
// an operand read as stored, ldmatrix.trans for K in dQ = dS K and for Q
// and dO in dK = dS^T Q and dV = P^T dO; nothing is widened. S and dP take
// one product each, fp32 accumulation. P and dS stay fp32 in registers and
// reach their next product as the A fragment of the accumulator's own
// register layout (flash_mma_kernel's), split into hi = bf16(x) and lo =
// bf16(x - hi): two products into one fp32 accumulator, ~16 bits of P and
// dS, where one bf16 term (8 bits) misses the long bf16 rule at hundreds of
// entries per gradient (tests/test_torch_flash_bf16_bwd.py). That is ten
// bf16 product units per kept (query, key) pair against the function's
// five. The sums stay in the tensor cores' fp32 accumulators (no IEEE adds
// as mma3_sum): the long bf16 rule holds at every element of mixtral's
// mesh shard, whose dK and dV sum 4 x 4096 query rows (PERF.md §6). Not
// the tensor cores bound these kernels but the shared-memory traffic of
// ldmatrix (each warp reads an item's Q and dO for its own 16 keys) and
// instruction issue: without the lo products they run 5-11 % faster.
//   * flash_bf16_bwd_dq_kernel: grid (B*Hq, ceil(Sq/64)), 4 warps of 16
//     query rows, three blocks per SM up to hd = 64, two above. Q and dO
//     are staged once and delta computed for the block's rows; the live
//     K/V tiles (64 keys up to hd = 128, 16 above) are double-buffered by
//     cp.async, S and dP recomputed, dQ += dS K.
//   * flash_bf16_bwd_dkdv_kernel: grid (B*Hkv*NZ, ceil(Skv/BKV)), 8 warps
//     in NG groups, one block per SM. A block owns BKV keys of one KV head
//     (16 per warp of each group) and DN of its dK/dV columns (all up to
//     hd = 128; above it two column blocks, NZ = 2, so the two fp32
//     accumulators fit in registers). It walks the items (query head, query
//     tile of 64 rows, 32 above hd = 64) over its rep query heads, so GQA's
//     sum stays in the block: group g takes items g, g + NG, ..., each with
//     its Q, dO, lse and delta double-buffered by cp.async, and the other
//     groups hand their sums to group 0 in group order. S^T = K Q^T and
//     dP^T = V dO^T come out in accumulator layout, so P^T and dS^T feed
//     dV += P^T dO and dK += dS^T Q directly (K and V as A fragments in
//     registers up to hd = 64). Key blocks are ordered longest causal walk
//     first on grid y, each with a whole SM. Two groups of 4 warps (64
//     keys) where the blocks fill the card; else four groups of 2 warps
//     (32 keys), which halves the longest block's walk (smollm-135m's
//     mesh shard: 48 blocks of 64 keys on 132 SMs).
//   Both skip the tiles that the causal and window masks leave dead and
//   mask element by element only in a tile that crosses a mask's edge.
//
// flash_wgmma_bwd_dq_kernel and flash_wgmma_bwd_dkdv_kernel (bf16, hd 64,
// 128, 256): the same function as the mma.sync pair, with Hopper's own
// machinery and flash_wgmma_kernel's layout (64-column boxes with the
// 128-byte swizzle, tensor maps encoded per call, a producer beside 64-row
// consumer warpgroups, setmaxnreg). At mixtral's layer (1, 4096, 32/8 heads
// of 128, causal) the function is 344 GFLOP on 168 MB: operations bound it
// (0.348 ms at 989 TFLOP/s), and the split P and dS make the tensor cores'
// own floor twice that. The mma.sync pair ran at 10-15 % of the bound, held
// by shared-memory traffic (each 16-key warp re-read an item's Q and dO by
// ldmatrix) and issue; here every operand reaches the tensor cores from
// shared memory by descriptor or from the accumulator's registers.
//   * flash_wgmma_bwd_dq_kernel: grid (ceil(Sq/BQ), B*Hq), the longest
//     causal walks first; NWG consumer warpgroups of 64 query rows (BQ =
//     64 NWG: up to 3 at hd 64, 2 at 128, 1 at 256) by the grid rule of
//     flash_wgmma_kernel. The producer's thread loads Q and dO once and the
//     live K/V tiles (64 keys) through a 2-stage ring by TMA. Consumers
//     compute delta = rowsum(dO O) for their rows (O from device memory, dO
//     from its swizzled tile), write it out, then per tile: S = Q K^T and
//     dP = dO V^T by wgmma from shared memory (K-major as stored), P and
//     dS = P (dP - delta) in the accumulator's registers, masks only in a
//     tile that crosses an edge, and dQ += (dS_hi + dS_lo) K by register-A
//     wgmma with K read MN-major (the transpose bit), as the forward's P V.
//   * flash_wgmma_bwd_dkdv_kernel: grid (B*Hkv*NZ, ceil(Skv/BKV)), the
//     longest causal walk first; NWG consumer warpgroups of 64 keys each
//     (BKV = 64 NWG: up to 2 at hd 64 and 128, 1 at 256). The producer
//     warp loads K and V once, then streams every live item (query head of
//     the rep, tile of 64 query rows) through a 2-stage ring: its lanes
//     write the item's lse (log2 units; 1e30 past Sq, so P is 0 there with
//     no mask) and delta into the stage, one lane issues Q's and dO's TMA
//     loads. Every warpgroup reads the same Q and dO tile once: S^T = K
//     Q^T and dP^T = V dO^T by wgmma (both K-major as stored) leave P^T and
//     dS^T in registers with rows = keys, and dV += (P^T_hi + P^T_lo) dO,
//     dK += (dS^T_hi + dS^T_lo) Q run register-A with dO and Q MN-major.
//     The warpgroups own disjoint keys, so GQA's sum over the rep heads
//     stays in each warpgroup's accumulators and nothing is handed over.
//     At hd 256 the two fp32 accumulators of 64 x 256 would take 256
//     registers a thread: two column blocks (NZ = 2, DN = 128), each
//     recomputing S^T and dP^T.
//   The sums stay in wgmma's fp32 accumulators, as in the mma.sync pair;
//   the long bf16 rule holds at every element of the six timed cases
//   (PERF.md). Deterministic: no atomics, every sum in a fixed order.
//
// The fp32 forward at hd 64, 128 and 256 over more than 512 keys
// (flash_wgmma_tf32_*): flash_tf32_kernel's function on TF32 wgmma fed by
// TMA, in the shape of the fp32 backward's dQ kernel below. At
// mixtral-8x7b's training case (1, 4096, 32/8 heads of 128, causal) it is
// 137 GFLOP on 168 MB: three TF32 products per fp32 one bound it at 0.83
// ms (495 TFLOP/s).
//   * flash_wgmma_tf32_fwd_prep_kernel (grid (ceil(Skv/32), B*Hkv, 2))
//     writes, into scratch the wrapper allocates, k's natural copy in two
//     terms (2, B, Skv, Hkv, hd) and v's transposed copy in three (3, B,
//     Hkv, hd, S8: hi, mid, lo, hi + mid + lo = v exactly), keys permuted in
//     groups of 8 by perm8: TF32 wgmma takes B only K-major, so P V's B
//     (V, reduced over the keys) must be stored keys-contiguous. 20 bytes
//     per element of k and v: 84 MB at mixtral's case, ~0.04 ms.
//   * flash_wgmma_tf32_kernel<HD, NWG>: grid (ceil(Sq/(64 NWG)), B*Hq), the
//     longest causal walks first; NWG consumer warpgroups of 64 query rows
//     (2 by the grid rule where the blocks fill the card, else 1) and a
//     producer (setmaxnreg 24 / 240 beside two). Resident: raw q of the
//     block's rows (64 NWG x hd x 4 bytes: 32, 64, 128 KB at NWG 2), split
//     in registers per k-step. Per live tile of BK = 8192 / hd keys (128,
//     64, 32) five 32 KB pieces stream through a ring of as many slots as
//     fit (3 to 6): K's hi and lo over half the head dim, twice (S = Q K^T,
//     three wgmma m64nBKk8 per k-step), then V^T's lo, mid and hi terms
//     (O += P V with N = hd: hi_P lo_V, hi_P mid_V, then lo_P hi_V and hi_P
//     hi_V per 8 keys, P split from the accumulator by acc_to_a_at).
//   * The softmax scales each fp32 score by scale log2 e before the row
//     maximum (either sign of the scale; q is never scaled or negated),
//     masks only on a tile that crosses an edge (keys past Skv by the mask:
//     TMA's zero rows give score 0, not p = 0) and rescales O on every tile.
//   * Sums: up to hd 128 a tile's P V goes into a zeroed accumulator that
//     joins O by one FFMA (O alpha + tile): along whisper's 1500-key
//     non-causal rows the tensor cores' rounding toward zero put o 1.67e-5
//     of max|o| from float64 without it, 2.6e-6 with it, for 3-4 % of the
//     time at mixtral's case. At hd 256 the registers hold one 64 x 256
//     accumulator only, and gemma3's 4096 keys keep o within 2.2e-6.
//   A row whose only live key has p = 1 returns that key's v bit for bit;
//   deterministic, no atomics.
//
// The fp32 backward at hd 64, 128 and 256 over more than 256 keys
// (flash_wgmma_tf32_bwd_*): the function of the pair below on Hopper's TF32
// wgmma, fed by TMA. At mixtral-8x7b's training case (1, 4096, 32/8 heads
// of 128, causal) it is 344 GFLOP on 336 MB: three TF32 products per fp32
// one bound it at 2.08 ms (495 TFLOP/s). TF32 wgmma reads a shared-memory
// operand only K-major (no transpose), and a 64-row fp32 tile in two terms
// is 512 hd bytes, so the design is set by shared memory:
//   * flash_wgmma_tf32_bwd_prep_kernel (grid (ceil(S/32), B*Hq, 4)) writes
//     once per call, into scratch the wrapper allocates, each fp32 operand
//     that a product reads from shared memory in two TF32 terms (hi =
//     tf32(x), lo = tf32(x - hi)): natural (2, B, S, H, hd) copies of q, k,
//     v, dout and transposed (2, B, H, hd, S8) copies of q, k, dout, whose
//     rows (keys or queries) are permuted in groups of 8 (perm8) so that
//     the accumulator's registers are the next product's A fragment
//     (acc_to_a, as in the mma.sync kernels); and delta = rowsum(dO O).
//     Scratch: 16 bytes per element of q, k and dout, 8 of v (0.64 GB at
//     mixtral's case).
//   * Every product is register-A wgmma (m64nNk8, A in registers, B by
//     descriptor): A is either an accumulator (P, dS, P^T, dS^T) or a
//     resident raw tile (q and dout in the dQ kernel, k and v in the dK/dV
//     kernel, loaded by TMA as they are) split in registers per k-step, so
//     only the B operands take two terms in shared memory. Each fp32 product
//     is three wgmma (lo_a hi_b, hi_a lo_b, hi_a hi_b).
//   * The B operands stream through a ring of 32 KB slots ("pieces"), as
//     many as fit beside the resident tiles (3 to 6), from a producer (a
//     warp; beside two consumer warpgroups a warpgroup that gives its
//     registers to them, setmaxnreg 24 / 240). A consumer
//     waits for a piece's products at its end and then releases the slot;
//     the ring keeps the next pieces' loads in flight meanwhile.
//   * flash_wgmma_tf32_bwd_dq_kernel: grid (ceil(Sq/(64 NWG)), B*Hq), the
//     longest causal walks first; NWG consumer warpgroups of 64 query rows
//     (2 up to hd 128, 1 at 256, by the grid rule of the bf16 kernels).
//     Resident: raw q and dout of the block's rows (64 NWG x hd x 8 bytes).
//     Per live K/V tile (BK = 64 keys, 32 at hd 256): (K, V) pieces (hi
//     and lo of BK keys x 2048 / BK head-dim columns) for S = Q K^T and dP =
//     dO V^T; dS = P (dP - delta) in registers, masks only on a tile that
//     crosses an edge; then K^T pieces (hi and lo of 4096 / hd keys, or at
//     hd 256 hi or lo of 32) for dQ += dS K with N = hd.
//   * flash_wgmma_tf32_bwd_dkdv_kernel: grid (B*Hkv*NZ, ceil(Skv/(64 NWG))),
//     NWG consumer warpgroups of 64 keys (2 up to hd 128, 1 at 256), each
//     owning its keys. Resident: raw k and v of the block's keys. Per item
//     (query head of the rep, BQ = 64 query rows up to hd 64, else 32, so
//     that dK, dV, S^T, dP^T and a partial sum fit in 240 registers): (Q,
//     dO) pieces for S^T = K Q^T and dP^T = V dO^T, the item's lse (1e30
//     past Sq) and delta from a two-item ring the producer's lanes fill,
//     P^T and dS^T in registers, then a dO^T and a Q^T piece (hi and lo of
//     the item's queries x DN head-dim rows) for dV += P^T dO and dK += dS^T
//     Q. DN = hd up to 128; at hd 256 two column blocks (NZ = 2), each
//     recomputing S^T and dP^T. Shared memory per block, resident + ring:
//     hd 64 64 + 160 KB (NWG 2); hd 128 128 + 96 KB; hd 256 128 + 96 KB.
//   * Sums: the tensor cores round each product's addition to the fp32
//     accumulator toward zero, a bias that grows along dK's and dV's rep x
//     Sq-long sums (3.8e-5 of max|dK| at mixtral's case on mma.sync). Each
//     64 columns of dK and dV take an item's sum in a zeroed accumulator
//     that is added to them in IEEE fp32 (tests/test_torch_flash_tf32.py
//     emulates both ways). S, dP (over hd) and dQ (over the keys) stay in
//     the tensor cores' accumulators.
//   Deterministic: no atomics, every sum in a fixed order.
//
//   * flash_tf32_bwd_dq_kernel: grid (B*Hq, ceil(Sq/64)), the forward's two
//     groups over 64 query rows. It stages Q and dO once, computes delta
//     for its rows (fp32; 8 rows per warp, written out for the next
//     kernel), then each group walks its live K/V tiles (32 keys, 8 above
//     hd = 128) double-buffered: S and dP (recomputed), P by ex2 of the
//     scores pre-scaled by log2 e, dS, and dQ += dS K; group 1 hands its
//     dQ to group 0.
//   * flash_tf32_bwd_dkdv_kernel: grid (B*Hkv, ceil(Skv/16), HD/DN). A block
//     owns 16 keys of one KV head and DN of its dK/dV columns (DN = HD up to
//     hd = 64, HD/2 above, so the two fp32 accumulators fit in registers);
//     its 4 warps take the 4 quarters of each query tile (64 rows, 32 above
//     hd = 128). It walks (query head, query tile) over its rep query heads,
//     so GQA's sum stays in the block, with the Q and dO tiles
//     double-buffered across heads. It computes S^T = K Q^T and dP^T =
//     V dO^T directly, so P^T and dS^T come out in accumulator layout and
//     feed dV += P^T dO and dK += dS^T Q; warps 1-3 hand their sums to warp
//     0, which adds them in warp order. At the training shape that is
//     16 x 24 = 384 blocks on 132 SMs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: flash_mma_kernel on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as one bf16x2 register (x in the low half) and the
// rounding residues: hi + lo carries ~16 bits of each value
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x, relative error ~2^-22; a result below 2^-126 is 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct MmaCfg {
  static constexpr int BK = HD <= 128 ? 64 : 32;     // keys per tile
  static constexpr int PITCH = HD + 8;               // bf16 per shared row (+16 bytes)
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr int KD = HD / 16;                 // k-steps over d
  static constexpr int NS = BK / 8;                  // score n-tiles per warp
  static constexpr int NO = HD / 8;                  // output n-tiles per warp
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)(kBQ + 4 * BK) * PITCH;
};

// rows [r0, r0 + ROWS) of one head (HD contiguous bf16 per row) into a
// shared tile of pitch PITCH; rows at or past n are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int64_t rs,
                                           int r0, int n) {
  constexpr int CH = HD / 8;                          // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < n;
    const bf16* s = ok ? src + (int64_t)(r0 + r) * rs + 8 * c : src;
    cp_async16(dst + r * MmaCfg<HD>::PITCH + 8 * c, s, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int Hq,
                 int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss, int64_t vsb,
                 int64_t vss, int64_t osb, int64_t oss, float scale_log2, int causal,
                 int window) {
  using C = MmaCfg<HD>;
  constexpr int BK = C::BK, PITCH = C::PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][PITCH]
  bf16* ks = qs + kBQ * PITCH;                    // [2][BK][PITCH]
  bf16* vs = ks + 2 * BK * PITCH;                 // [2][BK][PITCH]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const bf16* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const bf16* vb = v + b * vsb + (int64_t)(h / rep) * HD;

  // keys that some row of this tile may attend to: [k_begin, k_end)
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  stage_rows<HD, kBQ>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, Sq);
  if (t_begin < t_end) {
    stage_rows<HD, BK>(ks, kb, kss, t_begin * BK, Skv);
    stage_rows<HD, BK>(vs, vb, vss, t_begin * BK, Skv);
  }
  cp_async_commit();

  // the warp's rows, and per-lane offsets of the ldmatrix addresses
  const int wr0 = q0 + 16 * warp;                 // first row of the warp
  const int row_lo = wr0 + lane / 4, row_hi = row_lo + 8;
  const int a_row = lane % 16, a_col = (lane / 16) * 8;                    // A, plain
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;   // B, plain
  const int t_row = (lane % 8) + ((lane / 8) % 2) * 8, t_col = (lane / 16) * 8;  // B, trans

  float acc[C::NO][4];
#pragma unroll
  for (int j = 0; j < C::NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[C::Q_IN_REGS ? C::KD : 1][4];

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage_rows<HD, BK>(ks + (buf ^ 1) * BK * PITCH, kb, kss, (t + 1) * BK, Skv);
      stage_rows<HD, BK>(vs + (buf ^ 1) * BK * PITCH, vb, vss, (t + 1) * BK, Skv);
    }
    cp_async_commit();              // possibly empty: keeps the group count uniform
    cp_async_wait<1>();             // Q and tile t have landed
    __syncthreads();
    const bf16* kt = ks + buf * BK * PITCH;
    const bf16* vt = vs + buf * BK * PITCH;
    if constexpr (C::Q_IN_REGS) {
      if (t == t_begin) {
#pragma unroll
        for (int kd = 0; kd < C::KD; ++kd)
          ldmatrix_x4(qf[kd], qs + (16 * warp + a_row) * PITCH + 16 * kd + a_col);
      }
    }

    // S = Q K^T (fp32)
    float s[C::NS][4];
#pragma unroll
    for (int j = 0; j < C::NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
      } else {
        ldmatrix_x4(a, qs + (16 * warp + a_row) * PITCH + 16 * kd + a_col);
      }
#pragma unroll
      for (int jj = 0; jj < C::NS / 2; ++jj) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (16 * jj + b_row) * PITCH + 16 * kd + b_col);
        mma_bf16(s[2 * jj], a, bk[0], bk[1]);
        mma_bf16(s[2 * jj + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax; element e of n-tile j sits at row
    // (e < 2 ? row_lo : row_hi), key k0 + 8 j + 2 (lane % 4) + (e & 1)
    const int k0 = t * BK;
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wr0) ||
                           (window >= 0 && k0 <= wr0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int kp = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const int qp = e < 2 ? row_lo : row_hi;
          const bool keep =
              kp < Skv && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
          x = keep ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_ftz(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is exactly kNegInf; its p is 0 even in a row whose
        // every score so far is masked (m = kNegInf)
        const float p = s[j][e] == kNegInf ? 0.f : exp2_ftz(s[j][e] - m[e / 2]);
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];   // this lane's part
#pragma unroll
    for (int j = 0; j < C::NO; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }

    // O += (P_hi + P_lo) V: score n-tiles 2 kk and 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (16 * kk + t_row) * PITCH + 16 * dd + t_col);
        mma_bf16(acc[2 * dd], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dd], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dd + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dd + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();                // tile t's buffer may be refilled next
  }
  cp_async_wait<0>();

  // epilogue: the quad's row sums, one cast, ragged rows unwritten
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = i == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    // m is in log2 units (scores pre-scaled by log2 e): back to natural log
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] = m[i] * kLn2 + logf(fmaxf(li, 1e-30f));
    bf16* orow = o + b * osb + (int64_t)row * oss + (int64_t)h * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < C::NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128 and 256: flash_wgmma_kernel, wgmma fed by TMA
// ---------------------------------------------------------------------------

// threads of a block of the wgmma kernels with nwg consumer warpgroups: the
// producer is a whole warpgroup beside two or three of them, so that
// registers can move to the consumers (setmaxnreg), else one warp
constexpr int wg_threads(int nwg) { return nwg * 128 + (nwg >= 2 ? 128 : 32); }

template <int HD>
struct WgCfg {
  static constexpr int BK = HD <= 128 ? 128 : 64;        // keys per tile
  static constexpr int STAGES = 2;                       // K/V ring depth
  static constexpr int CB = HD / 64;                     // 128-byte column blocks per row
  static constexpr uint32_t TILE_BYTES = BK * HD * 2;    // one K or V tile
  // Q, the K and V rings, the barriers, and slack to align the tiles to 1024
  static constexpr size_t smem(int nwg) {
    return 1024 + (size_t)64 * nwg * HD * 2 + 2 * STAGES * (size_t)TILE_BYTES +
           8 * (1 + 4 * STAGES);
  }
};

// the masks, the scale and the online softmax of one warp's 16 rows over a
// tile of BK keys in the accumulator layout (flash_mma_kernel's): register
// 4 j + e of sc sits at row (e < 2 ? row_lo : row_hi), key k0 + 8 j +
// 2 (lane % 4) + e % 2. The scale (times log2 e, here >= 0) is applied to
// the fp32 scores: to the row maximum, which rounding keeps the largest,
// and in p = 2^(s scale - m) as one fused multiply-add. Masked keys take no
// part in the maximum and get p = 0 (the -1e30 and p = 0 of the TPU
// kernel); only a tile that crosses a mask's edge tests them. Turns sc into
// P (fp32), updates m (kNegInf while a row has seen no key) and this lane's
// part of l, and gives the factor O is rescaled by (1 exactly where a row's
// maximum did not move).
struct RowMask {
  int wr0, row_lo, row_hi, lane, Skv, causal, window;
  float scale_log2;

  __device__ __forceinline__ bool keep(int k0, int j, int e) const {
    const int kp = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
    const int qp = e < 2 ? row_lo : row_hi;
    return kp < Skv && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
  }

  // this lane's raw row maxima over the kept keys
  template <int BK, bool MASKED>
  __device__ __forceinline__ void row_max(const float (&sc)[BK / 2], int k0,
                                          float (&mx)[2]) const {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!MASKED || keep(k0, j, e)) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
  }

  // sc becomes P, its row sums go to rs
  template <int BK, bool MASKED>
  __device__ __forceinline__ void exp_rows(float (&sc)[BK / 2], int k0, const float (&m)[2],
                                           float (&rs)[2]) const {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -m[e / 2]));
        if (MASKED && !keep(k0, j, e)) p = 0.f;
        sc[4 * j + e] = p;
        rs[e / 2] += p;
      }
  }

  template <int BK>
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int k0, float (&m)[2],
                                          float (&l)[2], float (&alpha)[2]) const {
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wr0) ||
                           (window >= 0 && k0 <= wr0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
    if (need_mask)
      row_max<BK, true>(sc, k0, mx);
    else
      row_max<BK, false>(sc, k0, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] == kNegInf ? kNegInf : mx[r] * scale_log2);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
    }
    if (need_mask)
      exp_rows<BK, true>(sc, k0, m, rs);
    else
      exp_rows<BK, false>(sc, k0, m, rs);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  }
};

// P (fp32, accumulator layout) as the A operands of keys 16 kk .. 16 kk + 15
// in two bf16 terms: registers 8 kk .. 8 kk + 7 are exactly the m16n8k16 A
// fragment's rows and keys, so nothing moves between lanes
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2], uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
}

// one block: NWG consumer warpgroups of 64 query rows each (warps 0 .. 4 NWG
// - 1) and the producer (the warps after them, of which one thread issues
// the loads); tq/tk/tv map the (hd, H, S, B) views of q, k and v in boxes of
// 64 columns x (64 NWG query or BK key) rows
template <int HD, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                   float* __restrict__ lse, int Sq, int Skv, int Hq, int rep, int64_t osb,
                   int64_t oss, float scale_log2, int causal, int window) {
  using namespace hopper;
  using C = WgCfg<HD>;
  constexpr int BQ = 64 * NWG, BK = C::BK, CB = C::CB, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);            // [CB][BQ][64]
  bf16* ks = qs + CB * BQ * 64;                         // [ST][CB][BK][64]
  bf16* vs = ks + ST * CB * BK * 64;                    // [ST][CB][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * CB * BK * 64);
  uint64_t* k_full = q_full + 1;                        // [ST] K tile landed
  uint64_t* v_full = k_full + ST;                       // [ST] V tile landed
  uint64_t* k_empty = v_full + ST;                      // [ST] K tile read by every consumer
  uint64_t* v_empty = k_empty + ST;                     // [ST] V tile read by every consumer

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // the longest causal walks first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 4 * NWG);                  // lane 0 of each consumer warp
      mbar_init(v_empty + s, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: Q once, then the live K/V tiles through the ring; rows past
    // S arrive as zeros. Beside two or three consumer warpgroups its
    // registers go to them: 24 here, 240 (160) there, of the 168 (128) a
    // thread that 384 (512) threads share
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(q_full, BQ * HD * 2);
      for (int cb = 0; cb < CB; ++cb)
        tma_load_4d(qs + cb * BQ * 64, &tq, q_full, 64 * cb, h, q0, b);
      // tile t of K or V into its stage once the consumers have released it
      const int hk = h / rep;
      auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full, uint64_t* empty,
                      int t) {
        const int i = t - t_begin, s = i % ST;
        mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, C::TILE_BYTES);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_4d(ring + (s * CB + cb) * BK * 64, map, full + s, 64 * cb, hk, t * BK, b);
      };
      // K runs a tile ahead of V, as the consumers use them
      for (int t = t_begin; t < t_end; ++t) {
        load(&tk, ks, k_full, k_empty, t);
        if (t > t_begin) load(&tv, vs, v_full, v_empty, t - 1);
      }
      if (t_begin < t_end) load(&tv, vs, v_full, v_empty, t_end - 1);
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63, its warp w%4 16 of them
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  if constexpr (NWG == 3) setmaxnreg_inc<160>();
  const int wg = warp / 4;
  const int wr0 = q0 + 64 * wg + 16 * (warp % 4);       // first row of the warp
  const int row_lo = wr0 + lane / 4, row_hi = row_lo + 8;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  // S is taken with the scale's sign (Q negated below), so the softmax
  // scales by |scale| and a row's largest score is its largest scaled one
  const RowMask mask{wr0, row_lo, row_hi, lane, Skv, causal, window, fabsf(scale_log2)};
  float acc[HD / 2];                                    // O, accumulator layout
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];                                     // S, then P (fp32)
  uint32_t ph[BK / 16][4], pl[BK / 16][4];              // P as two bf16 A operands
  mbar_wait(q_full, 0);
  if (scale_log2 < 0.f) {
    // a negative scale: the warpgroup negates its 64 rows of Q (a bf16 sign
    // flip is exact), then makes the writes visible to wgmma
    for (int cb = 0; cb < CB; ++cb) {
      uint4* rows = reinterpret_cast<uint4*>(qs + (cb * BQ + 64 * wg) * 64);
      for (int x = threadIdx.x % 128; x < 64 * 8; x += 128) {
        uint4 u = rows[x];
        u.x ^= 0x80008000u, u.y ^= 0x80008000u, u.z ^= 0x80008000u, u.w ^= 0x80008000u;
        rows[x] = u;
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % ST;
    // S = Q K^T (fp32): HD / 16 k-steps, the first one overwriting
    mbar_wait(k_full + s, (i / ST) & 1);
    const uint32_t k_addr = smem_u32(ks + s * CB * BK * 64);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd)
      wgmma_ss<BK>(sc, desc_sw128(q_addr + (kd / 4) * BQ * 128 + (kd % 4) * 32, 16, 1024),
                   desc_sw128(k_addr + (kd / 4) * BK * 128 + (kd % 4) * 32, 16, 1024), kd > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty + s);           // K's stage may be refilled
    mask.softmax<BK>(sc, t * BK, m, l, alpha);
    split_p<BK>(sc, ph, pl);
    // O rescaled on every tile: alpha = 1 exactly where a row's maximum
    // did not move, and O * 1 is O
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] *= alpha[(j / 2) % 2];

    // O += (P_hi + P_lo) V, V read transposed from its [key][d] tile
    mbar_wait(v_full + s, (i / ST) & 1);
    const uint32_t v_addr = smem_u32(vs + s * CB * BK * 64);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs_t<HD>(acc, ph[kk], dv);
      wgmma_rs_t<HD>(acc, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(v_empty + s);           // V's stage may be refilled
  }

  // epilogue: the quad's row sums, one cast, ragged rows unwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = r == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] = m[r] * kLn2 + logf(fmaxf(li, 1e-30f));
    bf16* orow = o + b * osb + (int64_t)row * oss + (int64_t)h * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// split TF32 on the tensor cores: the fp32 forward and the backward
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero):
// the bits of cvt.rna.tf32.f32 for every input but NaN, in two integer
// operations (half the dropped range added, the 13 low bits cleared), where
// ptxas expands cvt.rna with an inf/NaN test and a select
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo to ~22 significant bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// x = hi + mid + lo exactly: x - hi and (x - hi) - mid are exact in fp32,
// and the last has at most 2 significant bits, so it is a TF32 value
__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  hi = tf32(x);
  const float r = x - __uint_as_float(hi);
  mid = tf32(r);
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// An operand fragment in two TF32 terms.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

// d += A B in split TF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms
// first. For the products over the head dim (S = Q K^T, dP = dO V^T: hd / 8
// k-steps).
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// mma3 for dK and dV, sums over rep x the query rows: the k-step's products
// go into a zeroed accumulator that is added to d in IEEE fp32. The tensor
// cores' own fp32 accumulation rounds toward zero; along 4 x 4096 query
// rows that bias reached 3.8e-5 of max|dK| at mixtral-8x7b's training case
// (1, 4096, 32/8 heads of 128), 8x the fp32 plain version's own error; one
// rounded add per k-step brings it back to IEEE fp32's, as in ssd_scan.cu's
// mma3. dQ (over the keys) keeps within the fp32 plain version's error
// without it (3e-6 of max|dQ|), and its kernel has no registers to spare
// at hd 64 (two blocks per SM) and 128.
__device__ __forceinline__ void mma3_sum(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(p, a, b);
  d[0] += p[0]; d[1] += p[1]; d[2] += p[2]; d[3] += p[3];
}

// Fragment loads from a shared tile of pitch P (g = lane / 4, t = lane % 4).
// A, from a [row][k] tile at its (row 0, k 0): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4). With P = 4 mod 8 words (fp32: HD + 4; bf16:
// HD + 8 halves) the 32 lanes' words g P + t fall on 32 banks.
template <int P>
__device__ __forceinline__ void load_a(Frag<4>& f, const float* base, int g, int t) {
  const float* p = base + g * P + t;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * P], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * P + 4], f.hi[3], f.lo[3]);
}
// B, from an [n][k] tile (K for Q K^T): b0 (k t, n g), b1 (k t+4, n g)
template <int P>
__device__ __forceinline__ void load_b_nk(Frag<2>& f, const float* base, int g, int t) {
  const float* p = base + g * P + t;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
}
// B, from a [k][n] tile (V for P V) whose k rows are permuted in pairs:
// k-index t is row 2t, k-index t+4 is row 2t+1 (words 2t P + g: 32 banks)
template <int P>
__device__ __forceinline__ void load_b_kn(Frag<2>& f, const float* base, int g, int t) {
  const float* p = base + 2 * t * P + g;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[P], f.hi[1], f.lo[1]);
}
// A, from an accumulator n-tile c (rows g, g+8; columns 2t, 2t+1) under the
// same permutation: column 2t is k-index t, column 2t+1 is k-index t+4
__device__ __forceinline__ void acc_to_a(Frag<4>& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

// Elements of T per shared row of HD values: padded by 16 bytes.
template <typename T, int HD>
constexpr int kPitch = HD + 16 / (int)sizeof(T);

// rows [r0, r0 + ROWS) of one head (HD contiguous T per row, rows rs apart)
// into a shared tile of pitch kPitch, by 16-byte cp.async from the NT
// threads numbered tid; rows at or past n are zero-filled
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int64_t rs, int r0,
                                           int n, int tid) {
  constexpr int V = 16 / sizeof(T), CH = HD / V, P = kPitch<T, HD>;
  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < n;
    const T* s = ok ? src + (int64_t)(r0 + r) * rs + V * c : src;
    cp_async16(dst + r * P + V * c, s, ok ? 16 : 0);
  }
}

__device__ __forceinline__ bool live(int i, int j, int Sq, int Skv, int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) && (window < 0 || j > i - window);
}

// The forward and dQ kernels run two groups of 4 warps over the same 64
// query rows: group 0 takes the even K/V tiles of the row tile's key range,
// group 1 the odd ones, each with its own double buffer and barrier, and
// group 1 hands its sums to group 0 at the end (a fixed order). The warp
// that owns the last rows of a causal sequence walks every key; the split
// halves that longest walk.
constexpr int kGroupThreads = 128;             // 4 warps
constexpr int kPairThreads = 2 * kGroupThreads;

// barrier over one group's 128 threads (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kGroupThreads));
}

template <int HD>
struct Tf32Cfg {
  static constexpr int BK = HD <= 128 ? 32 : 16;     // keys per tile
  static constexpr int P = kPitch<float, HD>;
  static constexpr int NS = BK / 8;                  // score n-tiles per warp
  static constexpr int NO = HD / 8;                  // output n-tiles per warp
  static constexpr int TILE = BK * P;                // floats of a K or V tile
  // Q; per group K and V double-buffered
  static constexpr size_t SMEM = sizeof(float) * ((size_t)kBQ * P + 8 * (size_t)TILE);
  // group 1's hand-over (m, l, O of 4 warps) in the K/V region
  static_assert(4 * (4 + 4 * NO) * 32 <= 8 * TILE, "hand-over");
};

template <int HD>
__global__ void __launch_bounds__(kPairThreads, HD <= 64 ? 2 : 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Skv, int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb,
                  int64_t kss, int64_t vsb, int64_t vss, int64_t osb, int64_t oss,
                  float scale_log2, int causal, int window) {
  using C = Tf32Cfg<HD>;
  constexpr int BK = C::BK, P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [kBQ][P]
  const int grp = threadIdx.x / kGroupThreads, gtid = threadIdx.x % kGroupThreads;
  float* ks = qs + kBQ * P + grp * 4 * C::TILE;     // this group's [2][BK][P]
  float* vs = ks + 2 * C::TILE;                     // [2][BK][P]

  const int warp = gtid / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // the most causal work first
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const float* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const float* vb = v + b * vsb + (int64_t)(h / rep) * HD;

  // keys that some row of this tile may attend to: [k_begin, k_end)
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + BK - 1) / BK;
  const int t_first = k_begin / BK + grp;           // this group's tiles: t_first + 2 i

  stage_tile<float, HD, kBQ, kPairThreads>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, Sq,
                                           threadIdx.x);
  if (t_first < t_end) {
    stage_tile<float, HD, BK, kGroupThreads>(ks, kb, kss, t_first * BK, Skv, gtid);
    stage_tile<float, HD, BK, kGroupThreads>(vs, vb, vss, t_first * BK, Skv, gtid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                  // Q (both groups' copies) and the first tiles

  const int wr0 = q0 + 16 * warp;                 // first row of the warp
  const int row_lo = wr0 + g, row_hi = row_lo + 8;
  const float* qw = qs + 16 * warp * P;

  float acc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tt = t_first, it = 0; tt < t_end; tt += 2, ++it) {
    const int buf = it & 1;
    if (tt + 2 < t_end) {
      stage_tile<float, HD, BK, kGroupThreads>(ks + (buf ^ 1) * C::TILE, kb, kss, (tt + 2) * BK,
                                               Skv, gtid);
      stage_tile<float, HD, BK, kGroupThreads>(vs + (buf ^ 1) * C::TILE, vb, vss, (tt + 2) * BK,
                                               Skv, gtid);
    }
    cp_async_commit();              // possibly empty: keeps the group count uniform
    cp_async_wait<1>();             // tile tt has landed
    group_sync(grp);
    const float* kt = ks + buf * C::TILE;
    const float* vt = vs + buf * C::TILE;

    // S = Q K^T, three products per k-step (fp32 scores, unscaled)
    float s[C::NS][4];
#pragma unroll
    for (int j = 0; j < C::NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 8; ++kd) {
      Frag<4> a;
      load_a<P>(a, qw + 8 * kd, g, t);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        Frag<2> bk;
        load_b_nk<P>(bk, kt + 8 * j * P + 8 * kd, g, t);
        mma3(s[j], a, bk);
      }
    }

    // scale, mask, online softmax as in flash_mma_kernel (a tile inside
    // every row's live range skips the mask); element e of n-tile j sits at
    // row (e < 2 ? row_lo : row_hi), key k0 + 8 j + 2 t + (e & 1)
    const int k0 = tt * BK;
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wr0) ||
                           (window >= 0 && k0 <= wr0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        const int kp = k0 + 8 * j + 2 * t + (e & 1), qp = e < 2 ? row_lo : row_hi;
        if (need_mask && !live(qp, kp, Sq, Skv, causal, window)) x = kNegInf;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_ftz(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[j][e] == kNegInf ? 0.f : exp2_ftz(s[j][e] - m[e / 2]);
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];   // this lane's part
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // O += P V: P (two terms) from the score registers, keys permuted in
    // pairs; V in three terms, four products
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      Frag<4> pa;
      acc_to_a(pa, s[j]);
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        const float* vp = vt + (8 * j + 2 * t) * P + 8 * n + g;
        uint32_t h0, m0, l0, h1, m1, l1;
        split3_tf32(vp[0], h0, m0, l0);
        split3_tf32(vp[P], h1, m1, l1);
        mma_tf32(acc[n], pa.lo, h0, h1);
        mma_tf32(acc[n], pa.hi, l0, l1);
        mma_tf32(acc[n], pa.hi, m0, m1);
        mma_tf32(acc[n], pa.hi, h0, h1);
      }
    }
    group_sync(grp);                // tile tt's buffer may be refilled next
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // the quad's row sums
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // group 1 hands (m, l, O) to group 0, which rescales both to the larger m
  __syncthreads();                  // every K/V buffer is read: reuse the region
  float* red = qs + kBQ * P + warp * (4 + 4 * C::NO) * 32 + lane;
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      red[i * 32] = m[i];
      red[(2 + i) * 32] = l[i];
    }
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 + 4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (grp == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = red[i * 32], m_new = fmaxf(m[i], m1);
    a0[i] = exp2_ftz(m[i] - m_new);
    a1[i] = exp2_ftz(m1 - m_new);
    l[i] = l[i] * a0[i] + red[(2 + i) * 32] * a1[i];
    m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = acc[n][e] * a0[e / 2] + red[(4 + 4 * n + e) * 32] * a1[e / 2];

  // epilogue: ragged rows unwritten
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f), inv = 1.f / den;
    // m is in log2 units (scores pre-scaled by log2 e): back to natural log
    if (lse != nullptr && t == 0) lse[((int64_t)b * Hq + h) * Sq + row] = m[i] * kLn2 + logf(den);
    float* orow = o + b * osb + (int64_t)row * oss + (int64_t)h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      store2(orow + 8 * n, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int HD>
struct BwdQCfg {
  static constexpr int BK = HD <= 128 ? 32 : 8;      // keys per tile
  static constexpr int P = kPitch<float, HD>;
  static constexpr int NS = BK / 8, NO = HD / 8;
  static constexpr int TILE = BK * P;                // elements of a K or V tile
  // Q, dO; per group K and V double-buffered; the rows' delta
  static constexpr size_t SMEM = sizeof(float) * ((size_t)2 * kBQ * P + 8 * (size_t)TILE + kBQ);
  // group 1's hand-over (dQ of 4 warps) over the Q, dO and K/V tiles
  static_assert(4 * 4 * NO * 32 <= 2 * kBQ * P + 8 * TILE, "hand-over");
};

// dQ and delta of 64 query rows of one head. o, dout, dq contiguous
// (B, Sq, Hq, HD); lse, delta (B, Hq, Sq).
template <int HD>
__global__ void __launch_bounds__(kPairThreads, HD <= 64 ? 2 : 1)
flash_tf32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv,
                         int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss,
                         int64_t vsb, int64_t vss, float scale, float scale_log2, int causal,
                         int window) {
  using C = BwdQCfg<HD>;
  constexpr int BK = C::BK, P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [kBQ][P]
  float* dos = qs + kBQ * P;                        // [kBQ][P]
  const int grp = threadIdx.x / kGroupThreads, gtid = threadIdx.x % kGroupThreads;
  float* kv0 = dos + kBQ * P;                       // both groups' K/V region
  float* ks = kv0 + grp * 4 * C::TILE;              // this group's [2][BK][P]
  float* vs = ks + 2 * C::TILE;                     // [2][BK][P]
  float* dl_s = reinterpret_cast<float*>(kv0 + 8 * C::TILE);   // [kBQ]

  const int warp = gtid / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // the most causal work first
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int64_t oss = (int64_t)Hq * HD, osb = (int64_t)Sq * oss;
  const float* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const float* vb = v + b * vsb + (int64_t)(h / rep) * HD;

  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + BK - 1) / BK;
  const int t_first = k_begin / BK + grp;            // this group's tiles: t_first + 2 i

  stage_tile<float, HD, kBQ, kPairThreads>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, Sq,
                                       threadIdx.x);
  stage_tile<float, HD, kBQ, kPairThreads>(dos, dout + b * osb + (int64_t)h * HD, oss, q0, Sq,
                                       threadIdx.x);
  if (t_first < t_end) {
    stage_tile<float, HD, BK, kGroupThreads>(ks, kb, kss, t_first * BK, Skv, gtid);
    stage_tile<float, HD, BK, kGroupThreads>(vs, vb, vss, t_first * BK, Skv, gtid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                  // Q, dO and the first tiles have landed

  // delta = rowsum(dO * O) of the 64 rows, fp32: each of the 8 warps takes
  // 8 rows, one at a time over its lanes
  const int w8 = threadIdx.x / 32;
#pragma unroll
  for (int r = 8 * w8; r < 8 * w8 + 8; ++r) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < Sq) {
      const float* orow = o + b * osb + (int64_t)row * oss + (int64_t)h * HD;
      for (int d = lane; d < HD; d += 32) sum = fmaf(orow[d], dos[r * P + d], sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dl_s[r] = sum;
      if (row < Sq) delta[((int64_t)b * Hq + h) * Sq + row] = sum;
    }
  }
  __syncthreads();
  const int row_lo = q0 + 16 * warp + g, row_hi = row_lo + 8;
  const float dl[2] = {dl_s[16 * warp + g], dl_s[16 * warp + g + 8]};
  float l2[2];                      // the rows' lse in log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    l2[i] = row < Sq ? lse[((int64_t)b * Hq + h) * Sq + row] * kLog2e : 0.f;
  }

  const float* qw = qs + 16 * warp * P;
  const float* dw = dos + 16 * warp * P;
  float acc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tt = t_first, it = 0; tt < t_end; tt += 2, ++it) {
    const int buf = it & 1;
    if (tt + 2 < t_end) {
      stage_tile<float, HD, BK, kGroupThreads>(ks + (buf ^ 1) * C::TILE, kb, kss, (tt + 2) * BK,
                                           Skv, gtid);
      stage_tile<float, HD, BK, kGroupThreads>(vs + (buf ^ 1) * C::TILE, vb, vss, (tt + 2) * BK,
                                           Skv, gtid);
    }
    cp_async_commit();
    cp_async_wait<1>();             // tile tt has landed
    group_sync(grp);
    const float* kt = ks + buf * C::TILE;
    const float* vt = vs + buf * C::TILE;

    // S = Q K^T and dP = dO V^T
    float s[C::NS][4], dp[C::NS][4];
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 8; ++kd) {
      Frag<4> aq, ad;
      load_a<P>(aq, qw + 8 * kd, g, t);
      load_a<P>(ad, dw + 8 * kd, g, t);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        Frag<2> bk, bv;
        load_b_nk<P>(bk, kt + 8 * j * P + 8 * kd, g, t);
        load_b_nk<P>(bv, vt + 8 * j * P + 8 * kd, g, t);
        mma3(s[j], aq, bk);
        mma3(dp[j], ad, bv);
      }
    }

    // dS = P (dP - delta), P = 2^(scale log2e s - lse log2e), masked 0;
    // element e of n-tile j: row (e < 2 ? row_lo : row_hi), key k0 + 8 j + 2 t + (e & 1)
    const int k0 = tt * BK;
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1), qp = e < 2 ? row_lo : row_hi;
        const float p = live(qp, kp, Sq, Skv, causal, window)
                            ? exp2_ftz(fmaf(s[j][e], scale_log2, -l2[e / 2]))
                            : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e / 2]);
      }

    // dQ += dS K, keys permuted in pairs
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      Frag<4> a;
      acc_to_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        Frag<2> bk;
        load_b_kn<P>(bk, kt + 8 * j * P + 8 * n, g, t);
        mma3(acc[n], a, bk);
      }
    }
    group_sync(grp);                // tile tt's buffer may be refilled next
  }
  cp_async_wait<0>();

  // group 1 hands its sums to group 0 (a fixed order)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw) + warp * 4 * C::NO * 32 + lane;
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;        // ragged q tail: not written
    float* drow = dq + b * osb + (int64_t)row * oss + (int64_t)h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      store2(drow + 8 * n, (acc[n][2 * i] + red[(4 * n + 2 * i) * 32]) * scale,
             (acc[n][2 * i + 1] + red[(4 * n + 2 * i + 1) * 32]) * scale);
  }
}

constexpr int kKVThreads = 128;     // 4 warps: the 4 quarters of a query tile

template <int HD>
struct BwdKVCfg {
  static constexpr int BKV = 16;                     // keys per block
  static constexpr int BQ = HD <= 128 ? 64 : 32;     // query rows per tile: 4 quarters
  static constexpr int NQ = BQ / 32;                 // score n-tiles per warp
  static constexpr int DN = HD <= 64 ? HD : HD / 2;  // dK/dV columns per block
  static constexpr int NO = DN / 8;
  static constexpr int P = kPitch<float, HD>;
  // K, V; Q, dO double-buffered
  static constexpr size_t SMEM = sizeof(float) * (size_t)(2 * BKV + 4 * BQ) * P;
  // warps 1-3's hand-over (dK, dV) in the Q and dO buffers
  static_assert(3 * 2 * NO * 4 * 32 <= 4 * BQ * P, "hand-over");
};

// dK and dV of 16 keys of one KV head, columns [d0, d0 + DN), summed over
// the rep query heads of that KV head; warp w takes quarter w of each query
// tile. dout contiguous (B, Sq, Hq, HD); dk, dv contiguous (B, Skv, Hkv,
// HD); lse, delta (B, Hq, Sq).
template <int HD>
__global__ void __launch_bounds__(kKVThreads)
flash_tf32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                           int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss,
                           int64_t vsb, int64_t vss, float scale, float scale_log2, int causal,
                           int window) {
  using C = BwdKVCfg<HD>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NQ = C::NQ, NO = C::NO, P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [BKV][P]
  float* vs = ks + BKV * P;                         // [BKV][P]
  float* qs = vs + BKV * P;                         // [2][BQ][P]
  float* dos = qs + 2 * BQ * P;                     // [2][BQ][P]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.y * BKV;                   // the most causal work first
  const int Hkv = Hq / rep;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int d0 = blockIdx.z * C::DN;
  const int64_t oss = (int64_t)Hq * HD, osb = (int64_t)Sq * oss;

  stage_tile<float, HD, BKV, kKVThreads>(ks, k + b * ksb + (int64_t)hk * HD, kss, k0, Skv,
                                     threadIdx.x);
  stage_tile<float, HD, BKV, kKVThreads>(vs, v + b * vsb + (int64_t)hk * HD, vss, k0, Skv,
                                     threadIdx.x);

  // query rows that may attend to a key of this tile: [q_begin, q_end);
  // the work items are (query head, query tile), heads outermost
  const int q_begin = causal ? k0 : 0;
  long long q_end = Sq;
  if (window >= 0) {
    const long long last = (long long)min(k0 + BKV, Skv) - 1 + window;
    q_end = last < q_end ? last : q_end;
  }
  const int qt_begin = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (int)((q_end + BQ - 1) / BQ) - qt_begin : 0;
  const int items = rep * n_qt;
  auto stage_item = [&](int it, int buf) {
    const int h = hk * rep + it / n_qt, i0 = (qt_begin + it % n_qt) * BQ;
    stage_tile<float, HD, BQ, kKVThreads>(qs + buf * BQ * P, q + b * qsb + (int64_t)h * HD, qss,
                                      i0, Sq, threadIdx.x);
    stage_tile<float, HD, BQ, kKVThreads>(dos + buf * BQ * P, dout + b * osb + (int64_t)h * HD,
                                      oss, i0, Sq, threadIdx.x);
  };
  if (items > 0) stage_item(0, 0);
  cp_async_commit();                // K, V and the first item

  const int key_lo = k0 + g, key_hi = key_lo + 8;
  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = 0; it < items; ++it) {
    const int buf = it & 1;
    if (it + 1 < items) stage_item(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();             // item it has landed
    __syncthreads();
    const int h = hk * rep + it / n_qt;
    const int qb = (qt_begin + it % n_qt) * BQ + warp * (BQ / 4);   // the warp's first query
    const float* qt = qs + buf * BQ * P + warp * (BQ / 4) * P;
    const float* dt = dos + buf * BQ * P + warp * (BQ / 4) * P;

    // lse (log2 units) and delta of this lane's queries qb + 8 j + 2 t + c
    float l2[NQ][2], dl[NQ][2];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qp = qb + 8 * j + 2 * t + c;
        const int64_t i = ((int64_t)b * Hq + h) * Sq + qp;
        l2[j][c] = qp < Sq ? lse[i] * kLog2e : 0.f;
        dl[j][c] = qp < Sq ? delta[i] : 0.f;
      }

    // S^T = K Q^T and dP^T = V dO^T: rows the block's 16 keys, columns the
    // warp's queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 8; ++kd) {
      Frag<4> ak, av;
      load_a<P>(ak, ks + 8 * kd, g, t);
      load_a<P>(av, vs + 8 * kd, g, t);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        Frag<2> bq, bd;
        load_b_nk<P>(bq, qt + 8 * j * P + 8 * kd, g, t);
        load_b_nk<P>(bd, dt + 8 * j * P + 8 * kd, g, t);
        mma3(st[j], ak, bq);
        mma3(dpt[j], av, bd);
      }
    }

    // P^T and dS^T; element e of n-tile j: key (e < 2 ? key_lo : key_hi),
    // query qb + 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, kp = e < 2 ? key_lo : key_hi, qp = qb + 8 * j + 2 * t + c;
        const float p = live(qp, kp, Sq, Skv, causal, window)
                            ? exp2_ftz(fmaf(st[j][e], scale_log2, -l2[j][c]))
                            : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[j][c]);
      }

    // dV += P^T dO, dK += dS^T Q, queries permuted in pairs
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      Frag<4> ap, as;
      acc_to_a(ap, st[j]);
      acc_to_a(as, dpt[j]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        Frag<2> bd, bq;
        load_b_kn<P>(bd, dt + 8 * j * P + d0 + 8 * n, g, t);
        load_b_kn<P>(bq, qt + 8 * j * P + d0 + 8 * n, g, t);
        mma3_sum(adv[n], ap, bd);
        mma3_sum(adk[n], as, bq);
      }
    }
    __syncthreads();                // item it's buffer may be refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // warps 1-3 hand their sums to warp 0, which adds them in warp order
  float* red = reinterpret_cast<float*>(qs) + lane;  // [warp 1..3][dK, dV][NO][4][32]
  if (warp > 0) {
    float* mine = red + (warp - 1) * 2 * NO * 4 * 32;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32] = adk[n][e];
        mine[((NO + n) * 4 + e) * 32] = adv[n][e];
      }
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const float* other = red + w * 2 * NO * 4 * 32;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adk[n][e] += other[(n * 4 + e) * 32];
        adv[n][e] += other[((NO + n) * 4 + e) * 32];
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i == 0 ? key_lo : key_hi;
    if (key >= Skv) continue;
    const int64_t off = ((int64_t)b * Skv + key) * Hkv * HD + (int64_t)hk * HD + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      store2(dk + off + 8 * n, adk[n][2 * i] * scale, adk[n][2 * i + 1] * scale);
      store2(dv + off + 8 * n, adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward: bf16 products on the tensor cores, split-bf16 P and dS
// ---------------------------------------------------------------------------

// 4-byte global -> shared copy; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// An m16n8k16 A fragment of 16 rows x 16 k from two adjacent accumulator
// n-tiles (16 columns: the FlashAttention-2 register layout), each fp32
// value split into hi + lo bf16 terms
__device__ __forceinline__ void acc_to_a2(const float (&c0)[4], const float (&c1)[4],
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// d (two 8-wide n-tiles) += (hi + lo) b: the B fragments b[0..1] and b[2..3]
// of an ldmatrix.x4, two products per n-tile into one fp32 accumulator
__device__ __forceinline__ void mma_split(float (&d0)[4], float (&d1)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], const uint32_t (&b)[4]) {
  mma_bf16(d0, hi, b[0], b[1]);
  mma_bf16(d0, lo, b[0], b[1]);
  mma_bf16(d1, hi, b[2], b[3]);
  mma_bf16(d1, lo, b[2], b[3]);
}

// sum + the dot product of 8 bf16 pairs (16 bytes each), fp32
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float sum) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    sum = fmaf(fx.x, fy.x, sum);
    sum = fmaf(fx.y, fy.y, sum);
  }
  return sum;
}

template <int HD>
struct Bf16BwdQCfg {
  static constexpr int NW = 4;                       // warps of 16 query rows
  static constexpr int BQ = 16 * NW, THREADS = 32 * NW;
  static constexpr int MIN_BLOCKS = HD <= 64 ? 3 : 2;   // blocks per SM
  static constexpr int BK = HD <= 128 ? 64 : 16;     // keys per tile
  static constexpr int P = kPitch<bf16, HD>;
  static constexpr int KD = HD / 16, NS = BK / 8, NO = HD / 8;
  static constexpr int TILE = BK * P;                // bf16 of a K or V tile
  // Q, dO; K and V double-buffered; the rows' delta
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)2 * BQ * P + 4 * (size_t)TILE) + sizeof(float) * BQ;
};

// dQ and delta of BQ query rows of one head, a warp per 16 rows. o, dout,
// dq contiguous (B, Sq, Hq, HD); lse, delta (B, Hq, Sq).
template <int HD>
__global__ void __launch_bounds__(Bf16BwdQCfg<HD>::THREADS, Bf16BwdQCfg<HD>::MIN_BLOCKS)
flash_bf16_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv,
                         int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss,
                         int64_t vsb, int64_t vss, float scale, float scale_log2, int causal,
                         int window) {
  using C = Bf16BwdQCfg<HD>;
  constexpr int BK = C::BK, P = C::P, BQ = C::BQ, NT = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);      // [BQ][P]
  bf16* dos = qs + BQ * P;                           // [BQ][P]
  bf16* ks = dos + BQ * P;                           // [2][BK][P]
  bf16* vs = ks + 2 * C::TILE;                       // [2][BK][P]
  float* dl_s = reinterpret_cast<float*>(vs + 2 * C::TILE);   // [BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the most causal work first
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int64_t oss = (int64_t)Hq * HD, osb = (int64_t)Sq * oss;
  const bf16* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const bf16* vb = v + b * vsb + (int64_t)(h / rep) * HD;

  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  stage_tile<bf16, HD, BQ, NT>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, Sq, threadIdx.x);
  stage_tile<bf16, HD, BQ, NT>(dos, dout + b * osb + (int64_t)h * HD, oss, q0, Sq,
                               threadIdx.x);
  if (t_begin < t_end) {
    stage_tile<bf16, HD, BK, NT>(ks, kb, kss, t_begin * BK, Skv, threadIdx.x);
    stage_tile<bf16, HD, BK, NT>(vs, vb, vss, t_begin * BK, Skv, threadIdx.x);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                  // Q, dO and the first tiles have landed

  // delta = rowsum(dO * O) of the warp's 16 rows, fp32: two lanes per row,
  // each over half of the row's 16-byte chunks (all loads in flight at once)
  {
    constexpr int HALF = HD / 16;                    // chunks per lane
    const int r = 16 * warp + lane / 2, row = q0 + r, c0 = (lane & 1) * HALF;
    float sum = 0.f;
    if (row < Sq) {
      const bf16* orow = o + b * osb + (int64_t)row * oss + (int64_t)h * HD;
#pragma unroll
      for (int c = c0; c < c0 + HALF; ++c)
        sum = dot8(*reinterpret_cast<const uint4*>(orow + 8 * c),
                   *reinterpret_cast<const uint4*>(dos + r * P + 8 * c), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0) {
      dl_s[r] = sum;
      if (row < Sq) delta[((int64_t)b * Hq + h) * Sq + row] = sum;
    }
  }
  __syncwarp();
  const int wr0 = q0 + 16 * warp;                    // first row of the warp
  const int row_lo = wr0 + lane / 4, row_hi = row_lo + 8;
  const float dl[2] = {dl_s[16 * warp + lane / 4], dl_s[16 * warp + lane / 4 + 8]};
  float l2[2];                      // the rows' lse in log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    l2[i] = row < Sq ? lse[((int64_t)b * Hq + h) * Sq + row] * kLog2e : 0.f;
  }

  // per-lane offsets of the ldmatrix addresses (flash_mma_kernel's)
  const int a_row = lane % 16, a_col = (lane / 16) * 8;                    // A, plain
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;   // B, plain
  const int t_row = (lane % 8) + ((lane / 8) % 2) * 8, t_col = (lane / 16) * 8;  // B, trans
  const bf16* qw = qs + (16 * warp + a_row) * P + a_col;
  const bf16* dw = dos + (16 * warp + a_row) * P + a_col;

  float acc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tt = t_begin; tt < t_end; ++tt) {
    const int buf = (tt - t_begin) & 1;
    if (tt + 1 < t_end) {
      stage_tile<bf16, HD, BK, NT>(ks + (buf ^ 1) * C::TILE, kb, kss, (tt + 1) * BK, Skv,
                                   threadIdx.x);
      stage_tile<bf16, HD, BK, NT>(vs + (buf ^ 1) * C::TILE, vb, vss, (tt + 1) * BK, Skv,
                                   threadIdx.x);
    }
    cp_async_commit();              // possibly empty: keeps the group count uniform
    cp_async_wait<1>();             // tile tt has landed
    __syncthreads();
    const bf16* kt = ks + buf * C::TILE;
    const bf16* vt = vs + buf * C::TILE;

    // S = Q K^T and dP = dO V^T, one bf16 product each (K and V are
    // [key][d]: B fragments by plain ldmatrix)
    float s[C::NS][4], dp[C::NS][4];
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t aq[4], ad[4];
      ldmatrix_x4(aq, qw + 16 * kd);
      ldmatrix_x4(ad, dw + 16 * kd);
#pragma unroll
      for (int jj = 0; jj < C::NS / 2; ++jj) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, kt + (16 * jj + b_row) * P + 16 * kd + b_col);
        ldmatrix_x4(bv, vt + (16 * jj + b_row) * P + 16 * kd + b_col);
        mma_bf16(s[2 * jj], aq, bk[0], bk[1]);
        mma_bf16(s[2 * jj + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * jj], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * jj + 1], ad, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta), P = 2^(scale log2e s - lse log2e), masked 0, in
    // fp32; element e of n-tile j: row (e < 2 ? row_lo : row_hi), key
    // k0 + 8 j + 2 t + (e & 1). A tile inside every row's live range
    // skips the mask.
    const int k0 = tt * BK;
    const bool need_mask = k0 + BK > Skv || wr0 + 16 > Sq || (causal && k0 + BK - 1 > wr0) ||
                           (window >= 0 && k0 <= wr0 + 15 - window);
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1), qp = e < 2 ? row_lo : row_hi;
        float p = 0.f;
        if (!need_mask || live(qp, kp, Sq, Skv, causal, window))
          p = exp2_ftz(fmaf(s[j][e], scale_log2, -l2[e / 2]));
        s[j][e] = p * (dp[j][e] - dl[e / 2]);
      }

    // dQ += (dS_hi + dS_lo) K: score n-tiles 2 kk and 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15; K [key][d] is read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      acc_to_a2(s[2 * kk], s[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, kt + (16 * kk + t_row) * P + 16 * dd + t_col);
        mma_split(acc[2 * dd], acc[2 * dd + 1], sh, sl, bk);
      }
    }
    __syncthreads();                // tile tt's buffer may be refilled next
  }
  cp_async_wait<0>();

  // epilogue: one cast, ragged rows unwritten
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    bf16* drow = dq + b * osb + (int64_t)row * oss + (int64_t)h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      store2(drow + 8 * n, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

constexpr size_t kSmemMax = 232448;                // shared memory a block can have

// barrier over `threads` threads (a multiple of 32) under barrier id `id`
// (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads));
}

template <int HD, int NG>
struct Bf16BwdKVCfg {
  static constexpr int NW = 8 / NG;                  // warps per group
  static constexpr int GT = 32 * NW;                 // threads per group
  static constexpr int BKV = 16 * NW;                // keys per block: 16 per warp of a group
  static constexpr int BQ = HD <= 64 ? 64 : 32;      // query rows per item
  static constexpr bool KV_IN_REGS = HD <= 64;       // K and V as A fragments
  static constexpr int NQ = BQ / 8;                  // S^T n-tiles per warp
  // dK/dV columns per block: all up to hd = 128, above that the first of
  // two column blocks takes 16 * ceil(hd / 32) (the other the rest), so the
  // two fp32 accumulators fit in registers
  static constexpr int DN = HD <= 128 ? HD : 16 * ((HD + 31) / 32);
  static constexpr int NZ = (HD + DN - 1) / DN;      // column blocks
  static constexpr int NO = DN / 8;
  static constexpr int KD = HD / 16;
  static constexpr int P = kPitch<bf16, HD>;
  static constexpr int ITEM = BQ * P;                // bf16 of a Q or dO tile
  // K, V; per group Q and dO double-buffered; per group lse and delta
  // double-buffered
  static constexpr size_t SMEM = sizeof(bf16) * ((size_t)2 * BKV * P + NG * 4 * (size_t)ITEM) +
                                 sizeof(float) * NG * 4 * BQ;
  // groups 1..NG-1 hand their dK, dV over the Q and dO buffers
  static_assert(sizeof(float) * (NG - 1) * NW * 2 * NO * 4 * 32 <= sizeof(bf16) * NG * 4 * ITEM,
                "hand-over");
};

// dK and dV of BKV keys of one KV head, columns [d0, d0 + DN), summed over
// the rep query heads of that KV head. NG groups of NW = 8 / NG warps: warp
// w of a group owns keys 16 w .. 16 w + 15 of the block; group g walks the
// (query head, query tile) items g, g + NG, ..., each group with its own
// double buffer and barrier, and groups 1..NG-1 hand their sums to group 0,
// which adds them in group order. dout contiguous (B, Sq, Hq, HD); dk, dv
// contiguous (B, Skv, Hkv, HD); lse, delta (B, Hq, Sq).
template <int HD, int NG>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_bf16_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                           int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss,
                           int64_t vsb, int64_t vss, float scale, float scale_log2, int causal,
                           int window) {
  using C = Bf16BwdKVCfg<HD, NG>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NQ = C::NQ, NO = C::NO, P = C::P, ITEM = C::ITEM;
  constexpr int GT = C::GT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);      // [BKV][P]
  bf16* vs = ks + BKV * P;                           // [BKV][P]
  bf16* qd = vs + BKV * P;                           // the groups' Q and dO buffers
  const int grp = threadIdx.x / GT, gtid = threadIdx.x % GT;
  bf16* qs = qd + grp * 4 * ITEM;                    // this group's [2][BQ][P]
  bf16* dos = qs + 2 * ITEM;                         // [2][BQ][P]
  float* ld = reinterpret_cast<float*>(qd + NG * 4 * ITEM) + grp * 4 * BQ;   // [2][lse, delta][BQ]

  const int warp = gtid / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int Hkv = Hq / rep;
  const int z = blockIdx.x % C::NZ, bh = blockIdx.x / C::NZ;   // column blocks side by side
  const int b = bh / Hkv, hk = bh % Hkv;
  const int k0 = blockIdx.y * BKV;                   // the most causal work first
  const int d0 = z * C::DN;
  const int64_t oss = (int64_t)Hq * HD, osb = (int64_t)Sq * oss;

  stage_tile<bf16, HD, BKV, kPairThreads>(ks, k + b * ksb + (int64_t)hk * HD, kss, k0, Skv,
                                          threadIdx.x);
  stage_tile<bf16, HD, BKV, kPairThreads>(vs, v + b * vsb + (int64_t)hk * HD, vss, k0, Skv,
                                          threadIdx.x);

  // query rows that may attend to a key of this block: [q_begin, q_end);
  // the items are (query head, query tile), heads outermost
  const int q_begin = causal ? k0 : 0;
  long long q_end = Sq;
  if (window >= 0) {
    const long long last = (long long)min(k0 + BKV, Skv) - 1 + window;
    q_end = last < q_end ? last : q_end;
  }
  const int qt_begin = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (int)((q_end + BQ - 1) / BQ) - qt_begin : 0;
  const int items = rep * n_qt;
  // Q, dO, lse and delta of item `it` into buffer `buf`, by this group's
  // threads; rows at or past Sq are zero-filled
  auto stage_item = [&](int it, int buf) {
    const int h = hk * rep + it / n_qt, i0 = (qt_begin + it % n_qt) * BQ;
    stage_tile<bf16, HD, BQ, GT>(qs + buf * ITEM, q + b * qsb + (int64_t)h * HD, qss, i0, Sq,
                                 gtid);
    stage_tile<bf16, HD, BQ, GT>(dos + buf * ITEM, dout + b * osb + (int64_t)h * HD, oss, i0,
                                 Sq, gtid);
    for (int j = gtid; j < 2 * BQ; j += GT) {
      const int r = j % BQ;
      const float* src = j < BQ ? lse : delta;
      const bool ok = i0 + r < Sq;
      cp_async4(ld + buf * 2 * BQ + j, ok ? src + ((int64_t)b * Hq + h) * Sq + i0 + r : src,
                ok ? 4 : 0);
    }
  };
  if (grp < items) stage_item(grp, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                  // K, V (all groups' copies) and each group's first item

  const int kw = 16 * warp;                          // the warp's first key in the block
  const int key_lo = k0 + kw + g, key_hi = key_lo + 8;
  const int a_row = lane % 16, a_col = (lane / 16) * 8;                    // A, plain
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;   // B, plain
  const int t_row = (lane % 8) + ((lane / 8) % 2) * 8, t_col = (lane / 16) * 8;  // B, trans
  const bf16* kw_s = ks + (kw + a_row) * P + a_col;
  const bf16* vw_s = vs + (kw + a_row) * P + a_col;
  uint32_t kf[C::KV_IN_REGS ? C::KD : 1][4], vf[C::KV_IN_REGS ? C::KD : 1][4];
  if constexpr (C::KV_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      ldmatrix_x4(kf[kd], kw_s + 16 * kd);
      ldmatrix_x4(vf[kd], vw_s + 16 * kd);
    }
  }

  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = grp, i = 0; it < items; it += NG, ++i) {
    const int buf = i & 1;
    if (it + NG < items) stage_item(it + NG, buf ^ 1);
    cp_async_commit();              // possibly empty: keeps the group count uniform
    cp_async_wait<1>();             // item it has landed
    bar_sync(grp + 1, GT);
    const int qb = (qt_begin + it % n_qt) * BQ;      // the item's first query
    const bf16* qt = qs + buf * ITEM;
    const bf16* dt = dos + buf * ITEM;
    const float* lt = ld + buf * 2 * BQ;             // lse, then delta
    const float* dlt = lt + BQ;

    // S^T = K Q^T and dP^T = V dO^T, one bf16 product each: rows the
    // warp's 16 keys, columns the item's BQ queries (Q and dO are
    // [query][d]: B fragments by plain ldmatrix)
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t ak[4], av[4];
      if constexpr (C::KV_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = kf[kd][i];
          av[i] = vf[kd][i];
        }
      } else {
        ldmatrix_x4(ak, kw_s + 16 * kd);
        ldmatrix_x4(av, vw_s + 16 * kd);
      }
#pragma unroll
      for (int jj = 0; jj < NQ / 2; ++jj) {
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, qt + (16 * jj + b_row) * P + 16 * kd + b_col);
        ldmatrix_x4(bd, dt + (16 * jj + b_row) * P + 16 * kd + b_col);
        mma_bf16(st[2 * jj], ak, bq[0], bq[1]);
        mma_bf16(st[2 * jj + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[2 * jj], av, bd[0], bd[1]);
        mma_bf16(dpt[2 * jj + 1], av, bd[2], bd[3]);
      }
    }

    // P^T and dS^T in fp32; element e of n-tile j: key (e < 2 ? key_lo :
    // key_hi), query qb + 8 j + 2 t + (e & 1). A tile inside every key's
    // live range skips the mask.
    const int kw0 = k0 + kw;
    const bool need_mask = kw0 + 16 > Skv || qb + BQ > Sq || (causal && kw0 + 15 > qb) ||
                           (window >= 0 && qb + BQ - 1 - window >= kw0);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
      const float l2[2] = {lv.x * kLog2e, lv.y * kLog2e}, dlc[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, kp = e < 2 ? key_lo : key_hi, qp = qb + 8 * j + 2 * t + c;
        float p = 0.f;
        if (!need_mask || live(qp, kp, Sq, Skv, causal, window))
          p = exp2_ftz(fmaf(st[j][e], scale_log2, -l2[c]));
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dlc[c]);
      }
    }

    // dV += (P^T_hi + P^T_lo) dO and dK += (dS^T_hi + dS^T_lo) Q over the
    // item's queries, 16 per k-step (dO and Q read transposed)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_to_a2(st[2 * kk], st[2 * kk + 1], ph, pl);
      acc_to_a2(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < NO / 2; ++dd) {
        if (d0 + 16 * dd >= HD) continue;            // the narrower column block
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, dt + (16 * kk + t_row) * P + d0 + 16 * dd + t_col);
        mma_split(adv[2 * dd], adv[2 * dd + 1], ph, pl, bd);
        ldmatrix_x4_trans(bq, qt + (16 * kk + t_row) * P + d0 + 16 * dd + t_col);
        mma_split(adk[2 * dd], adk[2 * dd + 1], sh, sl, bq);
      }
    }
    bar_sync(grp + 1, GT);          // item it's buffer may be refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // groups 1..NG-1 hand their sums to group 0, which adds them in group
  // order (a fixed order)
  constexpr int SLOT = 2 * NO * 4 * 32;              // floats of one warp's dK and dV
  float* red = reinterpret_cast<float*>(qd) + lane;
  if (grp > 0) {
    float* mine = red + ((grp - 1) * C::NW + warp) * SLOT;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32] = adk[n][e];
        mine[((NO + n) * 4 + e) * 32] = adv[n][e];
      }
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int o = 1; o < NG; ++o) {
    const float* other = red + ((o - 1) * C::NW + warp) * SLOT;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adk[n][e] += other[(n * 4 + e) * 32];
        adv[n][e] += other[((NO + n) * 4 + e) * 32];
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i == 0 ? key_lo : key_hi;
    if (key >= Skv) continue;
    const int64_t off = ((int64_t)b * Skv + key) * Hkv * HD + (int64_t)hk * HD + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (d0 + 8 * n >= HD) continue;
      store2(dk + off + 8 * n, adk[n][2 * i] * scale, adk[n][2 * i + 1] * scale);
      store2(dv + off + 8 * n, adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward at hd 64, 128 and 256: flash_wgmma_bwd_dq_kernel and
// flash_wgmma_bwd_dkdv_kernel, wgmma fed by TMA
// ---------------------------------------------------------------------------

template <int HD>
struct WgBwdCfg {
  static constexpr int CB = HD / 64;                     // 128-byte column blocks per row
  static constexpr int BK = 64;                          // dQ: keys per K/V tile
  static constexpr int BQ = 64;                          // dK/dV: query rows per item
  static constexpr int STAGES = 2;                       // ring depth, both kernels
  static constexpr int DN = HD <= 128 ? HD : 128;        // dK/dV columns per block
  static constexpr int NZ = HD / DN;                     // dK/dV column blocks
  // consumer warpgroups a block may have: the registers of a warpgroup's
  // state (dQ: 64 x hd fp32; dK/dV: two 64 x DN) and the shared memory
  static constexpr int DQ_NWG = HD == 64 ? 3 : HD == 128 ? 2 : 1;
  static constexpr int KV_NWG = HD <= 128 ? 2 : 1;
  // dQ: Q and dO of the block's rows, the K/V ring, delta, the barriers,
  // and slack to align the tiles to 1024 bytes
  static constexpr size_t dq_smem(int nwg) {
    return 1024 + (size_t)2 * 64 * nwg * HD * 2 + (size_t)2 * STAGES * BK * HD * 2 +
           4 * 64 * nwg + 8 * (1 + 2 * STAGES);
  }
  // dK/dV: K and V of the block's keys, the Q/dO ring, lse and delta per
  // stage, the barriers, the slack
  static constexpr size_t dkdv_smem(int nwg) {
    return 1024 + (size_t)2 * 64 * nwg * HD * 2 + (size_t)2 * STAGES * BQ * HD * 2 +
           STAGES * 2 * BQ * 4 + 8 * (1 + 2 * STAGES);
  }
};

// dS = P (dP - delta) of one warp's 16 query rows over a tile of BK keys in
// the accumulator layout (register 4 j + e: row e < 2 ? row_lo : row_hi, key
// k0 + 8 j + 2 (lane % 4) + e % 2), P = 2^(s scale log2 e - lse log2 e) with
// masked entries 0 (keys past Skv too: their K rows are TMA's zeros, and P
// there could overflow). dS replaces dP.
template <int BK, bool MASKED>
__device__ __forceinline__ void rows_ds(const float (&s)[BK / 2], float (&dp)[BK / 2],
                                        const float (&l2)[2], const float (&dl)[2],
                                        float scale_log2, int k0, int row_lo, int row_hi, int lane,
                                        int Skv, int causal, int window) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(s[4 * j + e], scale_log2, -l2[e / 2]));
      if (MASKED) {
        const int kp = k0 + 8 * j + 2 * (lane % 4) + (e & 1), qp = e < 2 ? row_lo : row_hi;
        if (!(kp < Skv && (!causal || kp <= qp) && (window < 0 || kp > qp - window))) p = 0.f;
      }
      dp[4 * j + e] = p * (dp[4 * j + e] - dl[e / 2]);
    }
}

// P^T and dS^T of one warp's 16 keys over an item of BQ query rows in the
// accumulator layout (register 4 j + e: key e < 2 ? key_lo : key_hi, query
// qb + 8 j + 2 (lane % 4) + e % 2); l holds the item's lse (log2 units) and
// then its delta. Query rows past Sq have lse 1e30 there, so their P is 0
// with no mask; keys past Skv are rows that are never stored.
template <int BQ, bool MASKED>
__device__ __forceinline__ void keys_p_ds(float (&st)[BQ / 2], float (&dpt)[BQ / 2],
                                          const float* l, float scale_log2, int qb, int key_lo,
                                          int key_hi, int lane, int causal, int window) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 lv = *reinterpret_cast<const float2*>(l + 8 * j + 2 * (lane % 4));
    const float2 dv = *reinterpret_cast<const float2*>(l + BQ + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      float p = exp2_ftz(fmaf(st[4 * j + e], scale_log2, -(c ? lv.y : lv.x)));
      if (MASKED) {
        const int kp = e < 2 ? key_lo : key_hi, qp = qb + 8 * j + 2 * (lane % 4) + c;
        if (!((!causal || kp <= qp) && (window < 0 || kp > qp - window))) p = 0.f;
      }
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - (c ? dv.y : dv.x));
    }
  }
}

// dQ and delta of 64 NWG query rows of one head: NWG consumer warpgroups of
// 64 rows (warps 0 .. 4 NWG - 1) and the producer (the warps after them, of
// which one thread issues the loads). tq/tdo map the (hd, H, S, B) views of
// q and dout in boxes of 64 columns x 64 NWG rows, tk/tv those of k and v
// in boxes of 64 columns x BK rows. o, dout, dq contiguous (B, Sq, Hq, HD);
// lse, delta (B, Hq, Sq).
template <int HD, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
flash_wgmma_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const bf16* __restrict__ o,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Skv, int Hq, int rep, float scale,
                          float scale_log2, int causal, int window) {
  using namespace hopper;
  using C = WgBwdCfg<HD>;
  constexpr int BQ = 64 * NWG, BK = C::BK, CB = C::CB, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);            // [CB][BQ][64]
  bf16* dos = qs + CB * BQ * 64;                        // [CB][BQ][64]
  bf16* ks = dos + CB * BQ * 64;                        // [ST][CB][BK][64]
  bf16* vs = ks + ST * CB * BK * 64;                    // [ST][CB][BK][64]
  float* dl_s = reinterpret_cast<float*>(vs + ST * CB * BK * 64);   // [BQ] the rows' delta
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(dl_s + BQ);
  uint64_t* full = qd_full + 1;                         // [ST] K and V tiles landed
  uint64_t* empty = full + ST;                          // [ST] read by every consumer warp

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // the longest causal walks first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);                    // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: Q and dO once, then the live K/V tiles through the ring;
    // rows past S arrive as zeros (registers as in flash_wgmma_kernel)
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&tdo);
      mbar_expect_tx(qd_full, 2 * BQ * HD * 2);
      for (int cb = 0; cb < CB; ++cb) {
        tma_load_4d(qs + cb * BQ * 64, &tq, qd_full, 64 * cb, h, q0, b);
        tma_load_4d(dos + cb * BQ * 64, &tdo, qd_full, 64 * cb, h, q0, b);
      }
      const int hk = h / rep;
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % ST;
        mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * BK * HD * 2);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(ks + (s * CB + cb) * BK * 64, &tk, full + s, 64 * cb, hk, t * BK, b);
          tma_load_4d(vs + (s * CB + cb) * BK * 64, &tv, full + s, 64 * cb, hk, t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63, its warp w % 4 16 of them
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  if constexpr (NWG == 3) setmaxnreg_inc<160>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int r0 = q0 + 64 * wg;                          // the warpgroup's first row
  const int wr0 = r0 + 16 * (warp % 4);                 // the warp's first row
  const int row_lo = wr0 + lane / 4, row_hi = row_lo + 8;
  mbar_wait(qd_full, 0);
  // delta = rowsum(dO * O) of the warpgroup's 64 rows, fp32: two threads
  // per row, each over half of its 16-byte chunks (o from device memory, dO
  // from its swizzled tile: chunk c of row r at chunk c ^ (r % 8))
  {
    const int r = 64 * wg + tid / 2, row = q0 + r, c0 = (tid & 1) * (HD / 16);
    float sum = 0.f;
    if (row < Sq) {
      const bf16* orow = o + (((int64_t)b * Sq + row) * Hq + h) * HD;
#pragma unroll
      for (int c = c0; c < c0 + HD / 16; ++c)
        sum = dot8(*reinterpret_cast<const uint4*>(orow + 8 * c),
                   *reinterpret_cast<const uint4*>(dos + ((c / 8) * BQ + r) * 64 +
                                                   ((c % 8) ^ (r % 8)) * 8),
                   sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      dl_s[r] = sum;
      if (row < Sq) delta[((int64_t)b * Hq + h) * Sq + row] = sum;
    }
  }
  named_barrier_sync(1 + wg, 128);
  const float dl[2] = {dl_s[row_lo - q0], dl_s[row_hi - q0]};
  float l2[2];                                          // the rows' lse in log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    l2[i] = row < Sq ? lse[((int64_t)b * Hq + h) * Sq + row] * kLog2e : 0.f;
  }
  // keys that some row of the warpgroup may attend to
  int wk_end = Skv;
  if (causal) wk_end = min(wk_end, min(r0 + 64, Sq));
  const int wk_begin = window >= 0 ? max(0, r0 - window + 1) : 0;
  const bool rows_live = r0 < Sq;

  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128, do_addr = smem_u32(dos) + wg * 64 * 128;
  float acc[HD / 2];                                    // dQ, accumulator layout
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
  float sc[BK / 2], dp[BK / 2];                         // S; dP, then dS (fp32)
  uint32_t dh[BK / 16][4], dlo[BK / 16][4];             // dS as two bf16 A operands
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % ST, k0 = t * BK;
    mbar_wait(full + s, (i / ST) & 1);
    if (rows_live && k0 < wk_end && k0 + BK > wk_begin) {
      // S = Q K^T and dP = dO V^T (fp32), HD / 16 k-steps each
      const uint32_t k_addr = smem_u32(ks + s * CB * BK * 64);
      const uint32_t v_addr = smem_u32(vs + s * CB * BK * 64);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        wgmma_ss<BK>(sc, desc_sw128(q_addr + (kd / 4) * BQ * 128 + (kd % 4) * 32, 16, 1024),
                     desc_sw128(k_addr + (kd / 4) * BK * 128 + (kd % 4) * 32, 16, 1024), kd > 0);
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        wgmma_ss<BK>(dp, desc_sw128(do_addr + (kd / 4) * BQ * 128 + (kd % 4) * 32, 16, 1024),
                     desc_sw128(v_addr + (kd / 4) * BK * 128 + (kd % 4) * 32, 16, 1024), kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wr0) ||
                             (window >= 0 && k0 <= wr0 + 15 - window);
      if (need_mask)
        rows_ds<BK, true>(sc, dp, l2, dl, scale_log2, k0, row_lo, row_hi, lane, Skv, causal,
                          window);
      else
        rows_ds<BK, false>(sc, dp, l2, dl, scale_log2, k0, row_lo, row_hi, lane, Skv, causal,
                           window);
      split_p<BK>(dp, dh, dlo);

      // dQ += (dS_hi + dS_lo) K, K read transposed from its [key][d] tile
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dk = desc_sw128(k_addr + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs_t<HD>(acc, dh[kk], dk);
        wgmma_rs_t<HD>(acc, dlo[kk], dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(empty + s);             // the stage may be refilled
  }

  // epilogue: one cast, ragged rows unwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    bf16* drow = dq + (((int64_t)b * Sq + row) * Hq + h) * HD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(drow + 8 * j, acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// dK and dV of 64 NWG keys of one KV head, columns [d0, d0 + DN), summed
// over the rep query heads of that KV head: NWG consumer warpgroups of 64
// keys and the producer warp, which loads K and V once, then streams the
// items (query head, tile of BQ query rows) with their lse and delta through
// the ring. tk/tv map k and v in boxes of 64 columns x 64 NWG rows, tq/tdo
// q and dout in boxes of 64 columns x BQ rows. dk, dv contiguous (B, Skv,
// Hkv, HD); lse, delta (B, Hq, Sq).
template <int HD, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
flash_wgmma_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
                            int rep, float scale, float scale_log2, int causal, int window) {
  using namespace hopper;
  using C = WgBwdCfg<HD>;
  constexpr int BKV = 64 * NWG, BQ = C::BQ, CB = C::CB, ST = C::STAGES, DN = C::DN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ks = reinterpret_cast<bf16*>(base);            // [CB][BKV][64]
  bf16* vs = ks + CB * BKV * 64;                        // [CB][BKV][64]
  bf16* qs = vs + CB * BKV * 64;                        // [ST][CB][BQ][64]
  bf16* dos = qs + ST * CB * BQ * 64;                   // [ST][CB][BQ][64]
  float* ld = reinterpret_cast<float*>(dos + ST * CB * BQ * 64);   // [ST][lse, delta][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ld + ST * 2 * BQ);
  uint64_t* full = kv_full + 1;                         // [ST] the item landed
  uint64_t* empty = full + ST;                          // [ST] read by every consumer warp

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Hkv = Hq / rep;
  const int z = blockIdx.x % C::NZ, bh = blockIdx.x / C::NZ;   // column blocks side by side
  const int b = bh / Hkv, hk = bh % Hkv;
  const int k0 = blockIdx.y * BKV;                      // the longest causal walks first
  // query rows that may attend to a key of this block: [q_begin, q_end);
  // the items are (query head, query tile), heads outermost
  const int q_begin = causal ? k0 : 0;
  long long q_end = Sq;
  if (window >= 0) {
    const long long last = (long long)min(k0 + BKV, Skv) - 1 + window;
    q_end = last < q_end ? last : q_end;
  }
  const int qt_begin = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (int)((q_end + BQ - 1) / BQ) - qt_begin : 0;
  const int items = rep * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 32);                          // the producer warp's lanes
      mbar_init(empty + s, 4 * NWG);                    // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: K and V once, then each item's Q and dO tiles by TMA (rows
    // past Sq arrive as zeros) and its lse and delta, written by the warp's
    // lanes, into the ring (registers as in flash_wgmma_kernel)
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG) {
      if (lane == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        tma_prefetch(&tdo);
        mbar_expect_tx(kv_full, 2 * BKV * HD * 2);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(ks + cb * BKV * 64, &tk, kv_full, 64 * cb, hk, k0, b);
          tma_load_4d(vs + cb * BKV * 64, &tv, kv_full, 64 * cb, hk, k0, b);
        }
      }
      for (int it = 0; it < items; ++it) {
        const int s = it % ST, h = hk * rep + it / n_qt, i0 = (qt_begin + it % n_qt) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        float* l = ld + s * 2 * BQ;
        const int64_t rows = ((int64_t)b * Hq + h) * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = i0 + r < Sq;
          l[r] = ok ? lse[rows + i0 + r] * kLog2e : 1e30f;
          l[BQ + r] = ok ? delta[rows + i0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * BQ * HD * 2);
          for (int cb = 0; cb < CB; ++cb) {
            tma_load_4d(qs + (s * CB + cb) * BQ * 64, &tq, full + s, 64 * cb, h, i0, b);
            tma_load_4d(dos + (s * CB + cb) * BQ * 64, &tdo, full + s, 64 * cb, h, i0, b);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63, its warp w % 4 16 of them
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int key0 = k0 + 64 * wg;                        // the warpgroup's first key
  const int kw0 = key0 + 16 * (warp % 4);               // the warp's first key
  const int key_lo = kw0 + lane / 4, key_hi = key_lo + 8;
  const int last_key = min(key0 + 64, Skv) - 1;
  const int z0 = z * (DN / 64);                         // the block's first column block
  const uint32_t k_addr = smem_u32(ks) + wg * 64 * 128, v_addr = smem_u32(vs) + wg * 64 * 128;
  float adk[DN / 2], adv[DN / 2];                       // dK, dV, accumulator layout
#pragma unroll
  for (int j = 0; j < DN / 2; ++j) adk[j] = adv[j] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];                        // S^T, then P^T; dP^T, then dS^T
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
  mbar_wait(kv_full, 0);
  for (int it = 0; it < items; ++it) {
    const int s = it % ST, qb = (qt_begin + it % n_qt) * BQ;
    mbar_wait(full + s, (it / ST) & 1);
    // does some query of the item attend to some key of the warpgroup?
    if (key0 < Skv && (!causal || qb + BQ - 1 >= key0) &&
        (window < 0 || qb < last_key + window)) {
      // S^T = K Q^T and dP^T = V dO^T (fp32): rows the warpgroup's keys,
      // columns the item's queries, both operands K-major as stored
      const uint32_t q_addr = smem_u32(qs + s * CB * BQ * 64);
      const uint32_t do_addr = smem_u32(dos + s * CB * BQ * 64);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        wgmma_ss<BQ>(st, desc_sw128(k_addr + (kd / 4) * BKV * 128 + (kd % 4) * 32, 16, 1024),
                     desc_sw128(q_addr + (kd / 4) * BQ * 128 + (kd % 4) * 32, 16, 1024), kd > 0);
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        wgmma_ss<BQ>(dpt, desc_sw128(v_addr + (kd / 4) * BKV * 128 + (kd % 4) * 32, 16, 1024),
                     desc_sw128(do_addr + (kd / 4) * BQ * 128 + (kd % 4) * 32, 16, 1024),
                     kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const float* l = ld + s * 2 * BQ;
      const bool need_mask = (causal && kw0 + 15 > qb) || (window >= 0 && qb + BQ - 1 - window >= kw0);
      if (need_mask)
        keys_p_ds<BQ, true>(st, dpt, l, scale_log2, qb, key_lo, key_hi, lane, causal, window);
      else
        keys_p_ds<BQ, false>(st, dpt, l, scale_log2, qb, key_lo, key_hi, lane, causal, window);
      split_p<BQ>(st, ph, pl);

      // dV += (P^T_hi + P^T_lo) dO, then dK += (dS^T_hi + dS^T_lo) Q over
      // the item's queries, 16 per k-step, dO and Q read transposed (columns
      // [d0, d0 + DN): column blocks z0 ..); dS^T is split while dV's
      // products run, and only P^T's terms are split before them, which
      // keeps two consumer warpgroups at hd 128 within 240 registers
      fence_regs(adk);
      fence_regs(adv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t ddo = desc_sw128(do_addr + z0 * BQ * 128 + kk * 16 * 128, BQ * 128, 1024);
        wgmma_rs_t<DN>(adv, ph[kk], ddo);
        wgmma_rs_t<DN>(adv, pl[kk], ddo);
      }
      wgmma_commit();
      split_p<BQ>(dpt, sh, sl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t dqd = desc_sw128(q_addr + z0 * BQ * 128 + kk * 16 * 128, BQ * 128, 1024);
        wgmma_rs_t<DN>(adk, sh[kk], dqd);
        wgmma_rs_t<DN>(adk, sl[kk], dqd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adk);
      fence_regs(adv);
    }
    if (lane == 0) mbar_arrive(empty + s);             // the stage may be refilled
  }

  // epilogue: one cast each, keys past Skv unwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key_lo : key_hi;
    if (key >= Skv) continue;
    const int64_t off = (((int64_t)b * Skv + key) * Hkv + hk) * HD + 64 * z0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      store2(dk + off + 8 * j, adk[4 * j + 2 * r] * scale, adk[4 * j + 2 * r + 1] * scale);
      store2(dv + off + 8 * j, adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 backward at hd 64, 128 and 256: flash_wgmma_tf32_bwd_prep_kernel, then
// flash_wgmma_tf32_bwd_dq_kernel and flash_wgmma_tf32_bwd_dkdv_kernel, TF32
// wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kPrepRows = 32;                          // rows per pre-pass block
constexpr int kPrepThreads = 256;
constexpr uint32_t kPiece = 32768;                     // bytes of one ring slot

// Position p of a group of 8 in a transposed copy holds row perm8(p) of the
// group: the accumulator's columns 2t and 2t + 1 are the TF32 A fragment's
// k-indices t and t + 4 (acc_to_a), so the B operand's k-entries follow them.
__device__ __forceinline__ int perm8(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

__host__ __device__ constexpr int round8(int s) { return (s + 7) & ~7; }

// The pre-pass's copies of the operands that the TF32 products read from
// shared memory, each x as hi = tf32(x) then lo = tf32(x - hi): natural
// (2, B, S, H, hd) copies of q, k, v and dout, and transposed (2, B, H, hd,
// S8) copies of q, k and dout (S8 = S rounded up to 8; zero past S; rows
// permuted in groups of 8 by perm8).
struct Tf32Scratch {
  float *qn, *kn, *vn, *don, *qt, *kt, *dot;
};

Tf32Scratch carve(float* p, int B, int Sq, int Skv, int Hq, int Hkv, int hd) {
  const int64_t nq = 2LL * B * Sq * Hq * hd, nk = 2LL * B * Skv * Hkv * hd;
  const int64_t tq = 2LL * B * Hq * hd * round8(Sq), tk = 2LL * B * Hkv * hd * round8(Skv);
  Tf32Scratch s;
  s.qn = p;
  s.kn = s.qn + nq;
  s.vn = s.kn + nk;
  s.don = s.vn + nk;
  s.qt = s.don + nq;
  s.kt = s.qt + tq;
  s.dot = s.kt + tk;
  return s;
}

int64_t scratch_floats(int B, int Sq, int Skv, int Hq, int Hkv, int hd) {
  return 2LL * hd * (2LL * B * Sq * Hq + 2LL * B * Skv * Hkv + 2LL * B * Hq * round8(Sq) +
                     (int64_t)B * Hkv * round8(Skv));
}

// One block per 32 rows of one head of one operand (blockIdx.z: 0 q, 1 k,
// 2 v, 3 dout): the split natural copy, the split transposed copy (not of
// v), and for dout delta = rowsum(dout o) (fp32, lanes over the head dim,
// then a butterfly). o and dout contiguous (B, Sq, Hq, HD); delta (B, Hq, Sq).
template <int HD>
__global__ void __launch_bounds__(kPrepThreads)
flash_wgmma_tf32_bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ o,
                                 const float* __restrict__ dout, Tf32Scratch sc,
                                 float* __restrict__ delta, int Sq, int Skv, int Hq, int Hkv,
                                 int64_t qsb, int64_t qss, int64_t ksb, int64_t kss, int64_t vsb,
                                 int64_t vss) {
  constexpr int R = kPrepRows, P = HD + 1;               // odd pitch: column reads on 32 banks
  __shared__ float tile[R * P];
  const int job = blockIdx.z;
  const bool kv = job == 1 || job == 2;
  const int S = kv ? Skv : Sq, H = kv ? Hkv : Hq, B = gridDim.y / Hq;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, r0 = blockIdx.x * R;
  if (h >= H || r0 >= S) return;
  const float* src;
  int64_t rs;
  float *nat, *tr;
  if (job == 0) {
    src = q + b * qsb + (int64_t)h * HD, rs = qss, nat = sc.qn, tr = sc.qt;
  } else if (job == 1) {
    src = k + b * ksb + (int64_t)h * HD, rs = kss, nat = sc.kn, tr = sc.kt;
  } else if (job == 2) {
    src = v + b * vsb + (int64_t)h * HD, rs = vss, nat = sc.vn, tr = nullptr;
  } else {
    src = dout + ((int64_t)b * Sq * Hq + h) * HD, rs = (int64_t)Hq * HD, nat = sc.don,
    tr = sc.dot;
  }
  const int64_t nat_lo = (int64_t)B * S * H * HD;        // floats from a hi to its lo
  for (int i = threadIdx.x; i < R * HD / 4; i += kPrepThreads) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = *reinterpret_cast<const float4*>(src + (r0 + r) * rs + c);
    float* t = tile + r * P + c;
    t[0] = x.x, t[1] = x.y, t[2] = x.z, t[3] = x.w;
    if (r0 + r < S) {
      uint32_t hi[4], lo[4];
      split_tf32(x.x, hi[0], lo[0]);
      split_tf32(x.y, hi[1], lo[1]);
      split_tf32(x.z, hi[2], lo[2]);
      split_tf32(x.w, hi[3], lo[3]);
      float* dst = nat + (((int64_t)b * S + r0 + r) * H + h) * HD + c;
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + nat_lo) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (tr != nullptr) {
    // lane p of a warp writes position r0 + p of head-dim rows warp, warp + 8, ...
    const int S8 = round8(S), pos = r0 + lane, r = (lane & ~7) + perm8(lane & 7);
    const int64_t tr_lo = (int64_t)B * H * HD * S8;
    if (pos < S8) {
      float* dst = tr + ((int64_t)b * H + h) * HD * S8 + pos;
      for (int d = warp; d < HD; d += kPrepThreads / 32) {
        uint32_t hi, lo;
        split_tf32(tile[r * P + d], hi, lo);
        dst[(int64_t)d * S8] = __uint_as_float(hi);
        dst[(int64_t)d * S8 + tr_lo] = __uint_as_float(lo);
      }
    }
  }
  if (job == 3) {
    for (int r = warp; r < R && r0 + r < Sq; r += kPrepThreads / 32) {
      const float* orow = o + (((int64_t)b * Sq + r0 + r) * Hq + h) * HD;
      float sum = 0.f;
      for (int d = lane; d < HD; d += 32) sum = fmaf(orow[d], tile[r * P + d], sum);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) delta[((int64_t)b * Hq + h) * Sq + r0 + r] = sum;
    }
  }
}

template <int HD>
struct Tf32WgCfg {
  static constexpr int CB = HD / 32;                     // 128-byte column blocks of a row
  // dQ: keys per K/V tile; head-dim columns of a (K, V) piece (K and V, hi
  // and lo, of the tile's keys) and such pieces per tile; the K^T pieces
  // (hi and lo of KT_KEYS keys, or at hd 256 hi or lo of 32 keys) per tile
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int AC = 2048 / BK;
  static constexpr int NA = HD / AC;
  static constexpr bool KT_SPLIT = HD == 256;
  static constexpr int KT_KEYS = KT_SPLIT ? 32 : 4096 / HD;
  static constexpr int NKT = KT_SPLIT ? 2 : BK / KT_KEYS;
  // dK/dV: query rows per item; head-dim columns of a (Q, dO) piece and such
  // pieces per item; dK/dV columns per block (two column blocks at hd 256)
  static constexpr int BQ = HD <= 64 ? 64 : 32;
  static constexpr int QC = 2048 / BQ;
  static constexpr int NQA = HD / QC;
  static constexpr int DN = HD <= 128 ? HD : 128;
  static constexpr int NZ = HD / DN;
  static_assert(8 * BQ * DN == kPiece, "a dO^T or Q^T piece: hi and lo of DN rows x BQ queries");
  // consumer warpgroups a block may have, both kernels
  static constexpr int MAX_NWG = HD <= 128 ? 2 : 1;
  // shared memory: the resident raw tiles (q and dout, or k and v, of 64 nwg
  // rows), as many ring slots as fit, the dK/dV kernel's lse/delta ring,
  // the barriers and slack to align the tiles to 1024 bytes
  __host__ __device__ static constexpr size_t resident(int nwg) {
    return (size_t)2 * 64 * nwg * HD * 4;
  }
  __host__ __device__ static constexpr int slots(int nwg) {
    return (int)((kSmemMax - 3072 - resident(nwg)) / kPiece);
  }
  static constexpr size_t smem(int nwg) {
    return 1024 + resident(nwg) + (size_t)slots(nwg) * kPiece + 2 * 2 * BQ * 4 +
           8 * (6 + 2 * slots(nwg));
  }
};

// The TF32 A fragment (hi and lo) of k-step kk (columns 8 kk .. 8 kk + 7) at
// rows row and row + 8 (row % 16 = lane / 4) of a raw fp32 tile of R rows as
// TMA writes it with the 128-byte swizzle ([column block][R][32], the
// 16-byte chunk c of row r at chunk c ^ (r % 8)): the 8 rows of a load hit 8
// distinct chunks, so the warp's 32 words fall on 32 banks.
template <int R>
__device__ __forceinline__ void load_a_sw(Frag<4>& f, const float* tile, int row, int kk, int t) {
  const float* blk = tile + (kk / 4) * R * 32 + row * 32;
  const int c0 = ((2 * (kk % 4)) ^ (row & 7)) * 4 + t;
  const int c1 = ((2 * (kk % 4) + 1) ^ (row & 7)) * 4 + t;
  split_tf32(blk[c0], f.hi[0], f.lo[0]);
  split_tf32(blk[8 * 32 + c0], f.hi[1], f.lo[1]);
  split_tf32(blk[c1], f.hi[2], f.lo[2]);
  split_tf32(blk[8 * 32 + c1], f.hi[3], f.lo[3]);
}

// acc_to_a on n-tile j of an accumulator in wgmma's layout
template <int R>
__device__ __forceinline__ void acc_to_a_at(Frag<4>& f, const float (&c)[R], int j) {
  split_tf32(c[4 * j], f.hi[0], f.lo[0]);
  split_tf32(c[4 * j + 2], f.hi[1], f.lo[1]);
  split_tf32(c[4 * j + 1], f.hi[2], f.lo[2]);
  split_tf32(c[4 * j + 3], f.hi[3], f.lo[3]);
}

// d (+)= A B in split TF32 by three wgmma: lo_a hi_b, hi_a lo_b, hi_a hi_b;
// bh and bl address B's hi and lo tiles (K-major, 128-byte swizzle)
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const Frag<4>& a, uint32_t bh,
                                       uint32_t bl, int accumulate) {
  using namespace hopper;
  wgmma_rs_tf32<N>(d, a.lo, desc_sw128(bh, 16, 1024), accumulate);
  wgmma_rs_tf32<N>(d, a.hi, desc_sw128(bl, 16, 1024), 1);
  wgmma_rs_tf32<N>(d, a.hi, desc_sw128(bh, 16, 1024), 1);
}

// dQ of 64 NWG query rows of one head: NWG consumer warpgroups of 64 rows
// and the producer. tq and tdo map q and dout as they are ((hd, H, S, B)
// views, boxes of 32 columns x 64 NWG rows), tkn and tvn the split natural
// copies of k and v ((hd, H, S, B, 2), boxes of 32 x BK), tkt the split
// transposed copy of k ((S8, hd, H, B, 2), boxes of 32 keys x HD). lse,
// delta (B, Hq, Sq); dq contiguous (B, Sq, Hq, HD).
template <int HD, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
flash_wgmma_tf32_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tkn,
                               const __grid_constant__ CUtensorMap tvn,
                               const __grid_constant__ CUtensorMap tkt,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dq, int Sq, int Skv, int Hq, int rep,
                               float scale, float scale_log2, int causal, int window) {
  using namespace hopper;
  using C = Tf32WgCfg<HD>;
  constexpr int BQ = 64 * NWG, BK = C::BK, CB = C::CB, NS = C::slots(NWG);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* qs = reinterpret_cast<float*>(base);           // [CB][BQ][32] q as it is
  float* dos = qs + CB * BQ * 32;                       // [CB][BQ][32] dout
  unsigned char* ring = reinterpret_cast<unsigned char*>(dos + CB * BQ * 32);   // [NS] pieces
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(ring + NS * kPiece);
  uint64_t* full = qd_full + 1;                         // [NS] a piece landed
  uint64_t* empty = full + NS;                          // [NS] read by every consumer warp

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // the longest causal walks first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: q and dout once, then per live K/V tile its NA (K, V) pieces
    // and NKT K^T pieces through the ring; rows past S arrive as zeros
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      tma_prefetch(&tkn);
      tma_prefetch(&tvn);
      tma_prefetch(&tkt);
      mbar_expect_tx(qd_full, 2 * BQ * HD * 4);
      for (int cb = 0; cb < CB; ++cb) {
        tma_load_4d(qs + cb * BQ * 32, &tq, qd_full, 32 * cb, h, q0, b);
        tma_load_4d(dos + cb * BQ * 32, &tdo, qd_full, 32 * cb, h, q0, b);
      }
      const int hk = h / rep;
      int n = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int p = 0; p < C::NA + C::NKT; ++p, ++n) {
          const int s = n % NS;
          mbar_wait(empty + s, ((n / NS) & 1) ^ 1);
          mbar_expect_tx(full + s, kPiece);
          float* dst = reinterpret_cast<float*>(ring + s * kPiece);
          if (p < C::NA) {                              // [AC / 32][K hi, lo, V hi, lo][BK][32]
            for (int cb = 0; cb < C::AC / 32; ++cb)
              for (int a = 0; a < 4; ++a)
                tma_load_5d(dst + (cb * 4 + a) * BK * 32, a < 2 ? &tkn : &tvn, full + s,
                            C::AC * p + 32 * cb, hk, t * BK, b, a & 1);
          } else if (C::KT_SPLIT) {                     // [HD][32]: hi, then lo
            tma_load_5d(dst, &tkt, full + s, t * BK, 0, hk, b, p - C::NA);
          } else {                                      // [KT_KEYS / 32][hi, lo][HD][32]
            for (int kc = 0; kc < C::KT_KEYS / 32; ++kc)
              for (int a = 0; a < 2; ++a)
                tma_load_5d(dst + (kc * 2 + a) * HD * 32, &tkt, full + s,
                            t * BK + (p - C::NA) * C::KT_KEYS + 32 * kc, 0, hk, b, a);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63, its warp w % 4 16 of them
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int wg = warp / 4, t4 = lane % 4;
  const int r0 = q0 + 64 * wg, wr0 = r0 + 16 * (warp % 4);
  const int row_lo = wr0 + lane / 4, row_hi = row_lo + 8;
  const int arow = row_lo - q0;                         // the fragments' first row in qs, dos
  float l2[2], dl[2];                                   // the rows' lse (log2 units) and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_lo : row_hi;
    const int64_t at = ((int64_t)b * Hq + h) * Sq + row;
    l2[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    dl[i] = row < Sq ? delta[at] : 0.f;
  }
  int wk_end = Skv;
  if (causal) wk_end = min(wk_end, min(r0 + 64, Sq));
  const int wk_begin = window >= 0 ? max(0, r0 - window + 1) : 0;
  const bool rows_live = r0 < Sq;

  float acc[HD / 2];                                    // dQ, accumulator layout
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
  float sc[BK / 2], dp[BK / 2];                         // S; dP, then dS
  mbar_wait(qd_full, 0);
  int n = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const bool live = rows_live && k0 < wk_end && k0 + BK > wk_begin;
    // S = Q K^T and dP = dO V^T, Q and dO split in registers per k-step
#pragma unroll
    for (int p = 0; p < C::NA; ++p, ++n) {
      const int s = n % NS;
      mbar_wait(full + s, (n / NS) & 1);
      if (live) {
        const uint32_t pa = smem_u32(ring + s * kPiece);
        fence_regs(sc);
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < C::AC / 8; ++j) {
          const int kk = C::AC / 8 * p + j;             // the k-step over the head dim
          Frag<4> fq, fd;
          load_a_sw<BQ>(fq, qs, arow, kk, t4);
          load_a_sw<BQ>(fd, dos, arow, kk, t4);
          const uint32_t bk = pa + (j / 4) * 4 * BK * 128 + (j % 4) * 32;
          wgmma_fence();
          wgmma3<BK>(sc, fq, bk, bk + BK * 128, p + j > 0);
          wgmma3<BK>(dp, fd, bk + 2 * BK * 128, bk + 3 * BK * 128, p + j > 0);
          wgmma_commit();
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
      }
      if (lane == 0) mbar_arrive(empty + s);           // the slot may be refilled
    }
    if (live) {
      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wr0) ||
                             (window >= 0 && k0 <= wr0 + 15 - window);
      if (need_mask)
        rows_ds<BK, true>(sc, dp, l2, dl, scale_log2, k0, row_lo, row_hi, lane, Skv, causal,
                          window);
      else
        rows_ds<BK, false>(sc, dp, l2, dl, scale_log2, k0, row_lo, row_hi, lane, Skv, causal,
                           window);
    }
    // dQ += dS K: dS split in registers per k-step of 8 keys, K^T from the ring
#pragma unroll
    for (int p = 0; p < C::NKT; ++p, ++n) {
      const int s = n % NS;
      mbar_wait(full + s, (n / NS) & 1);
      if (live) {
        const uint32_t pb = smem_u32(ring + s * kPiece);
        fence_regs(acc);
        if constexpr (C::KT_SPLIT) {
          // piece 0 holds K^T's hi (products lo_dS hi_K, hi_dS hi_K), piece 1 its lo
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            Frag<4> a;
            acc_to_a_at(a, dp, j);
            const uint64_t db = desc_sw128(pb + j * 32, 16, 1024);
            wgmma_fence();
            if (p == 0) {
              wgmma_rs_tf32<HD>(acc, a.lo, db, 1);
              wgmma_rs_tf32<HD>(acc, a.hi, db, 1);
            } else {
              wgmma_rs_tf32<HD>(acc, a.hi, db, 1);
            }
            wgmma_commit();
            wgmma_wait<1>();
          }
        } else {
#pragma unroll
          for (int kc = 0; kc < C::KT_KEYS / 32; ++kc)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              Frag<4> a;
              acc_to_a_at(a, dp, (p * C::KT_KEYS + 32 * kc) / 8 + j);
              const uint32_t bh = pb + kc * 2 * HD * 128 + j * 32;
              wgmma_fence();
              wgmma3<HD>(acc, a, bh, bh + HD * 128, 1);
              wgmma_commit();
              wgmma_wait<1>();
            }
        }
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (lane == 0) mbar_arrive(empty + s);
    }
  }

  // epilogue: ragged rows unwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    float* drow = dq + (((int64_t)b * Sq + row) * Hq + h) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(drow + 8 * j, acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// dK and dV of 64 NWG keys of one KV head, columns [d0, d0 + DN), summed
// over the rep query heads of that KV head: NWG consumer warpgroups of 64
// keys and the producer warp, which loads k and v once, then streams each
// item (query head, tile of BQ query rows) as NQA (Q, dO) pieces and a dO^T
// and a Q^T piece through the ring, and its lse and delta through a
// two-item ring of its own. tk and tv map k and v as they are (boxes of 32
// columns x 64 NWG rows), tqn and tdon the split natural copies of q and
// dout (boxes of 32 x BQ), tqt and tdot their split transposed copies
// (boxes of 32 queries x DN). dk, dv contiguous (B, Skv, Hkv, HD); lse,
// delta (B, Hq, Sq).
template <int HD, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
flash_wgmma_tf32_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tqn,
                                 const __grid_constant__ CUtensorMap tdon,
                                 const __grid_constant__ CUtensorMap tqt,
                                 const __grid_constant__ CUtensorMap tdot,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                                 int Hq, int rep, float scale, float scale_log2, int causal,
                                 int window) {
  using namespace hopper;
  using C = Tf32WgCfg<HD>;
  constexpr int BKV = 64 * NWG, BQ = C::BQ, CB = C::CB, NS = C::slots(NWG), DN = C::DN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* ks = reinterpret_cast<float*>(base);           // [CB][BKV][32] k as it is
  float* vs = ks + CB * BKV * 32;                       // [CB][BKV][32] v
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + CB * BKV * 32);   // [NS] pieces
  float* ld = reinterpret_cast<float*>(ring + NS * kPiece);   // [2][lse, delta][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ld + 2 * 2 * BQ);
  uint64_t* full = kv_full + 1;                         // [NS] a piece landed
  uint64_t* empty = full + NS;                          // [NS] read by every consumer warp
  uint64_t* ld_full = empty + NS;                       // [2] an item's lse and delta written
  uint64_t* ld_empty = ld_full + 2;                     // [2] read by every consumer warp

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Hkv = Hq / rep;
  const int z = blockIdx.x % C::NZ, bh = blockIdx.x / C::NZ;   // column blocks side by side
  const int b = bh / Hkv, hk = bh % Hkv;
  const int k0 = blockIdx.y * BKV;                      // the longest causal walks first
  const int d0 = z * DN;
  // query rows that may attend to a key of this block: [q_begin, q_end);
  // the items are (query head, query tile), heads outermost
  const int q_begin = causal ? k0 : 0;
  long long q_end = Sq;
  if (window >= 0) {
    const long long last = (long long)min(k0 + BKV, Skv) - 1 + window;
    q_end = last < q_end ? last : q_end;
  }
  const int qt_begin = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (int)((q_end + BQ - 1) / BQ) - qt_begin : 0;
  const int items = rep * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(ld_full + s, 32);                       // the producer warp's lanes
      mbar_init(ld_empty + s, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: k and v once; per item its lse (log2 units, 1e30 past Sq,
    // so P is 0 there with no mask) and delta by the warp's lanes, and its
    // pieces by lane 0; rows past S arrive as zeros
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG) {
      if (lane == 0) {
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        tma_prefetch(&tqn);
        tma_prefetch(&tdon);
        tma_prefetch(&tqt);
        tma_prefetch(&tdot);
        mbar_expect_tx(kv_full, 2 * BKV * HD * 4);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(ks + cb * BKV * 32, &tk, kv_full, 32 * cb, hk, k0, b);
          tma_load_4d(vs + cb * BKV * 32, &tv, kv_full, 32 * cb, hk, k0, b);
        }
      }
      int n = 0;
      for (int it = 0; it < items; ++it) {
        const int h = hk * rep + it / n_qt, i0 = (qt_begin + it % n_qt) * BQ, si = it & 1;
        mbar_wait(ld_empty + si, ((it >> 1) & 1) ^ 1);
        float* l = ld + si * 2 * BQ;
        const int64_t rows = ((int64_t)b * Hq + h) * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = i0 + r < Sq;
          l[r] = ok ? lse[rows + i0 + r] * kLog2e : 1e30f;
          l[BQ + r] = ok ? delta[rows + i0 + r] : 0.f;
        }
        mbar_arrive(ld_full + si);
        if (lane != 0) continue;
        for (int p = 0; p < C::NQA + 2; ++p, ++n) {
          const int s = n % NS;
          mbar_wait(empty + s, ((n / NS) & 1) ^ 1);
          mbar_expect_tx(full + s, kPiece);
          float* dst = reinterpret_cast<float*>(ring + s * kPiece);
          if (p < C::NQA) {                             // [QC / 32][Q hi, lo, dO hi, lo][BQ][32]
            for (int cb = 0; cb < C::QC / 32; ++cb)
              for (int a = 0; a < 4; ++a)
                tma_load_5d(dst + (cb * 4 + a) * BQ * 32, a < 2 ? &tqn : &tdon, full + s,
                            C::QC * p + 32 * cb, h, i0, b, a & 1);
          } else {                                      // [BQ / 32][hi, lo][DN][32]: dO^T, then Q^T
            for (int qc = 0; qc < BQ / 32; ++qc)
              for (int a = 0; a < 2; ++a)
                tma_load_5d(dst + (qc * 2 + a) * DN * 32, p == C::NQA ? &tdot : &tqt, full + s,
                            i0 + 32 * qc, d0, h, b, a);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63, its warp w % 4 16 of them
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int wg = warp / 4, t4 = lane % 4;
  const int key0 = k0 + 64 * wg;                        // the warpgroup's first key
  const int kw0 = key0 + 16 * (warp % 4);               // the warp's first key
  const int key_lo = kw0 + lane / 4, key_hi = key_lo + 8;
  const int arow = key_lo - k0;                         // the fragments' first row in ks, vs
  const int last_key = min(key0 + 64, Skv) - 1;
  float adk[DN / 2], adv[DN / 2];                       // dK, dV, accumulator layout
#pragma unroll
  for (int j = 0; j < DN / 2; ++j) adk[j] = adv[j] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];                        // S^T, then P^T; dP^T, then dS^T
  mbar_wait(kv_full, 0);
  int n = 0;
  for (int it = 0; it < items; ++it) {
    const int qb = (qt_begin + it % n_qt) * BQ, si = it & 1;
    // does some query of the item attend to some key of the warpgroup?
    const bool live = key0 < Skv && (!causal || qb + BQ - 1 >= key0) &&
                      (window < 0 || qb < last_key + window);
    // S^T = K Q^T and dP^T = V dO^T, K and V split in registers per k-step
#pragma unroll
    for (int p = 0; p < C::NQA; ++p, ++n) {
      const int s = n % NS;
      mbar_wait(full + s, (n / NS) & 1);
      if (live) {
        const uint32_t pa = smem_u32(ring + s * kPiece);
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < C::QC / 8; ++j) {
          const int kk = C::QC / 8 * p + j;             // the k-step over the head dim
          Frag<4> fk, fv;
          load_a_sw<BKV>(fk, ks, arow, kk, t4);
          load_a_sw<BKV>(fv, vs, arow, kk, t4);
          const uint32_t bq = pa + (j / 4) * 4 * BQ * 128 + (j % 4) * 32;
          wgmma_fence();
          wgmma3<BQ>(st, fk, bq, bq + BQ * 128, p + j > 0);
          wgmma3<BQ>(dpt, fv, bq + 2 * BQ * 128, bq + 3 * BQ * 128, p + j > 0);
          wgmma_commit();
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
      }
      if (lane == 0) mbar_arrive(empty + s);
    }
    mbar_wait(ld_full + si, (it >> 1) & 1);
    if (live) {
      const float* l = ld + si * 2 * BQ;
      const bool need_mask =
          (causal && kw0 + 15 > qb) || (window >= 0 && qb + BQ - 1 - window >= kw0);
      if (need_mask)
        keys_p_ds<BQ, true>(st, dpt, l, scale_log2, qb, key_lo, key_hi, lane, causal, window);
      else
        keys_p_ds<BQ, false>(st, dpt, l, scale_log2, qb, key_lo, key_hi, lane, causal, window);
    }
    if (lane == 0) mbar_arrive(ld_empty + si);
    // dV += P^T dO, then dK += dS^T Q, over the item's queries: each 64
    // columns' sum over the item taken in a zeroed accumulator and added to
    // dV or dK in IEEE fp32 (the tensor cores' accumulation rounds toward
    // zero, a bias that grows along rep x Sq-long sums)
#pragma unroll
    for (int p = 0; p < 2; ++p, ++n) {
      const int s = n % NS;
      mbar_wait(full + s, (n / NS) & 1);
      if (live) {
        const uint32_t pb = smem_u32(ring + s * kPiece);
#pragma unroll
        for (int c = 0; c < DN / 64; ++c) {
          float part[32];
          fence_regs(part);
#pragma unroll
          for (int js = 0; js < BQ / 8; ++js) {
            Frag<4> a;
            acc_to_a_at(a, p == 0 ? st : dpt, js);
            const uint32_t bh = pb + (js / 4) * 2 * DN * 128 + c * 64 * 128 + (js % 4) * 32;
            wgmma_fence();
            wgmma3<64>(part, a, bh, bh + DN * 128, js > 0);
            wgmma_commit();
            wgmma_wait<1>();
          }
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if (p == 0)
              adv[32 * c + i] += part[i];
            else
              adk[32 * c + i] += part[i];
          }
        }
      }
      if (lane == 0) mbar_arrive(empty + s);
    }
  }

  // epilogue: keys past Skv unwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key_lo : key_hi;
    if (key >= Skv) continue;
    const int64_t off = (((int64_t)b * Skv + key) * Hkv + hk) * HD + d0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      store2(dk + off + 8 * j, adk[4 * j + 2 * r] * scale, adk[4 * j + 2 * r + 1] * scale);
      store2(dv + off + 8 * j, adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 forward at hd 64, 128 and 256: flash_wgmma_tf32_fwd_prep_kernel, then
// flash_wgmma_tf32_kernel, TF32 wgmma fed by TMA
// ---------------------------------------------------------------------------

// The forward pre-pass's copies, in scratch the wrapper allocates: k's split
// natural copy (2, B, Skv, Hkv, hd) (hi, lo) and v's split transposed copy
// (3, B, Hkv, hd, S8) (hi, mid, lo: hi + mid + lo = v exactly; keys permuted
// in groups of 8 by perm8; zero past Skv).
int64_t fwd_scratch_floats(int B, int Skv, int Hkv, int hd) {
  return (int64_t)hd * B * Hkv * (2LL * Skv + 3LL * round8(Skv));
}

// One block per 32 keys of one KV head of k (blockIdx.z 0) or v (1).
template <int HD>
__global__ void __launch_bounds__(kPrepThreads)
flash_wgmma_tf32_fwd_prep_kernel(const float* __restrict__ k, const float* __restrict__ v,
                                 float* __restrict__ kn, float* __restrict__ vt, int Skv,
                                 int Hkv, int64_t ksb, int64_t kss, int64_t vsb, int64_t vss) {
  constexpr int R = kPrepRows, P = HD + 1;               // odd pitch: column reads on 32 banks
  __shared__ float tile[R * P];
  const int B = gridDim.y / Hkv, b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int r0 = blockIdx.x * R;
  if (blockIdx.z == 0) {
    const float* src = k + b * ksb + (int64_t)h * HD;
    const int64_t lo_at = (int64_t)B * Skv * Hkv * HD;  // floats from a hi to its lo
    for (int i = threadIdx.x; i < R * HD / 4; i += kPrepThreads) {
      const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
      if (r0 + r >= Skv) break;
      const float4 x = *reinterpret_cast<const float4*>(src + (r0 + r) * kss + c);
      uint32_t hi[4], lo[4];
      split_tf32(x.x, hi[0], lo[0]);
      split_tf32(x.y, hi[1], lo[1]);
      split_tf32(x.z, hi[2], lo[2]);
      split_tf32(x.w, hi[3], lo[3]);
      float* dst = kn + (((int64_t)b * Skv + r0 + r) * Hkv + h) * HD + c;
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + lo_at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    return;
  }
  const float* src = v + b * vsb + (int64_t)h * HD;
  for (int i = threadIdx.x; i < R * HD / 4; i += kPrepThreads) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Skv) x = *reinterpret_cast<const float4*>(src + (r0 + r) * vss + c);
    float* t = tile + r * P + c;
    t[0] = x.x, t[1] = x.y, t[2] = x.z, t[3] = x.w;
  }
  __syncthreads();
  // lane p of a warp writes position r0 + p of head-dim rows warp, warp + 8, ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S8 = round8(Skv), pos = r0 + lane, r = (lane & ~7) + perm8(lane & 7);
  const int64_t term = (int64_t)B * Hkv * HD * S8;       // floats from one term to the next
  if (pos >= S8) return;
  float* dst = vt + ((int64_t)b * Hkv + h) * HD * S8 + pos;
  for (int d = warp; d < HD; d += kPrepThreads / 32) {
    uint32_t hi, mid, lo;
    split3_tf32(tile[r * P + d], hi, mid, lo);
    dst[(int64_t)d * S8] = __uint_as_float(hi);
    dst[(int64_t)d * S8 + term] = __uint_as_float(mid);
    dst[(int64_t)d * S8 + 2 * term] = __uint_as_float(lo);
  }
}

template <int HD>
struct Tf32FwdCfg {
  static constexpr int CB = HD / 32;                     // 128-byte column blocks of a q row
  // keys per K/V tile: one term of V^T over the tile's keys (HD rows x BK
  // keys) is one piece, and K's two terms over the tile two pieces of KC
  // head-dim columns each; per tile the pieces K (columns 0 .. KC - 1),
  // K (KC .. HD - 1), V^T lo, V^T mid, V^T hi
  static constexpr int BK = (int)(kPiece / 4) / HD;
  static constexpr int KC = HD / 2;
  static constexpr int PIECES = 5;
  static_assert(8 * BK * KC == kPiece && 4 * BK * HD == kPiece, "pieces of 32 KB");
  // consumer warpgroups a block may have, by the grid rule (64 x HD fp32
  // of O a warpgroup in 240 registers a thread)
  static constexpr int MAX_NWG = 2;
  // a tile's P V products go into a zeroed accumulator that is added to O
  // in IEEE fp32 (up to hd 128, where the registers allow it); else into O
  static constexpr bool TILE_SUM = HD <= 128;
  // shared memory: q of the block's rows, as many ring slots as fit, the
  // barriers, and slack to align the tiles to 1024 bytes
  __host__ __device__ static constexpr size_t resident(int nwg) {
    return (size_t)64 * nwg * HD * 4;
  }
  __host__ __device__ static constexpr int slots(int nwg) {
    return (int)((kSmemMax - 3072 - resident(nwg)) / kPiece);
  }
  static constexpr size_t smem(int nwg) {
    return 1024 + resident(nwg) + (size_t)slots(nwg) * kPiece + 8 * (1 + 2 * slots(nwg));
  }
};

// The online softmax of a warp's 16 rows over a tile in the accumulator
// layout (RowMask's) for a scale of either sign, as flash_tf32_kernel takes
// it: each score is scaled (by scale log2 e) before the row maximum, masked
// scores are -1e30 and their p is 0. Turns sc into P, updates m (log2
// units) and this lane's part of l, gives O's rescale factor.
template <int BK, bool MASKED>
__device__ __forceinline__ void softmax_scaled(const RowMask& mk, float (&sc)[BK / 2], int k0,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * mk.scale_log2;
      if (MASKED && !mk.keep(k0, j, e)) x = kNegInf;
      sc[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * j + e];
      const float p = MASKED && x == kNegInf ? 0.f : exp2_ftz(x - m[e / 2]);
      sc[4 * j + e] = p;
      rs[e / 2] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// O (+)= P V over one piece of V^T (BK keys x HD, one TF32 term): P split
// in registers per k-step of 8 keys; the hi term's piece (`hi`) takes lo_P
// hi_V and hi_P hi_V, the others hi_P times their term; `zero` (a lo or mid
// piece only): the first product overwrites d
template <int HD, int BK>
__device__ __forceinline__ void pv_piece(float (&d)[HD / 2], const float (&p)[BK / 2],
                                         uint32_t pb, bool hi, bool zero) {
  using namespace hopper;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    Frag<4> a;
    acc_to_a_at(a, p, j);
    const uint64_t db = desc_sw128(pb + (j / 4) * HD * 128 + (j % 4) * 32, 16, 1024);
    wgmma_fence();
    if (hi) wgmma_rs_tf32<HD>(d, a.lo, db, 1);
    wgmma_rs_tf32<HD>(d, a.hi, db, !(zero && j == 0));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// O and the lse of 64 NWG query rows of one head: NWG consumer warpgroups of
// 64 rows and the producer. tq maps q as it is ((hd, H, S, B) view, boxes of
// 32 columns x 64 NWG rows), tkn k's split natural copy ((hd, H, S, B, 2),
// boxes of 32 x BK), tvt v's split transposed copy ((S8, hd, H, B, 3), boxes
// of 32 keys x HD). o (B, Sq, Hq, HD) with batch and row strides osb, oss;
// lse, when not null, contiguous (B, Hq, Sq).
template <int HD, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
flash_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tkn,
                        const __grid_constant__ CUtensorMap tvt, float* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Skv, int Hq, int rep, int64_t osb,
                        int64_t oss, float scale_log2, int causal, int window) {
  using namespace hopper;
  using C = Tf32FwdCfg<HD>;
  constexpr int BQ = 64 * NWG, BK = C::BK, CB = C::CB, NS = C::slots(NWG);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* qs = reinterpret_cast<float*>(base);           // [CB][BQ][32] q as it is
  unsigned char* ring = reinterpret_cast<unsigned char*>(qs + CB * BQ * 32);   // [NS] pieces
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + NS * kPiece);
  uint64_t* full = q_full + 1;                          // [NS] a piece landed
  uint64_t* empty = full + NS;                          // [NS] read by every consumer warp

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // the longest causal walks first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: q once, then per live K/V tile its five pieces through the
    // ring; rows past S arrive as zeros
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tkn);
      tma_prefetch(&tvt);
      mbar_expect_tx(q_full, BQ * HD * 4);
      for (int cb = 0; cb < CB; ++cb)
        tma_load_4d(qs + cb * BQ * 32, &tq, q_full, 32 * cb, h, q0, b);
      const int hk = h / rep;
      int n = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int p = 0; p < C::PIECES; ++p, ++n) {
          const int s = n % NS;
          mbar_wait(empty + s, ((n / NS) & 1) ^ 1);
          mbar_expect_tx(full + s, kPiece);
          float* dst = reinterpret_cast<float*>(ring + s * kPiece);
          if (p < 2) {                                  // [KC / 32][hi, lo][BK][32]
            for (int cb = 0; cb < C::KC / 32; ++cb)
              for (int a = 0; a < 2; ++a)
                tma_load_5d(dst + (cb * 2 + a) * BK * 32, &tkn, full + s, C::KC * p + 32 * cb, hk,
                            t * BK, b, a);
          } else {                                      // [BK / 32][HD][32] of term 4 - p
            for (int kc = 0; kc < BK / 32; ++kc)
              tma_load_5d(dst + kc * HD * 32, &tvt, full + s, t * BK + 32 * kc, 0, hk, b, 4 - p);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63, its warp w % 4 16 of them
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int wg = warp / 4, t4 = lane % 4;
  const int r0 = q0 + 64 * wg, wr0 = r0 + 16 * (warp % 4);
  const int row_lo = wr0 + lane / 4, row_hi = row_lo + 8;
  const int arow = row_lo - q0;                         // the fragments' first row in qs
  int wk_end = Skv;
  if (causal) wk_end = min(wk_end, min(r0 + 64, Sq));
  const int wk_begin = window >= 0 ? max(0, r0 - window + 1) : 0;
  const bool rows_live = r0 < Sq;
  const RowMask mask{wr0, row_lo, row_hi, lane, Skv, causal, window, scale_log2};

  float acc[HD / 2];                                    // O, accumulator layout
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
  float part[HD / 2];                                   // a tile's P V (TILE_SUM)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];                                     // S, then P
  mbar_wait(q_full, 0);
  int n = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const bool live = rows_live && k0 < wk_end && k0 + BK > wk_begin;
    // S = Q K^T, Q split in registers per k-step, K's two terms from the ring
#pragma unroll
    for (int p = 0; p < 2; ++p, ++n) {
      const int s = n % NS;
      mbar_wait(full + s, (n / NS) & 1);
      if (live) {
        const uint32_t pa = smem_u32(ring + s * kPiece);
        fence_regs(sc);
#pragma unroll
        for (int j = 0; j < C::KC / 8; ++j) {
          const int kk = C::KC / 8 * p + j;             // the k-step over the head dim
          Frag<4> fq;
          load_a_sw<BQ>(fq, qs, arow, kk, t4);
          const uint32_t bk = pa + (j / 4) * 2 * BK * 128 + (j % 4) * 32;
          wgmma_fence();
          wgmma3<BK>(sc, fq, bk, bk + BK * 128, kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        fence_regs(sc);
      }
      if (lane == 0) mbar_arrive(empty + s);           // the slot may be refilled
    }
    if (live) {
      // masks only on a tile that crosses an edge; O rescaled on every tile
      // (by exactly 1 where a row's maximum did not move)
      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wr0) ||
                             (window >= 0 && k0 <= wr0 + 15 - window);
      if (need_mask)
        softmax_scaled<BK, true>(mask, sc, k0, m, l, alpha);
      else
        softmax_scaled<BK, false>(mask, sc, k0, m, l, alpha);
      if constexpr (!C::TILE_SUM) {
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) acc[j] *= alpha[(j / 2) % 2];
      }
    }
    // O += P V, V^T's terms from the ring, small terms first: hi_P lo_V,
    // hi_P mid_V, then lo_P hi_V and hi_P hi_V (four products per fp32 one,
    // as flash_tf32_kernel)
#pragma unroll
    for (int p = 2; p < C::PIECES; ++p, ++n) {
      const int s = n % NS;
      mbar_wait(full + s, (n / NS) & 1);
      if (live) {
        const uint32_t pb = smem_u32(ring + s * kPiece);
        if constexpr (C::TILE_SUM) {
          fence_regs(part);
          pv_piece<HD, BK>(part, sc, pb, p == C::PIECES - 1, p == 2);
          fence_regs(part);
        } else {
          fence_regs(acc);
          pv_piece<HD, BK>(acc, sc, pb, p == C::PIECES - 1, false);
          fence_regs(acc);
        }
      }
      if (lane == 0) mbar_arrive(empty + s);
    }
    if constexpr (C::TILE_SUM) {
      // the tensor cores round each product's add toward zero: along a
      // whole row (1500 keys at whisper's encoder) that bias reaches 1.7e-5
      // of max|o|; one IEEE add per tile keeps it to a tile's products
      if (live) {
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) acc[j] = fmaf(acc[j], alpha[(j / 2) % 2], part[j]);
      }
    }
  }

  // epilogue: the quad's row sums, ragged rows unwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = r == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    const float den = fmaxf(li, 1e-30f), inv = 1.f / den;
    // m is in log2 units: back to natural log
    if (lse != nullptr && t4 == 0) lse[((int64_t)b * Hq + h) * Sq + row] = m[r] * kLn2 + logf(den);
    float* orow = o + b * osb + (int64_t)row * oss + (int64_t)h * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(orow + 8 * j, acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float *lse, *scratch;            // scratch: the fp32 Hopper route's split copies
  int B, Sq, Skv, Hq, rep;
  int64_t qsb, qss, ksb, kss, vsb, vss, osb, oss;
  float scale;
  int causal, window;
  cudaStream_t st;
};

// the attribute belongs to the device: raise it once per device and kernel
template <typename K>
cudaError_t raise_smem_limit(K kernel, size_t bytes, int& attr_dev) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev == attr_dev) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) attr_dev = dev;
  return e;
}

float log2_scale(float scale) { return (float)((double)scale * 1.4426950408889634); }

template <int HD>
int launch_fp32(const Args& a) {
  static int attr_dev = -1;
  cudaError_t e = raise_smem_limit(flash_tf32_kernel<HD>, Tf32Cfg<HD>::SMEM, attr_dev);
  if (e != cudaSuccess) return (int)e;
  // query tiles on y: the blocks with the most causal work start first
  const dim3 grid(a.B * a.Hq, (a.Sq + kBQ - 1) / kBQ);
  flash_tf32_kernel<HD><<<grid, kPairThreads, Tf32Cfg<HD>::SMEM, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.Sq, a.Skv, a.Hq, a.rep,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.osb, a.oss, log2_scale(a.scale), a.causal,
      a.window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const Args& a) {
  static int attr_dev = -1;
  cudaError_t e = raise_smem_limit(flash_mma_kernel<HD>, MmaCfg<HD>::SMEM, attr_dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  flash_mma_kernel<HD><<<grid, kMmaThreads, MmaCfg<HD>::SMEM, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.Sq, a.Skv, a.Hq, a.rep,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.osb, a.oss, scale_log2, a.causal,
      a.window);
  return (int)cudaGetLastError();
}

using hopper::encode_map;

// the TMA map of the (hd, H, S, B) view of a bf16 (fp32 with `fp32`) (B, S,
// H, hd) tensor with batch and row strides sb and ss (elements): boxes of
// 128 bytes (64 bf16 or 32 fp32 columns) x `rows` rows of one head. A
// dimension of extent 1 gets the stride a contiguous tensor would have
// (torch leaves its stride free, TMA wants a multiple of 16 bytes).
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd, int64_t sb,
                int64_t ss, int rows, bool fp32 = false) {
  const cuuint64_t e = fp32 ? 4 : 2;
  const cuuint64_t row = S > 1 ? (cuuint64_t)ss * e : (cuuint64_t)H * hd * e;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * e, row,
                                 B > 1 ? (cuuint64_t)sb * e : row * (cuuint64_t)S};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), 1, (cuuint32_t)rows, 1};
  const CUtensorMapDataType type =
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_map(map, type, ptr, 4, dims, strides, box);
}

template <int HD, int NWG>
int launch_wgmma_n(const Args& a) {
  using C = WgCfg<HD>;
  constexpr int BQ = 64 * NWG;
  static int attr_dev = -1;
  const cudaError_t e = raise_smem_limit(flash_wgmma_kernel<HD, NWG>, C::smem(NWG), attr_dev);
  if (e != cudaSuccess) return (int)e;
  // with no keys nothing is loaded but Q: k and v's maps then describe q
  const bool keys = a.Skv > 0;
  const int Hkv = a.Hq / a.rep;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, a.B, a.Sq, a.Hq, HD, a.qsb, a.qss, BQ) ||
      !tensor_map(&tk, keys ? a.k : a.q, a.B, keys ? a.Skv : 1, Hkv, HD,
                  keys ? a.ksb : a.qsb, keys ? a.kss : a.qss, C::BK) ||
      !tensor_map(&tv, keys ? a.v : a.q, a.B, keys ? a.Skv : 1, Hkv, HD,
                  keys ? a.vsb : a.qsb, keys ? a.vss : a.qss, C::BK))
    return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<HD, NWG><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.Hq), wg_threads(NWG),
                                C::smem(NWG), a.st>>>(
      tq, tk, tv, static_cast<bf16*>(a.o), a.lse, a.Sq, a.Skv, a.Hq, a.rep, a.osb, a.oss,
      log2_scale(a.scale), a.causal, a.window);
  return (int)cudaGetLastError();
}

// consumer warpgroups per block, by a rule on the grid: the most whose
// blocks still fill the card (three, 192 query rows, only at hd 64, where
// 160 registers a thread hold a warpgroup's state; two, 128 rows; else one,
// 64 rows)
template <int HD>
int launch_wgmma(const Args& a) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const auto blocks = [&](int rows) {
    return (long long)((a.Sq + rows - 1) / rows) * a.B * a.Hq;
  };
  if constexpr (HD == 64) {
    if (blocks(192) >= sms) return launch_wgmma_n<HD, 3>(a);
  }
  return blocks(128) >= sms ? launch_wgmma_n<HD, 2>(a) : launch_wgmma_n<HD, 1>(a);
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float *delta, *scratch;          // scratch: the fp32 Hopper route's split copies
  void *dq, *dk, *dv;
  int B, Sq, Skv, Hq, rep;
  int64_t qsb, qss, ksb, kss, vsb, vss;
  float scale;
  int causal, window;
  cudaStream_t st;
};

template <int HD>
int launch_bwd(const BwdArgs& a) {
  using CQ = BwdQCfg<HD>;
  using CKV = BwdKVCfg<HD>;
  static int attr_q = -1, attr_kv = -1;
  cudaError_t e = raise_smem_limit(flash_tf32_bwd_dq_kernel<HD>, CQ::SMEM, attr_q);
  if (e != cudaSuccess) return (int)e;
  e = raise_smem_limit(flash_tf32_bwd_dkdv_kernel<HD>, CKV::SMEM, attr_kv);
  if (e != cudaSuccess) return (int)e;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
          *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  const float scale_log2 = log2_scale(a.scale);
  // query (key) tiles on y: the blocks with the most causal work start first
  flash_tf32_bwd_dq_kernel<HD><<<dim3(a.B * a.Hq, (a.Sq + kBQ - 1) / kBQ), kPairThreads,
                                 CQ::SMEM, a.st>>>(
      q, k, v, static_cast<const float*>(a.o), dout, a.lse, a.delta, static_cast<float*>(a.dq),
      a.Sq, a.Skv, a.Hq, a.rep, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, scale_log2,
      a.causal, a.window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_tf32_bwd_dkdv_kernel<HD><<<dim3(a.B * (a.Hq / a.rep),
                                        (a.Skv + CKV::BKV - 1) / CKV::BKV, HD / CKV::DN),
                                   kKVThreads, CKV::SMEM, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq,
      a.Skv, a.Hq, a.rep, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, scale_log2,
      a.causal, a.window);
  return (int)cudaGetLastError();
}

// the bf16 dK/dV kernel with NG groups: the smem attribute once per device
template <int HD, int NG>
cudaError_t launch_dkdv_bf16(const BwdArgs& a, float scale_log2) {
  using C = Bf16BwdKVCfg<HD, NG>;
  static int attr_dev = -1;
  const cudaError_t e = raise_smem_limit(flash_bf16_bwd_dkdv_kernel<HD, NG>, C::SMEM, attr_dev);
  if (e != cudaSuccess) return e;
  flash_bf16_bwd_dkdv_kernel<HD, NG><<<dim3(a.B * (a.Hq / a.rep) * C::NZ,
                                            (a.Skv + C::BKV - 1) / C::BKV),
                                       kPairThreads, C::SMEM, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.Hq, a.rep, a.qsb,
      a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, scale_log2, a.causal, a.window);
  return cudaGetLastError();
}

template <int HD>
int launch_bwd_bf16(const BwdArgs& a) {
  using CQ = Bf16BwdQCfg<HD>;
  static int attr_q = -1;
  cudaError_t e = raise_smem_limit(flash_bf16_bwd_dq_kernel<HD>, CQ::SMEM, attr_q);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = log2_scale(a.scale);
  // query tiles on y: the blocks with the most causal work start first
  flash_bf16_bwd_dq_kernel<HD><<<dim3(a.B * a.Hq, (a.Sq + CQ::BQ - 1) / CQ::BQ), CQ::THREADS,
                                 CQ::SMEM, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Skv,
      a.Hq, a.rep, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, scale_log2, a.causal,
      a.window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // key blocks of 64 keys (two groups of 4 warps) when they fill the card,
  // else of 32 (four groups of 2 warps, where their buffers fit in shared
  // memory): twice the blocks, each group walking a quarter of the items
  using C2 = Bf16BwdKVCfg<HD, 2>;
  const long long blocks = (long long)a.B * (a.Hq / a.rep) * C2::NZ * ((a.Skv + 63) / 64);
  if constexpr (Bf16BwdKVCfg<HD, 4>::SMEM <= kSmemMax) {
    if (blocks < sms) return (int)launch_dkdv_bf16<HD, 4>(a, scale_log2);
  }
  return (int)launch_dkdv_bf16<HD, 2>(a, scale_log2);
}

// the TMA maps of q, k, v and dout for the Hopper backward: q and dout in
// boxes of `q_rows` rows, k and v in boxes of `kv_rows`
template <int HD>
bool bwd_maps(const BwdArgs& a, int q_rows, int kv_rows, CUtensorMap* tq, CUtensorMap* tk,
              CUtensorMap* tv, CUtensorMap* tdo) {
  const int Hkv = a.Hq / a.rep;
  const int64_t oss = (int64_t)a.Hq * HD, osb = (int64_t)a.Sq * oss;
  return tensor_map(tq, a.q, a.B, a.Sq, a.Hq, HD, a.qsb, a.qss, q_rows) &&
         tensor_map(tdo, a.dout, a.B, a.Sq, a.Hq, HD, osb, oss, q_rows) &&
         tensor_map(tk, a.k, a.B, a.Skv, Hkv, HD, a.ksb, a.kss, kv_rows) &&
         tensor_map(tv, a.v, a.B, a.Skv, Hkv, HD, a.vsb, a.vss, kv_rows);
}

// the dQ kernel with the most consumer warpgroups, up to NWG, whose blocks
// still fill the card's `sms` SMs, else one
template <int HD, int NWG>
cudaError_t launch_wgmma_bwd_dq(const BwdArgs& a, float scale_log2, int sms) {
  using C = WgBwdCfg<HD>;
  constexpr int BQ = 64 * NWG;
  if constexpr (NWG > 1) {
    if ((long long)((a.Sq + BQ - 1) / BQ) * a.B * a.Hq < sms)
      return launch_wgmma_bwd_dq<HD, NWG - 1>(a, scale_log2, sms);
  }
  static int attr_dev = -1;
  const cudaError_t e =
      raise_smem_limit(flash_wgmma_bwd_dq_kernel<HD, NWG>, C::dq_smem(NWG), attr_dev);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, tdo;
  if (!bwd_maps<HD>(a, BQ, C::BK, &tq, &tk, &tv, &tdo)) return cudaErrorInvalidValue;
  flash_wgmma_bwd_dq_kernel<HD, NWG><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.Hq), wg_threads(NWG),
                                       C::dq_smem(NWG), a.st>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(a.o), a.lse, a.delta, static_cast<bf16*>(a.dq),
      a.Sq, a.Skv, a.Hq, a.rep, a.scale, scale_log2, a.causal, a.window);
  return cudaGetLastError();
}

// the dK/dV kernel, chosen the same way
template <int HD, int NWG>
cudaError_t launch_wgmma_bwd_dkdv(const BwdArgs& a, float scale_log2, int sms) {
  using C = WgBwdCfg<HD>;
  constexpr int BKV = 64 * NWG;
  if constexpr (NWG > 1) {
    if ((long long)a.B * (a.Hq / a.rep) * C::NZ * ((a.Skv + BKV - 1) / BKV) < sms)
      return launch_wgmma_bwd_dkdv<HD, NWG - 1>(a, scale_log2, sms);
  }
  static int attr_dev = -1;
  const cudaError_t e =
      raise_smem_limit(flash_wgmma_bwd_dkdv_kernel<HD, NWG>, C::dkdv_smem(NWG), attr_dev);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, tdo;
  if (!bwd_maps<HD>(a, C::BQ, BKV, &tq, &tk, &tv, &tdo)) return cudaErrorInvalidValue;
  flash_wgmma_bwd_dkdv_kernel<HD, NWG><<<dim3(a.B * (a.Hq / a.rep) * C::NZ,
                                              (a.Skv + BKV - 1) / BKV),
                                         wg_threads(NWG), C::dkdv_smem(NWG), a.st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq,
      a.Skv, a.Hq, a.rep, a.scale, scale_log2, a.causal, a.window);
  return cudaGetLastError();
}

// the Hopper backward: the dQ kernel (which writes delta), then the dK/dV
// kernel, each with the most consumer warpgroups (up to its DQ_NWG or
// KV_NWG) whose blocks still fill the card
template <int HD>
int launch_wgmma_bwd(const BwdArgs& a) {
  using C = WgBwdCfg<HD>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = log2_scale(a.scale);
  e = launch_wgmma_bwd_dq<HD, C::DQ_NWG>(a, scale_log2, sms);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_wgmma_bwd_dkdv<HD, C::KV_NWG>(a, scale_log2, sms);
}

// a split natural copy (2, B, S, H, hd) as (hd, H, S, B, 2), boxes of 32
// columns x `rows` rows of one head and term
bool map_split_f32(CUtensorMap* map, const float* ptr, int B, int S, int H, int hd, int rows) {
  const cuuint64_t dims[5] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B, 2};
  const cuuint64_t r = (cuuint64_t)H * hd * 4;
  const cuuint64_t strides[4] = {(cuuint64_t)hd * 4, r, r * S, r * S * B};
  const cuuint32_t box[5] = {32, 1, (cuuint32_t)rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 5, dims, strides, box);
}

// a split transposed copy (terms, B, H, hd, S8) as (S8, hd, H, B, terms),
// boxes of 32 positions x `rows` head-dim rows of one head and term
bool map_split_t_f32(CUtensorMap* map, const float* ptr, int B, int S, int H, int hd, int rows,
                     int terms = 2) {
  const cuuint64_t s8 = (cuuint64_t)round8(S) * 4;
  const cuuint64_t dims[5] = {(cuuint64_t)round8(S), (cuuint64_t)hd, (cuuint64_t)H,
                              (cuuint64_t)B, (cuuint64_t)terms};
  const cuuint64_t strides[4] = {s8, s8 * hd, s8 * hd * H, s8 * hd * H * B};
  const cuuint32_t box[5] = {32, (cuuint32_t)rows, 1, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 5, dims, strides, box);
}

// the TF32 dQ kernel with the most consumer warpgroups, up to NWG, whose
// blocks still fill the card's `sms` SMs, else one
template <int HD, int NWG>
cudaError_t launch_tf32_bwd_dq(const BwdArgs& a, const Tf32Scratch& sc, float scale_log2,
                               int sms) {
  using C = Tf32WgCfg<HD>;
  constexpr int BQ = 64 * NWG;
  if constexpr (NWG > 1) {
    if ((long long)((a.Sq + BQ - 1) / BQ) * a.B * a.Hq < sms)
      return launch_tf32_bwd_dq<HD, NWG - 1>(a, sc, scale_log2, sms);
  }
  static int attr_dev = -1;
  const cudaError_t e =
      raise_smem_limit(flash_wgmma_tf32_bwd_dq_kernel<HD, NWG>, C::smem(NWG), attr_dev);
  if (e != cudaSuccess) return e;
  const int Hkv = a.Hq / a.rep;
  const int64_t oss = (int64_t)a.Hq * HD, osb = (int64_t)a.Sq * oss;
  CUtensorMap tq, tdo, tkn, tvn, tkt;
  if (!tensor_map(&tq, a.q, a.B, a.Sq, a.Hq, HD, a.qsb, a.qss, BQ, true) ||
      !tensor_map(&tdo, a.dout, a.B, a.Sq, a.Hq, HD, osb, oss, BQ, true) ||
      !map_split_f32(&tkn, sc.kn, a.B, a.Skv, Hkv, HD, C::BK) ||
      !map_split_f32(&tvn, sc.vn, a.B, a.Skv, Hkv, HD, C::BK) ||
      !map_split_t_f32(&tkt, sc.kt, a.B, a.Skv, Hkv, HD, HD))
    return cudaErrorInvalidValue;
  flash_wgmma_tf32_bwd_dq_kernel<HD, NWG><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.Hq),
                                            wg_threads(NWG), C::smem(NWG), a.st>>>(
      tq, tdo, tkn, tvn, tkt, a.lse, a.delta, static_cast<float*>(a.dq), a.Sq, a.Skv, a.Hq,
      a.rep, a.scale, scale_log2, a.causal, a.window);
  return cudaGetLastError();
}

// the TF32 dK/dV kernel, chosen the same way
template <int HD, int NWG>
cudaError_t launch_tf32_bwd_dkdv(const BwdArgs& a, const Tf32Scratch& sc, float scale_log2,
                                 int sms) {
  using C = Tf32WgCfg<HD>;
  constexpr int BKV = 64 * NWG;
  if constexpr (NWG > 1) {
    if ((long long)a.B * (a.Hq / a.rep) * C::NZ * ((a.Skv + BKV - 1) / BKV) < sms)
      return launch_tf32_bwd_dkdv<HD, NWG - 1>(a, sc, scale_log2, sms);
  }
  static int attr_dev = -1;
  const cudaError_t e =
      raise_smem_limit(flash_wgmma_tf32_bwd_dkdv_kernel<HD, NWG>, C::smem(NWG), attr_dev);
  if (e != cudaSuccess) return e;
  const int Hkv = a.Hq / a.rep;
  CUtensorMap tk, tv, tqn, tdon, tqt, tdot;
  if (!tensor_map(&tk, a.k, a.B, a.Skv, Hkv, HD, a.ksb, a.kss, BKV, true) ||
      !tensor_map(&tv, a.v, a.B, a.Skv, Hkv, HD, a.vsb, a.vss, BKV, true) ||
      !map_split_f32(&tqn, sc.qn, a.B, a.Sq, a.Hq, HD, C::BQ) ||
      !map_split_f32(&tdon, sc.don, a.B, a.Sq, a.Hq, HD, C::BQ) ||
      !map_split_t_f32(&tqt, sc.qt, a.B, a.Sq, a.Hq, HD, C::DN) ||
      !map_split_t_f32(&tdot, sc.dot, a.B, a.Sq, a.Hq, HD, C::DN))
    return cudaErrorInvalidValue;
  flash_wgmma_tf32_bwd_dkdv_kernel<HD, NWG><<<dim3(a.B * Hkv * C::NZ, (a.Skv + BKV - 1) / BKV),
                                              wg_threads(NWG), C::smem(NWG), a.st>>>(
      tk, tv, tqn, tdon, tqt, tdot, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Skv, a.Hq, a.rep, a.scale, scale_log2, a.causal,
      a.window);
  return cudaGetLastError();
}

// the fp32 backward on Hopper: the pre-pass (split copies and delta), then
// the dQ kernel, then the dK/dV kernel, each with the most consumer
// warpgroups (up to MAX_NWG) whose blocks still fill the card
template <int HD>
int launch_wgmma_tf32_bwd(const BwdArgs& a) {
  using C = Tf32WgCfg<HD>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int Hkv = a.Hq / a.rep;
  const Tf32Scratch sc = carve(a.scratch, a.B, a.Sq, a.Skv, a.Hq, Hkv, HD);
  const int rows = a.Sq > a.Skv ? a.Sq : a.Skv;
  flash_wgmma_tf32_bwd_prep_kernel<HD><<<dim3((rows + kPrepRows - 1) / kPrepRows, a.B * a.Hq, 4),
                                         kPrepThreads, 0, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), sc, a.delta, a.Sq, a.Skv, a.Hq, Hkv, a.qsb, a.qss,
      a.ksb, a.kss, a.vsb, a.vss);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = log2_scale(a.scale);
  e = launch_tf32_bwd_dq<HD, C::MAX_NWG>(a, sc, scale_log2, sms);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tf32_bwd_dkdv<HD, C::MAX_NWG>(a, sc, scale_log2, sms);
}

// the TF32 forward kernel with the most consumer warpgroups, up to NWG,
// whose blocks still fill the card's `sms` SMs, else one
template <int HD, int NWG>
cudaError_t launch_tf32_fwd(const Args& a, const float* kn, const float* vt, int sms) {
  using C = Tf32FwdCfg<HD>;
  constexpr int BQ = 64 * NWG;
  if constexpr (NWG > 1) {
    if ((long long)((a.Sq + BQ - 1) / BQ) * a.B * a.Hq < sms)
      return launch_tf32_fwd<HD, NWG - 1>(a, kn, vt, sms);
  }
  static int attr_dev = -1;
  const cudaError_t e = raise_smem_limit(flash_wgmma_tf32_kernel<HD, NWG>, C::smem(NWG), attr_dev);
  if (e != cudaSuccess) return e;
  const int Hkv = a.Hq / a.rep;
  CUtensorMap tq, tkn, tvt;
  if (!tensor_map(&tq, a.q, a.B, a.Sq, a.Hq, HD, a.qsb, a.qss, BQ, true) ||
      !map_split_f32(&tkn, kn, a.B, a.Skv, Hkv, HD, C::BK) ||
      !map_split_t_f32(&tvt, vt, a.B, a.Skv, Hkv, HD, HD, 3))
    return cudaErrorInvalidValue;
  flash_wgmma_tf32_kernel<HD, NWG><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.Hq), wg_threads(NWG),
                                     C::smem(NWG), a.st>>>(
      tq, tkn, tvt, static_cast<float*>(a.o), a.lse, a.Sq, a.Skv, a.Hq, a.rep, a.osb, a.oss,
      log2_scale(a.scale), a.causal, a.window);
  return cudaGetLastError();
}

// the fp32 forward on Hopper: the pre-pass (k's and v's split copies), then
// the forward kernel with the most consumer warpgroups (up to MAX_NWG) whose
// blocks still fill the card
template <int HD>
int launch_wgmma_tf32(const Args& a) {
  using C = Tf32FwdCfg<HD>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int Hkv = a.Hq / a.rep;
  float* kn = a.scratch;
  float* vt = kn + 2LL * a.B * a.Skv * Hkv * HD;
  flash_wgmma_tf32_fwd_prep_kernel<HD><<<dim3((a.Skv + kPrepRows - 1) / kPrepRows, a.B * Hkv, 2),
                                         kPrepThreads, 0, a.st>>>(
      static_cast<const float*>(a.k), static_cast<const float*>(a.v), kn, vt, a.Skv, Hkv, a.ksb,
      a.kss, a.vsb, a.vss);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tf32_fwd<HD, C::MAX_NWG>(a, kn, vt, sms);
}

// The fp32 routes' shape rule (kernel.py's `fp32_on_hopper`): the Hopper
// kernels (TF32 wgmma fed by TMA, after a pre-pass that writes split copies
// into scratch) at hd 64, 128 and 256 where the keys are more than
// kTf32FwdMmaKeys (forward) or kTf32BwdMmaKeys (backward); with fewer keys
// the mma.sync kernels, for which no pre-pass runs: there the pre-pass costs
// more than the Hopper kernels save (PERF.md: the forward at whisper's
// decoder, (8, 448, 12 heads of 64), and smollm-135m's training shape, (8,
// 256, 9/3 heads of 64); the backward at smollm's).
constexpr int kTf32FwdMmaKeys = 512, kTf32BwdMmaKeys = 256;

bool fp32_on_hopper(bool backward, int hd, int Skv) {
  return (hd == 64 || hd == 128 || hd == 256) &&
         Skv > (backward ? kTf32BwdMmaKeys : kTf32FwdMmaKeys);
}

// the forward by dtype, head dim and shape: a fixed rule, not a fallback
template <int HD>
struct Fwd {
  static int run(int dtype, const Args& a) {
    if (dtype == 0) {
      if constexpr (HD == 64 || HD == 128 || HD == 256) {
        if (fp32_on_hopper(false, HD, a.Skv))
          return launch_wgmma_tf32<HD>(a);
      }
      return launch_fp32<HD>(a);
    }
    if (dtype == 1) {
      if constexpr (HD == 64 || HD == 128 || HD == 256) return launch_wgmma<HD>(a);
      else return launch_bf16<HD>(a);
    }
    return (int)cudaErrorInvalidValue;
  }
};

// the backward by dtype, head dim and shape: a fixed rule, not a fallback
template <int HD>
struct Bwd {
  static int run(int dtype, const BwdArgs& a) {
    if (dtype == 0) {
      if constexpr (HD == 64 || HD == 128 || HD == 256) {
        if (fp32_on_hopper(true, HD, a.Skv))
          return launch_wgmma_tf32_bwd<HD>(a);
      }
      return launch_bwd<HD>(a);
    }
    if (dtype == 1) {
      if constexpr (HD == 64 || HD == 128 || HD == 256) return launch_wgmma_bwd<HD>(a);
      else return launch_bwd_bf16<HD>(a);
    }
    return (int)cudaErrorInvalidValue;
  }
};

template <template <int> class L, typename A>
int dispatch(int hd, int dtype, const A& a) {
  switch (hd) {
    case 16: return L<16>::run(dtype, a);
    case 32: return L<32>::run(dtype, a);
    case 48: return L<48>::run(dtype, a);
    case 64: return L<64>::run(dtype, a);
    case 80: return L<80>::run(dtype, a);
    case 96: return L<96>::run(dtype, a);
    case 112: return L<112>::run(dtype, a);
    case 128: return L<128>::run(dtype, a);
    case 144: return L<144>::run(dtype, a);
    case 160: return L<160>::run(dtype, a);
    case 176: return L<176>::run(dtype, a);
    case 192: return L<192>::run(dtype, a);
    case 208: return L<208>::run(dtype, a);
    case 224: return L<224>::run(dtype, a);
    case 240: return L<240>::run(dtype, a);
    case 256: return L<256>::run(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of the scratch that flash_attention_launch takes at these sizes:
// k's and v's split copies of the fp32 route on Hopper (fp32_on_hopper; 84
// MB at mixtral-8x7b's (1, 4096, 32/8 heads of 128)); 0 for every other
// route.
extern "C" long long flash_attention_fwd_scratch_bytes(int B, int Sq, int Skv, int Hq, int Hkv,
                                                       int hd, int dtype) {
  if (dtype != 0 || Hkv < 1 || !fp32_on_hopper(false, hd, Skv)) return 0;
  return 4 * fwd_scratch_floats(B, Skv, Hkv, hd);
}

// q, o (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd); dtype 0 = float32, 1 =
// bfloat16 for all four. Launches on `stream`, by kernel.forward_kernels's
// rule: float32 where fp32_on_hopper holds flash_wgmma_tf32_fwd_prep_kernel
// (k's and v's split copies in scratch), then flash_wgmma_tf32_kernel;
// float32 elsewhere flash_tf32_kernel; bfloat16 at hd 64, 128 and 256
// flash_wgmma_kernel, at the others flash_mma_kernel. Strides in elements:
// *sb between batches, *ss between rows; the head stride must be hd and the
// element stride 1; the pointers and the batch and row strides must be
// 16-byte aligned (cp.async, TMA). window < 0 = none.
// lse, when not null, receives each row's log-sum-exp of scale * q . k over
// its unmasked keys, fp32, contiguous (B, Hq, Sq) (the backward's input); o
// does not depend on it. scratch 16-byte aligned, of
// flash_attention_fwd_scratch_bytes (null where that is 0). Requires hd in
// 16..256 a multiple of 16, Hq % Hkv == 0, Sq >= 1, B * Hq <= 65535.
// Returns the first CUDA error, else cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, void* scratch, int B, int Sq, int Skv, int Hq,
                                      int Hkv, int hd,
                                      long long qsb, long long qss, long long ksb,
                                      long long kss, long long vsb, long long vss,
                                      long long osb, long long oss, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || B < 1 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), static_cast<float*>(scratch), B, Sq, Skv,
               Hq, Hq / Hkv, qsb, qss, ksb, kss, vsb, vss, osb, oss, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(hd, dtype, a);
}

// Bytes of the scratch that flash_attention_bwd_launch takes at these
// sizes: the split copies of the fp32 route on Hopper (fp32_on_hopper; four
// natural copies, three transposed ones, each in two TF32 terms: 0.6 GB at
// mixtral-8x7b's (1, 4096, 32/8 heads of 128)); 0 for every other route.
extern "C" long long flash_attention_bwd_scratch_bytes(int B, int Sq, int Skv, int Hq, int Hkv,
                                                       int hd, int dtype) {
  if (dtype != 0 || Hkv < 1 || !fp32_on_hopper(true, hd, Skv)) return 0;
  return 4 * scratch_floats(B, Sq, Skv, Hq, Hkv, hd);
}

// The backward of flash_attention_launch (same B, Sq, Skv, Hq, Hkv, hd, scale,
// causal, window and dtype): q, k, v with the forward's strides; o, dout and
// dq (B, Sq, Hq, hd), dk and dv (B, Skv, Hkv, hd) contiguous in the dtype,
// dout 16-byte aligned; lse (the forward's) and delta (scratch) fp32
// contiguous (B, Hq, Sq); scratch 16-byte aligned, of
// flash_attention_bwd_scratch_bytes (null where that is 0). Launches on
// `stream`, by kernel.backward_kernels's rule: float32 where fp32_on_hopper
// holds flash_wgmma_tf32_bwd_prep_kernel (the split copies in scratch, and
// delta), flash_wgmma_tf32_bwd_dq_kernel (dq), flash_wgmma_tf32_bwd_dkdv_kernel
// (dk, dv); float32 elsewhere flash_tf32_bwd_dq_kernel (dq, and delta), then
// flash_tf32_bwd_dkdv_kernel; bfloat16 at hd 64, 128, 256
// flash_wgmma_bwd_dq_kernel (dq, and delta), then
// flash_wgmma_bwd_dkdv_kernel; bfloat16 at the other head dims
// flash_bf16_bwd_dq_kernel, then flash_bf16_bwd_dkdv_kernel. Requires Sq,
// Skv >= 1, Skv <= 16 * 65535 and the forward's limits. Returns the first
// CUDA error, else cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* scratch, void* dq, void* dk, void* dv,
                                          int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                                          long long qsb, long long qss, long long ksb,
                                          long long kss, long long vsb, long long vss,
                                          float scale, int causal, int window, int dtype,
                                          void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || B < 1 || (long long)B * Hq > 65535 ||
      Skv > 16 * 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                  static_cast<float*>(scratch), dq, dk, dv, B, Sq, Skv, Hq, Hq / Hkv, qsb, qss,
                  ksb, kss, vsb, vss, scale, causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch<Bwd>(hd, dtype, a);
}
