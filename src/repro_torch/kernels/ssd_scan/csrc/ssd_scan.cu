// Mamba-2 chunked SSD scan for Hopper (sm_90a), CUDA C++ with plain C entry points.
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_ssd_kernel` of
// src/repro/kernels/ssd_scan/kernel.py. Same function: per (batch b, head h),
// over chunks of Q tokens,
//   L      = inclusive cumsum of dt*A over the chunk
//   y_t    = sum_{s<=t} (C_t.B_s) exp(L_t-L_s) dt_s x_s  +  exp(L_t) C_t.h_prev
//   h      = exp(L_Q) h_prev + sum_s exp(L_Q-L_s) dt_s x_s B_s^T
// plus the D skip, added in fp32 before the single cast of y to x's dtype
// (the TPU wrapper casts first and adds D after; see ref.py). The TPU kernel
// has no backward; the backward here is the gradient of the same function.
//
// One forward per dtype and one backward, chosen by a fixed rule on the
// dtype (not a fallback; a failed launch is returned), all on the tensor
// cores with the same three-stage forward:
//   * bfloat16 forward (ssd_scan_launch, bf16_in): chunk_state_kernel,
//     state_pass_kernel<false>, chunk_scan_kernel, bf16 mma.sync m16n8k16;
//   * float32 forward (ssd_scan_launch): chunk_state_tf32_kernel<false,
//     float>, state_pass_kernel<false>, chunk_scan_tf32_kernel, split-TF32
//     mma.sync m16n8k8;
//   * backward, both dtypes (ssd_scan_bwd_launch; see its section below):
//     six launches, split-TF32 mma.sync m16n8k8, templated on the type in
//     memory; fp32 at Q = 128, P = 64, N = 64 or 128 replaces the last three
//     by TF32 wgmma kernels fed by TMA (the Hopper route, its own section).
// x, B and C are read through their batch and row strides in every kernel:
// the split views of the conv output need no copy.
//
// What bounds it on this card: at the serving shapes (B=1, S<=1024, H=32,
// P=64, N=128, Q=128) the function moves ~10 MB and does ~1.6 GFLOP, so its
// least time is set by device-memory bytes (~3 us at 3.35 TB/s), not by the
// tensor cores. At the training shapes (B=8, S=256, 32 heads of 64 with
// N=128, or 64 heads with N=64; fp32) the forward does 2.2-2.7 GFLOP on
// 61-94 MB and the backward 3.3-4.4 GFLOP on 72-121 MB: IEEE fp32 on the
// CUDA cores (67 TFLOP/s) would be bound by operations, split TF32 (three
// TF32 products per fp32 one at 495 TFLOP/s) by bytes.
//
// bf16 forward: the TPU kernel's sequential chunk axis is split
// chunk-parallel (three launches, all scratch fp32 and allocated by the
// wrapper):
//   1. chunk_state_kernel, grid (nc, H, B x 64-channel slices): the chunk's
//      cumsum L (warp scan), x'_s = exp(L_Q - L_s) dt_s x_s in fp32 split
//      into hi + lo bf16, and S_c = x'^T B by mma.sync m16n8k16 (bf16 in,
//      fp32 accumulate), written to states (B, nc, H, P, N); L_Q to lq.
//   2. state_pass_kernel, grid over (P N / 1024, H, B): walks the chunks in
//      order, h <- exp(L_Q,c) h + S_c, writing h_prev over S_c in place and
//      the final state. Elementwise and bound by bytes (L2 at these sizes).
//   3. chunk_scan_kernel, grid (nc, H, B x 64- or 32-channel slices; 32 when
//      64 would leave SMs idle): warp w owns rows [16 w, 16 w + 16). One pass
//      over n gives C B^T on s <= t (exact: bf16 products, fp32 sums) and
//      C h_prev^T with h_prev split hi + lo; then M = (C B^T) o
//      exp(L_t - L_s) o dt_s is formed in fp32 from the accumulator
//      registers, split hi + lo, and used as the A fragments of M x (the
//      FlashAttention-2 register layout); + D x in fp32, one cast, each y
//      written once.
// x, B and C are bf16 already and a product of two bf16 is exact in fp32, so
// only the fp32 factor of each product (x', M, h_prev) is split: one bf16
// would round it to 8 bits and miss the bf16 rule at the serving shape
// (PERF.md); hi + lo keeps ~16 bits for twice the tensor-core work.
// Tiles are staged by cp.async (16-, 8- or 4-byte copies, the widest the
// pointers and strides allow, zero-filled past the chunk's rows) into rows
// padded by 16 bytes, so ldmatrix is free of bank conflicts. Any Q <= 128,
// any S (ragged rows act as padding with dt = 0: zero x, B, C, excluded
// from M, never written), any P (64-channel slices, padded to 16),
// N <= 128 with N % 4 == 0 (padded to 32).
//
// Split TF32 (the fp32 forward and the backward). A TF32 product keeps 11
// significant bits of each operand, which misses the fp32 rule. Each fp32
// operand is split in registers into hi = tf32(v) and lo = tf32(v - hi),
// rounded to nearest as cvt.rna.tf32.f32 rounds, and a product takes
// lo_a hi_b + hi_a lo_b + hi_a hi_b: ~22 bits per operand for three
// tensor-core products (flash_attention.cu's scheme; its helpers are copied
// below). Each k-step's three products go into a zeroed accumulator that is
// added to the running sum in IEEE fp32 (`mma3`). A bf16 value is exact in TF32 (lo = 0), so the
// backward skips the products of a bf16 operand's lo term (`if constexpr`).
// The m16n8k8 accumulator is not its A operand's layout: a lane holds
// columns 2t and 2t+1 of an 8-wide n-tile (t = lane % 4), where the A
// fragment wants k-columns t and t+4. chunk_scan_tf32_kernel feeds M from
// the accumulator straight to the A fragment by permuting the keys inside
// each group of 8 (key 2t plays k-index t, key 2t+1 plays t+4) and reads
// x's rows 2t and 2t+1 in that order; a sum over keys does not depend on
// their order, so no value is shuffled. The fp32 tiles live in shared
// memory as fp32 with rows padded so that a warp's fragment loads fall on
// 32 banks, and are split as they are loaded.
//
// fp32 forward: the bf16 path's three stages.
//   1. chunk_state_tf32_kernel<false, float>, grid (nc, H, B x 64-channel
//      slices): L, x'_s = exp(L_Q - L_s) dt_s x_s in fp32, S_c = x'^T B;
//      L_Q to lq.
//   2. state_pass_kernel<false> (the bf16 path's), h_prev over S_c.
//   3. chunk_scan_tf32_kernel, grid as chunk_scan_kernel's, 16 warps: warp
//      (i, kh) owns rows [16 i, 16 i + 16) and the kh-th half of their
//      8-key tiles s <= t (the causal triangle's work split evenly): C B^T
//      on those tiles and C h_prev^T on half of the channels in one pass
//      over n, M = (C B^T) o exp(L_t - L_s) o dt_s formed in registers from
//      the accumulator (the exponent masked to s <= t first) and fed back as
//      the A fragment of M x; half 1 hands its partial y to half 0, which
//      adds it, + D x in fp32, and writes each y once.
// C, B, x and h_prev of a chunk fill ~204 KB at N = 128 (one block of 16
// warps per SM). h_prev is the state_pass output the backward takes
// (return_states), so y and the state have the same bits either way.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "../../common/hopper.cuh"

namespace {

constexpr int kQMax = 128;    // largest chunk the kernels take
constexpr int kNMax = 128;    // largest state size the kernels take

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// bf16: chunk_state_kernel -> state_pass_kernel -> chunk_scan_kernel, with
// the products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPB = 64;           // head channels per block (chunk_scan may take 32)
constexpr int kXP = kPB + 8;      // bf16 pitch of an x tile (+16 bytes: no bank conflicts)
constexpr int kMmaThreads = 256;  // 8 warps

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }
// padded sizes: Q and P to the mma's 16, N to 32 (chunk_state's strips);
// shared rows of N values get 8 bf16 of padding, as x tiles do
__host__ __device__ constexpr int pad_n(int N) { return round_up(N, 32) + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Stage a (rows, wpad) tile of T with pitch `pitch` by the NT threads of
// the block: element (r, c) is src[r * rs + c] for r < nvalid and
// c < width, else 0. `vec` elements go per copy (16, 8 or 4 bytes by
// cp.async with zero-fill for the rest; a single bf16 by a plain load); the
// launcher picks the widest that the pointer, the strides and width allow.
// wpad is a multiple of 8; rows start 16-byte aligned.
template <typename T, int NT = kMmaThreads>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* __restrict__ src,
                                      int64_t rs, int rows, int nvalid, int width, int wpad,
                                      int vec) {
  const int per_row = wpad / vec;
  const int vbytes = vec * (int)sizeof(T);
  for (int idx = threadIdx.x; idx < rows * per_row; idx += NT) {
    const int r = idx / per_row, c = (idx % per_row) * vec;
    const bool ok = r < nvalid && c < width;
    const T* s = ok ? src + (int64_t)r * rs + c : src;
    T* d = dst + r * pitch + c;
    const int bytes = ok ? vbytes : 0;
    if (vbytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(d)), "l"(s), "r"(bytes));
    } else if (vbytes == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(smem_addr(d)), "l"(s), "r"(bytes));
    } else if (vbytes == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(d)), "l"(s), "r"(bytes));
    } else {
      *d = ok ? *s : from_f<T>(0.f);
    }
  }
}

// dt of the chunk's rows (0 past its nv valid rows) and the inclusive
// cumsum L of dt*A, by the first 4 warps; the caller syncs after
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt, int64_t row0, int H,
                                             int h, float a, int nv, float* dts, float* cum,
                                             float* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = 0.f;
  if (tid < kQMax) {
    const float d = tid < nv ? dt[(row0 + tid) * H + h] : 0.f;
    dts[tid] = d;
    v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wtot[warp] = v;
  }
  __syncthreads();
  if (tid < kQMax) {
    for (int w = 0; w < warp; ++w) v += wtot[w];
    cum[tid] = v;
  }
}

// The forward's arguments; x, B and C in the forward's dtype T.
template <typename T>
struct FwdArgs {
  const T *x, *Bm, *Cm;
  const float *dt, *A, *D;
  T* y;
  float *state, *states, *lq;
  int Bsz, S, H, P, N, Q, nc;
  int64_t xsb, xss, bsb, bss, csb, css;
  int vx, vb, vc;                // copy widths (elements per copy)
};
using Bf16Args = FwdArgs<bf16>;

constexpr size_t chunk_state_smem(int Qp, int N) {
  return 2 * sizeof(bf16) * (size_t)Qp * kXP + sizeof(bf16) * (size_t)Qp * pad_n(N) +
         sizeof(float) * (3 * kQMax + 4);
}

// S_c = x'^T B over the chunk, x'_s = exp(L_Q - L_s) dt_s x_s (fp32, split
// into hi + lo bf16), for one (chunk, head, batch, slice of kPB channels).
// Grid (nc, H, Bsz * ceil(P / kPB)). Writes S_c to states (Bsz, nc, H, P, N)
// and L_Q to lq (Bsz, nc, H).
__global__ void __launch_bounds__(kMmaThreads)
chunk_state_kernel(Bf16Args a) {
  const int c = blockIdx.x, h = blockIdx.y;
  const int npb = (a.P + kPB - 1) / kPB;
  const int b = blockIdx.z / npb, p0 = (blockIdx.z % npb) * kPB;
  const int pw = min(kPB, a.P - p0), Pp = round_up(pw, 16);
  const int Qp = round_up(a.Q, 16), Np = round_up(a.N, 32), NP = pad_n(a.N);
  const int nv = min(a.Q, a.S - c * a.Q);
  const int64_t row0 = (int64_t)b * a.S + (int64_t)c * a.Q;   // first token of the chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xh = reinterpret_cast<bf16*>(smem_raw);     // [Qp][kXP]  x, then x'_hi
  bf16* xl = xh + Qp * kXP;                          // [Qp][kXP]  x'_lo
  bf16* bs = xl + Qp * kXP;                          // [Qp][NP]   B
  float* dts = reinterpret_cast<float*>(bs + Qp * NP);
  float* cum = dts + kQMax;
  float* ws = cum + kQMax;
  float* wtot = ws + kQMax;

  const int64_t tok = (int64_t)c * a.Q;
  stage(xh, kXP, a.x + b * a.xsb + tok * a.xss + (int64_t)h * a.P + p0, a.xss, Qp, nv, pw, Pp,
        a.vx);
  stage(bs, NP, a.Bm + b * a.bsb + tok * a.bss, a.bss, Qp, nv, a.N, Np, a.vb);
  cp_async_commit();
  chunk_cumsum(a.dt, row0, a.H, h, a.A[h], nv, dts, cum, wtot);
  __syncthreads();
  const float lq = cum[a.Q - 1];
  if (threadIdx.x < kQMax) ws[threadIdx.x] = expf(lq - cum[threadIdx.x]) * dts[threadIdx.x];
  if (threadIdx.x == 0 && p0 == 0) a.lq[((int64_t)b * a.nc + c) * a.H + h] = lq;
  cp_async_wait_all();
  __syncthreads();

  // x' = w_s x_s in fp32, split into hi (in place of x) and lo, two at a time
  for (int idx = threadIdx.x; idx < Qp * Pp / 2; idx += kMmaThreads) {
    const int s = idx / (Pp / 2), p = 2 * (idx % (Pp / 2));
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(xh + s * kXP + p);
    const float2 xv = __bfloat1622float2(*hp);
    uint32_t hi, lo;
    split2(ws[s] * xv.x, ws[s] * xv.y, hi, lo);
    *reinterpret_cast<uint32_t*>(hp) = hi;
    *reinterpret_cast<uint32_t*>(xl + s * kXP + p) = lo;
  }
  __syncthreads();

  // (Pp x Np) in strips of 16 channels x 32 states, spread over the warps.
  // A = x'^T (p, s) and B (s, n) are both stored s-major: ldmatrix.trans.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a_s = (lane % 8) + (lane / 16) * 8, a_p = ((lane / 8) % 2) * 8;
  const int t_s = (lane % 8) + ((lane / 8) % 2) * 8, t_n = (lane / 16) * 8;
  const int n_strips = Np / 32;
  float* out = a.states + (((int64_t)b * a.nc + c) * a.H + h) * a.P * a.N;
  for (int strip = warp; strip < (Pp / 16) * n_strips; strip += kMmaThreads / 32) {
    const int pt = 16 * (strip / n_strips), nt = 32 * (strip % n_strips);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s0 = 0; s0 < Qp; s0 += 16) {
      uint32_t ah[4], al[4], b0[4], b1[4];
      ldmatrix_x4_trans(ah, xh + (s0 + a_s) * kXP + pt + a_p);
      ldmatrix_x4_trans(al, xl + (s0 + a_s) * kXP + pt + a_p);
      ldmatrix_x4_trans(b0, bs + (s0 + t_s) * NP + nt + t_n);
      ldmatrix_x4_trans(b1, bs + (s0 + t_s) * NP + nt + 16 + t_n);
      mma_bf16(acc[0], ah, b0[0], b0[1]);
      mma_bf16(acc[0], al, b0[0], b0[1]);
      mma_bf16(acc[1], ah, b0[2], b0[3]);
      mma_bf16(acc[1], al, b0[2], b0[3]);
      mma_bf16(acc[2], ah, b1[0], b1[1]);
      mma_bf16(acc[2], al, b1[0], b1[1]);
      mma_bf16(acc[3], ah, b1[2], b1[3]);
      mma_bf16(acc[3], al, b1[2], b1[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nt + 8 * j + 2 * (lane % 4);      // N % 4 == 0: n and n + 1 both in
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = pt + lane / 4 + 8 * i;
        if (p < pw && n < a.N)
          *reinterpret_cast<float2*>(out + (int64_t)(p0 + p) * a.N + n) =
              make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
    }
  }
}

// In place over the chunks' states (B, nc, H, P, N), in order (REV false,
// the forward: S_c becomes h_prev_c) or in reverse (REV true, the backward:
// U_c becomes dH_c, the gradient of the state after chunk c): slot c
// receives the carry, then the carry becomes exp(L_Q,c) carry + the slot's
// old value. The carry starts at `init` (B, H, P, N), or 0 when null, and
// ends in `last`, unless null. Grid (ceil(P N / 4 / 256), H, Bsz), 4 values
// a thread.
template <bool REV>
__global__ void __launch_bounds__(256)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ lq,
                  const float* __restrict__ init, float* __restrict__ last, int H, int P, int N,
                  int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t PN = (int64_t)P * N;
  const int64_t e = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= PN) return;
  float4 hv = init ? *reinterpret_cast<const float4*>(init + ((int64_t)b * H + h) * PN + e)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t step = (int64_t)H * PN / 4;          // float4s from chunk c to c + 1
  const int64_t dstep = REV ? -step : step;
  float4* cur = reinterpret_cast<float4*>(states + ((int64_t)b * nc * H + h) * PN + e) +
                (REV ? (int64_t)(nc - 1) * step : 0);
  float4 sv = *cur;
  for (int i = 0; i < nc; ++i) {
    const int c = REV ? nc - 1 - i : i;
    const float4 next = i + 1 < nc ? cur[dstep] : sv;   // prefetch the next chunk's slot
    const float d = expf(lq[((int64_t)b * nc + c) * H + h]);
    *cur = hv;
    hv = make_float4(d * hv.x + sv.x, d * hv.y + sv.y, d * hv.z + sv.z, d * hv.w + sv.w);
    sv = next;
    cur += dstep;
  }
  if (last) *reinterpret_cast<float4*>(last + ((int64_t)b * H + h) * PN + e) = hv;
}

constexpr size_t chunk_scan_smem(int Qp, int N, int pb) {
  return 2 * sizeof(bf16) * (size_t)Qp * pad_n(N) + sizeof(bf16) * (size_t)Qp * kXP +
         2 * sizeof(bf16) * (size_t)pb * pad_n(N) + sizeof(float) * (2 * kQMax + 4);
}

// y for one (chunk, head, batch, slice of pb channels): warp w owns rows
// t in [16 w, 16 w + 16) and computes
//   y = M x + exp(L_t) C h_prev^T + D x,  M = (C B^T) o exp(L_t - L_s) o dt_s on s <= t
// with C B^T exact (bf16 in, fp32 out), M and h_prev split into hi + lo
// bf16. Grid (nc, H, Bsz * ceil(P / pb)).
__global__ void __launch_bounds__(kMmaThreads)
chunk_scan_kernel(Bf16Args a, int pb) {
  const int c = blockIdx.x, h = blockIdx.y;
  const int npb = (a.P + pb - 1) / pb;
  const int b = blockIdx.z / npb, p0 = (blockIdx.z % npb) * pb;
  const int pw = min(pb, a.P - p0), Pp = round_up(pw, 16);
  const int Qp = round_up(a.Q, 16), Np = round_up(a.N, 32), NP = pad_n(a.N);
  const int nv = min(a.Q, a.S - c * a.Q);
  const int64_t row0 = (int64_t)b * a.S + (int64_t)c * a.Q;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);     // [Qp][NP]  C
  bf16* bs = cs + Qp * NP;                           // [Qp][NP]  B
  bf16* xs = bs + Qp * NP;                           // [Qp][kXP] x slice
  bf16* hh = xs + Qp * kXP;                          // [pb][NP]  h_prev hi
  bf16* hl = hh + pb * NP;                           // [pb][NP]  h_prev lo
  float* dts = reinterpret_cast<float*>(hl + pb * NP);
  float* cum = dts + kQMax;
  float* wtot = cum + kQMax;

  const int64_t tok = (int64_t)c * a.Q;
  stage(cs, NP, a.Cm + b * a.csb + tok * a.css, a.css, Qp, nv, a.N, Np, a.vc);
  stage(bs, NP, a.Bm + b * a.bsb + tok * a.bss, a.bss, Qp, nv, a.N, Np, a.vb);
  stage(xs, kXP, a.x + b * a.xsb + tok * a.xss + (int64_t)h * a.P + p0, a.xss, Qp, nv, pw, Pp,
        a.vx);
  cp_async_commit();
  if (c > 0) {   // h_prev (written by state_pass) split into hi + lo, 4 values at a time
    const float* hp = a.states + (((int64_t)b * a.nc + c) * a.H + h) * a.P * a.N;
    const int n4 = Np / 4;
    for (int idx = threadIdx.x; idx < Pp * n4; idx += kMmaThreads) {
      const int p = idx / n4, n = 4 * (idx % n4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < pw && n < a.N) v = *reinterpret_cast<const float4*>(hp + (int64_t)(p0 + p) * a.N + n);
      uint2 hi, lo;
      split2(v.x, v.y, hi.x, lo.x);
      split2(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(hh + p * NP + n) = hi;
      *reinterpret_cast<uint2*>(hl + p * NP + n) = lo;
    }
  }
  chunk_cumsum(a.dt, row0, a.H, h, a.A[h], nv, dts, cum, wtot);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (16 * warp >= nv) return;                     // no valid row here; no sync follows
  const int a_row = lane % 16, a_col = (lane / 16) * 8;                         // A, plain
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;  // B, plain
  const int t_row = (lane % 8) + ((lane / 8) % 2) * 8, t_col = (lane / 16) * 8;  // B, trans
  const int t_lo = 16 * warp + lane / 4, t_hi = t_lo + 8;

  float cb[kQMax / 8][4];      // C B^T, rows t_lo / t_hi, 8 keys s per n-tile
  float y[kPB / 8][4];         // y, 8 channels per n-tile
#pragma unroll
  for (int j = 0; j < kQMax / 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kPB / 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;

  // one pass over the states n: C B^T on s <= t, and C h_prev^T
  for (int n0 = 0; n0 < Np; n0 += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, cs + (16 * warp + a_row) * NP + n0 + a_col);
#pragma unroll
    for (int jj = 0; jj < kQMax / 16; ++jj) {
      if (jj <= warp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bs + (16 * jj + b_row) * NP + n0 + b_col);
        mma_bf16(cb[2 * jj], af, bf[0], bf[1]);
        mma_bf16(cb[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
    if (c > 0) {
#pragma unroll
      for (int pp = 0; pp < kPB / 16; ++pp) {
        if (16 * pp < Pp) {
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, hh + (16 * pp + b_row) * NP + n0 + b_col);
          ldmatrix_x4(bl, hl + (16 * pp + b_row) * NP + n0 + b_col);
          mma_bf16(y[2 * pp], af, bh[0], bh[1]);
          mma_bf16(y[2 * pp], af, bl[0], bl[1]);
          mma_bf16(y[2 * pp + 1], af, bh[2], bh[3]);
          mma_bf16(y[2 * pp + 1], af, bl[2], bl[3]);
        }
      }
    }
  }
  const float L_lo = cum[t_lo], L_hi = cum[t_hi];
  if (c > 0) {
    const float e_lo = expf(L_lo), e_hi = expf(L_hi);
#pragma unroll
    for (int j = 0; j < kPB / 8; ++j) {
      y[j][0] *= e_lo; y[j][1] *= e_lo;
      y[j][2] *= e_hi; y[j][3] *= e_hi;
    }
  }

  // y += M x over the key blocks s0 = 16 kk <= the warp's rows; the decay
  // exp(L_t - L_s) is formed only where s <= t and s is a valid row
#pragma unroll
  for (int kk = 0; kk < kQMax / 16; ++kk) {
    if (kk <= warp) {
      float mv[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 16 * kk + 8 * half + 2 * (lane % 4) + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          const float Lt = e < 2 ? L_lo : L_hi;
          mv[half][e] = (s <= t && s < nv) ? cb[2 * kk + half][e] * expf(Lt - cum[s]) * dts[s]
                                           : 0.f;
        }
      uint32_t mh[4], ml[4];
      split2(mv[0][0], mv[0][1], mh[0], ml[0]);
      split2(mv[0][2], mv[0][3], mh[1], ml[1]);
      split2(mv[1][0], mv[1][1], mh[2], ml[2]);
      split2(mv[1][2], mv[1][3], mh[3], ml[3]);
#pragma unroll
      for (int pp = 0; pp < kPB / 16; ++pp) {
        if (16 * pp < Pp) {
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, xs + (16 * kk + t_row) * kXP + 16 * pp + t_col);
          mma_bf16(y[2 * pp], mh, bx[0], bx[1]);
          mma_bf16(y[2 * pp], ml, bx[0], bx[1]);
          mma_bf16(y[2 * pp + 1], mh, bx[2], bx[3]);
          mma_bf16(y[2 * pp + 1], ml, bx[2], bx[3]);
        }
      }
    }
  }

  // + D x in fp32, one cast; rows past the chunk's valid ones are not written
  const float dsk = a.D[h];
#pragma unroll
  for (int j = 0; j < kPB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = e < 2 ? t_lo : t_hi, p = 8 * j + 2 * (lane % 4) + (e & 1);
      if (t < nv && p < pw) {
        const float out = y[j][e] + dsk * __bfloat162float(xs[t * kXP + p]);
        a.y[(row0 + t) * a.H * a.P + (int64_t)h * a.P + p0 + p] = __float2bfloat16(out);
      }
    }
}

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

// the grid's z extent for slices of pb channels, and the slice width
// chunk_scan takes: half-width slices when full ones would leave SMs idle
// (132 on an H100)
inline int scan_slice(int nc, int H, int Bsz, int P) {
  return (long long)nc * H * Bsz * ((P + kPB - 1) / kPB) < 132 ? kPB / 2 : kPB;
}

int launch_bf16(const Bf16Args& a, cudaStream_t st) {
  static int dev_state = -1, dev_scan = -1;
  cudaError_t e = raise_smem_limit(chunk_state_kernel, chunk_state_smem(kQMax, kNMax), dev_state);
  if (e != cudaSuccess) return (int)e;
  e = raise_smem_limit(chunk_scan_kernel, chunk_scan_smem(kQMax, kNMax, kPB), dev_scan);
  if (e != cudaSuccess) return (int)e;
  const int Qp = round_up(a.Q, 16);
  chunk_state_kernel<<<dim3(a.nc, a.H, a.Bsz * ((a.P + kPB - 1) / kPB)), kMmaThreads,
                       chunk_state_smem(Qp, a.N), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int n4 = a.P * a.N / 4;
  state_pass_kernel<false><<<dim3((n4 + 255) / 256, a.H, a.Bsz), 256, 0, st>>>(
      a.states, a.lq, nullptr, a.state, a.H, a.P, a.N, a.nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int pb = scan_slice(a.nc, a.H, a.Bsz, a.P);
  chunk_scan_kernel<<<dim3(a.nc, a.H, a.Bsz * ((a.P + pb - 1) / pb)), kMmaThreads,
                      chunk_scan_smem(Qp, a.N, pb), st>>>(a, pb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split TF32 on the tensor cores (flash_attention.cu's helpers)
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero):
// the bits of cvt.rna.tf32.f32 for every input but NaN, in two integer
// operations (half the dropped range added, the 13 low bits cleared)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo to ~22 significant bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment in two TF32 terms. EXACT: the values are TF32 already
// (widened bf16), lo stays unset and its products are skipped.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <bool EXACT, int N>
__device__ __forceinline__ void set_frag(Frag<N>& f, int i, float x) {
  if constexpr (EXACT) {
    f.hi[i] = __float_as_uint(x);
  } else {
    split_tf32(x, f.hi[i], f.lo[i]);
  }
}

// d += A B in split TF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms
// first, into a zeroed accumulator that is then added to d in IEEE fp32;
// the terms of an exact operand's lo are skipped. The tensor cores' own
// fp32 accumulation rounds toward zero, and along a long K that bias
// reached 3.4e-4 of max|dA| at (2, 300, 4 heads of 64, N 128), three times
// IEEE fp32's error; one rounded add per k-step brings it back to fp32's.
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (!AX) mma_tf32(p, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!BX) mma_tf32(p, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(p, a.hi, b.hi[0], b.hi[1]);
  d[0] += p[0]; d[1] += p[1]; d[2] += p[2]; d[3] += p[3];
}

// Fragment loads from shared memory (g = lane / 4, t = lane % 4).
// A (16 x 8), element (row r, k) at p[r * rs + k * ks]: a0 (g, t),
// a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
template <bool EXACT, typename T>
__device__ __forceinline__ void load_a(Frag<4>& f, const T* p, int rs, int ks, int g, int t) {
  const T* q = p + g * rs + t * ks;
  set_frag<EXACT>(f, 0, to_f(q[0]));
  set_frag<EXACT>(f, 1, to_f(q[8 * rs]));
  set_frag<EXACT>(f, 2, to_f(q[4 * ks]));
  set_frag<EXACT>(f, 3, to_f(q[8 * rs + 4 * ks]));
}
// B (8 x 8), element (k, column n) at p[k * ks + n * ns]: b0 (t, g), b1 (t+4, g)
template <bool EXACT, typename T>
__device__ __forceinline__ void load_b(Frag<2>& f, const T* p, int ks, int ns, int g, int t) {
  const T* q = p + t * ks + g * ns;
  set_frag<EXACT>(f, 0, to_f(q[0]));
  set_frag<EXACT>(f, 1, to_f(q[4 * ks]));
}
// B whose k rows are permuted in pairs, for an A fed from the accumulator:
// k-index t is row 2t, k-index t+4 is row 2t+1
template <bool EXACT, typename T>
__device__ __forceinline__ void load_b_perm(Frag<2>& f, const T* p, int ks, int ns, int g,
                                            int t) {
  const T* q = p + 2 * t * ks + g * ns;
  set_frag<EXACT>(f, 0, to_f(q[0]));
  set_frag<EXACT>(f, 1, to_f(q[ks]));
}
// B from a tile split once into (hi, lo) pairs, element (k, n) at
// p[k * ks + n * ns]: no split per load
__device__ __forceinline__ void load_b_split(Frag<2>& f, const uint2* p, int ks, int ns, int g,
                                             int t) {
  const uint2* q = p + t * ks + g * ns;
  const uint2 v0 = q[0], v1 = q[4 * ks];
  f.hi[0] = v0.x; f.lo[0] = v0.y;
  f.hi[1] = v1.x; f.lo[1] = v1.y;
}
// A from an accumulator n-tile c (rows g, g+8; columns 2t, 2t+1) under the
// same permutation: column 2t is k-index t, column 2t+1 is k-index t+4
__device__ __forceinline__ void acc_to_a(Frag<4>& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

// ---------------------------------------------------------------------------
// fp32 forward: chunk_state_tf32_kernel<false, float> -> state_pass_kernel
// -> chunk_scan_tf32_kernel
// ---------------------------------------------------------------------------

// One chunk's state-shaped product, shared by the forward and the backward:
//   forward (BWD false): S_c = X'^T M, X = x, M = B, w_s = exp(L_Q - L_s) dt_s
//   backward (BWD true): U_c = X'^T M, X = dy, M = C, w_t = exp(L_t)
// with X'_s = w_s X_s formed in fp32. X is (B, S, H, P) with head stride P,
// M (B, S, N); both with batch and row strides.
template <typename T>
struct StateArgs {
  const T *X, *M;
  const float *dt, *A;
  float* out;            // (B, nc, H, P, N)
  float* lq;             // (B, nc, H): L_Q
  float* cum;            // (B, nc, H, Q): L, or null
  int S, H, P, N, Q, nc;
  int64_t xsb, xss, msb, mss;
  int vm;                // copy width of M
};

constexpr int kSXP = kPB + 8;     // fp32 pitch of X' rows: t kSXP + g on 32 banks
// M rows (t state_mp + g on 32 banks for fp32)
__host__ __device__ constexpr int state_mp(int N) { return round_up(N, 32) + 8; }

template <typename T>
constexpr size_t state_tf32_smem(int Qp, int N) {
  return sizeof(float) * (size_t)Qp * kSXP + sizeof(T) * (size_t)Qp * state_mp(N) +
         sizeof(float) * (3 * kQMax + 4);
}

// X'^T M for one (chunk, head, batch, slice of kPB channels), split TF32.
// Grid (nc, H, Bsz * ceil(P / kPB)); the output in (16 channel x 32 state)
// strips spread over the warps, K = the chunk's rows in steps of 8.
template <bool BWD, typename T>
__global__ void __launch_bounds__(kMmaThreads)
chunk_state_tf32_kernel(StateArgs<T> a) {
  constexpr bool kExact = std::is_same<T, bf16>::value;
  const int c = blockIdx.x, h = blockIdx.y;
  const int npb = (a.P + kPB - 1) / kPB;
  const int b = blockIdx.z / npb, p0 = (blockIdx.z % npb) * kPB;
  const int pw = min(kPB, a.P - p0), Pp = round_up(pw, 16);
  const int Qp = round_up(a.Q, 16), Np = round_up(a.N, 32), MP = state_mp(a.N);
  const int nv = min(a.Q, a.S - c * a.Q);
  const int64_t tok = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok;
  const int64_t bch = ((int64_t)b * a.nc + c) * a.H + h;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);    // [Qp][kSXP]  X' (fp32)
  T* ms = reinterpret_cast<T*>(xs + Qp * kSXP);      // [Qp][MP]    M
  float* dts = reinterpret_cast<float*>(ms + Qp * MP);
  float* cum = dts + kQMax;
  float* ws = cum + kQMax;
  float* wtot = ws + kQMax;

  stage(ms, MP, a.M + b * a.msb + tok * a.mss, a.mss, Qp, nv, a.N, Np, a.vm);
  cp_async_commit();
  chunk_cumsum(a.dt, row0, a.H, h, a.A[h], nv, dts, cum, wtot);
  __syncthreads();
  const float lq = cum[a.Q - 1];
  if (tid < kQMax) ws[tid] = BWD ? expf(cum[tid]) : expf(lq - cum[tid]) * dts[tid];
  if (p0 == 0) {
    if (tid == 0) a.lq[bch] = lq;
    if (BWD && tid < a.Q) a.cum[bch * a.Q + tid] = cum[tid];
  }
  __syncthreads();
  const T* xb = a.X + b * a.xsb + tok * a.xss + (int64_t)h * a.P + p0;
  for (int idx = tid; idx < Qp * Pp; idx += kMmaThreads) {
    const int s = idx / Pp, p = idx % Pp;
    xs[s * kSXP + p] = (s < nv && p < pw) ? ws[s] * to_f(xb[s * a.xss + p]) : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n_strips = Np / 32;
  float* out = a.out + bch * a.P * a.N;
  for (int strip = warp; strip < (Pp / 16) * n_strips; strip += kMmaThreads / 32) {
    const int pt = 16 * (strip / n_strips), nt = 32 * (strip % n_strips);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s0 = 0; s0 < Qp; s0 += 8) {
      Frag<4> fa;
      load_a<false>(fa, xs + s0 * kSXP + pt, 1, kSXP, g, t);      // A(p, s) = X'[s][p]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Frag<2> fb;
        load_b<kExact>(fb, ms + s0 * MP + nt + 8 * j, MP, 1, g, t);  // B(s, n) = M[s][n]
        mma3<false, kExact>(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nt + 8 * j + 2 * t;               // N % 4 == 0: n and n + 1 both in
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = pt + g + 8 * i;
        if (p < pw && n < a.N)
          *reinterpret_cast<float2*>(out + (int64_t)(p0 + p) * a.N + n) =
              make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
    }
  }
}

__host__ __device__ constexpr int scan_cp(int N) { return round_up(N, 32) + 4; }

constexpr size_t scan_tf32_smem(int Qp, int N, int pb) {
  return sizeof(float) * (2 * (size_t)Qp * scan_cp(N) + (size_t)Qp * (pb + 4) +
                          (size_t)pb * scan_cp(N) + 2 * kQMax + 4);
}

constexpr int kScanThreads = 512;    // 16 warps: 8 row strips x 2 halves of their keys

// y for one (chunk, head, batch, slice of pb channels), fp32 in split TF32:
//   y = M x + exp(L_t) C h_prev^T + D x,  M = (C B^T) o exp(L_t - L_s) o dt_s on s <= t.
// Warp (i = warp % 8, kh = warp / 8) owns rows [16 i, 16 i + 16) and the
// kh-th half of their 8-key tiles (i + 1 of the 2 (i + 1) tiles s < 16 (i + 1)),
// so the causal triangle's work is split evenly between the two, and the
// kh-th half of the channels of C h_prev^T. Each keeps its C B^T tiles in
// registers, forms M there and feeds it back as the A fragment of M x; half
// 1 hands its partial y to half 0 through shared memory, which adds the two
// in that order, + D x, and writes each y once. C, B and h_prev rows are
// padded to N + 4 floats (g CP + t on 32 banks), x rows to pb + 4 (the
// permuted B fragment's 8 t + g). Grid (nc, H, Bsz * ceil(P / pb)).
__global__ void __launch_bounds__(kScanThreads, 1)
chunk_scan_tf32_kernel(FwdArgs<float> a, int pb) {
  const int c = blockIdx.x, h = blockIdx.y;
  const int npb = (a.P + pb - 1) / pb;
  const int b = blockIdx.z / npb, p0 = (blockIdx.z % npb) * pb;
  const int pw = min(pb, a.P - p0), Pp = round_up(pw, 16);
  const int Qp = round_up(a.Q, 16), Np = round_up(a.N, 32), CP = scan_cp(a.N), XP = pb + 4;
  const int nv = min(a.Q, a.S - c * a.Q);
  const int64_t tok = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);   // [Qp][CP]  C
  float* bs = cs + Qp * CP;                          // [Qp][CP]  B
  float* xs = bs + Qp * CP;                          // [Qp][XP]  x slice
  float* hs = xs + Qp * XP;                          // [pb][CP]  h_prev slice
  float* dts = hs + pb * CP;
  float* cum = dts + kQMax;
  float* wtot = cum + kQMax;
  float* ys = cs;                                    // [Qp][pb + 8] half 1's y, over C and B

  stage<float, kScanThreads>(cs, CP, a.Cm + b * a.csb + tok * a.css, a.css, Qp, nv, a.N, Np,
                             a.vc);
  stage<float, kScanThreads>(bs, CP, a.Bm + b * a.bsb + tok * a.bss, a.bss, Qp, nv, a.N, Np,
                             a.vb);
  stage<float, kScanThreads>(xs, XP, a.x + b * a.xsb + tok * a.xss + (int64_t)h * a.P + p0,
                             a.xss, Qp, nv, pw, Pp, a.vx);
  if (c > 0)     // h_prev, written by state_pass_kernel: contiguous rows of N floats
    stage<float, kScanThreads>(
        hs, CP, a.states + ((((int64_t)b * a.nc + c) * a.H + h) * a.P + p0) * a.N, a.N, Pp, pw,
        a.N, Np, 4);
  cp_async_commit();
  chunk_cumsum(a.dt, row0, a.H, h, a.A[h], nv, dts, cum, wtot);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i = warp & 7, kh = warp >> 3;
  const bool live = 16 * i < nv;                   // the strip has a valid row
  const int nk = i + 1, k0 = kh * nk;              // this warp's 8-key tiles: k0 .. k0 + nk - 1
  const int t_lo = 16 * i + g, t_hi = t_lo + 8;

  float cb[kQMax / 16][4];     // C B^T of the warp's key tiles, rows t_lo / t_hi
  float y[kPB / 8][4];         // y, 8 channels per n-tile
#pragma unroll
  for (int j = 0; j < kQMax / 16; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kPB / 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;

  // one pass over the states n: C B^T on the warp's key tiles, and C
  // h_prev^T on its half of the channels
  if (live) {
    for (int n0 = 0; n0 < Np; n0 += 8) {
      Frag<4> fa;
      load_a<false>(fa, cs + 16 * i * CP + n0, CP, 1, g, t);          // A(t, n) = C[t][n]
#pragma unroll
      for (int jj = 0; jj < kQMax / 16; ++jj) {
        if (jj < nk) {
          Frag<2> fb;
          load_b<false>(fb, bs + 8 * (k0 + jj) * CP + n0, 1, CP, g, t);  // B(n, s) = B[s][n]
          mma3<false, false>(cb[jj], fa, fb);
        }
      }
      if (c > 0) {
#pragma unroll
        for (int j = 0; j < kPB / 8; ++j) {
          if ((j >> 2) == kh && 8 * j < Pp) {
            Frag<2> fb;
            load_b<false>(fb, hs + 8 * j * CP + n0, 1, CP, g, t);      // B(n, p) = h_prev[p][n]
            mma3<false, false>(y[j], fa, fb);
          }
        }
      }
    }
  }
  __syncthreads();             // every warp is done with C and B: their rows take ys

  if (live) {
    const float L_lo = cum[t_lo], L_hi = cum[t_hi];
    if (c > 0) {
      const float e_lo = expf(L_lo), e_hi = expf(L_hi);
#pragma unroll
      for (int j = 0; j < kPB / 8; ++j) {
        y[j][0] *= e_lo; y[j][1] *= e_lo;
        y[j][2] *= e_hi; y[j][3] *= e_hi;
      }
    }
    // y += M x over the warp's key tiles: M formed in registers (the
    // exponent only where s <= t and s is a valid row) and fed back as the A
    // fragment, x's rows read in the permuted order
#pragma unroll
    for (int jj = 0; jj < kQMax / 16; ++jj) {
      if (jj < nk) {
        const int kk = k0 + jj;
        float mv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 8 * kk + 2 * t + (e & 1);
          const int tt = e < 2 ? t_lo : t_hi;
          const float Lt = e < 2 ? L_lo : L_hi;
          mv[e] = (s <= tt && s < nv) ? cb[jj][e] * expf(Lt - cum[s]) * dts[s] : 0.f;
        }
        Frag<4> fm;
        acc_to_a(fm, mv);
#pragma unroll
        for (int j = 0; j < kPB / 8; ++j) {
          if (8 * j < Pp) {
            Frag<2> fb;
            load_b_perm<false>(fb, xs + 8 * kk * XP + 8 * j, XP, 1, g, t);  // B(s, p) = x[s][p]
            mma3<false, false>(y[j], fm, fb);
          }
        }
      }
    }
    if (kh == 1) {
#pragma unroll
      for (int j = 0; j < kPB / 8; ++j) {
        if (8 * j < Pp) {
          *reinterpret_cast<float2*>(ys + t_lo * (pb + 8) + 8 * j + 2 * t) =
              make_float2(y[j][0], y[j][1]);
          *reinterpret_cast<float2*>(ys + t_hi * (pb + 8) + 8 * j + 2 * t) =
              make_float2(y[j][2], y[j][3]);
        }
      }
    }
  }
  __syncthreads();
  if (!live || kh == 1) return;

  // half 0's y + half 1's, + D x in fp32; rows past the chunk's valid ones
  // are not written
  const float dsk = a.D[h];
#pragma unroll
  for (int j = 0; j < kPB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = e < 2 ? t_lo : t_hi, p = 8 * j + 2 * t + (e & 1);
      if (tt < nv && p < pw)
        a.y[(row0 + tt) * a.H * a.P + (int64_t)h * a.P + p0 + p] =
            (y[j][e] + ys[tt * (pb + 8) + p]) + dsk * xs[tt * XP + p];
    }
}

int launch_fp32(const FwdArgs<float>& a, cudaStream_t st) {
  static int dev_state = -1, dev_scan = -1;
  cudaError_t e = raise_smem_limit(chunk_state_tf32_kernel<false, float>,
                                   state_tf32_smem<float>(kQMax, kNMax), dev_state);
  if (e != cudaSuccess) return (int)e;
  e = raise_smem_limit(chunk_scan_tf32_kernel, scan_tf32_smem(kQMax, kNMax, kPB), dev_scan);
  if (e != cudaSuccess) return (int)e;
  const int Qp = round_up(a.Q, 16);
  const StateArgs<float> sa{a.x, a.Bm, a.dt, a.A, a.states, a.lq, nullptr,
                            a.S, a.H, a.P, a.N, a.Q, a.nc, a.xsb, a.xss, a.bsb, a.bss, a.vb};
  chunk_state_tf32_kernel<false, float><<<dim3(a.nc, a.H, a.Bsz * ((a.P + kPB - 1) / kPB)),
                                          kMmaThreads, state_tf32_smem<float>(Qp, a.N), st>>>(sa);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int n4 = a.P * a.N / 4;
  state_pass_kernel<false><<<dim3((n4 + 255) / 256, a.H, a.Bsz), 256, 0, st>>>(
      a.states, a.lq, nullptr, a.state, a.H, a.P, a.N, a.nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int pb = scan_slice(a.nc, a.H, a.Bsz, a.P);
  chunk_scan_tf32_kernel<<<dim3(a.nc, a.H, a.Bsz * ((a.P + pb - 1) / pb)), kScanThreads,
                           scan_tf32_smem(Qp, a.N, pb), st>>>(a, pb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward, both dtypes: split TF32 on the tensor cores
// ---------------------------------------------------------------------------
//
// Per (b, h) and chunk c, with L the inclusive cumsum of dt A over the chunk
// (the forward's warp scan, so the same bits), w_s = exp(L_Q - L_s) dt_s,
// M'_ts = (C_t.B_s) exp(L_t - L_s) on s <= t and dH_c the gradient of the
// state after chunk c (see ref.py's ssd_chunked_bwd_ref). Six launches:
//   1. ssd_bwd_cbds_kernel, grid (nc, B, G + 1): C B^T per chunk (block
//      z = G), and for each of G groups of heads the group's part of
//      dS_ts = sum_h exp(L_t - L_s) dt_s (dy_t.x_s), the heads in order;
//      16 warps, each with 16 rows and half of their key tiles (as
//      chunk_scan_tf32_kernel), K = P (or N) in passes of 64;
//   2. chunk_state_tf32_kernel<true, T>: U_c = sum_t exp(L_t) dy_t^T C_t to
//      dstates, L and L_Q to scratch;
//   3. state_pass_kernel<true>: in place over dstates, the chunks in
//      reverse, dH_c = dhT for the last, dH_c-1 = exp(L_Q,c) dH_c + U_c;
//   4. ssd_bwd_chunk_tf32_kernel, grid (nc, H, B), 16 warps: the head's
//      decay tile M' built once from C B^T, then per 64-channel pass, warp
//      (strip i, half) computes y = exp(L_t) C h_prev^T + M' (dt x) (dotted
//      with dy for dL), dxs = B dH^T and dxi = M'^T dy, and
//      dx = dt dxi + w dxs + D dy; then dL from the per-row dots, its
//      reverse cumsum (a fixed-order warp scan), ddt, and the chunk's parts
//      of dA and dD;
//   5. ssd_bwd_bc_tf32_kernel, grid (nc, B, 2 G): per group of heads, its
//      part of sum_h exp(L_t) dy_t h_prev (dC) or sum_h w_s x_s dH_c (dB),
//      K = the heads' channels, the state split into TF32 pairs once;
//   6. ssd_bwd_bc_sum_tf32_kernel, grid (nc, B, 2 x 64-state slices): the
//      groups' parts in order, plus dS B (dC) or dS^T C (dB) with dS summed
//      over the groups in order, one cast; and dA, dD over (b, chunk).
// No atomics: every sum has one order, so a rerun gives the same bits. The
// exponent is masked before exp (s <= t), so nothing overflows. Ragged rows
// (past S in the last chunk) read as zero (dt = 0) and are never written.
// For bf16, x, B, C and dy are exact in TF32, and the products of their lo
// terms are skipped.

template <typename T>
struct BwdArgs {
  const T *x, *Bm, *Cm, *dy;
  const float *dt, *A, *D, *h_prev, *dhT;
  T *dx, *dB, *dC;
  float *ddt, *dA, *dD;
  float *cb, *dsp, *cum, *lq, *dstates, *bcp, *dA_part, *dD_part;
  int Bsz, S, H, P, N, Q, nc, G;
  int64_t xsb, xss, bsb, bss, csb, css;
  int vx, vb, vc, vdy;

  // x, B, C through their strides; dt, dy, dx, ddt, dB, dC contiguous
  __device__ float xv(int b, int64_t tok, int h, int p) const {
    return to_f(x[b * xsb + tok * xss + (int64_t)h * P + p]);
  }
  __device__ float dyv(int b, int64_t tok, int h, int p) const {
    return to_f(dy[(((int64_t)b * S + tok) * H + h) * P + p]);
  }
  // index of (b, chunk c, head h) in the (B, nc, H, ...) scratch
  __device__ int64_t bch(int b, int c, int h) const { return ((int64_t)b * nc + c) * H + h; }
  // heads per group: group z sums heads [z hg, min(H, (z + 1) hg))
  __device__ int hg() const { return (H + G - 1) / G; }
};

// the sum of v over the block's NT threads, in one order, returned to every
// thread (all threads call it; red holds NT / 32 floats)
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < NT / 32; ++w) t += red[w];
  return t;
}

template <typename T>
__host__ __device__ constexpr int kpitch() { return kPB + 16 / (int)sizeof(T); }

template <typename T>
constexpr size_t cbds_smem(int Qp) {
  return 2 * sizeof(T) * (size_t)Qp * kpitch<T>() + sizeof(float) * (2 * kQMax + 4);
}

// Block z < G: group z's part of dS_ts = sum_h exp(L_t - L_s) dt_s (dy_t.x_s)
// into dsp (B, nc, G, Q, Q); block z = G: C_t.B_s into cb (B, nc, Q, Q).
// Warp (i = warp % 8, kh = warp / 8) owns rows t of [16 i, 16 i + 16) and
// the kh-th half of their 8-key tiles s < 16 (i + 1), so the causal
// triangle's work is even over the warps; the depth (P, or N) goes in
// passes of 64, each pass's partial product masked, decayed and added. Only
// the tiles on and below the diagonal are written (entries above it in a
// diagonal tile are 0 in dS).
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_cbds_kernel(BwdArgs<T> a) {
  constexpr bool kExact = std::is_same<T, bf16>::value;
  constexpr int KP = kpitch<T>();          // rows of a pass: g KP + t on 32 banks
  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const bool is_cb = z == a.G;
  const int K = is_cb ? a.N : a.P;
  const int nv = min(a.Q, a.S - c * a.Q), Qp = round_up(a.Q, 16);
  const int64_t tok0 = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int i = warp & 7, nk = i + 1, j0 = (warp >> 3) * nk;   // key tiles j0 .. j0 + nk - 1

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);       // [Qp][KP]  rows t: dy (or C) of the pass
  T* bs = as + Qp * KP;                          // [Qp][KP]  rows s: x (or B) of the pass
  float* dts = reinterpret_cast<float*>(bs + Qp * KP);
  float* cum = dts + kQMax;
  float* wtot = cum + kQMax;

  const int hb = is_cb ? 0 : z * a.hg();
  const int he = is_cb ? 1 : min(a.H, hb + a.hg());
  const bool live = 16 * i < nv;
  float ds[kQMax / 16][4];
#pragma unroll
  for (int j = 0; j < kQMax / 16; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;

  for (int h = hb; h < he; ++h) {
    for (int k0 = 0; k0 < K; k0 += kPB) {
      const int kw = min(kPB, K - k0), Kp = round_up(kw, 8);
      __syncthreads();                   // the previous pass is done with the tiles
      if (is_cb) {
        stage<T, kScanThreads>(as, KP, a.Cm + b * a.csb + tok0 * a.css + k0, a.css, Qp, nv, kw,
                               Kp, a.vc);
        stage<T, kScanThreads>(bs, KP, a.Bm + b * a.bsb + tok0 * a.bss + k0, a.bss, Qp, nv, kw,
                               Kp, a.vb);
      } else {
        stage<T, kScanThreads>(as, KP, a.dy + (row0 * a.H + h) * a.P + k0, (int64_t)a.H * a.P,
                               Qp, nv, kw, Kp, a.vdy);
        stage<T, kScanThreads>(bs, KP, a.x + b * a.xsb + tok0 * a.xss + (int64_t)h * a.P + k0,
                               a.xss, Qp, nv, kw, Kp, a.vx);
      }
      cp_async_commit();
      if (!is_cb && k0 == 0) chunk_cumsum(a.dt, row0, a.H, h, a.A[h], nv, dts, cum, wtot);
      cp_async_wait_all();
      __syncthreads();
      if (!live) continue;
#pragma unroll
      for (int jj = 0; jj < kQMax / 16; ++jj) {
        if (jj < nk) {
          const int j = j0 + jj;
          float cur[4] = {0.f, 0.f, 0.f, 0.f};
          for (int kk = 0; kk < Kp; kk += 8) {
            Frag<4> fa;
            Frag<2> fb;
            load_a<kExact>(fa, as + 16 * i * KP + kk, KP, 1, g, t);      // A(t, k)
            load_b<kExact>(fb, bs + 8 * j * KP + kk, 1, KP, g, t);       // B(k, s)
            mma3<kExact, kExact>(cur, fa, fb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tt = 16 * i + g + 8 * (e >> 1), s = 8 * j + 2 * t + (e & 1);
            ds[jj][e] += is_cb ? cur[e]
                               : (s <= tt && tt < nv) ? cur[e] * expf(cum[tt] - cum[s]) * dts[s]
                                                      : 0.f;
          }
        }
      }
    }
  }
  if (!live) return;
  float* out = is_cb ? a.cb + ((int64_t)b * a.nc + c) * a.Q * a.Q
                     : a.dsp + (((int64_t)b * a.nc + c) * a.G + z) * a.Q * a.Q;
#pragma unroll
  for (int jj = 0; jj < kQMax / 16; ++jj) {
    if (jj < nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = 16 * i + g + 8 * (e >> 1), s = 8 * (j0 + jj) + 2 * t + (e & 1);
        if (tt < a.Q && s < a.Q) out[(int64_t)tt * a.Q + s] = ds[jj][e];
      }
    }
  }
}

constexpr int kChunkThreads = 512;   // 16 warps: 8 row strips x 2 channel halves
constexpr int kBXP = kPB + 8;        // rows of dt x and dy: t kBXP + g on 32 banks

template <typename T>
constexpr size_t chunk_bwd_smem(int Qp, int N) {
  return sizeof(float) * (size_t)Qp * (Qp + 4) +
         sizeof(T) * (size_t)Qp * (round_up(N, 32) + 16 / sizeof(T)) +
         sizeof(float) * ((size_t)kPB * scan_cp(N) + (size_t)Qp * kBXP + 9 * kQMax +
                          kChunkThreads / 32);
}

// dx, ddt and the chunk's parts of dA and dD for one (chunk, head, batch).
// Warp (i = warp % 8, hf = warp / 8) owns rows [16 i, 16 i + 16) and
// channels [32 hf, 32 hf + 32) of each 64-channel pass; the causal walks of
// M' x (keys s <= t) and M'^T dy (t >= s) are complementary, so the warps'
// work is even.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads, 1)
ssd_bwd_chunk_tf32_kernel(BwdArgs<T> a) {
  constexpr bool kExact = std::is_same<T, bf16>::value;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = min(a.Q, a.S - c * a.Q), Qp = round_up(a.Q, 16), Np = round_up(a.N, 32);
  const int MP = Qp + 4;                            // M' rows
  const int CP = Np + 16 / (int)sizeof(T);          // C, then B, rows
  const int HP = scan_cp(a.N);                      // h_prev, then dH, rows (fp32)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int64_t tok0 = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok0;
  const int64_t base = a.bch(b, c, h);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ms = reinterpret_cast<float*>(smem_raw);   // [Qp][MP]   M'
  T* cbs = reinterpret_cast<T*>(ms + Qp * MP);      // [Qp][CP]   C, then B
  float* hs = reinterpret_cast<float*>(cbs + Qp * CP);   // [kPB][HP] h_prev, then dH
  float* xs = hs + kPB * HP;                        // [Qp][kBXP] dt x, then dy (as T)
  T* dys = reinterpret_cast<T*>(xs);
  float* dts = xs + Qp * kBXP;                      // [kQMax]    dt
  float* cum = dts + kQMax;                         // [kQMax]    L
  float* wv = cum + kQMax;                          // [kQMax]    w = exp(L_Q - L) dt
  float* rows = wv + kQMax;                         // [6][kQMax] row dots by channel half
  float* red = rows + 6 * kQMax;                    // [kChunkThreads / 32]

  if (tid < kQMax) {
    dts[tid] = tid < nv ? a.dt[(row0 + tid) * a.H + h] : 0.f;
    cum[tid] = tid < a.Q ? a.cum[base * a.Q + tid] : 0.f;
  }
  __syncthreads();
  const float lq = cum[a.Q - 1];
  if (tid < kQMax) wv[tid] = expf(lq - cum[tid]) * dts[tid];
  const float* cbc = a.cb + ((int64_t)b * a.nc + c) * a.Q * a.Q;
  for (int idx = tid; idx < Qp * Qp; idx += kChunkThreads) {
    const int tt = idx / Qp, s = idx % Qp;
    ms[tt * MP + s] = (s <= tt && tt < nv) ? cbc[tt * a.Q + s] * expf(cum[tt] - cum[s]) : 0.f;
  }

  const int i = warp & 7, hf = warp >> 3, pc = 32 * hf;
  const int r_lo = 16 * i + g, r_hi = r_lo + 8;
  const bool live = 16 * i < nv;
  const float dsk = a.D[h];
  float rp[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f}, rds[2] = {0.f, 0.f};
  float dd = 0.f, ddot = 0.f;            // dy . x and h_prev . dH over the thread's entries
  for (int p0 = 0; p0 < a.P; p0 += kPB) {
    const int pw = min(kPB, a.P - p0), Pp = round_up(pw, 16);
    const bool mine = live && pc < Pp;
    const int64_t st0 = (base * a.P + p0) * a.N;    // the pass's rows of h_prev and dH
    // phase 1: C, h_prev, dt x
    __syncthreads();                     // M' is built; the last pass is done with the tiles
    stage<T, kChunkThreads>(cbs, CP, a.Cm + b * a.csb + tok0 * a.css, a.css, Qp, nv, a.N, Np,
                            a.vc);
    if (c > 0) stage<float, kChunkThreads>(hs, HP, a.h_prev + st0, a.N, Pp, pw, a.N, Np, 4);
    cp_async_commit();
    for (int idx = tid; idx < Qp * Pp; idx += kChunkThreads) {
      const int s = idx / Pp, p = idx % Pp;
      xs[s * kBXP + p] = (s < nv && p < pw) ? dts[s] * a.xv(b, tok0 + s, h, p0 + p) : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (mine) {
      float y[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
      if (c > 0) {                       // C h_prev^T, then exp(L_t)
        for (int n0 = 0; n0 < Np; n0 += 8) {
          Frag<4> fa;
          load_a<kExact>(fa, cbs + 16 * i * CP + n0, CP, 1, g, t4);      // A(t, n) = C[t][n]
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (pc + 8 * j < Pp) {
              Frag<2> fb;
              load_b<false>(fb, hs + (pc + 8 * j) * HP + n0, 1, HP, g, t4);  // B(n, p)
              mma3<kExact, false>(y[j], fa, fb);
            }
          }
        }
        const float e_lo = expf(cum[r_lo]), e_hi = expf(cum[r_hi]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[j][0] *= e_lo; y[j][1] *= e_lo;
          y[j][2] *= e_hi; y[j][3] *= e_hi;
        }
      }
      for (int s0 = 0; s0 < 16 * (i + 1); s0 += 8) {              // + M' (dt x), s <= t
        Frag<4> fa;
        load_a<false>(fa, ms + 16 * i * MP + s0, MP, 1, g, t4);          // A(t, s) = M'[t][s]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (pc + 8 * j < Pp) {
            Frag<2> fb;
            load_b<false>(fb, xs + s0 * kBXP + pc + 8 * j, kBXP, 1, g, t4);  // B(s, p)
            mma3<false, false>(y[j], fa, fb);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r_lo : r_hi, p = pc + 8 * j + 2 * t4 + (e & 1);
          if (r < nv && p < pw) rp[e >> 1] += a.dyv(b, tok0 + r, h, p0 + p) * y[j][e];
        }
    }
    // phase 2: B, dH, dy
    __syncthreads();                     // done with C, h_prev and dt x
    stage<T, kChunkThreads>(cbs, CP, a.Bm + b * a.bsb + tok0 * a.bss, a.bss, Qp, nv, a.N, Np,
                            a.vb);
    stage<float, kChunkThreads>(hs, HP, a.dstates + st0, a.N, Pp, pw, a.N, Np, 4);
    stage<T, kChunkThreads>(dys, kBXP, a.dy + (row0 * a.H + h) * a.P + p0, (int64_t)a.H * a.P,
                            Qp, nv, pw, Pp, a.vdy);
    cp_async_commit();
    if (c > 0)
      for (int idx = tid; idx < pw * a.N; idx += kChunkThreads)
        ddot += a.h_prev[st0 + idx] * a.dstates[st0 + idx];
    cp_async_wait_all();
    __syncthreads();
    if (mine) {
      float dxs[4][4], dxi[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxs[j][e] = dxi[j][e] = 0.f;
      for (int n0 = 0; n0 < Np; n0 += 8) {                       // dxs = B dH^T
        Frag<4> fa;
        load_a<kExact>(fa, cbs + 16 * i * CP + n0, CP, 1, g, t4);        // A(s, n) = B[s][n]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (pc + 8 * j < Pp) {
            Frag<2> fb;
            load_b<false>(fb, hs + (pc + 8 * j) * HP + n0, 1, HP, g, t4);  // B(n, p) = dH[p][n]
            mma3<kExact, false>(dxs[j], fa, fb);
          }
        }
      }
      for (int t0 = 16 * i; t0 < Qp; t0 += 8) {                  // dxi = M'^T dy, t >= s
        Frag<4> fa;
        load_a<false>(fa, ms + t0 * MP + 16 * i, 1, MP, g, t4);          // A(s, t) = M'[t][s]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (pc + 8 * j < Pp) {
            Frag<2> fb;
            load_b<kExact>(fb, dys + t0 * kBXP + pc + 8 * j, kBXP, 1, g, t4);  // B(t, p)
            mma3<false, kExact>(dxi[j], fa, fb);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? r_lo : r_hi, p = pc + 8 * j + 2 * t4 + (e & 1);
          if (s < nv && p < pw) {
            const float dyv = to_f(dys[s * kBXP + p]), xv = a.xv(b, tok0 + s, h, p0 + p);
            a.dx[((row0 + s) * a.H + h) * a.P + p0 + p] =
                from_f<T>(dts[s] * dxi[j][e] + wv[s] * dxs[j][e] + dsk * dyv);
            rdi[e >> 1] += xv * dxi[j][e];
            rds[e >> 1] += xv * dxs[j][e];
            dd += dyv * xv;
          }
        }
    }
  }

  // the row dots: the 4 lanes of a quad hold parts of rows r_lo and r_hi;
  // the two channel halves are added in order below
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rp[k] += __shfl_xor_sync(0xffffffffu, rp[k], off);
      rdi[k] += __shfl_xor_sync(0xffffffffu, rdi[k], off);
      rds[k] += __shfl_xor_sync(0xffffffffu, rds[k], off);
    }
  if (t4 == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = k ? r_hi : r_lo;
      rows[(0 + hf) * kQMax + r] = rp[k];
      rows[(2 + hf) * kQMax + r] = rdi[k];
      rows[(4 + hf) * kQMax + r] = rds[k];
    }
  }
  const float dD = block_sum<kChunkThreads>(dd, red);
  const float decay = expf(lq) * block_sum<kChunkThreads>(ddot, red);   // syncs: rows written
  // dL_t = dy.yi + exp(L_t) dy.yh - dt_t (x.dxi + exp(L_Q - L_t) x.dxs), and
  // at t = Q - 1 the state and chunk-decay terms
  float direct = 0.f, dL = 0.f, wx = 0.f;
  if (tid < kQMax) {
    const float plus = rows[tid] + rows[kQMax + tid];
    const float xdi = rows[2 * kQMax + tid] + rows[3 * kQMax + tid];
    const float xds = rows[4 * kQMax + tid] + rows[5 * kQMax + tid];
    const float tl = expf(lq - cum[tid]);
    direct = xdi + tl * xds;
    dL = plus - dts[tid] * direct;
    wx = tl * dts[tid] * xds;
  }
  const float state_term = block_sum<kChunkThreads>(wx, red);
  if (tid == a.Q - 1) dL += state_term + decay;
  // da_u = sum_{t >= u} dL_t: a suffix scan within each warp, then the
  // totals of the later warps in order
  float da = dL;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, da, off);
    if (lane + off < 32) da += u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = da;
  __syncthreads();
  if (tid < kQMax)
    for (int w2 = kQMax / 32 - 1; w2 > warp; --w2) da += red[w2];
  if (tid < nv) a.ddt[(row0 + tid) * a.H + h] = direct + a.A[h] * da;
  const float dA = block_sum<kChunkThreads>(tid < kQMax ? dts[tid] * da : 0.f, red);
  if (tid == 0) {
    a.dA_part[base] = dA;
    a.dD_part[base] = dD;
  }
}

constexpr int kAP = kPB + 4;          // rows of the A source: g kAP + t on 32 banks
// rows of the split state, in (hi, lo) pairs: a half-warp's 8-byte loads
// t SP + g fall on 32 banks
__host__ __device__ constexpr int bc_sp(int N) { return round_up(N, 32) + 4; }

constexpr size_t bc_smem(int Qp, int N) {
  return sizeof(float) * ((size_t)Qp * kAP + 2 * kQMax) + sizeof(uint2) * (size_t)kPB * bc_sp(N);
}

// Group grp's part of the state terms of dC (blockIdx.z even) or dB (odd):
//   dC_t: sum_h exp(L_t) sum_p dy_t[p] h_prev[p, :]
//   dB_s: sum_h w_s sum_p x_s[p] dH_c[p, :]
// over the group's heads in order, into bcp (2, B, nc, G, Q, N). Warp w
// owns rows [16 w, 16 w + 16) and every state n; K = the heads' channels,
// 64 per pass. Every warp reads all of a pass's state, so it is split into
// TF32 (hi, lo) once, as it is staged.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
ssd_bwd_bc_tf32_kernel(BwdArgs<T> a) {
  const int c = blockIdx.x, b = blockIdx.y, grp = blockIdx.z >> 1, is_db = blockIdx.z & 1;
  const int nv = min(a.Q, a.S - c * a.Q), Qp = round_up(a.Q, 16), Np = round_up(a.N, 32);
  const int SP = bc_sp(a.N);
  const int64_t tok0 = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);   // [Qp][kAP]  exp(L_t) dy_t or w_s x_s
  float* cum = as + Qp * kAP;                        // [kQMax]
  float* dts = cum + kQMax;                          // [kQMax]
  uint2* st = reinterpret_cast<uint2*>(dts + kQMax); // [kPB][SP]  h_prev or dH, split

  const bool live = 16 * warp < nv;
  float acc[kNMax / 8][4];
#pragma unroll
  for (int j = 0; j < kNMax / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int hb = grp * a.hg(), he = min(a.H, hb + a.hg());
  for (int h = hb; h < he; ++h) {
    const int64_t base = a.bch(b, c, h);
    for (int p0 = 0; p0 < a.P; p0 += kPB) {
      const int pw = min(kPB, a.P - p0), Pp = round_up(pw, 16);
      __syncthreads();                   // the previous pass is done with the tiles
      const float* sp = (is_db ? a.dstates : a.h_prev) + (base * a.P + p0) * a.N;
      for (int idx = tid; idx < Pp * Np / 4; idx += kMmaThreads) {
        const int p = idx / (Np / 4), n = 4 * (idx % (Np / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < pw && n < a.N) v = *reinterpret_cast<const float4*>(sp + (int64_t)p * a.N + n);
        uint2* d = st + p * SP + n;
        split_tf32(v.x, d[0].x, d[0].y);
        split_tf32(v.y, d[1].x, d[1].y);
        split_tf32(v.z, d[2].x, d[2].y);
        split_tf32(v.w, d[3].x, d[3].y);
      }
      if (p0 == 0 && tid < kQMax) {
        cum[tid] = tid < a.Q ? a.cum[base * a.Q + tid] : 0.f;
        dts[tid] = tid < nv ? a.dt[(row0 + tid) * a.H + h] : 0.f;
      }
      __syncthreads();
      const float lq = cum[a.Q - 1];
      for (int idx = tid; idx < Qp * Pp; idx += kMmaThreads) {
        const int r = idx / Pp, p = idx % Pp;
        float v = 0.f;
        if (r < nv && p < pw)
          v = is_db ? expf(lq - cum[r]) * dts[r] * a.xv(b, tok0 + r, h, p0 + p)
                    : expf(cum[r]) * a.dyv(b, tok0 + r, h, p0 + p);
        as[r * kAP + p] = v;
      }
      __syncthreads();
      if (!live) continue;
      for (int k0 = 0; k0 < Pp; k0 += 8) {
        Frag<4> fa;
        load_a<false>(fa, as + 16 * warp * kAP + k0, kAP, 1, g, t);      // A(r, p)
#pragma unroll
        for (int j = 0; j < kNMax / 8; ++j) {
          if (8 * j < Np) {
            Frag<2> fb;
            load_b_split(fb, st + k0 * SP + 8 * j, SP, 1, g, t);          // B(p, n)
            mma3<false, false>(acc[j], fa, fb);
          }
        }
      }
    }
  }
  if (!live) return;
  float* out = a.bcp + ((((int64_t)is_db * a.Bsz + b) * a.nc + c) * a.G + grp) * a.Q * a.N;
#pragma unroll
  for (int j = 0; j < kNMax / 8; ++j) {
    const int n = 8 * j + 2 * t;          // N % 4 == 0: n and n + 1 both in
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 16 * warp + g + 8 * k;
      if (r < nv && n < a.N)
        *reinterpret_cast<float2*>(out + (int64_t)r * a.N + n) =
            make_float2(acc[j][2 * k], acc[j][2 * k + 1]);
    }
  }
}

constexpr int kNS = 64;               // states per block of the final dB / dC kernel
constexpr int kSBP = kNS + 8;         // rows of its B or C slice: t kSBP + g on 32 banks

template <typename T>
constexpr size_t bc_sum_smem(int Qp) {
  return sizeof(float) * (size_t)Qp * (Qp + 4) + sizeof(T) * (size_t)Qp * kSBP;
}

// dC (blockIdx.z even) or dB (odd) for states [64 (z / 2), 64 (z / 2) + 64):
//   dC_t = sum_g part_g[t] + sum_{s<=t} dS_ts B_s
//   dB_s = sum_g part_g[s] + sum_{t>=s} dS_ts C_t
// with dS summed over the G groups in order; one cast, rows < nv written.
// Warp w owns rows [16 w, 16 w + 16). The blocks of (c, b) = (0, 0) with
// z < 2 also sum dA (even) or dD (odd) over (b, chunk) in order.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
ssd_bwd_bc_sum_tf32_kernel(BwdArgs<T> a) {
  constexpr bool kExact = std::is_same<T, bf16>::value;
  constexpr int BP = kSBP;
  const int c = blockIdx.x, b = blockIdx.y, is_db = blockIdx.z & 1, n0 = kNS * (blockIdx.z >> 1);
  const int nv = min(a.Q, a.S - c * a.Q), Qp = round_up(a.Q, 16), DP = Qp + 4;
  const int nw = min(kNS, a.N - n0);
  const int64_t tok0 = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (c == 0 && b == 0 && n0 == 0) {
    const float* part = is_db ? a.dD_part : a.dA_part;
    for (int h = tid; h < a.H; h += kMmaThreads) {
      float sum = 0.f;
      for (int k = 0; k < a.Bsz * a.nc; ++k) sum += part[(int64_t)k * a.H + h];
      (is_db ? a.dD : a.dA)[h] = sum;
    }
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dss = reinterpret_cast<float*>(smem_raw);  // [Qp][DP]  dS, s <= t < nv
  T* ms = reinterpret_cast<T*>(dss + Qp * DP);      // [Qp][BP]  B (dC) or C (dB), the slice
  if (is_db)
    stage(ms, BP, a.Cm + b * a.csb + tok0 * a.css + n0, a.css, Qp, nv, nw, kNS, a.vc);
  else
    stage(ms, BP, a.Bm + b * a.bsb + tok0 * a.bss + n0, a.bss, Qp, nv, nw, kNS, a.vb);
  cp_async_commit();
  const float* dsp = a.dsp + ((int64_t)b * a.nc + c) * a.G * a.Q * a.Q;
  for (int idx = tid; idx < Qp * Qp; idx += kMmaThreads) {
    const int tt = idx / Qp, s = idx % Qp;
    float v = 0.f;
    if (s <= tt && tt < nv)
      for (int k = 0; k < a.G; ++k) v += dsp[((int64_t)k * a.Q + tt) * a.Q + s];
    dss[tt * DP + s] = v;
  }
  cp_async_wait_all();
  __syncthreads();
  if (16 * warp >= nv) return;                     // no valid row here; no sync follows

  // the state terms: the groups' parts in order
  const float* part = a.bcp + (((int64_t)is_db * a.Bsz + b) * a.nc + c) * a.G * a.Q * a.N;
  float acc[kNS / 8][4];
#pragma unroll
  for (int j = 0; j < kNS / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k = 0; k < a.G; ++k) {
    const float* pk = part + (int64_t)k * a.Q * a.N;
#pragma unroll
    for (int j = 0; j < kNS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
        if (r < nv && n < a.N) acc[j][e] += pk[(int64_t)r * a.N + n];
      }
  }
  if (!is_db) {                          // dC_t += sum_{s <= t} dS_ts B_s
    for (int s0 = 0; s0 < 16 * (warp + 1); s0 += 8) {
      Frag<4> fa;
      load_a<false>(fa, dss + 16 * warp * DP + s0, DP, 1, g, t);       // A(t, s) = dS[t][s]
#pragma unroll
      for (int j = 0; j < kNS / 8; ++j) {
        Frag<2> fb;
        load_b<kExact>(fb, ms + s0 * BP + 8 * j, BP, 1, g, t);           // B(s, n) = B[s][n]
        mma3<false, kExact>(acc[j], fa, fb);
      }
    }
  } else {                               // dB_s += sum_{t >= s} dS_ts C_t
    for (int t0 = 16 * warp; t0 < Qp; t0 += 8) {
      Frag<4> fa;
      load_a<false>(fa, dss + t0 * DP + 16 * warp, 1, DP, g, t);       // A(s, t) = dS[t][s]
#pragma unroll
      for (int j = 0; j < kNS / 8; ++j) {
        Frag<2> fb;
        load_b<kExact>(fb, ms + t0 * BP + 8 * j, BP, 1, g, t);           // B(t, n) = C[t][n]
        mma3<false, kExact>(acc[j], fa, fb);
      }
    }
  }
  T* out = (is_db ? a.dB : a.dC) + row0 * a.N;
#pragma unroll
  for (int j = 0; j < kNS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
      if (r < nv && n < a.N) out[(int64_t)r * a.N + n] = from_f<T>(acc[j][e]);
    }
}

// The launches both routes share: ssd_bwd_cbds_kernel (C B^T and the head
// groups' parts of dS), chunk_state_tf32_kernel<true> (U_c, L, L_Q) and
// state_pass_kernel<true> (dH in place of U)
template <typename T>
cudaError_t launch_bwd_front(const BwdArgs<T>& a, cudaStream_t st) {
  static int dev_cbds = -1, dev_state = -1;
  cudaError_t e;
  if ((e = raise_smem_limit(ssd_bwd_cbds_kernel<T>, cbds_smem<T>(kQMax), dev_cbds)) ||
      (e = raise_smem_limit(chunk_state_tf32_kernel<true, T>, state_tf32_smem<T>(kQMax, kNMax),
                            dev_state)))
    return e;
  const int Qp = round_up(a.Q, 16);
  ssd_bwd_cbds_kernel<T><<<dim3(a.nc, a.Bsz, a.G + 1), kScanThreads, cbds_smem<T>(Qp), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const StateArgs<T> sa{a.dy, a.Cm, a.dt, a.A, a.dstates, a.lq, a.cum,
                        a.S, a.H, a.P, a.N, a.Q, a.nc,
                        (int64_t)a.S * a.H * a.P, (int64_t)a.H * a.P, a.csb, a.css, a.vc};
  chunk_state_tf32_kernel<true, T><<<dim3(a.nc, a.H, a.Bsz * ((a.P + kPB - 1) / kPB)),
                                     kMmaThreads, state_tf32_smem<T>(Qp, a.N), st>>>(sa);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n4 = a.P * a.N / 4;
  state_pass_kernel<true><<<dim3((n4 + 255) / 256, a.H, a.Bsz), 256, 0, st>>>(
      a.dstates, a.lq, a.dhT, nullptr, a.H, a.P, a.N, a.nc);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdArgs<T>& a, cudaStream_t st) {
  static int dev_chunk = -1, dev_bc = -1, dev_sum = -1;
  cudaError_t e;
  if ((e = raise_smem_limit(ssd_bwd_chunk_tf32_kernel<T>, chunk_bwd_smem<T>(kQMax, kNMax),
                            dev_chunk)) ||
      (e = raise_smem_limit(ssd_bwd_bc_tf32_kernel<T>, bc_smem(kQMax, kNMax), dev_bc)) ||
      (e = raise_smem_limit(ssd_bwd_bc_sum_tf32_kernel<T>, bc_sum_smem<T>(kQMax), dev_sum)))
    return (int)e;
  if ((e = launch_bwd_front(a, st)) != cudaSuccess) return (int)e;
  const int Qp = round_up(a.Q, 16);
  ssd_bwd_chunk_tf32_kernel<T><<<dim3(a.nc, a.H, a.Bsz), kChunkThreads,
                                 chunk_bwd_smem<T>(Qp, a.N), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_bc_tf32_kernel<T><<<dim3(a.nc, a.Bsz, 2 * a.G), kMmaThreads, bc_smem(Qp, a.N), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_bc_sum_tf32_kernel<T><<<dim3(a.nc, a.Bsz, 2 * ((a.N + kNS - 1) / kNS)), kMmaThreads,
                                  bc_sum_smem<T>(Qp), st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 backward on Hopper: ssd_bwd_dx_kernel, ssd_bwd_dbc_kernel and
// ssd_bwd_dbc_sum_kernel in place of ssd_bwd_chunk_tf32_kernel,
// ssd_bwd_bc_tf32_kernel and ssd_bwd_bc_sum_tf32_kernel, by a fixed rule
// (bwd_on_hopper: fp32, Q = 128, P = 64, N = 64 or 128, x's pointer and
// strides 16-byte aligned for TMA; not a fallback); the three launches
// before them are the other route's.
//
// What bounds them on this card: at the training shapes the dx kernel moves
// ~85-120 MB and does ~4-6 GFLOP (x3 in split TF32), the dB/dC stage about
// as much; both bounds are ~0.02-0.04 ms, so the kernels are held by the
// tensor cores' issue and the latency of each block's phases, not by
// bytes (PERF.md). Every product is TF32 wgmma m64nNk8 in split TF32 (lo_a
// hi_b, hi_a lo_b, hi_a hi_b; `wgmma3`): A from registers, each value
// loaded from global memory (C, B, C B^T: shared by a chunk's heads, in L2)
// and split once per product by the one thread that holds it, 8 k-steps'
// values at a time ahead of their products (`product`); B from shared
// memory, K-major with the 128-byte swizzle (TF32 wgmma reads no other), in
// two TF32 terms split once per block. Tiles arrive by TMA into
// mbarrier-guarded shared memory; a tile that TMA writes K-major is split
// in place or into its slot (hi, lo), an MN-major one (x and dy as the B of
// M' (dt x) and M'^T dy) is transposed as it is split. Each product runs
// from a zeroed accumulator, whose tensor-core sum rounds toward zero, and
// joins the others by IEEE fp32 operations: the rounding points that
// tests/test_torch_ssd_tf32.py emulates (`emulated_hopper_backward`).
//
//   * ssd_bwd_dx_kernel<N>, grid (nc, H, B), two warpgroups of 64 rows
//     each: dx, ddt and the chunk's parts of dA and dD, as
//     ssd_bwd_chunk_tf32_kernel. Phase 1: y = exp(L_t) C h_prev^T + (M'
//     dt) x with h_prev split in place (no load at chunk 0, whose entering
//     state is zero) and x transposed; phase 2: dxs = B dH^T, dxi = M'^T
//     dy with dH and dy staged likewise (their TMA loads in flight during
//     phase 1). M' = (C B^T) o exp(L_t - L_s) on s <= t is formed in
//     registers from cb as each A fragment is made, the decay by the SFU's
//     2^x on L in log2 units. The causal walks of M' x (keys s <= t) and
//     M'^T dy (t >= s) are complementary, so the two warpgroups (rows 0-63,
//     64-127) do even work over the kernel.
//   * ssd_bwd_dbc_kernel<N>, grid (nc, B, 2 G + 1): block z < 2 G the state
//     term of dC (z even) or dB (odd) over the heads of group z / 2,
//     transposed (rows n): per head A = h_prev^T or dH^T, B = dy or x as
//     TMA writes them (double-buffered, the next head's load and A values
//     in flight during this head's products), the head's product scaled by
//     exp(L_t) or w_s and added in IEEE fp32, heads in order; block z = 2 G
//     dS summed over the G groups in order (read once per chunk), split as
//     it is for dS B, then transposed from its summed copy for dS^T C. Parts
//     to bcp (2, B, nc, G + 1, Q, N).
//   * ssd_bwd_dbc_sum_kernel, grid (Q N / 1024, B nc, 2): dC and dB as the
//     G + 1 parts in order; and dA, dD over (b, chunk) in order.
// No atomics: every sum has one order, so a rerun gives the same bits.
// ---------------------------------------------------------------------------

constexpr int kHQ = 128;            // the route's chunk
constexpr int kHP = 64;             // the route's head channels
constexpr int kHThreads = 256;      // two warpgroups

// float offset of element (r, k) of an fp32 tile of R rows as TMA writes it
// with the 128-byte swizzle: [k / 32][R][32], the 16-byte chunk c of row r
// at chunk c ^ (r % 8). A K-major B operand (rows: the output columns, k:
// the reduction) has this layout.
__device__ __forceinline__ int swz(int R, int r, int k) {
  return (k >> 5) * R * 32 + r * 32 + ((((k >> 2) & 7) ^ (r & 7)) << 2) + (k & 3);
}

// shared address of k-step kk (columns 8 kk .. 8 kk + 7) of such a tile,
// from row r0 (a multiple of 8): a wgmma B descriptor's start
__device__ __forceinline__ uint32_t b_at(const float* tile, int R, int kk, int r0) {
  return hopper::smem_u32(tile) + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32;
}

// d (+)= A B in split TF32 by three wgmma: lo_a hi_b, hi_a lo_b, hi_a hi_b;
// bh and bl address B's hi and lo tiles
template <int NW>
__device__ __forceinline__ void wgmma3(float (&d)[NW / 2], const Frag<4>& f, uint32_t bh,
                                       uint32_t bl, int accumulate) {
  using namespace hopper;
  wgmma_rs_tf32<NW>(d, f.lo, desc_sw128(bh, 16, 1024), accumulate);
  wgmma_rs_tf32<NW>(d, f.hi, desc_sw128(bl, 16, 1024), 1);
  wgmma_rs_tf32<NW>(d, f.hi, desc_sw128(bh, 16, 1024), 1);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx: 2 ulp; x <= 0 here, the
// decays of M' in log2 units)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// an A fragment (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4))
// split from four fp32 values
__device__ __forceinline__ void frag_of(Frag<4>& f, float v0, float v1, float v2, float v3) {
  split_tf32(v0, f.hi[0], f.lo[0]);
  split_tf32(v1, f.hi[1], f.lo[1]);
  split_tf32(v2, f.hi[2], f.lo[2]);
  split_tf32(v3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void split4(float4 v, uint4& h, uint4& l) {
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
}

// from `src` (or in place when src == hi): hi = tf32(v), lo = tf32(v - hi),
// n4 float4s, same layout
__device__ __forceinline__ void split_tile(const float* src, float* hi, float* lo, int n4) {
  for (int i = threadIdx.x; i < n4; i += kHThreads) {
    uint4 h, l;
    split4(reinterpret_cast<const float4*>(src)[i], h, l);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// the activation tile as TMA writes it (rows s: 128, columns p: 64)
// transposed into a B operand (rows p, K = s) in two TF32 terms: a thread
// reads four rows of one column and writes them as one 16-byte chunk of
// each term
__device__ __forceinline__ void transpose_split(const float* raw, float* hi, float* lo) {
  for (int i = threadIdx.x; i < kHQ * kHP / 4; i += kHThreads) {
    const int p = (i >> 8) * 8 + (i & 7), s = 4 * ((i >> 3) & 31);
    uint4 h, l;
    split4(make_float4(raw[swz(kHQ, s, p)], raw[swz(kHQ, s + 1, p)], raw[swz(kHQ, s + 2, p)],
                       raw[swz(kHQ, s + 3, p)]),
           h, l);
    const int o = swz(kHP, p, s);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// acc (+)= A B over k-steps [k0, k1) of 16 (multiples of 8): A's raw values
// loaded 8 k-steps at a time (ld(kk, v)) ahead of their products, each made
// into a fragment by mk(kk, v, f); B's hi and lo tiles of R rows from row r0.
// The first k-step starts the sum from zero. Up to three k-steps in flight
// (unrolled: the registers of a fragment stay fixed while its wgmma is);
// WAIT false leaves the last ones in flight for a later wgmma_wait.
template <int NW, bool WAIT = true, typename Ld, typename Mk>
__device__ __forceinline__ void product(float (&acc)[NW / 2], int k0, int k1, const float* bh,
                                        const float* bl, int R, int r0, Ld ld, Mk mk) {
  using namespace hopper;
  float v[8][4];
  fence_regs(acc);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (8 * half < k0 || 8 * half >= k1) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) ld(8 * half + k, v[k]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int kk = 8 * half + k;
      Frag<4> f;
      mk(kk, v[k], f);
      wgmma_fence();
      wgmma3<NW>(acc, f, b_at(bh, R, kk, r0), b_at(bl, R, kk, r0), kk > k0);
      wgmma_commit();
      wgmma_wait<2>();
    }
  }
  if constexpr (WAIT) {
    wgmma_wait<0>();
    fence_regs(acc);
  }
}

template <int NS>
struct DxCfg {
  static constexpr int SB = NS * kHP * 4;     // bytes of a state tile (one term)
  static constexpr int XB = kHQ * kHP * 4;    // bytes of an activation tile
  static constexpr size_t smem = 1024 + 3 * (size_t)SB + 3 * (size_t)XB +
                                 4 * (8 * kHQ + 32) + 8 * 4;
};

// dx, ddt and the chunk's parts of dA and dD for one (chunk, head, batch)
// on the Hopper route. tmx, tmdy map x and dy as (P, H, S, B), boxes of 32
// channels x 128 rows; tmh, tmd map h_prev and dH as (N, B nc H P), boxes of
// 32 states x 64 channels. Warpgroup wg owns rows [64 wg, 64 wg + 64) (t in
// phase 1, s in phase 2) and every channel, its warp w rows 16 w + lane / 4
// (+ 8).
template <int NS>
__global__ void __launch_bounds__(kHThreads, 1)
ssd_bwd_dx_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmdy,
                  const __grid_constant__ CUtensorMap tmh, const __grid_constant__ CUtensorMap tmd,
                  BwdArgs<float> a) {
  using namespace hopper;
  using C = DxCfg<NS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* hbh = reinterpret_cast<float*>(base);  // [NS/32][64][32] h_prev, then dH: hi
  float* hbl = hbh + C::SB / 4;                 //                                  lo
  float* rawd = hbl + C::SB / 4;                // dH as TMA writes it
  float* xth = rawd + C::SB / 4;                // [4][64][32] x^T, then dy^T: hi
  float* xtl = xth + C::XB / 4;                 //                               lo
  float* rawx = xtl + C::XB / 4;                // [2][128][32] x, then dy, as TMA writes them
  float* dts = rawx + C::XB / 4;                // [kHQ] dt
  float* cum = dts + kHQ;                       // [kHQ] L
  float* wv = cum + kHQ;                        // [kHQ] w = exp(L_Q - L) dt
  float* el = wv + kHQ;                         // [kHQ] exp(L)
  float* l2 = el + kHQ;                         // [kHQ] L log2(e)
  float* rows = l2 + kHQ;                       // [3][kHQ] dy.y, x.dxi, x.dxs per row
  float* red = rows + 3 * kHQ;                  // [32] the warps' parts of the tail's sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 32);   // h_prev, x, dH, dy landed

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int nv = min(kHQ, a.S - c * kHQ);
  const int64_t tok0 = (int64_t)c * kHQ, row0 = (int64_t)b * a.S + tok0;
  const int64_t bch = a.bch(b, c, h);
  const int srow = (int)(bch * kHP);            // the state maps' first row

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    if (c > 0) {                                // the state entering chunk 0 is zero
      mbar_expect_tx(bar, C::SB);
      for (int k = 0; k < NS / 32; ++k) tma_load_2d(hbh + k * kHP * 32, &tmh, bar, 32 * k, srow);
    }
    mbar_expect_tx(bar + 1, C::XB);
    for (int k = 0; k < 2; ++k)
      tma_load_4d(rawx + k * kHQ * 32, &tmx, bar + 1, 32 * k, h, (int)tok0, b);
    mbar_expect_tx(bar + 2, C::SB);
    for (int k = 0; k < NS / 32; ++k) tma_load_2d(rawd + k * kHP * 32, &tmd, bar + 2, 32 * k, srow);
  }
  if (tid < kHQ) {
    dts[tid] = tid < nv ? a.dt[(row0 + tid) * a.H + h] : 0.f;
    cum[tid] = a.cum[bch * kHQ + tid];
  }
  __syncthreads();
  const float lq = cum[kHQ - 1];
  if (tid < kHQ) {
    wv[tid] = expf(lq - cum[tid]) * dts[tid];
    el[tid] = expf(cum[tid]);
    l2[tid] = cum[tid] * kLog2e;
  }

  // the thread's rows of the products (t in phase 1, s in phase 2); A from
  // global memory (C, B and cb are shared by the heads), the raw fragments'
  // values of 8 k-steps loaded at once (`product`)
  const int rlo = 64 * wg + 16 * (warp & 3) + g, rhi = rlo + 8;
  const bool vlo = rlo < nv, vhi = rhi < nv;
  const float* cbc = a.cb + ((int64_t)b * a.nc + c) * kHQ * kHQ;
  const float* Cr = a.Cm + b * a.csb + tok0 * a.css;
  const float* Br = a.Bm + b * a.bsb + tok0 * a.bss;
  // A(r, n) = M[r][n] for M = C or B (rows r < nv)
  auto rows_of = [&](const float* M, int64_t ms) {
    return [=](int kk, float (&v)[4]) {
      const int n = 8 * kk + t4;
      v[0] = vlo ? M[rlo * ms + n] : 0.f;
      v[1] = vhi ? M[rhi * ms + n] : 0.f;
      v[2] = vlo ? M[rlo * ms + n + 4] : 0.f;
      v[3] = vhi ? M[rhi * ms + n + 4] : 0.f;
    };
  };
  auto plain = [](int, const float (&v)[4], Frag<4>& f) { frag_of(f, v[0], v[1], v[2], v[3]); };

  float y[kHP / 2], acc[kHP / 2];               // accumulator layout: register 4 j + e at
                                                // row (e < 2 ? rlo : rhi), channel 8 j + 2 t4 + e % 2
  // phase 1: h_prev split in place, then y = exp(L_t) C h_prev^T left in
  // flight (the state entering chunk 0 is zero) while x is transposed and
  // split ...
  if (c > 0) {
    mbar_wait(bar, 0);
    split_tile(hbh, hbh, hbl, NS * kHP / 4);
    fence_proxy_async();
    __syncthreads();
    product<kHP, false>(acc, 0, NS / 8, hbh, hbl, kHP, 0, rows_of(Cr, a.css), plain);
  }
  mbar_wait(bar + 1, 0);
  transpose_split(rawx, xth, xtl);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {                               // dy into x's raw tile, while phase 1 runs
    mbar_expect_tx(bar + 3, C::XB);
    for (int k = 0; k < 2; ++k)
      tma_load_4d(rawx + k * kHQ * 32, &tmdy, bar + 3, 32 * k, h, (int)tok0, b);
  }
#pragma unroll
  for (int i = 0; i < kHP / 2; ++i) y[i] = 0.f;
  if (c > 0) {
    wgmma_wait<0>();
    fence_regs(acc);
    const float elo = el[rlo], ehi = el[rhi];
#pragma unroll
    for (int i = 0; i < kHP / 2; ++i) y[i] = acc[i] * ((i & 2) ? ehi : elo);
  }
  // the state tile is free once both warpgroups' C h_prev^T is done:
  // warpgroup 1 says so on barrier 1 and goes on
  if (wg == 1) named_barrier_arrive(1, kHThreads);
  // ... + (M' dt) x over s < 64 (wg + 1): M'_ts dt_s formed where s <= t < nv
  {
    const float Llo = l2[rlo], Lhi = l2[rhi];
    auto ld = [&](int kk, float (&v)[4]) {
      const int s0 = 8 * kk + t4, s1 = s0 + 4;
      v[0] = vlo && s0 <= rlo ? cbc[rlo * kHQ + s0] : 0.f;
      v[1] = vhi && s0 <= rhi ? cbc[rhi * kHQ + s0] : 0.f;
      v[2] = vlo && s1 <= rlo ? cbc[rlo * kHQ + s1] : 0.f;
      v[3] = vhi && s1 <= rhi ? cbc[rhi * kHQ + s1] : 0.f;
    };
    // the exponent taken only where s <= t
    auto m = [&](float v, int t, float Lt, int s) {
      return s <= t ? v * exp2_approx(Lt - l2[s]) * dts[s] : 0.f;
    };
    auto mk = [&](int kk, const float (&v)[4], Frag<4>& f) {
      const int s0 = 8 * kk + t4, s1 = s0 + 4;
      frag_of(f, m(v[0], rlo, Llo, s0), m(v[1], rhi, Lhi, s0), m(v[2], rlo, Llo, s1),
              m(v[3], rhi, Lhi, s1));
    };
    product<kHP>(acc, 0, 8 * (wg + 1), xth, xtl, kHP, 0, ld, mk);
#pragma unroll
    for (int i = 0; i < kHP / 2; ++i) y[i] += acc[i];
  }

  float2 xe[kHP / 8][2];                       // x at the thread's entries, for the row dots
#pragma unroll
  for (int j = 0; j < kHP / 8; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = k ? rhi : rlo;
      xe[j][k] = s < nv ? *reinterpret_cast<const float2*>(a.x + b * a.xsb + (tok0 + s) * a.xss +
                                                          (int64_t)h * kHP + 8 * j + 2 * t4)
                        : make_float2(0.f, 0.f);
    }

  // dy . y per row (dy as TMA wrote it: ragged rows are zero)
  mbar_wait(bar + 3, 0);
  float rp[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kHP / 8; ++j) {
    const int p = 8 * j + 2 * t4;
    rp[0] += rawx[swz(kHQ, rlo, p)] * y[4 * j] + rawx[swz(kHQ, rlo, p + 1)] * y[4 * j + 1];
    rp[1] += rawx[swz(kHQ, rhi, p)] * y[4 * j + 2] + rawx[swz(kHQ, rhi, p + 1)] * y[4 * j + 3];
  }
  // phase 2's state tile: warpgroup 0, whose M' x walk is the shorter,
  // splits dH (and takes h_prev . dH, h_prev as its two terms: its value to
  // 2^-22) while warpgroup 1 finishes M' x; barrier 2 hands the tile on
  float ddot = 0.f;
  if (wg == 0) {
    named_barrier_sync(1, kHThreads);           // warpgroup 1 is done with h_prev
    mbar_wait(bar + 2, 0);
    for (int i = tid; i < NS * kHP / 4; i += kHThreads / 2) {
      const float4 d = reinterpret_cast<const float4*>(rawd)[i];
      if (c > 0) {
        const float4 u = reinterpret_cast<const float4*>(hbh)[i];
        const float4 w = reinterpret_cast<const float4*>(hbl)[i];
        ddot += (u.x + w.x) * d.x + (u.y + w.y) * d.y + (u.z + w.z) * d.z + (u.w + w.w) * d.w;
      }
      uint4 hi, lo;
      split4(d, hi, lo);
      reinterpret_cast<uint4*>(hbh)[i] = hi;
      reinterpret_cast<uint4*>(hbl)[i] = lo;
    }
    fence_proxy_async();
    named_barrier_arrive(2, kHThreads);
    named_barrier_sync(3, kHThreads / 2);       // the tile is whole for warpgroup 0's wgmma
  } else {
    named_barrier_sync(2, kHThreads);
  }
  // dxs = B dH^T (into y's registers), left in flight while dy is staged
  product<kHP, false>(y, 0, NS / 8, hbh, hbl, kHP, 0, rows_of(Br, a.bss), plain);
  __syncthreads();                              // both warpgroups are done with x^T
  transpose_split(rawx, xth, xtl);
  fence_proxy_async();
  __syncthreads();
  // dxi = M'^T dy over t >= s >= 64 wg: A(s, t) = M'_ts where s <= t < nv
  // (its last wait ends dxs too)
  {
    const float Llo = l2[rlo], Lhi = l2[rhi];
    auto ld = [&](int kk, float (&v)[4]) {
      const int ta = 8 * kk + t4, tb = ta + 4;
      v[0] = vlo && rlo <= ta && ta < nv ? cbc[ta * kHQ + rlo] : 0.f;
      v[1] = vhi && rhi <= ta && ta < nv ? cbc[ta * kHQ + rhi] : 0.f;
      v[2] = vlo && rlo <= tb && tb < nv ? cbc[tb * kHQ + rlo] : 0.f;
      v[3] = vhi && rhi <= tb && tb < nv ? cbc[tb * kHQ + rhi] : 0.f;
    };
    auto m = [&](float v, int s, float Ls, int t) {
      return s <= t ? v * exp2_approx(l2[t] - Ls) : 0.f;
    };
    auto mk = [&](int kk, const float (&v)[4], Frag<4>& f) {
      const int ta = 8 * kk + t4, tb = ta + 4;
      frag_of(f, m(v[0], rlo, Llo, ta), m(v[1], rhi, Lhi, ta), m(v[2], rlo, Llo, tb),
              m(v[3], rhi, Lhi, tb));
    };
    product<kHP>(acc, 8 * wg, kHQ / 8, xth, xtl, kHP, 0, ld, mk);
    fence_regs(y);
  }

  // dx = dt dxi + w dxs + D dy, one store per pair of channels; the row dots
  const float dsk = a.D[h];
  float rdi[2] = {0.f, 0.f}, rds[2] = {0.f, 0.f}, dd = 0.f;
#pragma unroll
  for (int j = 0; j < kHP / 8; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = k ? rhi : rlo, p = 8 * j + 2 * t4, r = 4 * j + 2 * k;
      if (s < nv) {
        const float dy0 = rawx[swz(kHQ, s, p)], dy1 = rawx[swz(kHQ, s, p + 1)];
        const float2 xv = xe[j][k];
        *reinterpret_cast<float2*>(a.dx + ((row0 + s) * a.H + h) * kHP + p) =
            make_float2(dts[s] * acc[r] + wv[s] * y[r] + dsk * dy0,
                        dts[s] * acc[r + 1] + wv[s] * y[r + 1] + dsk * dy1);
        rdi[k] += xv.x * acc[r] + xv.y * acc[r + 1];
        rds[k] += xv.x * y[r] + xv.y * y[r + 1];
        dd += dy0 * xv.x + dy1 * xv.y;
      }
    }
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rp[k] += __shfl_xor_sync(0xffffffffu, rp[k], off);
      rdi[k] += __shfl_xor_sync(0xffffffffu, rdi[k], off);
      rds[k] += __shfl_xor_sync(0xffffffffu, rds[k], off);
    }
  if (t4 == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = k ? rhi : rlo;
      rows[r] = rp[k];
      rows[kHQ + r] = rdi[k];
      rows[2 * kHQ + r] = rds[k];
    }
  }
  // the tail in three rounds of warp sums (red: [0, 8) dy . x, [8, 16)
  // h_prev . dH, [16, 20) the scan's warp totals, [20, 24) the state term,
  // [24, 28) dA), each in one order
  auto warp_sum = [](float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  };
  dd = warp_sum(dd);
  ddot = warp_sum(ddot);
  if (lane == 0) {
    red[warp] = dd;
    red[8 + warp] = ddot;
  }
  __syncthreads();                              // the row dots and the parts are written
  float dD = 0.f, hd = 0.f;
  for (int w = 0; w < kHThreads / 32; ++w) {
    dD += red[w];
    hd += red[8 + w];
  }
  // dL_t = dy.yi + exp(L_t) dy.yh - dt_t (x.dxi + exp(L_Q - L_t) x.dxs);
  // the state and chunk-decay terms of dL_{Q-1}, K, join every suffix sum
  // da_u = sum_{t >= u} dL_t, so they are added after the scan
  float direct = 0.f, dL = 0.f, wx = 0.f;
  if (tid < kHQ) {
    const float tl = expf(lq - cum[tid]);
    direct = rows[kHQ + tid] + tl * rows[2 * kHQ + tid];
    dL = rows[tid] - dts[tid] * direct;
    wx = tl * dts[tid] * rows[2 * kHQ + tid];
  }
  float da = dL;                                // a suffix scan within each warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, da, off);
    if (lane + off < 32) da += u;
  }
  wx = warp_sum(wx);
  if (lane == 0 && warp < kHQ / 32) {
    red[16 + warp] = da;
    red[20 + warp] = wx;
  }
  __syncthreads();
  float kterm = expf(lq) * hd;
  for (int w = 0; w < kHQ / 32; ++w) kterm = red[20 + w] + kterm;
  if (tid < kHQ) {
    for (int w2 = kHQ / 32 - 1; w2 > warp; --w2) da += red[16 + w2];
    da += kterm;
  }
  if (tid < nv) a.ddt[(row0 + tid) * a.H + h] = direct + a.A[h] * da;
  const float pa = warp_sum(tid < kHQ ? dts[tid] * da : 0.f);
  if (lane == 0 && warp < kHQ / 32) red[24 + warp] = pa;
  __syncthreads();
  float dA = 0.f;
  for (int w = 0; w < kHQ / 32; ++w) dA += red[24 + w];
  if (tid == 0) {
    a.dA_part[bch] = dA;
    a.dD_part[bch] = dD;
  }
}

template <int NS>
struct DbcCfg {
  static constexpr int NW = NS == 128 ? 128 : 64;   // output columns of a warpgroup
  static constexpr int AB = kHQ * kHP * 4;          // bytes of an activation tile (one term)
  static constexpr int DP = kHQ + 1;                // row pitch of dS as summed (odd)
  // two slots of (hi, lo) activation tiles, or dS's hi and lo (128 x 128);
  // the head's column scales, the barriers; dS as summed
  static constexpr size_t smem = 1024 + 4 * (size_t)AB + 4 * 2 * kHQ + 8 * 2 + 4 * (size_t)kHQ * DP;
};

// a part of dC or dB, transposed in registers (rows n, columns t or s), to
// out (Q, N)
template <int NW>
__device__ __forceinline__ void store_part(float* out, const float (&v)[NW / 2], int NS, int nlo,
                                           int tc, int t4) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(int64_t)(tc + 8 * j + 2 * t4 + (e & 1)) * NS + nlo + 8 * (e >> 1)] = v[4 * j + e];
}

// The dB/dC stage's parts for one (chunk, batch): block z < 2 G the state
// term of dC (z even: sum over the group's heads of exp(L_t) dy_t h_prev) or
// dB (odd: w_s x_s dH); block z = 2 G the dS terms of both (dS B, dS^T C),
// all transposed (rows n), into bcp (2, B, nc, G + 1, Q, N) as (t, n).
// Warpgroup wg: at N = 128 rows n [64 wg, 64 wg + 64) and every column, at
// N = 64 every row and columns [64 wg, 64 wg + 64).
template <int NS>
__global__ void __launch_bounds__(kHThreads, 1)
ssd_bwd_dbc_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmdy,
                   BwdArgs<float> a) {
  using namespace hopper;
  using C = DbcCfg<NS>;
  constexpr int NW = C::NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* tiles = reinterpret_cast<float*>(base);    // slot k: hi, lo; or dS's hi, lo
  float* sc = tiles + C::AB;                        // [2][kHQ] a head's column scale
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + 2 * kHQ);

  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int nv = min(kHQ, a.S - c * kHQ);
  const int64_t tok0 = (int64_t)c * kHQ, row0 = (int64_t)b * a.S + tok0;
  const int nr = NS == 128 ? 64 * wg : 0, tc = NS == 128 ? 0 : 64 * wg;
  const int nlo = nr + 16 * (warp & 3) + g, nhi = nlo + 8;
  auto part = [&](int is_db, int k) {
    return a.bcp + ((((int64_t)is_db * a.Bsz + b) * a.nc + c) * (a.G + 1) + k) * kHQ * NS;
  };
  float acc[NW / 2];

  if (z < 2 * a.G) {
    const int grp = z >> 1, is_db = z & 1;
    const int hb = grp * a.hg(), nh = min(a.H, hb + a.hg()) - hb;
    const CUtensorMap* tm = is_db ? &tmx : &tmdy;
    const float* st = is_db ? a.dstates : a.h_prev;
    if (tid == 0) {
      mbar_init(full, 1);
      mbar_init(full + 1, 1);
      mbar_init_fence();
    }
    __syncthreads();
    auto issue = [&](int i) {                   // head hb + i into slot i % 2
      float* dst = tiles + 2 * (i & 1) * (C::AB / 4);
      mbar_expect_tx(full + (i & 1), C::AB);
      for (int k = 0; k < 2; ++k)
        tma_load_4d(dst + k * kHQ * 32, tm, full + (i & 1), 32 * k, hb + i, (int)tok0, b);
    };
    if (tid == 0)
      for (int i = 0; i < 2 && i < nh; ++i) issue(i);
    float total[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) total[i] = 0.f;
    // A(n, p) = state[p][n]: a head's 8 k-steps loaded at once, the next
    // head's while this one's products run
    float av[8][4];
    auto load_a = [&](int i) {
      const float* sp = st + a.bch(b, c, hb + i) * kHP * NS;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int p = 8 * kk + t4;
        av[kk][0] = sp[p * NS + nlo];
        av[kk][1] = sp[p * NS + nhi];
        av[kk][2] = sp[(p + 4) * NS + nlo];
        av[kk][3] = sp[(p + 4) * NS + nhi];
      }
    };
    if (nh > 0) load_a(0);
    for (int i = 0; i < nh; ++i) {
      const int h = hb + i, slot = i & 1;
      float* th = tiles + 2 * slot * (C::AB / 4);
      float* tl = th + C::AB / 4;
      const int64_t bch = a.bch(b, c, h);
      if (tid < kHQ) {
        const float L = a.cum[bch * kHQ + tid];
        sc[slot * kHQ + tid] =
            is_db ? expf(a.cum[bch * kHQ + kHQ - 1] - L) *
                        (tid < nv ? a.dt[(row0 + tid) * a.H + h] : 0.f)
                  : expf(L);
      }
      mbar_wait(full + slot, (i >> 1) & 1);
      split_tile(th, th, tl, kHQ * kHP / 4);
      fence_proxy_async();
      __syncthreads();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        Frag<4> f;
        frag_of(f, av[kk][0], av[kk][1], av[kk][2], av[kk][3]);
        wgmma_fence();
        wgmma3<NW>(acc, f, b_at(th, kHQ, kk, tc), b_at(tl, kHQ, kk, tc), kk > 0);
        wgmma_commit();
        wgmma_wait<2>();
      }
      if (i + 1 < nh) load_a(i + 1);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          total[4 * j + e] += acc[4 * j + e] * sc[slot * kHQ + tc + 8 * j + 2 * t4 + (e & 1)];
      __syncthreads();                          // every warp is done with the slot
      if (tid == 0 && i + 2 < nh) issue(i + 2);
    }
    store_part<NW>(part(is_db, grp), total, NS, nlo, tc, t4);
    return;
  }

  // dS summed over the groups in order (rows t = tid / 2, columns s of the
  // thread's half), masked to s <= t < nv (the rest of the scratch is
  // unset), kept as summed in dsr and split (rows t, K = s) into dsh, dsl
  float* dsh = tiles;                           // [4][128][32] dS (rows t, K = s), then dS^T
  float* dsl = tiles + kHQ * kHQ;
  float* dsr = reinterpret_cast<float*>(full + 2);   // [kHQ][DP] dS as summed
  {
    const int t = tid >> 1, sb = 64 * (tid & 1);
    const float* src = a.dsp + ((int64_t)b * a.nc + c) * a.G * kHQ * kHQ + t * kHQ + sb;
#pragma unroll 4
    for (int q = 0; q < 16; ++q) {
      float4 sum = *reinterpret_cast<const float4*>(src + 4 * q);
      for (int k = 1; k < a.G; ++k) {
        const float4 d = *reinterpret_cast<const float4*>(src + (int64_t)k * kHQ * kHQ + 4 * q);
        sum.x += d.x, sum.y += d.y, sum.z += d.z, sum.w += d.w;
      }
      const int s = sb + 4 * q;
      const bool ok = t < nv;
      const float4 v = make_float4(ok && s <= t ? sum.x : 0.f, ok && s + 1 <= t ? sum.y : 0.f,
                                   ok && s + 2 <= t ? sum.z : 0.f, ok && s + 3 <= t ? sum.w : 0.f);
      float* r = dsr + t * C::DP + s;
      r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
      uint4 hi, lo;
      split4(v, hi, lo);
      *reinterpret_cast<uint4*>(dsh + swz(kHQ, t, s)) = hi;
      *reinterpret_cast<uint4*>(dsl + swz(kHQ, t, s)) = lo;
    }
  }
  fence_proxy_async();
  __syncthreads();
  // dC^T += B^T dS^T: A(n, s) = B[s][n], B operand dS (N = t, K = s); at N =
  // 64 warpgroup wg's columns t < 64 (wg + 1) need s < 64 (wg + 1)
  const float* Br = a.Bm + b * a.bsb + tok0 * a.bss;
  const float* Cr = a.Cm + b * a.csb + tok0 * a.css;
  // A(n, r) = M[r][n] for M = B or C (rows r < nv)
  auto cols_of = [&](const float* M, int64_t ms) {
    return [=](int kk, float (&v)[4]) {
      const int r0 = 8 * kk + t4, r1 = r0 + 4;
      v[0] = r0 < nv ? M[r0 * ms + nlo] : 0.f;
      v[1] = r0 < nv ? M[r0 * ms + nhi] : 0.f;
      v[2] = r1 < nv ? M[r1 * ms + nlo] : 0.f;
      v[3] = r1 < nv ? M[r1 * ms + nhi] : 0.f;
    };
  };
  auto plain = [](int, const float (&v)[4], Frag<4>& f) { frag_of(f, v[0], v[1], v[2], v[3]); };
  product<NW>(acc, 0, NS == 128 ? kHQ / 8 : 8 * (wg + 1), dsh, dsl, kHQ, tc, cols_of(Br, a.bss),
              plain);
  store_part<NW>(part(0, a.G), acc, NS, nlo, tc, t4);
  __syncthreads();                              // every warp is done with dS
  // dS^T (rows s, K = t), split from dS as summed: four rows t of a column
  // s make one 16-byte chunk of each term
  for (int i = tid; i < kHQ * kHQ / 4; i += kHThreads) {
    const int s = i & (kHQ - 1), t = 4 * (i >> 7);
    const float* r = dsr + t * C::DP + s;
    uint4 hi, lo;
    split4(make_float4(r[0], r[C::DP], r[2 * C::DP], r[3 * C::DP]), hi, lo);
    *reinterpret_cast<uint4*>(dsh + swz(kHQ, s, t)) = hi;
    *reinterpret_cast<uint4*>(dsl + swz(kHQ, s, t)) = lo;
  }
  fence_proxy_async();
  __syncthreads();
  // dB^T += C^T dS: A(n, t) = C[t][n], B operand dS^T (N = s, K = t); at N =
  // 64 warpgroup wg's columns s >= 64 wg need t >= 64 wg
  product<NW>(acc, NS == 128 ? 0 : 8 * wg, kHQ / 8, dsh, dsl, kHQ, tc, cols_of(Cr, a.css), plain);
  store_part<NW>(part(1, a.G), acc, NS, nlo, tc, t4);
}

// dC (blockIdx.z 0) or dB (1) of one (batch, chunk) = its G + 1 parts in
// order, four values a thread; the blocks (0, 0, z) also sum dA (z = 0) or
// dD (1) over (b, chunk) in order
__global__ void __launch_bounds__(256)
ssd_bwd_dbc_sum_kernel(BwdArgs<float> a) {
  const int is_db = blockIdx.z, b = blockIdx.y / a.nc, c = blockIdx.y % a.nc;
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    const float* part = is_db ? a.dD_part : a.dA_part;
    for (int h = threadIdx.x; h < a.H; h += 256) {
      float sum = 0.f;
      for (int k = 0; k < a.Bsz * a.nc; ++k) sum += part[(int64_t)k * a.H + h];
      (is_db ? a.dD : a.dA)[h] = sum;
    }
  }
  const int nv = min(kHQ, a.S - c * kHQ);
  const int i = blockIdx.x * 256 + threadIdx.x;       // a float4 of the chunk's (t, n)
  if (4 * i >= nv * a.N) return;
  const int64_t stride = (int64_t)kHQ * a.N / 4;
  const float4* part = reinterpret_cast<const float4*>(
      a.bcp + (((int64_t)is_db * a.Bsz + b) * a.nc + c) * (a.G + 1) * kHQ * a.N) + i;
  float4 s = part[0];
  for (int k = 1; k <= a.G; ++k) {
    const float4 d = part[k * stride];
    s.x += d.x, s.y += d.y, s.z += d.z, s.w += d.w;
  }
  reinterpret_cast<float4*>((is_db ? a.dB : a.dC) + ((int64_t)b * a.S + (int64_t)c * kHQ) * a.N)[i] = s;
}

// The Hopper route's rule (kernel.bwd_on_hopper in Python is the same):
// fp32, chunks of 128 (S >= 128), 64 channels a head, 64 or 128 states, x's
// pointer and batch and row strides 16-byte aligned (its TMA map), the
// state maps' rows within int32. dy, h_prev and the scratch are contiguous
// allocations of the wrapper.
bool bwd_on_hopper(int bf16_in, int Bsz, int S, int H, int P, int N, int Q, const void* x,
                   long long xsb, long long xss) {
  const long long nc = (S + Q - 1) / Q;
  return !bf16_in && Q == kHQ && P == kHP && (N == 64 || N == 128) &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && xss % 4 == 0 && (Bsz == 1 || xsb % 4 == 0) &&
         (long long)Bsz * nc * H * P < (1LL << 31);
}

// the TMA map of the (P, H, S, B) view of an fp32 (B, S, H, P) tensor with
// batch and row strides sb and ss (elements): boxes of 32 channels x 128
// rows of one head (a dimension of extent 1 gets a contiguous tensor's
// stride: torch leaves it free, TMA wants a multiple of 16 bytes)
bool act_map(CUtensorMap* map, const float* ptr, int B, int S, int H, int P, int64_t sb,
             int64_t ss) {
  const cuuint64_t row = S > 1 ? (cuuint64_t)ss * 4 : (cuuint64_t)H * P * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)P * 4, row,
                                 B > 1 ? (cuuint64_t)sb * 4 : row * (cuuint64_t)S};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)kHQ, 1};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 4, dims, strides, box);
}

// the TMA map of (B, nc, H, P, N) states as (N, B nc H P): boxes of 32
// states x 64 channels
bool state_map(CUtensorMap* map, const float* ptr, long long rows, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)kHP};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 2, dims, strides, box);
}

template <int NS>
int launch_bwd_hopper(const BwdArgs<float>& a, cudaStream_t st) {
  using DC = DxCfg<NS>;
  static int dev_dx = -1, dev_dbc = -1;
  cudaError_t e;
  if ((e = raise_smem_limit(ssd_bwd_dx_kernel<NS>, DC::smem, dev_dx)) ||
      (e = raise_smem_limit(ssd_bwd_dbc_kernel<NS>, DbcCfg<NS>::smem, dev_dbc)))
    return (int)e;
  CUtensorMap tmx, tmdy, tmh, tmd;
  const long long rows = (long long)a.Bsz * a.nc * a.H * a.P;
  if (!act_map(&tmx, a.x, a.Bsz, a.S, a.H, a.P, a.xsb, a.xss) ||
      !act_map(&tmdy, a.dy, a.Bsz, a.S, a.H, a.P, (int64_t)a.S * a.H * a.P, (int64_t)a.H * a.P) ||
      !state_map(&tmh, a.h_prev, rows, NS) || !state_map(&tmd, a.dstates, rows, NS))
    return (int)cudaErrorInvalidValue;
  if ((e = launch_bwd_front(a, st)) != cudaSuccess) return (int)e;
  ssd_bwd_dx_kernel<NS><<<dim3(a.nc, a.H, a.Bsz), kHThreads, DC::smem, st>>>(
      tmx, tmdy, tmh, tmd, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dbc_kernel<NS><<<dim3(a.nc, a.Bsz, 2 * a.G + 1), kHThreads, DbcCfg<NS>::smem, st>>>(
      tmx, tmdy, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dbc_sum_kernel<<<dim3((kHQ * NS / 4 + 255) / 256, a.Bsz * a.nc, 2), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

bool vec_ok(int v, int elem) { return (v == 1 || v == 2 || v == 4 || v == 8) && v * elem <= 16; }

}  // namespace

// The forward, either dtype (bf16_in != 0: bfloat16, else float32): x
// (B,S,H,P) with head stride P and element stride 1, Bm, Cm (B,S,N) with
// element stride 1, each with its batch (*sb) and row (*ss) strides in
// elements; vx, vb, vc elements per copy (1, 2, 4, or 8 for bf16) dividing
// each tensor's pointer alignment, strides and row width. dt (B,S,H), A, D
// (H,) float32 contiguous. Out: y (B,S,H,P) in x's dtype, contiguous, state
// (B,H,P,N) float32; states (B, ceil(S/Q), H, P, N) float32 receives the
// state entering each chunk; scratch lq (B, ceil(S/Q), H) float32.
// Requires 1 <= Q <= 128, N <= 128, N % 4 == 0. Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* D, void* y, void* state, void* states,
                               void* lq, int Bsz, int S, int H, int P, int N, int Q,
                               long long xsb, long long xss, long long bsb, long long bss,
                               long long csb, long long css, int vx, int vb, int vc, int bf16_in,
                               void* stream) {
  const int elem = bf16_in ? 2 : 4;
  if (!D || Q < 1 || Q > kQMax || N > kNMax || N % 4 != 0 || !vec_ok(vx, elem) ||
      !vec_ok(vb, elem) || !vec_ok(vc, elem))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    const FwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(Bm),
                       static_cast<const T*>(Cm), static_cast<const float*>(dt),
                       static_cast<const float*>(A), static_cast<const float*>(D),
                       static_cast<T*>(y), static_cast<float*>(state),
                       static_cast<float*>(states), static_cast<float*>(lq),
                       Bsz, S, H, P, N, Q, nc, xsb, xss, bsb, bss, csb, css, vx, vb, vc};
    if constexpr (std::is_same<T, bf16>::value) {
      return launch_bf16(a, static_cast<cudaStream_t>(stream));
    } else {
      return launch_fp32(a, static_cast<cudaStream_t>(stream));
    }
  };
  return bf16_in ? run(bf16{}) : run(float{});
}

// The backward of either forward: x, Bm, Cm, dy and the outputs dx, dB, dC
// in the forward's dtype (bf16_in != 0: bfloat16, else float32), the rest
// float32. x, Bm, Cm as the forward takes them; dt, dy, dx (B,S,H[,P]), dB,
// dC (B,S,N) contiguous; vdy the copy width of dy; h_prev (B, nc, H, P, N)
// the forward's states; dhT (B,H,P,N) or null. Out: dx, ddt (B,S,H), dA,
// dD (H,), dB, dC. Scratch: cb (B, nc, Q, Q), dsp (B, nc, G, Q, Q), cum
// (B, nc, H, Q), lq, dA_part, dD_part (B, nc, H), dstates (B, nc, H, P, N),
// bcp (2, B, nc, G + 1, Q, N); G (1 <= G <= H) groups of heads. Requires
// 1 <= Q <= 128, N <= 128, N % 4 == 0. fp32 at the Hopper route's shapes
// (bwd_on_hopper) takes its kernels, every other call the mma.sync ones.
// Returns cudaGetLastError(), or cudaErrorInvalidValue where a TMA map
// cannot be made.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, const void* D, const void* h_prev,
                                   const void* dy, const void* dhT, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* dD, void* cb, void* dsp,
                                   void* cum, void* lq, void* dstates, void* bcp, void* dA_part,
                                   void* dD_part, int Bsz, int S, int H, int P, int N, int Q,
                                   int G, long long xsb, long long xss, long long bsb,
                                   long long bss, long long csb, long long css, int vx, int vb,
                                   int vc, int vdy, int bf16_in, void* stream) {
  const int elem = bf16_in ? 2 : 4;
  if (!D || Q < 1 || Q > kQMax || N > kNMax || N % 4 != 0 || G < 1 || G > H ||
      !vec_ok(vx, elem) || !vec_ok(vb, elem) || !vec_ok(vc, elem) || !vec_ok(vdy, elem))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(Bm),
                       static_cast<const T*>(Cm), static_cast<const T*>(dy),
                       static_cast<const float*>(dt), static_cast<const float*>(A),
                       static_cast<const float*>(D), static_cast<const float*>(h_prev),
                       static_cast<const float*>(dhT), static_cast<T*>(dx), static_cast<T*>(dB),
                       static_cast<T*>(dC), static_cast<float*>(ddt), static_cast<float*>(dA),
                       static_cast<float*>(dD), static_cast<float*>(cb), static_cast<float*>(dsp),
                       static_cast<float*>(cum), static_cast<float*>(lq),
                       static_cast<float*>(dstates), static_cast<float*>(bcp),
                       static_cast<float*>(dA_part), static_cast<float*>(dD_part),
                       Bsz, S, H, P, N, Q, nc, G, xsb, xss, bsb, bss, csb, css,
                       vx, vb, vc, vdy};
    if constexpr (std::is_same<T, float>::value) {
      if (bwd_on_hopper(bf16_in, Bsz, S, H, P, N, Q, x, xsb, xss))
        return N == 128 ? launch_bwd_hopper<128>(a, static_cast<cudaStream_t>(stream))
                        : launch_bwd_hopper<64>(a, static_cast<cudaStream_t>(stream));
    }
    return launch_bwd<T>(a, static_cast<cudaStream_t>(stream));
  };
  return bf16_in ? run(bf16{}) : run(float{});
}

// 1 when ssd_scan_bwd_launch takes the Hopper route at these arguments
// (fp32: ssd_bwd_dx_kernel, ssd_bwd_dbc_kernel, ssd_bwd_dbc_sum_kernel after
// the three shared launches), else 0 (the six-kernel route)
extern "C" int ssd_scan_bwd_on_hopper(int bf16_in, int Bsz, int S, int H, int P, int N, int Q,
                                      const void* x, long long xsb, long long xss) {
  return bwd_on_hopper(bf16_in, Bsz, S, H, P, N, Q, x, xsb, xss) ? 1 : 0;
}
