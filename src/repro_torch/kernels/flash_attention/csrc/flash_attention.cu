// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py. Same function: for aligned
// self-attention (query row i and key j sit at positions i and j),
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, h / rep]
// over the keys j that the mask keeps: j < Skv, j <= i when causal, and
// j > i - window when a window is given. GQA maps query head h to KV head
// h / rep (rep = Hq / Hkv) without repeating K or V. As on the TPU: scores
// and the softmax state (m, l, acc) are fp32, masked scores are -1e30 and
// their p is 0, l is clamped at 1e-30 (an empty row gives 0, not NaN), and
// the output is cast to q's dtype.
//
// Two kernels, chosen by a fixed rule on the dtype (not a fallback: each
// dtype reaches exactly one kernel, and a failed launch is returned):
//   * bfloat16 -> flash_mma_kernel, products on the tensor cores;
//   * float32  -> flash_kernel, products as fp32 FMAs on the CUDA cores, so
//     fp32 inputs stay IEEE fp32 (TF32 would miss the JAX tests' 2e-5).
//
// What bounds it on this card: at the whisper encoder's shape (B=4, S=1500,
// 12 heads of 64, bf16) the function does 2.8e10 FLOP on 37 MB, so its least
// time is set by operations (0.028 ms at the tensor cores' 989 TFLOP/s).
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
// flash_kernel (fp32), the first version: 256 threads as 16 x 16, thread
// (ty, tx) owns rows 4*ty .. 4*ty+3, score columns tx + 16*j of each 64-key
// tile and HD/16 output columns; q (scaled), K, V and P tiles in fp32
// shared memory with pitches of HD+4 floats.
//
// Both: HD is a template argument (16 .. 256 in steps of 16); q, k, v, o
// are read and written in place in BSHD through their batch and row strides
// (head stride HD, element stride 1); the live key range of a tile comes
// from causal, window and Skv, and tiles outside it are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32: flash_kernel on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kPP = kBK + 4;    // row pitch of the P tile

constexpr size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (hd + 4) + (size_t)kBQ * kPP);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// Copy rows [r0, r0 + rows) of one head of a BSHD tensor into a (rows, HD)
// fp32 tile of pitch HD+4, times `mul`; rows at or past `n` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int64_t rs,
                                          int r0, int rows, int n, float mul) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = r0 + r;
    dst[r * (HD + 4) + d] = s < n ? src[(int64_t)s * rs + d] * mul : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int Sq, int Skv, int Hq,
             int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss, int64_t vsb,
             int64_t vss, int64_t osb, int64_t oss, float scale, int causal, int window) {
  constexpr int P = HD + 4;
  constexpr int NC = HD / 16;                        // output columns per thread
  constexpr int VEC = NC % 4 == 0 ? 4 : (NC % 2 == 0 ? 2 : 1);
  constexpr int NV = NC / VEC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBQ][P]  q * scale
  float* ks = qs + kBQ * P;         // [kBK][P]
  float* vs = ks + kBK * P;         // [kBK][P]
  float* ps = vs + kBK * P;         // [kBQ][kPP]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const float* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const float* vb = v + b * vsb + (int64_t)(h / rep) * HD;
  load_tile<HD>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, kBQ, Sq, scale);

  // keys that some row of this tile may attend to: [k_begin, k_end)
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                // the previous tile's reads are done
    load_tile<HD>(ks, kb, kss, k0, kBK, Skv, 1.f);
    load_tile<HD>(vs, vb, vss, k0, kBK, Skv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * P + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * P + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // mask, online softmax; each row's 64 scores are spread over 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        keep[j] = kp < Skv && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
        s[i][j] = keep[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(4 * ty + i) * kPP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + rs;     // this thread's part of the row sum
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    // acc += P V; this thread's columns are VEC*tx + 16*VEC*n + e
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * kPP + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &vs[(kk + t) * P + VEC * tx];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float vv[VEC];
          load_vec<VEC>(vrow + 16 * VEC * n, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pr[i].x : t == 1 ? pr[i].y : t == 2 ? pr[i].z : pr[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][n * VEC + e] = fmaf(p, vv[e], acc[i][n * VEC + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int s = q0 + 4 * ty + i;
    if (s >= Sq) continue;          // ragged q tail: not written
    const float den = fmaxf(li, 1e-30f);
    // the scores are scaled already (q * scale), so m + log(l) is the row's
    // log-sum-exp of scale * q . k
    if (lse != nullptr && tx == 0) lse[((int64_t)b * Hq + h) * Sq + s] = m[i] + logf(den);
    float* orow = o + b * osb + (int64_t)s * oss + (int64_t)h * HD + VEC * tx;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e) orow[16 * VEC * n + e] = acc[i][n * VEC + e] / den;
  }
}

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
// backward: three kernels on the CUDA cores, fp32 arithmetic
// ---------------------------------------------------------------------------
//
// With P = exp(scale * Q K^T - lse) (lse from the forward; masked entries 0),
// dP = dO V^T, delta = rowsum(dO * O) and dS = P * (dP - delta):
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// flash_bwd_preprocess_kernel computes delta (one warp per row);
// flash_bwd_dkdv_kernel owns a tile of keys of one KV head and loops over
// its rep query heads and their live query tiles, so GQA's sum over the
// query heads of a KV head stays inside the block; flash_bwd_dq_kernel owns
// a tile of query rows of one head and loops over its live key tiles. Each
// gradient element is summed by one thread in a fixed order, with no
// atomics: two runs give the same bits. Masks and dead tiles as in the
// forward. T (float or bf16) is the type in memory: bf16 is widened on load
// and dq, dk, dv are written in T.
//
// What bounds it: at the training shape (B=8, S=256, 9/3 heads of 64,
// causal, fp32) the five products of the function (QK^T, dO V^T, dV, dK,
// dQ) are 1.5 GFLOP on ~20 MB, so operations bound it (0.023 ms at the CUDA
// cores' 67 TFLOP/s). The design is the simple one: both kernels recompute
// S and dP (seven products, not five), tiles of 64 (32 above hd = 128) in
// fp32 shared memory, 4 x 4 (2 x 2) register blocks per thread.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

template <int HD>
struct BwdCfg {
  static constexpr int BT = HD <= 128 ? 64 : 32;   // query rows and keys per tile
  static constexpr int R = BT / 16;                // rows (and columns) per thread
  static constexpr int P = HD + 4;                 // pitch of an HD-wide tile
  static constexpr int PT = BT + 4;                // pitch of a BT-wide tile
  static constexpr int NC = HD / 16;               // output columns per thread
  // K, V, Q, dO tiles; the P and dS tiles (dkdv) or the dS tile (dq); lse, delta
  static constexpr size_t SMEM_KV =
      sizeof(float) * ((size_t)4 * BT * P + (size_t)2 * BT * PT + 2 * BT);
  static constexpr size_t SMEM_Q =
      sizeof(float) * ((size_t)4 * BT * P + (size_t)BT * PT + 2 * BT);
};

// rows [r0, r0 + ROWS) of one head (HD contiguous values per row, rows rs
// apart) into an fp32 tile of pitch HD + 4; rows at or past n are zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void bwd_load(float* dst, const T* __restrict__ src, int64_t rs,
                                         int r0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    dst[r * (HD + 4) + d] = r0 + r < n ? to_f(src[(int64_t)(r0 + r) * rs + d]) : 0.f;
  }
}

__device__ __forceinline__ bool live(int i, int j, int Sq, int Skv, int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) && (window < 0 || j > i - window);
}

// s = Q K^T and dp = dO V^T over one (query tile, key tile) pair: this
// thread's query rows R ty + a and keys tx + 16 c
template <int HD>
__device__ __forceinline__ void bwd_scores(const float* qs, const float* dos, const float* ks,
                                           const float* vs,
                                           float (&s)[BwdCfg<HD>::R][BwdCfg<HD>::R],
                                           float (&dp)[BwdCfg<HD>::R][BwdCfg<HD>::R]) {
  constexpr int R = BwdCfg<HD>::R, P = BwdCfg<HD>::P;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qa[R], da[R], kb[R], vb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(&qs[(R * ty + a) * P + d]);
      da[a] = *reinterpret_cast<const float4*>(&dos[(R * ty + a) * P + d]);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      kb[c] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * c) * P + d]);
      vb[c] = *reinterpret_cast<const float4*>(&vs[(tx + 16 * c) * P + d]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = fmaf(qa[a].x, kb[c].x, s[a][c]);
        s[a][c] = fmaf(qa[a].y, kb[c].y, s[a][c]);
        s[a][c] = fmaf(qa[a].z, kb[c].z, s[a][c]);
        s[a][c] = fmaf(qa[a].w, kb[c].w, s[a][c]);
        dp[a][c] = fmaf(da[a].x, vb[c].x, dp[a][c]);
        dp[a][c] = fmaf(da[a].y, vb[c].y, dp[a][c]);
        dp[a][c] = fmaf(da[a].z, vb[c].z, dp[a][c]);
        dp[a][c] = fmaf(da[a].w, vb[c].w, dp[a][c]);
      }
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]; o and dout contiguous
// (B, Sq, Hq, HD) = rows x HD, one warp per row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                            float* __restrict__ delta, int64_t rows, int Sq, int Hq) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;          // the whole warp
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f(o[row * HD + d]), to_f(dout[row * HD + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t h = row % Hq, bi = row / Hq;      // bi = b * Sq + i
    delta[(bi / Sq * Hq + h) * Sq + bi % Sq] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Skv, int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb,
                      int64_t kss, int64_t vsb, int64_t vss, float scale, int causal,
                      int window) {
  using C = BwdCfg<HD>;
  constexpr int BT = C::BT, R = C::R, P = C::P, PT = C::PT, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [BT][P]
  float* vs = ks + BT * P;          // [BT][P]
  float* qs = vs + BT * P;          // [BT][P]
  float* dos = qs + BT * P;         // [BT][P]
  float* ps = dos + BT * P;         // [BT][PT]  P[query][key]
  float* dss = ps + BT * PT;        // [BT][PT]  dS[query][key]
  float* lse_s = dss + BT * PT;     // [BT]
  float* dl_s = lse_s + BT;         // [BT]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BT;
  const int Hkv = Hq / rep;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  bwd_load<T, HD, BT>(ks, k + b * ksb + (int64_t)hk * HD, kss, k0, Skv);
  bwd_load<T, HD, BT>(vs, v + b * vsb + (int64_t)hk * HD, vss, k0, Skv);

  // query rows that may attend to a key of this tile: [q_begin, q_end)
  const int q_begin = causal ? k0 : 0;
  long long q_end = Sq;
  if (window >= 0) {
    const long long last = (long long)(k0 + BT < Skv ? k0 + BT : Skv) - 1 + window;
    q_end = last < q_end ? last : q_end;
  }

  float acc_k[R][NC], acc_v[R][NC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc_k[a][n] = acc_v[a][n] = 0.f;

  const int64_t osb = (int64_t)Sq * Hq * HD, oss = (int64_t)Hq * HD;   // dO is contiguous
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const T* qh = q + b * qsb + (int64_t)h * HD;
    const T* dh = dout + b * osb + (int64_t)h * HD;
    const float* lse_h = lse + ((int64_t)b * Hq + h) * Sq;
    const float* dl_h = delta + ((int64_t)b * Hq + h) * Sq;
    for (int i0 = q_begin / BT * BT; i0 < q_end; i0 += BT) {
      __syncthreads();              // the previous tile's reads are done
      bwd_load<T, HD, BT>(qs, qh, qss, i0, Sq);
      bwd_load<T, HD, BT>(dos, dh, oss, i0, Sq);
      for (int r = threadIdx.x; r < BT; r += kThreads) {
        lse_s[r] = i0 + r < Sq ? lse_h[i0 + r] : 0.f;
        dl_s[r] = i0 + r < Sq ? dl_h[i0 + r] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      bwd_scores<HD>(qs, dos, ks, vs, s, dp);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int r = R * ty + a, j = tx + 16 * c;
          const float p =
              live(i0 + r, k0 + j, Sq, Skv, causal, window) ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
          ps[r * PT + j] = p;
          dss[r * PT + j] = p * (dp[a][c] - dl_s[r]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this thread's keys R ty + a, columns tx + 16 n
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pv[a] = ps[r * PT + R * ty + a];
          dsv[a] = dss[r * PT + R * ty + a];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float ov = dos[r * P + tx + 16 * n], qv = qs[r * P + tx + 16 * n];
#pragma unroll
          for (int a = 0; a < R; ++a) {
            acc_v[a][n] = fmaf(pv[a], ov, acc_v[a][n]);
            acc_k[a][n] = fmaf(dsv[a], qv, acc_k[a][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = k0 + R * ty + a;
    if (j >= Skv) continue;
    const int64_t off = ((int64_t)b * Skv + j) * Hkv * HD + (int64_t)hk * HD + tx;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dk[off + 16 * n] = from_f<T>(acc_k[a][n] * scale);
      dv[off + 16 * n] = from_f<T>(acc_v[a][n]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
                    int Hq, int rep, int64_t qsb, int64_t qss, int64_t ksb, int64_t kss,
                    int64_t vsb, int64_t vss, float scale, int causal, int window) {
  using C = BwdCfg<HD>;
  constexpr int BT = C::BT, R = C::R, P = C::P, PT = C::PT, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BT][P]
  float* dos = qs + BT * P;         // [BT][P]
  float* ks = dos + BT * P;         // [BT][P]
  float* vs = ks + BT * P;          // [BT][P]
  float* dss = vs + BT * P;         // [BT][PT]  dS[query][key]
  float* lse_s = dss + BT * PT;     // [BT]
  float* dl_s = lse_s + BT;         // [BT]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // the most causal work first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int64_t osb = (int64_t)Sq * Hq * HD, oss = (int64_t)Hq * HD;   // dO is contiguous
  bwd_load<T, HD, BT>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, Sq);
  bwd_load<T, HD, BT>(dos, dout + b * osb + (int64_t)h * HD, oss, q0, Sq);
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const int64_t i = ((int64_t)b * Hq + h) * Sq + q0 + r;
    lse_s[r] = q0 + r < Sq ? lse[i] : 0.f;
    dl_s[r] = q0 + r < Sq ? delta[i] : 0.f;
  }
  const T* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const T* vb = v + b * vsb + (int64_t)(h / rep) * HD;

  // keys that some row of this tile may attend to: [k_begin, k_end)
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BT, Sq));
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;

  float acc[R][NC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[a][n] = 0.f;

  for (int j0 = k_begin / BT * BT; j0 < k_end; j0 += BT) {
    __syncthreads();                // the previous tile's reads are done
    bwd_load<T, HD, BT>(ks, kb, kss, j0, Skv);
    bwd_load<T, HD, BT>(vs, vb, vss, j0, Skv);
    __syncthreads();
    float s[R][R], dp[R][R];
    bwd_scores<HD>(qs, dos, ks, vs, s, dp);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int r = R * ty + a, j = tx + 16 * c;
        const float p =
            live(q0 + r, j0 + j, Sq, Skv, causal, window) ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
        dss[r * PT + j] = p * (dp[a][c] - dl_s[r]);
      }
    __syncthreads();
    // dQ += dS K: this thread's rows R ty + a, columns tx + 16 n
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float dsv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) dsv[a] = dss[(R * ty + a) * PT + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float kv = ks[j * P + tx + 16 * n];
#pragma unroll
        for (int a = 0; a < R; ++a) acc[a][n] = fmaf(dsv[a], kv, acc[a][n]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + R * ty + a;
    if (i >= Sq) continue;          // ragged q tail: not written
    T* row = dq + (((int64_t)b * Sq + i) * Hq + h) * HD + tx;
#pragma unroll
    for (int n = 0; n < NC; ++n) row[16 * n] = from_f<T>(acc[a][n] * scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
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

template <int HD>
int launch_fp32(const Args& a) {
  static int attr_dev = -1;
  cudaError_t e = raise_smem_limit(flash_kernel<HD>, smem_bytes(HD), attr_dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_kernel<HD><<<grid, kThreads, smem_bytes(HD), a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.Sq, a.Skv, a.Hq, a.rep,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.osb, a.oss, a.scale, a.causal, a.window);
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

template <int HD>
struct Fwd {
  static int run(int dtype, const Args& a) {
    if (dtype == 0) return launch_fp32<HD>(a);
    if (dtype == 1) return launch_bf16<HD>(a);
    return (int)cudaErrorInvalidValue;
  }
};

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Skv, Hq, rep;
  int64_t qsb, qss, ksb, kss, vsb, vss;
  float scale;
  int causal, window;
  cudaStream_t st;
};

template <typename T, int HD>
int launch_bwd(const BwdArgs& a) {
  using C = BwdCfg<HD>;
  static int attr_kv = -1, attr_q = -1;
  cudaError_t e = raise_smem_limit(flash_bwd_dkdv_kernel<T, HD>, C::SMEM_KV, attr_kv);
  if (e != cudaSuccess) return (int)e;
  e = raise_smem_limit(flash_bwd_dq_kernel<T, HD>, C::SMEM_Q, attr_q);
  if (e != cudaSuccess) return (int)e;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  const int64_t rows = (int64_t)a.B * a.Sq * a.Hq;
  flash_bwd_preprocess_kernel<T, HD><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                                       kThreads, 0, a.st>>>(static_cast<const T*>(a.o), dout,
                                                            a.delta, rows, a.Sq, a.Hq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((a.Skv + C::BT - 1) / C::BT, a.B * (a.Hq / a.rep)),
                                 kThreads, C::SMEM_KV, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Skv,
      a.Hq, a.rep, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, a.causal, a.window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, HD><<<dim3((a.Sq + C::BT - 1) / C::BT, a.B * a.Hq), kThreads,
                               C::SMEM_Q, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Skv, a.Hq, a.rep, a.qsb,
      a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int HD>
struct Bwd {
  static int run(int dtype, const BwdArgs& a) {
    if (dtype == 0) return launch_bwd<float, HD>(a);
    if (dtype == 1) return launch_bwd<bf16, HD>(a);
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

// q, o (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd); dtype 0 = float32 (flash_kernel),
// 1 = bfloat16 (flash_mma_kernel) for all four. Strides in elements: *sb
// between batches, *ss between rows; the head stride must be hd and the
// element stride 1; for bfloat16 the pointers and the batch and row strides
// must be 16-byte aligned. window < 0 = none. lse, when not null, receives
// each row's log-sum-exp of scale * q . k over its unmasked keys, fp32,
// contiguous (B, Hq, Sq) (the backward's input); o does not depend on it.
// Requires hd in 16..256 a multiple of 16, Hq % Hkv == 0, Sq >= 1,
// B * Hq <= 65535. Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                                      long long qsb, long long qss, long long ksb,
                                      long long kss, long long vsb, long long vss,
                                      long long osb, long long oss, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || B < 1 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, Hq, Hq / Hkv, qsb, qss, ksb,
               kss, vsb, vss, osb, oss, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(hd, dtype, a);
}

// The backward of flash_attention_launch (same B, Sq, Skv, Hq, Hkv, hd, scale,
// causal, window and dtype): q, k, v with the forward's strides; o, dout and
// dq (B, Sq, Hq, hd), dk and dv (B, Skv, Hkv, hd) contiguous in the dtype;
// lse (the forward's) and delta (scratch) fp32 contiguous (B, Hq, Sq). Three
// launches on `stream`: flash_bwd_preprocess_kernel, flash_bwd_dkdv_kernel,
// flash_bwd_dq_kernel. Requires Sq, Skv >= 1 and the forward's limits.
// Returns the first CUDA error, else cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int Hq, int Hkv, int hd,
                                          long long qsb, long long qss, long long ksb,
                                          long long kss, long long vsb, long long vss,
                                          float scale, int causal, int window, int dtype,
                                          void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || B < 1 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, B, Sq, Skv, Hq, Hq / Hkv, qsb, qss, ksb, kss, vsb, vss, scale,
                  causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch<Bwd>(hd, dtype, a);
}
