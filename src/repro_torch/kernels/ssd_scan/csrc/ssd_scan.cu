// Mamba-2 chunked SSD scan for Hopper (sm_90a), CUDA C++ with plain C entry points.
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_ssd_kernel` of
// src/repro/kernels/ssd_scan/kernel.py. Same function: per (batch b, head h),
// over chunks of Q tokens,
//   L      = inclusive cumsum of dt*A over the chunk
//   y_t    = sum_{s<=t} (C_t.B_s) exp(L_t-L_s) dt_s x_s  +  exp(L_t) C_t.h_prev
//   h      = exp(L_Q) h_prev + sum_s exp(L_Q-L_s) dt_s x_s B_s^T
// plus the D skip, added in fp32 before the single cast of y to x's dtype
// (the TPU wrapper casts first and adds D after; see ref.py).
//
// The dtype picks the kernels, by a fixed rule and not as a fallback:
//   * bfloat16 (ssd_scan_bf16_launch): chunk_state_kernel, state_pass_kernel,
//     chunk_scan_kernel, with the products on the tensor cores;
//   * float32 (ssd_scan_fp32_launch): cb_kernel then scan_kernel, fp32 FMAs
//     on the CUDA cores, so fp32 stays IEEE fp32.
//
// What bounds it on this card: at the serving shapes (B=1, S<=1024, H=32,
// P=64, N=128, Q=128) the function moves ~10 MB and does ~1.6 GFLOP, so its
// least time is set by device-memory bytes (~3 us at 3.35 TB/s), not by the
// tensor cores.
//
// bf16 design: the TPU kernel's sequential chunk axis is split chunk-parallel
// (three launches, all scratch fp32 and allocated by the wrapper):
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
// padded by 16 bytes, so ldmatrix is free of bank conflicts. x, B and C are
// read through their batch and row strides: the split views of the conv
// output need no copy. Any Q <= 128, any S (ragged rows act as padding with
// dt = 0: zero x, B, C, excluded from M, never written), any P (64-channel
// slices, padded to 16), N <= 128 with N % 4 == 0 (padded to 32).
//
// fp32 design, the first version: cb_kernel computes C.B^T once per
// (b, chunk, 32x32 tile of the lower triangle) into an fp32 scratch shared
// by all heads; scan_kernel runs one block per (b, h, 16 head channels),
// walks the chunks in order with its (16, N) state slice in registers and
// the decay tile, B, C and x in ~216 KB of dynamic shared memory. Inputs
// contiguous. When asked, it writes the state entering each chunk for the
// backward.
//
// The backward (ssd_scan_bwd_launch, both dtypes; see its section below):
// cb_kernel and six ssd_bwd_* kernels on the CUDA cores, fp32 arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQMax = 128;    // largest chunk the kernel takes
constexpr int kNMax = 128;    // largest state size the kernel takes
constexpr int kPS = 16;       // head channels per block
constexpr int kThreads = 256;
constexpr int kTile = 32;     // cb_kernel output tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// cb[b, c, t, s] = C_t . B_s for one 32x32 tile of chunk c (tiles above the
// diagonal are skipped: scan_kernel and the backward read only s <= t).
// B and C are read through their batch (*sb) and row (*ss) strides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb,
          int S, int N, int Q, int nc, int64_t bsb, int64_t bss, int64_t csb, int64_t css) {
  const int nt = (Q + kTile - 1) / kTile;
  const int tt = blockIdx.x / nt, ts = blockIdx.x % nt;
  if (ts > tt) return;
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  __shared__ float cs[kTile][kNMax + 1];
  __shared__ float bs[kTile][kNMax + 1];
  for (int idx = tid; idx < kTile * N; idx += kThreads) {
    const int r = idx / N, n = idx % N;
    const int t = tt * kTile + r, s = ts * kTile + r;
    const int64_t tok_t = (int64_t)c * Q + t, tok_s = (int64_t)c * Q + s;
    cs[r][n] = (t < Q && tok_t < S) ? to_f(Cm[b * csb + tok_t * css + n]) : 0.f;
    bs[r][n] = (s < Q && tok_s < S) ? to_f(Bm[b * bsb + tok_s * bss + n]) : 0.f;
  }
  __syncthreads();
  const int sl = tid % kTile;
  const int tl = tid / kTile;     // 0..7, one row per warp: cs reads broadcast
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n = 0; n < N; ++n) {
    const float bv = bs[sl][n];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += cs[tl + 8 * i][n] * bv;
  }
  const int s = ts * kTile + sl;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kTile + tl + 8 * i;
    if (t < Q && s < Q) cb[(((int64_t)b * nc + c) * Q + t) * Q + s] = acc[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ D,
            const float* __restrict__ cb, T* __restrict__ y,
            float* __restrict__ state, float* __restrict__ states, int S, int H, int P, int N,
            int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int Q4 = (Q + 3) & ~3;
  const int MS = Q4 + 4;          // row stride of the decay tile
  const int NS = N + 4;           // row stride of B, C and the state
  float* ms = smem;                       // [kQMax][MS]  decay-weighted C.B^T
  float* cs = ms + kQMax * MS;            // [kQMax][NS]  C of the chunk
  float* bs = cs + kQMax * NS;            // [kQMax][NS]  B of the chunk
  float* xs = bs + kQMax * NS;            // [kQMax][kPS] x slice of the chunk
  float* hs = xs + kQMax * kPS;           // [kPS][NS]    state before the chunk
  float* cum = hs + kPS * NS;             // [kQMax]      L_t
  float* dts = cum + kQMax;               // [kQMax]      dt_t
  float* ws = dts + kQMax;                // [kQMax]      exp(L_Q-L_t) dt_t
  float* wtot = ws + kQMax;               // [4]          warp totals of the scan

  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = A[h];
  const float dskip = D[h];

  // the thread's 8 state values: h[pg2*8 + j][nq]
  const int nq = tid % kQMax, pg2 = tid / kQMax;
  float hreg[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) hreg[j] = 0.f;
  for (int idx = tid; idx < kPS * NS; idx += kThreads) hs[idx] = 0.f;

  // y mapping: rows tg + 32 i (i < 4), channels 2 pg, 2 pg + 1
  const int pg = tid % 8, tg = tid / 8;

  for (int c = 0; c < nc; ++c) {
    const int64_t c0 = (int64_t)c * Q;
    if (states && nq < N) {    // the state entering the chunk, for the backward
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + pg2 * 8 + j;
        if (p < P) states[((((int64_t)b * nc + c) * H + h) * P + p) * N + nq] = hreg[j];
      }
    }
    __syncthreads();
    // 1. dt and the inclusive cumsum of dt*A over the chunk (4 warps)
    float v = 0.f;
    if (tid < kQMax) {
      const bool ok = tid < Q && c0 + tid < S;
      const float d = ok ? dt[((int64_t)b * S + c0 + tid) * H + h] : 0.f;
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
    __syncthreads();
    const float lq = cum[Q - 1];
    if (tid < kQMax) ws[tid] = expf(lq - cum[tid]) * dts[tid];

    // 2. the chunk's x slice, B, C and decay tile into shared memory
    for (int idx = tid; idx < kQMax * kPS; idx += kThreads) {
      const int r = idx / kPS, p = idx % kPS;
      const bool ok = r < Q && c0 + r < S && p0 + p < P;
      xs[idx] = ok ? to_f(x[(((int64_t)b * S + c0 + r) * H + h) * P + p0 + p]) : 0.f;
    }
    for (int idx = tid; idx < kQMax * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      const bool ok = r < Q && c0 + r < S;
      const int64_t g = ((int64_t)b * S + c0 + r) * N + n;
      bs[r * NS + n] = ok ? to_f(Bm[g]) : 0.f;
      cs[r * NS + n] = ok ? to_f(Cm[g]) : 0.f;
    }
    const float* cbc = cb + ((int64_t)b * nc + c) * Q * Q;
    for (int idx = tid; idx < kQMax * Q4; idx += kThreads) {
      const int t = idx / Q4, s = idx % Q4;
      float m = 0.f;
      if (s <= t && t < Q) m = cbc[t * Q + s] * expf(cum[t] - cum[s]) * dts[s];
      ms[t * MS + s] = m;
    }
    __syncthreads();

    // 3. y = M x + exp(L_t) C h_prev^T + D x
    float acc[4][2], inter[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = inter[i][0] = inter[i][1] = 0.f;
    for (int s = 0; s < Q4; s += 4) {
      float2 xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        xv[k] = *reinterpret_cast<const float2*>(&xs[(s + k) * kPS + 2 * pg]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 m = *reinterpret_cast<const float4*>(&ms[(tg + 32 * i) * MS + s]);
        acc[i][0] += m.x * xv[0].x + m.y * xv[1].x + m.z * xv[2].x + m.w * xv[3].x;
        acc[i][1] += m.x * xv[0].y + m.y * xv[1].y + m.z * xv[2].y + m.w * xv[3].y;
      }
    }
    if (c > 0) {
      for (int n = 0; n < N; n += 4) {
        const float4 ha = *reinterpret_cast<const float4*>(&hs[(2 * pg) * NS + n]);
        const float4 hb = *reinterpret_cast<const float4*>(&hs[(2 * pg + 1) * NS + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(&cs[(tg + 32 * i) * NS + n]);
          inter[i][0] += cv.x * ha.x + cv.y * ha.y + cv.z * ha.z + cv.w * ha.w;
          inter[i][1] += cv.x * hb.x + cv.y * hb.y + cv.z * hb.z + cv.w * hb.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg + 32 * i;
      if (t < Q && c0 + t < S) {
        const float et = expf(cum[t]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 2 * pg + j;
          if (p0 + p < P) {
            const float out = acc[i][j] + et * inter[i][j] + dskip * xs[t * kPS + p];
            y[(((int64_t)b * S + c0 + t) * H + h) * P + p0 + p] = from_f<T>(out);
          }
        }
      }
    }

    // 4. state: h = exp(L_Q) h + sum_s ws_s x_s B_s^T, kept in registers
    if (nq < N) {
      const float dq = expf(lq);
#pragma unroll
      for (int j = 0; j < 8; ++j) hreg[j] *= dq;
      for (int s = 0; s < Q4; ++s) {
        const float bw = bs[s * NS + nq] * ws[s];
        const float4 xa = *reinterpret_cast<const float4*>(&xs[s * kPS + pg2 * 8]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[s * kPS + pg2 * 8 + 4]);
        hreg[0] += xa.x * bw; hreg[1] += xa.y * bw; hreg[2] += xa.z * bw; hreg[3] += xa.w * bw;
        hreg[4] += xb.x * bw; hreg[5] += xb.y * bw; hreg[6] += xb.z * bw; hreg[7] += xb.w * bw;
      }
    }
    __syncthreads();   // every read of hs in step 3 is done
    if (nq < N) {
#pragma unroll
      for (int j = 0; j < 8; ++j) hs[(pg2 * 8 + j) * NS + nq] = hreg[j];
    }
  }

  if (nq < N) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + pg2 * 8 + j;
      if (p < P) state[(((int64_t)b * H + h) * P + p) * N + nq] = hreg[j];
    }
  }
}

// dynamic shared memory of scan_kernel for Q rounded up to Q4 (the layout
// at the top of scan_kernel)
constexpr size_t scan_smem_bytes(int Q4, int N) {
  return sizeof(float) * ((size_t)kQMax * (Q4 + 4) + 2 * (size_t)kQMax * (N + 4) +
                          kQMax * kPS + kPS * (N + 4) + 3 * kQMax + 4);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, void* cb, void* y, void* state, void* states, int Bsz, int S, int H,
           int P, int N, int Q, cudaStream_t st) {
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + kTile - 1) / kTile;
  const int64_t sn = (int64_t)S * N;
  cb_kernel<T><<<dim3(nt * nt, nc, Bsz), kThreads, 0, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(cb), S, N,
      Q, nc, sn, N, sn, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = scan_smem_bytes((Q + 3) & ~3, N);
  // the attribute belongs to the device: raise it to the largest block once per device
  static int attr_dev = -1;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != attr_dev) {
    e = cudaFuncSetAttribute(scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scan_smem_bytes(kQMax, kNMax));
    if (e != cudaSuccess) return (int)e;
    attr_dev = dev;
  }
  scan_kernel<T><<<dim3((P + kPS - 1) / kPS, H, Bsz), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(cb), static_cast<T*>(y), static_cast<float*>(state),
      static_cast<float*>(states), S, H, P, N, Q, nc);
  return (int)cudaGetLastError();
}


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

// Stage a (rows, wpad) bf16 tile of pitch `pitch`: element (r, c) is
// src[r * rs + c] for r < nvalid and c < width, else 0. `vec` bf16 go per
// copy (8, 4 or 2 by cp.async with zero-fill for the rest; 1 by plain
// loads); the launcher picks the widest that the pointer, the strides and
// width allow. wpad is a multiple of 16.
__device__ __forceinline__ void stage(bf16* dst, int pitch, const bf16* __restrict__ src,
                                      int64_t rs, int rows, int nvalid, int width, int wpad,
                                      int vec) {
  const int per_row = wpad / vec;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kMmaThreads) {
    const int r = idx / per_row, c = (idx % per_row) * vec;
    const bool ok = r < nvalid && c < width;
    const bf16* s = ok ? src + (int64_t)r * rs + c : src;
    bf16* d = dst + r * pitch + c;
    const int bytes = ok ? 2 * vec : 0;
    if (vec == 8) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(d)), "l"(s), "r"(bytes));
    } else if (vec == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(smem_addr(d)), "l"(s), "r"(bytes));
    } else if (vec == 2) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(d)), "l"(s), "r"(bytes));
    } else {
      *d = ok ? *s : __float2bfloat16(0.f);
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

struct Bf16Args {
  const bf16 *x, *Bm, *Cm;
  const float *dt, *A, *D;
  bf16* y;
  float *state, *states, *lq;
  int Bsz, S, H, P, N, Q, nc;
  int64_t xsb, xss, bsb, bss, csb, css;
  int vx, vb, vc;                // copy widths (bf16 per copy)
};

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

// In place over states: for each chunk in order, S_c is replaced by the
// state before the chunk, h_prev, and h <- exp(L_Q,c) h + S_c; the last h
// is the final state. Grid (ceil(P N / 4 / 256), H, Bsz), 4 values a thread.
__global__ void __launch_bounds__(256)
state_pass_kernel(Bf16Args a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t PN = (int64_t)a.P * a.N;
  const int64_t e = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= PN) return;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* cur = reinterpret_cast<float4*>(a.states + ((int64_t)b * a.nc * a.H + h) * PN + e);
  const int64_t step = a.H * PN / 4;                 // float4s from chunk c to c + 1
  const float* lq = a.lq + (int64_t)b * a.nc * a.H + h;
  float4 sv = *cur;
  for (int c = 0; c < a.nc; ++c) {
    const float4 next = c + 1 < a.nc ? cur[step] : sv;   // prefetch the next chunk's S
    const float d = expf(lq[(int64_t)c * a.H]);
    *cur = hv;
    hv = make_float4(d * hv.x + sv.x, d * hv.y + sv.y, d * hv.z + sv.z, d * hv.w + sv.w);
    sv = next;
    cur += step;
  }
  *reinterpret_cast<float4*>(a.state + ((int64_t)b * a.H + h) * PN + e) = hv;
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
  state_pass_kernel<<<dim3((n4 + 255) / 256, a.H, a.Bsz), 256, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // half-width channel slices when full ones would leave SMs idle (132 on an H100)
  const int pb = (long long)a.nc * a.H * a.Bsz * ((a.P + kPB - 1) / kPB) < 132 ? kPB / 2 : kPB;
  chunk_scan_kernel<<<dim3(a.nc, a.H, a.Bsz * ((a.P + pb - 1) / pb)), kMmaThreads,
                      chunk_scan_smem(Qp, a.N, pb), st>>>(a, pb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward, both dtypes: fp32 arithmetic on the CUDA cores
// ---------------------------------------------------------------------------
//
// Per (b, h) and chunk c, with L the inclusive cumsum of dt A over the chunk
// (the forward's warp scan, so the same bits), w_s = exp(L_Q - L_s) dt_s,
// M'_ts = (C_t.B_s) exp(L_t - L_s) on s <= t and dH_c the gradient of the
// state after chunk c (see ref.py's ssd_chunked_bwd_ref):
//   1. cb_kernel: C.B^T per chunk, shared by the heads (as in the forward);
//   2. ssd_bwd_dstate_kernel, grid (nc, H, B x 64-channel slices): L and L_Q to
//      scratch, U_c = sum_t exp(L_t) dy_t^T C_t to dstates;
//   3. ssd_bwd_state_pass_kernel: in place over dstates, the chunks in reverse,
//      dH_c = dhT for the last, dH_c-1 = exp(L_Q,c) dH_c + U_c;
//   4. ssd_bwd_chunk_kernel, grid (nc, H, B): per head, in 32-channel passes,
//      dxi_s = sum_t M'_ts dy_t, dxs_s = dH_c B_s, dx = dt dxi + w dxs + D dy,
//      and the per-row dots behind dL (dy.yi with yi the forward's intra y,
//      exp(L_t) dy.(C_t h_prev^T), x.dxi, x.dxs); then dL, its reverse
//      cumsum within the chunk (a fixed-order warp scan), ddt, and the
//      chunk's partial sums of dA and dD;
//   5. ssd_bwd_ds_kernel, grid (32x32 tiles of the lower triangle, nc, B):
//      dS_ts = sum_h exp(L_t - L_s) dt_s (dy_t.x_s), the heads in order;
//   6. ssd_bwd_bc_kernel, grid (32-row tiles, nc, B x {dC, dB}):
//      dC_t = sum_s dS_ts B_s + sum_h exp(L_t) dy_t h_prev,
//      dB_s = sum_t dS_ts C_t + sum_h w_s x_s dH_c, the heads in order;
//   7. ssd_bwd_reduce_kernel: dA and dD over (b, chunk) in order.
// No atomics: every sum has one order, so a rerun gives the same bits. The
// exponent is masked before exp (s <= t), so nothing overflows. Ragged rows
// (past S in the last chunk) read as zero (dt = 0) and are never written.
// What bounds it: at the training shapes (8, 256, 32 or 64 heads of 64,
// N = 128 or 64) ~6.6 GFLOP against ~75 MB, so fp32 operations on the CUDA
// cores; this first version is simple and correct, not tuned.

constexpr int kPW = 64;   // head channels per block: dstate, ds and bc kernels
constexpr int kPC = 32;   // head channels per pass of ssd_bwd_chunk_kernel
constexpr int kMS = kQMax + 4;   // row stride of the Q x Q tiles in shared memory

template <typename T>
struct BwdArgs {
  const T *x, *Bm, *Cm, *dy;
  const float *dt, *A, *D, *h_prev, *dhT;
  T *dx, *dB, *dC;
  float *ddt, *dA, *dD;
  float *cb, *cum, *lq, *dstates, *dS, *dA_part, *dD_part;
  int Bsz, S, H, P, N, Q, nc;
  int64_t xsb, xss, bsb, bss, csb, css;

  // x, B, C through their strides; dt, dy, dx, ddt, dB, dC contiguous
  __device__ float xv(int b, int64_t tok, int h, int p) const {
    return to_f(x[b * xsb + tok * xss + (int64_t)h * P + p]);
  }
  __device__ float bv(int b, int64_t tok, int n) const { return to_f(Bm[b * bsb + tok * bss + n]); }
  __device__ float cv(int b, int64_t tok, int n) const { return to_f(Cm[b * csb + tok * css + n]); }
  __device__ float dyv(int b, int64_t tok, int h, int p) const {
    return to_f(dy[(((int64_t)b * S + tok) * H + h) * P + p]);
  }
  // index of (b, chunk c, head h) in the (B, nc, H, ...) scratch
  __device__ int64_t bch(int b, int c, int h) const { return ((int64_t)b * nc + c) * H + h; }
};

// the sum of v over the block, in one order, returned to every thread (all
// kThreads threads call it; red holds kThreads / 32 floats)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

constexpr size_t dstate_smem(int N) {
  return sizeof(float) * ((size_t)kQMax * (N + 4) + kQMax * kPW + 2 * kQMax + 4);
}

// U_c[p, n] = sum_t exp(L_t) dy_t[p] C_t[n] for one (chunk, head, batch,
// slice of kPW channels) into dstates (B, nc, H, P, N); L to cum (B, nc, H,
// Q) and L_Q to lq (B, nc, H). Thread: n = 4 lane .. + 3, p = warp + 8 j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_kernel(BwdArgs<T> a) {
  const int c = blockIdx.x, h = blockIdx.y;
  const int npb = (a.P + kPW - 1) / kPW;
  const int b = blockIdx.z / npb, p0 = (blockIdx.z % npb) * kPW;
  const int nv = min(a.Q, a.S - c * a.Q), NS = a.N + 4, tid = threadIdx.x;
  const int64_t tok0 = (int64_t)c * a.Q, row0 = (int64_t)b * a.S + tok0;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                     // [kQMax][NS]  C of the chunk
  float* ys = cs + kQMax * NS;          // [kQMax][kPW] exp(L_t) dy_t, the slice's channels
  float* dts = ys + kQMax * kPW;        // [kQMax]
  float* cum = dts + kQMax;             // [kQMax]
  float* wtot = cum + kQMax;            // [4]

  chunk_cumsum(a.dt, row0, a.H, h, a.A[h], nv, dts, cum, wtot);
  for (int idx = tid; idx < a.Q * a.N; idx += kThreads) {
    const int r = idx / a.N, n = idx % a.N;
    cs[r * NS + n] = r < nv ? a.cv(b, tok0 + r, n) : 0.f;
  }
  __syncthreads();
  const int64_t base = a.bch(b, c, h);
  if (p0 == 0 && tid < a.Q) a.cum[base * a.Q + tid] = cum[tid];
  if (p0 == 0 && tid == 0) a.lq[base] = cum[a.Q - 1];
  for (int idx = tid; idx < a.Q * kPW; idx += kThreads) {
    const int r = idx / kPW, p = idx % kPW;
    ys[idx] = (r < nv && p0 + p < a.P) ? expf(cum[r]) * a.dyv(b, tok0 + r, h, p0 + p) : 0.f;
  }
  __syncthreads();

  const int n = 4 * (tid & 31), pr = tid >> 5;
  if (n >= a.N) return;                 // no sync follows
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int t = 0; t < nv; ++t) {
    const float4 cv = *reinterpret_cast<const float4*>(&cs[t * NS + n]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float yv = ys[t * kPW + pr + 8 * j];
      acc[j][0] += yv * cv.x; acc[j][1] += yv * cv.y; acc[j][2] += yv * cv.z; acc[j][3] += yv * cv.w;
    }
  }
  float* out = a.dstates + base * a.P * a.N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = p0 + pr + 8 * j;
    if (p < a.P)
      *reinterpret_cast<float4*>(out + (int64_t)p * a.N + n) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

// In place over dstates, the chunks in reverse: slot c receives dH_c (the
// gradient of the state after chunk c; dhT, or 0 when null, for the last)
// and the carry becomes exp(L_Q,c) dH_c + U_c. Grid (ceil(P N / 1024), H, B).
__global__ void __launch_bounds__(256)
ssd_bwd_state_pass_kernel(const float* __restrict__ dhT, float* __restrict__ dstates,
                      const float* __restrict__ lq, int H, int P, int N, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t PN = (int64_t)P * N;
  const int64_t e = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= PN) return;
  float4 g = dhT ? *reinterpret_cast<const float4*>(dhT + ((int64_t)b * H + h) * PN + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* base = reinterpret_cast<float4*>(dstates + ((int64_t)b * nc * H + h) * PN + e);
  const int64_t step = H * PN / 4;                  // float4s from chunk c to c + 1
  for (int c = nc - 1; c >= 0; --c) {
    float4* cur = base + c * step;
    const float4 u = *cur;
    *cur = g;
    const float d = expf(lq[((int64_t)b * nc + c) * H + h]);
    g = make_float4(d * g.x + u.x, d * g.y + u.y, d * g.z + u.z, d * g.w + u.w);
  }
}

constexpr size_t chunk_smem(int N) {
  return sizeof(float) * ((size_t)kQMax * kMS + (size_t)kQMax * (N + 4) + (size_t)kPC * (N + 4) +
                          2 * kQMax * kPC + 5 * kQMax + kThreads / 32);
}

// dx, ddt and the chunk's partial dA and dD for one (chunk, head, batch).
// Thread tile: rows r_i = tg + 32 i (i < 4), channels p0 + pc + 8 j (j < 4)
// of each 32-channel pass.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(BwdArgs<T> a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = min(a.Q, a.S - c * a.Q), Q4 = (a.Q + 3) & ~3, NS = a.N + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = tid >> 3, pc = tid & 7;
  const int64_t tok0 = (int64_t)c * a.Q;
  const int64_t base = a.bch(b, c, h);
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                     // [kQMax][kMS]  M'_ts
  float* mat = ms + kQMax * kMS;        // [kQMax][NS]   C, then B
  float* st = mat + kQMax * NS;         // [kPC][NS]     h_prev, then dH_c, of the pass
  float* xs = st + kPC * NS;            // [kQMax][kPC]  x of the pass
  float* dys = xs + kQMax * kPC;        // [kQMax][kPC]  dy of the pass
  float* dts = dys + kQMax * kPC;       // [kQMax]       dt
  float* cum = dts + kQMax;             // [kQMax]       L
  float* plus = cum + kQMax;            // [kQMax]       dy.yi + exp(L_t) dy.(C_t h_prev^T)
  float* xdi = plus + kQMax;            // [kQMax]       x.dxi
  float* xds = xdi + kQMax;             // [kQMax]       x.dxs
  float* red = xds + kQMax;             // [kThreads / 32]

  if (tid < kQMax) {
    dts[tid] = tid < nv ? a.dt[((int64_t)b * a.S + tok0 + tid) * a.H + h] : 0.f;
    cum[tid] = tid < a.Q ? a.cum[base * a.Q + tid] : 0.f;
  }
  __syncthreads();
  const float lq = cum[a.Q - 1];
  const float* cbc = a.cb + ((int64_t)b * a.nc + c) * a.Q * a.Q;
  for (int idx = tid; idx < kQMax * kQMax; idx += kThreads) {
    const int t = idx / kQMax, s = idx % kQMax;
    ms[t * kMS + s] = (s <= t && t < nv) ? cbc[t * a.Q + s] * expf(cum[t] - cum[s]) : 0.f;
  }

  float rplus[4] = {0.f, 0.f, 0.f, 0.f}, rxdi[4] = {0.f, 0.f, 0.f, 0.f};
  float rxds[4] = {0.f, 0.f, 0.f, 0.f};
  float ddot = 0.f, dd = 0.f;           // h_prev . dH over the thread's entries; dy . x
  const float dsk = a.D[h];
  for (int p0 = 0; p0 < a.P; p0 += kPC) {
    __syncthreads();                    // the previous pass is done with the tiles
    for (int idx = tid; idx < kQMax * kPC; idx += kThreads) {
      const int r = idx / kPC, p = idx % kPC;
      const bool ok = r < nv && p0 + p < a.P;
      xs[idx] = ok ? a.xv(b, tok0 + r, h, p0 + p) : 0.f;
      dys[idx] = ok ? a.dyv(b, tok0 + r, h, p0 + p) : 0.f;
    }
    for (int idx = tid; idx < kQMax * a.N; idx += kThreads) {
      const int r = idx / a.N, n = idx % a.N;
      mat[r * NS + n] = r < nv ? a.cv(b, tok0 + r, n) : 0.f;
    }
    for (int idx = tid; idx < kPC * a.N; idx += kThreads) {
      const int p = idx / a.N, n = idx % a.N;
      st[p * NS + n] = p0 + p < a.P ? a.h_prev[(base * a.P + p0 + p) * a.N + n] : 0.f;
    }
    __syncthreads();

    // the intra-chunk terms: yi_t = sum_s M'_ts dt_s x_s, dxi_s = sum_t M'_ts dy_t
    float yi[4][4], dxi[4][4], yh[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yi[i][j] = dxi[i][j] = yh[i][j] = 0.f;
    for (int s = 0; s < Q4; s += 4) {
      float xv[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = dts[s + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[k][j] = d * xs[(s + k) * kPC + pc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 m = *reinterpret_cast<const float4*>(&ms[(tg + 32 * i) * kMS + s]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          yi[i][j] += m.x * xv[0][j] + m.y * xv[1][j] + m.z * xv[2][j] + m.w * xv[3][j];
      }
    }
    for (int t = 0; t < nv; ++t) {
      float dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = dys[t * kPC + pc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m = ms[t * kMS + tg + 32 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) dxi[i][j] += m * dv[j];
      }
    }
    // the inter-chunk term: yh_t = C_t h_prev^T
    for (int n = 0; n < a.N; n += 4) {
      float4 hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = *reinterpret_cast<const float4*>(&st[(pc + 8 * j) * NS + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 cv = *reinterpret_cast<const float4*>(&mat[(tg + 32 * i) * NS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          yh[i][j] += cv.x * hv[j].x + cv.y * hv[j].y + cv.z * hv[j].z + cv.w * hv[j].w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tg + 32 * i;
      const float el = expf(cum[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dv = dys[r * kPC + pc + 8 * j], xv = xs[r * kPC + pc + 8 * j];
        rplus[i] += dv * (yi[i][j] + el * yh[i][j]);
        rxdi[i] += xv * dxi[i][j];
        dd += dv * xv;
      }
    }
    __syncthreads();                    // done with C and h_prev
    for (int idx = tid; idx < kQMax * a.N; idx += kThreads) {
      const int r = idx / a.N, n = idx % a.N;
      mat[r * NS + n] = r < nv ? a.bv(b, tok0 + r, n) : 0.f;
    }
    const float* dh = a.dstates + base * a.P * a.N;
    for (int idx = tid; idx < kPC * a.N; idx += kThreads) {
      const int p = idx / a.N, n = idx % a.N;
      const bool ok = p0 + p < a.P;
      const float g = ok ? dh[(int64_t)(p0 + p) * a.N + n] : 0.f;
      st[p * NS + n] = g;
      if (ok) ddot += a.h_prev[(base * a.P + p0 + p) * a.N + n] * g;
    }
    __syncthreads();
    // the state term: dxs_s = dH_c B_s; then dx
    float dxs[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dxs[i][j] = 0.f;
    for (int n = 0; n < a.N; n += 4) {
      float4 gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = *reinterpret_cast<const float4*>(&st[(pc + 8 * j) * NS + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 bv = *reinterpret_cast<const float4*>(&mat[(tg + 32 * i) * NS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dxs[i][j] += bv.x * gv[j].x + bv.y * gv[j].y + bv.z * gv[j].z + bv.w * gv[j].w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tg + 32 * i;
      const float w = expf(lq - cum[r]) * dts[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + pc + 8 * j;
        const float dv = dys[r * kPC + pc + 8 * j], xv = xs[r * kPC + pc + 8 * j];
        rxds[i] += xv * dxs[i][j];
        if (r < nv && p < a.P)
          a.dx[(((int64_t)b * a.S + tok0 + r) * a.H + h) * a.P + p] =
              from_f<T>(dts[r] * dxi[i][j] + w * dxs[i][j] + dsk * dv);
      }
    }
  }

  // the row dots: the 8 threads of a row group hold its partial sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      rplus[i] += __shfl_xor_sync(0xffffffffu, rplus[i], off);
      rxdi[i] += __shfl_xor_sync(0xffffffffu, rxdi[i], off);
      rxds[i] += __shfl_xor_sync(0xffffffffu, rxds[i], off);
    }
    if (pc == 0) {
      plus[tg + 32 * i] = rplus[i];
      xdi[tg + 32 * i] = rxdi[i];
      xds[tg + 32 * i] = rxds[i];
    }
  }
  const float dD = block_sum(dd, red);
  const float decay = expf(lq) * block_sum(ddot, red);   // syncs: plus, xdi, xds are written
  // dL_t = dy.yi + exp(L_t) dy.yh - dt_t (x.dxi + exp(L_Q - L_t) x.dxs), and
  // at t = Q - 1 the state and chunk-decay terms
  float direct = 0.f, dL = 0.f, wx = 0.f;
  if (tid < kQMax) {
    const float tl = expf(lq - cum[tid]);
    direct = xdi[tid] + tl * xds[tid];
    dL = plus[tid] - dts[tid] * direct;
    wx = tl * dts[tid] * xds[tid];
  }
  const float state_term = block_sum(wx, red);
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
  const float a_h = a.A[h];
  if (tid < nv) a.ddt[((int64_t)b * a.S + tok0 + tid) * a.H + h] = direct + a_h * da;
  const float dA = block_sum(tid < kQMax ? dts[tid] * da : 0.f, red);
  if (tid == 0) {
    a.dA_part[base] = dA;
    a.dD_part[base] = dD;
  }
}

// dS_ts = sum_h exp(L_t - L_s) dt_s (dy_t . x_s) on s <= t for one 32x32
// tile of chunk c (tiles above the diagonal are skipped; entries above it in
// a diagonal tile are written 0). Thread: s = lane, t = warp + 8 i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_ds_kernel(BwdArgs<T> a) {
  const int nt = (a.Q + kTile - 1) / kTile;
  const int tt = blockIdx.x / nt, ts = blockIdx.x % nt;
  if (ts > tt) return;
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nv = min(a.Q, a.S - c * a.Q);
  const int64_t tok0 = (int64_t)c * a.Q;
  __shared__ float dyt[kTile][kPW + 1];   // dy, rows t of the tile, one head's channel slice
  __shared__ float xt[kTile][kPW + 1];    // x, rows s
  __shared__ float lt[kTile], ls[kTile], dls[kTile];
  const int sl = tid % kTile, tl = tid / kTile;
  const int s = ts * kTile + sl;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h = 0; h < a.H; ++h) {
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < a.P; p0 += kPW) {
      __syncthreads();
      for (int idx = tid; idx < kTile * kPW; idx += kThreads) {
        const int r = idx / kPW, p = idx % kPW;
        const int t_r = tt * kTile + r, s_r = ts * kTile + r;
        const bool okp = p0 + p < a.P;
        dyt[r][p] = (t_r < nv && okp) ? a.dyv(b, tok0 + t_r, h, p0 + p) : 0.f;
        xt[r][p] = (s_r < nv && okp) ? a.xv(b, tok0 + s_r, h, p0 + p) : 0.f;
      }
      if (p0 == 0 && tid < kTile) {
        const int64_t cb0 = a.bch(b, c, h) * a.Q;
        const int t_r = tt * kTile + tid, s_r = ts * kTile + tid;
        lt[tid] = t_r < a.Q ? a.cum[cb0 + t_r] : 0.f;
        ls[tid] = s_r < a.Q ? a.cum[cb0 + s_r] : 0.f;
        dls[tid] = s_r < nv ? a.dt[((int64_t)b * a.S + tok0 + s_r) * a.H + h] : 0.f;
      }
      __syncthreads();
      const int pw = min(kPW, a.P - p0);
      for (int p = 0; p < pw; ++p) {
        const float xv = xt[sl][p];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] += dyt[tl + 8 * i][p] * xv;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tt * kTile + tl + 8 * i;
      if (s <= t && t < nv) acc[i] += g[i] * expf(lt[tl + 8 * i] - ls[sl]) * dls[sl];
    }
  }
  float* out = a.dS + ((int64_t)b * a.nc + c) * a.Q * a.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kTile + tl + 8 * i;
    if (t < a.Q && s < a.Q) out[(int64_t)t * a.Q + s] = s <= t ? acc[i] : 0.f;
  }
}

constexpr size_t bc_smem(int N) {
  return sizeof(float) * ((size_t)kQMax * (N + 4) + (size_t)kTile * kMS + kTile * kPW);
}

// dC (blockIdx.z even) or dB (odd) for 32 rows of chunk c:
//   dC_t = sum_{s<=t} dS_ts B_s + sum_h exp(L_t) sum_p dy_t[p] h_prev[p, :]
//   dB_s = sum_{t>=s} dS_ts C_t + sum_h w_s sum_p x_s[p] dH_c[p, :]
// the heads in order. Thread: rows warp + 8 i, n = 4 lane .. + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(BwdArgs<T> a) {
  const int r0 = blockIdx.x * kTile, c = blockIdx.y;
  const int b = blockIdx.z >> 1, is_db = blockIdx.z & 1;
  const int nv = min(a.Q, a.S - c * a.Q), NS = a.N + 4, tid = threadIdx.x;
  const int64_t tok0 = (int64_t)c * a.Q;
  extern __shared__ __align__(16) float smem[];
  float* mat = smem;                    // [kQMax][NS] B or C; later [kPW][NS] a head's state slice
  float* sds = mat + kQMax * NS;        // [kTile][kMS] dS rows (dC) or columns (dB)
  float* ops = sds + kTile * kMS;       // [kTile][kPW] exp(L_t) dy_t or w_s x_s, one head's slice
  const int rg = tid >> 5, n = 4 * (tid & 31);

  for (int idx = tid; idx < kQMax * a.N; idx += kThreads) {
    const int r = idx / a.N, nn = idx % a.N;
    mat[r * NS + nn] = r < nv ? (is_db ? a.cv(b, tok0 + r, nn) : a.bv(b, tok0 + r, nn)) : 0.f;
  }
  const float* dsc = a.dS + ((int64_t)b * a.nc + c) * a.Q * a.Q;
  for (int idx = tid; idx < kTile * kQMax; idx += kThreads) {
    const int i = idx / kQMax, k = idx % kQMax, row = r0 + i;
    const int t = is_db ? k : row, s = is_db ? row : k;
    sds[i * kMS + k] = (s <= t && t < nv) ? dsc[(int64_t)t * a.Q + s] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (n < a.N) {
    for (int k = 0; k < nv; ++k) {
      const float4 mv = *reinterpret_cast<const float4*>(&mat[k * NS + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = sds[(rg + 8 * i) * kMS + k];
        acc[i][0] += d * mv.x; acc[i][1] += d * mv.y; acc[i][2] += d * mv.z; acc[i][3] += d * mv.w;
      }
    }
  }
  const float* state = is_db ? a.dstates : a.h_prev;
  for (int h = 0; h < a.H; ++h) {
    const int64_t base = a.bch(b, c, h);
    const float lq = a.lq[base];
    for (int p0 = 0; p0 < a.P; p0 += kPW) {
      __syncthreads();                  // the last reads of mat and ops are done
      for (int idx = tid; idx < kPW * a.N; idx += kThreads) {
        const int p = idx / a.N, nn = idx % a.N;
        mat[p * NS + nn] = p0 + p < a.P ? state[(base * a.P + p0 + p) * a.N + nn] : 0.f;
      }
      for (int idx = tid; idx < kTile * kPW; idx += kThreads) {
        const int i = idx / kPW, p = idx % kPW, row = r0 + i;
        float v = 0.f;
        if (row < nv && p0 + p < a.P) {
          const float L = a.cum[base * a.Q + row];
          v = is_db ? expf(lq - L) * a.dt[((int64_t)b * a.S + tok0 + row) * a.H + h] *
                          a.xv(b, tok0 + row, h, p0 + p)
                    : expf(L) * a.dyv(b, tok0 + row, h, p0 + p);
        }
        ops[idx] = v;
      }
      __syncthreads();
      if (n < a.N) {
        const int pw = min(kPW, a.P - p0);
        for (int p = 0; p < pw; ++p) {
          const float4 sv = *reinterpret_cast<const float4*>(&mat[p * NS + n]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float o = ops[(rg + 8 * i) * kPW + p];
            acc[i][0] += o * sv.x; acc[i][1] += o * sv.y; acc[i][2] += o * sv.z; acc[i][3] += o * sv.w;
          }
        }
      }
    }
  }
  if (n >= a.N) return;
  T* out = is_db ? a.dB : a.dC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg + 8 * i;
    if (row < nv) {
      T* o = out + ((int64_t)b * a.S + tok0 + row) * a.N + n;
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = from_f<T>(acc[i][k]);
    }
  }
}

// dA and dD: the chunks' partial sums over (b, chunk) in order
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dA_part,
                                  const float* __restrict__ dD_part, float* __restrict__ dA,
                                  float* __restrict__ dD, int n_bc, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int i = 0; i < n_bc; ++i) {
    sa += dA_part[(int64_t)i * H + h];
    sd += dD_part[(int64_t)i * H + h];
  }
  dA[h] = sa;
  dD[h] = sd;
}

template <typename T>
int launch_bwd(const BwdArgs<T>& a, cudaStream_t st) {
  static int dev_dstate = -1, dev_chunk = -1, dev_bc = -1;
  cudaError_t e = raise_smem_limit(ssd_bwd_dstate_kernel<T>, dstate_smem(kNMax), dev_dstate);
  if (e != cudaSuccess) return (int)e;
  e = raise_smem_limit(ssd_bwd_chunk_kernel<T>, chunk_smem(kNMax), dev_chunk);
  if (e != cudaSuccess) return (int)e;
  e = raise_smem_limit(ssd_bwd_bc_kernel<T>, bc_smem(kNMax), dev_bc);
  if (e != cudaSuccess) return (int)e;
  const int nt = (a.Q + kTile - 1) / kTile;
  cb_kernel<T><<<dim3(nt * nt, a.nc, a.Bsz), kThreads, 0, st>>>(a.Bm, a.Cm, a.cb, a.S, a.N, a.Q,
                                                                a.nc, a.bsb, a.bss, a.csb, a.css);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dstate_kernel<T><<<dim3(a.nc, a.H, a.Bsz * ((a.P + kPW - 1) / kPW)), kThreads,
                         dstate_smem(a.N), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int n4 = a.P * a.N / 4;
  ssd_bwd_state_pass_kernel<<<dim3((n4 + 255) / 256, a.H, a.Bsz), 256, 0, st>>>(
      a.dhT, a.dstates, a.lq, a.H, a.P, a.N, a.nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_chunk_kernel<T><<<dim3(a.nc, a.H, a.Bsz), kThreads, chunk_smem(a.N), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_ds_kernel<T><<<dim3(nt * nt, a.nc, a.Bsz), kThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_bc_kernel<T><<<dim3(nt, a.nc, 2 * a.Bsz), kThreads, bc_smem(a.N), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_reduce_kernel<<<(a.H + 127) / 128, 128, 0, st>>>(a.dA_part, a.dD_part, a.dA, a.dD,
                                                        a.Bsz * a.nc, a.H);
  return (int)cudaGetLastError();
}

}  // namespace

// float32: x, Bm, Cm, y, dt, A, D, state, cb all float32 and contiguous:
// x, y (B,S,H,P); dt (B,S,H); Bm, Cm (B,S,N); A, D (H,); state (B,H,P,N);
// cb scratch (B, ceil(S/Q), Q, Q); states (B, ceil(S/Q), H, P, N) receives
// the state entering each chunk, or is null.
// Requires 1 <= Q <= 128, N <= 128, N % 4 == 0. Returns cudaGetLastError().
extern "C" int ssd_scan_fp32_launch(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, const void* D, void* cb,
                                    void* y, void* state, void* states, int Bsz, int S, int H,
                                    int P, int N, int Q, void* stream) {
  if (!D || Q < 1 || Q > kQMax || N > kNMax || N % 4 != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(x, dt, A, Bm, Cm, D, cb, y, state, states, Bsz, S, H, P, N, Q,
                       static_cast<cudaStream_t>(stream));
}

// bfloat16: x (B,S,H,P) with head stride P and element stride 1, Bm, Cm
// (B,S,N) with element stride 1, each with its batch (*sb) and row (*ss)
// strides in elements; vx, vb, vc bf16 per copy (8, 4, 2 or 1) dividing each
// tensor's pointer alignment, strides and row width. dt (B,S,H), A, D (H,)
// float32 contiguous. Out: y (B,S,H,P) bf16 contiguous, state (B,H,P,N)
// float32; scratch: states (B, ceil(S/Q), H, P, N) and lq (B, ceil(S/Q), H)
// float32. Requires 1 <= Q <= 128, N <= 128, N % 4 == 0.
// Returns cudaGetLastError().
extern "C" int ssd_scan_bf16_launch(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, const void* D, void* y,
                                    void* state, void* states, void* lq, int Bsz, int S, int H,
                                    int P, int N, int Q, long long xsb, long long xss,
                                    long long bsb, long long bss, long long csb,
                                    long long css, int vx, int vb, int vc, void* stream) {
  auto vec_ok = [](int v) { return v == 1 || v == 2 || v == 4 || v == 8; };
  if (!D || Q < 1 || Q > kQMax || N > kNMax || N % 4 != 0 || !vec_ok(vx) || !vec_ok(vb) ||
      !vec_ok(vc))
    return (int)cudaErrorInvalidValue;
  const Bf16Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(Bm),
                   static_cast<const bf16*>(Cm), static_cast<const float*>(dt),
                   static_cast<const float*>(A), static_cast<const float*>(D),
                   static_cast<bf16*>(y), static_cast<float*>(state),
                   static_cast<float*>(states), static_cast<float*>(lq),
                   Bsz, S, H, P, N, Q, (S + Q - 1) / Q, xsb, xss, bsb, bss, csb, css,
                   vx, vb, vc};
  return launch_bf16(a, static_cast<cudaStream_t>(stream));
}

// The backward of either forward: x, Bm, Cm, dy and the outputs dx, dB, dC
// in the forward's dtype (bf16 != 0: bfloat16, else float32), the rest
// float32. x (B,S,H,P) with head stride P and element stride 1, Bm, Cm
// (B,S,N) with element stride 1, each with its batch (*sb) and row (*ss)
// strides in elements; dt, dy, dx (B,S,H[,P]), dB, dC (B,S,N) contiguous;
// h_prev (B, nc, H, P, N) the forward's states; dhT (B,H,P,N) or null.
// Out: dx, ddt (B,S,H), dA, dD (H,), dB, dC. Scratch: cb, dS (B, nc, Q, Q),
// cum (B, nc, H, Q), lq, dA_part, dD_part (B, nc, H), dstates (B, nc, H, P, N).
// Requires 1 <= Q <= 128, N <= 128, N % 4 == 0. Returns cudaGetLastError().
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, const void* D, const void* h_prev,
                                   const void* dy, const void* dhT, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* dD, void* cb, void* cum,
                                   void* lq, void* dstates, void* dS, void* dA_part,
                                   void* dD_part, int Bsz, int S, int H, int P, int N, int Q,
                                   long long xsb, long long xss, long long bsb, long long bss,
                                   long long csb, long long css, int bf16_in, void* stream) {
  if (!D || Q < 1 || Q > kQMax || N > kNMax || N % 4 != 0) return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(Bm),
                       static_cast<const T*>(Cm), static_cast<const T*>(dy),
                       static_cast<const float*>(dt), static_cast<const float*>(A),
                       static_cast<const float*>(D), static_cast<const float*>(h_prev),
                       static_cast<const float*>(dhT), static_cast<T*>(dx), static_cast<T*>(dB),
                       static_cast<T*>(dC), static_cast<float*>(ddt), static_cast<float*>(dA),
                       static_cast<float*>(dD), static_cast<float*>(cb),
                       static_cast<float*>(cum), static_cast<float*>(lq),
                       static_cast<float*>(dstates), static_cast<float*>(dS),
                       static_cast<float*>(dA_part), static_cast<float*>(dD_part),
                       Bsz, S, H, P, N, Q, nc, xsb, xss, bsb, bss, csb, css};
    return launch_bwd<T>(a, static_cast<cudaStream_t>(stream));
  };
  return bf16_in ? run(bf16{}) : run(float{});
}
