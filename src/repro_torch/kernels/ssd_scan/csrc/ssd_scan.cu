// Mamba-2 chunked SSD scan for Hopper (sm_90a), CUDA C++ with a plain C entry point.
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
// What bounds it on this card: at the serving shapes (B=1, S<=1024, H=32,
// P=64, N=128, Q=128) the function moves ~10 MB and does ~1.6 GFLOP, so its
// least time is set by device-memory bytes (~3 us at 3.35 TB/s), not by the
// tensor cores. This first version computes in fp32 on the CUDA cores (no
// wgmma, no TMA), which puts it far above that bound; PERF.md keeps its time.
//
// Design (the TPU kernel's sequential chunk grid axis becomes a loop inside
// one block; nothing is carried between blocks):
//   * cb_kernel: C.B^T is shared by all heads, so it is computed once per
//     (b, chunk, 32x32 tile of the lower triangle) into an fp32 scratch
//     (B, nc, Q, Q) that stays in L2, instead of once per head.
//   * scan_kernel: one block per (b, h, slice of 16 head channels), so B=1
//     still gives 4*H = 128 blocks for the 132 SMs. The block walks the
//     chunks in order. Its (16, N) slice of the state lives in registers
//     across the loop (8 values a thread) and is mirrored to shared memory
//     for the inter-chunk product; the (Q, Q) decay tile, the chunk's B, C
//     and x live only in shared memory (~216 KB at Q=N=128, dynamic, after
//     cudaFuncSetAttribute). Row strides are padded so that the float4 reads
//     of the inner products hit distinct banks.
//   * Any Q <= 128 and any S: the ragged tail of the last chunk is masked as
//     if padded with dt = 0 (zero x, B, C), which is the same function, and
//     its rows of y are not written. Loops run to Q rounded up to 4, over
//     zeroed entries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQMax = 128;    // largest chunk the kernel takes
constexpr int kNMax = 128;    // largest state size the kernel takes
constexpr int kPS = 16;       // head channels per block
constexpr int kThreads = 256;
constexpr int kTile = 32;     // cb_kernel output tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// cb[b, c, t, s] = C_t . B_s for one 32x32 tile of chunk c (tiles above the
// diagonal are skipped: scan_kernel reads only s <= t).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb,
          int S, int N, int Q, int nc) {
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
    cs[r][n] = (t < Q && tok_t < S) ? to_f(Cm[((int64_t)b * S + tok_t) * N + n]) : 0.f;
    bs[r][n] = (s < Q && tok_s < S) ? to_f(Bm[((int64_t)b * S + tok_s) * N + n]) : 0.f;
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
            float* __restrict__ state, int S, int H, int P, int N, int Q, int nc) {
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
           const void* D, void* cb, void* y, void* state, int Bsz, int S, int H, int P,
           int N, int Q, cudaStream_t st) {
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + kTile - 1) / kTile;
  cb_kernel<T><<<dim3(nt * nt, nc, Bsz), kThreads, 0, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(cb), S, N,
      Q, nc);
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
      static_cast<const float*>(cb), static_cast<T*>(y), static_cast<float*>(state), S, H, P,
      N, Q, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// x, Bm, Cm, y: dtype 0 = float32, 1 = bfloat16; dt, A, D, state, cb: float32.
// All contiguous: x, y (B,S,H,P); dt (B,S,H); Bm, Cm (B,S,N); A, D (H,);
// state (B,H,P,N); cb scratch (B, ceil(S/Q), Q, Q).
// Requires 1 <= Q <= 128, N <= 128, N % 4 == 0. Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* D, void* cb, void* y, void* state,
                               int Bsz, int S, int H, int P, int N, int Q, int dtype,
                               void* stream) {
  if (!D || Q < 1 || Q > kQMax || N > kNMax || N % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, cb, y, state, Bsz, S, H, P, N, Q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, cb, y, state, Bsz, S, H, P, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
