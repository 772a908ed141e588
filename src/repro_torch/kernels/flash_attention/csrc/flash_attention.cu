// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py. Same function: for aligned
// self-attention (query row i and key j sit at positions i and j),
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, h / rep]
// over the keys j that the mask keeps: j < Skv, j <= i when causal, and
// j > i - window when a window is given. GQA maps query head h to KV head
// h / rep (rep = Hq / Hkv) without repeating K or V. As on the TPU: q is
// scaled in fp32, scores and the softmax state (m, l, acc) are fp32, masked
// scores are -1e30 and their p is 0, l is clamped at 1e-30 (an empty row
// gives 0, not NaN), and the output is cast to q's dtype.
//
// What bounds it on this card: at the whisper encoder's shape (B=4, S=1500,
// 12 heads of 64, bf16) the function does 2.8e10 FLOP on 37 MB, so its least
// time is set by operations (0.028 ms at the tensor cores' 989 TFLOP/s).
// This first version computes in fp32 on the CUDA cores (no wgmma, no TMA),
// whose rate is 67 TFLOP/s, so it runs well above that bound; PERF.md keeps
// its time.
//
// Design (the TPU grid (B, Hq, nQ, nK) carries m, l, acc in VMEM across the
// sequential nK axis; here the K loop runs inside one block instead):
//   * one block per (64-row q tile, b * Hq + h); tiles with the most causal
//     work are scheduled first. 256 threads as 16 x 16: thread (ty, tx) owns
//     rows 4*ty .. 4*ty+3, score columns tx + 16*j of each 64-key tile and
//     HD/16 output columns, so m, l and acc live in registers for the whole
//     K loop (HD is a template argument: 16 .. 256 in steps of 16).
//   * the q tile (scaled fp32), one K tile, one V tile (fp32) and the P tile
//     sit in dynamic shared memory: 69 KB at HD=64, 217 KB at HD=256, above
//     the 48 KB default, so the launcher raises the limit once per device.
//     Row pitches of HD+4 floats let the float4 reads of 16 different rows
//     fall on distinct banks.
//   * q, k, v, o are read and written in place in BSHD through their batch
//     and row strides (the head stride is HD, the element stride 1); nothing
//     is transposed or copied.
//   * the live key range of a tile comes from causal, window and Skv; tiles
//     outside it are skipped, and the in-tile mask handles the rest. Rows of
//     a ragged q tail are zero in shared memory and never written; keys past
//     Skv are zero in shared memory and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kPP = kBK + 4;    // row pitch of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int64_t rs,
                                          int r0, int rows, int n, float mul) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = r0 + r;
    dst[r * (HD + 4) + d] = s < n ? to_f(src[(int64_t)s * rs + d]) * mul : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Skv, int Hq, int rep, int64_t qsb, int64_t qss,
             int64_t ksb, int64_t kss, int64_t vsb, int64_t vss, int64_t osb, int64_t oss,
             float scale, int causal, int window) {
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
  const T* kb = k + b * ksb + (int64_t)(h / rep) * HD;
  const T* vb = v + b * vsb + (int64_t)(h / rep) * HD;
  load_tile<T, HD>(qs, q + b * qsb + (int64_t)h * HD, qss, q0, kBQ, Sq, scale);

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
    load_tile<T, HD>(ks, kb, kss, k0, kBK, Skv, 1.f);
    load_tile<T, HD>(vs, vb, vss, k0, kBK, Skv, 1.f);
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
    T* orow = o + b * osb + (int64_t)s * oss + (int64_t)h * HD + VEC * tx;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e) orow[16 * VEC * n + e] = from_f<T>(acc[i][n * VEC + e] / den);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Skv, Hq, rep;
  int64_t qsb, qss, ksb, kss, vsb, vss, osb, oss;
  float scale;
  int causal, window;
  cudaStream_t st;
};

template <typename T, int HD>
int launch(const Args& a) {
  // the attribute belongs to the device: raise it once per device
  static int attr_dev = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != attr_dev) {
    e = cudaFuncSetAttribute(flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(HD));
    if (e != cudaSuccess) return (int)e;
    attr_dev = dev;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_kernel<T, HD><<<grid, kThreads, smem_bytes(HD), a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.Sq, a.Skv, a.Hq, a.rep, a.qsb, a.qss, a.ksb, a.kss, a.vsb,
      a.vss, a.osb, a.oss, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 48: return launch<T, 48>(a);
    case 64: return launch<T, 64>(a);
    case 80: return launch<T, 80>(a);
    case 96: return launch<T, 96>(a);
    case 112: return launch<T, 112>(a);
    case 128: return launch<T, 128>(a);
    case 144: return launch<T, 144>(a);
    case 160: return launch<T, 160>(a);
    case 176: return launch<T, 176>(a);
    case 192: return launch<T, 192>(a);
    case 208: return launch<T, 208>(a);
    case 224: return launch<T, 224>(a);
    case 240: return launch<T, 240>(a);
    case 256: return launch<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd); dtype 0 = float32, 1 = bfloat16
// for all four. Strides in elements: *sb between batches, *ss between rows;
// the head stride must be hd and the element stride 1. window < 0 = none.
// Requires hd in 16..256 a multiple of 16, Hq % Hkv == 0, Sq >= 1,
// B * Hq <= 65535. Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                                      long long qsb, long long qss, long long ksb,
                                      long long kss, long long vsb, long long vss,
                                      long long osb, long long oss, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || B < 1 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, Sq, Skv, Hq, Hq / Hkv, qsb, qss, ksb, kss, vsb, vss, osb, oss,
               scale, causal, window, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(hd, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, a);
  return (int)cudaErrorInvalidValue;
}
