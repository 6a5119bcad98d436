// GQA flash-decode for Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attn/kernel.py::decode_attention (the
// Pallas kernel _kernel): one query token per sequence, q (b, hq, d),
// against a cache k/v (b, skv, hkv, d) whose first kv_len positions are
// valid; the g = hq / hkv query heads of a kv head share its keys.
//
// What bounds it: bytes. Every valid key and value is read once and used
// for g dot products and g axpys: about g / 2 FLOP a byte in bf16, far
// under the ~295 the H100 needs before the arithmetic matters. The floor
// is 2 * kv_len * hkv * d * sizeof(T) bytes at 3.35 TB/s.
//
// What this simple design does about that: it spreads the cache over the
// card. The TPU grid (b, hkv, n_blocks) runs its kv blocks in order and
// carries (m, l, acc) across them; that would give b * hkv CTAs (8 at
// Qwen3-4B width), far too few for 132 SMs. Here each (kv block, kv head,
// batch) is a CTA of its own (flash-decoding): it scores its block's keys
// against the g heads, takes the block's softmax, and writes fp32
// partials (m, l, acc) into scratch. A second kernel combines the partials
// of each (batch, q head). Blocks at or past kv_len are never launched;
// the last block reads only its valid rows. The CTA keeps many loads in
// flight: each thread scores one key (its row in 4-value loads, unrolled),
// and in PV each thread owns 4 columns of a key group and unrolls its loop
// over keys 8 deep; g is a template parameter so the g accumulators stay
// in registers. A split sized to the card rather than to kv_block, and
// TMA bulk copies, are left for later.
//
// p is rounded to v's type before the PV product, as in the Pallas
// kernel; l sums the unrounded p. The split reorders the sums, so results
// agree with the in-order kernel to rounding, not bit for bit.
//
// Plain C interface for ctypes. The launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Grid: (n_split, hkv, b); G = hq / hkv query heads. Partials: pm/pl
// (b, hq, n_split), pacc (b, hq, n_split, d). Shared: qs[G][d],
// ps[G][kv_block], red[kThreads / (d / 4)][G][d].
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ pm,
                      float* __restrict__ pl, float* __restrict__ pacc,
                      int skv, int hq, int hkv, int d, int kv_len,
                      int kv_block, int n_split, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ps = qs + G * d;
  float* red = ps + G * kv_block;

  const int blk = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blk * kv_block;
  const int n = min(kv_block, kv_len - t0);  // valid keys in this block
  const size_t row_stride = (size_t)hkv * d;
  const T* kp = k + ((size_t)bi * skv + t0) * row_stride + (size_t)hi * d;
  const T* vp = v + ((size_t)bi * skv + t0) * row_stride + (size_t)hi * d;

  const T* qp = q + ((size_t)bi * hq + (size_t)hi * G) * d;
  for (int e = tid; e < G * d; e += kThreads) qs[e] = to_f32(qp[e]);
  __syncthreads();

  // scores: one thread per key, its row read 4 values a load
  for (int t = tid; t < n; t += kThreads) {
    const T* kr = kp + (size_t)t * row_stride;
    float dot[G];
#pragma unroll
    for (int h = 0; h < G; ++h) dot[h] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; c += 4) {
      float x[4];
      load4(kr + c, x);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[h * d + c]);
        dot[h] = fmaf(qv.x, x[0], dot[h]);
        dot[h] = fmaf(qv.y, x[1], dot[h]);
        dot[h] = fmaf(qv.z, x[2], dot[h]);
        dot[h] = fmaf(qv.w, x[3], dot[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) ps[h * kv_block + t] = dot[h] * scale;
  }
  __syncthreads();

  // the block's softmax, one warp per head
  const size_t part = ((size_t)bi * hq + (size_t)hi * G) * n_split + blk;
  for (int h = warp; h < G; h += kWarps) {
    float* row = ps + h * kv_block;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(row[t] - mx);
      sum += p;
      row[t] = round_to(p, vp);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pm[part + (size_t)h * n_split] = mx;
      pl[part + (size_t)h * n_split] = sum;
    }
  }
  __syncthreads();

  // PV: a thread owns 4 columns of one key group; groups split the keys
  const int ncc = d / 4, n_grp = kThreads / ncc;
  const int cc = tid % ncc, grp = tid / ncc;
  float acc[G][4];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
#pragma unroll 8
  for (int t = grp; t < n; t += n_grp) {
    float x[4];
    load4(vp + (size_t)t * row_stride + cc * 4, x);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float p = ps[h * kv_block + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(p, x[e], acc[h][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(grp * G + h) * d + cc * 4 + e] = acc[h][e];
  __syncthreads();
  for (int e = tid; e < G * d; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < n_grp; ++r) s += red[r * G * d + e];
    const int h = e / d;
    pacc[(part + (size_t)h * n_split) * d + e % d] = s;
  }
}

// Grid: (b * hq). out (b, hq, d) in T; no partials (kv_len 0) gives 0.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ pm,
                                      const float* __restrict__ pl,
                                      const float* __restrict__ pacc,
                                      T* __restrict__ out, int d,
                                      int n_split) {
  const size_t row = blockIdx.x;
  const float* m = pm + row * n_split;
  const float* l = pl + row * n_split;
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, m[i]);
  float den = 0.f;
  for (int i = 0; i < n_split; ++i) den += l[i] * expf(m[i] - mx);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float num = 0.f;
    for (int i = 0; i < n_split; ++i)
      num = fmaf(pacc[(row * n_split + i) * d + dd], expf(m[i] - mx), num);
    store(&out[row * d + dd], den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int G>
int launch_partial(const T* q, const T* k, const T* v, float* pm, float* pl,
                   float* pacc, int b, int skv, int hq, int hkv, int d,
                   int kv_len, int kv_block, int n_split, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * d + (size_t)G * kv_block +
                                       (size_t)G * 4 * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_split, hkv, b);
  decode_partial_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      q, k, v, pm, pl, pacc, skv, hq, hkv, d, kv_len, kv_block, n_split,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qv, const void* kv, const void* vv, void* pmv,
           void* plv, void* paccv, void* out, int b, int skv, int hq,
           int hkv, int d, int kv_len, int kv_block, float scale,
           cudaStream_t stream) {
  const int n_split = (kv_len + kv_block - 1) / kv_block;
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  float* pm = static_cast<float*>(pmv);
  float* pl = static_cast<float*>(plv);
  float* pacc = static_cast<float*>(paccv);
  if (n_split > 0) {
    int err;
    switch (hq / hkv) {
#define DECODE_G(GG)                                                        \
  case GG:                                                                 \
    err = launch_partial<T, GG>(q, k, v, pm, pl, pacc, b, skv, hq, hkv, d, \
                                kv_len, kv_block, n_split, scale, stream); \
    break;
      DECODE_G(1) DECODE_G(2) DECODE_G(4) DECODE_G(8) DECODE_G(16)
#undef DECODE_G
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
  }
  decode_combine_kernel<T><<<b * hq, d < kThreads ? d : kThreads, 0,
                             stream>>>(pm, pl, pacc, static_cast<T*>(out), d,
                                       n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The wrapper has checked: d in {32, 64, 128, 256}, hq / hkv in
// {1, 2, 4, 8, 16} (others return cudaErrorInvalidValue), 0 <= kv_len <=
// skv, 16-byte aligned q/k/v, and sized the scratch
// pm/pl (b, hq, n_split) and pacc (b, hq, n_split, d) in fp32 with
// n_split = ceil(kv_len / kv_block).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* pm, void* pl, void* pacc, void* out, int b,
                            int skv, int hq, int hkv, int d, int kv_len,
                            int kv_block, float scale, int bf16,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0) return (int)cudaGetLastError();
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, pm, pl, pacc, out, b, skv, hq, hkv,
                                 d, kv_len, kv_block, scale, s);
  return launch<float>(q, k, v, pm, pl, pacc, out, b, skv, hq, hkv, d,
                       kv_len, kv_block, scale, s);
}

}  // extern "C"
