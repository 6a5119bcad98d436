// Block-sparse flash attention for Hopper (sm_90a).
//
// Replaces repro/kernels/block_sparse_attn/kernel.py::block_sparse_attention
// (the Pallas kernel _kernel): for each (batch*head, q-block) row, softmax
// attention restricted to the kv blocks listed in block_idx[:block_cnt],
// with causal masking by absolute position inside the blocks and GQA by
// kv row = bh / kv_group. A row that sees no key outputs 0.
//
// What bounds it: operations. One 128 x 128 tile of a 128-wide head is
// 4 * 128^3 = 8.4 MFLOP (QK^T and PV) against 64 KB of K and V in bf16:
// 128 FLOP a byte, and every q-block re-reads its K/V tiles from L2, so
// on the H100 the floor is the arithmetic, 989 TFLOP/s in bf16 on the
// tensor cores.
//
// What this simple design does about that: little yet. It runs the
// products as fp32 FMAs on the CUDA cores (67 TFLOP/s at most), which
// also keeps fp32 inputs exact. One CTA of 256 threads takes 64 query
// rows of a q-block and walks that q-block's list itself (the TPU's
// scalar prefetch has no counterpart: entries past block_cnt are never
// read). Each kv block is taken in 64-row sub-tiles: K^T into shared
// memory, S = Q K^T (each thread a 4 x 4 patch), the online-softmax
// update in registers, P into shared memory, then V over the K buffer and
// O += P V (each thread 4 rows x D/16 columns). Sub-tiles that the causal
// mask hides from all 64 rows are skipped. The tensor cores (mma.sync or
// wgmma on bf16 tiles) and TMA are left for later.
//
// Masking uses -inf with guards (m == -inf gives p = 0 and corr = 0), so
// a fully masked row never adds exp(0) garbage to l, where the Pallas
// kernel's finite -1e30 does and later wipes it. l sums the fp32 p; the
// PV product takes p rounded to v's type first, as the Pallas kernel does.
//
// Plain C interface for ctypes. The launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // kv rows per sub-tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 columns
constexpr int LDT = BM + 4;    // row stride of the transposed tiles (floats)

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

// q: (bh, sq, D); k/v: (bh / kv_group, skv, D); o: (bh, sq, D).
// block_idx: (bh, n_qb, max_nnz) i32; block_cnt: (bh, n_qb) i32.
// Grid: (sq / BM, bh). Shared: qT[D][LDT], kv[max(D*LDT, BN*D)], pT[BN][LDT].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
block_sparse_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int32_t* __restrict__ block_idx,
                         const int32_t* __restrict__ block_cnt,
                         T* __restrict__ o, int sq, int skv, int n_qb,
                         int max_nnz, int q_block, int kv_block,
                         int kv_group, int causal, float scale) {
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                                  // [D][LDT]
  float* kv = qT + D * LDT;                          // K^T [D][LDT] / V [BN][D]
  float* pT = kv + (D * LDT > BN * D ? D * LDT : BN * D);  // [BN][LDT]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * BM;  // first query row of this CTA
  const int qb = row0 / q_block;
  const int n_kb = skv / kv_block;

  const T* qp = q + ((size_t)bh * sq + row0) * D;
  const size_t kv_off = (size_t)(bh / kv_group) * skv * D;
  const T* kp = k + kv_off;
  const T* vp = v + kv_off;

  for (int e = tid; e < BM * D; e += kThreads)
    qT[(e % D) * LDT + e / D] = to_f32(qp[e]);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int32_t* list = block_idx + ((size_t)bh * n_qb + qb) * max_nnz;
  int cnt = block_cnt[(size_t)bh * n_qb + qb];
  cnt = cnt < max_nnz ? cnt : max_nnz;

  for (int t = 0; t < cnt; ++t) {
    const int kb = list[t];
    if (kb < 0 || kb >= n_kb) continue;  // never read outside k/v
    for (int sub = 0; sub < kv_block; sub += BN) {
      const int kv0 = kb * kv_block + sub;
      if (causal && kv0 > row0 + BM - 1) break;  // hidden from every row
      __syncthreads();  // the previous sub-tile's readers are done
      for (int e = tid; e < BN * D; e += kThreads)
        kv[(e % D) * LDT + e / D] = to_f32(kp[(size_t)kv0 * D + e]);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qT[kk * LDT + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&kv[kk * LDT + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
      __syncthreads();  // K^T is consumed; V goes into the same buffer

      for (int e = tid; e < BN * D; e += kThreads)
        kv[e] = to_f32(vp[(size_t)kv0 * D + e]);

      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = row0 + ty * 4 + i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j] * scale;
          if (causal && kv0 + tx * 4 + j > qpos) x = -INFINITY;
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int w = 1; w < 16; w <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = expf(s[i][j] - m_safe);
          sum += p[i][j];
        }
#pragma unroll
        for (int w = 1; w < 16; w <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, w);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&pT[(tx * 4 + j) * LDT + ty * 4]) =
            make_float4(round_to(p[0][j], vp), round_to(p[1][j], vp),
                        round_to(p[2][j], vp), round_to(p[3][j], vp));
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < BN; ++j) {
        const float4 pp = *reinterpret_cast<const float4*>(&pT[j * LDT + ty * 4]);
        const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int c4 = 0; c4 < CPT / 4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &kv[j * D + c4 * 64 + tx * 4]);
          const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][c4 * 4 + e] = fmaf(pv[i], vx[e], acc[i][c4 * 4 + e]);
        }
      }
    }
  }

  T* op = o + ((size_t)bh * sq + row0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CPT / 4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&op[(ty * 4 + i) * D + c4 * 64 + tx * 4 + e],
              l[i] > 0.f ? acc[i][c4 * 4 + e] * inv : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* idx,
           const void* cnt, void* o, int bh, int sq, int skv, int n_qb,
           int max_nnz, int q_block, int kv_block, int kv_group, int causal,
           float scale, cudaStream_t stream) {
  const int kv_floats = D * LDT > BN * D ? D * LDT : BN * D;
  const size_t smem = sizeof(float) * (size_t)(D * LDT + kv_floats + BN * LDT);
  auto kern = block_sparse_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sq / BM, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(cnt), static_cast<T*>(o), sq, skv, n_qb,
      max_nnz, q_block, kv_block, kv_group, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a head size
// other than 64 or 128. The wrapper has checked shapes and divisibility:
// sq % q_block == 0, q_block % 64 == 0, kv_block % 64 == 0, skv % kv_block == 0.
int block_sparse_attention_launch(const void* q, const void* k,
                                  const void* v, const void* block_idx,
                                  const void* block_cnt, void* o, int bh,
                                  int sq, int skv, int d, int n_qb,
                                  int max_nnz, int q_block, int kv_block,
                                  int kv_group, int causal, float scale,
                                  int bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (sq == 0 || bh == 0) return (int)cudaGetLastError();
#define BSA_LAUNCH(T, DD)                                                     \
  return launch<T, DD>(q, k, v, block_idx, block_cnt, o, bh, sq, skv, n_qb,  \
                       max_nnz, q_block, kv_block, kv_group, causal, scale, s)
  if (d == 64) {
    if (bf16) BSA_LAUNCH(__nv_bfloat16, 64);
    BSA_LAUNCH(float, 64);
  }
  if (d == 128) {
    if (bf16) BSA_LAUNCH(__nv_bfloat16, 128);
    BSA_LAUNCH(float, 128);
  }
#undef BSA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
