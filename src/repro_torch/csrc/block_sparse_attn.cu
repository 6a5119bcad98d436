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
// Two kernels, dispatched on the inputs' dtype (not a fallback: each
// dtype has exactly one kernel, and a failed launch raises):
//
// bf16 -> bsa_tc_kernel, the tensor cores (FlashAttention-2's design).
// A CTA of NW warps takes 16 * NW query rows (NW = 8 where q_block is a
// multiple of 128, else 4), each warp 16 rows. Q is copied once and held
// as mma A fragments in registers (ldmatrix.x4). K and V come in 64-row
// sub-tiles by 16-byte cp.async into a three-stage ring in shared memory
// (Q passes through the third stage first), so the next two sub-tiles'
// copies overlap the current products, with one barrier a sub-tile; the
// 16-byte
// chunks of a row are XOR-swizzled by (row % 8), so ldmatrix reads 8
// rows without bank conflicts. S = Q K^T and O += P V run as
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 (K read by ldmatrix as the
// column-major B, V by ldmatrix.trans). The online softmax stays in
// registers: a lane holds rows lane/4 and lane/4 + 8 and columns
// 2 * (lane % 4) + {0, 1} of each 8-column tile, so the row max reduces
// over the 4 lanes of a quad; the fp32 S accumulators are packed into
// bf16 A fragments for P V without a trip through shared memory. That
// packing rounds p to bf16 exactly as the Pallas kernel's
// p.astype(v.dtype), and bf16 x bf16 products are exact in fp32, so the
// kernel computes the Pallas function up to the order of the sums. The
// grid is (bh, row-blocks) with the row-block index reversed, so under
// the causal mask the heaviest q-blocks (qb + 1 tiles) start first.
//
// fp32 -> block_sparse_attn_kernel, fp32 FMAs on the CUDA cores (67
// TFLOP/s at most). TF32 tensor cores would round the inputs to 10-bit
// mantissas, beyond the fp32 tolerance (2e-5) of the kernel's contract.
// One CTA of 256 threads takes 64 query rows and walks the list; each kv
// block in 64-row sub-tiles: K^T into shared memory, S = Q K^T (each
// thread a 4 x 4 patch), the online-softmax update in registers, P into
// shared memory, then V over the K buffer and O += P V.
//
// Both kernels read their own list (the TPU's scalar prefetch has no
// counterpart): entries past block_cnt, or outside [0, skv / kv_block),
// are never read, and sub-tiles that the causal mask hides from all of a
// CTA's rows are skipped (the tensor-core kernel also skips a warp's
// products where they are hidden from its 16 rows). Masking uses -inf
// with guards (m == -inf gives p = 0 and corr = 0), so a fully masked row
// never adds exp(0) garbage to l, where the Pallas kernel's finite -1e30
// does and later wipes it. l sums the fp32 p; the PV product takes p
// rounded to v's type first, as the Pallas kernel does.
//
// Plain C interface for ctypes. The launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using namespace sm90;
constexpr int TC_BN = 64;     // kv rows per sub-tile
constexpr int TC_STAGES = 3;  // sub-tiles in the ring

// rows x D from global (row stride D) into a swizzled tile, by cp.async
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    cp_async16(dst + swz<D>(r, ch), src + (size_t)r * D + ch * 8);
  }
}

// The next sub-tile at or after (t, sub) of the list: listed (t <
// n_list), inside k/v, and not hidden from every row up to row_last by
// the causal mask. Returns its first kv row, or -1 past the list's end.
__device__ __forceinline__ int next_subtile(const int32_t* list, int n_list,
                                            int n_kb, int kv_block,
                                            int causal, int row_last, int& t,
                                            int& sub) {
  for (; t < n_list; ++t, sub = 0) {
    const int kb = __ldg(list + t);
    if (kb < 0 || kb >= n_kb || sub >= kv_block) continue;
    const int kv0 = kb * kv_block + sub;
    if (!causal || kv0 <= row_last) return kv0;
  }
  return -1;
}

// Grid: (bh, sq / BM), BM = 16 * NW; block NW * 32. Dynamic shared:
// TC_STAGES stages of K [TC_BN][D] and V [TC_BN][D], bf16; Q [BM][D]
// passes through the last stage before its first sub-tile arrives.
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 2 : 1)
bsa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v,
              const int32_t* __restrict__ block_idx,
              const int32_t* __restrict__ block_cnt, bf16* __restrict__ o,
              int sq, int skv, int n_qb, int max_nnz, int q_block,
              int kv_block, int kv_group, int causal, float scale_log2) {
  constexpr int BM = NW * 16, NT = NW * 32, KS = D / 16, NO = D / 8;
  constexpr int STAGE = 2 * TC_BN * D;  // elements of a stage: K, then V
  static_assert(BM <= 2 * TC_BN, "Q must fit in one stage");
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int qb = row0 / q_block;
  const int n_kb = skv / kv_block;
  const int wrow0 = row0 + warp * 16;  // this warp's first query row
  const int row_last = row0 + BM - 1;
  const size_t kv_off = (size_t)(bh / kv_group) * skv * D;
  const bf16* kp = k + kv_off;
  const bf16* vp = v + kv_off;
  const int32_t* list = block_idx + ((size_t)bh * n_qb + qb) * max_nnz;
  const int n_list = min(block_cnt[(size_t)bh * n_qb + qb], max_nnz);
  auto load_kv = [&](int st, int first) {  // sub-tile at kv row `first`
    if (first < 0) return;
    load_tile<D, NT>(ring + st * STAGE, kp + (size_t)first * D, TC_BN, tid);
    load_tile<D, NT>(ring + st * STAGE + TC_BN * D, vp + (size_t)first * D,
                     TC_BN, tid);
  };

  // prologue: Q into the last stage, the first two sub-tiles (kv0 at
  // list position (t, sub), kv1 at (t1, s1)) into the first two
  bf16* qs = ring + (TC_STAGES - 1) * STAGE;
  load_tile<D, NT>(qs, q + ((size_t)bh * sq + row0) * D, BM, tid);
  cp_async_commit();
  int t = 0, sub = 0;
  int kv0 = next_subtile(list, n_list, n_kb, kv_block, causal, row_last, t,
                         sub);
  load_kv(0, kv0);
  cp_async_commit();
  int t1 = t, s1 = sub + TC_BN;
  int kv1 = kv0 < 0 ? -1
                    : next_subtile(list, n_list, n_kb, kv_block, causal,
                                   row_last, t1, s1);
  load_kv(1, kv1);
  cp_async_commit();
  cp_async_wait<2>();  // Q has landed
  __syncthreads();

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qs + swz<D>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * kk + (lane >> 4)),
            qa[kk]);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r, r+8
  const int r0 = wrow0 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);

  for (int it = 0; kv0 >= 0; ++it) {
    cp_async_wait<1>();  // this thread's copies of sub-tile it have landed
    // everyone's copies have landed, and everyone is done with sub-tile
    // it - 1 (and Q), whose stage takes sub-tile it + 2
    __syncthreads();
    int t2 = t1, s2 = s1 + TC_BN;
    const int kv2 = kv1 < 0 ? -1
                            : next_subtile(list, n_list, n_kb, kv_block,
                                           causal, row_last, t2, s2);
    load_kv((it + 2) % TC_STAGES, kv2);
    cp_async_commit();

    if (!causal || kv0 <= wrow0 + 15) {
      const bf16* ks = ring + (it % TC_STAGES) * STAGE;
      const bf16* vs = ks + TC_BN * D;
      float s[TC_BN / 8][4];
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
        for (int j = 0; j < TC_BN / 8; ++j) {
          uint32_t b[4];
          ldsm_x4(ks + swz<D>(8 * j + (lane & 7), 2 * kk + (lane >> 3)), b);
          mma_bf16(s[j], qa[kk], b[0], b[1]);
          mma_bf16(s[j], qa[kk + 1], b[2], b[3]);
        }
      }

      const bool diag = causal && kv0 + TC_BN - 1 > wrow0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (diag && kv0 + 8 * j + cq + (e & 1) > (e < 2 ? r0 : r1))
            x = -INFINITY;
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = m0 == -INFINITY ? 0.f : exp2f(m0 - ms0);
      const float c1 = m1 == -INFINITY ? 0.f : exp2f(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;  // this lane's share of the row sums
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
        s[j][0] = exp2f(s[j][0] - ms0);
        s[j][1] = exp2f(s[j][1] - ms0);
        s[j][2] = exp2f(s[j][2] - ms1);
        s[j][3] = exp2f(s[j][3] - ms1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
#pragma unroll
      for (int kt = 0; kt < TC_BN / 16; ++kt) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t b[4];
          ldsm_x4_t(vs + swz<D>(16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8,
                                j + (lane >> 4)),
                    b);
          mma_bf16(acc[j], pa, b[0], b[1]);
          mma_bf16(acc[j + 1], pa, b[2], b[3]);
        }
      }
    }
    kv0 = kv1;
    t1 = t2;
    s1 = s2;
    kv1 = kv2;
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  bf16* op = o + ((size_t)bh * sq + r0) * D + cq;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
        l0 > 0.f ? acc[j][0] / l0 : 0.f, l0 > 0.f ? acc[j][1] / l0 : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(op + 8 * D + 8 * j) =
        __floats2bfloat162_rn(l1 > 0.f ? acc[j][2] / l1 : 0.f,
                              l1 > 0.f ? acc[j][3] / l1 : 0.f);
  }
}

template <int D, int NW>
int launch_tc(const void* q, const void* k, const void* v, const void* idx,
              const void* cnt, void* o, int bh, int sq, int skv, int n_qb,
              int max_nnz, int q_block, int kv_block, int kv_group,
              int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)TC_STAGES * 2 * TC_BN * D;
  auto kern = bsa_tc_kernel<D, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, sq / (NW * 16));
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(cnt), static_cast<bf16*>(o), sq, skv, n_qb,
      max_nnz, q_block, kv_block, kv_group, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // kv rows per sub-tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 columns
constexpr int LDT = BM + 4;    // row stride of the transposed tiles (floats)

// q: (bh, sq, D); k/v: (bh / kv_group, skv, D); o: (bh, sq, D).
// block_idx: (bh, n_qb, max_nnz) i32; block_cnt: (bh, n_qb) i32.
// Grid: (sq / BM, bh). Shared: qT[D][LDT], kv[max(D*LDT, BN*D)], pT[BN][LDT].
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
block_sparse_attn_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ block_idx,
                         const int32_t* __restrict__ block_cnt,
                         float* __restrict__ o, int sq, int skv, int n_qb,
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

  const float* qp = q + ((size_t)bh * sq + row0) * D;
  const size_t kv_off = (size_t)(bh / kv_group) * skv * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;

  for (int e = tid; e < BM * D; e += kThreads)
    qT[(e % D) * LDT + e / D] = qp[e];

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
        kv[(e % D) * LDT + e / D] = kp[(size_t)kv0 * D + e];
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
        kv[e] = vp[(size_t)kv0 * D + e];

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
            make_float4(p[0][j], p[1][j],
                        p[2][j], p[3][j]);
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

  float* op = o + ((size_t)bh * sq + row0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CPT / 4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[(ty * 4 + i) * D + c4 * 64 + tx * 4 + e] =
            l[i] > 0.f ? acc[i][c4 * 4 + e] * inv : 0.f;
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v,
                const void* idx, const void* cnt, void* o, int bh, int sq,
                int skv, int n_qb, int max_nnz, int q_block, int kv_block,
                int kv_group, int causal, float scale, cudaStream_t stream) {
  const int kv_floats = D * LDT > BN * D ? D * LDT : BN * D;
  const size_t smem = sizeof(float) * (size_t)(D * LDT + kv_floats + BN * LDT);
  auto kern = block_sparse_attn_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sq / BM, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(cnt), static_cast<float*>(o), sq, skv, n_qb,
      max_nnz, q_block, kv_block, kv_group, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a head size
// other than 64 or 128, or rows other than 64 or 128 (bf16). The wrapper
// has checked shapes and divisibility: sq % q_block == 0, q_block % 64 ==
// 0 (% rows for bf16), kv_block % 64 == 0, skv % kv_block == 0.
int block_sparse_attention_launch(const void* q, const void* k,
                                  const void* v, const void* block_idx,
                                  const void* block_cnt, void* o, int bh,
                                  int sq, int skv, int d, int n_qb,
                                  int max_nnz, int q_block, int kv_block,
                                  int kv_group, int causal, float scale,
                                  int is_bf16, int rows, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (sq == 0 || bh == 0) return (int)cudaGetLastError();
#define BSA_ARGS                                                            \
  q, k, v, block_idx, block_cnt, o, bh, sq, skv, n_qb, max_nnz, q_block,    \
      kv_block, kv_group, causal, scale, s
  if (is_bf16) {
    if (d == 64 && rows == 64) return launch_tc<64, 4>(BSA_ARGS);
    if (d == 64 && rows == 128) return launch_tc<64, 8>(BSA_ARGS);
    if (d == 128 && rows == 64) return launch_tc<128, 4>(BSA_ARGS);
    if (d == 128 && rows == 128) return launch_tc<128, 8>(BSA_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 64) return launch_fp32<64>(BSA_ARGS);
  if (d == 128) return launch_fp32<128>(BSA_ARGS);
#undef BSA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
