// GQA flash-decode for Hopper (sm_90a): one launch a call, a split sized
// to the card.
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
// What the design does about that:
// - The split is the kernel's own, chosen by the wrapper from the card's
//   SM count (kernel.py::split_plan), not from the Pallas kv_block: each
//   (split, kv head, batch) is a CTA of `chunk` key rows, a multiple of
//   64 and about 256 or more, with up to 16 splits of a (batch, kv head)
//   (at Qwen3-4B's 8 kv heads: 8 splits of 256 keys at kv_len 2048, 16
//   of 2048 at 32,000).
// - Loads are coalesced 16-byte cp.async copies into a three-stage ring in
//   shared memory, zero-filled past kv_len, so two stages stay in flight
//   while the CTA computes on the third, and a short split is one round
//   trip.
// - One launch: the splits of one (batch, kv head) are one thread block
//   cluster. Each CTA leaves its fp32 partial (m, l, acc) in its shared
//   memory; after a cluster barrier each CTA combines a share of the
//   output columns from all the partials, read through distributed
//   shared memory, and a second barrier keeps every CTA's shared memory
//   alive until all have read it. Nothing goes through device memory but
//   q, k, v and the output, and no state outlives the launch; kv_len 0
//   is one CTA that writes zeros.
//
// Two kernels, dispatched on the inputs' dtype (each dtype has exactly
// one; a failed launch raises):
// - bf16 -> decode_tc_kernel, the tensor cores. The g query heads are the
//   rows of an mma.sync m16n8k16 A operand (padded to 16 with zeros, held
//   in registers), each warp takes 16 keys of a 64-key stage: S = q K^T
//   with K read by ldmatrix, the online softmax on the fp32 accumulators,
//   p packed to bf16 A fragments (the Pallas kernel's p.astype(v.dtype);
//   l sums the unrounded p), O += P V with V read by ldmatrix.trans.
//   bf16 x bf16 products are exact in fp32, so this is the Pallas
//   function up to the order of the sums, at a few instructions a key.
// - fp32 -> decode_kernel, the CUDA cores (the tensor cores' TF32 would
//   break the fp32 tolerance). R neighbouring lanes read one key row in
//   16-byte pieces (d = 128: 32 lanes a row); each lane copies the pieces
//   it will use into its own ring slots, so no barrier is needed; the
//   row's dot product is reduced over its R lanes with shuffles and each
//   lane keeps a running softmax over its columns.
//
// Scores are kept in log2 units (dot * scale * log2 e) so exp2 gives the
// softmax. The split and the online softmax inside a CTA change only the
// order of the sums and the max that p is taken against, so results agree
// with the in-order kernel to rounding, not bit for bit.
//
// Plain C interface for ctypes. The launcher returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sm90;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kMaxCluster = 16;  // splits of a (batch, kv head), non-portable
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(bf16* o, float x) {
  *o = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float exp2_or_0(float x, float m) {
  return x == -INFINITY ? 0.f : exp2f(x - m);
}

// After the CTA's warps have left their partial softmaxes in shared memory
// (wm, wl [kWarps][g], wacc [kWarps][g][D], then room for 2 g floats):
// merge them into the CTA's partial, then combine the cluster's partials
// into the output of heads head0 .. head0 + g - 1. Every thread calls it.
template <typename T, int D>
__device__ __forceinline__ void finish(float* wm, float* wl, float* wacc,
                                       int g, T* __restrict__ out,
                                       size_t head0) {
  const int tid = threadIdx.x, split = blockIdx.x, n_split = gridDim.x;
  float* cm = wacc + kWarps * g * D;  // the CTA's partial: m [g], l [g]
  float* cl = cm + g;
  // acc over warp 0's slot: element i is read and written by one thread
  for (int i = tid; i < g * D; i += kThreads) {
    const int h = i / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * g + h]);
    const float ms = mx == -INFINITY ? 0.f : mx;
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2_or_0(wm[w * g + h], ms);
      num = fmaf(wacc[w * g * D + i], a, num);
      den = fmaf(wl[w * g + h], a, den);
    }
    wacc[i] = num;
    if (i % D == 0) {
      cm[h] = mx;
      cl[h] = den;
    }
  }

  // CTA `split` writes float4 columns split, split + n_split, ... of the
  // g heads, reading every CTA's partial through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = tid * n_split + split; i < g * D / 4;
       i += n_split * kThreads) {
    const int h = i / (D / 4);
    float mx = -INFINITY;
#pragma unroll 4
    for (int r = 0; r < n_split; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(cm, r)[h]);
    const float ms = mx == -INFINITY ? 0.f : mx;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
#pragma unroll 4
    for (int r = 0; r < n_split; ++r) {
      const float a = exp2_or_0(cluster.map_shared_rank(cm, r)[h], ms);
      const float4 x =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(wacc, r))[i];
      den = fmaf(cluster.map_shared_rank(cl, r)[h], a, den);
      num.x = fmaf(x.x, a, num.x);
      num.y = fmaf(x.y, a, num.y);
      num.z = fmaf(x.z, a, num.z);
      num.w = fmaf(x.w, a, num.w);
    }
    T* o = out + head0 * D + (size_t)i * 4;
    store(o, den > 0.f ? num.x / den : 0.f);
    store(o + 1, den > 0.f ? num.y / den : 0.f);
    store(o + 2, den > 0.f ? num.z / den : 0.f);
    store(o + 3, den > 0.f ? num.w / den : 0.f);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_KEYS = 64;  // keys a stage, 16 a warp

// Grid: (n_split, hkv, b), clusters of (n_split, 1, 1); block kThreads;
// g <= 16. Dynamic shared: kStages stages of K [TC_KEYS][D] and V
// [TC_KEYS][D], bf16, swizzled; after the loop the partials of finish().
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int skv,
                 int hq, int hkv, int g, int kv_len, int chunk,
                 float scale_log2) {
  constexpr int KS = D / 16, NO = D / 8, CH = D / 8;
  // kStages of 64 keys: 96 KB at d = 128, so two CTAs fit on an SM (at
  // 160 KB a CTA, clusters of 16 do not all find room at once)
  constexpr int STAGE = 2 * TC_KEYS * D, NS = kStages;
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);
  float* wm = reinterpret_cast<float*>(smem4);
  float* wl = wm + kWarps * g;
  float* wacc = wl + kWarps * g;

  const int split = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = split * chunk;
  const int n = max(0, min(chunk, kv_len - t0));  // valid keys here
  const int n_st = (n + TC_KEYS - 1) / TC_KEYS;
  const size_t row_stride = (size_t)hkv * D;
  const bf16* kp = k + ((size_t)bi * skv + t0) * row_stride + (size_t)hi * D;
  const bf16* vp = v + ((size_t)bi * skv + t0) * row_stride + (size_t)hi * D;
  auto load = [&](int st, int it) {  // keys it * TC_KEYS ... into stage st
    bf16* ks = ring + st * STAGE;
    for (int i = tid; i < TC_KEYS * CH; i += kThreads) {
      const int r = i / CH, c = i % CH, t = it * TC_KEYS + r;
      const size_t off = t < n ? (size_t)t * row_stride + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), kp + off, t < n);
      cp_async16(ks + TC_KEYS * D + swz<D>(r, c), vp + off, t < n);
    }
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_st) load(st, st);
    cp_async_commit();
  }

  // q as A fragments: rows are the g heads, zero past g
  const int r0 = lane >> 2, cq = 2 * (lane & 3);
  const bf16* qp = q + ((size_t)bi * hq + (size_t)hi * g) * D;
  auto q2 = [&](int row, int col) -> uint32_t {
    return row < g ? *reinterpret_cast<const uint32_t*>(qp + row * D + col)
                   : 0u;
  };
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = q2(r0, 16 * kk + cq);
    qa[kk][1] = q2(r0 + 8, 16 * kk + cq);
    qa[kk][2] = q2(r0, 16 * kk + 8 + cq);
    qa[kk][3] = q2(r0 + 8, 16 * kk + 8 + cq);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r0, +8

  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<NS - 2>();  // this thread's copies of stage it
    // every thread's copies have landed, and stage it - 1 is consumed
    __syncthreads();
    if (it + NS - 1 < n_st) load((it + NS - 1) % NS, it + NS - 1);
    cp_async_commit();
    const int key0 = it * TC_KEYS + warp * 16;  // this warp's 16 keys
    if (key0 >= n) continue;
    const bf16* ks = ring + (it % NS) * STAGE;
    const bf16* vs = ks + TC_KEYS * D;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldsm_x4(ks + swz<D>(warp * 16 + 8 * j + (lane & 7),
                            2 * kk + (lane >> 3)),
                b);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j], qa[kk + 1], b[2], b[3]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = key0 + 8 * j + cq + (e & 1) < n
                            ? s[j][e] * scale_log2
                            : -INFINITY;
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
    const float c0 = exp2_or_0(m0, ms0), c1 = exp2_or_0(m1, ms1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = exp2f(s[j][0] - ms0);
      s[j][1] = exp2f(s[j][1] - ms0);
      s[j][2] = exp2f(s[j][2] - ms1);
      s[j][3] = exp2f(s[j][3] - ms1);
    }
    l0 = l0 * c0 + s[0][0] + s[0][1] + s[1][0] + s[1][1];
    l1 = l1 * c1 + s[0][2] + s[0][3] + s[1][2] + s[1][3];
    if (c0 != 1.f || c1 != 1.f) {  // the max moved: rescale (exact if not)
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(vs + swz<D>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            j + (lane >> 4)),
                b);
      mma_bf16(acc[j], pa, b[0], b[1]);
      mma_bf16(acc[j + 1], pa, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes are reused below

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  if ((lane & 3) == 0) {
    if (r0 < g) {
      wm[warp * g + r0] = m0;
      wl[warp * g + r0] = l0;
    }
    if (r0 + 8 < g) {
      wm[warp * g + r0 + 8] = m1;
      wl[warp * g + r0 + 8] = l1;
    }
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (r0 < g) {
      wacc[(warp * g + r0) * D + 8 * j + cq] = acc[j][0];
      wacc[(warp * g + r0) * D + 8 * j + cq + 1] = acc[j][1];
    }
    if (r0 + 8 < g) {
      wacc[(warp * g + r0 + 8) * D + 8 * j + cq] = acc[j][2];
      wacc[(warp * g + r0 + 8) * D + 8 * j + cq + 1] = acc[j][3];
    }
  }
  __syncthreads();
  finish<bf16, D>(wm, wl, wacc, g, out, (size_t)bi * hq + (size_t)hi * g);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void unpack(const uint4& u, float* x) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}

// Grid and clusters as decode_tc_kernel. Dynamic shared: the ring
// [kStages][U][NP][K, V][kThreads] of 16-byte pieces; after the loop the
// partials of finish().
template <int G, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int skv,
              int hq, int hkv, int kv_len, int chunk, float scale_log2) {
  constexpr int VEC = 4;                        // values in a 16-byte piece
  constexpr int R = D / VEC < 32 ? D / VEC : 32;  // lanes a key row
  constexpr int NP = D / VEC / R;               // pieces a lane (1 or 2)
  constexpr int E = NP * VEC;                   // columns a lane
  constexpr int RPW = 32 / R;                   // key rows a warp-step
  constexpr int STEP = kWarps * RPW;            // key rows a CTA-step
  constexpr int U = 4 / NP;                     // CTA-steps a stage
  extern __shared__ float4 smem4[];
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* wm = reinterpret_cast<float*>(smem4);
  float* wl = wm + kWarps * G;
  float* wacc = wl + kWarps * G;

  const int split = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / R, c = lane % R;
  const int t0 = split * chunk;
  const int n = max(0, min(chunk, kv_len - t0));  // valid keys here
  const int n_it = (n + STEP * U - 1) / (STEP * U);
  const size_t row_stride = (size_t)hkv * D;
  const float* kp = k + ((size_t)bi * skv + t0) * row_stride + (size_t)hi * D;
  const float* vp = v + ((size_t)bi * skv + t0) * row_stride + (size_t)hi * D;

  // this thread's slot of piece (u, p) of K (kv 0) or V (kv 1) in a stage
  auto slot = [&](int st, int u, int p, int kv) {
    return ring + (((st * U + u) * NP + p) * 2 + kv) * kThreads + tid;
  };
  // copy the pieces of iteration `it` into stage `st`
  auto issue = [&](int st, int it) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = it * STEP * U + warp * RPW + rg + u * STEP;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const size_t off =
            t < n ? (size_t)t * row_stride + (c + p * R) * VEC : 0;
        cp_async16(slot(st, u, p, 0), kp + off, t < n);
        cp_async16(slot(st, u, p, 1), vp + off, t < n);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it) issue(st, st);
    cp_async_commit();
  }

  float qr[G][E];
  const float* qp = q + ((size_t)bi * hq + (size_t)hi * G) * D;
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int p = 0; p < NP; ++p)
      unpack(__ldg(reinterpret_cast<const uint4*>(qp + h * D +
                                                  (c + p * R) * VEC)),
             &qr[h][p * VEC]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  // n_it is the CTA's, so every lane reaches the shuffles
  for (int it = 0; it < n_it; ++it) {
    // the stage consumed in the previous iteration takes it + kStages - 1
    if (it + kStages - 1 < n_it)
      issue((it + kStages - 1) % kStages, it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this iteration's stage has landed
    const int st = it % kStages;
    const int base = it * STEP * U + warp * RPW + rg;
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
#pragma unroll
      for (int p = 0; p < NP; ++p) unpack(*slot(st, u, p, 0), &x[p * VEC]);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[h][e], x[e], dot);
#pragma unroll
        for (int w = R / 2; w > 0; w >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, w);
        s[u][h] = base + u * STEP < n ? dot * scale_log2 : -INFINITY;
      }
    }
    float vx[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        unpack(*slot(st, u, p, 1), &vx[u][p * VEC]);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = s[0][h];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][h]);
      const float m_new = fmaxf(m[h], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2_or_0(m[h], m_safe);
      l[h] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= corr;
      m[h] = m_new;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = exp2_or_0(s[u][h], m_safe);
        l[h] += pu;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pu, vx[u][e], acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes are reused below

  // merge the warp's row groups (lanes that differ in bits >= log2 R)
#pragma unroll
  for (int w = R; w < 32; w <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], w);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], w);
      const float mn = fmaxf(m[h], mo);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float a = exp2_or_0(m[h], ms), b = exp2_or_0(mo, ms);
      l[h] = l[h] * a + lo * b;
      m[h] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[h][e], w);
        acc[h][e] = acc[h][e] * a + ao * b;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      wm[warp * G + h] = m[h];
      wl[warp * G + h] = l[h];
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wacc[(warp * G + h) * D + (c + p * R) * VEC + e] =
              acc[h][p * VEC + e];
  }
  __syncthreads();
  finish<float, D>(wm, wl, wacc, G, out, (size_t)bi * hq + (size_t)hi * G);
}

// Launch `kern` on grid (n_split, hkv, b) in clusters of (n_split, 1, 1).
template <auto kern, typename... Args>
int launch_clusters(size_t smem, int n_split, int hkv, int b,
                    cudaStream_t stream, Args... args) {
  static bool configured = false;  // once a kernel: the most it may ask for
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, hkv, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// shared bytes of finish()'s partials
size_t partial_bytes(int g, int d) {
  return sizeof(float) * ((size_t)kWarps * g * (d + 2) + (size_t)2 * g);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int skv, int hq, int hkv, int kv_len, int chunk, int n_split,
              float scale, cudaStream_t stream) {
  const int g = hq / hkv;
  const size_t ring = sizeof(bf16) * (size_t)kStages * 2 * TC_KEYS * D;
  const size_t part = partial_bytes(g, D);
  return launch_clusters<decode_tc_kernel<D>>(
      ring > part ? ring : part, n_split, hkv, b, stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), skv, hq, hkv, g,
      kv_len, chunk, scale * kLog2e);
}

template <int G, int D>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int b, int skv, int hq, int hkv, int kv_len, int chunk,
                int n_split, float scale, cudaStream_t stream) {
  const size_t ring = (size_t)kStages * 4 * 2 * kThreads * 16;
  const size_t part = partial_bytes(G, D);
  return launch_clusters<decode_kernel<G, D>>(
      ring > part ? ring : part, n_split, hkv, b, stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), skv, hq, hkv,
      kv_len, chunk, scale * kLog2e);
}

template <int D>
int launch_fp32_g(int g, const void* q, const void* k, const void* v,
                  void* out, int b, int skv, int hq, int hkv, int kv_len,
                  int chunk, int n_split, float scale, cudaStream_t s) {
  switch (g) {
#define DECODE_G(GG)                                                        \
  case GG:                                                                 \
    return launch_fp32<GG, D>(q, k, v, out, b, skv, hq, hkv, kv_len,       \
                              chunk, n_split, scale, s);
    DECODE_G(1) DECODE_G(2) DECODE_G(4) DECODE_G(8) DECODE_G(16)
#undef DECODE_G
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The wrapper has checked: d in {32, 64, 128, 256}, hq / hkv in
// {1, 2, 4, 8, 16} (others return cudaErrorInvalidValue), 0 <= kv_len <=
// skv, 16-byte aligned q/k/v, and 1 <= n_split <= 16 splits of `chunk`
// keys that cover kv_len, none of them empty unless kv_len is 0.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, int b, int skv, int hq, int hkv,
                            int d, int kv_len, int chunk, int n_split,
                            float scale, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0) return (int)cudaGetLastError();
  const int g = hq / hkv;
  if (n_split < 1 || n_split > kMaxCluster || chunk < 1 ||
      (long long)chunk * n_split < kv_len || g < 1 || g > 16 ||
      g * hkv != hq)
    return (int)cudaErrorInvalidValue;
#define DECODE_ARGS \
  q, k, v, out, b, skv, hq, hkv, kv_len, chunk, n_split, scale, s
  switch (d) {
#define DECODE_D(DD)                                \
  case DD:                                         \
    return is_bf16 ? launch_tc<DD>(DECODE_ARGS)    \
                   : launch_fp32_g<DD>(g, DECODE_ARGS);
    DECODE_D(32) DECODE_D(64) DECODE_D(128) DECODE_D(256)
#undef DECODE_D
#undef DECODE_ARGS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
