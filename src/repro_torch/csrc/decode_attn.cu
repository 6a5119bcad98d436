// GQA flash-decode for Hopper (sm_90a): one launch a call, a split sized
// to the card.
//
// Replaces repro/kernels/decode_attn/kernel.py::decode_attention (the
// Pallas kernel _kernel): one query token per sequence, q (b, hq, d),
// against a cache k/v (b, skv, hkv, d) whose first kv_len positions are
// valid; the g = hq / hkv query heads of a kv head share its keys.
//
// Two segments: a second cache k2/v2 (b, skv2, hkv, d) whose first kv_len2
// positions follow the first cache's (the serving path's read-only context
// and its decode tail). The kernels see one range of kv_len + kv_len2
// keys, which the wrapper splits as one; each key row is read from the
// segment it lies in (a compare in the copies' address, key by key, so a
// split may straddle the two at any kv_len), and the combine of the splits
// is the merge of the two. One segment is kv_len2 0, every address as
// before.
//
// What bounds it: bytes. Every valid key and value is read once and used
// for g dot products and g axpys: about g / 2 FLOP a byte in bf16, far
// under the ~295 the H100 needs before the arithmetic matters. The floor
// is 2 * (kv_len + kv_len2) * hkv * d * sizeof(T) bytes at 3.35 TB/s.
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
// Three kernels. The wrapper (kernel.py::_fast) picks one by shape and
// dtype before the launch; none stands in for another, and a failed
// launch raises. The fast kernels take head sizes 32, 64, 80, 128 and
// 256, 1 to 16 query heads a kv head, and b and hkv under 65536; the
// generic kernel (decode_generic_kernel, at the end) every other shape
// the reference takes, in fp32, bf16 and fp16: the tiled engine of
// generic_attn.cuh with the g query heads of a kv head as the rows of its
// tiles (64 a CTA on the tensor cores, 32 in fp32), so each split's keys
// are read once for all of them. Its split is its own
// (kernel.py::split_plan_generic): enough splits that the launch has a
// CTA an SM at least, where the fast kernels' clusters of at most 16
// leave a card with two kv heads at 32 CTAs; the partials meet in a
// workspace that decode_combine_kernel reads in a second launch of the
// same call.
// - bf16, fp16 -> decode_tc_kernel<T>, the tensor cores (the fp16
//   mma.sync has the bf16 one's shape and fragments). The g query heads
//   are the rows of an mma.sync m16n8k16 A operand (padded to 16 with
//   zeros, held in registers), each warp takes 16 keys of a 64-key
//   stage: S = q K^T
//   with K read by ldmatrix, the online softmax on the fp32 accumulators,
//   p packed to T A fragments (the Pallas kernel's p.astype(v.dtype);
//   l sums the unrounded p), O += P V with V read by ldmatrix.trans.
//   T x T products are exact in fp32, so this is the Pallas
//   function up to the order of the sums, at a few instructions a key.
//   g is a run-time value, any of 1..16. At d = 80 a K/V row in shared
//   memory is padded to 11 16-byte chunks (mma_sm90.cuh, tile_pitch) and
//   the fifth k-step reads K by ldmatrix.x2.
// - fp32 -> decode_kernel, the CUDA cores (the tensor cores' TF32 would
//   break the fp32 tolerance). R neighbouring lanes read one key row in
//   16-byte pieces (d = 128: 32 lanes a row); each lane copies the pieces
//   it will use into its own ring slots, so no barrier is needed; the
//   row's dot product is reduced over its R lanes with shuffles and each
//   lane keeps a running softmax over its columns. R is a power of two:
//   d = 80's 20 pieces take a warp, 12 lanes idle (37.5% of its lanes'
//   work wasted). The group is a template (the q heads in registers):
//   G in {1, 2, 3, 4, 8, 12, 16}, exact; any other g runs on a padded
//   instance of the least G > g, the rows past g zero and never stored
//   (g = 5 wastes 3/8).
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

#include "generic_attn.cuh"
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
__device__ __forceinline__ void store(f16* o, float x) {
  *o = __float2half_rn(x);
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
// g <= 16. Keys: the first kv_len of k/v, then the first kv_len2 of k2/v2.
// Dynamic shared: kStages stages of K [TC_KEYS][D] and V [TC_KEYS][D], T
// (bf16 or fp16), swizzled; after the loop the partials of finish().
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ k2,
                 const T* __restrict__ v2, T* __restrict__ out, int skv,
                 int skv2, int hq, int hkv, int g, int kv_len, int kv_len2,
                 int chunk, float scale_log2) {
  constexpr int KS = D / 16, NO = D / 8, CH = D / 8;
  constexpr int P = tile_pitch<D>();  // d = 80: 88 (mma_sm90.cuh)
  // kStages of 64 keys: 96 KB at d = 128, so two CTAs fit on an SM (at
  // 160 KB a CTA, clusters of 16 do not all find room at once)
  constexpr int STAGE = 2 * TC_KEYS * P, NS = kStages;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  float* wm = reinterpret_cast<float*>(smem4);
  float* wl = wm + kWarps * g;
  float* wacc = wl + kWarps * g;

  const int split = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = split * chunk;
  const int n = max(0, min(chunk, kv_len + kv_len2 - t0));  // keys here
  const int n_st = (n + TC_KEYS - 1) / TC_KEYS;
  const size_t row_stride = (size_t)hkv * D;
  const T* kp = k + (size_t)bi * skv * row_stride + (size_t)hi * D;
  const T* vp = v + (size_t)bi * skv * row_stride + (size_t)hi * D;
  const T* kp2 = k2 + (size_t)bi * skv2 * row_stride + (size_t)hi * D;
  const T* vp2 = v2 + (size_t)bi * skv2 * row_stride + (size_t)hi * D;
  auto load = [&](int st, int it) {  // keys it * TC_KEYS ... into stage st
    T* ks = ring + st * STAGE;
    for (int i = tid; i < TC_KEYS * CH; i += kThreads) {
      const int r = i / CH, c = i % CH, t = it * TC_KEYS + r;
      const int p = t0 + t;  // in the range of both segments
      const bool ok = t < n, two = ok && p >= kv_len;
      const size_t off =
          ok ? (size_t)(two ? p - kv_len : p) * row_stride + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), (two ? kp2 : kp) + off, ok);
      cp_async16(ks + TC_KEYS * P + swz<D>(r, c), (two ? vp2 : vp) + off, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_st) load(st, st);
    cp_async_commit();
  }

  // q as A fragments: rows are the g heads, zero past g
  const int r0 = lane >> 2, cq = 2 * (lane & 3);
  const T* qp = q + ((size_t)bi * hq + (size_t)hi * g) * D;
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
    const T* ks = ring + (it % NS) * STAGE;
    const T* vs = ks + TC_KEYS * P;

    // two k-steps a K ldmatrix.x4; the last of an odd count (d = 80) from
    // an .x2
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kk + 1 < KS) {
          uint32_t b[4];
          ldsm_x4(ks + swz<D>(warp * 16 + 8 * j + (lane & 7),
                              2 * kk + (lane >> 3)),
                  b);
          mma16816<T>(s[j], qa[kk], b[0], b[1]);
          mma16816<T>(s[j], qa[kk + 1 < KS ? kk + 1 : kk], b[2], b[3]);
        } else {
          uint32_t b[2];
          ldsm_x2(ks + swz<D>(warp * 16 + 8 * j + (lane & 7),
                              2 * kk + ((lane >> 3) & 1)),
                  b);
          mma16816<T>(s[j], qa[kk], b[0], b[1]);
        }
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
    const uint32_t pa[4] = {pack2<T>(s[0][0], s[0][1]),
                            pack2<T>(s[0][2], s[0][3]),
                            pack2<T>(s[1][0], s[1][1]),
                            pack2<T>(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(vs + swz<D>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            j + (lane >> 4)),
                b);
      mma16816<T>(acc[j], pa, b[0], b[1]);
      mma16816<T>(acc[j + 1], pa, b[2], b[3]);
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
  finish<T, D>(wm, wl, wacc, g, out, (size_t)bi * hq + (size_t)hi * g);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void unpack(const uint4& u, float* x) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}

__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

// Grid and clusters as decode_tc_kernel. Dynamic shared: the ring
// [kStages][U][NP][K, V][kThreads] of 16-byte pieces; after the loop the
// partials of finish(). G is the template's group. Where PAD is false the
// call's g is G; where it is true, g < G: the q rows past g are zeros and
// their partials are never stored (g 5-7 run at G 8, 9-11 at 12, 13-15 at
// 16). The exact instances keep g a constant: a run-time g costs the
// G = 16 instances spills.
template <int G, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ k2,
              const float* __restrict__ v2, float* __restrict__ out, int skv,
              int skv2, int hq, int hkv, int g_call, int kv_len, int kv_len2,
              int chunk, float scale_log2) {
  const int g = PAD ? g_call : G;
  constexpr int VEC = 4;                        // values in a 16-byte piece
  constexpr int PCS = D / VEC;                  // pieces a key row
  // lanes a key row, a power of two for the shuffles; at d = 80 a row's 20
  // pieces take 32 lanes and lanes 20-31 hold zeros
  constexpr int R = PCS < 32 ? pow2_ceil(PCS) : 32;
  constexpr int NP = (PCS + R - 1) / R;         // pieces a lane (1 or 2)
  constexpr int E = NP * VEC;                   // columns a lane
  constexpr int RPW = 32 / R;                   // key rows a warp-step
  constexpr int STEP = kWarps * RPW;            // key rows a CTA-step
  constexpr int U = 4 / NP;                     // CTA-steps a stage
  extern __shared__ float4 smem4[];
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* wm = reinterpret_cast<float*>(smem4);
  float* wl = wm + kWarps * g;
  float* wacc = wl + kWarps * g;

  const int split = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / R, c = lane % R;
  // piece p of this lane lies in the row (always, unless R does not
  // divide PCS)
  auto live = [&](int p) { return PCS % R == 0 || c + p * R < PCS; };
  const int t0 = split * chunk;
  const int n = max(0, min(chunk, kv_len + kv_len2 - t0));  // keys here
  const int n_it = (n + STEP * U - 1) / (STEP * U);
  const size_t row_stride = (size_t)hkv * D;
  const float* kp = k + (size_t)bi * skv * row_stride + (size_t)hi * D;
  const float* vp = v + (size_t)bi * skv * row_stride + (size_t)hi * D;
  const float* kp2 = k2 + (size_t)bi * skv2 * row_stride + (size_t)hi * D;
  const float* vp2 = v2 + (size_t)bi * skv2 * row_stride + (size_t)hi * D;

  // this thread's slot of piece (u, p) of K (kv 0) or V (kv 1) in a stage
  auto slot = [&](int st, int u, int p, int kv) {
    return ring + (((st * U + u) * NP + p) * 2 + kv) * kThreads + tid;
  };
  // copy the pieces of iteration `it` into stage `st`
  auto issue = [&](int st, int it) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = it * STEP * U + warp * RPW + rg + u * STEP;
      const int key = t0 + t;  // in the range of both segments
      const bool two = key >= kv_len;
      const size_t row = (size_t)(two ? key - kv_len : key) * row_stride;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bool ok = t < n && live(p);
        const size_t off = ok ? row + (c + p * R) * VEC : 0;
        cp_async16(slot(st, u, p, 0), (ok && two ? kp2 : kp) + off, ok);
        cp_async16(slot(st, u, p, 1), (ok && two ? vp2 : vp) + off, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it) issue(st, st);
    cp_async_commit();
  }

  float qr[G][E];
  const float* qp = q + ((size_t)bi * hq + (size_t)hi * g) * D;
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int p = 0; p < NP; ++p)
      unpack(h < g && live(p)
                 ? __ldg(reinterpret_cast<const uint4*>(qp + h * D +
                                                        (c + p * R) * VEC))
                 : make_uint4(0u, 0u, 0u, 0u),
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
      if (h < g) {
        wm[warp * g + h] = m[h];
        wl[warp * g + h] = l[h];
      }
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (h < g && live(p))
            wacc[(warp * g + h) * D + (c + p * R) * VEC + e] =
                acc[h][p * VEC + e];
  }
  __syncthreads();
  finish<float, D>(wm, wl, wacc, g, out, (size_t)bi * hq + (size_t)hi * g);
}

// Launch `kern` on grid (n_split, gy, gz) in clusters of (n_split, 1, 1).
template <auto kern, typename... Args>
int launch_clusters(size_t smem, int n_split, int gy, int gz,
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
  cfg.gridDim = dim3(n_split, gy, gz);
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

template <typename T, int D>
int launch_tc(const void* q, const void* k, const void* v, const void* k2,
              const void* v2, void* out, int b, int skv, int skv2, int hq,
              int hkv, int kv_len, int kv_len2, int chunk, int n_split,
              float scale, cudaStream_t stream) {
  const int g = hq / hkv;
  const size_t ring =
      sizeof(T) * (size_t)kStages * 2 * TC_KEYS * tile_pitch<D>();
  const size_t part = partial_bytes(g, D);
  return launch_clusters<decode_tc_kernel<T, D>>(
      ring > part ? ring : part, n_split, hkv, b, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(k2),
      static_cast<const T*>(v2), static_cast<T*>(out), skv, skv2, hq, hkv, g,
      kv_len, kv_len2, chunk, scale * kLog2e);
}

template <int G, int D, bool PAD>
int launch_fp32(const void* q, const void* k, const void* v, const void* k2,
                const void* v2, void* out, int b, int skv, int skv2, int hq,
                int hkv, int kv_len, int kv_len2, int chunk, int n_split,
                float scale, cudaStream_t stream) {
  const int g = hq / hkv;
  const size_t ring = (size_t)kStages * 4 * 2 * kThreads * 16;
  const size_t part = partial_bytes(g, D);
  return launch_clusters<decode_kernel<G, D, PAD>>(
      ring > part ? ring : part, n_split, hkv, b, stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(k2),
      static_cast<const float*>(v2), static_cast<float*>(out), skv, skv2, hq,
      hkv, g, kv_len, kv_len2, chunk, scale * kLog2e);
}

// the fp32 kernel's groups: exact for 1-4, 8, 12 and 16 (every config's
// g), the others on the next one up, padded
template <int D>
int launch_fp32_g(int g, const void* q, const void* k, const void* v,
                  const void* k2, const void* v2, void* out, int b, int skv,
                  int skv2, int hq, int hkv, int kv_len, int kv_len2,
                  int chunk, int n_split, float scale, cudaStream_t s) {
#define DECODE_G(GG, PAD)                                                   \
  if (PAD ? g < GG : g == GG)                                              \
    return launch_fp32<GG, D, PAD>(q, k, v, k2, v2, out, b, skv, skv2, hq, \
                                   hkv, kv_len, kv_len2, chunk, n_split,   \
                                   scale, s);
  DECODE_G(1, false) DECODE_G(2, false) DECODE_G(3, false)
  DECODE_G(4, false) DECODE_G(8, false) DECODE_G(12, false)
  DECODE_G(16, false) DECODE_G(8, true) DECODE_G(12, true)
  DECODE_G(16, true)
#undef DECODE_G
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Any head size, group and float type: the tiled generic kernel
// ---------------------------------------------------------------------------

// One CTA takes the g query heads of a (batch, kv head) as its rows (up to
// Eng::kRows: 64 on the tensor cores, 32 in fp32; more heads take several
// CTAs, side by side in the grid, so that their reads of a split meet in
// L2) over one split's keys (generic_attn.cuh), so the kv head's keys are
// read once a split. The splits are the wrapper's (kernel.py::
// split_plan_generic): enough to give the launch a CTA an SM at least.
// With one split the CTA writes the output; with more, its partial (m, l
// and the unnormalised fp32 O of each head) goes to the workspace ws, and
// decode_combine_kernel merges them in a second launch on the same stream.
// Grid: x = b * hkv * n_hc * n_split, the split fastest; y = O's
// 256-column chunks (BIG, d past 256). Keys: the first kv_len of k/v, then
// the first kv_len2 of k2/v2 (gen::TwoRows).
template <class Eng, bool BIG>
__global__ void __launch_bounds__(gen::kThreads)
decode_generic_kernel(const typename Eng::E* __restrict__ q,
                      const typename Eng::E* __restrict__ k,
                      const typename Eng::E* __restrict__ v,
                      const typename Eng::E* __restrict__ k2,
                      const typename Eng::E* __restrict__ v2,
                      typename Eng::E* __restrict__ out,
                      float* __restrict__ ws, int skv, int skv2, int hq,
                      int hkv, int d, int g, int n_hc, int kv_len,
                      int kv_len2, int chunk, int n_split, long long n_heads,
                      float scale_log2) {
  using E = typename Eng::E;
  extern __shared__ float4 smem4[];
  long long x = blockIdx.x;
  const int split = (int)(x % n_split);
  x /= n_split;
  const int hc = (int)(x % n_hc);
  x /= n_hc;
  const int hi = (int)(x % hkv);
  const long long bi = x / hkv;
  const int h0 = hc * Eng::kRows, R = min(Eng::kRows, g - h0);
  const size_t head0 = (size_t)bi * hq + (size_t)hi * g + h0;
  const int t0 = split * chunk;
  const int n = max(0, min(chunk, kv_len + kv_len2 - t0));  // keys here
  const size_t stride = (size_t)hkv * d;
  const size_t off = (size_t)bi * skv * stride + (size_t)hi * d;
  const size_t off2 = (size_t)bi * skv2 * stride + (size_t)hi * d;
  const gen::TwoRows<E> krows{k + off, k2 + off2, stride, t0, kv_len};
  const gen::TwoRows<E> vrows{v + off, v2 + off2, stride, t0, kv_len};
  const int c0 = BIG ? blockIdx.y * gen::kChunk : 0;
  gen::RangeWalk<Eng::kKeys / gen::kSegRows> walk{n, 0};
  Eng eng;
  float* wm = ws;  // (m, l) of (head, split), then O of (head, split)
  float* wo = ws + 2 * (size_t)n_heads * n_split;
  gen::attend<Eng, BIG>(
      eng, reinterpret_cast<E*>(smem4), walk, q + head0 * d, (size_t)d, R,
      krows, vrows, d, blockIdx.y, 0, 0, scale_log2,
      [&](int r, int c, float m, float l, float a) {
        const size_t h = head0 + r;
        if (n_split == 1) {
          out[h * d + c0 + c] = from_f32<E>(l > 0.f ? a / l : 0.f);
        } else {
          const size_t row = h * n_split + split;
          wo[row * d + c0 + c] = a;
          if (c0 + c == 0) {
            wm[2 * row] = m;
            wm[2 * row + 1] = l;
          }
        }
      });
  grid_dep_launch();  // the combine may start; it waits for this memory
}

// The splits' partials merged into the output: out = sum_s 2^(m_s - M)
// o_s / sum_s 2^(m_s - M) l_s, M the largest m_s. A CTA takes 32 columns
// of one query head (grid: heads x column blocks), a lane a column; its 16
// warps take every 16th split, so each thread's loads are few and
// independent, and the warps' sums meet in shared memory.
constexpr int kCombineWarps = 16;

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                      long long n_heads, int n_split, int d) {
  constexpr int W = kCombineWarps;
  __shared__ float num_w[W][32], den_w[W], max_w[W];
  grid_dep_wait();  // every split's partial has landed
  const long long h = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.y * 32 + lane;
  const float* wm = ws + 2 * h * n_split;
  const float* wo = ws + 2 * n_heads * n_split + h * n_split * d;
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_split; s += W * 32)
    mx = fmaxf(mx, wm[2 * s]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  if (lane == 0) max_w[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < W; ++w) mx = fmaxf(mx, max_w[w]);
  const float ms = mx == -INFINITY ? 0.f : mx;
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = warp; s < n_split; s += W) {
    const float a = exp2_or_0(wm[2 * s], ms);
    den = fmaf(wm[2 * s + 1], a, den);
    if (col < d) num = fmaf(wo[(size_t)s * d + col], a, num);
  }
  num_w[warp][lane] = num;
  if (lane == 0) den_w[warp] = den;
  __syncthreads();
  if (warp == 0 && col < d) {
    float n = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      n += num_w[w][lane];
      l += den_w[w];
    }
    out[h * d + col] = from_f32<T>(l > 0.f ? n / l : 0.f);
  }
}

template <class Eng, bool BIG>
int launch_generic(const void* q, const void* k, const void* v,
                   const void* k2, const void* v2, void* out, void* ws, int b,
                   int skv, int skv2, int hq, int hkv, int d, int kv_len,
                   int kv_len2, int chunk, int n_split, float scale,
                   cudaStream_t stream) {
  using E = typename Eng::E;
  auto kern = decode_generic_kernel<Eng, BIG>;
  static bool configured = false;  // once a kernel: the most it may ask for
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int g = hq / hkv, n_hc = (g + Eng::kRows - 1) / Eng::kRows;
  const long long ctas = (long long)b * hkv * n_hc * n_split;
  if (ctas > 0x7fffffffLL || (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_heads = (long long)b * hq;
  dim3 grid((unsigned)ctas, gen::col_chunks(d));
  kern<<<grid, gen::kThreads, gen::smem_bytes<Eng>(d), stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(k2),
      static_cast<const E*>(v2), static_cast<E*>(out),
      static_cast<float*>(ws), skv, skv2, hq, hkv, d, g, n_hc, kv_len,
      kv_len2, chunk, n_split, n_heads, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  // the combine as a programmatic dependent launch: its launch overlaps
  // the splits' tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_heads, (d + 31) / 32);
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<E>,
                           static_cast<const float*>(ws), static_cast<E*>(out),
                           n_heads, n_split, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instance of a head size's tier (64, 128, 256 columns, or 256-column
// chunks: BIG) and, on the tensor cores, of the query heads' row tiles
// (the groups of 16 keys a warp takes: gen::Tc's NG; BIG takes 4), with
// three stages up to 128 columns (gen::Tc's NS; at 256, 220 KB a CTA
// would leave no room for 64 rows of Q).
#define DECODE_PARAMS                                                     \
  const void *q, const void *k, const void *v, const void *k2,            \
      const void *v2, void *out, void *ws, int b, int skv, int skv2,      \
      int hq, int hkv, int d, int kv_len, int kv_len2, int chunk,         \
      int n_split, float scale, cudaStream_t s
#define DECODE_ARGS                                                    \
  q, k, v, k2, v2, out, ws, b, skv, skv2, hq, hkv, d, kv_len, kv_len2, \
      chunk, n_split, scale, s

template <typename T>
int launch_generic_tc(DECODE_PARAMS) {
  const int n_rt = (min(hq / hkv, 64) + 15) / 16;
  if (d > gen::kChunk)
    return launch_generic<gen::Tc<T, 256, 4>, true>(DECODE_ARGS);
#define TC_NG(TT, NS)                                                      \
  if (n_rt == 1)                                                           \
    return launch_generic<gen::Tc<T, TT, 1, NS>, false>(DECODE_ARGS);      \
  if (n_rt == 2)                                                           \
    return launch_generic<gen::Tc<T, TT, 2, NS>, false>(DECODE_ARGS);      \
  return launch_generic<gen::Tc<T, TT, 4, NS>, false>(DECODE_ARGS);
  switch (gen::tier_of(d)) {
    case 64: { TC_NG(64, 3) }
    case 128: { TC_NG(128, 3) }
    default: { TC_NG(256, 2) }
  }
#undef TC_NG
}

int launch_generic_fp32(DECODE_PARAMS) {
  if (d > gen::kChunk)
    return launch_generic<gen::Simt<256>, true>(DECODE_ARGS);
  switch (gen::tier_of(d)) {
    case 64: return launch_generic<gen::Simt<64>, false>(DECODE_ARGS);
    case 128: return launch_generic<gen::Simt<128>, false>(DECODE_ARGS);
    default: return launch_generic<gen::Simt<256>, false>(DECODE_ARGS);
  }
}
#undef DECODE_ARGS
#undef DECODE_PARAMS

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, 2 fp16. The wrapper has checked: d in {32, 64,
// 80, 128, 256}, hq / hkv in 1..16 (others return cudaErrorInvalidValue),
// b and hkv under 65536, 0 <= kv_len <= skv, 0 <= kv_len2 <= skv2 (k2 and
// v2 a second segment of the same heads and type, or k and v again with
// kv_len2 0), 16-byte aligned q/k/v/k2/v2, and 1 <= n_split <= 16 splits
// of `chunk` keys that cover kv_len + kv_len2, none of them empty unless
// that is 0.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* k2, const void* v2, void* out, int b,
                            int skv, int skv2, int hq, int hkv, int d,
                            int kv_len, int kv_len2, int chunk, int n_split,
                            float scale, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0) return (int)cudaGetLastError();
  const int g = hq / hkv;
  if (n_split < 1 || n_split > kMaxCluster || chunk < 1 || kv_len < 0 ||
      kv_len2 < 0 || (long long)chunk * n_split < (long long)kv_len + kv_len2 ||
      g < 1 || g > 16 || g * hkv != hq)
    return (int)cudaErrorInvalidValue;
#define DECODE_ARGS                                                      \
  q, k, v, k2, v2, out, b, skv, skv2, hq, hkv, kv_len, kv_len2, chunk,   \
      n_split, scale, s
  switch (d) {
#define DECODE_D(DD)                                        \
  case DD:                                                 \
    return dtype == 1   ? launch_tc<bf16, DD>(DECODE_ARGS) \
           : dtype == 2 ? launch_tc<f16, DD>(DECODE_ARGS)  \
                        : launch_fp32_g<DD>(g, DECODE_ARGS);
    DECODE_D(32) DECODE_D(64) DECODE_D(80) DECODE_D(128) DECODE_D(256)
#undef DECODE_D
#undef DECODE_ARGS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The generic kernel (decode_generic_kernel, then decode_combine_kernel
// where n_split > 1): any d >= 1, any g = hq / hkv >= 1, dtype 0 fp32, 1
// bf16, 2 fp16; the segments as decode_attention_launch's; n_split splits
// of `chunk` keys that cover kv_len + kv_len2, none of them empty unless
// that is 0, and a workspace ws of b * hq * n_split * (d + 2) floats where
// n_split > 1 (kernel.py::workspace_floats).
int decode_attention_generic_launch(const void* q, const void* k,
                                    const void* v, const void* k2,
                                    const void* v2, void* out, void* ws,
                                    int b, int skv, int skv2, int hq, int hkv,
                                    int d, int kv_len, int kv_len2, int chunk,
                                    int n_split, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0) return (int)cudaGetLastError();
  if (n_split < 1 || chunk < 1 || kv_len < 0 || kv_len2 < 0 ||
      (long long)chunk * n_split < (long long)kv_len + kv_len2 || hkv < 1 ||
      hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
#define DECODE_ARGS                                                         \
  q, k, v, k2, v2, out, ws, b, skv, skv2, hq, hkv, d, kv_len, kv_len2,      \
      chunk, n_split, scale, s
  switch (dtype) {
    case 0: return launch_generic_fp32(DECODE_ARGS);
    case 1: return launch_generic_tc<bf16>(DECODE_ARGS);
    case 2: return launch_generic_tc<f16>(DECODE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_ARGS
}

}  // extern "C"
