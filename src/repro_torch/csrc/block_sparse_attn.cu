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
// Three kernels. The wrapper (kernel.py::_fast) picks one by shape and
// dtype before the launch; none stands in for another, and a failed
// launch raises. The fast kernels take head sizes 64, 80, 128 and 256
// and blocks that are multiples of 16: bf16 and fp16 on the tensor cores
// (bsa_tc_kernel), fp32 on the CUDA cores (block_sparse_attn_kernel).
// The generic kernel (bsa_generic_kernel, at the end) takes every other
// shape the reference takes, in all three types: any head size to 4096,
// any q_block and kv_block. It is the tiled engine of generic_attn.cuh: a
// CTA takes up to 64 rows of one q-block (32 in fp32) and walks its list
// in 8-row segments, so a kv block of any size fills 64-key sub-tiles
// (24 rows: three segments), staged once by 16-byte cp.async for all the
// CTA's rows; bf16 and fp16 on the tensor cores (the fast kernel's
// fragments, a run-time count of k-steps under a tier of 64, 128 or 256
// columns), fp32 on the CUDA cores (4 x 2 of S and 4 x 4 * tier / 64 of O
// a thread). Past 256 columns, O's columns are split over the grid's y.
// What bounds it at blocks under 64 rows: the latency of each sub-tile's
// walk, copies and products against few rows (24 rows re-read each listed
// tile from L2 for 24 queries), not the tensor cores (PERF.md §6).
//
// Block sizes (the fast kernels): q_block and kv_block are any multiples
// of 16 (the m16 of mma.sync). A CTA takes rows of one q-block: the most
// of 128 (bf16 and fp16 only), 64, 32 or 16 that divides q_block (96 ->
// 32, 48 -> 16). K and V come in
// 64-row sub-tiles of four 16-row segments, each the next 16 listed rows
// in list order (next_subtile): a kv_block of 64 or 128 gives whole
// sub-tiles of one block, 16 or 32 several blocks a sub-tile, 96 a
// sub-tile and a half. A segment's keys are masked by their own absolute
// positions, and a segment missing at the list's end is zero-filled and
// masked. Both kernels take the walk as a template (SEGS): where kv_block
// is a multiple of 64 every sub-tile is 64 rows of one block, and the
// kernel keeps only its first row, as before blocks of 16 were taken.
//
// bf16, fp16 -> bsa_tc_kernel<T>, the tensor cores (FlashAttention-2's
// design; mma.sync m16n8k16 has one shape and fragment layout for both
// types, so the element type is a template). A CTA of
// NW warps (1, 2, 4 or 8) takes 16 * NW query rows, each warp 16 rows. Head
// sizes 64, 80, 128 and 256. Up to d = 128, Q is copied once and held as mma A
// fragments in registers (ldmatrix.x4), and K and V come in 64-row sub-tiles by
// 16-byte cp.async into a three-stage ring in shared memory (Q passes through
// the third stage first), so the next two sub-tiles' copies overlap the current
// products, with one barrier a sub-tile. At d = 256 the O accumulators take 128
// registers a thread: Q stays in shared memory and its fragments are read at
// each k-step, and the ring has two stages (192 KB at 128 rows), so the next
// sub-tile's copy overlaps the products. The 16-byte chunks of a row are
// XOR-swizzled by (row % 8) (d 64, 128, 256), or a row of d = 80 is padded to
// 11 chunks (mma_sm90.cuh, tile_pitch), so ldmatrix reads 8 rows without bank
// conflicts; d = 80's fifth k-step reads K by ldmatrix.x2. S = Q K^T and O += P
// V run as mma.sync.m16n8k16 T x T -> fp32 (K read by ldmatrix as the
// column-major B, V by ldmatrix.trans). The online softmax stays in registers:
// a lane holds rows lane/4 and lane/4 + 8 and columns 2 * (lane % 4) + {0, 1}
// of each 8-column tile, so the row max reduces over the 4 lanes of a quad; the
// fp32 S accumulators are packed into T A fragments for P V without a trip
// through shared memory. That packing rounds p to T exactly as the Pallas
// kernel's p.astype(v.dtype), and T x T products are exact in fp32, so the
// kernel computes the Pallas function up to the order of the sums. The grid
// is (bh, row-blocks) with the row-block index reversed, so under the causal
// mask the heaviest q-blocks (qb + 1 tiles) start first.
//
// fp32 -> block_sparse_attn_kernel, fp32 FMAs on the CUDA cores (67
// TFLOP/s at most). TF32 tensor cores would round the inputs to 10-bit
// mantissas, beyond the fp32 tolerance (2e-5) of the kernel's contract.
// One CTA of 4 * BM threads takes BM query rows (64, 32 or 16) and walks
// the list in the same 64-row sub-tiles: K^T into shared memory, S = Q K^T
// (each thread a 4 x 4 patch), the online-softmax update in registers, P into
// shared memory, then V over the K buffer and O += P V. At d = 80 a
// thread's 5 output columns are one float4 group and one scalar.
//
// The fast kernels read their own list (the TPU's scalar prefetch has no
// counterpart): entries past block_cnt, or outside [0, skv / kv_block),
// are never read, and segments that the causal mask hides from all of a
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

#include "generic_attn.cuh"
#include "mma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using namespace sm90;
constexpr int TC_BN = 64;        // kv rows per sub-tile
constexpr int SEG = 16;          // kv rows per segment: the smallest block
constexpr int NSEG = TC_BN / SEG;

// rows x D from global (row stride D) into a tile of pitch tile_pitch<D>,
// by cp.async
template <int D, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    cp_async16(dst + swz<D>(r, ch), src + (size_t)r * D + ch * 8);
  }
}

// The first kv row of the next STEP rows at or after (t, sub) of the list
// (a 16-row segment, or a whole sub-tile where kv_block is a multiple of
// it): listed (t < n_list), inside k/v, and not hidden from every row up
// to row_last by the causal mask. Moves (t, sub) past them. Returns -1
// past the list's end (where t stays at n_list).
template <int STEP>
__device__ __forceinline__ int next_rows(const int32_t* list, int n_list,
                                         int n_kb, int kv_block, int causal,
                                         int row_last, int& t, int& sub) {
  for (; t < n_list; ++t, sub = 0) {
    const int kb = __ldg(list + t);
    if (kb < 0 || kb >= n_kb || sub >= kv_block) continue;
    const int kv0 = kb * kv_block + sub;
    if (!causal || kv0 <= row_last) {
      sub += STEP;
      return kv0;
    }
  }
  return -1;
}

// The next sub-tile of the list: the first kv rows of its NSEG segments in
// list order, -1 for each past the list's end. A block of 16 or 32 rows
// gives a sub-tile several blocks; one of 96 rows spans two sub-tiles.
// Where one block holds the whole sub-tile (blocks of 64 or more rows,
// none of it hidden by the causal mask), its segments follow each other
// and the list is read once.
__device__ __forceinline__ void next_subtile(const int32_t* list, int n_list,
                                             int n_kb, int kv_block,
                                             int causal, int row_last,
                                             int& t, int& sub,
                                             int (&seg)[NSEG]) {
  seg[0] = next_rows<SEG>(list, n_list, n_kb, kv_block, causal, row_last, t,
                          sub);
  if (seg[0] >= 0 && sub + (NSEG - 1) * SEG <= kv_block &&
      (!causal || seg[0] + (NSEG - 1) * SEG <= row_last)) {
#pragma unroll
    for (int i = 1; i < NSEG; ++i) seg[i] = seg[0] + i * SEG;
    sub += (NSEG - 1) * SEG;
    return;
  }
#pragma unroll
  for (int i = 1; i < NSEG; ++i)
    seg[i] = next_rows<SEG>(list, n_list, n_kb, kv_block, causal, row_last,
                            t, sub);
}

// Whether a sub-tile's segments are TC_BN consecutive kv rows
__device__ __forceinline__ bool contiguous(const int (&seg)[NSEG]) {
  bool c = seg[0] >= 0;
#pragma unroll
  for (int i = 1; i < NSEG; ++i) c = c && seg[i] == seg[0] + i * SEG;
  return c;
}

// seg[i] for a run-time i, without a trip through local memory
__device__ __forceinline__ int pick(const int (&seg)[NSEG], int i) {
  int b = seg[0];
#pragma unroll
  for (int k = 1; k < NSEG; ++k)
    if (i == k) b = seg[k];
  return b;
}

// A sub-tile's TC_BN rows (segment i: 16 rows from kv row seg[i], zeros
// where seg[i] < 0) into a tile of pitch tile_pitch<D>, by cp.async
template <int D, int NT, typename T>
__device__ __forceinline__ void load_subtile(T* dst, const T* src,
                                             const int (&seg)[NSEG],
                                             int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < TC_BN * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    const int b = pick(seg, r / SEG);
    cp_async16(dst + swz<D>(r, ch),
               src + (size_t)(b < 0 ? 0 : b + r % SEG) * D + ch * 8, b >= 0);
  }
}

// How a head size shapes the tensor-core kernel. Up to d = 128 the warp's
// Q fragments stay in registers (KS * 4 of them) and Q passes through the
// ring's last stage; three stages. At d = 256 the O accumulators alone
// are 128 fp32 registers a thread, so Q stays in shared memory beside the
// ring and each k-step reads its fragments by ldmatrix (25% more shared
// reads than K's), and the ring has two stages of 64 KB.
template <int D>
struct TcShape {
  static constexpr bool kQRegs = D <= 128;
  static constexpr int kStages = kQRegs ? 3 : 2;
  static constexpr int kPitch = tile_pitch<D>();
  static constexpr int kStage = 2 * TC_BN * kPitch;  // K, then V
  // 16-bit elements of shared memory at BM query rows a CTA
  __host__ __device__ static constexpr int elems(int bm) {
    return kStages * kStage + (kQRegs ? 0 : bm * kPitch);
  }
  // bytes of shared memory: the tiles, then (segs) each stage's segments
  __host__ __device__ static constexpr int bytes(int bm, bool segs) {
    return 2 * elems(bm) + (segs ? kStages * NSEG * 4 : 0);
  }
};

// Grid: (bh, sq / BM), BM = 16 * NW rows of one q-block; block NW * 32.
// Dynamic shared: TcShape<D>::kStages stages of K [TC_BN][D] and V
// [TC_BN][D], bf16, at pitch tile_pitch<D>; Q [BM][D] passes through the
// last stage before its first sub-tile arrives, or (d = 256) stays after
// the ring; then (SEGS) each stage's NSEG segment rows (int), last, so
// that the tiles keep the allocation's alignment, which the swizzle needs.
// SEGS: kv_block is not a multiple of TC_BN, and sub-tiles are gathered
// from 16-row segments; else each sub-tile is TC_BN rows of one block,
// kept in registers as its first kv row.
template <typename T, int D, int NW, bool SEGS>
__global__ void __launch_bounds__(NW * 32, (NW == 4 && D <= 128) ? 2 : 1)
bsa_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v,
              const int32_t* __restrict__ block_idx,
              const int32_t* __restrict__ block_cnt, T* __restrict__ o,
              int sq, int skv, int n_qb, int max_nnz, int q_block,
              int kv_block, int kv_group, int causal, float scale_log2) {
  using S = TcShape<D>;
  constexpr int BM = NW * 16, NT = NW * 32, KS = D / 16, NO = D / 8;
  constexpr int NS = S::kStages, STAGE = S::kStage;
  static_assert(!S::kQRegs || BM * S::kPitch <= STAGE,
                "Q must fit in one stage");
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int qb = row0 / q_block;
  const int n_kb = skv / kv_block;
  const int wrow0 = row0 + warp * 16;  // this warp's first query row
  const int row_last = row0 + BM - 1;
  const size_t kv_off = (size_t)(bh / kv_group) * skv * D;
  const T* kp = k + kv_off;
  const T* vp = v + kv_off;
  const int32_t* list = block_idx + ((size_t)bh * n_qb + qb) * max_nnz;
  const int n_list = min(block_cnt[(size_t)bh * n_qb + qb], max_nnz);
  // segs[st * NSEG + i]: the first kv row of segment i in stage st
  // (-1: none)
  int* segs = reinterpret_cast<int*>(ring + S::elems(BM));
  int ct = 0, cs = 0;  // where the search for the next rows starts
  // the next sub-tile of the list into stage st; returns its first kv row
  // (-1 past the list's end). Every thread walks the list alike; with
  // SEGS the first NSEG threads write the sub-tile's segments.
  auto issue = [&](int st) {
    T* kd = ring + st * STAGE;
    T* vd = kd + TC_BN * S::kPitch;
    if constexpr (!SEGS) {
      const int kv = next_rows<TC_BN>(list, n_list, n_kb, kv_block, causal,
                                      row_last, ct, cs);
      if (kv >= 0) {
        load_tile<D, NT>(kd, kp + (size_t)kv * D, TC_BN, tid);
        load_tile<D, NT>(vd, vp + (size_t)kv * D, TC_BN, tid);
      }
      return kv;
    } else {
      int seg[NSEG];
      next_subtile(list, n_list, n_kb, kv_block, causal, row_last, ct, cs,
                   seg);
      if (tid < NSEG) segs[st * NSEG + tid] = pick(seg, tid);
      if (seg[0] < 0) return -1;
      if (contiguous(seg)) {  // rows from seg[0] on, as one tile
        load_tile<D, NT>(kd, kp + (size_t)seg[0] * D, TC_BN, tid);
        load_tile<D, NT>(vd, vp + (size_t)seg[0] * D, TC_BN, tid);
      } else {
        load_subtile<D, NT>(kd, kp, seg, tid);
        load_subtile<D, NT>(vd, vp, seg, tid);
      }
      return seg[0];
    }
  };

  // prologue: Q, then the first NS - 1 sub-tiles into the first stages;
  // pend holds their first kv rows in order (-1 past the list's end)
  T* qs = ring + (S::kQRegs ? (NS - 1) * STAGE : NS * STAGE);
  load_tile<D, NT>(qs, q + ((size_t)bh * sq + row0) * D, BM, tid);
  cp_async_commit();
  int pend[NS - 1];
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    pend[st] = issue(st);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // Q has landed
  __syncthreads();

  // A fragments of k-step kk of this warp's 16 Q rows
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    ldsm_x4(qs + swz<D>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * kk + (lane >> 4)),
            a);
  };
  uint32_t qa[S::kQRegs ? KS : 1][4];
  if constexpr (S::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) q_frag(kk, qa[kk]);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r, r+8
  const int r0 = wrow0 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);

  for (int it = 0; pend[0] >= 0; ++it) {
    const int st = it % NS, first = pend[0];
    cp_async_wait<NS - 2>();  // this thread's copies of sub-tile it
    // everyone's copies have landed, and everyone is done with sub-tile
    // it - 1 (and Q, where it passed through the ring), whose stage takes
    // sub-tile it + NS - 1
    __syncthreads();
    const int kv_new = issue((it + NS - 1) % NS);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < NS - 2; ++i) pend[i] = pend[i + 1];
    pend[NS - 2] = kv_new;

    // whether the sub-tile is TC_BN consecutive keys from its first, and
    // its first key (missing segments at the list's end are masked)
    const int* sg = segs + st * NSEG;
    int lo = first;
    bool contig = true;
    if constexpr (SEGS) {
#pragma unroll
      for (int i = 1; i < NSEG; ++i) {
        const int b = sg[i];
        contig = contig && b == first + i * SEG;
        if (b >= 0) lo = min(lo, b);
      }
    }
    if (!causal || lo <= wrow0 + 15) {
      const T* ks = ring + st * STAGE;
      const T* vs = ks + TC_BN * S::kPitch;
      float s[TC_BN / 8][4];
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // two k-steps a K ldmatrix.x4; the last of an odd count (d = 80)
      // from an .x2
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        const bool two = kk + 1 < KS;
        uint32_t qf[2][4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qf[0][e] = qa[kk][e];
            qf[1][e] = qa[two ? kk + 1 : kk][e];
          }
        } else {
          q_frag(kk, qf[0]);
          if (two) q_frag(kk + 1, qf[1]);
        }
#pragma unroll
        for (int j = 0; j < TC_BN / 8; ++j) {
          if (two) {
            uint32_t b[4];
            ldsm_x4(ks + swz<D>(8 * j + (lane & 7), 2 * kk + (lane >> 3)),
                    b);
            mma16816<T>(s[j], qf[0], b[0], b[1]);
            mma16816<T>(s[j], qf[1], b[2], b[3]);
          } else {
            uint32_t b[2];
            ldsm_x2(ks + swz<D>(8 * j + (lane & 7),
                                2 * kk + ((lane >> 3) & 1)),
                    b);
            mma16816<T>(s[j], qf[0], b[0], b[1]);
          }
        }
      }

      // mask keys past a row (causal), and every key of a sub-tile gathered
      // from several places, by its own position
      const bool diag = causal && first + TC_BN - 1 > wrow0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          const int row = e < 2 ? r0 : r1;
          if constexpr (SEGS) {
            if (!contig || diag) {
              const int b = contig ? first + SEG * (j / 2) : sg[j / 2];
              if (b < 0 ||
                  (causal && b + 8 * (j % 2) + cq + (e & 1) > row))
                x = -INFINITY;
            }
          } else if (diag && first + 8 * j + cq + (e & 1) > row) {
            x = -INFINITY;
          }
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
        const uint32_t pa[4] = {pack2<T>(s[2 * kt][0], s[2 * kt][1]),
                                pack2<T>(s[2 * kt][2], s[2 * kt][3]),
                                pack2<T>(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack2<T>(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t b[4];
          ldsm_x4_t(vs + swz<D>(16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8,
                                j + (lane >> 4)),
                    b);
          mma16816<T>(acc[j], pa, b[0], b[1]);
          mma16816<T>(acc[j + 1], pa, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  T* op = o + ((size_t)bh * sq + r0) * D + cq;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<uint32_t*>(op + 8 * j) = pack2<T>(
        l0 > 0.f ? acc[j][0] / l0 : 0.f, l0 > 0.f ? acc[j][1] / l0 : 0.f);
    *reinterpret_cast<uint32_t*>(op + 8 * D + 8 * j) =
        pack2<T>(l1 > 0.f ? acc[j][2] / l1 : 0.f,
                 l1 > 0.f ? acc[j][3] / l1 : 0.f);
  }
}

template <typename T, int D, int NW, bool SEGS>
int launch_tc(const void* q, const void* k, const void* v, const void* idx,
              const void* cnt, void* o, int bh, int sq, int skv, int n_qb,
              int max_nnz, int q_block, int kv_block, int kv_group,
              int causal, float scale, cudaStream_t stream) {
  const size_t smem = TcShape<D>::bytes(NW * 16, SEGS);
  auto kern = bsa_tc_kernel<T, D, NW, SEGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, sq / (NW * 16));
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(cnt), static_cast<T*>(o), sq, skv, n_qb,
      max_nnz, q_block, kv_block, kv_group, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BN = TC_BN;      // kv rows per sub-tile
constexpr int LDK = BN + 4;    // row stride of the transposed K tile (floats)

// q: (bh, sq, D); k/v: (bh / kv_group, skv, D); o: (bh, sq, D).
// block_idx: (bh, n_qb, max_nnz) i32; block_cnt: (bh, n_qb) i32.
// Grid: bh * (sq / BM) on x, row block fastest (bh past 65535 fits), BM
// rows of one q-block (64, 32 or 16); block
// 4 * BM threads, 16 a row group: ty picks 4 rows, tx 4 columns. Shared:
// qT[D][BM + 4], kv[max(D * LDK, BN * D)], pT[BN][BM + 4]: 87 KB at d = 128
// and BM = 64, two CTAs an SM; 157 KB at d = 256, one.
// A thread's output columns: float4 groups c4 * 64 + tx * 4 (c4 < D / 64),
// then, where 64 does not divide D (d = 80), D % 64 / 16 scalar columns
// from (D / 64) * 64 + tx * (D % 64 / 16).
template <int D, int BM, bool SEGS>
__global__ void __launch_bounds__(4 * BM, D <= 128 ? 2 : 1)
block_sparse_attn_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ block_idx,
                         const int32_t* __restrict__ block_cnt,
                         float* __restrict__ o, int sq, int skv, int n_qb,
                         int max_nnz, int q_block, int kv_block,
                         int kv_group, int causal, float scale) {
  constexpr int NT = 4 * BM;
  constexpr int LDQ = BM + 4;  // row stride of qT and pT (floats)
  constexpr int CPT = D / 16;  // output columns per thread
  constexpr int F4 = D / 64;   // of them in float4 groups
  constexpr int REM = CPT - 4 * F4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                                  // [D][LDQ]
  float* kv = qT + D * LDQ;                          // K^T [D][LDK] / V [BN][D]
  float* pT = kv + (D * LDK > BN * D ? D * LDK : BN * D);  // [BN][LDQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_rb = sq / BM;
  const int bh = blockIdx.x / n_rb;
  const int row0 = (blockIdx.x - bh * n_rb) * BM;  // this CTA's first row
  const int qb = row0 / q_block;
  const int n_kb = skv / kv_block;

  const float* qp = q + ((size_t)bh * sq + row0) * D;
  const size_t kv_off = (size_t)(bh / kv_group) * skv * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;

  for (int e = tid; e < BM * D; e += NT)
    qT[(e % D) * LDQ + e / D] = qp[e];

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int32_t* list = block_idx + ((size_t)bh * n_qb + qb) * max_nnz;
  const int n_list = min(block_cnt[(size_t)bh * n_qb + qb], max_nnz);
  int t = 0, sub = 0;  // where the search for the next segment starts

  for (;;) {
    int seg[NSEG];  // the same walk in every thread (see bsa_tc_kernel)
    if constexpr (SEGS) {
      next_subtile(list, n_list, n_kb, kv_block, causal, row0 + BM - 1, t,
                   sub, seg);
    } else {
      seg[0] = next_rows<BN>(list, n_list, n_kb, kv_block, causal,
                             row0 + BM - 1, t, sub);
#pragma unroll
      for (int i = 1; i < NSEG; ++i) seg[i] = seg[0] + i * SEG;
    }
    if (seg[0] < 0) break;
    const bool contig = !SEGS || contiguous(seg);
    const int kv0 = seg[0];
    __syncthreads();  // the previous sub-tile's readers are done
    if (contig) {
      for (int e = tid; e < BN * D; e += NT)
        kv[(e % D) * LDK + e / D] = kp[(size_t)kv0 * D + e];
    } else {
      for (int e = tid; e < BN * D; e += NT) {
        const int r = e / D, b = pick(seg, r / SEG);
        kv[(e % D) * LDK + r] =
            b < 0 ? 0.f : kp[(size_t)(b + r % SEG) * D + e % D];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[kk * LDQ + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[kk * LDK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    __syncthreads();  // K^T is consumed; V goes into the same buffer

    if (contig) {
      for (int e = tid; e < BN * D; e += NT) kv[e] = vp[(size_t)kv0 * D + e];
    } else {
      for (int e = tid; e < BN * D; e += NT) {
        const int r = e / D, b = pick(seg, r / SEG);
        kv[e] = b < 0 ? 0.f : vp[(size_t)(b + r % SEG) * D + e % D];
      }
    }

    // this thread's 4 keys lie in segment tx / 4, from key kb0
    const int sb = contig ? kv0 + (tx >> 2) * SEG : pick(seg, tx >> 2);
    const int kb0 = sb + (tx & 3) * 4;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = row0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (sb < 0 || (causal && kb0 + j > qpos)) x = -INFINITY;
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
      *reinterpret_cast<float4*>(&pT[(tx * 4 + j) * LDQ + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&pT[j * LDQ + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int c4 = 0; c4 < F4; ++c4) {
        const float4 vv = *reinterpret_cast<const float4*>(
            &kv[j * D + c4 * 64 + tx * 4]);
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c4 * 4 + e] = fmaf(pv[i], vx[e], acc[i][c4 * 4 + e]);
      }
#pragma unroll
      for (int e = 0; e < REM; ++e) {
        const float vx = kv[j * D + F4 * 64 + tx * REM + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][4 * F4 + e] = fmaf(pv[i], vx, acc[i][4 * F4 + e]);
      }
    }
  }

  float* op = o + ((size_t)bh * sq + row0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c4 = 0; c4 < F4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[(ty * 4 + i) * D + c4 * 64 + tx * 4 + e] =
            l[i] > 0.f ? acc[i][c4 * 4 + e] * inv : 0.f;
#pragma unroll
    for (int e = 0; e < REM; ++e)
      op[(ty * 4 + i) * D + F4 * 64 + tx * REM + e] =
          l[i] > 0.f ? acc[i][4 * F4 + e] * inv : 0.f;
  }
}

template <int D, int BM, bool SEGS>
int launch_fp32(const void* q, const void* k, const void* v,
                const void* idx, const void* cnt, void* o, int bh, int sq,
                int skv, int n_qb, int max_nnz, int q_block, int kv_block,
                int kv_group, int causal, float scale, cudaStream_t stream) {
  const int kv_floats = D * LDK > BN * D ? D * LDK : BN * D;
  const size_t smem =
      sizeof(float) * (size_t)(D * (BM + 4) + kv_floats + BN * (BM + 4));
  auto kern = block_sparse_attn_kernel<D, BM, SEGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)bh * (unsigned)(sq / BM);
  kern<<<grid, 4 * BM, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(cnt), static_cast<float*>(o), sq, skv, n_qb,
      max_nnz, q_block, kv_block, kv_group, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any head size, block size and float type: the tiled generic kernel
// ---------------------------------------------------------------------------

// One CTA takes up to Eng::kRows rows of one q-block (64 on the tensor
// cores, 32 in fp32; a longer q-block takes several CTAs) and walks the
// q-block's list in 8-row segments (generic_attn.cuh), every row sharing
// each staged sub-tile. Grid: x = bh * n_qb * n_rc CTAs, the (q-block, row
// chunk) slowest and reversed, so that under the causal mask the heaviest
// q-blocks start first; y = O's 256-column chunks (BIG, d past 256).
template <class Eng, bool BIG>
__global__ void __launch_bounds__(gen::kThreads)
bsa_generic_kernel(const typename Eng::E* __restrict__ q,
                   const typename Eng::E* __restrict__ k,
                   const typename Eng::E* __restrict__ v,
                   const int32_t* __restrict__ block_idx,
                   const int32_t* __restrict__ block_cnt,
                   typename Eng::E* __restrict__ o, int bh_total, int sq,
                   int skv, int d, int n_qb, int max_nnz, int q_block,
                   int kv_block, int kv_group, int causal, float scale_log2,
                   int n_rc) {
  using E = typename Eng::E;
  extern __shared__ float4 smem4[];
  const long long x = blockIdx.x;
  const int bh = (int)(x % bh_total);
  const int qrc = n_qb * n_rc - 1 - (int)(x / bh_total);  // heaviest first
  const int qb = qrc / n_rc, rc = qrc - qb * n_rc;
  const int row0 = qb * q_block + rc * Eng::kRows;
  const int R = min(Eng::kRows, q_block - rc * Eng::kRows);
  const size_t kv_off = (size_t)(bh / kv_group) * skv * d;
  const size_t list0 = (size_t)bh * n_qb + qb;
  gen::ListWalk<Eng::kKeys / gen::kSegRows> walk{
      block_idx + list0 * max_nnz, min(block_cnt[list0], max_nnz),
      skv / kv_block, kv_block, causal, row0 + R - 1, -1, -1, 0};
  const int c0 = BIG ? blockIdx.y * gen::kChunk : 0;
  E* op = o + ((size_t)bh * sq + row0) * d + c0;
  Eng eng;
  gen::attend<Eng, BIG>(
      eng, reinterpret_cast<E*>(smem4), walk,
      q + ((size_t)bh * sq + row0) * d, (size_t)d, R,
      gen::Rows<E>{k + kv_off, (size_t)d},
      gen::Rows<E>{v + kv_off, (size_t)d}, d, blockIdx.y, causal, row0,
      scale_log2,
      [&](int r, int c, float, float l, float a) {
        op[(size_t)r * d + c] = from_f32<E>(l > 0.f ? a / l : 0.f);
      });
}

template <class Eng, bool BIG>
int launch_generic(const void* q, const void* k, const void* v,
                   const void* idx, const void* cnt, void* o, int bh, int sq,
                   int skv, int d, int n_qb, int max_nnz, int q_block,
                   int kv_block, int kv_group, int causal, float scale,
                   cudaStream_t stream) {
  using E = typename Eng::E;
  auto kern = bsa_generic_kernel<Eng, BIG>;
  static bool configured = false;  // once a kernel: the most it may ask for
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_rc = (q_block + Eng::kRows - 1) / Eng::kRows;
  const long long ctas = (long long)bh * n_qb * n_rc;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ctas, gen::col_chunks(d));
  kern<<<grid, gen::kThreads, gen::smem_bytes<Eng>(d), stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(cnt), static_cast<E*>(o), bh, sq, skv, d,
      n_qb, max_nnz, q_block, kv_block, kv_group, causal,
      scale * 1.4426950408889634f, n_rc);
  return (int)cudaGetLastError();
}

// The instance of a head size's tier (64, 128, 256 columns, or 256-column
// chunks: BIG) and, on the tensor cores, of a q-block's row tiles (the
// groups of 16 keys a warp takes: gen::Tc's NG; BIG takes 4).
#define BSA_PARAMS                                                          \
  const void *q, const void *k, const void *v, const void *idx,             \
      const void *cnt, void *o, int bh, int sq, int skv, int d, int n_qb,   \
      int max_nnz, int q_block, int kv_block, int kv_group, int causal,     \
      float scale, cudaStream_t s
#define BSA_ARGS                                                            \
  q, k, v, idx, cnt, o, bh, sq, skv, d, n_qb, max_nnz, q_block, kv_block,   \
      kv_group, causal, scale, s

template <typename T>
int launch_generic_tc(BSA_PARAMS) {
  const int n_rt = (min(q_block, 64) + 15) / 16;
  if (d > gen::kChunk)
    return launch_generic<gen::Tc<T, 256, 4>, true>(BSA_ARGS);
#define TC_NG(TT)                                                           \
  if (n_rt == 1) return launch_generic<gen::Tc<T, TT, 1>, false>(BSA_ARGS); \
  if (n_rt == 2) return launch_generic<gen::Tc<T, TT, 2>, false>(BSA_ARGS); \
  return launch_generic<gen::Tc<T, TT, 4>, false>(BSA_ARGS);
  switch (gen::tier_of(d)) {
    case 64: { TC_NG(64) }
    case 128: { TC_NG(128) }
    default: { TC_NG(256) }
  }
#undef TC_NG
}

int launch_generic_fp32(BSA_PARAMS) {
  if (d > gen::kChunk) return launch_generic<gen::Simt<256>, true>(BSA_ARGS);
  switch (gen::tier_of(d)) {
    case 64: return launch_generic<gen::Simt<64>, false>(BSA_ARGS);
    case 128: return launch_generic<gen::Simt<128>, false>(BSA_ARGS);
    default: return launch_generic<gen::Simt<256>, false>(BSA_ARGS);
  }
}
#undef BSA_ARGS
#undef BSA_PARAMS

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, 2 fp16. Returns a CUDA error code; 1
// (cudaErrorInvalidValue) for a head size other than 64, 80, 128 or 256,
// or rows a CTA other than 16, 32, 64 or 128 (bf16, fp16) and 16, 32 or 64
// (fp32). The wrapper has checked shapes and divisibility: sq % q_block ==
// 0, q_block % rows == 0, kv_block % 16 == 0, skv % kv_block == 0, and
// the grid: sq / rows <= 65535 (bf16, fp16), bh * sq / rows < 2^31
// (fp32).
int block_sparse_attention_launch(const void* q, const void* k,
                                  const void* v, const void* block_idx,
                                  const void* block_cnt, void* o, int bh,
                                  int sq, int skv, int d, int n_qb,
                                  int max_nnz, int q_block, int kv_block,
                                  int kv_group, int causal, float scale,
                                  int dtype, int rows, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (sq == 0 || bh == 0) return (int)cudaGetLastError();
  // kv blocks that are not whole sub-tiles take the segmented walk
  const bool segs = kv_block % TC_BN != 0;
#define BSA_ARGS                                                            \
  q, k, v, block_idx, block_cnt, o, bh, sq, skv, n_qb, max_nnz, q_block,    \
      kv_block, kv_group, causal, scale, s
#define BSA_TC(T, DD)                                                        \
  if (rows == 16) return launch_tc<T, DD, 1, true>(BSA_ARGS);                \
  if (rows == 32) return launch_tc<T, DD, 2, true>(BSA_ARGS);                \
  if (rows == 64 && segs) return launch_tc<T, DD, 4, true>(BSA_ARGS);        \
  if (rows == 64) return launch_tc<T, DD, 4, false>(BSA_ARGS);               \
  if (rows == 128 && segs) return launch_tc<T, DD, 8, true>(BSA_ARGS);       \
  if (rows == 128) return launch_tc<T, DD, 8, false>(BSA_ARGS);
#define BSA_D(DD)                                                            \
  if (d == DD && dtype == 0) {                                               \
    if (rows == 16) return launch_fp32<DD, 16, true>(BSA_ARGS);              \
    if (rows == 32) return launch_fp32<DD, 32, true>(BSA_ARGS);              \
    if (rows == 64 && segs) return launch_fp32<DD, 64, true>(BSA_ARGS);      \
    if (rows == 64) return launch_fp32<DD, 64, false>(BSA_ARGS);             \
  }                                                                          \
  if (d == DD && dtype == 1) { BSA_TC(bf16, DD) }                            \
  if (d == DD && dtype == 2) { BSA_TC(f16, DD) }
  BSA_D(64) BSA_D(80) BSA_D(128) BSA_D(256)
#undef BSA_D
#undef BSA_TC
#undef BSA_ARGS
  return (int)cudaErrorInvalidValue;
}

// The generic kernel (bsa_generic_kernel): any d >= 1, any q_block and
// kv_block, dtype 0 fp32, 1 bf16, 2 fp16. The wrapper has checked sq %
// q_block == 0, skv % kv_block == 0 and bh * n_qb * ceil(q_block / 32) <
// 2^31.
int block_sparse_attention_generic_launch(
    const void* q, const void* k, const void* v, const void* block_idx,
    const void* block_cnt, void* o, int bh, int sq, int skv, int d, int n_qb,
    int max_nnz, int q_block, int kv_block, int kv_group, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (sq == 0 || bh == 0) return (int)cudaGetLastError();
#define BSA_ARGS                                                            \
  q, k, v, block_idx, block_cnt, o, bh, sq, skv, d, n_qb, max_nnz, q_block, \
      kv_block, kv_group, causal, scale, s
  switch (dtype) {
    case 0: return launch_generic_fp32(BSA_ARGS);
    case 1: return launch_generic_tc<bf16>(BSA_ARGS);
    case 2: return launch_generic_tc<f16>(BSA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BSA_ARGS
}

}  // extern "C"
