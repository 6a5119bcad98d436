// The generic attention kernels' tiled engine: one CTA of 4 warps takes a
// block of query rows (the rows of a q-block in block-sparse attention, the
// query heads of a kv head in decode) and walks a stream of key rows in
// sub-tiles, all its rows sharing each sub-tile staged in shared memory.
// Both kernels (block_sparse_attn.cu::bsa_generic_kernel,
// decode_attn.cu::decode_generic_kernel) are this engine with their own key
// stream and output.
//
// Key stream. A sub-tile is kKeys key rows in segments of 8 consecutive
// rows (kSegRows): a segment is (first kv row, rows), rows 1..8, or first
// -1 for none. Block-sparse fills segments from its list, at most 8 rows of
// one kv block each (a block of 24 rows is three segments, one of 20 is
// 8 + 8 + 4); decode from its split's range. A missing row is zero-filled
// and masked by its absolute position, as the causal mask is.
//
// Head size. Any d: a row is staged padded with zeros to `width(d)` (16
// columns for the tensor cores, 4 for fp32), and the engine's register
// arrays are sized by a tier of that width (64, 128 or 256 columns) with the
// k-steps and output tiles a run-time count under it, so three instances
// take every d up to 256. Past 256 (BIG) the accumulators of O no longer
// fit: each CTA owns one 256-column chunk of O and V (the grid's y), and
// recomputes S chunk by chunk, Q and K staged 256 columns at a time.
//
// Staging. 16-byte cp.async copies, 8 threads a row, where a row is a whole
// number of 16-byte pieces (zero-filled past d and for missing rows), into
// a ring of kStages sub-tiles (K then V) so that the next sub-tiles' copies
// overlap the current products; otherwise (d = 33 in bf16, say) element by
// element. Rows are padded in shared memory so that the reads of 8 rows at
// one column fall in 8 different bank groups: an odd number of 16-byte
// chunks (tensor cores, ldmatrix), or a pitch of 4 floats past a multiple
// of 32 (fp32, 16 lanes reading 16 rows).
//
// Tc<T, TIER, NG, NS> (bf16, fp16): mma.sync.m16n8k16 with fp32
// accumulation, the fast kernels' fragments (mma_sm90.cuh). 32 rows a CTA
// (two m16 tiles), or 64 (four) where the rows need three or four; where
// they take fewer than 4 tiles, the warps of a tile share its keys (2 or 4
// warps a tile, NG = 2 or 1 groups of 16 keys of each 64-key sub-tile), and
// their partial softmaxes are merged through shared memory at the end. p is
// packed to T for P V (the Pallas kernels' p.astype(v.dtype)) while l sums
// the fp32 p.
// Simt<TIER> (fp32): the CUDA cores, never TF32 (the fp32 tolerance is
// 2e-5). Up to 32 rows a CTA: a thread holds 4 rows x 2 keys of S (keys tx,
// tx + 16 of a 32-key sub-tile) and 4 rows x 4 * TIER / 64 columns of O;
// row reductions over the 16 lanes of a half-warp, P moved to the lanes
// that own O's columns by shuffles.
//
// Masking uses -inf with guards, as the fast kernels do: a row that sees no
// key ends with l = 0 and writes 0.
//
// What bounds it (chip_smoke path O; PERF.md §6): neither the tensor
// cores nor the bytes, but the instructions around each sub-tile's
// products (the copies' issue, which stalls in the memory pipeline, the
// walk and the softmax) at 8 to 12 warps an SM; few rows a CTA (24-row
// q-blocks, 20 query heads) give each staged byte little work. The design
// keeps those instructions out of branches (compile-time group counts, P V
// over the tier's every tile) and fits three CTAs an SM.

#pragma once

#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace gen {

using namespace sm90;

constexpr int kThreads = 128;  // 4 warps a CTA
constexpr int kSegRows = 8;    // kv rows a segment
constexpr int kChunk = 256;    // the widest tier: O's columns a CTA

// The tier of a head size: the register arrays' width (64, 128 or 256
// columns; past 256 the BIG form of the 256 tier), and O's column chunks.
__host__ __device__ constexpr int tier_of(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}
__host__ __device__ constexpr int col_chunks(int d) {
  return d <= kChunk ? 1 : (d + kChunk - 1) / kChunk;
}

template <int N>
__device__ __forceinline__ int2 pick(const int2 (&sg)[N], int i) {
  int2 b = sg[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (i == k) b = sg[k];
  return b;
}

// Where a stream's row p lies: base + p * stride (Q, a kv head's keys).
template <typename E>
struct Rows {
  const E* base;
  size_t stride;
  __device__ __forceinline__ const E* row(int p) const {
    return base + (size_t)p * stride;
  }
};

// rows x cw columns of a tile of pitch P from the global rows
// rows_of.row(pos(r)), columns c0 .. c0 + cw - 1 of d; zeros where pos(r) <
// 0 and past d. 16-byte cp.async pieces where `vec` (d * sizeof(E) a
// multiple of 16), else element by element.
template <typename E, class Src, class Pos>
__device__ __forceinline__ void load_rows(E* dst, int P, const Src& rows_of,
                                          int rows, int c0, int cw, int d,
                                          bool vec, Pos pos) {
  constexpr int EPC = 16 / sizeof(E);  // elements a 16-byte piece
  const E* base = rows_of.row(0);
  if (vec) {
    // 8 threads a row, 16 rows a pass
    for (int r = threadIdx.x >> 3; r < rows; r += kThreads / 8) {
      const int p = pos(r);
      const E* src = p >= 0 ? rows_of.row(p) : base;
      E* row = dst + r * P;
      for (int c = threadIdx.x & 7; c * EPC < cw; c += 8) {
        const int col = c0 + c * EPC;
        const bool ok = p >= 0 && col < d;
        cp_async16(row + c * EPC, ok ? src + col : base, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cw; i += kThreads) {
      const int r = i / cw, c = i - r * cw;
      const int p = pos(r), col = c0 + c;
      dst[r * P + c] = p >= 0 && col < d ? rows_of.row(p)[col]
                                         : from_f32<E>(0.f);
    }
  }
}

// A sub-tile's ROWS key rows (segments sg, rows of rows_of) into a tile of
// pitch P, columns
// c0 .. c0 + cw - 1 of d, zeros for missing rows and past d. With 16-byte
// pieces, 8 threads a row (a warp copies 4 rows of 128 contiguous bytes at
// a time) in ROWS / 16 passes, each thread's row in a known pair of
// segments; otherwise element by element.
template <int ROWS, typename E, class Src, int N>
__device__ __forceinline__ void load_keys(E* dst, int P, const Src& rows_of,
                                          int c0, int cw, int d, bool vec,
                                          const int2 (&sg)[N]) {
  constexpr int EPC = 16 / sizeof(E);
  static_assert(ROWS % 16 == 0 && N == ROWS / kSegRows, "sub-tile");
  if (!vec) {
    load_rows(dst, P, rows_of, ROWS, c0, cw, d, false, [&](int r) {
      const int2 b = pick(sg, r / kSegRows);
      const int o = r % kSegRows;
      return b.x >= 0 && o < b.y ? b.x + o : -1;
    });
    return;
  }
  const int rr = threadIdx.x >> 3, o = rr & 7;
#pragma unroll
  for (int pass = 0; pass < ROWS / 16; ++pass) {
    const int2 b = rr >= 8 ? sg[2 * pass + 1] : sg[2 * pass];
    const int p = b.x >= 0 && o < b.y ? b.x + o : -1;
    const E* base = rows_of.row(0);
    const E* src = p >= 0 ? rows_of.row(p) : base;
    E* row = dst + (pass * 16 + rr) * P;
#pragma unroll 1
    for (int c = threadIdx.x & 7; c * EPC < cw; c += 8) {
      const int col = c0 + c * EPC;
      const bool ok = p >= 0 && col < d;
      cp_async16(row + c * EPC, ok ? src + col : base, ok);
    }
  }
}

// Whether key `key` of a sub-tile (segments sg) is seen by the row at
// absolute position `row`
__device__ __forceinline__ bool seen(const int2* sg, int key, int causal,
                                     int row) {
  const int2 b = sg[key / kSegRows];
  const int o = key % kSegRows;
  return b.x >= 0 && o < b.y && (!causal || b.x + o <= row);
}

// ---------------------------------------------------------------------------
// bf16, fp16 on the tensor cores
// ---------------------------------------------------------------------------

// NG: 16-key groups a warp takes of each 64-key sub-tile, fixed by the
// CTA's row tiles (kernels/_generic.py::tc_groups): 1 for one m16 tile (4
// warps share its keys), 2 for two tiles, 4 for three or four (a warp a
// tile). A compile-time count keeps every mma.sync out of a run-time
// branch, which costs a warp synchronisation and the recomputed addresses
// around each (the first design's run-time guards took a third of its
// time).
//
// NS: stages of the ring. Two (block-sparse): 60 KB at d = 96 and 32 rows,
// three CTAs an SM (the registers allow three at up to 170 a thread); three
// stages of two CTAs an SM took a third more time at path O's shapes.
// Three (decode up to 128 columns, whose 250 CTAs at path O's shape fit in
// two an SM), with the next sub-tile's copies issued after the current
// products (attend): 4% faster there.
template <typename T, int TIER, int NG, int NS = 2>
struct Tc {
  using E = T;
  static constexpr int kKeys = 64;  // a sub-tile: 4 groups of 16 keys
  // query rows a CTA: 2 m16 tiles, or 4 where a warp takes a tile
  static constexpr int kRows = NG == 4 ? 64 : 32;
  static constexpr int kStages = NS;
  static constexpr int NO = TIER / 8;  // n8 tiles of O: the tier's all
  static constexpr int WPR = 4 / NG;   // warps a row tile
  __host__ __device__ static int width(int d) { return (d + 15) / 16 * 16; }
  // elements a staged row of cw columns (a multiple of 16): an odd number
  // of 16-byte chunks
  __host__ __device__ static int pitch(int cw) { return cw + 8; }
  __host__ __device__ static int ksteps(int cols) { return cols / 16; }
  __host__ __device__ static int nout(int cols) { return cols / 8; }
  __host__ __device__ static int q_rows(int r) { return (r + 15) / 16 * 16; }
  // shared bytes of the partials merged at the end: a warp's m [16], l
  // [16] and O [16][cw + 1], then each row's (m, l)
  __host__ __device__ static size_t part_bytes(int cw) {
    return sizeof(float) * (4 * (32 + 16 * ((size_t)cw + 1)) + 2 * kRows);
  }

  int rt, kp;   // the warp's row tile and key part
  bool active;  // the tile holds rows of the CTA
  bool plain;   // every row of the tile sees every key of the warp's groups
  float m0, m1, l0, l1;  // rows lane / 4 and lane / 4 + 8 of the tile
  float acc[NO][4];
  float s[NG][2][4];  // S of the warp's groups: [group][n8 tile][fragment]

  __device__ __forceinline__ void init(int R) {
    const int warp = threadIdx.x >> 5;
    rt = warp / WPR;
    kp = warp % WPR;
    active = rt * 16 < R;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // whether the warp's keys of the sub-tile (segments sg) need no mask, and
  // S to 0
  __device__ __forceinline__ void groups(const int2* sg, int causal,
                                         int row0, int) {
    const int first = row0 + rt * 16;
    plain = true;
#pragma unroll
    for (int i = 0; i < 2 * NG; ++i) {
      const int2 b = sg[2 * kp * NG + i];
      plain = plain && b.x >= 0 && b.y == kSegRows &&
              (!causal || b.x + kSegRows - 1 <= first);
    }
#pragma unroll
    for (int gl = 0; gl < NG; ++gl)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[gl][j][e] = 0.f;
  }

  // S += Q K^T over kst k-steps of the staged Q and K (pitch P)
  __device__ __forceinline__ void qk(const T* qs, const T* ks, int P,
                                     int kst) {
    if (!active) return;
    const int lane = threadIdx.x & 31;
    const T* qrow =
        qs + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
        (lane >> 4) * 8;
    const T* krow =
        ks + (kp * NG * 16 + 8 * (lane >> 4) + (lane & 7)) * P +
        ((lane >> 3) & 1) * 8;
#pragma unroll 2
    for (int kk = 0; kk < kst; ++kk) {
      uint32_t a[4];
      ldsm_x4(qrow + kk * 16, a);
#pragma unroll
      for (int gl = 0; gl < NG; ++gl) {
        uint32_t b[4];  // n8 tiles 0 and 1 of the group's 16 keys
        ldsm_x4(krow + gl * 16 * P + kk * 16, b);
        mma16816<T>(s[gl][0], a, b[0], b[1]);
        mma16816<T>(s[gl][1], a, b[2], b[3]);
      }
    }
  }

  // the masked online softmax over the warp's keys of the sub-tile, then
  // O += P V over the tier's n8 tiles of the staged V (those past the
  // head size read padding or the next rows and are never stored)
  __device__ __forceinline__ void softmax_pv(const T* vs, int P, int,
                                             const int2* sg, int causal,
                                             int row0, float sl2) {
    if (!active) return;
    const int lane = threadIdx.x & 31, t2 = 2 * (lane & 3);
    const int p0 = row0 + rt * 16 + (lane >> 2), p1 = p0 + 8;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int gl = 0; gl < NG; ++gl) {
      const int key0 = (kp * NG + gl) * 16 + t2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[gl][j][e] * sl2;
          if (!plain && !seen(sg, key0 + 8 * j + (e & 1), causal,
                              e < 2 ? p0 : p1))
            x = -INFINITY;
          s[gl][j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int gl = 0; gl < NG; ++gl)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[gl][j][0] = exp2f(s[gl][j][0] - ms0);
        s[gl][j][1] = exp2f(s[gl][j][1] - ms0);
        s[gl][j][2] = exp2f(s[gl][j][2] - ms1);
        s[gl][j][3] = exp2f(s[gl][j][3] - ms1);
        sum0 += s[gl][j][0] + s[gl][j][1];
        sum1 += s[gl][j][2] + s[gl][j][3];
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
    const T* vrow = vs + (kp * NG * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             P +
                    (lane >> 4) * 8;
#pragma unroll
    for (int gl = 0; gl < NG; ++gl) {
      const uint32_t pa[4] = {pack2<T>(s[gl][0][0], s[gl][0][1]),
                              pack2<T>(s[gl][0][2], s[gl][0][3]),
                              pack2<T>(s[gl][1][0], s[gl][1][1]),
                              pack2<T>(s[gl][1][2], s[gl][1][3])};
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(vrow + gl * 16 * P + j * 8, b);
        mma16816<T>(acc[j], pa, b[0], b[1]);
        mma16816<T>(acc[j + 1], pa, b[2], b[3]);
      }
    }
  }

  // Merge the warps' partials of each row tile through shared memory
  // (part, after the ring is drained) and hand each of the R rows' ncols
  // columns to out(row, column, m, l, o): m the row's max (log2 units), l
  // its sum, o the unnormalised output. Every thread calls it.
  template <class Out>
  __device__ __forceinline__ void finish(float* part, int R, int ncols,
                                         int no, Out out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t2 = 2 * (lane & 3), g8 = lane >> 2;
    const int rp = no * 8 + 1;         // a partial row, padded
    const int stride = 32 + 16 * rp;   // a warp's m [16], l [16], O [16][rp]
    float* info = part + 4 * stride;   // each row's (m, l)
    if (active) {
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, w);
        l1 += __shfl_xor_sync(0xffffffffu, l1, w);
      }
      float* pw = part + warp * stride;
      if ((lane & 3) == 0) {
        pw[g8] = m0;
        pw[g8 + 8] = m1;
        pw[16 + g8] = l0;
        pw[24 + g8] = l1;
      }
      float* po = pw + 32;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (j < no) {
          po[g8 * rp + 8 * j + t2] = acc[j][0];
          po[g8 * rp + 8 * j + t2 + 1] = acc[j][1];
          po[(g8 + 8) * rp + 8 * j + t2] = acc[j][2];
          po[(g8 + 8) * rp + 8 * j + t2 + 1] = acc[j][3];
        }
      }
    }
    __syncthreads();
    // each row's max over its warps, their weights (in place of their m)
    // and the row's l
    if ((int)threadIdx.x < R) {
      const int r = threadIdx.x, rr = r % 16;
      float* p0 = part + (r / 16) * WPR * stride;
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < WPR; ++k) mx = fmaxf(mx, p0[k * stride + rr]);
      const float ms = mx == -INFINITY ? 0.f : mx;
      float l = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) {
        const float m = p0[k * stride + rr];
        const float a = m == -INFINITY ? 0.f : exp2f(m - ms);
        l = fmaf(p0[k * stride + 16 + rr], a, l);
        p0[k * stride + rr] = a;
      }
      info[2 * r] = mx;
      info[2 * r + 1] = l;
    }
    __syncthreads();
    for (int r = warp; r < R; r += 4) {
      const float* p0 = part + (r / 16) * WPR * stride;
      const int rr = r % 16;
      float a[WPR];
#pragma unroll
      for (int k = 0; k < WPR; ++k) a[k] = p0[k * stride + rr];
      const float mx = info[2 * r], l = info[2 * r + 1];
      for (int c = lane; c < ncols; c += 32) {
        float o = 0.f;
#pragma unroll
        for (int k = 0; k < WPR; ++k)
          o = fmaf(p0[k * stride + 32 + rr * rp + c], a[k], o);
        out(r, c, mx, l, o);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int TIER>
struct Simt {
  using E = float;
  static constexpr int kKeys = 32;  // a sub-tile: keys tx and tx + 16
  static constexpr int kRows = 32;  // query rows a CTA: 8 groups of 4
  // two stages (64 KB at d = 96, three CTAs an SM)
  static constexpr int kStages = 2;
  static constexpr int C4 = TIER / 64;  // float4 columns of O a thread
  __host__ __device__ static int width(int d) { return (d + 3) / 4 * 4; }
  __host__ __device__ static int pitch(int cw) {
    return (cw + 31) / 32 * 32 + 4;
  }
  __host__ __device__ static int ksteps(int cols) { return cols / 4; }
  __host__ __device__ static int nout(int cols) { return cols / 4; }
  __host__ __device__ static int q_rows(int) { return kRows; }
  __host__ __device__ static size_t part_bytes(int) { return 0; }

  int ty, tx;  // rows 4 ty .. 4 ty + 3; keys tx, tx + 16; O's float4
               // columns tx + 16 c
  float m[4], l[4];
  float acc[4][C4][4];
  float s[4][2];

  __device__ __forceinline__ void init(int) {
    ty = threadIdx.x >> 4;
    tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }

  // S to 0 (every sub-tile is masked key by key)
  __device__ __forceinline__ void groups(const int2*, int, int, int) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
  }

  // S += Q K^T over n4 float4 columns of the staged Q and K (pitch P)
  __device__ __forceinline__ void qk(const float* qs, const float* ks, int P,
                                     int n4) {
    const float* qr = qs + ty * 4 * P;
    const float* kr = ks + tx * P;
#pragma unroll 2
    for (int kk = 0; kk < n4; ++kk) {
      float4 a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qr + i * P + 4 * kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        b[j] = *reinterpret_cast<const float4*>(kr + j * 16 * P + 4 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          x = fmaf(a[i].w, b[j].w, x);
          s[i][j] = x;
        }
    }
  }

  __device__ __forceinline__ void softmax_pv(const float* vs, int P, int n4,
                                             const int2* sg, int causal,
                                             int row0, float sl2) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = seen(sg, tx + 16 * j, causal, row)
                            ? s[i][j] * sl2 : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float c = m[i] == -INFINITY ? 0.f : exp2f(m[i] - ms);
      s[i][0] = exp2f(s[i][0] - ms);
      s[i][1] = exp2f(s[i][1] - ms);
      float sum = s[i][0] + s[i][1];
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * c + sum;
      m[i] = mn;
#pragma unroll
      for (int cc = 0; cc < C4; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][cc][e] *= c;
    }
    // O += P V: key src + 16 j's p from the lane that holds it
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll 4
      for (int src = 0; src < 16; ++src) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = __shfl_sync(0xffffffffu, s[i][j], (lane & 16) | src);
        const float* vr = vs + (src + 16 * j) * P;
#pragma unroll
        for (int cc = 0; cc < C4; ++cc) {
          const int g4 = tx + 16 * cc;
          if (g4 < n4) {
            const float4 v = *reinterpret_cast<const float4*>(vr + 4 * g4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][cc][0] = fmaf(p[i], v.x, acc[i][cc][0]);
              acc[i][cc][1] = fmaf(p[i], v.y, acc[i][cc][1]);
              acc[i][cc][2] = fmaf(p[i], v.z, acc[i][cc][2]);
              acc[i][cc][3] = fmaf(p[i], v.w, acc[i][cc][3]);
            }
          }
        }
      }
    }
  }

  template <class Out>
  __device__ __forceinline__ void finish(float*, int R, int ncols, int,
                                         Out out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= R) continue;
#pragma unroll
      for (int cc = 0; cc < C4; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * (tx + 16 * cc) + e;
          if (c < ncols) out(r, c, m[i], l[i], acc[i][cc][e]);
        }
    }
  }
};

// ---------------------------------------------------------------------------
// Key streams
// ---------------------------------------------------------------------------

// Block-sparse: the kv blocks of a q-block's list in list order, skipping
// entries outside [0, n_kb) and, under the causal mask, blocks whose first
// row lies past the CTA's last row (row_last); each block in segments of
// at most kSegRows of its rows.
template <int N>
struct ListWalk {
  const int32_t* list;
  int n_list, n_kb, kv_block, causal, row_last;
  int t, kv0, sub;  // the entry, its first kv row (-1: none), the next row

  __device__ __forceinline__ int2 seg() {
    for (;;) {
      if (kv0 >= 0 && sub < kv_block && (!causal || kv0 + sub <= row_last)) {
        const int n = min(kSegRows, kv_block - sub);
        sub += kSegRows;
        return make_int2(kv0 + sub - kSegRows, n);
      }
      if (++t >= n_list) {  // past the list's end, for good
        t = n_list;
        kv0 = -1;
        return make_int2(-1, 0);
      }
      const int kb = __ldg(list + t);
      kv0 = kb < 0 || kb >= n_kb ? -1 : kb * kv_block;
      sub = 0;
    }
  }
  __device__ __forceinline__ void next(int2 (&sg)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) sg[i] = seg();
  }
};

// Decode's key rows: a split's row p is key t0 + p of one range, the first
// n_a keys of a cache (a) and then those of a second (b, the decode tail),
// each at `stride` a row. With nothing in b, the rows of Rows{a + t0 *
// stride, stride}.
template <typename E>
struct TwoRows {
  const E* a;
  const E* b;
  size_t stride;
  int t0, n_a;
  __device__ __forceinline__ const E* row(int p) const {
    const int t = t0 + p;
    return t < n_a ? a + (size_t)t * stride : b + (size_t)(t - n_a) * stride;
  }
};

// Decode: keys 0 .. n - 1 of a split, in order.
template <int N>
struct RangeWalk {
  int n, at;
  __device__ __forceinline__ void next(int2 (&sg)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = at + i * kSegRows;
      sg[i] = p < n ? make_int2(p, min(kSegRows, n - p)) : make_int2(-1, 0);
    }
    at += N * kSegRows;
  }
};

// ---------------------------------------------------------------------------
// The CTA's walk
// ---------------------------------------------------------------------------

// Shared memory (elements of Eng::E) the engine asks for at head size d:
// the ring and Q (resident, d up to 256) or one Q chunk and one K/V chunk
// (BIG), then the segments; at least the partials of Tc::finish.
template <class Eng>
__host__ __device__ size_t smem_bytes(int d) {
  using E = typename Eng::E;
  constexpr int NSEG = Eng::kKeys / kSegRows;
  const int w = Eng::width(d);
  const bool big = w > kChunk;
  const int cw = big ? kChunk : w, P = Eng::pitch(cw);
  const size_t tiles =
      big ? (size_t)(Eng::kRows + Eng::kKeys) * P
          : (size_t)Eng::kStages * 2 * Eng::kKeys * P +
                (size_t)Eng::kRows * P;
  const size_t bytes = tiles * sizeof(E) +
                       (big ? 1 : Eng::kStages) * NSEG * sizeof(int2);
  const size_t part = Eng::part_bytes(big ? kChunk : w);
  return bytes > part ? bytes : part;
}

// One CTA: R query rows from qbase (row stride qstride), at absolute
// positions row0 ... (the causal mask's), against the keys `walk` gives,
// key row p read from krows.row(p) / vrows.row(p); O's column chunk cs
// where BIG. Hands every (row, column) of the result to out(r, c, m, l, o).
template <class Eng, bool BIG, class Walk, class Src, class Out>
__device__ __forceinline__ void attend(Eng& eng, typename Eng::E* smem,
                                       Walk& walk,
                                       const typename Eng::E* qbase,
                                       size_t qstride, int R,
                                       const Src& krows, const Src& vrows,
                                       int d, int cs, int causal, int row0,
                                       float sl2, Out out) {
  using E = typename Eng::E;
  constexpr int KEYS = Eng::kKeys, NSEG = KEYS / kSegRows;
  const int tid = threadIdx.x;
  const bool vec = (d * sizeof(E)) % 16 == 0;
  const int width = Eng::width(d);
  const Rows<E> qrows{qbase, qstride};
  auto qpos = [&](int r) { return r < R ? r : -1; };
  int ncols, no;  // O's columns this CTA writes; its output tiles
  eng.init(R);

  if constexpr (!BIG) {
    // three stages or more: the next copies wait for the current products,
    // when fewer of the CTA's copies are still in flight
    constexpr int NS = Eng::kStages;
    constexpr bool kLate = NS >= 3;
    const int cw = width, P = Eng::pitch(cw), STAGE = 2 * KEYS * P;
    E* qs = smem + NS * STAGE;
    int2* segs = reinterpret_cast<int2*>(qs + Eng::kRows * P);
    ncols = d;
    no = Eng::nout(cw);
    load_rows(qs, P, qrows, Eng::q_rows(R), 0, cw, d, vec, qpos);
    cp_async_commit();
    // the next sub-tile into stage st, its segments into segs; false past
    // the stream's end. Every thread walks the stream alike.
    auto issue = [&](int st) {
      int2 sg[NSEG];
      walk.next(sg);
      if (tid < NSEG) segs[st * NSEG + tid] = pick(sg, tid);
      if (sg[0].x < 0) return false;
      E* ks = smem + st * STAGE;
      load_keys<KEYS>(ks, P, krows, 0, cw, d, vec, sg);
      load_keys<KEYS>(ks + KEYS * P, P, vrows, 0, cw, d, vec, sg);
      return true;
    };
    bool pend[NS - 1];
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      pend[st] = issue(st);
      cp_async_commit();
    }
    for (int it = 0; pend[0]; ++it) {
      const int st = it % NS;
      cp_async_wait<NS - 2>();  // this thread's copies of sub-tile it
      // everyone's copies have landed, and everyone is done with sub-tile
      // it - 1, whose stage takes sub-tile it + NS - 1
      __syncthreads();
      auto next = [&] {
        const bool nx = issue((it + NS - 1) % NS);
        cp_async_commit();
#pragma unroll
        for (int i = 0; i < NS - 2; ++i) pend[i] = pend[i + 1];
        pend[NS - 2] = nx;
      };
      if constexpr (!kLate) next();
      const E* ks = smem + st * STAGE;
      const int2* sg = segs + st * NSEG;
      eng.groups(sg, causal, row0, R);
      eng.qk(qs, ks, P, Eng::ksteps(cw));
      eng.softmax_pv(ks + KEYS * P, P, no, sg, causal, row0, sl2);
      if constexpr (kLate) next();
    }
  } else {
    const int cw = kChunk, P = Eng::pitch(cw);
    E* qs = smem;
    E* ks = qs + Eng::kRows * P;  // K's chunks, then V's
    int2* segs = reinterpret_cast<int2*>(ks + KEYS * P);
    const int c_own = cs * kChunk;
    const int own = min(kChunk, width - c_own);
    ncols = min(kChunk, d - c_own);
    no = Eng::nout(own);
    const int nc = (width + kChunk - 1) / kChunk;
    for (;;) {
      int2 sg[NSEG];
      walk.next(sg);
      if (sg[0].x < 0) break;
      __syncthreads();  // the previous sub-tile's readers are done
      if (tid < NSEG) segs[tid] = pick(sg, tid);
      for (int c = 0; c < nc; ++c) {
        if (c > 0) __syncthreads();  // the previous chunk's readers are done
        load_rows(qs, P, qrows, Eng::q_rows(R), c * kChunk, cw, d, vec,
                  qpos);
        load_keys<KEYS>(ks, P, krows, c * kChunk, cw, d, vec, sg);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (c == 0) eng.groups(segs, causal, row0, R);
        eng.qk(qs, ks, P, Eng::ksteps(min(kChunk, width - c * kChunk)));
      }
      __syncthreads();  // K's last chunk is consumed; V takes its place
      load_keys<KEYS>(ks, P, vrows, c_own, cw, d, vec, sg);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      eng.softmax_pv(ks, P, no, segs, causal, row0, sl2);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes take the partials
  eng.finish(reinterpret_cast<float*>(smem), R, ncols, no, out);
}

}  // namespace gen
