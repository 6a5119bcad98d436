// KV-chunk dequantization for Hopper (sm_90a): one launch over every
// streamed chunk of a request, written straight into the KV cache.
//
// Replaces repro/kernels/kv_dequant/kernel.py::_kernel (kv_dequant) and
// ::_mixed_kernel (kv_dequant_mixed): uint8 codes plus per-group fp32
// parameters -> x = code * step + zero, written as fp32 or bf16.
//
// What bounds it: bytes. Each value reads 1 B of code and writes 4 B of
// fp32 (2 B of bf16); each group also reads 8 B of parameters. A cachegen
// request of the main path (144 chunk tensors of 1,048,576 values, group
// 64, fp32 out) moves 774 MB: 0.231 ms at the H100's 3.35 TB/s. Launched
// once per chunk tensor, the same work was bound by launch overhead
// instead (1.6 us of bytes a launch), and each chunk's output took one
// more copy into the cache.
//
// What the design does about it:
// - One launch takes a list of entries (chunk tensors). Their codes,
//   parameters and zeros are concatenated, as whole groups, into flat
//   buffers; an int64 table row per entry gives its first group, its value
//   count, the address its values go to (a chunk's slot of the K or V
//   cache), its bit-width and its first code. Every value is written once,
//   at its place; group padding past an entry's count is never written.
// - The grid is sized to the card: the SM count times the CTAs a SM holds.
//   Each CTA walks one contiguous range of 512-code tiles, a warp two tiles
//   at a time; a lane issues its two 16-byte code loads for the next two
//   tiles before it stores the current ones, so the loads' latency hides
//   behind the stores.
// - Stores are full 16-byte vectors and coalesced: a warp's 512 codes pass
//   through shared memory, so each store instruction of the warp covers
//   512 contiguous bytes. Code loads are streaming (evict-first), since
//   each code is read once.
// - A lane finds the entry of its values by binary search over the table's
//   first codes and keeps it in registers while it stays inside it (an
//   entry is a million values on the main path).
// - Any group size: a value's group is (its index in the entry) / group,
//   so a 16-byte vector may span two or more groups (bf16 at group 100,
//   any group under 8). A vector inside one group takes one (step, zero)
//   pair, as at group 64 or 8; one that spans groups reads a pair a value.
//   Each entry's codes start at their own offset (the table's first
//   code): a batch that ops.stage lays out starts every entry on a 16-byte
//   boundary, so its vectors never straddle two entries. A vector that
//   does (the row-matrix forms at a width that is not a multiple of a
//   vector's 4 fp32 or 8 bf16 values), or whose destination is not
//   16-byte aligned, is written value by value.

// Rounding: the result is fma(code, step, zero) rounded once, as the
// Pallas kernels give it; the mixed form's step is the IEEE fp32 quotient
// span / (2^bits - 1). The explicit intrinsics keep -fmad and -prec-div
// from changing either. bf16 output is that fp32 value rounded to nearest
// even.
//
// Plain C interface for ctypes. The launcher returns the first CUDA error
// it meets, cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;     // codes a warp loads at once, 16 a lane
constexpr int kUnroll = 2;     // tiles a warp loads before it stores any

// Columns of the entry table (int64).
constexpr int kFirstGroup = 0, kNVals = 1, kDst = 2, kBits = 3,
              kFirstCode = 4, kCols = 5;

struct Entry {
  int64_t v0 = 0, v1 = 0;  // flat code range [v0, v1) up to the next entry
                           // (v0: its first code)
  int64_t g0 = 0;          // first group
  int64_t n_vals = 0;      // values it writes
  char* dst = nullptr;
  float q = 1.f;           // 2^bits - 1 (mixed form)
  int64_t vend = -1;       // the last code a 16-byte vector of the entry
                           // may start at: v1 - a vector's values where v0
                           // is a multiple of them and dst 16-byte aligned
                           // (and v0 <= v when found), else none
};

// The last entry whose first code is at or before flat code `v` (the
// first entry where none is).
template <typename Out>
__device__ __forceinline__ void find_entry(const int64_t* __restrict__ table,
                                           int n_entries, int64_t n_codes,
                                           int64_t v, Entry& e) {
  int lo = 0, hi = n_entries - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + (int64_t)mid * kCols + kFirstCode) <= v)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int64_t* row = table + (int64_t)lo * kCols;
  e.g0 = __ldg(row + kFirstGroup);
  e.v0 = __ldg(row + kFirstCode);
  e.v1 = lo + 1 < n_entries ? __ldg(row + kCols + kFirstCode) : n_codes;
  e.n_vals = __ldg(row + kNVals);
  e.dst = reinterpret_cast<char*>(__ldg(row + kDst));
  e.q = (float)((1 << (int)__ldg(row + kBits)) - 1);
  constexpr int kVals = 16 / sizeof(Out);
  e.vend = e.v0 <= v && e.v0 % kVals == 0 &&
                   (reinterpret_cast<uintptr_t>(e.dst) & 15) == 0
               ? e.v1 - kVals
               : INT64_MIN;
}

__device__ __forceinline__ uint4 load_stream(const uint8_t* p) {
  uint4 r;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void store16(void* p, uint32_t a, uint32_t b,
                                        uint32_t c, uint32_t d) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// kVals values (one 16-byte store) to `out`, or only the first `left`.
__device__ __forceinline__ void put(float* out, const float* x, int64_t left) {
  if (left >= 4) {
    store16(out, __float_as_uint(x[0]), __float_as_uint(x[1]),
                 __float_as_uint(x[2]), __float_as_uint(x[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < left) out[i] = x[i];
  }
}

__device__ __forceinline__ void put(__nv_bfloat16* out, const float* x,
                                    int64_t left) {
  if (left >= 8) {
    store16(out, pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                 pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < left) out[i] = __float2bfloat16_rn(x[i]);
  }
}

__device__ __forceinline__ void put1(float* out, float x) { *out = x; }
__device__ __forceinline__ void put1(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16_rn(x);
}

// The step and zero of group gi.
template <bool MIXED>
__device__ __forceinline__ void group_params(const float* __restrict__ params,
                                             const float* __restrict__ zeros,
                                             int64_t gi, float q, float& step,
                                             float& zero) {
  step = __ldg(params + gi);
  if (MIXED) step = __fdiv_rn(step, q);
  zero = __ldg(zeros + gi);
}

// codes (n_codes,) u8; params/zeros (n_groups,) f32 (params: the steps, or
// the spans when MIXED); table (n_entries, kCols) int64, sorted by first
// group and by first code. An entry's values are its n_vals codes from its
// first code, in groups of `group` from its first group. WHOLE: group is a
// multiple of a vector's values, so a vector that starts at a multiple of
// them in an entry spans no group boundary.
template <typename Out, bool MIXED, bool WHOLE>
__global__ void __launch_bounds__(kThreads, 4)
dequant_kernel(const uint8_t* __restrict__ codes,
               const float* __restrict__ params,
               const float* __restrict__ zeros,
               const int64_t* __restrict__ table, int n_entries,
               int64_t n_codes, int group) {
  constexpr int kVals = 16 / sizeof(Out);        // values a 16-byte store
  constexpr int kStores = kTile / (32 * kVals);  // stores a lane a tile
  __shared__ __align__(16) uint8_t stage[kWarps][kUnroll][kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_tiles = (n_codes + kTile - 1) / kTile;
  const int64_t begin = n_tiles * blockIdx.x / gridDim.x;
  const int64_t end = n_tiles * (blockIdx.x + 1) / gridDim.x;
  Entry e;

  uint4 raw[kUnroll];
  auto load = [&](int64_t t) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = (t + u) * kTile + lane * 16;
      raw[u] = (t + u < end && at < n_codes) ? load_stream(codes + at)
                                             : make_uint4(0, 0, 0, 0);
    }
  };
  load(begin + (int64_t)warp * kUnroll);
  for (int64_t t0 = begin + (int64_t)warp * kUnroll; t0 < end;
       t0 += kWarps * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<uint4*>(&stage[warp][u][lane * 16]) = raw[u];
    __syncwarp();
    load(t0 + kWarps * kUnroll);   // the next tiles' loads fly meanwhile
    // each lane stores kVals values a step: (tile u, store j), 32 lanes
    // on contiguous 16-byte runs
#pragma unroll 2
    for (int sj = 0; sj < kUnroll * kStores; ++sj) {
      const int u = sj / kStores, j = sj % kStores;
      if (t0 + u >= end) break;
      const int off = (j * 32 + lane) * kVals;     // within the tile
      const int64_t v = (t0 + u) * kTile + off;
      if (v >= n_codes) continue;
      if (v < e.v0 || v >= e.v1)
        find_entry<Out>(table, n_entries, n_codes, v, e);
      const int64_t local = v - e.v0;
      const uint8_t* cs = &stage[warp][u][off];
      if (v <= e.vend) {
        if (local >= e.n_vals) continue;           // group padding
        uint32_t w[kVals / 4];
#pragma unroll
        for (int i = 0; i < kVals / 4; ++i)
          w[i] = reinterpret_cast<const uint32_t*>(cs)[i];
        const uint32_t gq = (uint32_t)local / (uint32_t)group;
        float x[kVals];
        if (WHOLE || (uint32_t)local - gq * (uint32_t)group + kVals <=
                         (uint32_t)group) {        // one group: one pair
          float step, zero;
          group_params<MIXED>(params, zeros, e.g0 + gq, e.q, step, zero);
#pragma unroll
          for (int i = 0; i < kVals; ++i)
            x[i] = __fmaf_rn((float)((w[i / 4] >> (8 * (i % 4))) & 0xffu),
                             step, zero);
        } else {                                   // a pair a value
#pragma unroll
          for (int i = 0; i < kVals; ++i) {
            x[i] = 0.f;
            if (local + i >= e.n_vals) continue;   // past the last group
            float step, zero;
            group_params<MIXED>(
                params, zeros,
                e.g0 + ((uint32_t)local + i) / (uint32_t)group, e.q, step,
                zero);
            x[i] = __fmaf_rn((float)((w[i / 4] >> (8 * (i % 4))) & 0xffu),
                             step, zero);
          }
        }
        put(reinterpret_cast<Out*>(e.dst) + local, x, e.n_vals - local);
      } else {
        // value by value: the vector crosses an entry's bounds, or the
        // entry does not start on a vector or at a 16-byte aligned
        // destination
        for (int i = 0; i < kVals && v + i < n_codes; ++i) {
          const int64_t vi = v + i;
          if (vi < e.v0 || vi >= e.v1)
            find_entry<Out>(table, n_entries, n_codes, vi, e);
          const int64_t li = vi - e.v0;
          if (li < 0 || li >= e.n_vals) continue;
          float step, zero;
          group_params<MIXED>(params, zeros,
                              e.g0 + (int64_t)((uint32_t)li / (uint32_t)group),
                              e.q, step, zero);
          put1(reinterpret_cast<Out*>(e.dst) + li,
               __fmaf_rn((float)cs[i], step, zero));
        }
      }
    }
    __syncwarp();
  }
}

template <typename Out, bool MIXED>
int grid_size(int64_t n_codes, int* grid) {
  // CTAs a SM holds: fixed for a built kernel (the whole-group instance's;
  // both instances' launch bounds ask for 4)
  static int per_sm = 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dequant_kernel<Out, MIXED, true>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n_codes + kTile - 1) / kTile;
  const int64_t want = (tiles + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(want < cap ? want : cap);
  return 0;
}

template <typename Out, bool MIXED>
int launch(const void* codes, const void* params, const void* zeros,
           const void* table, int n_entries, int64_t n_codes, int group,
           cudaStream_t s) {
  int grid = 0;
  int err = grid_size<Out, MIXED>(n_codes, &grid);
  if (err) return err;
  if (grid == 0 || n_entries == 0) return (int)cudaGetLastError();
  auto kern = group % (16 / sizeof(Out)) ? dequant_kernel<Out, MIXED, false>
                                         : dequant_kernel<Out, MIXED, true>;
  kern<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(params),
      static_cast<const float*>(zeros), static_cast<const int64_t*>(table),
      n_entries, n_codes, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over a batch of entries (see dequant_kernel). mixed: params
// are spans and the table's bit-widths set the steps; out_bf16: every
// destination is bf16, else fp32.
int kv_dequant_launch(const void* codes, const void* params,
                      const void* zeros, const void* table, int n_entries,
                      long long n_codes, int group, int mixed, int out_bf16,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mixed)
    return out_bf16 ? launch<__nv_bfloat16, true>(codes, params, zeros, table,
                                                  n_entries, n_codes, group,
                                                  s)
                    : launch<float, true>(codes, params, zeros, table,
                                          n_entries, n_codes, group, s);
  return out_bf16 ? launch<__nv_bfloat16, false>(codes, params, zeros, table,
                                                 n_entries, n_codes, group, s)
                  : launch<float, false>(codes, params, zeros, table,
                                         n_entries, n_codes, group, s);
}

// The grid kv_dequant_launch takes for n_codes codes, or -(CUDA error).
int kv_dequant_grid(long long n_codes, int mixed, int out_bf16) {
  int grid = 0, err;
  if (mixed)
    err = out_bf16 ? grid_size<__nv_bfloat16, true>(n_codes, &grid)
                   : grid_size<float, true>(n_codes, &grid);
  else
    err = out_bf16 ? grid_size<__nv_bfloat16, false>(n_codes, &grid)
                   : grid_size<float, false>(n_codes, &grid);
  return err ? -err : grid;
}

}  // extern "C"
