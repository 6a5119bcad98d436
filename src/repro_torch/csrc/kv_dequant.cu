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
//   cache) and its bit-width. Every value is written once, at its place;
//   group padding past an entry's count is never written.
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
//   first groups and keeps it in registers while it stays inside it (an
//   entry is a million values on the main path).
//
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
constexpr int kFirstGroup = 0, kNVals = 1, kDst = 2, kBits = 3, kCols = 4;

struct Entry {
  int64_t v0 = 0, v1 = 0;  // flat code range [v0, v1) up to the next entry
  int64_t g0 = 0;          // first group
  int64_t n_vals = 0;      // values it writes
  char* dst = nullptr;
  float q = 1.f;           // 2^bits - 1 (mixed form)
};

// The last entry whose first code is at or before flat code `v`.
__device__ __forceinline__ void find_entry(const int64_t* __restrict__ table,
                                           int n_entries, int64_t n_groups,
                                           int group, int64_t v, Entry& e) {
  int lo = 0, hi = n_entries - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + (int64_t)mid * kCols + kFirstGroup) * group <= v)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int64_t* row = table + (int64_t)lo * kCols;
  e.g0 = __ldg(row + kFirstGroup);
  e.v0 = e.g0 * group;
  e.v1 = (lo + 1 < n_entries ? __ldg(row + kCols + kFirstGroup) : n_groups)
         * group;
  e.n_vals = __ldg(row + kNVals);
  e.dst = reinterpret_cast<char*>(__ldg(row + kDst));
  e.q = (float)((1 << (int)__ldg(row + kBits)) - 1);
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

// codes (n_groups * group,) u8; params/zeros (n_groups,) f32 (params: the
// steps, or the spans when MIXED); table (n_entries, kCols) int64, sorted
// by first group.
template <typename Out, bool MIXED>
__global__ void __launch_bounds__(kThreads, 4)
dequant_kernel(const uint8_t* __restrict__ codes,
               const float* __restrict__ params,
               const float* __restrict__ zeros,
               const int64_t* __restrict__ table, int n_entries,
               int64_t n_groups, int group) {
  constexpr int kVals = 16 / sizeof(Out);        // values a 16-byte store
  constexpr int kStores = kTile / (32 * kVals);  // stores a lane a tile
  __shared__ __align__(16) uint8_t stage[kWarps][kUnroll][kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_codes = n_groups * group;
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
        find_entry(table, n_entries, n_groups, group, v, e);
      const int64_t local = v - e.v0;
      if (local >= e.n_vals) continue;             // group padding
      const int64_t gi =
          e.g0 + (int64_t)((uint32_t)local / (uint32_t)group);
      float step = __ldg(params + gi);
      if (MIXED) step = __fdiv_rn(step, e.q);
      const float zero = __ldg(zeros + gi);
      uint32_t w[kVals / 4];
#pragma unroll
      for (int i = 0; i < kVals / 4; ++i)
        w[i] = reinterpret_cast<const uint32_t*>(&stage[warp][u][off])[i];
      float x[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i)
        x[i] = __fmaf_rn((float)((w[i / 4] >> (8 * (i % 4))) & 0xffu), step,
                         zero);
      put(reinterpret_cast<Out*>(e.dst) + local, x, e.n_vals - local);
    }
    __syncwarp();
  }
}

template <typename Out, bool MIXED>
int grid_size(int64_t n_codes, int* grid) {
  static int per_sm = 0;     // CTAs a SM holds: fixed for a built kernel
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dequant_kernel<Out, MIXED>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n_codes + kTile - 1) / kTile;
  const int64_t want = (tiles + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(want < cap ? want : cap);
  return 0;
}

template <typename Out, bool MIXED>
int launch(const void* codes, const void* params, const void* zeros,
           const void* table, int n_entries, int64_t n_groups, int group,
           cudaStream_t s) {
  int grid = 0;
  int err = grid_size<Out, MIXED>(n_groups * group, &grid);
  if (err) return err;
  if (grid == 0 || n_entries == 0) return (int)cudaGetLastError();
  dequant_kernel<Out, MIXED><<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(params),
      static_cast<const float*>(zeros), static_cast<const int64_t*>(table),
      n_entries, n_groups, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over a batch of entries (see dequant_kernel). mixed: params
// are spans and the table's bit-widths set the steps; out_bf16: every
// destination is bf16, else fp32.
int kv_dequant_launch(const void* codes, const void* params,
                      const void* zeros, const void* table, int n_entries,
                      long long n_groups, int group, int mixed, int out_bf16,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mixed)
    return out_bf16 ? launch<__nv_bfloat16, true>(codes, params, zeros, table,
                                                  n_entries, n_groups, group,
                                                  s)
                    : launch<float, true>(codes, params, zeros, table,
                                          n_entries, n_groups, group, s);
  return out_bf16 ? launch<__nv_bfloat16, false>(codes, params, zeros, table,
                                                 n_entries, n_groups, group, s)
                  : launch<float, false>(codes, params, zeros, table,
                                         n_entries, n_groups, group, s);
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
