// Helpers shared by the attention kernels of this directory: cp.async
// copies into shared memory, ldmatrix, the bf16 and fp16 mma.sync
// m16n8k16 with fp32 accumulation, the element types' conversions, the row
// pitch of the fast kernels' tiles and programmatic dependent launch.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"): lane l
// holds rows l / 4 and l / 4 + 8 and columns 2 * (l % 4) + {0, 1} (+ 8) of
// each 16 x 8 tile; the fp16 instruction has the bf16 one's shape and
// fragments, so a kernel templated on the element type takes either.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; 16 zero bytes where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// Programmatic dependent launch: a kernel lets the next one on its stream
// start (launch_dependents), and that one waits for the first's memory
// (wait), so the second launch's latency overlaps the first's tail.
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16 x 16, row) * b (16 x 8, col), fp16 in, fp32 accumulate
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// The mma and the packing (round to nearest even) of element type T, bf16
// or fp16.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same_v<T, f16>) mma_f16(c, a, b0, b1);
  else mma_bf16(c, a, b0, b1);
}
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>) return pack_f16(lo, hi);
  else return pack_bf16(lo, hi);
}

// An element of fp32, bf16 or fp16 to fp32, and fp32 to T rounded to
// nearest even.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, f16>) return __float2half_rn(x);
  else if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(x);
  else return x;
}

// Row pitch, in elements, of a [rows][D] bf16 tile in shared memory. Where
// a row is 8 or more 16-byte chunks and their count a power of two (D 64,
// 128, 256), the pitch is D and the chunks are XOR-swizzled (swz). Other
// head sizes (D 80: 10 chunks, which an XOR by row % 8 would send off the
// row) take an odd number of chunks a row, D / 8 or one more: 8 rows at one
// logical chunk then fall on 8 different 16-byte bank groups with no
// swizzle (80 -> 88 elements, 176 bytes, 10% more shared memory).
template <int D>
__host__ __device__ constexpr int tile_pitch() {
  static_assert(D % 16 == 0, "head size");
  constexpr int ch = D / 8;
  if constexpr (D == 32 || (ch >= 8 && (ch & (ch - 1)) == 0)) return D;
  else return ch % 2 ? D : D + 8;
}

// Element offset of 16-byte chunk `ch` of row `row` in a [rows][D] bf16
// tile of pitch tile_pitch<D>(), laid out so that the 8 rows an ldmatrix
// reads at one logical chunk fall on 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int P = tile_pitch<D>();
  if constexpr (D == 32)  // 4 chunks a row, two rows a 128-byte line
    return row * D + ((ch ^ ((row >> 1) & 3)) << 3);
  else if constexpr (P == D && D % 64 == 0)
    return row * D + ((ch ^ (row & 7)) << 3);
  else  // an odd number of chunks a row: no swizzle needed
    return row * P + (ch << 3);
}

}  // namespace sm90
