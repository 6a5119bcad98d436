// PTX helpers shared by the tensor-core kernels of this directory:
// cp.async copies into shared memory, ldmatrix, and the bf16 mma.sync
// m16n8k16 with fp32 accumulation. Fragment layouts (PTX ISA, "Matrix
// fragments for mma.m16n8k16"): lane l holds rows l / 4 and l / 4 + 8 and
// columns 2 * (l % 4) + {0, 1} (+ 8) of each 16 x 8 tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Element offset of 16-byte chunk `ch` of row `row` in a [rows][D] bf16
// tile, the chunks XOR-swizzled so that the 8 rows an ldmatrix reads at
// one logical chunk fall on 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  static_assert(D == 32 || D % 64 == 0, "head size");
  if constexpr (D == 32)  // 4 chunks a row, two rows a 128-byte line
    return row * D + ((ch ^ ((row >> 1) & 3)) << 3);
  else
    return row * D + ((ch ^ (row & 7)) << 3);
}

}  // namespace sm90
