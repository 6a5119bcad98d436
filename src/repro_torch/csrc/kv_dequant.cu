// Fused KV-chunk dequantization for Hopper (sm_90a).
//
// Replaces repro/kernels/kv_dequant/kernel.py::_kernel (kv_dequant) and
// ::_mixed_kernel (kv_dequant_mixed): uint8 codes plus per-group fp32
// parameters -> x = code * step + zero, written as fp32 or bf16.
//
// What bounds it: bytes. Each value reads 1 B of code and writes 4 B of
// fp32 (2 B of bf16); each group of `group` values also reads 8 B of
// parameters. One full-width chunk of the main path (1024 tokens x 8 kv
// heads x 128 = 1,048,576 values, group 64, fp32 out) moves about
// 5.2 MB: about 1.6 us at the H100's 3.35 TB/s, so one launch per chunk
// is bound by launch overhead, not by memory.
//
// What this simple design does about that: nothing yet. One thread
// handles one 16-byte run of codes (16 values inside one group), reads
// that group's parameters and writes its 16 outputs. Wider vectors, more
// work per thread and one launch over every streamed chunk of a request
// are left for later.
//
// Rounding: the result is fma(code, step, zero) rounded once, as the
// Pallas kernel gives it, and the mixed kernel's step is the IEEE fp32
// quotient span / (2^bits - 1). The explicit intrinsics keep -fmad and
// -prec-div from changing either. bf16 output is that fp32 value rounded
// to nearest even.
//
// Plain C interface for ctypes. Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;      // codes per thread: one 16-byte load
constexpr int kThreads = 256;

__device__ __forceinline__ void store16(float* out, const float* x) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i)
    o[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* x) {
  __align__(16) __nv_bfloat16 h[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) h[i] = __float2bfloat16_rn(x[i]);
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4* src = reinterpret_cast<const uint4*>(h);
  o[0] = src[0];
  o[1] = src[1];
}

// codes (rows, width) u8; step_or_span/zeros (rows, width/group) f32;
// bits (rows,) i32 or null. MIXED turns a span into the row's step.
template <typename Out, bool MIXED>
__global__ void dequant_kernel(const uint8_t* __restrict__ codes,
                               const float* __restrict__ step_or_span,
                               const float* __restrict__ zeros,
                               const int32_t* __restrict__ bits,
                               Out* __restrict__ out, int64_t n_vec,
                               int width, int group) {
  int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  int64_t first = v * kVec;
  int64_t row = first / width;
  int col = (int)(first - row * width);
  int64_t p = row * (width / group) + col / group;
  float step = step_or_span[p];
  if (MIXED) {
    float q = (float)((1 << bits[row]) - 1);
    step = __fdiv_rn(step, q);
  }
  float zero = zeros[p];
  uint4 raw = reinterpret_cast<const uint4*>(codes)[v];
  const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
  float x[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = __fmaf_rn((float)c[i], step, zero);
  store16(out + first, x);
}

template <bool MIXED>
int launch(const void* codes, const void* params, const void* zeros,
           const void* bits, void* out, int rows, int width, int group,
           int out_bf16, void* stream) {
  int64_t n_vec = (int64_t)rows * width / kVec;
  if (n_vec == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((n_vec + kThreads - 1) / kThreads));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* p = static_cast<const float*>(params);
  const float* z = static_cast<const float*>(zeros);
  const int32_t* b = static_cast<const int32_t*>(bits);
  if (out_bf16)
    dequant_kernel<__nv_bfloat16, MIXED><<<grid, kThreads, 0, s>>>(
        c, p, z, b, static_cast<__nv_bfloat16*>(out), n_vec, width, group);
  else
    dequant_kernel<float, MIXED><<<grid, kThreads, 0, s>>>(
        c, p, z, b, static_cast<float*>(out), n_vec, width, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kv_dequant: scales are the per-group steps.
int kv_dequant_launch(const void* codes, const void* scales,
                      const void* zeros, void* out, int rows, int width,
                      int group, int out_bf16, void* stream) {
  return launch<false>(codes, scales, zeros, nullptr, out, rows, width,
                       group, out_bf16, stream);
}

// kv_dequant_mixed: spans plus a per-row bit-width.
int kv_dequant_mixed_launch(const void* codes, const void* spans,
                            const void* zeros, const void* bits, void* out,
                            int rows, int width, int group, int out_bf16,
                            void* stream) {
  return launch<true>(codes, spans, zeros, bits, out, rows, width, group,
                      out_bf16, stream);
}

}  // extern "C"
