// Huffman decode of streamed KV chunks for Hopper (sm_90a): one launch a
// streamed chunk decodes its K and V tensors to their quantization codes.
//
// Replaces no Pallas kernel: the reference decodes on the host
// (repro/compression/huffman.py::decode, a numpy loop that steps a chunk
// tensor's interleaved streams in lockstep, about ten numpy operations a
// symbol), and the port keeps a verbatim copy of it for the CPU. On the
// card this kernel decodes the same bitstream to the same codes.
//
// What bounds it: each stream's serial chain, not bytes. A Qwen3-4B chunk
// tensor is 1,048,576 five-bit codes in 64 streams: about 0.6 MB of
// bitstream in and 1 MB of codes out, well under a microsecond at the
// H100's 3.35 TB/s. But a stream's next code starts where the last one
// ended, so its 16,384 symbols are 16,384 dependent table reads, and the
// format fixes the parallelism at the stream count (64 a tensor).
//
// What the design does about it:
// - One block a tensor, one thread a stream (threads past the stream count
//   only help build the table). The block builds its canonical decode
//   table in shared memory from the code lengths alone: a 2^16-entry
//   uint16 table indexed by the next 16 bits (symbol | length << 8), 128
//   KB of dynamic shared memory, so each symbol is one shared-memory read
//   on the chain. The alphabet is at most 256 symbols (uint8 codes) and
//   codes at most MAX_LEN = 16 bits.
// - Canonical codes laid out left-justified in 16 bits are contiguous in
//   (length, symbol) order, so a symbol's first table entry is the sum of
//   2^(16 - length) over the symbols before it in that order, and each
//   entry belongs to the last symbol that starts at or before it; entries
//   past the last code are 0 (symbol 0, length 0), as the reference's
//   table leaves them.
// - A thread keeps a 64-bit bit buffer in registers, left-aligned, with
//   more than 32 valid bits after each refill, so two symbols decode
//   between refills. Its stream row reaches shared memory by cp.async, a
//   128-byte line at a time, into a ring of two lines a thread: the next
//   line is in flight while the thread reads the current one, and no
//   register waits for it. (A register queue of 16-byte loads put the
//   load's latency back on the chain: the compiler moved each loaded
//   vector into the queue right after the load; direct loads from L1
//   with a prefetch a line ahead were slower still.)
// - Symbols leave as 32-bit stores of four codes wherever the output is
//   4-byte aligned (bytes at a segment's ragged ends). A stream's segment
//   starts at the prefix sum of the symbol counts before it (the host
//   computes the sums), so the output is the reference decoder's flat
//   order. Padding symbols past a stream's count are never written.
//
// Input: one buffer the host packs and copies to the card in one piece.
// At its start, an int64 row per tensor (kCols columns): the byte offset
// of its first stream row, the row stride in bytes (whole 128-byte lines,
// the last one zeros), the stream count, the byte offset of its code
// lengths (uint8, one a symbol), the alphabet size, the byte offset of
// its (segment start, symbol count) int64 pair a stream, and the byte
// offset of its codes in the output. Every offset is a multiple of 16.
//
// Plain C interface for ctypes. The launcher returns the first CUDA error
// it meets, cudaGetLastError() after the launch; it allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 16;
constexpr int kTable = 1 << kMaxLen;
constexpr int kMaxAlphabet = 256;
static_assert(kMaxAlphabet == kThreads, "one symbol a thread");

// Columns of a tensor's row (int64).
constexpr int kStreams = 0, kStride = 1, kNStreams = 2, kLens = 3,
              kNAlpha = 4, kSegs = 5, kOut = 6, kCols = 7;

// Dynamic shared memory: the table, then each coded symbol's first entry
// and packed entry in (length, symbol) order, the code lengths, and each
// thread's ring of two row lines.
constexpr int kStartOff = kTable * 2;
constexpr int kEntryOff = kStartOff + kMaxAlphabet * 4;
constexpr int kLensOff = kEntryOff + kMaxAlphabet * 2;
constexpr int kRingOff = kLensOff + kMaxAlphabet;
constexpr int kLine = 128;                  // bytes of a row a fetch brings
constexpr int kLineWords = kLine / 4;
constexpr int kSmem = kRingOff + kThreads * 2 * kLine;

// A stream's bits, most significant first: the next bits are the top of
// `buf`, of which `bits` are valid. The row reaches shared memory a line
// at a time by cp.async, into a ring of two lines a thread: while the
// thread reads one, the next is on its way, and no register waits for
// it. A line past the row reads its last line, zeros (the host pads each
// row to whole lines and one more), as the reference pads it.
struct BitReader {
  const uint8_t* row;
  int64_t last;        // the row's last line (bytes from its start)
  uint32_t ring;       // the thread's two lines (shared-memory address)
  const uint32_t* words;  // the same, as words
  int next;            // the next word of the row
  uint64_t buf;
  int bits;

  __device__ __forceinline__ BitReader(const uint8_t* r, int64_t stride,
                                       uint32_t* lines)
      : row(r), last(stride - kLine),
        ring((uint32_t)__cvta_generic_to_shared(lines)), words(lines),
        next(0), buf(0), bits(0) {
    fetch(0);
    fetch(1);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    push();
    push();
  }

  // line `line` of the row into its ring slot, as one group
  __device__ __forceinline__ void fetch(int line) {
    const uint32_t dst = ring + (line & 1) * kLine;
    const int64_t at = (int64_t)line * kLine;
    const uint8_t* src = row + (at < last ? at : last);
#pragma unroll
    for (int k = 0; k < kLine; k += 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + k),
                   "l"(src + k));
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // 32 more bits under the valid ones; needs bits <= 32. Past a line's
  // last word, the line after next goes into its slot and the next line
  // must have arrived.
  __device__ __forceinline__ void push() {
    const uint32_t w = words[next & (2 * kLineWords - 1)];
    // the stream's bytes are in order: the word's first byte is its top
    buf |= (uint64_t)__byte_perm(w, 0, 0x0123) << (32 - bits);
    bits += 32;
    if ((++next & (kLineWords - 1)) == 0) {
      fetch(next / kLineWords + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
  }

  // More than 32 valid bits after it: enough for two symbols.
  __device__ __forceinline__ void refill() {
    if (bits <= 32) push();
  }

  __device__ __forceinline__ uint32_t next_symbol(const uint16_t* table) {
    const uint32_t e = table[buf >> (64 - kMaxLen)];
    const int len = e >> 8;
    buf <<= len;
    bits -= len;
    return e & 0xFFu;
  }

  // nothing of the row left in flight into the ring
  __device__ __forceinline__ ~BitReader() {
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
};

__global__ void __launch_bounds__(kThreads, 1)
huffman_decode_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint32_t* start = reinterpret_cast<uint32_t*>(smem + kStartOff);
  uint16_t* entry = reinterpret_cast<uint16_t*>(smem + kEntryOff);
  uint8_t* lens = smem + kLensOff;

  const int64_t* d = reinterpret_cast<const int64_t*>(in) +
                     (int64_t)blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int n_alpha = (int)d[kNAlpha];
  const uint8_t len = tid < n_alpha ? in[d[kLens] + tid] : 0;
  lens[tid] = len;
  __syncthreads();

  // each coded symbol's place in (length, symbol) order and first entry
  if (len) {
    uint32_t first = 0;
    int rank = 0;
    for (int j = 0; j < n_alpha; ++j) {
      const int lj = lens[j];
      if (lj && (lj < len || (lj == len && j < tid))) {
        first += 1u << (kMaxLen - lj);
        ++rank;
      }
    }
    start[rank] = first;
    entry[rank] = (uint16_t)(tid | (len << 8));
  }
  const int n_coded = __syncthreads_count(len != 0);

  // entry w belongs to the last symbol starting at or before it, if its
  // span reaches w; a thread's entries rise, so its symbol only advances
  int i = -1;
  for (int w = tid; w < kTable; w += kThreads) {
    while (i + 1 < n_coded && start[i + 1] <= (uint32_t)w) ++i;
    uint16_t e = 0;
    if (i >= 0 &&
        (uint32_t)w < start[i] + (1u << (kMaxLen - (entry[i] >> 8))))
      e = entry[i];
    table[w] = e;
  }
  __syncthreads();

  const int n_streams = (int)d[kNStreams];
  const int64_t stride = d[kStride];
  const int64_t* segs = reinterpret_cast<const int64_t*>(in + d[kSegs]);
  for (int r = tid; r < n_streams; r += kThreads) {
    BitReader br(in + d[kStreams] + r * stride, stride,
                 reinterpret_cast<uint32_t*>(smem + kRingOff) +
                     tid * 2 * kLineWords);
    uint8_t* p = out + d[kOut] + segs[2 * r];
    const int n = (int)segs[2 * r + 1];
    int k = 0;
    for (; k < n && (reinterpret_cast<uintptr_t>(p) & 3); ++k) {
      br.refill();
      *p++ = (uint8_t)br.next_symbol(table);
    }
    for (; k + 4 <= n; k += 4) {
      br.refill();
      uint32_t word = br.next_symbol(table);
      word |= br.next_symbol(table) << 8;
      br.refill();
      word |= br.next_symbol(table) << 16;
      word |= br.next_symbol(table) << 24;
      *reinterpret_cast<uint32_t*>(p) = word;
      p += 4;
    }
    for (; k < n; ++k) {
      br.refill();
      *p++ = (uint8_t)br.next_symbol(table);
    }
  }
}

}  // namespace

extern "C" {

// Decode n_tensors tensors (one block each) on `stream`: `in` is the
// packed buffer on the card, `out` the codes' buffer.
int huffman_decode_launch(const void* in, void* out, int n_tensors,
                          void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        huffman_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if (n_tensors <= 0) return (int)cudaErrorInvalidValue;
  huffman_decode_kernel<<<n_tensors, kThreads, kSmem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
