// Routed experts of a decode-sized MoE step for Hopper (sm_90a): the
// router, the top k, the k routed experts and their ordered combine in
// three launches, for a few tokens at a time.
//
// Replaces no Pallas kernel: the reference's MoE is XLA's (its
// moe_block_local, a sort-based dispatch with capacity). The port's eager
// form of it (models/layers.py::moe_block_local) runs the prefill's
// dispatch for one token: a softmax, a stable sort, counts, a cumsum, an
// argsort, an index_put into an (e, cap + 1, d) zero buffer, three bmm
// over every expert, gathers, an inverse permutation and k gather-and-add
// pairs. That is about 60 launches a layer, several of them
// advanced-indexing ops with a heavy host cost, and the bmm read every
// expert's weights where only k are routed. This kernel computes the same
// function for t tokens when no assignment can be dropped (t at most the
// capacity, t * k at most e; the caller checks both).
//
// What bounds it: bytes. A token reads k experts' gate, up and down rows,
// k * 3 * d * f elements, plus the router, d * e: 188.7 MB a layer at
// Granite-4.0-H's widths (4096 wide, experts of 768, top 10 of 72), 56 us
// at 3.35 TB/s; each weight is used for one multiply-add a token, far under
// the ~295 FLOP a byte at which the tensor cores would matter.
//
// What the design does about it:
// - Every weight row is read in 128-byte pieces (a tile of 8 16-byte
//   vectors), so each DRAM page a block opens gives it whole lines, and
//   the parallelism a one-token step lacks comes from thread block
//   clusters that split the sums and meet in distributed shared memory:
//   no atomics, no scratch in device memory between the parts of a sum,
//   and a fixed order of adds, so every run gives the same bits. (Tiles of
//   32 or 64 bytes, which gave a one-token step a block an SM without
//   clusters, read the same bytes 1.3-1.6x slower.)
// - router_kernel, a cluster of 8 blocks of 1024 threads a token: each
//   block sums its eighth of the rows of x . router in fp32 from 16-byte
//   loads; block 0 adds the eight partial logits in order, rounds them to
//   the parameters' dtype (as the eager matmul rounds them), takes an fp32
//   softmax, the top k by a stable order (ties to the lower expert, as the
//   eager stable sort), renormalises the gates with the clamp at 1e-9 and
//   writes the token's picks in ascending expert id, the combine's order.
//   (One block alone read a 590 KB router in 24 us.)
// - gate_up_kernel, a cluster a (f-tile, assignment) of `split` blocks,
//   each over a slice of the d rows: its expert's w_gate and w_up rows (f
//   contiguous in the (e, d, f) layout) stream through a ring of 16-byte
//   cp.async copies, each thread consuming its own copies, into fp32 sums.
//   Block 0 adds the slices' sums in order, rounds gate and up to the
//   dtype (the bmm's output), computes the activation in fp32 on the
//   rounded gate and rounds it, and rounds the product: the eager path's
//   rounding points.
// - down_kernel, a cluster of the token's k experts a d-tile: block j
//   streams expert j's w_down rows (d contiguous in (e, f, d)) through the
//   same kind of ring and rounds its fp32 sum to the dtype; block 0 then
//   multiplies each expert's output by its fp32 gate and adds it into an
//   fp32 sum, one expert after the other in ascending id, as the eager
//   combine does, and writes y in the dtype. The first cluster's block 0
//   also computes the Switch aux loss from the router's probabilities and
//   picks.
// - The second and third launches are programmatic dependent launches:
//   they start while the one before runs and wait for its memory before
//   they read it, so the three launches' latencies overlap.
//
// Plain C interface for ctypes. The launcher returns the first CUDA error
// it meets; it allocates nothing (the wrapper hands it y, aux and a
// workspace of probabilities, picks, gates and h).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using sm90::bf16;
using sm90::f16;
using sm90::from_f32;
using sm90::to_f32;

constexpr int kRouterThreads = 1024;
constexpr int kRouterCluster = 8;  // blocks a token's router
constexpr int kThreads = 256;      // the expert kernels' blocks
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;          // 16-byte vectors a tile row: 128 bytes
constexpr int kRows = kThreads / kLanes;  // rows a stage
constexpr int kStagesUp = 4;    // gate/up ring: two 16-byte copies a stage
constexpr int kStagesDown = 8;  // down ring: one a stage
constexpr int kMaxK = 16;       // picks a token: the down kernel's cluster
constexpr int kMaxE = 1024;     // experts: one router thread each
constexpr int kMaxSplit = 8;    // gate/up cluster

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 16 bytes of T to fp32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&out)[16 / sizeof(T)]) {
  const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) out[i] = to_f32(p[i]);
}

// the activation in fp32, as PyTorch computes it on the card: silu, or
// gelu with the tanh approximation
__device__ __forceinline__ float activate(float x, int kind) {
  if (kind == 0) return x / (1.0f + expf(-x));
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// sum (max where `is_max`) of v over the block; every thread gets it.
// `red` holds a value a warp.
__device__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < n_warps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Grid (kRouterCluster, t), clusters of (kRouterCluster, 1, 1): block q of
// token t sums rows [q * chunk, (q + 1) * chunk) of x . router. Shared
// memory: the slice of x in fp32 (chunk), the GEMV's row partials (rows x
// e), the block's partial logits (e), then, in block 0, the probabilities
// (e) and the ranks (e).
template <typename T>
__global__ void __launch_bounds__(kRouterThreads)
    router_kernel(const T* __restrict__ x, const T* __restrict__ w, int d,
                  int e, int k, float* __restrict__ probs,
                  int* __restrict__ ids, float* __restrict__ gates) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  __shared__ float red[kRouterThreads / 32];
  __shared__ int sel[kMaxK];
  __shared__ float total;
  sm90::grid_dep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x, tok = blockIdx.y, tid = threadIdx.x;
  const int chunk = (d + kRouterCluster - 1) / kRouterCluster;
  const int r0 = q * chunk, n_rows = max(0, min(d - r0, chunk));
  const int nv = e / V, rows = kRouterThreads / nv;
  float* xs = reinterpret_cast<float*>(smem4);
  float* part = xs + ((chunk + 3) & ~3);
  float* mine = part + rows * e;
  float* p = mine + e;
  int* rank = reinterpret_cast<int*>(p + e);

  for (int i = tid; i < n_rows; i += kRouterThreads)
    xs[i] = to_f32(x[(size_t)tok * d + r0 + i]);
  __syncthreads();
  // thread (r, c) sums rows r, r + rows, ... of the slice, column vector c
  const int c = tid % nv, r = tid / nv;
  if (r < rows) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    const uint4* wv = reinterpret_cast<const uint4*>(w) + (size_t)r0 * nv + c;
    int i = r;
    for (; i + 3 * rows < n_rows; i += 4 * rows) {
      uint4 u[4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        u[s] = __ldg(wv + (size_t)(i + s * rows) * nv);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float fw[V];
        unpack<T>(u[s], fw);
        const float xv = xs[i + s * rows];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(xv, fw[v], acc[v]);
      }
    }
    for (; i < n_rows; i += rows) {
      float fw[V];
      unpack<T>(__ldg(wv + (size_t)i * nv), fw);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(xs[i], fw[v], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) part[r * e + c * V + v] = acc[v];
  }
  __syncthreads();
  if (tid < e) {  // the block's partial logits
    const int used = min(rows, n_rows);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int i = 0;
    for (; i + 3 < used; i += 4) {
      s0 += part[i * e + tid];
      s1 += part[(i + 1) * e + tid];
      s2 += part[(i + 2) * e + tid];
      s3 += part[(i + 3) * e + tid];
    }
    for (; i < used; ++i) s0 += part[i * e + tid];
    mine[tid] = (s0 + s1) + (s2 + s3);
  }
  cluster.sync();
  if (q == 0) {
    // the logits, the blocks' partials added in order and rounded to the
    // dtype as the eager matmul's output is
    float logit = -INFINITY;
    if (tid < e) {
      float s = 0.0f;
      for (int b = 0; b < kRouterCluster; ++b)
        s += cluster.map_shared_rank(mine, b)[tid];
      logit = round_to<T>(s);
    }
    // fp32 softmax
    const float mx = block_reduce(logit, true, red);
    const float ex = tid < e ? expf(logit - mx) : 0.0f;
    const float sum = block_reduce(ex, false, red);
    const float pj = ex / sum;
    if (tid < e) p[tid] = pj;
    __syncthreads();
    // the top k by a stable order: ties to the lower expert
    if (tid < e) {
      int rk = 0;
      for (int i = 0; i < e; ++i) {
        const float pi = p[i];
        rk += (pi > pj) || (pi == pj && i < tid);
      }
      rank[tid] = rk;
      if (rk < k) sel[rk] = tid;
      probs[(size_t)tok * e + tid] = pj;
    }
    __syncthreads();
    if (tid == 0) {  // the picks' sum in the sorted order
      float s = 0.0f;
      for (int i = 0; i < k; ++i) s += p[sel[i]];
      total = fmaxf(s, 1e-9f);
    }
    __syncthreads();
    if (tid < e && rank[tid] < k) {  // written in ascending expert id
      int pos = 0;
      for (int i = 0; i < tid; ++i) pos += rank[i] < k;
      ids[tok * k + pos] = tid;
      gates[tok * k + pos] = pj / total;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its partials
}

// Sum of the fp32 vectors acc of the threads that share a column vector
// (tid % kLanes), one sum a warp left in red[warp][kLanes * V].
template <int V>
__device__ __forceinline__ void warp_rows(float (&acc)[V], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  if (lane < kLanes)
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[warp * kLanes * V + lane * V + v] = acc[v];
}

// the warps' sums of column i of the tile, in order
__device__ __forceinline__ float warps_sum(const float* red, int width,
                                           int i) {
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s += red[w * width + i];
  return s;
}

// Grid (split, f-tiles, t * k), clusters of (split, 1, 1): block s sums
// rows [s * chunk, (s + 1) * chunk) of x . w_gate[ex] and x . w_up[ex] over
// the tile's columns; block 0 adds the slices and writes h = act(gate) *
// up, rounded as the eager path rounds. Shared memory: the ring
// [kStagesUp][2][kThreads] of 16-byte copies, then the slice of x in fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wu, const int* __restrict__ ids,
                   int d, int f, int k, int act, T* __restrict__ h) {
  constexpr int V = 16 / sizeof(T), W = kLanes * V, S = kStagesUp;
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kWarps * W];
  __shared__ float mine[2][W];
  sm90::grid_dep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* xs = reinterpret_cast<float*>(ring + S * 2 * kThreads);
  const int s_id = blockIdx.x, split = gridDim.x;
  const int tile = blockIdx.y, a = blockIdx.z, tok = a / k;
  const int tid = threadIdx.x, r = tid / kLanes;
  const int chunk = (d + split - 1) / split;
  const int r0 = s_id * chunk, n_rows = max(0, min(d - r0, chunk));
  const int col = tile * W + (tid % kLanes) * V;
  const bool ok_col = col < f;
  for (int i = tid; i < n_rows; i += kThreads)
    xs[i] = to_f32(x[(size_t)tok * d + r0 + i]);  // an input: no wait
  sm90::grid_dep_wait();                          // the router's picks
  const int ex = ids[a];
  const T* g0 = wg + ((size_t)ex * d + r0) * f + col;
  const T* u0 = wu + ((size_t)ex * d + r0) * f + col;
  const int n_st = (n_rows + kRows - 1) / kRows;
  auto issue = [&](int s) {
    if (s < n_st) {
      const int row = s * kRows + r;
      const bool ok = ok_col && row < n_rows;
      uint4* slot = ring + (s % S) * 2 * kThreads + tid;
      sm90::cp_async16(slot, ok ? (const void*)(g0 + (size_t)row * f)
                                : (const void*)wg, ok);
      sm90::cp_async16(slot + kThreads,
                       ok ? (const void*)(u0 + (size_t)row * f)
                          : (const void*)wu, ok);
    }
    sm90::cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  __syncthreads();  // xs
  float ag[V], au[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ag[v] = au[v] = 0.0f;
  for (int s = 0; s < n_st; ++s) {
    sm90::cp_async_wait<S - 2>();  // this thread's copies of stage s
    const uint4* slot = ring + (s % S) * 2 * kThreads + tid;
    const uint4 vg = slot[0], vu = slot[kThreads];
    asm volatile("" ::: "memory");  // read before the slot is refilled
    issue(s + S - 1);
    const int row = s * kRows + r;
    if (row < n_rows) {
      const float xv = xs[row];
      float fg[V], fu[V];
      unpack<T>(vg, fg);
      unpack<T>(vu, fu);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ag[v] = fmaf(xv, fg[v], ag[v]);
        au[v] = fmaf(xv, fu[v], au[v]);
      }
    }
  }
  sm90::cp_async_wait<0>();
  warp_rows<V>(ag, red[0]);
  warp_rows<V>(au, red[1]);
  __syncthreads();
  if (tid < W) {
    mine[0][tid] = warps_sum(red[0], W, tid);
    mine[1][tid] = warps_sum(red[1], W, tid);
  }
  cluster.sync();
  const int cc = tile * W + tid;
  if (s_id == 0 && tid < W && cc < f) {
    float sg = 0.0f, su = 0.0f;
    for (int b = 0; b < split; ++b) {
      const float* m = cluster.map_shared_rank(&mine[0][0], b);
      sg += m[tid];
      su += m[W + tid];
    }
    const float g = round_to<T>(sg), u = round_to<T>(su);
    const float av = round_to<T>(activate(g, act));
    h[(size_t)a * f + cc] = from_f32<T>(av * u);
  }
  cluster.sync();  // no block leaves while block 0 reads its sums
}

// The Switch aux loss, e * sum_j mean_t(probs[:, j]) * count_j / (t * k),
// by one block.
__device__ void aux_loss(const float* __restrict__ probs,
                         const int* __restrict__ ids, int t, int e, int k,
                         float* red, float* __restrict__ aux) {
  float part = 0.0f;
  for (int j = threadIdx.x; j < e; j += blockDim.x) {
    float m = 0.0f;
    for (int i = 0; i < t; ++i) m += probs[(size_t)i * e + j];
    int cnt = 0;
    for (int i = 0; i < t * k; ++i) cnt += ids[i] == j;
    part += (m / (float)t) * ((float)cnt / (float)(t * k));
  }
  const float s = block_reduce(part, false, red);
  if (threadIdx.x == 0) aux[0] = (float)e * s;
}

// Grid (k, d-tiles, t), clusters of (k, 1, 1): block j computes expert j's
// output over the tile's columns, round(h[j] . w_down[ex_j]); block 0 adds
// gate_j times each in ascending j into an fp32 sum and writes y. Shared
// memory: the ring [kStagesDown][kThreads] of 16-byte copies, then h[j] in
// fp32 (f).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    down_kernel(const T* __restrict__ h, const T* __restrict__ wd,
                const int* __restrict__ ids, const float* __restrict__ gates,
                const float* __restrict__ probs, int t, int d, int f, int e,
                int k, T* __restrict__ y, float* __restrict__ aux) {
  constexpr int V = 16 / sizeof(T), W = kLanes * V, S = kStagesDown;
  extern __shared__ float4 smem4[];
  __shared__ float red[kWarps * W];
  __shared__ float mine[W];
  cg::cluster_group cluster = cg::this_cluster();
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* hs = reinterpret_cast<float*>(ring + S * kThreads);
  const int j = blockIdx.x, tile = blockIdx.y, tok = blockIdx.z;
  const int tid = threadIdx.x, r = tid / kLanes;
  const int col = tile * W + (tid % kLanes) * V;
  const bool ok_col = col < d;
  sm90::grid_dep_wait();  // h, and through it the router's picks
  const int a = tok * k + j;
  for (int i = tid; i < f; i += kThreads)
    hs[i] = to_f32(h[(size_t)a * f + i]);
  const T* w0 = wd + (size_t)ids[a] * f * d + col;
  const int n_st = (f + kRows - 1) / kRows;
  auto issue = [&](int s) {
    if (s < n_st) {
      const int row = s * kRows + r;
      const bool ok = ok_col && row < f;
      sm90::cp_async16(ring + (s % S) * kThreads + tid,
                       ok ? (const void*)(w0 + (size_t)row * d)
                          : (const void*)wd, ok);
    }
    sm90::cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  __syncthreads();  // hs
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  for (int s = 0; s < n_st; ++s) {
    sm90::cp_async_wait<S - 2>();
    const uint4 vw = ring[(s % S) * kThreads + tid];
    asm volatile("" ::: "memory");
    issue(s + S - 1);
    const int row = s * kRows + r;
    if (row < f) {
      const float hv = hs[row];
      float fw[V];
      unpack<T>(vw, fw);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(hv, fw[v], acc[v]);
    }
  }
  sm90::cp_async_wait<0>();
  warp_rows<V>(acc, red);
  __syncthreads();
  if (tid < W) mine[tid] = round_to<T>(warps_sum(red, W, tid));
  cluster.sync();
  const int cc = tile * W + tid;
  if (j == 0 && tid < W && cc < d) {
    float ysum = 0.0f;
    for (int b = 0; b < k; ++b)
      ysum = __fadd_rn(ysum, __fmul_rn(cluster.map_shared_rank(mine, b)[tid],
                                       gates[tok * k + b]));
    y[(size_t)tok * d + cc] = from_f32<T>(ysum);
  }
  cluster.sync();  // no block leaves while block 0 reads its output
  if (j == 0 && tile == 0 && tok == 0) aux_loss(probs, ids, t, e, k, red, aux);
}

// The most dynamic shared memory a kernel may ask for beside its static
// shared memory, and clusters past 8 blocks; set once a kernel.
template <typename K>
cudaError_t configure(K kern, bool& configured) {
  if (configured) return cudaSuccess;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024 - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) configured = true;
  return err;
}

// Launch `kern` on `grid` in clusters of (cluster_x, 1, 1), as a
// programmatic dependent launch where `pdl`.
template <typename K, typename... Args>
cudaError_t launch(K kern, dim3 grid, int threads, int cluster_x,
                   size_t smem, bool pdl, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_all(const void* x, const void* router, const void* wg,
               const void* wu, const void* wd, void* y, void* aux,
               void* probs, void* ids, void* gates, void* h, int t, int d,
               int f, int e, int k, int act, int split, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T), W = kLanes * V;
  static bool conf_r = false, conf_u = false, conf_d = false;
  auto kr = router_kernel<T>;
  auto ku = gate_up_kernel<T>;
  auto kd = down_kernel<T>;
  cudaError_t err = configure(kr, conf_r);
  if (err == cudaSuccess) err = configure(ku, conf_u);
  if (err == cudaSuccess) err = configure(kd, conf_d);
  if (err != cudaSuccess) return (int)err;
  const int chunk_r = (d + kRouterCluster - 1) / kRouterCluster;
  const int rows = kRouterThreads / (e / V);
  const size_t smem_r = sizeof(float) * ((size_t)((chunk_r + 3) & ~3) +
                                         (size_t)rows * e + 3 * (size_t)e);
  err = launch(kr, dim3(kRouterCluster, t), kRouterThreads, kRouterCluster,
               smem_r, false, stream, static_cast<const T*>(x),
               static_cast<const T*>(router), d, e, k,
               static_cast<float*>(probs), static_cast<int*>(ids),
               static_cast<float*>(gates));
  if (err != cudaSuccess) return (int)err;
  const size_t smem_u = (size_t)kStagesUp * 2 * kThreads * 16 +
                        sizeof(float) * (size_t)((d + split - 1) / split);
  err = launch(ku, dim3(split, (f + W - 1) / W, t * k), kThreads, split,
               smem_u, true, stream, static_cast<const T*>(x),
               static_cast<const T*>(wg), static_cast<const T*>(wu),
               static_cast<const int*>(ids), d, f, k, act,
               static_cast<T*>(h));
  if (err != cudaSuccess) return (int)err;
  const size_t smem_d =
      (size_t)kStagesDown * kThreads * 16 + sizeof(float) * (size_t)f;
  err = launch(kd, dim3(k, (d + W - 1) / W, t), kThreads, k, smem_d, true,
               stream, static_cast<const T*>(h), static_cast<const T*>(wd),
               static_cast<const int*>(ids), static_cast<const float*>(gates),
               static_cast<const float*>(probs), t, d, f, e, k,
               static_cast<T*>(y), static_cast<float*>(aux));
  return (int)err;
}

}  // namespace

extern "C" {

// t tokens x (t, d) through the router (d, e), the top k and the routed
// experts w_gate, w_up (e, d, f) and w_down (e, f, d), all of one dtype
// (0 fp32, 1 bf16, 2 fp16): y (t, d) in that dtype and the aux loss (one
// fp32). probs (t, e) fp32, ids (t, k) int32, gates (t, k) fp32 and h
// (t * k, f) in the dtype are the workspace. act: 0 silu, 1 gelu (tanh).
// split: the gate/up kernel's blocks a sum, 1 to 8. The caller checks the
// shapes (kernel.py::_check).
int moe_decode_launch(const void* x, const void* router, const void* wg,
                      const void* wu, const void* wd, void* y, void* aux,
                      void* probs, void* ids, void* gates, void* h, int t,
                      int d, int f, int e, int k, int act, int split,
                      int dtype, void* stream) {
  if (t < 1 || k < 1 || k > kMaxK || e < k || e > kMaxE || split < 1 ||
      split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_all<float>(x, router, wg, wu, wd, y, aux, probs,
                                     ids, gates, h, t, d, f, e, k, act,
                                     split, s);
    case 1: return launch_all<bf16>(x, router, wg, wu, wd, y, aux, probs,
                                    ids, gates, h, t, d, f, e, k, act, split,
                                    s);
    case 2: return launch_all<f16>(x, router, wg, wu, wd, y, aux, probs, ids,
                                   gates, h, t, d, f, e, k, act, split, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
