// Dense-SPF kernels for Hopper (sm_90a): the per-area cold SPF tables of
// the Decision route build.
//
// Replaces the jitted XLA kernels of the JAX package
//   openr_tpu/ops/spf.py:291 dense_spf_distances      (kernel 1 here)
//   openr_tpu/ops/spf.py:331 dense_spf_nexthop_lanes  (kernel 2 here)
// vmapped over areas by openr_tpu/ops/route_select.py:171
// multi_area_spf_tables_dense, and both again over a batch of vantage
// roots by openr_tpu/ops/fleet_tables.py:89 fleet_multi_area_tables_dense
// (and :154, its generation-delta twin)              (kernel 12 here).
//
// Both are fixed points over the dense in-edge matrix [A, V, K]
// (slot (v, k) = k-th directed edge INTO v):
//   1. dist: masked Bellman-Ford, d[v] <- min(d[v], min_k d[in_src]+w),
//      where an overloaded node other than the root does not transit.
//   2. lanes: on-DAG in-edges (d[src] + w == d[v] < BIG) seed the root's
//      out-edge lanes (by in_rank) and propagate first-hop lane sets along
//      the shortest-path DAG, to a fixed point.  Rows of vertices absent
//      from the padded edge list (in_has false) hold int8 -128, exactly as
//      the reference's segment reduction leaves them.
//
// Design: one thread block per area.  The area's distance vector lives in
// dynamic shared memory (V <= 16384 -> at most 64 KB, above the 48 KB
// default, hence cudaFuncSetAttribute), relaxation rounds loop inside the
// kernel and end on a block-wide "changed" vote (__syncthreads_or), so
// there are no host round trips.  Updates are in place (Gauss-Seidel):
// both iterations are monotone with a unique fixed point (integral link
// metrics keep every f32 path sum exact), so in-place updates and racy
// reads of a neighbour's value within a round reach the same tables as the
// reference's synchronous rounds, bit for bit.  The lane table is the
// output buffer in device memory: writes by one thread are visible to the
// block after the barrier that ends each round.
//
// What bounds it: latency, not bytes.  Each round re-reads the [V, K]
// in-edge planes (L2-resident at these sizes) and the loop runs for the
// hop diameter; with A = 1 the whole solve runs on 1 of the card's 132
// SMs.  Spreading one area over several blocks is later work.
//
// Kernel 12 (fleet_spf_dense) runs both fixed points in ONE launch for
// every (vantage root, area) pair, 256 threads per pair.  The lane rounds
// run only over the lanes a seed can reach (1 + the highest rank of a
// root out-edge on the DAG): every other lane of a present vertex is 0
// from the start and never changes, because a propagating edge's source
// is reached and not the root, so its own lanes hold 0 or 1, never -128.
// A root of -1 (the vantage is absent from the area) writes dist BIG and
// lanes 0 over its whole slice without solving: the reference masks the
// slice after the fact (fleet_tables.py:130-131), so 0 overwrites the
// -128 fill there.  A block's state (distances and edge classes, 4V + V*K
// bytes) lives in its own slice of a global scratch, and a fixed grid of
// resident blocks walks the pairs in a grid-stride loop, so the scratch
// scales with the grid and not with B * A, and no shape is refused for
// its state (a 64-pod fat-tree, V = 4,096, K = 64, needs 278,528 bytes a
// block, more than shared memory holds).  The state is block-private and
// read back after the barriers that already order it; it and the in-edge
// planes every pair of an area shares (3.4 MB for that fat-tree) stay in
// L1/L2.  Keeping the state in shared memory where it fits was measured
// and dropped: 4.94 against 3.98 ms at the 1,024-root fleet (the carve-out
// leaves less L1 for the planes and fewer blocks resident), 0.0123
// against 0.0138 ms on a 3-area world of 33 roots (an H100; PERF.md).
//
// Traps: BIG + BIG overflows to +inf in f32, and padding slots carry
// w = +inf.  min/compare must treat inf exactly, so this file is never
// built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool can_transit(const uint8_t* ovl, int s,
                                            int root) {
  return !ovl[s] || s == root;
}

__global__ void __launch_bounds__(kThreads)
    dense_spf_distances_kernel(const int32_t* __restrict__ in_src,
                               const float* __restrict__ in_w,
                               const uint8_t* __restrict__ in_ok,
                               const uint8_t* __restrict__ overloaded,
                               const int32_t* __restrict__ roots,
                               float* __restrict__ dist_out, int V, int K,
                               float big) {
  extern __shared__ float d[];  // [V] this area's distances
  const int a = blockIdx.x;
  const int root = roots[a];
  const size_t plane = (size_t)a * V * K;
  const int32_t* src = in_src + plane;
  const float* w = in_w + plane;
  const uint8_t* ok = in_ok + plane;
  const uint8_t* ovl = overloaded + (size_t)a * V;

  for (int v = threadIdx.x; v < V; v += blockDim.x) d[v] = v == root ? 0.f : big;
  __syncthreads();
  // the reference stops after at most V rounds; a shortest path has at
  // most V - 1 edges, so the fixed point is always reached first
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const float cur = d[v];
      float best = cur;
      const size_t row = (size_t)v * K;
      for (int k = 0; k < K; ++k) {
        const int s = src[row + k];
        const bool usable = ok[row + k] && can_transit(ovl, s, root);
        best = fminf(best, d[s] + (usable ? w[row + k] : big));
      }
      if (best < cur) {
        d[v] = best;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int v = threadIdx.x; v < V; v += blockDim.x) dist_out[(size_t)a * V + v] = d[v];
}

// edge classes in the scratch plane
constexpr uint8_t kOffDag = 0;
constexpr uint8_t kSeed = 1;       // on-DAG edge out of the root
constexpr uint8_t kPropagate = 2;  // on-DAG edge out of any other node

__global__ void __launch_bounds__(kThreads)
    dense_spf_nexthop_lanes_kernel(
        const int32_t* __restrict__ in_src, const float* __restrict__ in_w,
        const uint8_t* __restrict__ in_ok, const int32_t* __restrict__ in_rank,
        const uint8_t* __restrict__ in_has,
        const uint8_t* __restrict__ overloaded,
        const int32_t* __restrict__ roots, const float* __restrict__ dist,
        uint8_t* __restrict__ edge_class, int8_t* nh, int V, int K, int D,
        float big) {
  extern __shared__ float d[];  // [V] this area's distances
  const int a = blockIdx.x;
  const int root = roots[a];
  const size_t plane = (size_t)a * V * K;
  const int32_t* src = in_src + plane;
  const float* w = in_w + plane;
  const uint8_t* ok = in_ok + plane;
  const int32_t* rank = in_rank + plane;
  const uint8_t* has = in_has + (size_t)a * V;
  const uint8_t* ovl = overloaded + (size_t)a * V;
  uint8_t* cls = edge_class + plane;
  int8_t* lanes = nh + (size_t)a * V * D;

  for (int v = threadIdx.x; v < V; v += blockDim.x) d[v] = dist[(size_t)a * V + v];
  __syncthreads();
  const int VK = V * K;
  for (int e = threadIdx.x; e < VK; e += blockDim.x) {
    const int v = e / K;
    const int s = src[e];
    const bool usable = ok[e] && can_transit(ovl, s, root);
    const float dv = d[v];
    const bool on_dag = usable && (d[s] + w[e] == dv) && (dv < big);
    cls[e] = on_dag ? (s == root ? kSeed : kPropagate) : kOffDag;
  }
  __syncthreads();
  const int VD = V * D;
  for (int i = threadIdx.x; i < VD; i += blockDim.x) {
    const int v = i / D;
    const int l = i - v * D;
    int8_t x = -128;
    if (has[v]) {
      x = 0;
      for (int k = 0; k < K; ++k) {
        const size_t e = (size_t)v * K + k;
        if (cls[e] == kSeed && rank[e] == l) x = 1;
      }
    }
    lanes[i] = x;
  }
  __syncthreads();
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < VD; i += blockDim.x) {
      const int v = i / D;
      if (!has[v]) continue;
      const int l = i - v * D;
      // contrib = max_k (propagating edge ? lanes[src][l] : 0), the
      // reference's int8 max(nh[in_src] * prop)
      int contrib = -128;
      for (int k = 0; k < K; ++k) {
        const size_t e = (size_t)v * K + k;
        const int x = cls[e] == kPropagate ? (int)lanes[(size_t)src[e] * D + l] : 0;
        contrib = x > contrib ? x : contrib;
      }
      const int cur = lanes[i];
      if (contrib > cur) {
        lanes[i] = (int8_t)contrib;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

constexpr int kBatchThreads = 256;

// Kernel 12's work on one (row, area) pair r = batch row * A + area, with
// the block's state at d ([V] distances) and cls ([V, K] edge classes).
__device__ __forceinline__ void fleet_pair(
    float* d, uint8_t* cls, int& lanes_used, int r,
    const int32_t* __restrict__ in_src, const float* __restrict__ in_w,
    const uint8_t* __restrict__ in_ok, const int32_t* __restrict__ in_rank,
    const uint8_t* __restrict__ in_has,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, float* __restrict__ dist_out,
    int8_t* nh, int A, int V, int K, int D, float big) {
  const int VD = V * D;
  const int a = r % A;  // r = batch row * A + area
  const int root = roots[r];
  float* dist = dist_out + (size_t)r * V;
  int8_t* lanes = nh + (size_t)r * V * D;
  if (root < 0) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = big;
    for (int i = threadIdx.x; i < VD; i += blockDim.x) lanes[i] = 0;
    return;
  }
  const size_t plane = (size_t)a * V * K;
  const int32_t* src = in_src + plane;
  const float* w = in_w + plane;
  const uint8_t* ok = in_ok + plane;
  const int32_t* rank = in_rank + plane;
  const uint8_t* has = in_has + (size_t)a * V;
  const uint8_t* ovl = overloaded + (size_t)a * V;

  // 1. distances: kernel 1's in-place rounds
  for (int v = threadIdx.x; v < V; v += blockDim.x) d[v] = v == root ? 0.f : big;
  if (threadIdx.x == 0) lanes_used = 0;
  __syncthreads();
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const float cur = d[v];
      float best = cur;
      const size_t row = (size_t)v * K;
      for (int k = 0; k < K; ++k) {
        const int s = src[row + k];
        const bool usable = ok[row + k] && can_transit(ovl, s, root);
        best = fminf(best, d[s] + (usable ? w[row + k] : big));
      }
      if (best < cur) {
        d[v] = best;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = d[v];

  // 2. edge classes, and the lanes a seed can reach
  const int VK = V * K;
  for (int e = threadIdx.x; e < VK; e += blockDim.x) {
    const int v = e / K;
    const int s = src[e];
    const bool usable = ok[e] && can_transit(ovl, s, root);
    const float dv = d[v];
    const bool on_dag = usable && (d[s] + w[e] == dv) && (dv < big);
    cls[e] = on_dag ? (s == root ? kSeed : kPropagate) : kOffDag;
    if (on_dag && s == root) atomicMax(&lanes_used, rank[e] + 1);
  }
  __syncthreads();
  const int L = lanes_used < D ? lanes_used : D;
  for (int i = threadIdx.x; i < VD; i += blockDim.x) {
    const int v = i / D;
    const int l = i - v * D;
    int8_t x = -128;
    if (has[v]) {
      x = 0;
      for (int k = 0; l < L && k < K; ++k) {
        const size_t e = (size_t)v * K + k;
        if (cls[e] == kSeed && rank[e] == l) x = 1;
      }
    }
    lanes[i] = x;
  }
  __syncthreads();

  // 3. OR-propagation over the live lanes: kernel 2's in-place rounds
  const int VL = V * L;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < VL; i += blockDim.x) {
      const int v = i / L;
      if (!has[v]) continue;
      const int l = i - v * L;
      int contrib = -128;
      for (int k = 0; k < K; ++k) {
        const size_t e = (size_t)v * K + k;
        const int x = cls[e] == kPropagate ? (int)lanes[(size_t)src[e] * D + l] : 0;
        contrib = x > contrib ? x : contrib;
      }
      const size_t at = (size_t)v * D + l;
      if (contrib > lanes[at]) {
        lanes[at] = (int8_t)contrib;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// Kernel 12 over rows = B * A pairs: block b keeps its state in its slice
// of `scratch` (state_floats each) and walks pairs b, b + grid, ...
__global__ void __launch_bounds__(kBatchThreads) fleet_spf_dense_kernel(
    const int32_t* __restrict__ in_src, const float* __restrict__ in_w,
    const uint8_t* __restrict__ in_ok, const int32_t* __restrict__ in_rank,
    const uint8_t* __restrict__ in_has,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, float* __restrict__ dist_out,
    int8_t* nh, float* scratch, size_t state_floats, int rows, int A, int V,
    int K, int D, float big) {
  __shared__ int lanes_used;
  float* d = scratch + blockIdx.x * state_floats;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    fleet_pair(d, reinterpret_cast<uint8_t*>(d + V), lanes_used, r, in_src,
               in_w, in_ok, in_rank, in_has, overloaded, roots, dist_out, nh,
               A, V, K, D, big);
    // the next pair rewrites the state this one's threads may still read
    __syncthreads();
  }
}

}  // namespace

extern "C" int openr_dense_spf_distances(const void* in_src, const void* in_w,
                                         const void* in_ok,
                                         const void* overloaded,
                                         const void* roots, void* dist, int A,
                                         int V, int K, float big,
                                         void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_spf_distances_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_spf_distances_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in_src, (const float*)in_w, (const uint8_t*)in_ok,
      (const uint8_t*)overloaded, (const int32_t*)roots, (float*)dist, V, K,
      big);
  return (int)cudaGetLastError();
}

extern "C" int openr_dense_spf_nexthop_lanes(
    const void* in_src, const void* in_w, const void* in_ok,
    const void* in_rank, const void* in_has, const void* overloaded,
    const void* roots, const void* dist, void* edge_class, void* nh, int A,
    int V, int K, int D, float big, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_spf_nexthop_lanes_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_spf_nexthop_lanes_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in_src, (const float*)in_w, (const uint8_t*)in_ok,
      (const int32_t*)in_rank, (const uint8_t*)in_has,
      (const uint8_t*)overloaded, (const int32_t*)roots, (const float*)dist,
      (uint8_t*)edge_class, (int8_t*)nh, V, K, D, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_fleet_spf_dense(const void* in_src, const void* in_w,
                                     const void* in_ok, const void* in_rank,
                                     const void* in_has,
                                     const void* overloaded,
                                     const void* roots, void* dist, void* nh,
                                     void* scratch, int grid, int B, int A,
                                     int V, int K, int D, float big,
                                     void* stream) {
  if (B == 0 || A == 0) return (int)cudaSuccess;
  // grid slices of scratch, each rounded up to whole 16-byte words
  const size_t state = (size_t)V * sizeof(float) + (size_t)V * K;
  const size_t state_floats = (state + 15) / 16 * 4;
  fleet_spf_dense_kernel<<<grid, kBatchThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in_src, (const float*)in_w, (const uint8_t*)in_ok,
      (const int32_t*)in_rank, (const uint8_t*)in_has,
      (const uint8_t*)overloaded, (const int32_t*)roots, (float*)dist,
      (int8_t*)nh, (float*)scratch, state_floats, B * A, A, V, K, D, big);
  return (int)cudaGetLastError();
}
