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
// Kernel 12 (fleet_spf_dense) solves every (vantage root, area) pair in
// ONE launch, one block per pair at a time, the blocks walking the pairs in
// a grid-stride loop.  It does not sweep the planes: the launcher derives
// once a CSR by source of each area's usable in-edge slots (in_ok; the
// transit rule stays per root), each slot {dst, w} and its in_rank, and the
// block runs the frontier relaxation of frontier.cuh from its root (kernel
// 15's routine).  Then the lanes: the plane is filled (-128 where in_has is
// false, else 0), the root's out-edges on the shortest-path DAG set their
// lanes, every other DAG edge (its source reached, not the root, free to
// transit) is packed as a propagating source of its dst, and kernel 16's OR
// lane loop runs over the vertices with a propagating source and only the
// lanes a seed can reach (1 + the highest rank of a root out-edge on the
// DAG): every other lane of a present vertex is 0 from the fill and never
// changes, because a propagating source is reached and not the root, so
// its own lanes hold 0 or 1, never -128.  A root of -1 (the vantage is
// absent from the area) writes dist BIG and lanes 0 over its whole slice
// without solving: the reference masks the slice after the fact
// (fleet_tables.py:130-131), so 0 overwrites the -128 fill there.  A
// block's state, the frontier state (distances, bitmaps, the listed
// frontier) and the lane lists (the packed sources, sized by the largest
// area's usable edges), lives in shared memory where it leaves room for
// two blocks per SM; else the frontier state stays in shared memory and
// the lists go to the block's slice of a global scratch; past shared
// memory both do, so no shape is refused for its state.  What bounds it:
// latency, the barriers of the frontier's rounds and of the lane rounds
// per pair, not bytes (PERF.md).
//
// Traps: BIG + BIG overflows to +inf in f32, and padding slots carry
// w = +inf.  min/compare must treat inf exactly, so this file is never
// built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier.cuh"

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

// Kernel 12's lane lists: per vertex its propagating sources' count, then
// the cursor of its packing [V], the moving vertices [V], their sources'
// offsets [V + 1] and the packed sources [M] (M: the largest area's usable
// edges).
__host__ __device__ inline size_t fleet_lists_ints(int V, int M) {
  return 3 * (size_t)V + 1 + (size_t)M;
}

// Kernel 12's work on one (row, area) pair r = batch row * A + area, with
// the frontier state f and the lane lists at `lists`.
__device__ __forceinline__ void fleet_pair(
    const Frontier& f, int32_t* lists, int& lanes_used, int r,
    const int32_t* __restrict__ out_off, const int2* __restrict__ out_edge,
    const int32_t* __restrict__ out_rank, const uint8_t* __restrict__ in_has,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, float* __restrict__ dist_out,
    int8_t* nh, int A, int V, int D, float big) {
  const int T = blockDim.x;
  const int VD = V * D;
  const int a = r % A;  // r = batch row * A + area
  const int root = roots[r];
  float* dist = dist_out + (size_t)r * V;
  int8_t* lanes = nh + (size_t)r * V * D;
  if (root < 0) {
    for (int v = threadIdx.x; v < V; v += T) dist[v] = big;
    for (int i = threadIdx.x; i < VD; i += T) lanes[i] = 0;
    return;
  }
  const int32_t* off = out_off + (size_t)a * (V + 1);
  const uint8_t* has = in_has + (size_t)a * V;
  const uint8_t* ovl = overloaded + (size_t)a * V;
  int32_t* count = lists;
  int32_t* moving = count + V;
  int32_t* poff = moving + V;
  int32_t* psrc = poff + V + 1;

  // 1. distances
  frontier_distances(f, V, root, off, out_edge, nullptr, ovl,
                     [](int) { return true; }, big);
  const volatile float* d = f.d;
  for (int v = threadIdx.x; v < V; v += T) {
    dist[v] = d[v];
    count[v] = 0;
  }
  // 2. the fill: -128 where the vertex is absent from the padded edge list
  // (16 lanes a store where whole rows of D lanes fill 16-byte words)
  if (D % 16 == 0) {
    uint4* words = reinterpret_cast<uint4*>(lanes);
    for (int i = threadIdx.x; i < VD / 16; i += T) {
      const uint32_t x = has[i / (D / 16)] ? 0u : 0x80808080u;
      words[i] = make_uint4(x, x, x, x);
    }
  } else {
    for (int i = threadIdx.x; i < VD; i += T) lanes[i] = has[i / D] ? 0 : -128;
  }
  if (threadIdx.x == 0) lanes_used = 0;
  __syncthreads();

  // 3. the root's out-edges on the DAG set their lanes; every other DAG edge
  // counts a propagating source of its dst
  for (int j = off[root] + threadIdx.x; j < off[root + 1]; j += T) {
    const int2 e = out_edge[j];
    const float dv = d[e.x];
    if (d[root] + __int_as_float(e.y) == dv && dv < big) {
      const int k = out_rank[j];
      if (k < D) lanes[(size_t)e.x * D + k] = 1;
      atomicMax(&lanes_used, k + 1);
    }
  }
  const auto each_propagating = [&](auto visit) {
    for (int u = threadIdx.x; u < V; u += T) {
      const float du = d[u];
      if (u == root || du >= big || ovl[u]) continue;
      for (int j = off[u]; j < off[u + 1]; ++j) {
        const int2 e = out_edge[j];
        if (du + __int_as_float(e.y) == d[e.x]) visit(u, e.x);
      }
    }
  };
  each_propagating([&](int, int v) { atomicAdd(count + v, 1); });
  __syncthreads();

  // 4. the moving vertices (a propagating source at least) and the offsets
  // of their sources; count becomes each one's packing cursor
  const volatile int32_t* vcount = count;
  const int num_moving = block_ranks(
      f.counts, V, [&](int v) { return vcount[v] > 0; },
      [&](int v, int k) {
        if (k >= 0) moving[k] = v;
      });
  const int num_prop = block_offsets(
      f.counts, num_moving, [&](int k) { return vcount[moving[k]]; },
      [&](int k, int o) {
        poff[k] = o;
        count[moving[k]] = o;
      });
  if (threadIdx.x == 0) poff[num_moving] = num_prop;
  each_propagating([&](int u, int v) { psrc[atomicAdd(count + v, 1)] = u; });
  __syncthreads();

  // 5. OR-propagation over the live lanes
  const int L = lanes_used < D ? lanes_used : D;
  or_lanes(lanes, moving, num_moving, poff, psrc, V, L, D);
}

// Where kernel 12's block state lives (FleetLayout): the frontier state
// (state_ints) and the lane lists both in dynamic shared memory, the
// frontier state there and the lists in the block's slice of a global
// scratch, or both in the slice.
enum FleetLayout { kSharedAll = 0, kSharedFrontier = 1, kGlobalAll = 2 };

// Kernel 12 over rows = B * A pairs: block b walks pairs b, b + grid, ...
// with its state placed by `layout` (slice_ints: its slice of `scratch`).
__global__ void __launch_bounds__(1024) fleet_spf_dense_kernel(
    const int32_t* __restrict__ out_off, const int2* __restrict__ out_edge,
    const int32_t* __restrict__ out_rank, const uint8_t* __restrict__ in_has,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, float* __restrict__ dist_out,
    int8_t* nh, int32_t* scratch, size_t state_ints, size_t slice_ints,
    int layout, int rows, int A, int V, int D, int cap, float big) {
  extern __shared__ int32_t shared_ints[];
  __shared__ int lanes_used;
  int32_t* slice = scratch ? scratch + blockIdx.x * slice_ints : nullptr;
  const Frontier f(layout == kGlobalAll ? slice : shared_ints, V, cap);
  int32_t* lists = layout == kSharedAll         ? shared_ints + state_ints
                   : layout == kSharedFrontier ? slice
                                               : slice + state_ints;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    fleet_pair(f, lists, lanes_used, r, out_off, out_edge, out_rank, in_has,
               overloaded, roots, dist_out, nh, A, V, D, big);
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

extern "C" int openr_fleet_spf_dense(
    const void* out_off, const void* out_edge, const void* out_rank,
    const void* in_has, const void* overloaded, const void* roots,
    void* dist, void* nh, void* scratch, int layout, int grid, int threads,
    int B, int A, int V, int M, int D, int cap, float big, void* stream) {
  if (B == 0 || A == 0) return (int)cudaSuccess;
  // the frontier state and the lane lists, each rounded up to whole
  // 16-byte words
  const size_t state_ints = (frontier_state_ints(V, cap, threads) + 3) / 4 * 4;
  const size_t lists_ints = (fleet_lists_ints(V, M) + 3) / 4 * 4;
  const size_t shared_ints = layout == kSharedAll        ? state_ints + lists_ints
                             : layout == kSharedFrontier ? state_ints
                                                         : 0;
  const size_t slice_ints = state_ints + lists_ints - shared_ints;
  const size_t smem = shared_ints * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fleet_spf_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fleet_spf_dense_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)out_off, (const int2*)out_edge, (const int32_t*)out_rank,
      (const uint8_t*)in_has, (const uint8_t*)overloaded,
      (const int32_t*)roots, (float*)dist, (int8_t*)nh, (int32_t*)scratch,
      state_ints, slice_ints, layout, B * A, A, V, D, cap, big);
  return (int)cudaGetLastError();
}
