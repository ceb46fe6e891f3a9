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
// Kernel 1: one thread block per area.  The area's distance vector lives
// in dynamic shared memory (V <= 16384 -> at most 64 KB, above the 48 KB
// default, hence cudaFuncSetAttribute), relaxation rounds loop inside the
// kernel and end on a block-wide "changed" vote (__syncthreads_or), so
// there are no host round trips.  Updates are in place (Gauss-Seidel): the
// iteration is monotone with a unique fixed point (integral link metrics
// keep every f32 path sum exact), so in-place updates and racy reads of a
// neighbour's value within a round reach the reference's table bit for
// bit.  What bounds it: latency, not bytes.  Each round re-reads the
// [V, K] in-edge planes (L2-resident at these sizes) and the loop runs for
// the hop diameter; with A = 1 the whole solve runs on 1 of the card's 132
// SMs.
//
// Kernel 2: one thread block per area, its lanes as bit words.  The
// thread that owns a vertex classifies its K in-slots once against the
// distances (shared memory): a DAG slot out of the root sets its seed bit
// (lane in_rank), every other DAG slot counts a propagating source.  Two
// block scans list the moving vertices (a propagating source at least) and
// pack their sources, in slot order.  The lanes are ceil(D / 32) uint32
// words per vertex beside the distances, and the OR rounds run over the
// words of the moving vertices only, and only over the words a seed can
// reach (lanes below 1 + the highest seeded rank), in place until a round
// changes nothing.  The int8 table is written once at the end, spread over
// the block (4 lanes a store where D allows): -128 where in_has is false,
// else the bit.  Why OR is exact: a vertex's reference lanes start at 0 or
// 1 where in_has holds (else -128) and rise by the int8 max over its
// propagating sources' lanes; a propagating source is reached and is not
// the root, so it has an in-edge on the DAG, in_has holds there and its
// lanes are 0 or 1, never -128; so the max is the OR of bits, and a word's
// fixed point is the reference's.  The state (distances, words, scan
// counts) and the lane lists (room for a source in every in-slot) live in
// shared memory where they fit; else the lists, and past shared memory
// the whole state, go to the area's slice of a global scratch
// (StateLayout), so every shape kernel 1 takes runs.  What bounds it:
// latency, one barrier a round for the depth of the DAG (126 rounds from
// node0 on the 64 x 64 grid), each round a few shared-memory loads per
// thread; with A = 1 on 1 of the 132 SMs (PERF.md).

// Kernel 12 (fleet_spf_dense) solves every (vantage root, area) pair in
// ONE launch, one block per pair at a time, the blocks walking the pairs in
// a grid-stride loop.  It does not sweep the planes: the launcher derives
// once a CSR by source of each area's usable in-edge slots (in_ok; the
// transit rule stays per root), each slot {dst, w} and its in_rank, and the
// block runs the frontier relaxation of frontier.cuh from its root (kernel
// 15's routine).  Then the lanes: the plane is filled (-128 where in_has is
// false, else 0), the root's out-edges on the shortest-path DAG set their
// lanes, every other DAG edge (its source reached, not the root, free to
// transit) is packed as a propagating source of its dst, and OR rounds run
// over the vertices with a propagating source and only the lanes a seed
// can reach, as one bit word a vertex where those lanes fit 32, else on
// the table by or_lanes (frontier_pair, shared with kernels 14 and 16).
// A root of -1 (the vantage is
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

// Kernel 2's block state (dense_lanes_state_ints), carved from `base`
// (dynamic shared memory, or the area's slice of a global scratch):
// distances [V], lane words [V * W] (W = ceil(D / 32)) and scan counts
// [T + 1]; its lane lists (lane_lists_ints) follow or live in the slice.
__host__ __device__ inline size_t dense_lanes_state_ints(int V, int D, int T) {
  return (size_t)V + (size_t)V * ((D + 31) / 32) + (size_t)T + 1;
}

__global__ void __launch_bounds__(kThreads)
    dense_spf_nexthop_lanes_kernel(
        const int32_t* __restrict__ in_src, const float* __restrict__ in_w,
        const uint8_t* __restrict__ in_ok, const int32_t* __restrict__ in_rank,
        const uint8_t* __restrict__ in_has,
        const uint8_t* __restrict__ overloaded,
        const int32_t* __restrict__ roots, const float* __restrict__ dist,
        int8_t* __restrict__ nh, int32_t* scratch, size_t state_ints,
        size_t slice_ints, int layout, int V, int K, int D, float big) {
  extern __shared__ int32_t shared_ints[];
  __shared__ int lanes_used;
  const int a = blockIdx.x;
  const int T = blockDim.x;
  const int W = (D + 31) / 32;
  const int root = roots[a];
  const size_t plane = (size_t)a * V * K;
  const int32_t* src = in_src + plane;
  const float* w = in_w + plane;
  const uint8_t* ok = in_ok + plane;
  const int32_t* rank = in_rank + plane;
  const uint8_t* has = in_has + (size_t)a * V;
  const uint8_t* ovl = overloaded + (size_t)a * V;
  int8_t* lanes = nh + (size_t)a * V * D;
  int32_t* slice = scratch ? scratch + (size_t)a * slice_ints : nullptr;
  int32_t* state = layout == kGlobalAll ? slice : shared_ints;
  int32_t* lists = layout == kSharedAll         ? shared_ints + state_ints
                   : layout == kSharedFrontier ? slice
                                               : slice + state_ints;
  float* d = reinterpret_cast<float*>(state);
  uint32_t* words = reinterpret_cast<uint32_t*>(state + V);
  int32_t* counts = state + V + (size_t)V * W;
  int32_t* count = lists;
  int32_t* moving = count + V;
  int32_t* poff = moving + V;
  int32_t* psrc = poff + V + 1;

  for (int v = threadIdx.x; v < V; v += T) d[v] = dist[(size_t)a * V + v];
  for (int i = threadIdx.x; i < V * W; i += T) words[i] = 0u;
  if (threadIdx.x == 0) lanes_used = 0;
  __syncthreads();
  // in-slot (v, k) on the shortest-path DAG: usable (ok, its source free
  // to transit) with d[src] + w == d[v] < BIG
  const auto on_dag = [&](size_t e, int s, float dv) {
    return ok[e] && can_transit(ovl, s, root) && d[s] + w[e] == dv;
  };
  // 1. each vertex's in-slots, classified once by the thread that owns the
  // vertex: the root's set its seed bit (by in_rank), the others count
  for (int v = threadIdx.x; v < V; v += T) {
    const float dv = d[v];
    int c = 0;
    if (dv < big) {
      uint32_t* vw = words + (size_t)v * W;
      for (int k = 0; k < K; ++k) {
        const size_t e = (size_t)v * K + k;
        const int s = src[e];
        if (!on_dag(e, s, dv)) continue;
        if (s != root) {
          ++c;
          continue;
        }
        const int r = rank[e];
        if (r >= 0 && r < D) {
          vw[r >> 5] |= 1u << (r & 31);
          atomicMax(&lanes_used, r + 1);
        }
      }
    }
    count[v] = c;
  }
  __syncthreads();
  // 2. the moving vertices (a propagating source at least) and their
  // sources, packed in in-slot order
  const int num_moving = block_ranks(
      counts, V, [&](int v) { return count[v] > 0; },
      [&](int v, int k) {
        if (k >= 0) moving[k] = v;
      });
  const int num_prop = block_offsets(
      counts, num_moving, [&](int k) { return count[moving[k]]; },
      [&](int k, int o) {
        poff[k] = o;
        const int v = moving[k];
        const float dv = d[v];
        for (int j = 0; j < K; ++j) {
          const size_t e = (size_t)v * K + j;
          const int s = src[e];
          if (s != root && on_dag(e, s, dv)) psrc[o++] = s;
        }
      });
  if (threadIdx.x == 0) poff[num_moving] = num_prop;
  __syncthreads();
  // 3. OR rounds over the words of the moving vertices and only the words
  // a seed can reach; in place, as or_lanes
  const int L = lanes_used < D ? lanes_used : D;
  const int Wl = (L + 31) / 32;
  const int n = num_moving * Wl;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += T) {
      const int k = Wl == 1 ? i : i / Wl;
      const int j = i - k * Wl;
      uint32_t* at = words + (size_t)moving[k] * W + j;
      const uint32_t cur = *at;
      uint32_t x = cur;
      for (int p = poff[k]; p < poff[k + 1]; ++p) x |= words[(size_t)psrc[p] * W + j];
      if (x != cur) {
        *at = x;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  // 4. the int8 table, written once: -128 where the vertex is absent from
  // the padded edge list, else its bit (4 lanes a store where D allows)
  if (D % 4 == 0) {
    uint32_t* out = reinterpret_cast<uint32_t*>(lanes);
    const int n4 = V * D / 4;
    for (int i = threadIdx.x; i < n4; i += T) {
      const int v = 4 * i / D;
      const int l = 4 * i - v * D;
      uint32_t x = 0x80808080u;
      if (has[v]) {
        const uint32_t b = (words[(size_t)v * W + (l >> 5)] >> (l & 31)) & 0xFu;
        x = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
      }
      out[i] = x;
    }
  } else {
    for (int i = threadIdx.x; i < V * D; i += T) {
      const int v = i / D;
      const int l = i - v * D;
      lanes[i] = has[v] ? (int8_t)((words[(size_t)v * W + (l >> 5)] >> (l & 31)) & 1u)
                        : (int8_t)-128;
    }
  }
}

// Kernel 12's work on one (row, area) pair r = batch row * A + area, with
// the frontier state f and the lane lists at `lists` (frontier_pair).
__device__ __forceinline__ void fleet_pair(
    const Frontier& f, int32_t* lists, int& lanes_used, int r,
    const int32_t* __restrict__ out_off, const int2* __restrict__ out_edge,
    const int32_t* __restrict__ out_rank, const uint8_t* __restrict__ in_has,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, float* __restrict__ dist_out,
    int8_t* nh, int A, int V, int D, float big) {
  const int a = r % A;  // r = batch row * A + area
  const int root = roots[r];
  float* dist = dist_out + (size_t)r * V;
  int8_t* lanes = nh + (size_t)r * V * D;
  if (root < 0) {
    const size_t VD = (size_t)V * D;
    for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = big;
    for (size_t i = threadIdx.x; i < VD; i += blockDim.x) lanes[i] = 0;
    return;
  }
  frontier_pair(f, lists, lanes_used, root, out_off + (size_t)a * (V + 1), out_edge,
                out_rank, nullptr, [](int) { return true; }, in_has + (size_t)a * V,
                overloaded + (size_t)a * V, dist, lanes, V, D, big, false);
}

// Kernel 12 over rows = B * A pairs: block b walks pairs b, b + grid, ...
// with its state placed by `layout` (StateLayout; slice_ints: its slice
// of `scratch`).
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
    const void* roots, const void* dist, void* nh, void* scratch, int layout,
    int threads, int A, int V, int K, int D, int M, float big, void* stream) {
  if (A == 0) return (int)cudaSuccess;
  // the state and the lane lists, each rounded up to whole 16-byte words
  const size_t state_ints = (dense_lanes_state_ints(V, D, threads) + 3) / 4 * 4;
  const size_t lists_ints = (lane_lists_ints(V, M) + 3) / 4 * 4;
  const size_t shared_ints = layout == kSharedAll        ? state_ints + lists_ints
                             : layout == kSharedFrontier ? state_ints
                                                         : 0;
  const size_t slice_ints = state_ints + lists_ints - shared_ints;
  const size_t smem = shared_ints * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dense_spf_nexthop_lanes_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_spf_nexthop_lanes_kernel<<<A, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in_src, (const float*)in_w, (const uint8_t*)in_ok,
      (const int32_t*)in_rank, (const uint8_t*)in_has,
      (const uint8_t*)overloaded, (const int32_t*)roots, (const float*)dist,
      (int8_t*)nh, (int32_t*)scratch, state_ints, slice_ints, layout, V, K, D,
      big);
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
  const size_t lists_ints = (lane_lists_ints(V, M) + 3) / 4 * 4;
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
