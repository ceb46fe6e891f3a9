// Warm-start SPF kernels for Hopper (sm_90a): the per-area SPF tables of
// a warm topology tick, seeded from the previous generation's tables.
//
// Replaces the jitted XLA kernels of the JAX package
//   openr_tpu/ops/spf.py:449 warm_spf_distances        (kernel 4 here)
//   openr_tpu/ops/spf.py:493 spf_nexthop_lanes_reset   (kernel 5 here)
//   openr_tpu/ops/spf.py:548 warm_subgraph_repair_one  (kernel 6 here)
// vmapped over areas by openr_tpu/ops/route_select.py:200
// warm_multi_area_spf_tables (kernels 4 + 5, through spf.py:636
// warm_spf_one) and :235 warm_multi_area_subgraph_tables (kernel 6), and
// the cold segment-form twins
//   openr_tpu/ops/spf.py:50 spf_distances, :106 spf_nexthop_lanes
//   (:160 spf_one; route_select.py:148 multi_area_spf_tables)
// batched over vantage roots and failure sets by
//   openr_tpu/ops/fleet_tables.py:27 fleet_multi_area_tables and
//   :217 whatif_multi_area_tables                     (kernel 14 here).
//
// All three read the SEGMENT form of the topology: directed edges sorted
// by dst, so vertex v's in-edges are the run [off[v], off[v+1]) (the
// wrapper derives the offsets from dst).  Padding edges carry
// edge_ok = false and still sit in their dst's run.
//   4. dist: masked Bellman-Ford from the host-planned over-estimate d0
//      (reset vertices BIG, the root pinned at 0).
//   5. lanes with RESET semantics: every round REPLACES lane (v, l) by
//      max(seed, max over v's in-edges of contrib), where a shortest-path
//      DAG edge out of the root seeds its lane (lane_rank) and a DAG edge
//      out of any other node contributes nh[src][l]; every other edge of
//      the run contributes 0.  A vertex with an EMPTY run holds int8
//      -128, exactly the reference's segment_max identity.
//   6. bounded repair of a pure-weakening delta: 4 then 5, relaxing only
//      the reset vertices over the sub-edge list (every in-edge of a reset
//      vertex), every other vertex read from the previous generation.
//
// Design: one thread block per area, the area's distances in dynamic
// shared memory (V <= 16384 -> at most 64 KB, hence
// cudaFuncSetAttribute), rounds loop inside the kernel and end on a
// block-wide changed vote, so there are no host round trips.
//
// Updates are in place (Gauss-Seidel), and the fixed points are the
// reference's, bit for bit:
//   * distances: from a seed d0 the relaxation converges to
//     min_u (d0[u] + path(u -> v)) whatever the update order; integral
//     link metrics keep every f32 sum exact.
//   * lanes: propagating edges lie on the shortest-path DAG
//     (d[src] + w == d[dst] < BIG with w >= 1), so they form an acyclic
//     graph and the reset-semantics update has a unique fixed point.  By
//     induction on DAG depth, after round k every vertex of depth < k is
//     final whether a thread read a neighbour's old or new value, and a
//     round in which no thread changed anything read one consistent state
//     that is therefore the fixed point.  So no second [V, D] buffer is
//     needed.  The round counts are telemetry and differ from the
//     reference's synchronous counts.
//
// Load balance: padding edges all sit in the run of vertex V-1 (half the
// edge list on a full node bucket), so a thread walking that run every
// round serialises the block.  A parallel prologue records, per vertex,
// the end of its run's last enabled edge (seg_end); the rounds walk only
// [off[v], seg_end[v]).  The skipped tail holds disabled edges alone,
// which contribute nothing (BIG to a distance, 0 to a lane); the run's
// emptiness, which decides the -128 fill, is still read from off[].
//
// Kernel 14 (spf_segment_batch) is the cold solve of 4 then 5 for every
// (batch row, area) pair in one launch, one block of 256 threads each:
// distances from BIG (the root at 0), then the lanes.  The reference
// OR-accumulates its cold lanes from the seed; the reset update reaches
// the same tables, because on the DAG both fixed points are the unique
// one above the seed.  Per row it takes the row's own root (-1: the
// vantage is absent from the area, and the block writes dist BIG, lanes
// 0 without solving) and, optionally, a failed set of (area, link) pairs:
// an edge is masked iff some member has this area, the edge's link id and
// a link id >= 0, so a -1 pad masks nothing, not even a padding edge
// (whose link id is also -1).  The block keeps in shared memory its
// distances, its run ends, its edge classes and the lane rank of every
// edge (a block scan: the rank among the root's out-edges in edge order,
// -1 off the root), so nothing scales with the batch but the outputs;
// the lane rounds run only over lanes a root out-edge can seed.
//
// What bounds it: latency, not bytes.  Each round re-reads the area's
// edge arrays (L2-resident at these sizes) and the loop runs for the
// depth of the perturbed region; one block runs on 1 of the card's 132
// SMs when A = 1.
//
// Traps: the seed and the unusable-edge candidate are BIG = 3.4e38, not
// inf: BIG + w rounds to BIG and BIG + BIG is +inf, and padding weights
// are +inf.  min/compare must treat these exactly, so this file is never
// built with --use_fast_math.  int8 lanes are combined in int32 and
// stored as int8, as the reference's int8 multiply-and-max gives them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// edge classes in the scratch plane
constexpr uint8_t kOffDag = 0;
constexpr uint8_t kSeed = 1;       // on-DAG edge out of the root
constexpr uint8_t kPropagate = 2;  // on-DAG edge out of any other node

// full edge list: usable when ok and its src may transit (an overloaded
// node other than the root does not relax its out-edges)
struct FullEdges {
  const uint8_t* edge_ok;
  const uint8_t* overloaded;
  int root;
  __device__ bool usable(int e, int s) const {
    return edge_ok[e] && (!overloaded[s] || s == root);
  }
};

// sub-edge list: usability precomputed on the host (edge_ok & transit)
struct SubEdges {
  const uint8_t* ok;
  __device__ bool usable(int e, int) const { return ok[e]; }
};

// seg_end[v] = end of the last enabled edge of v's run (off[v] if none);
// ends with a barrier.
__device__ void enabled_run_ends(int32_t* seg_end, const int32_t* off,
                                 const int32_t* dst, const uint8_t* enabled,
                                 int V, int E) {
  for (int v = threadIdx.x; v < V; v += blockDim.x) seg_end[v] = off[v];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (enabled[e]) atomicMax(&seg_end[dst[e]], e + 1);
  __syncthreads();
}

// Relax the selected vertices (all when `only` is null) to the fixed
// point; returns the number of rounds run.
template <class Edges>
__device__ int relax_distances(float* d, const int32_t* off,
                               const int32_t* seg_end, const int32_t* src,
                               const float* w, Edges edges,
                               const uint8_t* only, int V, float big) {
  int rounds = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      if (only && !only[v]) continue;
      const float cur = d[v];
      float best = cur;
      for (int e = off[v]; e < seg_end[v]; ++e) {
        const int s = src[e];
        best = fminf(best, edges.usable(e, s) ? d[s] + w[e] : big);
      }
      if (best < cur) {
        d[v] = best;
        changed = 1;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  return rounds;
}

// Classify the in-edges of the selected vertices against the converged
// distances: shortest-path DAG edges seed (lane_rank >= 0: an out-edge of
// the root) or propagate.
template <class Edges>
__device__ void classify_edges(uint8_t* cls, const float* d,
                               const int32_t* off, const int32_t* seg_end,
                               const int32_t* src, const float* w,
                               const int32_t* lane_rank, Edges edges,
                               const uint8_t* only, int V, float big) {
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    if (only && !only[v]) continue;
    const float dv = d[v];
    for (int e = off[v]; e < seg_end[v]; ++e) {
      const int s = src[e];
      const bool on = edges.usable(e, s) && dv < big && d[s] + w[e] == dv;
      cls[e] = on ? (lane_rank[e] >= 0 ? kSeed : kPropagate) : kOffDag;
    }
  }
}

// Reset-semantics lane fixed point over the selected vertices, in place
// in nh [V, D], over its first L lanes (L = D but in kernel 14); returns
// the number of rounds run.
__device__ int propagate_lanes(int8_t* nh, const uint8_t* cls,
                               const int32_t* off, const int32_t* seg_end,
                               const int32_t* src, const int32_t* lane_rank,
                               const uint8_t* only, int V, int L, int D) {
  int rounds = 0;
  const int VL = V * L;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < VL; i += blockDim.x) {
      const int v = i / L;
      if (only && !only[v]) continue;
      const int l = i - v * L;
      const size_t at = (size_t)v * D + l;
      const int e0 = off[v];
      // an empty run keeps the reference's segment_max identity, -128;
      // otherwise non-DAG edges contribute 0, so the value starts at 0
      int x = e0 < off[v + 1] ? 0 : -128;
      for (int e = e0; e < seg_end[v]; ++e) {
        const uint8_t c = cls[e];
        if (c == kSeed) {
          if (lane_rank[e] == l) x = x > 1 ? x : 1;
        } else if (c == kPropagate) {
          const int y = nh[(size_t)src[e] * D + l];
          x = y > x ? y : x;
        }
      }
      if (x != nh[at]) {
        nh[at] = (int8_t)x;
        changed = 1;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  return rounds;
}

__global__ void __launch_bounds__(kThreads)
    warm_spf_distances_kernel(const int32_t* __restrict__ src,
                              const int32_t* __restrict__ dst,
                              const float* __restrict__ w,
                              const uint8_t* __restrict__ edge_ok,
                              const uint8_t* __restrict__ overloaded,
                              const int32_t* __restrict__ roots,
                              const float* __restrict__ d0,
                              const int32_t* __restrict__ seg_off,
                              int32_t* __restrict__ seg_end,
                              float* __restrict__ dist_out,
                              int32_t* __restrict__ rounds_out, int V, int E,
                              float big) {
  extern __shared__ float d[];  // [V] this area's distances
  const int a = blockIdx.x;
  const int root = roots[a];
  const size_t edges_at = (size_t)a * E;
  const int32_t* off = seg_off + (size_t)a * (V + 1);
  int32_t* end = seg_end + (size_t)a * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    d[v] = v == root ? 0.f : d0[(size_t)a * V + v];
  enabled_run_ends(end, off, dst + edges_at, edge_ok + edges_at, V, E);
  const FullEdges edges{edge_ok + edges_at, overloaded + (size_t)a * V, root};
  const int rounds = relax_distances(d, off, end, src + edges_at,
                                     w + edges_at, edges, nullptr, V, big);
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    dist_out[(size_t)a * V + v] = d[v];
  if (threadIdx.x == 0) rounds_out[a] = rounds;
}

__global__ void __launch_bounds__(kThreads) spf_nexthop_lanes_reset_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ roots,
    const float* __restrict__ dist, const int8_t* __restrict__ nh0,
    const int32_t* __restrict__ seg_off, int32_t* __restrict__ seg_end,
    const int32_t* __restrict__ root_rank, uint8_t* __restrict__ edge_class,
    int8_t* nh, int32_t* __restrict__ rounds_out, int V, int E, int D,
    float big) {
  extern __shared__ float d[];  // [V] this area's distances
  const int a = blockIdx.x;
  const int root = roots[a];
  const size_t edges_at = (size_t)a * E;
  const size_t lanes_at = (size_t)a * V * D;
  const int32_t* off = seg_off + (size_t)a * (V + 1);
  int32_t* end = seg_end + (size_t)a * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) d[v] = dist[(size_t)a * V + v];
  for (int i = threadIdx.x; i < V * D; i += blockDim.x)
    nh[lanes_at + i] = nh0[lanes_at + i];
  enabled_run_ends(end, off, dst + edges_at, edge_ok + edges_at, V, E);
  const FullEdges edges{edge_ok + edges_at, overloaded + (size_t)a * V, root};
  classify_edges(edge_class + edges_at, d, off, end, src + edges_at,
                 w + edges_at, root_rank + edges_at, edges, nullptr, V, big);
  __syncthreads();
  const int rounds = propagate_lanes(nh + lanes_at, edge_class + edges_at, off,
                                     end, src + edges_at, root_rank + edges_at,
                                     nullptr, V, D, D);
  if (threadIdx.x == 0) rounds_out[a] = rounds;
}

__global__ void __launch_bounds__(kThreads) warm_subgraph_repair_kernel(
    const int32_t* __restrict__ src_sub, const int32_t* __restrict__ dst_sub,
    const float* __restrict__ w_sub, const uint8_t* __restrict__ ok_sub,
    const int32_t* __restrict__ rank_sub,
    const float* __restrict__ prev_dist, const int8_t* __restrict__ prev_nh,
    const uint8_t* __restrict__ reset, const int32_t* __restrict__ seg_off,
    int32_t* __restrict__ seg_end, uint8_t* __restrict__ edge_class,
    float* __restrict__ dist_out, int8_t* nh,
    int32_t* __restrict__ rounds_d, int32_t* __restrict__ rounds_l, int V,
    int Es, int D, float big) {
  extern __shared__ float d[];  // [V] this area's distances
  const int a = blockIdx.x;
  const size_t edges_at = (size_t)a * Es;
  const size_t lanes_at = (size_t)a * V * D;
  const int32_t* off = seg_off + (size_t)a * (V + 1);
  int32_t* end = seg_end + (size_t)a * V;
  const uint8_t* only = reset + (size_t)a * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    d[v] = only[v] ? big : prev_dist[(size_t)a * V + v];
  for (int i = threadIdx.x; i < V * D; i += blockDim.x)
    nh[lanes_at + i] = only[i / D] ? 0 : prev_nh[lanes_at + i];
  enabled_run_ends(end, off, dst_sub + edges_at, ok_sub + edges_at, V, Es);
  const SubEdges edges{ok_sub + edges_at};
  const int rd = relax_distances(d, off, end, src_sub + edges_at,
                                 w_sub + edges_at, edges, only, V, big);
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    dist_out[(size_t)a * V + v] = d[v];
  classify_edges(edge_class + edges_at, d, off, end, src_sub + edges_at,
                 w_sub + edges_at, rank_sub + edges_at, edges, only, V, big);
  __syncthreads();
  const int rl = propagate_lanes(nh + lanes_at, edge_class + edges_at, off,
                                 end, src_sub + edges_at, rank_sub + edges_at,
                                 only, V, D, D);
  if (threadIdx.x == 0) {
    rounds_d[a] = rd;
    rounds_l[a] = rl;
  }
}

// full edge list minus a failed set: kernel 14's usability (the transit
// rule of FullEdges, and no edge of a failed link of this area)
struct MaskedEdges {
  const uint8_t* edge_ok;
  const uint8_t* overloaded;
  const int32_t* link_index;
  const int32_t* failed;  // this area's failed link ids (all >= 0)
  int num_failed;
  int root;
  __device__ bool usable(int e, int s) const {
    if (!edge_ok[e] || (overloaded[s] && s != root)) return false;
    for (int k = 0; k < num_failed; ++k)
      if (link_index[e] == failed[k]) return false;
    return true;
  }
};

// rank[e] = e's rank among the root's out-edges in edge order (its lane),
// -1 on every other edge; counts holds blockDim.x + 1 ints of scratch.
// Returns the number of root out-edges; ends with a barrier.
__device__ int root_lane_ranks(int32_t* rank, int32_t* counts,
                               const int32_t* src, int root, int E) {
  const int T = blockDim.x;
  const int chunk = (E + T - 1) / T;
  const int lo = min(E, (int)threadIdx.x * chunk);
  const int hi = min(E, lo + chunk);
  int c = 0;
  for (int e = lo; e < hi; ++e) c += src[e] == root;
  counts[threadIdx.x] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < T; ++t) {
      const int n = counts[t];
      counts[t] = run;
      run += n;
    }
    counts[T] = run;
  }
  __syncthreads();
  int next = counts[threadIdx.x];
  for (int e = lo; e < hi; ++e) rank[e] = src[e] == root ? next++ : -1;
  __syncthreads();
  return counts[T];
}

constexpr int kBatchThreads = 256;

__global__ void __launch_bounds__(kBatchThreads) spf_segment_batch_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ link_index,
    const int32_t* __restrict__ roots, const int32_t* __restrict__ fail_area,
    const int32_t* __restrict__ fail_link,
    const int32_t* __restrict__ seg_off, float* __restrict__ dist_out,
    int8_t* nh, int A, int V, int E, int D, int S, float big) {
  // shared: run ends [V], lane ranks [E], scan counts [T + 1], failed
  // links [S], distances [V], edge classes [E]
  extern __shared__ int32_t shared_ints[];
  int32_t* end = shared_ints;
  int32_t* rank = end + V;
  int32_t* counts = rank + E;
  int32_t* failed = counts + blockDim.x + 1;
  float* d = reinterpret_cast<float*>(failed + S);
  uint8_t* cls = reinterpret_cast<uint8_t*>(d + V);
  __shared__ int num_failed;
  const int r = blockIdx.x;  // batch row * A + area
  const int b = r / A;
  const int a = r - b * A;
  const int root = roots[r];
  float* dist = dist_out + (size_t)r * V;
  int8_t* lanes = nh + (size_t)r * V * D;
  const int VD = V * D;
  if (root < 0) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = big;
    for (int i = threadIdx.x; i < VD; i += blockDim.x) lanes[i] = 0;
    return;
  }
  const size_t edges_at = (size_t)a * E;
  const int32_t* off = seg_off + (size_t)a * (V + 1);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int s = 0; s < S; ++s) {
      const int fl = fail_link[(size_t)b * S + s];
      if (fail_area[(size_t)b * S + s] == a && fl >= 0) failed[n++] = fl;
    }
    num_failed = n;
  }
  const int root_out = root_lane_ranks(rank, counts, src + edges_at, root, E);
  for (int v = threadIdx.x; v < V; v += blockDim.x) d[v] = v == root ? 0.f : big;
  enabled_run_ends(end, off, dst + edges_at, edge_ok + edges_at, V, E);
  const MaskedEdges edges{edge_ok + edges_at, overloaded + (size_t)a * V,
                          link_index ? link_index + edges_at : nullptr,
                          failed, link_index ? num_failed : 0, root};
  relax_distances(d, off, end, src + edges_at, w + edges_at, edges, nullptr,
                  V, big);
  for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = d[v];
  classify_edges(cls, d, off, end, src + edges_at, w + edges_at, rank, edges,
                 nullptr, V, big);
  // an empty run holds -128; every lane no root out-edge can seed stays 0
  for (int i = threadIdx.x; i < VD; i += blockDim.x) {
    const int v = i / D;
    lanes[i] = off[v] < off[v + 1] ? 0 : -128;
  }
  __syncthreads();
  propagate_lanes(lanes, cls, off, end, src + edges_at, rank, nullptr, V,
                  root_out < D ? root_out : D, D);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int openr_warm_spf_distances(const void* src, const void* dst,
                                        const void* w, const void* edge_ok,
                                        const void* overloaded,
                                        const void* roots, const void* d0,
                                        const void* seg_off, void* seg_end,
                                        void* dist, void* rounds, int A,
                                        int V, int E, float big,
                                        void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  cudaError_t err = allow_smem(warm_spf_distances_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  warm_spf_distances_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w,
      (const uint8_t*)edge_ok, (const uint8_t*)overloaded,
      (const int32_t*)roots, (const float*)d0, (const int32_t*)seg_off,
      (int32_t*)seg_end, (float*)dist, (int32_t*)rounds, V, E, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_spf_nexthop_lanes_reset(
    const void* src, const void* dst, const void* w, const void* edge_ok,
    const void* overloaded, const void* roots, const void* dist,
    const void* nh0, const void* seg_off, void* seg_end,
    const void* root_rank, void* edge_class, void* nh, void* rounds, int A,
    int V, int E, int D, float big, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  cudaError_t err = allow_smem(spf_nexthop_lanes_reset_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  spf_nexthop_lanes_reset_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w,
      (const uint8_t*)edge_ok, (const uint8_t*)overloaded,
      (const int32_t*)roots, (const float*)dist, (const int8_t*)nh0,
      (const int32_t*)seg_off, (int32_t*)seg_end, (const int32_t*)root_rank,
      (uint8_t*)edge_class, (int8_t*)nh, (int32_t*)rounds, V, E, D, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_warm_subgraph_repair(
    const void* src_sub, const void* dst_sub, const void* w_sub,
    const void* ok_sub, const void* rank_sub, const void* prev_dist,
    const void* prev_nh, const void* reset, const void* seg_off,
    void* seg_end, void* edge_class, void* dist, void* nh, void* rounds_d,
    void* rounds_l, int A, int V, int Es, int D, float big, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  cudaError_t err = allow_smem(warm_subgraph_repair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  warm_subgraph_repair_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src_sub, (const int32_t*)dst_sub, (const float*)w_sub,
      (const uint8_t*)ok_sub, (const int32_t*)rank_sub,
      (const float*)prev_dist, (const int8_t*)prev_nh, (const uint8_t*)reset,
      (const int32_t*)seg_off, (int32_t*)seg_end, (uint8_t*)edge_class,
      (float*)dist, (int8_t*)nh, (int32_t*)rounds_d, (int32_t*)rounds_l, V,
      Es, D, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_spf_segment_batch(
    const void* src, const void* dst, const void* w, const void* edge_ok,
    const void* overloaded, const void* link_index, const void* roots,
    const void* fail_area, const void* fail_link, const void* seg_off,
    void* dist, void* nh, int B, int A, int V, int E, int D, int S,
    float big, void* stream) {
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(V + E + kBatchThreads + 1 + S) * 4 +
                      (size_t)V * sizeof(float) + (size_t)E;
  cudaError_t err = allow_smem(spf_segment_batch_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  spf_segment_batch_kernel<<<B * A, kBatchThreads, smem,
                             (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w,
      (const uint8_t*)edge_ok, (const uint8_t*)overloaded,
      (const int32_t*)link_index, (const int32_t*)roots,
      (const int32_t*)fail_area, (const int32_t*)fail_link,
      (const int32_t*)seg_off, (float*)dist, (int8_t*)nh, A, V, E, D, S, big);
  return (int)cudaGetLastError();
}
