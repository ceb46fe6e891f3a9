// Cold batch-minor link-failure sweep for Hopper (sm_90a): kernel 8.
//
// Replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/spf.py:878 sweep_spf_link_failures
// with its parts :678 spf_distances_sweep and :716 spf_lanes_sweep (the
// int8 lane form; the reference's 5-bit packed channels, :801, are a TPU
// byte layout the port does not keep).  One topology as a dst-sorted
// edge list (vertex v's in-edges are the run [off[v], off[v+1]); padding
// edges carry edge_ok = false), B snapshots, snapshot b failing the
// undirected link failed[b] (-1: none):
//   dist [V, B] f32: masked Bellman-Ford from the root (BIG unreached);
//     an edge relaxes iff edge_ok, its link is not the failed one and its
//     src may transit (not overloaded, or the root)
//   nh [V, B, D] int8: first-hop lanes.  A shortest-path-DAG edge out of
//     the root (lane_rank >= 0) seeds its lane at its head; every other
//     DAG edge ORs its src's lanes into its head; lanes only ever rise
//     (OR-accumulate).  A vertex with an EMPTY run keeps int8 -128, the
//     reference's segment_max identity; every other vertex starts at 0.
//
// Design: one thread block per 32-snapshot word, warp lane = snapshot, so
// a warp's 32 reads of d[src, word*32 + lane] are one coalesced 128-byte
// line of the batch-minor table.  Warps take vertices round-robin.  Each
// block runs its own fixed point on its own columns, in place in the
// output tables, and stops on a block-wide changed vote
// (__syncthreads_or): no grid-wide sync, no host round trip.
//
// In place (Gauss-Seidel) is exact: the distance update converges to
// min_u (d0[u] + path(u -> v)) whatever the update order (integral link
// metrics keep every f32 sum exact), and the OR-accumulated lanes are the
// least fixed point above the seed of a monotone update, which any
// update order reaches.  Round counts are per block and differ from the
// reference's synchronous ones; they are telemetry.
//
// Load balance: the padding edges all sit in the run of vertex V-1; a
// prologue records each run's last enabled edge (seg_end, shared memory)
// and the rounds stop there.  Emptiness, which decides the -128 fill, is
// still read from off[].
//
// What bounds it: latency.  Each round walks the block's vertices' runs
// (the edge arrays stay in L1/L2) for as many rounds as the snapshot
// word's deepest shortest path; a single word (the engine's base solve)
// runs on one SM.
//
// Traps: BIG = 3.4e38 and BIG + w rounds to BIG; never built with
// --use_fast_math.  The output pointers are read while they are written,
// so they are not __restrict__ (no non-coherent loads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool relaxes(int e, int s, const uint8_t* edge_ok,
                                        const int32_t* link_index, int failed,
                                        const uint8_t* overloaded, int root) {
  return edge_ok[e] && link_index[e] != failed && (!overloaded[s] || s == root);
}

__global__ void __launch_bounds__(kThreads) sweep_spf_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const int32_t* __restrict__ link_index,
    const int32_t* __restrict__ failed_link,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ lane_rank, const int32_t* __restrict__ seg_off,
    float* dist, int8_t* nh, int32_t* __restrict__ rounds_d,
    int32_t* __restrict__ rounds_l, int V, int E, int B, int D, int root,
    float big) {
  extern __shared__ int32_t seg_end[];  // [V]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const bool live = b < B;
  const int failed = live ? failed_link[b] : -1;

  for (int v = threadIdx.x; v < V; v += blockDim.x) seg_end[v] = seg_off[v];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (edge_ok[e]) atomicMax(&seg_end[dst[e]], e + 1);
  if (live)
    for (int v = warp; v < V; v += nwarps)
      dist[(size_t)v * B + b] = v == root ? 0.f : big;
  __syncthreads();

  // distances
  int rd = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    if (live) {
      for (int v = warp; v < V; v += nwarps) {
        const float cur = dist[(size_t)v * B + b];
        float best = cur;
        for (int e = seg_off[v]; e < seg_end[v]; ++e) {
          const int s = src[e];
          if (relaxes(e, s, edge_ok, link_index, failed, overloaded, root))
            best = fminf(best, dist[(size_t)s * B + b] + w[e]);
        }
        if (best < cur) {
          dist[(size_t)v * B + b] = best;
          changed = 1;
        }
      }
    }
    ++rd;
    if (!__syncthreads_or(changed)) break;
  }

  // lanes: the fill, then the root's DAG out-edges seed their lanes
  if (live) {
    for (int v = warp; v < V; v += nwarps) {
      int8_t* out = nh + ((size_t)v * B + b) * D;
      const int e0 = seg_off[v];
      const int8_t fill = e0 < seg_off[v + 1] ? 0 : -128;
      for (int l = 0; l < D; ++l) out[l] = fill;
      const float dv = dist[(size_t)v * B + b];
      if (dv >= big) continue;
      for (int e = e0; e < seg_end[v]; ++e) {
        const int r = lane_rank[e];
        const int s = src[e];
        if (r >= 0 && r < D &&
            relaxes(e, s, edge_ok, link_index, failed, overloaded, root) &&
            dist[(size_t)s * B + b] + w[e] == dv)
          out[r] = 1;
      }
    }
  }
  __syncthreads();

  // lanes: OR-propagate along the other DAG edges, in place
  int rl = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    if (live) {
      for (int v = warp; v < V; v += nwarps) {
        const float dv = dist[(size_t)v * B + b];
        if (dv >= big) continue;
        int8_t* out = nh + ((size_t)v * B + b) * D;
        for (int e = seg_off[v]; e < seg_end[v]; ++e) {
          const int s = src[e];
          if (lane_rank[e] >= 0 ||
              !relaxes(e, s, edge_ok, link_index, failed, overloaded, root) ||
              dist[(size_t)s * B + b] + w[e] != dv)
            continue;
          const int8_t* in = nh + ((size_t)s * B + b) * D;
          for (int l = 0; l < D; ++l) {
            const int8_t y = in[l];
            if (y > out[l]) {
              out[l] = y;
              changed = 1;
            }
          }
        }
      }
    }
    ++rl;
    if (!__syncthreads_or(changed)) break;
  }
  if (threadIdx.x == 0) {
    rounds_d[blockIdx.x] = rd;
    rounds_l[blockIdx.x] = rl;
  }
}

}  // namespace

extern "C" int openr_sweep_spf_link_failures(
    const void* src, const void* dst, const void* w, const void* edge_ok,
    const void* link_index, const void* failed_link, const void* overloaded,
    const void* lane_rank, const void* seg_off, void* dist, void* nh,
    void* rounds_d, void* rounds_l, int V, int E, int B, int D, int root,
    float big, void* stream) {
  const size_t smem = (size_t)V * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_spf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int words = (B + 31) / 32;
  sweep_spf_kernel<<<words, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w,
      (const uint8_t*)edge_ok, (const int32_t*)link_index,
      (const int32_t*)failed_link, (const uint8_t*)overloaded,
      (const int32_t*)lane_rank, (const int32_t*)seg_off, (float*)dist,
      (int8_t*)nh, (int32_t*)rounds_d, (int32_t*)rounds_l, V, E, B, D, root,
      big);
  return (int)cudaGetLastError();
}
