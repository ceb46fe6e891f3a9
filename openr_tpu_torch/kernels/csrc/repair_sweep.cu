// Warm repair of B link-failure sets for Hopper (sm_90a): kernel 9.
//
// Replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/repair.py:367 _repair_sweep_impl (jit at :514)
// the what-if sweep's per-chunk solve and its warm base solve.  Inputs:
// one topology as a dst-sorted edge list (src, dst, w, lid, transit_src_ok
// [E]: edge ok and its src may transit), fails [B, K] (snapshot b fails
// every link of row b at once; -1 pads), the plan's per-link affected
// bitsets aff [L, ceil(V/32)], the base solve (dist [V], lanes [V, D] 0/1
// int8) and its pull-mode lane tables (slot v*din + k: v's k-th valid
// in-edge; seed_* the root out-edges).  For each snapshot:
//   1. affected vertices = OR over the set's links of their bitsets; the
//      seed is BIG there and the base distance elsewhere
//   2. an edge is enabled iff transit_src_ok and its lid differs from
//      EVERY member of the set (a -1 pad equals the -1 lid of a padding
//      edge, which transit_src_ok already disables), and Bellman-Ford runs
//      from the seed
//   3. DAG membership: enabled, d[dst] < BIG and d[src] + w == d[dst]
//   4. lanes with RESET semantics: each round REPLACES every (v, lane)
//      word by seed | OR over v's non-root in-slots of (lane word of the
//      slot's neighbour & the slot's membership word), from the base
//      lanes masked off the affected vertices
// Outputs: dist [V, B] f32, lanes [V, D, B/32] uint32 (bit b % 32 of
// word b / 32 is snapshot b), round counts per word.
//
// Design: one thread block per 32-snapshot word.  For the distances a
// warp lane is a snapshot: a warp's reads of d[src, word*32 + lane] are
// one coalesced line of the batch-minor table, and __ballot_sync turns
// the 32 lanes' affected and DAG-membership flags straight into the
// packed words the lane phase needs.  The lane phase works on whole
// words (32 snapshots per bitwise OR), one thread per (vertex, lane).
// Each block runs its own fixed points and stops on a block-wide changed
// vote: no grid-wide sync.
//
//  * distances are updated in place (Gauss-Seidel): the relaxation
//    converges to min_u (d0[u] + path(u -> v)) in any order, so only the
//    round count differs from the reference's synchronous rounds.
//  * lanes are synchronous rounds in two word planes (ping-pong), exactly
//    the reference's iteration: its reset-semantics update has a unique
//    fixed point only while every DAG edge strictly increases distance,
//    and synchronous rounds need no such argument.
//  * the seed scatter is an atomicMax per (vertex, lane), the reference's
//    .at[].max (each pair occurs once, one root out-edge per lane).
//
// What bounds it: latency.  The distance rounds run for the depth of the
// word's deepest affected region, the lane rounds for its DAG depth; the
// per-word planes (membership words per pull slot, three lane planes)
// live in device memory and stay in L2.
//
// Traps: BIG + w rounds to BIG; never built with --use_fast_math.
// Pointers that are read while written are not __restrict__.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// edge enabled for a snapshot whose failure set is `fails` [K]
__device__ __forceinline__ bool enabled(int lid, const int32_t* fails, int K) {
  for (int k = 0; k < K; ++k)
    if (lid == fails[k]) return false;
  return true;
}

__global__ void __launch_bounds__(kThreads) repair_sweep_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const int32_t* __restrict__ lid,
    const uint8_t* __restrict__ tsok, const int32_t* __restrict__ fails,
    const uint32_t* __restrict__ aff_table,
    const float* __restrict__ base_dist, const int8_t* __restrict__ base_nh,
    const int32_t* __restrict__ nbr_flat, const int32_t* __restrict__ pull_perm,
    const uint8_t* __restrict__ pull_valid,
    const uint8_t* __restrict__ nbr_is_root, const int32_t* __restrict__ seed_v,
    const int32_t* __restrict__ seed_r, const int32_t* __restrict__ seed_slot,
    const int32_t* __restrict__ seg_off, uint32_t* on_pull,
    uint32_t* lane_planes, float* dist, uint32_t* __restrict__ nh_out,
    int32_t* __restrict__ rounds_d, int32_t* __restrict__ rounds_l, int V,
    int E, int B, int K, int D, int din, int S, float big) {
  extern __shared__ int32_t smem[];
  int32_t* seg_end = smem;                            // [V]
  uint32_t* naff = reinterpret_cast<uint32_t*>(smem + V);  // [V]
  int32_t* set = smem + 2 * V;                        // [32, K]
  const int word = blockIdx.x;
  const int Bw = B / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t col = (size_t)word * 32 + lane;
  const int Vw = (V + 31) / 32;
  const int VD = V * D;
  const int VS = V * din;
  uint32_t* onp = on_pull + (size_t)word * VS;
  uint32_t* seed = lane_planes + (size_t)word * 3 * VD;
  uint32_t* cur = seed + VD;
  uint32_t* nxt = cur + VD;

  for (int i = threadIdx.x; i < 32 * K; i += blockDim.x)
    set[i] = fails[(size_t)word * 32 * K + i];
  for (int v = threadIdx.x; v < V; v += blockDim.x) seg_end[v] = seg_off[v];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (tsok[e]) atomicMax(&seg_end[dst[e]], e + 1);
  const int32_t* mine = set + lane * K;

  // 1. affected vertices: the seed, and the non-affected words
  for (int v = warp; v < V; v += nwarps) {
    uint32_t bits = 0;
    for (int k = 0; k < K; ++k) {
      const int f = mine[k];
      if (f >= 0) bits |= aff_table[(size_t)f * Vw + (v >> 5)];
    }
    const bool affected = (bits >> (v & 31)) & 1u;
    dist[(size_t)v * B + col] = affected ? big : base_dist[v];
    const uint32_t not_affected = __ballot_sync(kFull, !affected);
    if (lane == 0) naff[v] = not_affected;
  }
  __syncthreads();

  // 2. distances, in place
  int rd = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int v = warp; v < V; v += nwarps) {
      const float cur_d = dist[(size_t)v * B + col];
      float best = cur_d;
      for (int e = seg_off[v]; e < seg_end[v]; ++e)
        if (tsok[e] && enabled(lid[e], mine, K))
          best = fminf(best, dist[(size_t)src[e] * B + col] + w[e]);
      if (best < cur_d) {
        dist[(size_t)v * B + col] = best;
        changed = 1;
      }
    }
    ++rd;
    if (!__syncthreads_or(changed)) break;
  }

  // 3. DAG membership word of every pull slot
  for (int slot = warp; slot < VS; slot += nwarps) {
    bool on = false;
    if (pull_valid[slot]) {
      const int e = pull_perm[slot];
      if (tsok[e] && enabled(lid[e], mine, K)) {
        const float dd = dist[(size_t)dst[e] * B + col];
        on = dd < big && dist[(size_t)src[e] * B + col] + w[e] == dd;
      }
    }
    const uint32_t member = __ballot_sync(kFull, on);
    if (lane == 0) onp[slot] = member;
  }
  for (int i = threadIdx.x; i < VD; i += blockDim.x) seed[i] = 0;
  __syncthreads();

  // 4. seeds: a root out-edge's membership word at its head, its lane
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int r = seed_r[s];
    if (r >= 0 && r < D)
      atomicMax(&seed[(size_t)seed_v[s] * D + r], onp[seed_slot[s]]);
  }
  __syncthreads();

  // 5. warm lane init: base lanes masked off the affected vertices
  for (int i = threadIdx.x; i < VD; i += blockDim.x) {
    const uint32_t mask = 0u - (uint32_t)(int32_t)base_nh[i];
    cur[i] = (mask & naff[i / D]) | seed[i];
  }
  __syncthreads();

  // 6. reset-semantics lane rounds, synchronous (cur -> nxt, then swap)
  int rl = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < VD; i += blockDim.x) {
      const int v = i / D;
      const int l = i - v * D;
      uint32_t acc = seed[i];
      for (int slot = v * din; slot < (v + 1) * din; ++slot) {
        if (nbr_is_root[slot]) continue;
        const uint32_t member = onp[slot];
        if (member) acc |= cur[(size_t)nbr_flat[slot] * D + l] & member;
      }
      nxt[i] = acc;
      changed |= acc != cur[i];
    }
    ++rl;
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!__syncthreads_or(changed)) break;
  }

  for (int i = threadIdx.x; i < VD; i += blockDim.x)
    nh_out[(size_t)i * Bw + word] = cur[i];
  if (threadIdx.x == 0) {
    rounds_d[word] = rd;
    rounds_l[word] = rl;
  }
}

}  // namespace

extern "C" int openr_repair_sweep(
    const void* src, const void* dst, const void* w, const void* lid,
    const void* transit_src_ok, const void* fails, const void* aff_table,
    const void* base_dist, const void* base_nh, const void* nbr_flat,
    const void* pull_perm, const void* pull_valid, const void* nbr_is_root,
    const void* seed_v, const void* seed_r, const void* seed_slot,
    const void* seg_off, void* on_pull, void* lane_planes, void* dist,
    void* nh, void* rounds_d, void* rounds_l, int V, int E, int B, int K,
    int D, int din, int S, float big, void* stream) {
  const size_t smem = (size_t)(2 * V + 32 * K) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      repair_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  repair_sweep_kernel<<<B / 32, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w,
      (const int32_t*)lid, (const uint8_t*)transit_src_ok,
      (const int32_t*)fails, (const uint32_t*)aff_table,
      (const float*)base_dist, (const int8_t*)base_nh,
      (const int32_t*)nbr_flat, (const int32_t*)pull_perm,
      (const uint8_t*)pull_valid, (const uint8_t*)nbr_is_root,
      (const int32_t*)seed_v, (const int32_t*)seed_r,
      (const int32_t*)seed_slot, (const int32_t*)seg_off,
      (uint32_t*)on_pull, (uint32_t*)lane_planes, (float*)dist,
      (uint32_t*)nh, (int32_t*)rounds_d, (int32_t*)rounds_l, V, E, B, K, D,
      din, S, big);
  return (int)cudaGetLastError();
}
