// Warm repair of B link-failure sets for Hopper (sm_90a): kernel 9.
//
// Replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/repair.py:367 _repair_sweep_impl (jit at :514)
// the what-if sweep's per-chunk solve and its warm base solve.  Inputs:
// one topology as a dst-sorted edge list (src, w, lid, transit_src_ok [E]:
// edge ok and its src may transit; seg_off [V + 1], each vertex's run,
// derived by the launcher from dst), fails [B, K] (snapshot b fails
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
// Design: the work of one 32-snapshot word is its LIST, the union of its
// snapshots' affected vertices, ranked by a block scan over the union's
// words (block_offsets, frontier.cuh).  With an exact base (the plan's
// own solve) a vertex outside the union keeps its distance and its lanes
// in every snapshot of the word: no base shortest path to it crosses a
// failed link (a path crossing failed edge x->y would make it a DAG
// descendant of y), so every one survives and none is new.  So the
// distance rounds, the DAG membership of the pull slots and the lane
// rounds run over the listed vertices only, and an unlisted vertex is
// written from the base.  With a warm seed (LinkFailureSweep's warm base
// solve: an over-estimate, lanes possibly zero) added or cheapened links
// lower distances anywhere, so the caller says so (`all_listed`) and every
// vertex is listed; the kernel never infers it from an empty union.
//
// A word runs on a thread block cluster of C blocks (C = 1, 2, 4 or 8; a
// cluster's blocks run at once, on SMs of one GPC): the blocks rank the
// same list and each owns the listed vertices j with j % C == its rank.
// An owned vertex's state lives in the owner's shared memory where the
// list fits, read by the other blocks as distributed shared memory, else
// in the owner's slice of a global scratch: 32 distance columns, its
// not-affected word, and the sources the rounds read, gathered once.  An
// unlisted source is final (its base distance, its base lanes in every
// snapshot), so it is relaxed once into the seed distances, and its lane
// contribution ORed once into the seed words; the rounds walk only the
// listed sources (in-edges that may relax, then the non-root pull slots on
// the DAG in some snapshot of the word), with no global load.  A round
// ends on cluster.sync() and a vote over the blocks' changed flags (two
// slots, by round parity).  For the distances a warp lane is a snapshot:
// __ballot_sync turns the 32 lanes' affected and DAG-membership flags
// straight into the packed words the lane phase needs, which works on
// whole words (32 snapshots per bitwise OR), one thread per (owned vertex,
// lane).
//
//  * distances are updated in place (Gauss-Seidel): the relaxation
//    converges to min_u (d0[u] + path(u -> v)) in any order, so only the
//    round count differs from the reference's synchronous rounds.  A round
//    in which no block changed anything read one consistent state.
//  * lanes are synchronous rounds in two word planes (ping-pong), exactly
//    the reference's iteration on the listed vertices, from its initial
//    words: its reset-semantics update has a unique fixed point only while
//    every DAG edge strictly increases distance, and synchronous rounds
//    need no such argument.  An unlisted vertex holds its base lanes from
//    the reference's first round on (its DAG in-neighbours are unlisted
//    too, and its seed is within its base lanes).
//  * the seed scatter is an atomicMax per (vertex, lane), the reference's
//    .at[].max (each pair occurs once, one root out-edge per lane).
//
// What bounds it: latency.  The distance rounds run for the depth of the
// word's deepest affected region, the lane rounds for its DAG depth, each
// round over the word's list; the launch takes as long as its largest
// list, which the cluster spreads over C SMs.
//
// Traps: BIG + w rounds to BIG; never built with --use_fast_math.
// Pointers that are read while written are not __restrict__; state that
// other blocks write is read through volatile pointers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;

// edge enabled for a snapshot whose failure set is `fails` [K]
__device__ __forceinline__ bool enabled(int lid, const int32_t* fails, int K) {
  for (int k = 0; k < K; ++k)
    if (lid == fails[k]) return false;
  return true;
}

// Ints of a block's fixed shared head: the word's sets [32 K], the list's
// union words and their ranks [ceil(V / 32)] each, scan counts [T + 1],
// rounded up to whole 16-byte words.
__host__ __device__ inline size_t head_ints(int V, int K, int T) {
  return ((size_t)32 * K + 2 * (((size_t)V + 31) / 32) + T + 1 + 3) / 4 * 4;
}

// Ints of one owned vertex's state: distances [32], vertex, its listed
// in-edges' and active lane sources' counts, not-affected word, then a
// region of max(4 din, 3 din + 3 D): first its listed in-edges (the
// address of the source's distance column [din] as 64 bits, bits of w,
// link id [din] each) for the distance rounds, then, over them, its active
// lane sources' addresses (of their plane-0 words) [din] as 64 bits, its
// pull slots' membership words [din], its seed words and two lane planes
// [D] each.
__host__ __device__ inline size_t region_ints(int D, int din) {
  const size_t lanes = 3 * (size_t)din + 3 * (size_t)D;
  return 4 * (size_t)din > lanes ? 4 * (size_t)din : lanes;
}
// (even, so that every slice of the global scratch keeps the addresses
// 8-byte aligned)
__host__ __device__ inline size_t vertex_ints(int D, int din) {
  return (32 + 4 + region_ints(D, din) + 1) / 2 * 2;
}

// One block's state for up to `cap` owned vertices, struct of arrays from
// `base` (its own shared memory, another block's shared memory, or a slice
// of the global scratch; 8-byte aligned).  What other blocks read (the
// distances and the lane planes) is volatile.
struct Owned {
  volatile float* d;
  int32_t* vtx;
  int32_t* n_in;
  int32_t* n_act;
  uint32_t* naff;
  const volatile float** in_p;  // the distance rounds' in-edges ...
  int32_t* in_w;
  int32_t* in_l;
  const volatile uint32_t** act_p;  // ... then, over them, the lane rounds'
  uint32_t* onp;
  uint32_t* seed;
  volatile uint32_t* plane[2];

  __device__ Owned(int32_t* base, int cap, int D, int din) {
    d = reinterpret_cast<float*>(base);
    vtx = base + (size_t)32 * cap;
    n_in = vtx + cap;
    n_act = n_in + cap;
    naff = reinterpret_cast<uint32_t*>(n_act + cap);
    int32_t* region = reinterpret_cast<int32_t*>(naff + cap);
    in_p = reinterpret_cast<const volatile float**>(region);
    in_w = region + 2 * (size_t)din * cap;
    in_l = in_w + (size_t)din * cap;
    act_p = reinterpret_cast<const volatile uint32_t**>(region);
    onp = reinterpret_cast<uint32_t*>(region + 2 * (size_t)din * cap);
    seed = onp + (size_t)din * cap;
    plane[0] = seed + (size_t)D * cap;
    plane[1] = plane[0] + (size_t)D * cap;
  }
};

__global__ void __launch_bounds__(1024) repair_sweep_kernel(
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const int32_t* __restrict__ lid, const uint8_t* __restrict__ tsok,
    const int32_t* __restrict__ fails, const uint32_t* __restrict__ aff_table,
    const float* __restrict__ base_dist, const int8_t* __restrict__ base_nh,
    const int32_t* __restrict__ nbr_flat, const int32_t* __restrict__ pull_perm,
    const uint8_t* __restrict__ pull_valid,
    const uint8_t* __restrict__ nbr_is_root, const int32_t* __restrict__ seed_v,
    const int32_t* __restrict__ seed_r, const int32_t* __restrict__ seed_slot,
    const int32_t* __restrict__ seg_off, int32_t* scratch, float* dist,
    uint32_t* __restrict__ nh_out, int32_t* __restrict__ rounds_d,
    int32_t* __restrict__ rounds_l, int V, int B, int K, int D, int din, int S,
    int all_listed, int cshift, int cap_shared, float big) {
  extern __shared__ int32_t smem[];
  __shared__ int votes[2];
  __shared__ int32_t* bases[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = 1 << cshift;
  const int rank = (int)cluster.block_rank();
  const int Bw = B / 32;
  // the words from the last: a depth-sorted batch (LinkFailureSweep sorts
  // its solves shallow first) starts its deepest words first
  const int word = Bw - 1 - (int)(blockIdx.x >> cshift);
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = T >> 5;
  const size_t col = (size_t)word * 32 + lane;
  const int Vw = (V + 31) / 32;
  int32_t* set = smem;                                   // [32, K]
  uint32_t* uw = reinterpret_cast<uint32_t*>(set + 32 * K);  // [Vw]
  int32_t* pre = reinterpret_cast<int32_t*>(uw + Vw);   // [Vw]
  int32_t* counts = pre + Vw;                            // [T + 1]
  int32_t* state = smem + head_ints(V, K, T);

  for (int i = threadIdx.x; i < 32 * K; i += T) set[i] = fails[(size_t)word * 32 * K + i];
  __syncthreads();
  const int32_t* mine = set + lane * K;

  // 1. the list: the union of the word's affected sets (every vertex when
  // the base is a warm seed; a warp a union word, a lane a snapshot),
  // ranked by words
  for (int i = warp; i < Vw; i += nwarps) {
    uint32_t u = i == Vw - 1 && (V & 31) ? (1u << (V & 31)) - 1 : kFull;
    if (!all_listed) {
      u = 0;
      for (int k = 0; k < K; ++k) {
        const int f = mine[k];
        if (f >= 0) u |= aff_table[(size_t)f * Vw + i];
      }
      u = __reduce_or_sync(kFull, u);
    }
    if (lane == 0) uw[i] = u;
  }
  __syncthreads();
  const int n = block_offsets(
      counts, Vw, [&](int i) { return __popc(uw[i]); }, [&](int i, int o) { pre[i] = o; });
  // the listed index of vertex s, -1 if unlisted
  const auto pos = [&](int s) -> int {
    const uint32_t bits = uw[s >> 5];
    const uint32_t bit = 1u << (s & 31);
    return bits & bit ? pre[s >> 5] + __popc(bits & (bit - 1)) : -1;
  };

  // 2. where the owned state lives: each block's shared memory where the
  // list fits, else its slice of the global scratch (cap: ceil(V / C))
  const int own_n = (n - rank + C - 1) >> cshift;
  const bool shared = ((n + C - 1) >> cshift) <= cap_shared;
  const int cap = shared ? cap_shared : (V + C - 1) >> cshift;
  if (threadIdx.x < C) {
    const int r = threadIdx.x;
    bases[r] = !shared   ? scratch + ((size_t)word * C + r) * cap * vertex_ints(D, din)
               : r == rank ? state
                           : cluster.map_shared_rank(state, r);
  }
  __syncthreads();
  const Owned own(bases[rank], cap, D, din);
  // every block's state, by rank (own included)
  const auto of = [&](int r) { return Owned(bases[r], cap, D, din); };
  // a listed vertex's distance column and plane-0 words, at its owner
  const auto column = [&](int j) { return of(j & (C - 1)).d + (size_t)(j >> cshift) * 32; };
  const auto words = [&](int j) { return of(j & (C - 1)).plane[0] + (size_t)(j >> cshift) * D; };
  const size_t plane_stride = (size_t)D * cap;

  // 3. the owned vertices; each one's seed distances and not-affected
  // word; its in-edges that may relax (its run in the dst-sorted list, 32
  // at a time, a lane an edge) from listed sources as a list, from unlisted
  // ones (final at their base distance) relaxed here once
  for (int i = threadIdx.x; i < Vw; i += T) {
    uint32_t bits = uw[i];
    for (int j = pre[i]; bits; bits &= bits - 1, ++j)
      if ((j & (C - 1)) == rank) own.vtx[j >> cshift] = i * 32 + __ffs(bits) - 1;
  }
  __syncthreads();
  for (int jl = warp; jl < own_n; jl += nwarps) {
    const int v = own.vtx[jl];
    uint32_t bits = 0;
    for (int k = 0; k < K; ++k) {
      const int f = mine[k];
      if (f >= 0) bits |= aff_table[(size_t)f * Vw + (v >> 5)];
    }
    const bool affected = (bits >> (v & 31)) & 1u;
    float dv = affected ? big : base_dist[v];
    const uint32_t not_affected = __ballot_sync(kFull, !affected);
    const int end = seg_off[v + 1];
    int listed = 0;
    for (int e0 = seg_off[v]; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      const bool ok = e < end && tsok[e];
      const int s = ok ? src[e] : 0;
      const int j = ok ? pos(s) : -1;
      const float we = ok ? w[e] : 0.f;
      const int le = ok ? lid[e] : 0;
      const float bs = ok && j < 0 ? base_dist[s] : 0.f;
      const uint32_t in_list = __ballot_sync(kFull, ok && j >= 0);
      if (ok && j >= 0) {
        const size_t at = (size_t)(listed + __popc(in_list & ((1u << lane) - 1))) * cap + jl;
        own.in_p[at] = column(j);
        own.in_w[at] = __float_as_int(we);
        own.in_l[at] = le;
      }
      listed += __popc(in_list);
      for (uint32_t from = __ballot_sync(kFull, ok && j < 0); from; from &= from - 1) {
        const int q = __ffs(from) - 1;
        const int lq = __shfl_sync(kFull, le, q);
        const float cand = __shfl_sync(kFull, bs, q) + __shfl_sync(kFull, we, q);
        if (enabled(lq, mine, K)) dv = fminf(dv, cand);
      }
    }
    own.d[(size_t)jl * 32 + lane] = dv;
    if (lane == 0) {
      own.naff[jl] = not_affected;
      own.n_in[jl] = listed;
    }
  }

  // a round's vote: each block's changed flag in its slot of the round's
  // parity, read by every block after the cluster barrier (a slot is
  // rewritten two rounds later, past the next barrier)
  const auto cluster_any = [&](int changed, int round) {
    const int mine_changed = __syncthreads_or(changed);
    if (threadIdx.x == 0) votes[round & 1] = mine_changed;
    cluster.sync();
    int any = 0;
    if (threadIdx.x < C)
      any = *(volatile int*)cluster.map_shared_rank(&votes[round & 1], (int)threadIdx.x);
    return __syncthreads_or(any);
  };
  cluster.sync();

  // 4. distances over the owned vertices' listed in-edges, in place,
  // until no block changes
  int rd = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int jl = warp; jl < own_n; jl += nwarps) {
      const float cur_d = own.d[(size_t)jl * 32 + lane];
      float best = cur_d;
      const int m = own.n_in[jl];
      // kBatch in-edges at a time: their loads issued before any is used
      for (int c0 = 0; c0 < m; c0 += kBatch) {
        const volatile float* at_p[kBatch];
        float we[kBatch], dj[kBatch];
        bool on[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const size_t at = (size_t)(c0 + k < m ? c0 + k : c0) * cap + jl;
          at_p[k] = own.in_p[at];
          we[k] = __int_as_float(own.in_w[at]);
          on[k] = c0 + k < m && enabled(own.in_l[at], mine, K);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) dj[k] = at_p[k][lane];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (on[k]) best = fminf(best, dj[k] + we[k]);
      }
      if (best < cur_d) {
        own.d[(size_t)jl * 32 + lane] = best;
        changed = 1;
      }
    }
    ++rd;
    if (!cluster_any(changed, round)) break;
  }

  // 5. the DAG membership word of every pull slot of the owned vertices
  // (over the distance rounds' lists, read no more): each slot's edge
  // loaded by a lane, 32 slots at a time, then a ballot per slot, kBatch
  // slots' source distances loaded at a time (an unlisted source's base
  // distance read at a stride of 0)
  for (int jl = warp; jl < own_n; jl += nwarps) {
    const int v = own.vtx[jl];
    const float dv = own.d[(size_t)jl * 32 + lane];
    for (int k0 = 0; k0 < din; k0 += 32) {
      const int k = k0 + lane;
      bool ok = k < din && pull_valid[v * din + k];
      const int e = ok ? pull_perm[v * din + k] : 0;
      ok = ok && tsok[e];
      const int s = ok ? src[e] : 0;
      const int j = ok ? pos(s) : -1;
      const float we = ok ? w[e] : 0.f;
      const int le = ok ? lid[e] : 0;
      const volatile float* from = j >= 0 ? column(j) : base_dist + s;
      const uint32_t slots = __ballot_sync(kFull, ok);
      uint32_t mine_member = 0;
      const int kn = din - k0 < 32 ? din - k0 : 32;
      for (int q0 = 0; q0 < kn; q0 += kBatch) {
        float dq[kBatch], wq[kBatch];
        int lq[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const int q = q0 + t < kn ? q0 + t : q0;
          const volatile float* fq = reinterpret_cast<const volatile float*>(
              __shfl_sync(kFull, reinterpret_cast<unsigned long long>(from), q));
          const int stride = __shfl_sync(kFull, j, q) >= 0 ? 1 : 0;
          dq[t] = fq[lane * stride];
          wq[t] = __shfl_sync(kFull, we, q);
          lq[t] = __shfl_sync(kFull, le, q);
        }
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const int q = q0 + t;
          const bool on = q < kn && ((slots >> q) & 1u) && dv < big &&
                          enabled(lq[t], mine, K) && dq[t] + wq[t] == dv;
          const uint32_t member = __ballot_sync(kFull, on);
          if (lane == q) mine_member = member;
        }
      }
      if (k < din) own.onp[(size_t)k * cap + jl] = mine_member;
    }
  }
  for (int i = threadIdx.x; i < own_n * D; i += T) own.seed[i] = 0;
  __syncthreads();

  // 6. seeds: a root out-edge's membership word at its head, its lane
  for (int s = threadIdx.x; s < S; s += T) {
    const int v = seed_v[s];
    const int j = pos(v);
    const int r = seed_r[s];
    if (j >= 0 && (j & (C - 1)) == rank && r >= 0 && r < D) {
      const int jl = j >> cshift;
      atomicMax(&own.seed[(size_t)jl * D + r],
                own.onp[(size_t)(seed_slot[s] - v * din) * cap + jl]);
    }
  }
  __syncthreads();

  // 7. warm lane init: base lanes masked off the affected vertices
  for (int i = threadIdx.x; i < own_n * D; i += T) {
    const int jl = i / D;
    const uint32_t mask = 0u - (uint32_t)(int32_t)base_nh[(size_t)own.vtx[jl] * D + (i - jl * D)];
    own.plane[0][i] = (mask & own.naff[jl]) | own.seed[i];
  }
  __syncthreads();

  // 8. each owned vertex's active lane sources (a non-root in-slot on the
  // DAG in some snapshot), compacted in place, a lane a slot: a listed
  // source by its listed index; an unlisted one, whose words are its base
  // lanes in every round, ORed into the seeds the rounds read
  for (int jl = warp; jl < own_n; jl += nwarps) {
    const int v = own.vtx[jl];
    int act = 0;
    for (int k0 = 0; k0 < din; k0 += 32) {
      const int k = k0 + lane;
      uint32_t member = k < din ? own.onp[(size_t)k * cap + jl] : 0u;
      if (member && nbr_is_root[v * din + k]) member = 0;
      const int u = member ? nbr_flat[v * din + k] : 0;
      const int j = member ? pos(u) : -1;
      __syncwarp();  // every slot of the chunk read before the compacted writes
      const uint32_t listed = __ballot_sync(kFull, member && j >= 0);
      if (member && j >= 0) {
        const size_t at = (size_t)(act + __popc(listed & ((1u << lane) - 1))) * cap + jl;
        own.onp[at] = member;
        own.act_p[at] = words(j);
      }
      act += __popc(listed);
      for (uint32_t from = __ballot_sync(kFull, member && j < 0); from; from &= from - 1) {
        const int q = __ffs(from) - 1;
        const int uq = __shfl_sync(kFull, u, q);
        const uint32_t mq = __shfl_sync(kFull, member, q);
        for (int l = lane; l < D; l += 32)
          own.seed[(size_t)jl * D + l] |= (0u - (uint32_t)(int32_t)base_nh[(size_t)uq * D + l]) & mq;
      }
    }
    if (lane == 0) own.n_act[jl] = act;
  }
  cluster.sync();

  // 9. reset-semantics lane rounds, synchronous (plane p -> 1 - p), over
  // each owned (vertex, lane) and its active listed sources
  int rl = 0;
  int p = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < own_n * D; i += T) {
      const int jl = i / D;
      const int l = i - jl * D;
      uint32_t acc = own.seed[i];
      const int m = own.n_act[jl];
      const size_t off = p * plane_stride + l;
      // kBatch sources at a time: their loads issued before any is used
      for (int c0 = 0; c0 < m; c0 += kBatch) {
        const volatile uint32_t* at_p[kBatch];
        uint32_t member[kBatch], x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const size_t at = (size_t)(c0 + k < m ? c0 + k : c0) * cap + jl;
          at_p[k] = own.act_p[at];
          member[k] = c0 + k < m ? own.onp[at] : 0u;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) x[k] = at_p[k][off];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) acc |= x[k] & member[k];
      }
      own.plane[1 - p][i] = acc;
      changed |= acc != own.plane[p][i];
    }
    ++rl;
    p = 1 - p;
    if (!cluster_any(changed, round)) break;
  }

  // 10. the outputs: the owned vertices from their state, the unlisted
  // ones (split over the cluster by vertex) from the base
  for (int jl = warp; jl < own_n; jl += nwarps)
    dist[(size_t)own.vtx[jl] * B + col] = own.d[(size_t)jl * 32 + lane];
  for (int i = threadIdx.x; i < own_n * D; i += T) {
    const int jl = i / D;
    nh_out[((size_t)own.vtx[jl] * D + (i - jl * D)) * Bw + word] = own.plane[p][i];
  }
  for (int v = warp * C + rank; v < V; v += nwarps * C)
    if (pos(v) < 0) dist[(size_t)v * B + col] = base_dist[v];
  for (int i = threadIdx.x; i < V * D; i += T) {
    const int v = i / D;
    if ((v & (C - 1)) == rank && pos(v) < 0)
      nh_out[(size_t)i * Bw + word] = 0u - (uint32_t)(int32_t)base_nh[i];
  }
  if (threadIdx.x == 0 && rank == 0) {
    rounds_d[word] = rd;
    rounds_l[word] = rl;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

extern "C" int openr_repair_sweep(
    const void* src, const void* w, const void* lid,
    const void* transit_src_ok, const void* fails, const void* aff_table,
    const void* base_dist, const void* base_nh, const void* nbr_flat,
    const void* pull_perm, const void* pull_valid, const void* nbr_is_root,
    const void* seed_v, const void* seed_r, const void* seed_slot,
    const void* seg_off, void* scratch, void* dist, void* nh, void* rounds_d,
    void* rounds_l, int V, int B, int K, int D, int din, int S,
    int all_listed, int threads, int cluster, int cap_shared, float big,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  int cshift = 0;
  while ((1 << cshift) < cluster) ++cshift;
  if ((1 << cshift) != cluster || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  const size_t smem = (head_ints(V, K, threads) + (size_t)cap_shared * vertex_ints(D, din)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      repair_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B / 32 * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, repair_sweep_kernel, (const int32_t*)src, (const float*)w,
      (const int32_t*)lid, (const uint8_t*)transit_src_ok, (const int32_t*)fails,
      (const uint32_t*)aff_table, (const float*)base_dist, (const int8_t*)base_nh,
      (const int32_t*)nbr_flat, (const int32_t*)pull_perm, (const uint8_t*)pull_valid,
      (const uint8_t*)nbr_is_root, (const int32_t*)seed_v, (const int32_t*)seed_r,
      (const int32_t*)seed_slot, (const int32_t*)seg_off, (int32_t*)scratch, (float*)dist,
      (uint32_t*)nh,
      (int32_t*)rounds_d, (int32_t*)rounds_l, V, B, K, D, din, S, all_listed, cshift,
      cap_shared, big);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
