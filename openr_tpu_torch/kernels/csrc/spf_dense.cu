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
// Kernel 1: a packed in-edge list per block, and a thread block cluster
// per area where the area is large.  An area's vertices are split into C
// slices of S = ceil(V / C) (C = 1, 2, 4 or 8, the launcher's rule from V
// and the plane's slot count V * K, or forced); block r of the area's
// cluster owns slice r.  The block first packs its slice's usable
// in-slots, the transit rule folded in (in_ok and its source not
// overloaded or the root: the reference's `ok`, openr_tpu/ops/spf.py:304),
// into one 8-byte record {source, bits of w} each, so padding and down
// slots are never read again.  The records are stored by group of 32
// consecutive vertices, as many rows of 32 as the group's largest usable
// in-degree: a vertex's u-th record at its group's run + 32 u + its lane,
// so a warp's lanes read consecutive records (no bank conflict), and each
// vertex's head {first record, in-degree} is one 8-byte load.  The
// records live in shared memory where the block's count fits what the
// launcher left (`cap_shared`), else in the block's slice of a global
// scratch that the launcher holds; the block decides from its own count,
// which only the card knows.  Every block holds the whole area's
// distances in shared memory, so a relaxation reads only local memory: a
// block relaxes its own slice, and each improvement it makes is stored
// into the other blocks' copies too (distributed shared memory; nothing
// waits on those stores).  Rounds run in place (Gauss-Seidel), `sweeps`
// of them between two votes, a block-wide __syncthreads_or and, with
// C > 1, a flag that a block which changed something sets in every block
// (two slots, by vote parity), read past one cluster.sync(), which also
// makes every remote store before it visible.  A vote's rounds in which
// no block changed anything read a constant state, every copy equal to
// its owners' values, so all blocks stop together and only then.
// In-place updates and racy reads of a neighbour's value reach the
// reference's table bit for bit: the iteration is monotone with a unique
// fixed point, and integral link metrics keep every f32 path sum exact.
// Skipping an unusable slot is exact too: its term d[src] + BIG is never
// below the current value.  What bounds it: latency, one vote every
// `sweeps` rounds for the hop depth from the root (126 rounds from node0
// on the 64 x 64 grid, 48 on the KSP2 backbone); a round costs the
// instructions of its relaxations (a few per usable slot, the records'
// loads batched so they overlap), a vote the barriers.

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
// else the bit.  (The rounds and the writer, or_word_rounds and
// write_word_lanes in frontier.cuh, are shared with kernel 5.)  Why OR is exact: a vertex's reference lanes start at 0 or
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 8;
// dynamic shared memory a kernel-1 block may take beside its static bytes
constexpr size_t kDenseDynamicSmem = 232448 - 256;

__device__ __forceinline__ bool can_transit(const uint8_t* ovl, int s,
                                            int root) {
  return !ovl[s] || s == root;
}

// Kernel 1's block state (dense_dist_fixed_ints), in 16-byte words: the
// area's distances [V] (during the packing, the slice's usable-slot masks
// where it takes 4-slot words), its slice's vertices' heads [S] {first record, usable
// in-degree}, the first record of each 32-vertex group [ceil(S / 32) + 1]
// and scan counts [kThreads + 1]; then room for `cap_shared` records
// (int2) where the launcher left it.
__host__ __device__ inline size_t dense_dist_fixed_ints(int V, int S) {
  const size_t G = ((size_t)S + 31) / 32;
  return ((size_t)V + (V & 1) + 2 * (size_t)S + G + 1 + kThreads + 1 + 3) / 4 * 4;
}

// records a thread loads at once in a round, so their loads overlap
constexpr int kRecordBatch = 4;

template <bool kCluster>
__global__ void __launch_bounds__(kThreads) dense_spf_distances_kernel(
    const int32_t* __restrict__ in_src, const float* __restrict__ in_w,
    const uint8_t* __restrict__ in_ok, const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, float* __restrict__ dist_out,
    int2* scratch, int V, int K, int C, int S, int cap_shared, int sweeps, float big) {
  extern __shared__ int32_t smem[];
  __shared__ int votes[2];
  __shared__ float* copies[kMaxCluster];
  constexpr int T = kThreads;
  int rank = 0;
  if constexpr (kCluster) rank = (int)cg::this_cluster().block_rank();
  const int a = blockIdx.x / C;
  const int lo = rank * S;
  const int n = max(0, min(S, V - lo));  // the owned slice [lo, lo + n)
  const int G = (n + 31) / 32;
  float* d = reinterpret_cast<float*>(smem);             // the area's [V]
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem);  // d's room, until d is set
  int2* heads = reinterpret_cast<int2*>(smem + V + (V & 1));
  int32_t* gbase = reinterpret_cast<int32_t*>(heads + S);
  int32_t* counts = gbase + (S + 31) / 32 + 1;
  const int root = roots[a];
  const size_t plane = (size_t)a * V * K;
  const int32_t* src = in_src + plane;
  const float* w = in_w + plane;
  const uint8_t* ok = in_ok + plane;
  const uint8_t* ovl = overloaded + (size_t)a * V;
  // slot e usable: ok and its source s free to transit
  const auto usable = [&](size_t e, int& s) -> bool {
    if (!ok[e]) return false;
    s = src[e];
    return !ovl[s] || s == root;
  };
  // up to 32 slots a vertex in 4-slot words (the degree buckets' K, where
  // the planes' alignment allows): its usable ones as a bit mask, the ok
  // bytes and sources 4 slots a load; else slot by slot
  const bool by_word = K <= 32 && K % 4 == 0 && (uintptr_t)ok % 4 == 0 && (uintptr_t)src % 16 == 0;

  // 1. each owned vertex's usable slots and in-degree
  for (int j = threadIdx.x; j < n; j += T) {
    const size_t row = (size_t)(lo + j) * K;
    int c = 0;
    if (by_word) {
      uint32_t m = 0;
      for (int q = 0; q < K / 4; ++q) {
        const uint32_t okw = __vcmpne4(reinterpret_cast<const uint32_t*>(ok + row)[q], 0u);
        if (!okw) continue;
        const int4 s4 = reinterpret_cast<const int4*>(src + row)[q];
        const int s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (((okw >> (8 * t)) & 1u) && (!ovl[s[t]] || s[t] == root)) m |= 1u << (4 * q + t);
      }
      masks[j] = m;
      c = __popc(m);
    } else {
      int s;
      for (int k = 0; k < K; ++k) c += usable(row + k, s);
    }
    heads[j].y = c;
  }
  __syncthreads();
  // 2. each group's run, 32 records a row of as many rows as its largest
  // in-degree (a block scan over the groups), and where the records live:
  // shared memory where the block's count fits
  const int M = block_offsets(
      counts, G,
      [&](int g) {
        int most = 0;
        const int end = min(n, g * 32 + 32);
        for (int j = g * 32; j < end; ++j) most = max(most, heads[j].y);
        return 32 * most;
      },
      [&](int g, int o) { gbase[g] = o; });
  int2* rec = M <= cap_shared
                  ? reinterpret_cast<int2*>(smem + dense_dist_fixed_ints(V, S))
                  : scratch + (size_t)blockIdx.x * ((S + 31) / 32 * 32) * K;
  // 3. the records {source, bits of w}: a vertex's u-th usable slot at
  // its group's run + 32 u + its lane, so the lanes of a warp read
  // consecutive records
  for (int j = threadIdx.x; j < n; j += T) {
    const size_t row = (size_t)(lo + j) * K;
    const int at = gbase[j >> 5] + (j & 31);
    const int dj = heads[j].y;
    heads[j].x = at;
    uint32_t m = by_word ? masks[j] : 0u;
    for (int u = 0, k = 0; u < dj; ++u, ++k) {
      int s;
      if (by_word) {
        k = __ffs(m) - 1;
        m &= m - 1;
        s = src[row + k];
      } else {
        while (!usable(row + k, s)) ++k;
      }
      rec[at + 32 * u] = make_int2(s, __float_as_int(w[row + k]));
    }
  }
  __syncthreads();
  // every block holds the whole area's distances: its own slice's are
  // its own, the others' arrive by the owners' remote stores
  for (int v = threadIdx.x; v < V; v += T) d[v] = v == root ? 0.f : big;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    if ((int)threadIdx.x < C) copies[threadIdx.x] = cluster.map_shared_rank(d, (int)threadIdx.x);
    if (threadIdx.x < 2) votes[threadIdx.x] = 0;
    // no block stores into another before that one has set its distances
    cluster.sync();
  } else {
    __syncthreads();
  }

  // 4. sweeps over the records, in place, `sweeps` between two votes,
  // until no block changes in a vote's sweeps (the distances were then
  // constant while every vertex was relaxed).  Between votes no thread
  // waits for another, so only a vote's first sweep is sure to see every
  // write before it: each vote advances at least one synchronous round.
  // The reference stops after at most V rounds, and a shortest path has
  // at most V - 1 edges, so the fixed point is always reached first
  for (int vote = 0; vote < V; ++vote) {
    int changed = 0;
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int j = threadIdx.x; j < n; j += T) {
        const int2 h = heads[j];
        const int v = lo + j;
        const float cur = d[v];
        float best = cur;
        // kRecordBatch records at a time: their loads, then their
        // sources' distances, so the loads overlap
        for (int u0 = 0; u0 < h.y; u0 += kRecordBatch) {
          int2 r[kRecordBatch];
#pragma unroll
          for (int q = 0; q < kRecordBatch; ++q)
            r[q] = u0 + q < h.y ? rec[h.x + 32 * (u0 + q)] : make_int2(0, 0);
#pragma unroll
          for (int q = 0; q < kRecordBatch; ++q)
            if (u0 + q < h.y) best = fminf(best, d[r[q].x] + __int_as_float(r[q].y));
        }
        if (best < cur) {
          d[v] = best;
          changed = 1;
          if constexpr (kCluster) {
            // the other blocks' copies, by stores that nothing waits on
            for (int r = 0; r < C; ++r)
              if (r != rank) reinterpret_cast<volatile float*>(copies[r])[v] = best;
          }
        }
      }
      // later sweeps reload what other threads (and blocks) wrote
      if (sweep + 1 < sweeps) __threadfence_block();
    }
    int any;
    if constexpr (kCluster) {
      // a block that changed something sets the vote's slot (by parity)
      // in every block; past the cluster barrier (which also makes every
      // remote store of the sweeps visible) each block reads its own.  The
      // other slot, the next vote's, was last read before this barrier and
      // is next written past the cluster barrier, so it is cleared here
      cg::cluster_group cluster = cg::this_cluster();
      const int mine = __syncthreads_or(changed);
      if (threadIdx.x == 0) votes[(vote + 1) & 1] = 0;
      if (mine && (int)threadIdx.x < C)
        *reinterpret_cast<volatile int*>(cluster.map_shared_rank(&votes[vote & 1], (int)threadIdx.x)) = 1;
      cluster.sync();
      any = *reinterpret_cast<volatile int*>(&votes[vote & 1]);
    } else {
      any = __syncthreads_or(changed);
    }
    if (!any) break;
  }
  for (int j = threadIdx.x; j < n; j += T) dist_out[(size_t)a * V + lo + j] = d[lo + j];
  // no block leaves while another may still store into its shared memory
  if constexpr (kCluster) cg::this_cluster().sync();
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
  or_word_rounds(words, W, (L + 31) / 32, moving, num_moving, poff, psrc, V);
  // 4. the int8 table, written once: -128 where the vertex is absent from
  // the padded edge list, else its bit (4 lanes a store where D allows)
  write_word_lanes(lanes, words, [&](int v) { return has[v] != 0; }, 0, V, D);
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

extern "C" int openr_dense_spf_distances(
    const void* in_src, const void* in_w, const void* in_ok,
    const void* overloaded, const void* roots, void* dist, void* scratch,
    int A, int V, int K, int cluster, int cap_shared, int sweeps, float big,
    void* stream) {
  if (A == 0) return (int)cudaSuccess;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || sweeps < 1 ||
      cap_shared < 0)
    return (int)cudaErrorInvalidValue;
  const int S = (V + cluster - 1) / cluster;
  // the distances, the slice's heads and the shared records must fit
  const size_t smem = dense_dist_fixed_ints(V, S) * 4 + (size_t)cap_shared * 8;
  if (smem > kDenseDynamicSmem) return (int)cudaErrorInvalidValue;
  const auto kernel =
      cluster > 1 ? dense_spf_distances_kernel<true> : dense_spf_distances_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(A * cluster));
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)in_src, (const float*)in_w,
                           (const uint8_t*)in_ok, (const uint8_t*)overloaded,
                           (const int32_t*)roots, (float*)dist, (int2*)scratch, V, K,
                           cluster, S, cap_shared, sweeps, big);
  if (err != cudaSuccess) return (int)err;
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
