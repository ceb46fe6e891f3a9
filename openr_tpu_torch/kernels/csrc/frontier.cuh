// Device routines shared by the SPF kernels of spf_warm.cu and
// spf_dense.cu: the warp-shuffle block scan (block_offsets, block_ranks),
// the packed OR lane loop (or_lanes), frontier relaxation over a compact
// out-edge list (frontier_distances) and the whole solve of one (root,
// area) pair over that list (frontier_pair, kernels 12, 14 and 16).
//
// Frontier relaxation (kernels 12, 14, 15 and 16).  The topology is a CSR by
// SOURCE of the usable edges only (edge_ok false and padding dropped by
// the launcher; the lists of kernels 14 and 16 keep them as self-loops of
// +inf, which lower nothing): vertex u's out-edges are the slots [off[u], off[u + 1]),
// each an int2 {dst, bits of w}, so one 8-byte load gives both.  Round 0's
// frontier is the root alone; each round relaxes only the out-edges of the
// vertices whose distance fell in the round before, and the solve ends
// when a round lowers nothing.  The work of a round is spread as
// (frontier vertex, out-edge) pairs by a block scan over the frontier's
// out-degrees, so a hub's out-edges spread over the block instead of
// serialising on one thread; each thread takes a contiguous run of pairs
// (one binary search for its first vertex) and issues the loads of
// kBatch pairs before it relaxes them, as it does for the frontier
// vertices' out-slots and degrees, so a round waits on few round trips to
// L2.  The transit rule (an
// overloaded vertex other than the root relaxes nothing) is checked once
// per frontier vertex, as a degree of 0; a per-slot filter (kernel 15's
// and 16's row edge bit, by the slot's edge id; kernel 14's failed set, by the
// slot's link id) once per pair.  d[v] falls by an integer atomicMin on the
// float's bits: distances are >= 0, so integer order is float order.
// Only vertices with d < BIG are ever in a frontier, so BIG + BIG (+inf)
// is never formed.  A lowered v sets its bit in the next round's bitmap;
// the bitmap is ranked by a block scan over its words and listed, at most
// `cap` vertices at a time (the frontier list lives beside the distances
// in shared memory, so a round whose frontier exceeds it runs in chunks).
//
// Why this is exact: every relaxation writes d[u] + w for a usable edge,
// a path length evaluated as the reference does (the f32 sum along the
// path, exact for integral metrics); a vertex whose distance fell is
// relaxed again after the barrier that ends the round, from its final
// value at the latest, so the end state satisfies d[v] <= d[u] + w on every
// usable edge.  That fixed point is unique, so any order of relaxations
// reaches the reference's table bit for bit.  Never built with
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Visits every i < n in index order, calling emit(i, offset) with the sum
// of weight(j) over j < i: a block scan over contiguous chunks.  counts
// holds blockDim.x + 1 ints of scratch (blockDim.x a multiple of 32).
// Returns the sum of every weight; ends with a barrier.
template <class Weight, class Emit>
__device__ int block_offsets(int32_t* counts, int n, Weight weight,
                             Emit emit) {
  const int T = blockDim.x;
  const int chunk = (n + T - 1) / T;
  const int lo = min(n, (int)threadIdx.x * chunk);
  const int hi = min(n, lo + chunk);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += weight(i);
  // exclusive scan of c over the block: within each warp by shuffles, then
  // the warp totals by warp 0 (blockDim.x a multiple of 32)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) counts[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < (T >> 5) ? counts[lane] : 0;
    int ti = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ti, o);
      if (lane >= o) ti += y;
    }
    if (lane < (T >> 5)) counts[lane] = ti - t;
    if (lane == 31) counts[T] = ti;
  }
  __syncthreads();
  int next = counts[warp] + inc - c;
  for (int i = lo; i < hi; ++i) {
    const int k = weight(i);
    emit(i, next);
    next += k;
  }
  __syncthreads();
  return counts[T];
}

// emit(i, rank) with i's rank among the i < n that satisfy pred (-1 where
// pred is false), in index order; returns how many do.
template <class Pred, class Emit>
__device__ int block_ranks(int32_t* counts, int n, Pred pred, Emit emit) {
  return block_offsets(
      counts, n, [&](int i) { return pred(i) ? 1 : 0; },
      [&](int i, int k) { emit(i, pred(i) ? k : -1); });
}

// The packed OR lane loop of frontier_pair (kernels 12, 14 and 16) where
// the live lanes exceed one word: the moving vertices
// (moving[k], k < num_moving) OR-accumulate, over their first L lanes, the
// lanes of their propagating in-edges' sources psrc[poff[k], poff[k + 1]),
// in place until a round changes nothing.  This is the reference's own
// cold update (a lane once set stays set, from the fill and the seeds); on
// the DAG its fixed point above the seeds is unique, so update order does
// not matter.
__device__ void or_lanes(int8_t* nh, const int32_t* moving, int num_moving,
                         const int32_t* poff, const int32_t* psrc, int V,
                         int L, int D) {
  const int n = num_moving * L;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = i / L;
      const int l = i - k * L;
      const size_t at = (size_t)moving[k] * D + l;
      const int cur = nh[at];
      int x = cur;
      for (int j = poff[k]; j < poff[k + 1]; ++j) {
        const int y = nh[(size_t)psrc[j] * D + l];
        x = y > x ? y : x;
      }
      if (x != cur) {
        nh[at] = (int8_t)x;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// The OR rounds of kernels 2 and 5 over bit-word lanes: words [V * W]
// (W uint32 per vertex, bit l % 32 of word l / 32 is lane l), the moving
// vertices (moving[k], k < num_moving) ORing, over their first Wl words
// (the words a seed can reach), the words of their propagating sources
// psrc[poff[k], poff[k + 1]), in place, `sweeps` rounds between two votes,
// until no thread changes anything in a vote's rounds (the words were
// then constant while every item was visited).  A changed word i is
// written by store(i, x) (into every copy of the words, for kernel 5's
// cluster); vote(changed) is the block's (or cluster's) vote.  The words
// may have been set by atomics, by other blocks or in a global scratch, so
// they are read volatile.  Returns the rounds run.
template <class Store, class Vote>
__device__ int or_word_rounds(const volatile uint32_t* words, int W, int Wl,
                              const int32_t* moving, int num_moving, const int32_t* poff,
                              const int32_t* psrc, int V, int sweeps, Store store, Vote vote) {
  const int n = num_moving * Wl;
  int rounds = 0;
  for (int round = 0; round < V; round += sweeps) {
    int changed = 0;
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = Wl == 1 ? i : i / Wl;
        const int j = i - k * Wl;
        const size_t at = (size_t)moving[k] * W + j;
        const uint32_t cur = words[at];
        uint32_t x = cur;
        for (int p = poff[k]; p < poff[k + 1]; ++p) x |= words[(size_t)psrc[p] * W + j];
        if (x != cur) {
          store(at, x);
          changed = 1;
        }
      }
      ++rounds;
    }
    if (!vote(changed)) break;
  }
  return rounds;
}

// Kernel 2's rounds: one block, one round a vote; ends with a barrier.
__device__ inline int or_word_rounds(volatile uint32_t* words, int W, int Wl,
                                     const int32_t* moving, int num_moving,
                                     const int32_t* poff, const int32_t* psrc, int V) {
  return or_word_rounds(
      words, W, Wl, moving, num_moving, poff, psrc, V, 1,
      [&](size_t at, uint32_t x) { words[at] = x; },
      [](int changed) { return __syncthreads_or(changed); });
}

// The int8 lane table [V, D] of kernels 2 and 5 from the bit words, the
// rows of vertices [lo, hi) written once over the block: -128 where has(v)
// is false (the vertex is absent from the padded edge list), else the bit;
// 4 lanes a store where D allows (lanes then 4-byte aligned).
template <class Has>
__device__ void write_word_lanes(int8_t* lanes, const volatile uint32_t* words,
                                 Has has, int lo, int hi, int D) {
  const int W = (D + 31) / 32;
  const int T = blockDim.x;
  if (D % 4 == 0) {
    uint32_t* out = reinterpret_cast<uint32_t*>(lanes);
    for (int i = lo * D / 4 + threadIdx.x; i < hi * D / 4; i += T) {
      const int v = 4 * i / D;
      const int l = 4 * i - v * D;
      uint32_t x = 0x80808080u;
      if (has(v)) {
        const uint32_t b = (words[(size_t)v * W + (l >> 5)] >> (l & 31)) & 0xFu;
        x = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
      }
      out[i] = x;
    }
  } else {
    for (int i = lo * D + threadIdx.x; i < hi * D; i += T) {
      const int v = i / D;
      const int l = i - v * D;
      lanes[i] = has(v) ? (int8_t)((words[(size_t)v * W + (l >> 5)] >> (l & 31)) & 1u)
                        : (int8_t)-128;
    }
  }
}

// Frontier relaxation's block state, carved from `base` (dynamic shared
// memory, or a block's slice of a global scratch): distances [V], the
// frontier bitmaps cur and next and cur's word ranks [ceil(V / 32)] each,
// scan counts [T + 1], and the listed chunk of the frontier: vertices,
// pair offsets and first out-slots [cap] each (offsets [cap + 1]).
__host__ __device__ inline size_t frontier_state_ints(int V, int cap, int T) {
  const size_t words = ((size_t)V + 31) / 32;
  return (size_t)V + 3 * words + (size_t)T + 1 + 3 * (size_t)cap + 1;
}

// frontier vertices (and pairs) one thread loads for at once
constexpr int kBatch = 4;

struct Frontier {
  float* d;
  uint32_t* cur;
  uint32_t* next;
  int32_t* pre;
  int32_t* counts;
  int32_t* list;
  int32_t* pair_at;
  int32_t* slot_at;
  int cap;

  __device__ Frontier(int32_t* base, int V, int cap_) : cap(cap_) {
    const int words = (V + 31) / 32;
    d = reinterpret_cast<float*>(base);
    cur = reinterpret_cast<uint32_t*>(base + V);
    next = cur + words;
    pre = reinterpret_cast<int32_t*>(next + words);
    counts = pre + words;
    list = counts + blockDim.x + 1;
    pair_at = list + cap;
    slot_at = pair_at + cap + 1;
  }
};

// Distances from `root` (>= 0) into f.d over the out-edge CSR (off [V + 1]
// absolute slots, edge [slots] {dst, bits of w}); a vertex u relaxes its
// out-edges only where !overloaded[u] or u == root, and, where slot_id is
// given, a slot only where keep(slot_id[slot]).  Returns the rounds run;
// ends with a barrier.
template <class Keep>
__device__ int frontier_distances(const Frontier& f, int V, int root,
                                  const int32_t* __restrict__ off,
                                  const int2* __restrict__ edge,
                                  const int32_t* __restrict__ slot_id,
                                  const uint8_t* __restrict__ overloaded,
                                  Keep keep, float big) {
  const int words = (V + 31) / 32;
  const int T = blockDim.x;
  for (int v = threadIdx.x; v < V; v += T) f.d[v] = v == root ? 0.f : big;
  for (int i = threadIdx.x; i < words; i += T)
    f.next[i] = i == (root >> 5) ? 1u << (root & 31) : 0u;
  __syncthreads();
  // what other threads' atomics wrote is read past the L1 (the state may
  // be a global scratch)
  volatile float* vd = f.d;
  volatile uint32_t* vnext = f.next;
  int* di = reinterpret_cast<int*>(f.d);
  int rounds = 0;
  for (;;) {
    // the marks of the last round become this round's frontier: rank it
    // by words (cur = next, next cleared)
    const int n = block_offsets(
        f.counts, words, [&](int i) { return __popc(vnext[i]); },
        [&](int i, int o) {
          f.pre[i] = o;
          f.cur[i] = vnext[i];
          vnext[i] = 0u;
        });
    if (n == 0) break;
    ++rounds;
    for (int c0 = 0; c0 < n; c0 += f.cap) {
      const int c1 = min(n, c0 + f.cap);
      const int nc = c1 - c0;
      // list the frontier vertices of rank [c0, c1)
      for (int i = threadIdx.x; i < words; i += T) {
        uint32_t bits = f.cur[i];
        int r = f.pre[i];
        if (!bits || r >= c1 || r + __popc(bits) <= c0) continue;
        for (; bits; bits &= bits - 1, ++r)
          if (r >= c0 && r < c1) f.list[r - c0] = i * 32 + __ffs(bits) - 1;
      }
      __syncthreads();
      // each one's first out-slot and out-degree (0 where it may not
      // transit), spread evenly over the block, kBatch at a time so their
      // loads overlap
      for (int i0 = threadIdx.x; i0 < nc; i0 += kBatch * T) {
        int u[kBatch], first[kBatch], last[kBatch];
        bool stuck[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = i0 + k * T;
          u[k] = i < nc ? f.list[i] : -1;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (u[k] < 0) continue;
          first[k] = off[u[k]];
          last[k] = off[u[k] + 1];
          stuck[k] = overloaded[u[k]] && u[k] != root;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (u[k] < 0) continue;
          f.slot_at[i0 + k * T] = first[k];
          f.pair_at[i0 + k * T] = stuck[k] ? 0 : last[k] - first[k];
        }
      }
      __syncthreads();
      // pair offsets: the degrees scanned in place
      const int pairs = block_offsets(
          f.counts, nc, [&](int i) { return f.pair_at[i]; },
          [&](int i, int o) { f.pair_at[i] = o; });
      // each thread relaxes a contiguous run of pairs [j0, j1), kBatch at
      // a time: their loads first, then their relaxations
      const int per = (pairs + T - 1) / T;
      const int j0 = min(pairs, (int)threadIdx.x * per);
      const int j1 = min(pairs, j0 + per);
      if (j0 < j1) {
        int lo = 0, hi = nc;  // the last i with pair_at[i] <= j0
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (f.pair_at[mid] <= j0) lo = mid; else hi = mid;
        }
        int i = lo;
        for (int jb = j0; jb < j1; jb += kBatch) {
          int u[kBatch], id[kBatch];
          int2 e[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int j = jb + k;
            if (j >= j1) continue;
            while (i + 1 < nc && f.pair_at[i + 1] <= j) ++i;
            const int slot = f.slot_at[i] + (j - f.pair_at[i]);
            u[k] = f.list[i];
            e[k] = edge[slot];
            id[k] = slot_id ? slot_id[slot] : 0;
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            if (jb + k >= j1 || (slot_id && !keep(id[k]))) continue;
            const float nd = vd[u[k]] + __int_as_float(e[k].y);
            const int old = atomicMin(di + e[k].x, __float_as_int(nd));
            if (__float_as_int(nd) < old)
              atomicOr(f.next + (e[k].x >> 5), 1u << (e[k].x & 31));
          }
        }
      }
      __syncthreads();
    }
  }
  return rounds;
}

// The lane lists of frontier_pair: per vertex its propagating sources'
// count, then the cursor of its packing [V], the moving vertices [V],
// their sources' offsets [V + 1] and the packed sources [M] (M: at least
// the largest area's usable edges).
__host__ __device__ inline size_t lane_lists_ints(int V, int M) {
  return 3 * (size_t)V + 1 + (size_t)M;
}

// Where a pair kernel's block state lives: the frontier state and the
// lane lists both in dynamic shared memory, the frontier state there and
// the lists in the block's slice of a global scratch, or both in the
// slice.
enum StateLayout { kSharedAll = 0, kSharedFrontier = 1, kGlobalAll = 2 };

// The solve of one (root, area) pair from root >= 0 over the area's
// out-edge CSR (off [V + 1] absolute slots, out_edge {dst, bits of w},
// out_rank the slot's lane: its rank among its source's out-edges; where
// null, the slot's place in its source's run, a run that holds all of the
// source's edges in edge order), a
// slot usable where slot_id is null or keep(slot_id[slot]) holds, into
// dist [V] and lanes [V, D]:
//   1. distances by frontier_distances;
//   2. the fill, -128 where has[v] is false (the vertex is absent from
//      the padded edge list), else 0, and dist for every vertex; or, where
//      `prefilled` (a fill kernel wrote dist BIG and the fill already;
//      has is then not read), dist of the reached vertices only;
//   3. the root's out-edges on the shortest-path DAG set their lanes;
//      every other DAG edge (its source reached, not the root, free to
//      transit) is packed as a propagating source of its dst;
//   4. OR rounds over the vertices with a propagating source and only the
//      lanes a seed can reach (1 + the highest rank of a root out-edge on
//      the DAG): every other lane of a present vertex is 0 from the fill
//      and never changes, because a propagating source is reached and not
//      the root, so its own lanes hold 0 or 1, never -128.  So the int8
//      max is an OR of bits: where the live lanes fit 32, the rounds run
//      on one uint32 word a vertex in the distances' place (shared memory
//      where the state is), else on the table (or_lanes).
// lists: lane_lists_ints(V, M); lanes_used: a __shared__ int.
template <class Keep>
__device__ void frontier_pair(const Frontier& f, int32_t* lists, int& lanes_used, int root,
                              const int32_t* __restrict__ off,
                              const int2* __restrict__ out_edge,
                              const int32_t* __restrict__ out_rank,
                              const int32_t* __restrict__ slot_id, Keep keep,
                              const uint8_t* __restrict__ has,
                              const uint8_t* __restrict__ ovl, float* dist,
                              int8_t* lanes, int V, int D, float big,
                              bool prefilled) {
  const int T = blockDim.x;
  int32_t* count = lists;
  int32_t* moving = count + V;
  int32_t* poff = moving + V;
  int32_t* psrc = poff + V + 1;
  const auto kept = [&](int j) { return !slot_id || keep(slot_id[j]); };

  // 1. distances
  frontier_distances(f, V, root, off, out_edge, slot_id, ovl, keep, big);
  const volatile float* d = f.d;
  for (int v = threadIdx.x; v < V; v += T) {
    const float dv = d[v];
    if (!prefilled || dv < big) dist[v] = dv;
    count[v] = 0;
  }
  // 2. the fill (16 lanes a store where whole rows of D lanes fill 16-byte
  // words)
  if (!prefilled) {
    const size_t VD = (size_t)V * D;
    if (D % 16 == 0) {
      uint4* words = reinterpret_cast<uint4*>(lanes);
      for (size_t i = threadIdx.x; i < VD / 16; i += T) {
        const uint32_t x = has[i / (D / 16)] ? 0u : 0x80808080u;
        words[i] = make_uint4(x, x, x, x);
      }
    } else {
      for (size_t i = threadIdx.x; i < VD; i += T) lanes[i] = has[i / D] ? 0 : -128;
    }
  }
  if (threadIdx.x == 0) lanes_used = 0;
  __syncthreads();

  // 3. the root's out-edges on the DAG set their lanes; every other DAG
  // edge counts a propagating source of its dst
  for (int j = off[root] + threadIdx.x; j < off[root + 1]; j += T) {
    const int2 e = out_edge[j];
    const float dv = d[e.x];
    if (kept(j) && d[root] + __int_as_float(e.y) == dv && dv < big) {
      const int k = out_rank ? out_rank[j] : j - off[root];
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
        if (du + __int_as_float(e.y) == d[e.x] && kept(j)) visit(u, e.x);
      }
    }
  };
  each_propagating([&](int, int v) { atomicAdd(count + v, 1); });
  __syncthreads();

  // the moving vertices (a propagating source at least) and the offsets of
  // their sources; count becomes each one's packing cursor
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

  // 4. OR-propagation over the live lanes: where they fit one word a
  // vertex, as bit words in the distances' place (read no more), seeded
  // from the seed lanes set in step 3 (a lane of the fill is 0 or -128, so
  // a 1 is a seed), then each moving vertex's lanes that became 1 written
  // out; else on the table itself
  const int L = lanes_used < D ? lanes_used : D;
  if (L > 32) {
    or_lanes(lanes, moving, num_moving, poff, psrc, V, L, D);
    return;
  }
  // the words are set by atomics, so they are read past the L1 (the state
  // may be a global scratch)
  volatile uint32_t* word = reinterpret_cast<volatile uint32_t*>(f.d);
  for (int v = threadIdx.x; v < V; v += T) word[v] = 0u;
  __syncthreads();
  for (int j = off[root] + threadIdx.x; j < off[root + 1]; j += T) {
    const int k = out_rank ? out_rank[j] : j - off[root];
    const int v = out_edge[j].x;
    if (k < L && lanes[(size_t)v * D + k] == 1)
      atomicOr(const_cast<uint32_t*>(word) + v, 1u << k);
  }
  __syncthreads();
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int k = threadIdx.x; k < num_moving; k += T) {
      const int v = moving[k];
      const uint32_t cur = word[v];
      uint32_t x = cur;
      for (int j = poff[k]; j < poff[k + 1]; ++j) x |= word[psrc[j]];
      if (x != cur) {
        word[v] = x;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < num_moving * L; i += T) {
    const int k = i / L;
    const int l = i - k * L;
    const int v = moving[k];
    if ((word[v] >> l) & 1u) lanes[(size_t)v * D + l] = 1;
  }
}

}  // namespace
