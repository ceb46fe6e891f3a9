// Device routines shared by the SPF kernels of spf_warm.cu and
// spf_dense.cu: the warp-shuffle block scan (block_offsets, block_ranks),
// the packed OR lane loop (or_lanes) and frontier relaxation over a
// compact out-edge list (frontier_distances).
//
// Frontier relaxation (kernels 12 and 15).  The topology is a CSR by
// SOURCE of the usable edges only (edge_ok false and padding dropped by
// the launcher): vertex u's out-edges are the slots [off[u], off[u + 1]),
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
// row edge bit, by the slot's edge id) once per pair.  d[v] falls by an integer atomicMin on the
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

// The packed OR lane loop of kernels 12 and 16: the moving vertices
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

}  // namespace
