// Multi-area best-route selection for Hopper (sm_90a).
//
// Replaces the jitted XLA kernels of the JAX package
//   openr_tpu/ops/route_select.py:267 multi_area_select_from_tables
//       (kernel 3 here: fleet_select_kernel<false, W, true> at one batch
//       row)
//   openr_tpu/ops/route_select.py:368 multi_area_select_delta_from_tables
//       (kernel 7 here: multi_area_select_delta_kernel)
// and the vmap of kernel 3 over vantage roots or failure snapshots in
//   openr_tpu/ops/fleet_tables.py:27, :89, :154 (with the per-root diff
//       of :205-210) and :217
//       (kernel 13 here: fleet_select_kernel<false / true, W, false>)
// (SpfSolver.cpp:161-312, 456-556; LsdbUtil.cpp:761-823), computed for
// every prefix row p over its C candidate advertisements:
//   1. reach: candidate ok and its node reached by SPF in its own area
//   2. hard-drain filter with all-drained fallback
//   3. keep-max of not-drained, path_pref, source_pref (ties kept)
//   4. keep-min of distance, globally or within each area
//   5. per area: min SPF metric over the winners' node names resolved in
//      that area (only areas holding a winner advertisement), and the
//      union of the min-cost winners' first-hop lanes
// Outputs: use [P, C], shortest [P, A] f32, lanes [P, A, D], valid [P, A]
// (bool tensors, one byte each).  Kernel 7 then flags changed[p] when any
// output differs from the previous generation's, or when a candidate
// touches a node whose drain state moved (node_changed [A, V]): for
// cand_ok slots, the candidate's own-area cell and every area's cell it
// resolves to (cand_node_in_area >= 0).  The host re-decodes only the
// flagged rows.
//
// Kernel 7: one thread per row, looping over C, A and D; the row's
// candidate sets are bitmasks in a register (C <= 64, the largest
// candidate bucket).  What bounds it: bytes.  Each row reads its [C] and
// [C, A] candidate columns once and writes its outputs once; the SPF
// tables it gathers from are small and stay in L2.
//
// Kernels 13 and 3: a block per tile of TP consecutive prefix rows of one
// batch row b, so each of the tile's outputs (use [TP, C], shortest and
// valid [TP, A], lanes [TP, A, D]) is one contiguous span.  Phase 1: a
// thread per row runs the chain to the winner mask, every key compared in
// registers (the not-drained key is a 0/1 mask, no indexed local array);
// kernel 3 (kOkOnly) runs it over the row's ok candidates alone: a
// candidate that is not ok joins no selection, so the row reads its
// cand_ok bytes first and nothing else of a slot that is not ok (a row
// with none, such as the candidate table's bucket padding, reads only
// those bytes and writes the empty outputs), where kernel 13 reads a
// slot's columns beside its ok byte (one dependent load fewer; the flag
// cost it up to 6 % at its shapes, PERF.md).  Then a thread per (row,
// area) pair finds the pair's min-cost winners and shortest metric and
// writes the shortest at once (consecutive pairs, consecutive
// addresses).  Phase 2: the block sweeps the tile's lane span, W bytes a
// thread (W = 16, 8, 4 or 1: the most that divides D and the
// pointers' alignment): each byte is the int32 SUM over the pair's
// min-cost winners of nh[b, a, n, l], then > 0, so a winner's -128 fill
// cancels as it does in the reference; a winner's W lane bytes are one
// load (a node's D bytes are contiguous) and the stores are coalesced.
// Phase 3: valid (= winners and a set lane) and use from shared memory,
// coalesced.  The diff variant compares each output with prev_* as it
// writes it, and votes per block into changed[b] (zeroed before the
// launch).  What bounds it: bytes, the lane table written once, and the
// nh rows and distances of the winners gathered once each.  Kernel 3 is
// this kernel at B = 1: its [A, V] tables are the [1, A, V] ones.
//
// Traps reproduced exactly:
//   * keep_max starts from INT32_MIN, keep_min from INT32_MAX, and both
//     keep ties (key == best).
//   * the lane union is the reference's einsum(mc, nh) > 0: a SUM over
//     the min-cost winners, then > 0 — not a bitwise OR.  A winner whose
//     lane row holds the int8 -128 fill (a root with no in-edges) cancels
//     exactly as it does there, so the sum is kept in int32.
//   * distances compare against BIG and +inf exactly: never built with
//     --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
// threads of a kernel-13 block: 128 was within 3 % of the fastest of
// 64-256 at (d) cold, its delta and the fat-tree (PERF.md)
constexpr int kSelectThreads = 128;
// dynamic shared memory a kernel-13 block may take
constexpr size_t kSelectDynamicSmem = 232448;

__device__ __forceinline__ uint64_t bit(int c) { return 1ull << c; }

// keep the candidates of `mask` whose key equals the mask's max key
__device__ __forceinline__ uint64_t keep_max(uint64_t mask, const int32_t* key,
                                             int C) {
  int32_t best = INT32_MIN;
  for (int c = 0; c < C; ++c)
    if ((mask & bit(c)) && key[c] > best) best = key[c];
  uint64_t out = 0;
  for (int c = 0; c < C; ++c)
    if ((mask & bit(c)) && key[c] == best) out |= bit(c);
  return out;
}

// Kernel 7's selection chain of row p; returns whether any output differs
// from the previous generation's.
__device__ __forceinline__ bool select_delta_row(
    int p, const float* __restrict__ dist, const int8_t* __restrict__ nh,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ cand_area, const int32_t* __restrict__ cand_node,
    const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance,
    const int32_t* __restrict__ cand_node_in_area, uint8_t* __restrict__ use_out,
    float* __restrict__ shortest_out, uint8_t* __restrict__ lanes_out,
    uint8_t* __restrict__ valid_out, const uint8_t* __restrict__ prev_use,
    const float* __restrict__ prev_shortest,
    const uint8_t* __restrict__ prev_lanes,
    const uint8_t* __restrict__ prev_valid, int C, int A, int V, int D,
    int per_area, float big) {
  const size_t row = (size_t)p * C;
  const int32_t* area = cand_area + row;

  // 1-2. reachability, hard-drain filter with all-drained fallback, and
  // the not-drained key (advertised drain metric or soft-drained node)
  uint64_t reach = 0, nonhard = 0;
  int32_t not_drained[64];
  for (int c = 0; c < C; ++c) {
    const size_t node = (size_t)area[c] * V + cand_node[row + c];
    if (cand_ok[row + c] && dist[node] < big) {
      reach |= bit(c);
      if (!overloaded[node]) nonhard |= bit(c);
    }
    not_drained[c] = !(drain_metric[row + c] > 0 || soft[node] > 0);
  }
  uint64_t use = nonhard ? nonhard : reach;

  // 3. metric chain
  use = keep_max(use, not_drained, C);
  use = keep_max(use, path_pref + row, C);
  use = keep_max(use, source_pref + row, C);

  // 4. SHORTEST_DISTANCE, globally or per area
  const int32_t* dd = distance + row;
  uint64_t kept = 0;
  if (per_area) {
    for (int c = 0; c < C; ++c) {
      if (!(use & bit(c))) continue;
      int32_t best = INT32_MAX;
      for (int c2 = 0; c2 < C; ++c2)
        if ((use & bit(c2)) && area[c2] == area[c] && dd[c2] < best) best = dd[c2];
      if (dd[c] == best) kept |= bit(c);
    }
  } else {
    int32_t best = INT32_MAX;
    for (int c = 0; c < C; ++c)
      if ((use & bit(c)) && dd[c] < best) best = dd[c];
    for (int c = 0; c < C; ++c)
      if ((use & bit(c)) && dd[c] == best) kept |= bit(c);
  }
  use = kept;
  bool changed = false;
  for (int c = 0; c < C; ++c) {
    const uint8_t u = (use >> c) & 1;
    use_out[row + c] = u;
    changed |= u != prev_use[row + c];
  }

  // 5. per-area min-cost winners and their lane union
  for (int a = 0; a < A; ++a) {
    bool has_winner = false;
    for (int c = 0; c < C; ++c)
      if ((use & bit(c)) && area[c] == a) has_winner = true;
    float shortest = big;
    uint64_t reached = 0;
    if (has_winner) {
      for (int c = 0; c < C; ++c) {
        if (!(use & bit(c))) continue;
        const int n = cand_node_in_area[(row + c) * A + a];
        if (n < 0) continue;
        const float m = dist[(size_t)a * V + n];
        if (m < big) {
          reached |= bit(c);
          shortest = fminf(shortest, m);
        }
      }
    }
    uint64_t mc = 0;
    for (int c = 0; c < C; ++c) {
      if (!(reached & bit(c))) continue;
      const int n = cand_node_in_area[(row + c) * A + a];
      if (dist[(size_t)a * V + n] == shortest) mc |= bit(c);
    }
    const size_t out = (size_t)p * A + a;
    int num_nh = 0;
    for (int l = 0; l < D; ++l) {
      int32_t hits = 0;
      for (int c = 0; c < C; ++c) {
        if (!(mc & bit(c))) continue;
        const int n = cand_node_in_area[(row + c) * A + a];
        hits += nh[((size_t)a * V + n) * D + l];
      }
      lanes_out[out * D + l] = hits > 0;
      num_nh += hits > 0;
      changed |= (hits > 0) != (prev_lanes[out * D + l] != 0);
    }
    const bool valid = mc != 0 && num_nh > 0;
    shortest_out[out] = shortest;
    valid_out[out] = valid;
    changed |= shortest != prev_shortest[out];
    changed |= valid != (prev_valid[out] != 0);
  }
  return changed;
}

__global__ void __launch_bounds__(kThreads) multi_area_select_delta_kernel(
    const float* __restrict__ dist, const int8_t* __restrict__ nh,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ cand_area, const int32_t* __restrict__ cand_node,
    const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance,
    const int32_t* __restrict__ cand_node_in_area, uint8_t* __restrict__ use_out,
    float* __restrict__ shortest_out, uint8_t* __restrict__ lanes_out,
    uint8_t* __restrict__ valid_out, const uint8_t* __restrict__ prev_use,
    const float* __restrict__ prev_shortest,
    const uint8_t* __restrict__ prev_lanes,
    const uint8_t* __restrict__ prev_valid,
    const uint8_t* __restrict__ node_changed,
    uint8_t* __restrict__ changed_out, int P, int C, int A, int V, int D,
    int per_area, float big) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  bool changed = select_delta_row(
      p, dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
      drain_metric, path_pref, source_pref, distance, cand_node_in_area,
      use_out, shortest_out, lanes_out, valid_out, prev_use, prev_shortest,
      prev_lanes, prev_valid, C, A, V, D, per_area, big);
  const size_t row = (size_t)p * C;
  const int32_t* area = cand_area + row;
  // drain-state touches: decode wraps the winning entry from LinkState's
  // drain lookups, so such rows re-decode even with unchanged outputs
  for (int c = 0; c < C && !changed; ++c) {
    if (!cand_ok[row + c]) continue;
    changed = node_changed[(size_t)area[c] * V + cand_node[row + c]];
    for (int a = 0; a < A && !changed; ++a) {
      const int n = cand_node_in_area[(row + c) * A + a];
      changed = n >= 0 && node_changed[(size_t)a * V + n];
    }
  }
  changed_out[p] = changed;
}

// Kernel 13's chain of row p (steps 1-4) to its winner mask, in registers.
// kOkOnly (kernel 3): over the row's ok candidates alone, read first, so a
// row with none reads its cand_ok bytes alone.
template <bool kOkOnly>
__device__ __forceinline__ uint64_t fleet_row_use(
    size_t row, const float* __restrict__ dist,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ cand_area, const int32_t* __restrict__ cand_node,
    const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance, int C, int V, int per_area, float big) {
  const int32_t* area = cand_area + row;
  // 1-2. reachability, hard-drain filter with all-drained fallback, and
  // the not-drained key as a mask (advertised drain metric or soft-drained
  // node clear it; only a reached, so ok, candidate is ever kept)
  uint64_t reach = 0, nonhard = 0, not_drained = 0;
  if constexpr (kOkOnly) {
    uint64_t ok = 0;
    for (int c = 0; c < C; ++c)
      if (cand_ok[row + c]) ok |= bit(c);
    if (!ok) return 0;
    for (uint64_t m = ok; m; m &= m - 1) {
      const int c = __ffsll(m) - 1;
      const size_t node = (size_t)area[c] * V + cand_node[row + c];
      if (dist[node] < big) {
        reach |= bit(c);
        if (!overloaded[node]) nonhard |= bit(c);
      }
      if (!(drain_metric[row + c] > 0 || soft[node] > 0)) not_drained |= bit(c);
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const size_t node = (size_t)area[c] * V + cand_node[row + c];
      if (cand_ok[row + c] && dist[node] < big) {
        reach |= bit(c);
        if (!overloaded[node]) nonhard |= bit(c);
      }
      if (!(drain_metric[row + c] > 0 || soft[node] > 0)) not_drained |= bit(c);
    }
  }
  uint64_t use = nonhard ? nonhard : reach;
  // 3. metric chain: a 0/1 key keeps the 1s where any is kept
  if (use & not_drained) use &= not_drained;
  use = keep_max(use, path_pref + row, C);
  use = keep_max(use, source_pref + row, C);
  // 4. SHORTEST_DISTANCE, globally or per area
  const int32_t* dd = distance + row;
  uint64_t kept = 0;
  if (per_area) {
    for (uint64_t m = use; m; m &= m - 1) {
      const int c = __ffsll(m) - 1;
      int32_t best = INT32_MAX;
      for (uint64_t m2 = use; m2; m2 &= m2 - 1) {
        const int c2 = __ffsll(m2) - 1;
        if (area[c2] == area[c] && dd[c2] < best) best = dd[c2];
      }
      if (dd[c] == best) kept |= bit(c);
    }
  } else {
    int32_t best = INT32_MAX;
    for (uint64_t m = use; m; m &= m - 1) best = min(best, dd[__ffsll(m) - 1]);
    for (uint64_t m = use; m; m &= m - 1) {
      const int c = __ffsll(m) - 1;
      if (dd[c] == best) kept |= bit(c);
    }
  }
  return kept;
}

// W lane bytes as one register load or store (W = 1, 4, 8 or 16)
template <int W> struct Lanes;
template <> struct Lanes<1> { using T = uint8_t; };
template <> struct Lanes<4> { using T = uint32_t; };
template <> struct Lanes<8> { using T = uint2; };
template <> struct Lanes<16> { using T = uint4; };
template <int W> union LaneBytes {
  typename Lanes<W>::T v;
  int8_t s[W];
  uint8_t u[W];
};

// Kernel 13 over tiles of TP prefix rows: block (b, tile) with its winner
// masks and lane flags in dynamic shared memory (fleet_select_smem);
// kOkOnly as in fleet_row_use.
template <bool kDiff, int W, bool kOkOnly>
__global__ void __launch_bounds__(kSelectThreads) fleet_select_kernel(
    const float* __restrict__ dist, const int8_t* __restrict__ nh,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ cand_area, const int32_t* __restrict__ cand_node,
    const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance,
    const int32_t* __restrict__ cand_node_in_area, uint8_t* __restrict__ use_out,
    float* __restrict__ shortest_out, uint8_t* __restrict__ lanes_out,
    uint8_t* __restrict__ valid_out, const uint8_t* __restrict__ prev_use,
    const float* __restrict__ prev_shortest,
    const uint8_t* __restrict__ prev_lanes,
    const uint8_t* __restrict__ prev_valid, uint8_t* __restrict__ changed_out,
    int tiles, int TP, int P, int C, int A, int V, int D, int per_area,
    float big) {
  using Vec = typename Lanes<W>::T;
  extern __shared__ uint64_t smem64[];
  uint64_t* use_s = smem64;                                 // [TP]
  uint64_t* mc_s = use_s + TP;                              // [TP * A]
  int32_t* lit_s = reinterpret_cast<int32_t*>(mc_s + (size_t)TP * A);  // [TP * A]
  constexpr int T = kSelectThreads;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  const int np = min(TP, P - p0);
  const float* dist_b = dist + (size_t)b * A * V;
  const int8_t* nh_b = nh + (size_t)b * A * V * D;
  const size_t out0 = (size_t)b * P + p0;  // the tile's first output row
  bool changed = false;

  // 1. the chain, a thread per row; then a thread per (row, area) pair:
  // its min-cost winners (only areas holding a winner advertisement) and
  // shortest metric over the winners' node names resolved in the area
  for (int r = threadIdx.x; r < np; r += T)
    use_s[r] = fleet_row_use<kOkOnly>((size_t)(p0 + r) * C, dist_b, overloaded, soft, cand_area,
                             cand_node, cand_ok, drain_metric, path_pref, source_pref,
                             distance, C, V, per_area, big);
  __syncthreads();
  for (int i = threadIdx.x; i < np * A; i += T) {
    const int r = i / A;
    const int a = i - r * A;
    const size_t row = (size_t)(p0 + r) * C;
    const uint64_t use = use_s[r];
    bool has_winner = false;
    for (uint64_t m = use; m; m &= m - 1)
      if (cand_area[row + __ffsll(m) - 1] == a) has_winner = true;
    float shortest = big;
    uint64_t reached = 0;
    if (has_winner) {
      for (uint64_t m = use; m; m &= m - 1) {
        const int c = __ffsll(m) - 1;
        const int n = cand_node_in_area[(row + c) * A + a];
        if (n < 0) continue;
        const float x = dist_b[(size_t)a * V + n];
        if (x < big) {
          reached |= bit(c);
          shortest = fminf(shortest, x);
        }
      }
    }
    uint64_t mc = 0;
    for (uint64_t m = reached; m; m &= m - 1) {
      const int c = __ffsll(m) - 1;
      const int n = cand_node_in_area[(row + c) * A + a];
      if (dist_b[(size_t)a * V + n] == shortest) mc |= bit(c);
    }
    mc_s[i] = mc;
    lit_s[i] = 0;
    const size_t o = out0 * A + i;
    shortest_out[o] = shortest;
    if (kDiff) changed |= shortest != prev_shortest[o];
  }
  __syncthreads();

  // 2. the lane span [np, A, D], W bytes a thread: the int32 sum over the
  // pair's min-cost winners of their lane bytes, then > 0
  const int per_pair = D / W;
  const int chunks = np * A * per_pair;
  Vec* lanes_t = reinterpret_cast<Vec*>(lanes_out + out0 * A * D);
  const Vec* prev_t = kDiff ? reinterpret_cast<const Vec*>(prev_lanes + out0 * A * D) : nullptr;
  for (int k = threadIdx.x; k < chunks; k += T) {
    const int pair = k / per_pair;
    const int l0 = (k - pair * per_pair) * W;
    const int r = pair / A;
    const int a = pair - r * A;
    const int32_t* nia = cand_node_in_area + (size_t)(p0 + r) * C * A + a;
    int sum[W];
#pragma unroll
    for (int t = 0; t < W; ++t) sum[t] = 0;
    for (uint64_t m = mc_s[pair]; m; m &= m - 1) {
      const int n = nia[(size_t)(__ffsll(m) - 1) * A];
      LaneBytes<W> x;
      x.v = *reinterpret_cast<const Vec*>(nh_b + ((size_t)a * V + n) * D + l0);
#pragma unroll
      for (int t = 0; t < W; ++t) sum[t] += x.s[t];
    }
    LaneBytes<W> out;
    bool lit = false;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      out.u[t] = sum[t] > 0;
      lit |= sum[t] > 0;
    }
    lanes_t[k] = out.v;
    if (lit) lit_s[pair] = 1;
    if (kDiff) {
      LaneBytes<W> prev;
      prev.v = prev_t[k];
#pragma unroll
      for (int t = 0; t < W; ++t) changed |= (prev.u[t] != 0) != (out.u[t] != 0);
    }
  }
  __syncthreads();

  // 3. valid and use, coalesced from shared memory
  for (int i = threadIdx.x; i < np * A; i += T) {
    const bool valid = mc_s[i] != 0 && lit_s[i] != 0;
    const size_t o = out0 * A + i;
    valid_out[o] = valid;
    if (kDiff) changed |= valid != (prev_valid[o] != 0);
  }
  for (int i = threadIdx.x; i < np * C; i += T) {
    const int r = i / C;
    const uint8_t u = (use_s[r] >> (i - r * C)) & 1;
    const size_t o = out0 * C + i;
    use_out[o] = u;
    if (kDiff) changed |= u != prev_use[o];
  }
  if (kDiff && __syncthreads_or(changed) && threadIdx.x == 0) changed_out[b] = 1;
}

// Dynamic shared bytes of a kernel-13 block: use [TP], winners [TP, A]
// (64-bit masks), lane flags [TP, A] (int32).
__host__ __device__ inline size_t fleet_select_smem(int TP, int A) {
  return (size_t)TP * 8 + (size_t)TP * A * 12;
}

template <bool kDiff, int W, bool kOkOnly>
int launch_fleet_select(const void* const* p, int B, int P, int C, int A, int V, int D,
                        int per_area, int TP, float big, cudaStream_t stream) {
  const int tiles = (P + TP - 1) / TP;
  const size_t smem = fleet_select_smem(TP, A);
  constexpr auto kernel = fleet_select_kernel<kDiff, W, kOkOnly>;
  const cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * tiles, kSelectThreads, smem, stream>>>(
      (const float*)p[0], (const int8_t*)p[1], (const uint8_t*)p[2], (const int32_t*)p[3],
      (const int32_t*)p[4], (const int32_t*)p[5], (const uint8_t*)p[6], (const int32_t*)p[7],
      (const int32_t*)p[8], (const int32_t*)p[9], (const int32_t*)p[10],
      (const int32_t*)p[11], (uint8_t*)p[12], (float*)p[13], (uint8_t*)p[14],
      (uint8_t*)p[15], (const uint8_t*)p[16], (const float*)p[17], (const uint8_t*)p[18],
      (const uint8_t*)p[19], (uint8_t*)p[20], tiles, TP, P, C, A, V, D, per_area, big);
  return (int)cudaGetLastError();
}

template <bool kDiff, bool kOkOnly>
int launch_fleet_select_w(const void* const* p, int B, int P, int C, int A, int V, int D,
                          int per_area, int TP, float big, cudaStream_t stream) {
  // the widest lane vector that divides D and every lane pointer's alignment
  int W = 16;
  const auto fits = [&](const void* q) { return q == nullptr || (uintptr_t)q % W == 0; };
  while (W > 1 && (D % W || !fits(p[1]) || !fits(p[14]) || !fits(p[18]))) W = W > 4 ? W / 2 : 1;
  switch (W) {
    case 16:
      return launch_fleet_select<kDiff, 16, kOkOnly>(p, B, P, C, A, V, D, per_area, TP, big, stream);
    case 8:
      return launch_fleet_select<kDiff, 8, kOkOnly>(p, B, P, C, A, V, D, per_area, TP, big, stream);
    case 4:
      return launch_fleet_select<kDiff, 4, kOkOnly>(p, B, P, C, A, V, D, per_area, TP, big, stream);
    default:
      return launch_fleet_select<kDiff, 1, kOkOnly>(p, B, P, C, A, V, D, per_area, TP, big, stream);
  }
}

// Kernel 13 (ok_only false) or kernel 3 (B = 1, no previous generation,
// ok_only true): checks, the changed flags zeroed, the launch.
int launch_fleet(const void* const* p, int B, int P, int C, int A, int V, int D, int per_area,
                 int tile_rows, float big, bool ok_only, cudaStream_t stream) {
  const int TP = tile_rows < P ? tile_rows : P;
  // a tile's winner masks and lane flags must fit shared memory
  if (C > 64 || tile_rows < 1 || fleet_select_smem(TP, A) > kSelectDynamicSmem)
    return (int)cudaErrorInvalidValue;
  const bool diff = p[16] != nullptr;
  if (diff) {
    cudaError_t err = cudaMemsetAsync(const_cast<void*>(p[20]), 0, (size_t)B, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (B == 0 || P == 0) return (int)cudaSuccess;
  if (diff) return launch_fleet_select_w<true, false>(p, B, P, C, A, V, D, per_area, TP, big, stream);
  return ok_only
             ? launch_fleet_select_w<false, true>(p, B, P, C, A, V, D, per_area, TP, big, stream)
             : launch_fleet_select_w<false, false>(p, B, P, C, A, V, D, per_area, TP, big, stream);
}

int launch_select_delta(const void* dist, const void* nh, const void* overloaded,
                        const void* soft, const void* cand_area, const void* cand_node,
                        const void* cand_ok, const void* drain_metric, const void* path_pref,
                        const void* source_pref, const void* distance,
                        const void* cand_node_in_area, void* use, void* shortest, void* lanes,
                        void* valid, const void* prev_use, const void* prev_shortest,
                        const void* prev_lanes, const void* prev_valid,
                        const void* node_changed, void* changed, int P, int C, int A, int V,
                        int D, int per_area, float big, void* stream) {
  if (C > 64) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const int blocks = (P + kThreads - 1) / kThreads;
  multi_area_select_delta_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dist, (const int8_t*)nh, (const uint8_t*)overloaded,
      (const int32_t*)soft, (const int32_t*)cand_area, (const int32_t*)cand_node,
      (const uint8_t*)cand_ok, (const int32_t*)drain_metric, (const int32_t*)path_pref,
      (const int32_t*)source_pref, (const int32_t*)distance,
      (const int32_t*)cand_node_in_area, (uint8_t*)use, (float*)shortest, (uint8_t*)lanes,
      (uint8_t*)valid, (const uint8_t*)prev_use, (const float*)prev_shortest,
      (const uint8_t*)prev_lanes, (const uint8_t*)prev_valid, (const uint8_t*)node_changed,
      (uint8_t*)changed, P, C, A, V, D, per_area, big);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int openr_fleet_select(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_area, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* cand_node_in_area, void* use,
    void* shortest, void* lanes, void* valid, const void* prev_use,
    const void* prev_shortest, const void* prev_lanes, const void* prev_valid,
    void* changed, int B, int P, int C, int A, int V, int D, int per_area,
    int tile_rows, float big, void* stream) {
  const void* p[21] = {dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
                       drain_metric, path_pref, source_pref, distance, cand_node_in_area,
                       use, shortest, lanes, valid, prev_use, prev_shortest, prev_lanes,
                       prev_valid, changed};
  return launch_fleet(p, B, P, C, A, V, D, per_area, tile_rows, big, false,
                      (cudaStream_t)stream);
}

// Kernel 3: kernel 13 at one batch row (its [A, V] tables are the
// [1, A, V] ones), without a previous generation, over each row's ok
// candidates alone.
extern "C" int openr_multi_area_select(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_area, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* cand_node_in_area, void* use,
    void* shortest, void* lanes, void* valid, int P, int C, int A, int V,
    int D, int per_area, int tile_rows, float big, void* stream) {
  const void* p[21] = {dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
                       drain_metric, path_pref, source_pref, distance, cand_node_in_area,
                       use, shortest, lanes, valid, nullptr, nullptr, nullptr, nullptr,
                       nullptr};
  return launch_fleet(p, 1, P, C, A, V, D, per_area, tile_rows, big, true,
                      (cudaStream_t)stream);
}

extern "C" int openr_multi_area_select_delta(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_area, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* cand_node_in_area, void* use,
    void* shortest, void* lanes, void* valid, const void* prev_use,
    const void* prev_shortest, const void* prev_lanes, const void* prev_valid,
    const void* node_changed, void* changed, int P, int C, int A, int V,
    int D, int per_area, float big, void* stream) {
  return launch_select_delta(
      dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
      path_pref, source_pref, distance, cand_node_in_area, use, shortest,
      lanes, valid, prev_use, prev_shortest, prev_lanes, prev_valid,
      node_changed, changed, P, C, A, V, D, per_area, big, stream);
}
