// Multi-area best-route selection for Hopper (sm_90a), and the gather of
// its changed rows.
//
// Replaces the jitted XLA kernels of the JAX package
//   openr_tpu/ops/route_select.py:267 multi_area_select_from_tables
//       (kernel 3 here: fleet_select_kernel<kNoDiff, W, true> at one batch
//       row)
//   openr_tpu/ops/route_select.py:368 multi_area_select_delta_from_tables
//       (kernel 7 here: fleet_select_kernel<kRowDiff, W, true> at one
//       batch row)
//   openr_tpu/ops/route_select.py:439 gather_selection_rows
//       (kernel 18 here: gather_rows_kernel)
// and the vmap of kernel 3 over vantage roots or failure snapshots in
//   openr_tpu/ops/fleet_tables.py:27, :89, :154 (with the per-root diff
//       of :205-210) and :217
//       (kernel 13 here: fleet_select_kernel<kNoDiff / kBatchDiff, W, false>)
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
// output of row p differs from the previous generation's, or when an ok
// candidate of the row touches a node whose drain state moved
// (node_changed [A, V]): its own-area cell, or any area's cell it
// resolves to (cand_node_in_area >= 0).  The host re-decodes only the
// flagged rows.
//
// Kernels 13, 3 and 7: a block per tile of TP consecutive prefix rows of
// one batch row b, so each of the tile's outputs (use [TP, C], shortest
// and valid [TP, A], lanes [TP, A, D]) is one contiguous span.  Phase 1:
// a thread per row runs the chain to the winner mask, every key compared
// in registers (the not-drained key is a 0/1 mask, no indexed local
// array); kernels 3 and 7 (kOkOnly) run it over the row's ok candidates
// alone: a candidate that is not ok joins no selection, so the row reads
// its cand_ok bytes first and nothing else of a slot that is not ok (a
// row with none, such as the candidate table's bucket padding, reads only
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
// coalesced.  What bounds them: bytes, the lane table written once, and
// the nh rows and distances of the winners gathered once each.  Kernel 3
// is this kernel at B = 1: its [A, V] tables are the [1, A, V] ones.
//
// The diff modes compare each output with prev_* as they write it.
// kBatchDiff (kernel 13) votes per block into changed[b] (zeroed before
// the launch).  kRowDiff (kernel 7, at B = 1) keeps a flag word a row in
// the tile's shared memory: phase 1 sets it from the row's touches (its
// ok slots, read for the chain, against node_changed), the pairs from
// shortest, phase 2 from each W-byte lane word against the same word of
// prev_lanes (one load), phase 3 from valid and use; the tile's changed
// bytes are stored coalesced at the end.  Every row reads its prev_*
// outputs whatever its ok bytes: a withdrawn prefix leaves an empty row,
// which must flag when its previous row was not empty.  Kernel 7 adds to
// kernel 3's bytes only the prev_* tables, the node_changed cells its ok
// slots name and changed [P].
//
// Kernel 18 gathers rows idx [G] (int64) of the four selection tables
// into [G, ...] outputs in one launch, each table byte-generic with its
// own row size.  A row of at most kThreadRowWords words is a thread's (the
// delta build's rows are 1 to 4 bytes); a longer one (the fleet's rows are
// whole roots' tables, KB each) is spread over ceil(words / 256) blocks,
// a thread a word.  Words are 16, 8, 4 or 1 bytes: the most that divides
// the row's bytes and both tables' alignment.  Repeated and unsorted
// indices copy their rows as jnp.take does.  An index outside [0, N)
// (negative ones too) reads nothing and writes its output row as zero
// bytes (false, +0.0); jnp.take would wrap a negative index and fill past
// N, and torch.index_select raises; the callers pass row numbers of the
// table.  What bounds it: bytes, each gathered row read once and written
// once; at the delta build's few hundred rows, the launch itself.
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

// The ok mask of a candidate row (C <= 64).
__device__ __forceinline__ uint64_t row_ok(const uint8_t* __restrict__ ok, int C) {
  uint64_t m = 0;
  for (int c = 0; c < C; ++c)
    if (ok[c]) m |= bit(c);
  return m;
}

// Kernel 13's chain of row p (steps 1-4) to its winner mask, in registers.
// kOkOnly (kernels 3 and 7): over the row's ok candidates `ok` alone, read
// first, so a row with none reads its cand_ok bytes alone.
template <bool kOkOnly>
__device__ __forceinline__ uint64_t fleet_row_use(
    size_t row, const float* __restrict__ dist,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ cand_area, const int32_t* __restrict__ cand_node,
    const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance, int C, int V, int per_area, float big,
    uint64_t ok) {
  const int32_t* area = cand_area + row;
  // 1-2. reachability, hard-drain filter with all-drained fallback, and
  // the not-drained key as a mask (advertised drain metric or soft-drained
  // node clear it; only a reached, so ok, candidate is ever kept)
  uint64_t reach = 0, nonhard = 0, not_drained = 0;
  if constexpr (kOkOnly) {
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

// Kernel 7's drain-state touches of a row: an ok slot whose own-area cell,
// or a cell it resolves to in any area, is in node_changed (decode wraps
// the winning entry from LinkState's drain lookups, so such rows
// re-decode even with unchanged outputs).
__device__ __forceinline__ bool row_touches(
    uint64_t ok, size_t row, const int32_t* __restrict__ cand_area,
    const int32_t* __restrict__ cand_node, const int32_t* __restrict__ cand_node_in_area,
    const uint8_t* __restrict__ node_changed, int A, int V) {
  for (uint64_t m = ok; m; m &= m - 1) {
    const size_t c = row + __ffsll(m) - 1;
    if (node_changed[(size_t)cand_area[c] * V + cand_node[c]]) return true;
    const int32_t* nia = cand_node_in_area + c * A;
    for (int a = 0; a < A; ++a)
      if (nia[a] >= 0 && node_changed[(size_t)a * V + nia[a]]) return true;
  }
  return false;
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

// the diff modes of fleet_select_kernel
constexpr int kNoDiff = 0;     // kernels 3 and 13 without a previous generation
constexpr int kBatchDiff = 1;  // kernel 13: changed[b] per batch row
constexpr int kRowDiff = 2;    // kernel 7: changed[p] per prefix row, at B = 1

// Kernels 13, 3 and 7 over tiles of TP prefix rows: block (b, tile) with
// its winner masks, lane flags and (kRowDiff) row flags in dynamic shared
// memory (fleet_select_smem); kOkOnly as in fleet_row_use.
template <int kDiff, int W, bool kOkOnly>
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
    const uint8_t* __restrict__ prev_valid, const uint8_t* __restrict__ node_changed,
    uint8_t* __restrict__ changed_out, int tiles, int TP, int P, int C, int A, int V,
    int D, int per_area, float big) {
  static_assert(kDiff != kRowDiff || kOkOnly, "kernel 7 runs the chain over ok slots");
  using Vec = typename Lanes<W>::T;
  extern __shared__ uint64_t smem64[];
  uint64_t* use_s = smem64;                                 // [TP]
  uint64_t* mc_s = use_s + TP;                              // [TP * A]
  int32_t* lit_s = reinterpret_cast<int32_t*>(mc_s + (size_t)TP * A);  // [TP * A]
  int32_t* flag_s = lit_s + (size_t)TP * A;                 // [TP], kRowDiff
  constexpr int T = kSelectThreads;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  const int np = min(TP, P - p0);
  const float* dist_b = dist + (size_t)b * A * V;
  const int8_t* nh_b = nh + (size_t)b * A * V * D;
  const size_t out0 = (size_t)b * P + p0;  // the tile's first output row
  bool changed = false;

  // 1. the chain, a thread per row (kRowDiff: and the row's touches); then
  // a thread per (row, area) pair: its min-cost winners (only areas holding
  // a winner advertisement) and shortest metric over the winners' node
  // names resolved in the area
  for (int r = threadIdx.x; r < np; r += T) {
    const size_t row = (size_t)(p0 + r) * C;
    const uint64_t ok = kOkOnly ? row_ok(cand_ok + row, C) : 0;
    use_s[r] = fleet_row_use<kOkOnly>(row, dist_b, overloaded, soft, cand_area, cand_node,
                                      cand_ok, drain_metric, path_pref, source_pref, distance,
                                      C, V, per_area, big, ok);
    if constexpr (kDiff == kRowDiff)
      flag_s[r] = row_touches(ok, row, cand_area, cand_node, cand_node_in_area, node_changed,
                              A, V);
  }
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
    if constexpr (kDiff == kBatchDiff) changed |= shortest != prev_shortest[o];
    if constexpr (kDiff == kRowDiff)
      if (shortest != prev_shortest[o]) flag_s[r] = 1;
  }
  __syncthreads();

  // 2. the lane span [np, A, D], W bytes a thread: the int32 sum over the
  // pair's min-cost winners of their lane bytes, then > 0
  const int per_pair = D / W;
  const int chunks = np * A * per_pair;
  Vec* lanes_t = reinterpret_cast<Vec*>(lanes_out + out0 * A * D);
  const Vec* prev_t =
      kDiff != kNoDiff ? reinterpret_cast<const Vec*>(prev_lanes + out0 * A * D) : nullptr;
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
    if constexpr (kDiff != kNoDiff) {
      LaneBytes<W> prev;
      prev.v = prev_t[k];
      bool differ = false;
#pragma unroll
      for (int t = 0; t < W; ++t) differ |= (prev.u[t] != 0) != (out.u[t] != 0);
      if constexpr (kDiff == kBatchDiff) changed |= differ;
      if constexpr (kDiff == kRowDiff)
        if (differ) flag_s[r] = 1;
    }
  }
  __syncthreads();

  // 3. valid and use, coalesced from shared memory
  for (int i = threadIdx.x; i < np * A; i += T) {
    const bool valid = mc_s[i] != 0 && lit_s[i] != 0;
    const size_t o = out0 * A + i;
    valid_out[o] = valid;
    if constexpr (kDiff == kBatchDiff) changed |= valid != (prev_valid[o] != 0);
    if constexpr (kDiff == kRowDiff)
      if (valid != (prev_valid[o] != 0)) flag_s[i / A] = 1;
  }
  for (int i = threadIdx.x; i < np * C; i += T) {
    const int r = i / C;
    const uint8_t u = (use_s[r] >> (i - r * C)) & 1;
    const size_t o = out0 * C + i;
    use_out[o] = u;
    if constexpr (kDiff == kBatchDiff) changed |= u != prev_use[o];
    if constexpr (kDiff == kRowDiff)
      if (u != prev_use[o]) flag_s[r] = 1;
  }
  if constexpr (kDiff == kBatchDiff) {
    if (__syncthreads_or(changed) && threadIdx.x == 0) changed_out[b] = 1;
  }
  if constexpr (kDiff == kRowDiff) {
    // 4. the tile's changed bytes, coalesced
    __syncthreads();
    for (int r = threadIdx.x; r < np; r += T) changed_out[out0 + r] = flag_s[r] != 0;
  }
}

// Dynamic shared bytes of a kernel-13 block: use [TP], winners [TP, A]
// (64-bit masks), lane flags [TP, A] (int32), and kernel 7's row flags
// [TP] (int32).
__host__ __device__ inline size_t fleet_select_smem(int TP, int A, bool row_diff) {
  return (size_t)TP * 8 + (size_t)TP * A * 12 + (row_diff ? (size_t)TP * 4 : 0);
}

template <int kDiff, int W, bool kOkOnly>
int launch_fleet_select(const void* const* p, int B, int P, int C, int A, int V, int D,
                        int per_area, int TP, float big, cudaStream_t stream) {
  const int tiles = (P + TP - 1) / TP;
  const size_t smem = fleet_select_smem(TP, A, kDiff == kRowDiff);
  constexpr auto kernel = fleet_select_kernel<kDiff, W, kOkOnly>;
  const cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * tiles, kSelectThreads, smem, stream>>>(
      (const float*)p[0], (const int8_t*)p[1], (const uint8_t*)p[2], (const int32_t*)p[3],
      (const int32_t*)p[4], (const int32_t*)p[5], (const uint8_t*)p[6], (const int32_t*)p[7],
      (const int32_t*)p[8], (const int32_t*)p[9], (const int32_t*)p[10],
      (const int32_t*)p[11], (uint8_t*)p[12], (float*)p[13], (uint8_t*)p[14],
      (uint8_t*)p[15], (const uint8_t*)p[16], (const float*)p[17], (const uint8_t*)p[18],
      (const uint8_t*)p[19], (const uint8_t*)p[21], (uint8_t*)p[20], tiles, TP, P, C, A, V,
      D, per_area, big);
  return (int)cudaGetLastError();
}

template <int kDiff, bool kOkOnly>
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

// Kernel 13 (ok_only false), kernel 3 (B = 1, no previous generation,
// ok_only true) or kernel 7 (B = 1, node_changed p[21] given, ok_only
// true): checks, kernel 13's changed flags zeroed, the launch.
int launch_fleet(const void* const* p, int B, int P, int C, int A, int V, int D, int per_area,
                 int tile_rows, float big, bool ok_only, cudaStream_t stream) {
  const int TP = tile_rows < P ? tile_rows : P;
  const bool row_diff = p[21] != nullptr;
  const bool diff = p[16] != nullptr;
  // a tile's winner masks and flags must fit shared memory
  if (C > 64 || tile_rows < 1 || fleet_select_smem(TP, A, row_diff) > kSelectDynamicSmem ||
      (row_diff && (B != 1 || !diff || !ok_only)))
    return (int)cudaErrorInvalidValue;
  if (diff && !row_diff) {
    cudaError_t err = cudaMemsetAsync(const_cast<void*>(p[20]), 0, (size_t)B, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (B == 0 || P == 0) return (int)cudaSuccess;
  if (row_diff)
    return launch_fleet_select_w<kRowDiff, true>(p, B, P, C, A, V, D, per_area, TP, big, stream);
  if (diff)
    return launch_fleet_select_w<kBatchDiff, false>(p, B, P, C, A, V, D, per_area, TP, big, stream);
  return ok_only
             ? launch_fleet_select_w<kNoDiff, true>(p, B, P, C, A, V, D, per_area, TP, big, stream)
             : launch_fleet_select_w<kNoDiff, false>(p, B, P, C, A, V, D, per_area, TP, big, stream);
}

// ---------------------------------------------------------------------------
// Kernel 18: the changed-row gather
// ---------------------------------------------------------------------------

constexpr int kGatherThreads = 256;
// a row of at most this many words is one thread's
constexpr long long kThreadRowWords = 4;
constexpr int kGatherTables = 4;

struct GatherTable {
  const uint8_t* src;  // [N, row_bytes]
  uint8_t* dst;        // [G, row_bytes]
  int row_bytes;
  int w;            // word bytes: 16, 8, 4 or 1
  int segs;         // blocks a row, 0 where a row is a thread's
  int first_block;  // the table's first block of the launch
};

struct GatherArgs {
  GatherTable t[kGatherTables];
};

// Copy word k of row g (source row i, or zeros where i is out of range).
template <typename Word>
__device__ __forceinline__ void gather_word(const GatherTable& t, long long i, bool in_range,
                                            long long g, long long words, long long k) {
  Word x{};
  if (in_range) x = reinterpret_cast<const Word*>(t.src)[i * words + k];
  reinterpret_cast<Word*>(t.dst)[g * words + k] = x;
}

template <typename Word>
__device__ __forceinline__ void gather_table(const GatherTable& t, int block,
                                             const int64_t* __restrict__ idx, int G, int N) {
  const long long words = t.row_bytes / t.w;
  if (t.segs == 0) {  // a thread a row
    const long long g = (long long)block * kGatherThreads + threadIdx.x;
    if (g >= G) return;
    const long long i = idx[g];
    const bool in_range = i >= 0 && i < N;
    for (long long k = 0; k < words; ++k) gather_word<Word>(t, i, in_range, g, words, k);
  } else {  // segs blocks a row, a thread a word
    const long long g = block / t.segs;
    const long long k = (long long)(block - g * t.segs) * kGatherThreads + threadIdx.x;
    const long long i = idx[g];
    if (k < words) gather_word<Word>(t, i, i >= 0 && i < N, g, words, k);
  }
}

__global__ void __launch_bounds__(kGatherThreads) gather_rows_kernel(
    const GatherArgs args, const int64_t* __restrict__ idx, int G, int N) {
  // the last table begun by this block, picked by constant indices (an
  // indexed kernel parameter would be copied to local memory)
  GatherTable t = args.t[0];
#pragma unroll
  for (int j = 1; j < kGatherTables; ++j)
    if ((int)blockIdx.x >= args.t[j].first_block) t = args.t[j];
  const int block = blockIdx.x - t.first_block;
  switch (t.w) {
    case 16: gather_table<uint4>(t, block, idx, G, N); break;
    case 8: gather_table<uint2>(t, block, idx, G, N); break;
    case 4: gather_table<uint32_t>(t, block, idx, G, N); break;
    default: gather_table<uint8_t>(t, block, idx, G, N); break;
  }
}

int launch_gather(const void* const* src, void* const* dst, const int* row_bytes,
                  const void* idx, int G, int N, cudaStream_t stream) {
  if (G < 0 || N < 0) return (int)cudaErrorInvalidValue;
  GatherArgs args{};
  long long blocks = 0;
  for (int j = 0; j < kGatherTables; ++j) {
    GatherTable& t = args.t[j];
    if (row_bytes[j] < 0) return (int)cudaErrorInvalidValue;
    t.src = (const uint8_t*)src[j];
    t.dst = (uint8_t*)dst[j];
    t.row_bytes = row_bytes[j];
    // the widest word that divides the row's bytes and both tables' alignment
    int w = 16;
    while (w > 1 && (t.row_bytes % w || (uintptr_t)src[j] % w || (uintptr_t)dst[j] % w))
      w = w > 4 ? w / 2 : 1;
    t.w = w;
    const long long words = t.row_bytes / w;
    t.first_block = (int)blocks;
    long long n = 0;
    if (words > kThreadRowWords) {
      t.segs = (int)((words + kGatherThreads - 1) / kGatherThreads);
      n = (long long)G * t.segs;
    } else if (words > 0) {
      n = ((long long)G + kGatherThreads - 1) / kGatherThreads;
    }
    blocks += n;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return (int)cudaSuccess;
  gather_rows_kernel<<<(unsigned)blocks, kGatherThreads, 0, stream>>>(
      args, (const int64_t*)idx, G, N);
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
  const void* p[22] = {dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
                       drain_metric, path_pref, source_pref, distance, cand_node_in_area,
                       use, shortest, lanes, valid, prev_use, prev_shortest, prev_lanes,
                       prev_valid, changed, nullptr};
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
  const void* p[22] = {dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
                       drain_metric, path_pref, source_pref, distance, cand_node_in_area,
                       use, shortest, lanes, valid, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr};
  return launch_fleet(p, 1, P, C, A, V, D, per_area, tile_rows, big, true,
                      (cudaStream_t)stream);
}

// Kernel 7: kernel 3 with the per-row diff against prev_* and the touches
// of node_changed, changed [P].
extern "C" int openr_multi_area_select_delta(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_area, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* cand_node_in_area, void* use,
    void* shortest, void* lanes, void* valid, const void* prev_use,
    const void* prev_shortest, const void* prev_lanes, const void* prev_valid,
    const void* node_changed, void* changed, int P, int C, int A, int V,
    int D, int per_area, int tile_rows, float big, void* stream) {
  const void* p[22] = {dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
                       drain_metric, path_pref, source_pref, distance, cand_node_in_area,
                       use, shortest, lanes, valid, prev_use, prev_shortest, prev_lanes,
                       prev_valid, changed, node_changed};
  return launch_fleet(p, 1, P, C, A, V, D, per_area, tile_rows, big, true,
                      (cudaStream_t)stream);
}

// Kernel 18: rows idx [G] (int64) of the four tables [N, ...] (row bytes
// each) into [G, ...]; G = 0 launches nothing.
extern "C" int openr_gather_selection_rows(
    const void* use, const void* shortest, const void* lanes, const void* valid,
    void* use_out, void* shortest_out, void* lanes_out, void* valid_out,
    const void* idx, int G, int N, int use_bytes, int shortest_bytes, int lanes_bytes,
    int valid_bytes, void* stream) {
  const void* src[4] = {use, shortest, lanes, valid};
  void* dst[4] = {use_out, shortest_out, lanes_out, valid_out};
  const int row_bytes[4] = {use_bytes, shortest_bytes, lanes_bytes, valid_bytes};
  if (G == 0) return (int)cudaSuccess;
  return launch_gather(src, dst, row_bytes, idx, G, N, (cudaStream_t)stream);
}
