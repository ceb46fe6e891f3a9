// Multi-area best-route selection for Hopper (sm_90a).
//
// Replaces the jitted XLA kernels of the JAX package
//   openr_tpu/ops/route_select.py:267 multi_area_select_from_tables
//       (kernel 3 here: multi_area_select_kernel<false>)
//   openr_tpu/ops/route_select.py:368 multi_area_select_delta_from_tables
//       (kernel 7 here: multi_area_select_kernel<true>)
// and the vmap of kernel 3 over vantage roots or failure snapshots in
//   openr_tpu/ops/fleet_tables.py:27, :89, :154 (with the per-root diff
//       of :205-210) and :217
//       (kernel 13 here: fleet_select_kernel<false / true>)
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
// (bool tensors, one byte each).  Kernel 7 runs the same body (the
// template flag) and then flags changed[p] when any output differs from
// the previous generation's, or when a candidate touches a node whose
// drain state moved (node_changed [A, V]): for cand_ok slots, the
// candidate's own-area cell and every area's cell it resolves to
// (cand_node_in_area >= 0).  The host re-decodes only the flagged rows.
//
// Design: one thread per row, looping over C, A and D; the row's
// candidate sets are bitmasks in a register (C <= 64, the largest
// candidate bucket).  What bounds it: bytes.  Each row reads its [C] and
// [C, A] candidate columns once and writes its outputs once; the SPF
// tables it gathers from are small and stay in L2.
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

namespace {

constexpr int kThreads = 256;

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

// The selection chain of row p; with kDiff, returns whether any output
// differs from the previous generation's (else false).
template <bool kDiff>
__device__ __forceinline__ bool select_row(
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
    if (kDiff) changed |= u != prev_use[row + c];
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
      if (kDiff) changed |= (hits > 0) != (prev_lanes[out * D + l] != 0);
    }
    const bool valid = mc != 0 && num_nh > 0;
    shortest_out[out] = shortest;
    valid_out[out] = valid;
    if (kDiff) {
      changed |= shortest != prev_shortest[out];
      changed |= valid != (prev_valid[out] != 0);
    }
  }
  return changed;
}

template <bool kDelta>
__global__ void __launch_bounds__(kThreads) multi_area_select_kernel(
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
  bool changed = select_row<kDelta>(
      p, dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
      drain_metric, path_pref, source_pref, distance, cand_node_in_area,
      use_out, shortest_out, lanes_out, valid_out, prev_use, prev_shortest,
      prev_lanes, prev_valid, C, A, V, D, per_area, big);
  if (!kDelta) return;
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

// Kernel 13: the chain for every (batch row b, prefix row p); row b reads
// its own tables dist [b, A, V] and nh [b, A, V, D] and writes its own
// outputs, the candidate tables are shared.  With kDiff, changed[b] (zeroed
// before the launch) is set when any output of the row's P rows differs
// from prev_* [b, ...]: a block vote, then one store per block.
template <bool kDiff>
__global__ void __launch_bounds__(kThreads) fleet_select_kernel(
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
    int blocks_per_row, int P, int C, int A, int V, int D, int per_area,
    float big) {
  const int b = blockIdx.x / blocks_per_row;
  const int p = (blockIdx.x - b * blocks_per_row) * blockDim.x + threadIdx.x;
  const size_t sel = (size_t)b * P;  // this row's first output row
  const size_t tables = (size_t)b * A * V;
  bool changed = false;
  if (p < P)
    changed = select_row<kDiff>(
        p, dist + tables, nh + tables * D, overloaded, soft, cand_area,
        cand_node, cand_ok, drain_metric, path_pref, source_pref, distance,
        cand_node_in_area, use_out + sel * C, shortest_out + sel * A,
        lanes_out + sel * A * D, valid_out + sel * A,
        kDiff ? prev_use + sel * C : nullptr,
        kDiff ? prev_shortest + sel * A : nullptr,
        kDiff ? prev_lanes + sel * A * D : nullptr,
        kDiff ? prev_valid + sel * A : nullptr, C, A, V, D, per_area, big);
  if (kDiff && __syncthreads_or(changed) && threadIdx.x == 0) changed_out[b] = 1;
}

template <bool kDelta>
int launch_select(const void* dist, const void* nh, const void* overloaded,
                  const void* soft, const void* cand_area,
                  const void* cand_node, const void* cand_ok,
                  const void* drain_metric, const void* path_pref,
                  const void* source_pref, const void* distance,
                  const void* cand_node_in_area, void* use, void* shortest,
                  void* lanes, void* valid, const void* prev_use,
                  const void* prev_shortest, const void* prev_lanes,
                  const void* prev_valid, const void* node_changed,
                  void* changed, int P, int C, int A, int V, int D,
                  int per_area, float big, void* stream) {
  if (C > 64) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const int blocks = (P + kThreads - 1) / kThreads;
  multi_area_select_kernel<kDelta>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)dist, (const int8_t*)nh, (const uint8_t*)overloaded,
          (const int32_t*)soft, (const int32_t*)cand_area,
          (const int32_t*)cand_node, (const uint8_t*)cand_ok,
          (const int32_t*)drain_metric, (const int32_t*)path_pref,
          (const int32_t*)source_pref, (const int32_t*)distance,
          (const int32_t*)cand_node_in_area, (uint8_t*)use, (float*)shortest,
          (uint8_t*)lanes, (uint8_t*)valid, (const uint8_t*)prev_use,
          (const float*)prev_shortest, (const uint8_t*)prev_lanes,
          (const uint8_t*)prev_valid, (const uint8_t*)node_changed,
          (uint8_t*)changed, P, C, A, V, D, per_area, big);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int openr_multi_area_select(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_area, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* cand_node_in_area, void* use,
    void* shortest, void* lanes, void* valid, int P, int C, int A, int V,
    int D, int per_area, float big, void* stream) {
  return launch_select<false>(
      dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
      path_pref, source_pref, distance, cand_node_in_area, use, shortest,
      lanes, valid, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, P,
      C, A, V, D, per_area, big, stream);
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
  return launch_select<true>(
      dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
      path_pref, source_pref, distance, cand_node_in_area, use, shortest,
      lanes, valid, prev_use, prev_shortest, prev_lanes, prev_valid,
      node_changed, changed, P, C, A, V, D, per_area, big, stream);
}

extern "C" int openr_fleet_select(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_area, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* cand_node_in_area, void* use,
    void* shortest, void* lanes, void* valid, const void* prev_use,
    const void* prev_shortest, const void* prev_lanes, const void* prev_valid,
    void* changed, int B, int P, int C, int A, int V, int D, int per_area,
    float big, void* stream) {
  if (C > 64) return (int)cudaErrorInvalidValue;
  const bool diff = prev_use != nullptr;
  if (diff) {
    cudaError_t err = cudaMemsetAsync(changed, 0, (size_t)B, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (B == 0 || P == 0) return (int)cudaSuccess;
  const int per_row = (P + kThreads - 1) / kThreads;
  const auto kernel = diff ? fleet_select_kernel<true> : fleet_select_kernel<false>;
  kernel<<<B * per_row, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dist, (const int8_t*)nh, (const uint8_t*)overloaded,
      (const int32_t*)soft, (const int32_t*)cand_area,
      (const int32_t*)cand_node, (const uint8_t*)cand_ok,
      (const int32_t*)drain_metric, (const int32_t*)path_pref,
      (const int32_t*)source_pref, (const int32_t*)distance,
      (const int32_t*)cand_node_in_area, (uint8_t*)use, (float*)shortest,
      (uint8_t*)lanes, (uint8_t*)valid, (const uint8_t*)prev_use,
      (const float*)prev_shortest, (const uint8_t*)prev_lanes,
      (const uint8_t*)prev_valid, (uint8_t*)changed, per_row, P, C, A, V, D,
      per_area, big);
  return (int)cudaGetLastError();
}
