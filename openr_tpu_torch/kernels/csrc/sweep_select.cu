// What-if sweep selection and delta compaction for Hopper (sm_90a):
// kernels 10, 11 and 17.
//
// Kernel 10 replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/sweep_select.py:155 _select_chunk
// (its body: openr_tpu/ops/route_select.py:39 select_routes_one,
// SpfSolver.cpp:161-312).  For every snapshot s of a chunk and every
// prefix p over its C candidate advertisements:
//   reach (candidate ok, its node's d[node, s] < BIG) ▸ hard-drain filter
//   with all-drained fallback ▸ keep-max of not-drained, path_pref,
//   source_pref ▸ keep-min of distance ▸ skip-if-self ▸ igp tie: the
//   winners at the least SPF distance OR their first-hop lanes ▸ valid =
//   a winner, not self, reached, >= 1 lane and >= the min-nexthop
//   requirement (max over the selection winners, 0 for other slots)
// then diffs the route against the base route: changed iff validity
// differs, or both are valid and the metric or a lane word differs.
// Outputs: changed [b, ceil(P/32)] uint32 (bit p % 32), valid [b, P],
// metric [b, P] f32, lanes [b, P, ceil(D/32)] uint32.  The engine also
// runs the base selection through it, as a one-snapshot batch.
//
// Design: one thread per (snapshot, prefix); a warp is 32 consecutive
// prefixes of one snapshot, so __ballot_sync of the 32 changed flags IS
// the packed changed word, and the valid/metric/lane stores coalesce.  The
// candidate sets are 64-bit masks in registers (C <= 64).  The lanes come
// straight from the repair's batch-packed words (bit s % 32 of word
// s / 32 at [node, lane]).  What bounds it: bytes — the candidate
// columns are read once per snapshot (L2-resident across snapshots), the
// outputs written once.
//
// Kernel 11 replaces
//   openr_tpu/ops/sweep_select.py:274 _compact_deltas
// over the sweep-wide buffers (every chunk's kernel-10 rows stacked;
// row_id maps a buffer row to its global unique-solve row, -1 on padding
// snapshots): every changed (row, prefix) lands in [cap] buffers in
// global flat order (rows in order, then prefixes), rows beyond cap drop,
// the count stays exact (int64), fills are -1 for the coordinates and 0
// elsewhere.  Three passes, no library scan: each block popcounts 1024
// changed words; one block scans the block counts (int64 offsets, so no
// overflow at 16k snapshots x 409,600 prefixes); each block re-counts,
// scans within the block (warp shuffles) and writes its set bits in bit
// order.  What bounds it: bytes — the changed words once, the rows it
// copies once.
//
// Kernel 17 replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/route_select.py:112 batched_select_routes
// (and the selection half of :449 spf_and_select, the flagship step): the
// same chain (select_chain, shared with kernel 10) for every (row,
// prefix), with the row's own hard drains, soft drains and root, against
// row tables dist [B, V] and unpacked int8 lanes nh [B, V, D]; it writes
// all five outputs (valid, metric, lanes [B, P, D] int8, num_nexthops,
// use [B, P, C]).  Design: one thread per (row, prefix), rows on grid x
// through a grid-stride loop (kernel 10's per-snapshot grid y stops at
// 65,535).  What bounds it: bytes — the outputs are written once (the
// lanes [B, P, D] and use [B, P, C] dominate), each row's dist and the
// winners' lane rows are gathered from L2.
//
// Traps: metric comparisons are exact (no --use_fast_math); a prefix
// beyond P in the last changed word is masked off; kernel 17's lane rows
// (D = 17 on the flagship world) are read and written bytewise, no
// alignment assumed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSelectThreads = 256;
constexpr int kCompactThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t bit(int c) { return 1ull << c; }

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

// The selection chain of one prefix row over its C candidates (the row's
// columns: node, ok, drain_metric, path_pref, source_pref, distance,
// min_nexthop), against one snapshot's SPF distances, hard-drain bits and
// soft-drain increments, read through dist_of(n), hard_of(n) and
// soft_of(n).  Kernels 10 and 17 share it; only their lane layouts differ.
struct Selection {
  uint64_t use;      // the selection winners (after the min distance)
  uint64_t winners;  // those of them at the least SPF distance
  float best_igp;    // that distance (big when there is no winner)
  int32_t req;       // min-nexthop requirement: max over use, 0 elsewhere
  bool self_wins;    // the root advertises among the winners
};

template <class Dist, class Hard, class Soft>
__device__ __forceinline__ Selection select_chain(
    const int32_t* node, const uint8_t* ok, const int32_t* drain_metric,
    const int32_t* path_pref, const int32_t* source_pref,
    const int32_t* distance, const int32_t* min_nexthop, int C, int root,
    float big, Dist dist_of, Hard hard_of, Soft soft_of) {
  uint64_t reach = 0, hard = 0;
  for (int c = 0; c < C; ++c) {
    const int n = node[c];
    if (ok[c] && dist_of(n) < big) reach |= bit(c);
    if (hard_of(n)) hard |= bit(c);
  }
  const uint64_t nonhard = reach & ~hard;
  uint64_t use = nonhard ? nonhard : reach;
  // not drained: neither an advertised drain metric nor a soft drain
  int32_t best = INT32_MIN;
  for (int c = 0; c < C; ++c)
    if (use & bit(c)) {
      const int32_t k = (drain_metric[c] > 0 || soft_of(node[c]) > 0) ? 0 : 1;
      best = k > best ? k : best;
    }
  uint64_t kept = 0;
  for (int c = 0; c < C; ++c)
    if (use & bit(c)) {
      const int32_t k = (drain_metric[c] > 0 || soft_of(node[c]) > 0) ? 0 : 1;
      if (k == best) kept |= bit(c);
    }
  use = kept;
  use = keep_max(use, path_pref, C);
  use = keep_max(use, source_pref, C);
  int32_t lo = INT32_MAX;
  for (int c = 0; c < C; ++c)
    if ((use & bit(c)) && distance[c] < lo) lo = distance[c];
  kept = 0;
  for (int c = 0; c < C; ++c)
    if ((use & bit(c)) && distance[c] == lo) kept |= bit(c);
  use = kept;

  Selection sel{use, 0, big, INT32_MIN, false};
  for (int c = 0; c < C; ++c) {
    const bool u = use & bit(c);
    if (u && node[c] == root) sel.self_wins = true;
    if (u) sel.best_igp = fminf(sel.best_igp, dist_of(node[c]));
    const int32_t r = u ? min_nexthop[c] : 0;
    sel.req = r > sel.req ? r : sel.req;
  }
  for (int c = 0; c < C; ++c)
    if ((use & bit(c)) && dist_of(node[c]) == sel.best_igp) sel.winners |= bit(c);
  return sel;
}

__global__ void __launch_bounds__(kSelectThreads) select_chunk_kernel(
    const float* __restrict__ dist, const uint32_t* __restrict__ nh,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ cand_node, const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance,
    const int32_t* __restrict__ min_nexthop,
    const uint8_t* __restrict__ base_valid,
    const float* __restrict__ base_metric,
    const uint32_t* __restrict__ base_lanes, uint32_t* __restrict__ changed_out,
    uint8_t* __restrict__ valid_out, float* __restrict__ metric_out,
    uint32_t* __restrict__ lanes_out, int V, int b, int P, int C, int D,
    int root, float big) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int Bw = (b + 31) / 32;
  const int Dw = (D + 31) / 32;
  const int Pw = (P + 31) / 32;
  const int sw = s >> 5;
  const int sb = s & 31;
  bool changed = false;
  if (p < P) {
    const size_t row = (size_t)p * C;
    const int32_t* node = cand_node + row;
    const Selection sel = select_chain(
        node, cand_ok + row, drain_metric + row, path_pref + row,
        source_pref + row, distance + row, min_nexthop + row, C, root, big,
        [&](int n) { return dist[(size_t)n * b + s]; },
        [&](int n) { return overloaded[n] != 0; },
        [&](int n) { return soft[n]; });

    int num_nh = 0;
    bool lanes_differ = false;
    uint32_t* lanes_row = lanes_out + ((size_t)s * P + p) * Dw;
    for (int k = 0; k < Dw; ++k) {
      uint32_t word = 0;
      const int d_end = D < 32 * (k + 1) ? D : 32 * (k + 1);
      for (int c = 0; c < C; ++c) {
        if (!(sel.winners & bit(c))) continue;
        const uint32_t* src = nh + (size_t)node[c] * D * Bw + sw;
        for (int d = 32 * k; d < d_end; ++d)
          word |= ((src[(size_t)d * Bw] >> sb) & 1u) << (d - 32 * k);
      }
      lanes_row[k] = word;
      num_nh += __popc(word);
      lanes_differ |= word != base_lanes[(size_t)p * Dw + k];
    }
    const bool valid = sel.winners && !sel.self_wins && sel.best_igp < big &&
                       num_nh > 0 && num_nh >= sel.req;
    valid_out[(size_t)s * P + p] = valid;
    metric_out[(size_t)s * P + p] = sel.best_igp;
    const bool bv = base_valid[p];
    changed = (valid != bv) ||
              (valid && bv && (sel.best_igp != base_metric[p] || lanes_differ));
  }
  const uint32_t word = __ballot_sync(kFull, changed);
  if ((threadIdx.x & 31) == 0 && p < P) changed_out[(size_t)s * Pw + (p >> 5)] = word;
}

// Kernel 17: the chain for every (row, prefix) pair i = b * P + p, one
// thread each in a grid-stride loop (rows on grid x: no 65,535 limit),
// against row b's tables dist [B, V] and unpacked int8 lanes nh [B, V, D],
// hard drains overloaded [B, V], soft drains soft [B, V] and root
// roots[b].  The lane union is the reference's int8 max over the
// candidates, a non-winner contributing 0 (so a lone winner's -128 fill
// row survives, as there); num_nh sums the lanes in int32.
__global__ void __launch_bounds__(kSelectThreads) batched_select_kernel(
    const float* __restrict__ dist, const int8_t* __restrict__ nh,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ soft,
    const int32_t* __restrict__ roots, const int32_t* __restrict__ cand_node,
    const uint8_t* __restrict__ cand_ok,
    const int32_t* __restrict__ drain_metric,
    const int32_t* __restrict__ path_pref,
    const int32_t* __restrict__ source_pref,
    const int32_t* __restrict__ distance,
    const int32_t* __restrict__ min_nexthop, uint8_t* __restrict__ valid_out,
    float* __restrict__ metric_out, int8_t* __restrict__ nh_out,
    int32_t* __restrict__ num_out, uint8_t* __restrict__ use_out, int B,
    int V, int P, int C, int D, float big) {
  const size_t total = (size_t)B * P;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / P);
    const int p = (int)(i - (size_t)b * P);
    const size_t row = (size_t)p * C;
    const int32_t* node = cand_node + row;
    const float* d = dist + (size_t)b * V;
    const uint8_t* ovl = overloaded + (size_t)b * V;
    const int32_t* sft = soft + (size_t)b * V;
    const Selection sel = select_chain(
        node, cand_ok + row, drain_metric + row, path_pref + row,
        source_pref + row, distance + row, min_nexthop + row, C, roots[b],
        big, [&](int n) { return d[n]; }, [&](int n) { return ovl[n] != 0; },
        [&](int n) { return sft[n]; });
    for (int c = 0; c < C; ++c) use_out[i * C + c] = (sel.use >> c) & 1u;
    const int8_t* lanes = nh + (size_t)b * V * D;
    int num_nh = 0;
    for (int l = 0; l < D; ++l) {
      int x = INT32_MIN;
      for (int c = 0; c < C; ++c) {
        const int y = (sel.winners & bit(c)) ? lanes[(size_t)node[c] * D + l] : 0;
        x = y > x ? y : x;
      }
      nh_out[i * D + l] = (int8_t)x;
      num_nh += x;
    }
    num_out[i] = num_nh;
    valid_out[i] = sel.winners && !sel.self_wins && sel.best_igp < big &&
                   num_nh > 0 && num_nh >= sel.req;
    metric_out[i] = sel.best_igp;
  }
}

// changed word g of the sweep-wide buffer, padding rows and the bits past
// P in a row's last word masked off
__device__ __forceinline__ uint32_t live_word(const uint32_t* changed,
                                              const int32_t* row_id, size_t g,
                                              int Pw, int P) {
  const size_t r = g / Pw;
  const int wi = (int)(g - r * Pw);
  uint32_t m = row_id[r] >= 0 ? changed[g] : 0u;
  const int tail = P - wi * 32;
  if (tail < 32) m &= (1u << tail) - 1u;
  return m;
}

// exclusive scan of x over the block; *total gets the block's sum
__device__ long long block_exclusive_scan(long long x, long long* total) {
  __shared__ long long warp_sums[32];
  __shared__ long long block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long t = lane < nwarps ? warp_sums[lane] : 0;
    long long ti = t;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, ti, o);
      if (lane >= o) ti += y;
    }
    if (lane < nwarps) warp_sums[lane] = ti - t;
    if (lane == 31) block_total = ti;
  }
  __syncthreads();
  const long long out = warp_sums[warp] + inc - x;
  *total = block_total;
  __syncthreads();  // the shared sums are reused by the next call
  return out;
}

__global__ void __launch_bounds__(kCompactThreads) compact_count_kernel(
    const uint32_t* __restrict__ changed, const int32_t* __restrict__ row_id,
    long long* __restrict__ block_sums, size_t words, int Pw, int P) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const long long c = g < words ? __popc(live_word(changed, row_id, g, Pw, P)) : 0;
  long long total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// one block: block counts -> exclusive block offsets, and the total
__global__ void __launch_bounds__(kCompactThreads) compact_scan_kernel(
    long long* __restrict__ block_sums, long long* __restrict__ count,
    int nblocks) {
  long long carry = 0;
  for (int base = 0; base < nblocks; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const long long x = i < nblocks ? block_sums[i] : 0;
    long long total;
    const long long excl = block_exclusive_scan(x, &total);
    if (i < nblocks) block_sums[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) count[0] = carry;
}

__global__ void __launch_bounds__(kCompactThreads) compact_scatter_kernel(
    const uint32_t* __restrict__ changed, const uint8_t* __restrict__ valid,
    const float* __restrict__ metric, const uint32_t* __restrict__ lanes,
    const int32_t* __restrict__ row_id,
    const long long* __restrict__ block_offs, int32_t* __restrict__ row_out,
    int32_t* __restrict__ pref_out, uint8_t* __restrict__ valid_out,
    float* __restrict__ metric_out, uint32_t* __restrict__ lanes_out,
    size_t words, int Pw, int P, int Dw, long long cap) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t m = g < words ? live_word(changed, row_id, g, Pw, P) : 0u;
  long long total;
  long long pos = block_offs[blockIdx.x] + block_exclusive_scan(__popc(m), &total);
  if (!m) return;
  const size_t r = g / Pw;
  const int wi = (int)(g - r * Pw);
  while (m && pos < cap) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const int p = wi * 32 + j;
    const size_t at = r * (size_t)P + p;
    row_out[pos] = row_id[r];
    pref_out[pos] = p;
    valid_out[pos] = valid[at];
    metric_out[pos] = metric[at];
    for (int k = 0; k < Dw; ++k) lanes_out[pos * Dw + k] = lanes[at * Dw + k];
    ++pos;
  }
}

}  // namespace

extern "C" int openr_select_chunk(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* cand_node, const void* cand_ok, const void* drain_metric,
    const void* path_pref, const void* source_pref, const void* distance,
    const void* min_nexthop, const void* base_valid, const void* base_metric,
    const void* base_lanes, void* changed, void* valid, void* metric,
    void* lanes, int V, int b, int P, int C, int D, int root, float big,
    void* stream) {
  const dim3 grid((P + kSelectThreads - 1) / kSelectThreads, b);
  select_chunk_kernel<<<grid, kSelectThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dist, (const uint32_t*)nh, (const uint8_t*)overloaded,
      (const int32_t*)soft, (const int32_t*)cand_node,
      (const uint8_t*)cand_ok, (const int32_t*)drain_metric,
      (const int32_t*)path_pref, (const int32_t*)source_pref,
      (const int32_t*)distance, (const int32_t*)min_nexthop,
      (const uint8_t*)base_valid, (const float*)base_metric,
      (const uint32_t*)base_lanes, (uint32_t*)changed, (uint8_t*)valid,
      (float*)metric, (uint32_t*)lanes, V, b, P, C, D, root, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_compact_deltas(
    const void* changed, const void* valid, const void* metric,
    const void* lanes, const void* row_id, void* block_sums, void* count,
    void* row_out, void* pref_out, void* valid_out, void* metric_out,
    void* lanes_out, int R, int P, int Dw, int cap, int blocks,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Pw = (P + 31) / 32;
  const size_t words = (size_t)R * Pw;
  compact_count_kernel<<<blocks, kCompactThreads, 0, st>>>(
      (const uint32_t*)changed, (const int32_t*)row_id,
      (long long*)block_sums, words, Pw, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scan_kernel<<<1, kCompactThreads, 0, st>>>(
      (long long*)block_sums, (long long*)count, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // fills: -1 coordinates, 0 elsewhere
  const size_t n = (size_t)cap;
  if ((err = cudaMemsetAsync(row_out, 0xff, n * sizeof(int32_t), st)) ||
      (err = cudaMemsetAsync(pref_out, 0xff, n * sizeof(int32_t), st)) ||
      (err = cudaMemsetAsync(valid_out, 0, n, st)) ||
      (err = cudaMemsetAsync(metric_out, 0, n * sizeof(float), st)) ||
      (err = cudaMemsetAsync(lanes_out, 0, n * Dw * sizeof(uint32_t), st)))
    return (int)err;
  compact_scatter_kernel<<<blocks, kCompactThreads, 0, st>>>(
      (const uint32_t*)changed, (const uint8_t*)valid, (const float*)metric,
      (const uint32_t*)lanes, (const int32_t*)row_id,
      (const long long*)block_sums, (int32_t*)row_out, (int32_t*)pref_out,
      (uint8_t*)valid_out, (float*)metric_out, (uint32_t*)lanes_out, words, Pw,
      P, Dw, (long long)cap);
  return (int)cudaGetLastError();
}

extern "C" int openr_batched_select_routes(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* roots, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* min_nexthop, void* valid, void* metric,
    void* nh_out, void* num_nh, void* use, int B, int V, int P, int C, int D,
    float big, void* stream) {
  const size_t total = (size_t)B * P;
  if (total == 0) return (int)cudaSuccess;
  const size_t want = (total + kSelectThreads - 1) / kSelectThreads;
  const int blocks = (int)(want < (1u << 30) ? want : (1u << 30));
  batched_select_kernel<<<blocks, kSelectThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dist, (const int8_t*)nh, (const uint8_t*)overloaded,
      (const int32_t*)soft, (const int32_t*)roots, (const int32_t*)cand_node,
      (const uint8_t*)cand_ok, (const int32_t*)drain_metric,
      (const int32_t*)path_pref, (const int32_t*)source_pref,
      (const int32_t*)distance, (const int32_t*)min_nexthop, (uint8_t*)valid,
      (float*)metric, (int8_t*)nh_out, (int32_t*)num_nh, (uint8_t*)use, B, V,
      P, C, D, big);
  return (int)cudaGetLastError();
}
