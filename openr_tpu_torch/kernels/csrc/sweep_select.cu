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
// Design: a block takes a tile of prefixes x snapshots of one 32-snapshot
// word sw (grid x: tiles along P, grid y: words).  Where the chunk holds 32
// snapshots or more, a warp takes one prefix and a warp lane one snapshot
// (bp = 32); below 32, bp is the chunk's snapshot count rounded up to a
// power of two and a warp takes 32 / bp prefixes of bp lanes each, so no
// lane idles past the rounding (at b = 1, a warp is 32 consecutive
// prefixes of the one snapshot, and it stores its results directly).  The
// tile is 32 prefixes where bp >= 8, else 256 / bp, so a block of 256
// threads covers it in TP * bp / 256 passes.  So:
//   * the candidate columns and the base row (base_valid, base_metric,
//     base_lanes) are uniform across a lane group: broadcast loads;
//   * dist[n * b + 32 sw + lane] is one coalesced 128-byte line per
//     candidate (with a prefix a lane, 32 rows n, a sector each);
//   * where a warp is one prefix, a winner's lanes are one load of its 32
//     lane words nh[node, 32 k + lane, sw] and a 32 x 32 bit transpose
//     across the warp (five shuffles), after which lane s holds snapshot
//     s's bits; below, one broadcast word nh[node, d, sw] per (winner, d),
//     of which each lane takes its own bit.
// The chain (select_chain, shared with kernel 17) skips what cannot change
// its result: candidates that are not ok past the first loop, and the keep
// filters where one candidate is left.
// Results are staged in shared memory (a snapshot's row of the stage
// padded by the lane-group count, so the stores of a warp hit 32 banks),
// then written transposed: a warp stores 32 consecutive prefixes of one
// snapshot, so the valid, metric and lane stores coalesce along P, and the
// snapshot's changed word over those prefixes is one __ballot_sync.  Lane
// words are staged where they fit (D <= 128); above, each lane stores its
// own words.  The candidate sets are 64-bit masks in registers (C <= 64).
// What bounds it: bytes - the distances and lane words the chain reads,
// the candidate columns (L1/L2-resident across words) and the outputs,
// once each.
//
// Kernel 11 replaces
//   openr_tpu/ops/sweep_select.py:274 _compact_deltas
// over the sweep-wide buffers (every chunk's kernel-10 rows stacked;
// row_id maps a buffer row to its global unique-solve row, -1 on padding
// snapshots): every changed (row, prefix) lands in [cap] buffers in
// global flat order (rows in order, then prefixes), rows beyond cap drop,
// the count stays exact (int64), fills are -1 for the coordinates and 0
// elsewhere.  One launch, no memset: a single-pass scan with decoupled
// look-back.  A tile is kCompactTileWords changed words (a thread loads
// kCompactWords of them as one 16-byte word where aligned); tiles take
// their ids from an atomic ticket, so a tile only ever waits on tiles that
// have already started.  A tile counts its live bits (padding rows and the
// bits past P masked), scans them within the block (warp shuffles, int64),
// publishes its aggregate, then warp 0 looks back over its predecessors'
// status words 32 at a time: each adds an aggregate until the nearest
// inclusive prefix, which ends the walk; the tile then publishes its own
// inclusive prefix.  A status word packs the call's epoch (26 bits), a
// flag (aggregate or inclusive prefix) and the int64 sum in 36 bits (16k
// snapshots x 409,600 prefixes is 6.7e9, past 32 bits), so words left by
// an earlier call are never read as this call's.  The ticket word holds
// the epoch in its high half and the ticket count in its low half (one
// 64-bit atomicAdd gives a block both); the block that takes the last
// ticket sets the count back to 0 and the epoch to the next, so the
// scratch (the ticket word, the status words and a done count, zeroed
// once when the launcher allocates it) is never reset between calls, and a
// CUDA graph may replay the launch.  The epoch repeats every 2^26 calls,
// and a word an earlier large call left past a later call's last tile
// would then read as that call's: so the call whose epoch is the cycle's
// last clears every status word, the last of its blocks to be done with
// them (counted in the done word after them) doing it, and a word of the
// current epoch with a flag set was always written by the current call.  The tile then writes its set bits at their
// global ranks while the rank is below cap, spread over the block: the
// tile's bits (consecutive ranks) go to its threads in turn,
// bit k to thread k % 256, 8 a thread at a time with their loads issued
// together (a thread finds a bit's word by a binary search over the
// threads' first ranks, kept in shared memory with the tile's words, and
// the bit by __fns), so a dense word holds up no thread and consecutive
// threads store to consecutive slots; the last tile writes the count.
// The blocks whose tickets come after the tiles' (ops/sweep_select.py
// compact_fillers: one per 8,192 slots of cap, at most 264) fill the
// slots [min(count, cap), cap) in 16-byte words: they wait for the last
// tile's inclusive prefix, which cannot deadlock, since every tile has
// taken its ticket, and so runs, before any filler waits.  What bounds it:
// bytes - the changed words once, the rows it copies and the fills once;
// a call is one launch, so on the main path's launch-sized shapes the
// host's issue time.
//
// Kernel 17 replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/route_select.py:112 batched_select_routes
// (and the selection half of :449 spf_and_select, the flagship step): the
// same chain (select_chain, shared with kernel 10) for every (row,
// prefix), with the row's own hard drains, soft drains and root, against
// row tables dist [B, V] and unpacked int8 lanes nh [B, V, D]; it writes
// all five outputs (valid, metric, lanes [B, P, D] int8, num_nexthops,
// use [B, P, C]).  Design: a block of 256 threads per tile of TP
// consecutive prefixes of one row b (TP from the launcher), so each of the
// tile's outputs is one contiguous span of [B, P, *].  The block stages
// row b's dist, overloaded and soft, and then its lane rows nh[b], in
// shared memory by cp.async where they fit beside the tile's lane and use
// stages (else it reads them from L2).  A thread per prefix then runs the chain, writes metric,
// num and valid at once (consecutive prefixes, consecutive addresses),
// and forms its D lane bytes as up to 16 words in registers: the bytewise
// signed max (__vmaxs4) of the winners' lane words (each two aligned
// words and a funnel shift), the first winner's clamped at 0 where a
// candidate is no winner (a non-winner contributes 0, so a lone winner's
// -128 fill survives only where every candidate wins, as in the
// reference), num the signed byte sum (__dp4a).  It ORs its lane words
// and its use bytes (4 a word) into zeroed stages in shared memory, placed
// at the output spans' alignment mod 16 (neighbouring prefixes share
// words: shared atomics); the block then stores both spans as 16-byte
// words, with the head and tail bytes apart (at D = 17 a span starts
// mid-word).  What bounds it: bytes — the outputs are written once (the
// lanes [B, P, D] and use [B, P, C] dominate) and each row's tables, the
// lane table among them, read once; at the flagship shape the chain and
// the lanes' instructions cost more than the copies (PERF.md).
//
// Traps: metric comparisons are exact (no --use_fast_math); a prefix
// beyond P in the last changed word is masked off; kernel 17's lane rows
// (D = 17 on the flagship world) start at any byte, so a lane word is read
// as two aligned words and a funnel shift (from L2 the second only where
// the row reaches into it: never past the table).

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

// kernel 11's tile: threads, the changed words a thread takes (one
// 16-byte load) and the words a tile takes (ops/sweep_select.py
// COMPACT_TILE_WORDS, held equal by a test)
constexpr int kCompactThreads = 256;
constexpr int kCompactWords = 4;
constexpr int kCompactTileWords = kCompactThreads * kCompactWords;
// set bits a thread of kernel 11 scatters at once (their loads together)
constexpr int kScatterBits = 8;
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

// The chain skips what cannot change its result:
//   * a candidate that is not ok is never reached, so it needs no
//     distance or hard-drain bit, and the candidates after the last ok one
//     never join the selection: the later loops stop before them (a row
//     with no ok candidate has no winner, so its min-nexthop requirement,
//     then INT32_MIN rather than 0, decides nothing);
//   * where at most one candidate survives the reach and hard-drain
//     filters, the keep-max and keep-min filters keep it as it is.
template <class Dist, class Hard, class Soft>
__device__ __forceinline__ Selection select_chain(
    const int32_t* node, const uint8_t* ok, const int32_t* drain_metric,
    const int32_t* path_pref, const int32_t* source_pref,
    const int32_t* distance, const int32_t* min_nexthop, int C, int root,
    float big, Dist dist_of, Hard hard_of, Soft soft_of) {
  uint64_t reach = 0, hard = 0;
  int last_ok = -1;
  for (int c = 0; c < C; ++c) {
    const int n = node[c];
    if (ok[c]) {
      last_ok = c;
      if (dist_of(n) < big) reach |= bit(c);
      if (hard_of(n)) hard |= bit(c);
    }
  }
  C = last_ok + 1;
  const uint64_t nonhard = reach & ~hard;
  uint64_t use = nonhard ? nonhard : reach;
  if (use & (use - 1)) {
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
  }

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

// Kernel 10's tile (see the header): 256 threads; its stage, in dynamic
// shared memory (none where b = 1), holds for each of the bp x stride
// (snapshot, prefix) slots a metric, the flags and, where D <= 32
// kStageWords, the lane words.
constexpr int kTileThreads = 256;
constexpr int kStageWords = 4;

// 32 x 32 bit transpose across a warp: lane l holds row l on entry, and
// on return lane s holds column s (bit l = bit s of lane l's row), by 5
// butterfly exchanges of half-blocks
__device__ __forceinline__ uint32_t transpose_bits(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~m) | ((y & ~m) >> j)) : ((x & m) | ((y & m) << j));
  }
  return x;
}

__global__ void __launch_bounds__(kTileThreads) select_chunk_kernel(
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
    uint32_t* __restrict__ lanes_out, int b, int P, int C, int D, int root,
    float big, int bshift) {
  extern __shared__ int32_t stage[];
  const int bp = 1 << bshift;        // lanes a prefix takes
  const int G = 32 >> bshift;        // prefixes a warp takes at once
  const int TP = bp >= 8 ? 32 : 256 >> bshift;  // prefixes a tile
  const int stride = TP + G;         // a snapshot's stage row
  const int pairs = bp * stride;
  float* st_metric = reinterpret_cast<float*>(stage);
  int32_t* st_flags = stage + pairs;  // bit 0 valid, bit 1 changed
  uint32_t* st_lanes = reinterpret_cast<uint32_t*>(stage + 2 * pairs);  // [Dw][pairs]
  const int Bw = (b + 31) / 32;
  const int Dw = (D + 31) / 32;
  const int Pw = (P + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sl = lane & (bp - 1);    // the lane's snapshot in the tile
  const int q = lane >> bshift;      // its prefix in the warp's group
  const int sw = blockIdx.y;
  const int s = sw * 32 + sl;        // bp < 32 only where b < 32: sw = 0
  const int sc = s < b ? s : b - 1;  // reads stay in bounds past b
  const int sb = sc & 31;
  const int p0 = blockIdx.x * TP;
  const bool direct = bp == 1;       // a warp is 32 prefixes of snapshot 0
  const bool stage_lanes = Dw <= kStageWords;
  const int passes = (TP << bshift) / kTileThreads;

  for (int pass = 0; pass < passes; ++pass) {
    const int pl = (pass * (kTileThreads / 32) + warp) * G + q;
    const int p = p0 + pl;
    const bool live = p < P && s < b;
    const int pc = p < P ? p : P - 1;
    const size_t row = (size_t)pc * C;
    const int32_t* node = cand_node + row;
    const auto dist_of = [&](int n) { return dist[(size_t)n * b + sc]; };
    const auto hard_of = [&](int n) { return overloaded[n] != 0; };
    const auto soft_of = [&](int n) { return soft[n]; };
    const Selection sel = select_chain(
        node, cand_ok + row, drain_metric + row, path_pref + row, source_pref + row,
        distance + row, min_nexthop + row, C, root, big, dist_of, hard_of, soft_of);

    int num_nh = 0;
    bool lanes_differ = false;
    const int at = sl * stride + pl;
    uint32_t* lanes_row = lanes_out + ((size_t)s * P + p) * Dw;
    for (int k = 0; k < Dw; ++k) {
      uint32_t word = 0;
      const int d_end = D < 32 * (k + 1) ? D : 32 * (k + 1);
      if (bp == 32) {
        // the warp's prefix: a winner's 32 lane words of this word k in
        // one load (lane l: lane 32 k + l of the node, its bits the 32
        // snapshots), transposed so that lane s holds snapshot s's bits
        for (int c = 0; c < C; ++c) {
          const bool win = (sel.winners & bit(c)) != 0;
          if (!__any_sync(kFull, win)) continue;
          const int d = 32 * k + lane;
          const uint32_t x =
              d < d_end ? nh[((size_t)node[c] * D + d) * Bw + sw] : 0u;
          const uint32_t t = transpose_bits(x, lane);
          if (win) word |= t;
        }
      } else {
        for (int c = 0; c < C; ++c) {
          if (!(sel.winners & bit(c))) continue;
          // the lane group's winner: one word a lane, the same address
          // for every lane of the group
          const uint32_t* src = nh + (size_t)node[c] * D * Bw + sw;
#pragma unroll 8
          for (int d = 32 * k; d < d_end; ++d)
            word |= ((src[(size_t)d * Bw] >> sb) & 1u) << (d - 32 * k);
        }
      }
      num_nh += __popc(word);
      lanes_differ |= word != base_lanes[(size_t)pc * Dw + k];
      if (live && (direct || !stage_lanes)) lanes_row[k] = word;
      else if (stage_lanes && !direct) st_lanes[(size_t)k * pairs + at] = word;
    }
    const bool valid = sel.winners && !sel.self_wins && sel.best_igp < big &&
                       num_nh > 0 && num_nh >= sel.req;
    const bool bv = base_valid[pc];
    const bool changed =
        live && ((valid != bv) ||
                 (valid && bv && (sel.best_igp != base_metric[pc] || lanes_differ)));
    if (direct) {
      if (live) {
        valid_out[p] = valid;
        metric_out[p] = sel.best_igp;
      }
      const uint32_t word = __ballot_sync(kFull, changed);
      if (lane == 0 && p < P) changed_out[p >> 5] = word;
    } else {
      st_metric[at] = sel.best_igp;
      st_flags[at] = (valid ? 1 : 0) | (changed ? 2 : 0);
    }
  }
  if (direct) return;
  __syncthreads();
  // transposed: job j is 32 consecutive prefixes (segment j % segs) of one
  // snapshot (j / segs), a warp lane a prefix
  const int segs = TP / 32;
  for (int j = warp; j < (segs << bshift); j += kTileThreads / 32) {
    const int s_loc = j / segs;
    const int pl = (j - s_loc * segs) * 32 + lane;
    const int st = sw * 32 + s_loc;
    const int p = p0 + pl;
    if (st >= b) continue;  // uniform over the warp
    const int at = s_loc * stride + pl;
    const bool in = p < P;
    const int flags = st_flags[at];
    if (in) {
      const size_t o = (size_t)st * P + p;
      valid_out[o] = flags & 1;
      metric_out[o] = st_metric[at];
      if (stage_lanes)
        for (int k = 0; k < Dw; ++k) lanes_out[o * Dw + k] = st_lanes[(size_t)k * pairs + at];
    }
    const uint32_t word = __ballot_sync(kFull, in && (flags & 2));
    if (lane == 0 && in) changed_out[(size_t)st * Pw + (p >> 5)] = word;
  }
}

// Kernel 17's blocks: kBatchedThreads threads, a stage of at most
// kBatchedSmemMax bytes (the card's dynamic shared memory a block) laid
// out by batched_layout.
constexpr int kBatchedThreads = 256;
constexpr size_t kBatchedSmemMax = 232448;
// lane words a thread holds in registers at a time (64 lane bytes)
constexpr int kLaneWords = 16;

// Byte offsets of kernel 17's stage regions: each starts on 16 bytes and
// keeps 16 more, so that the data can sit at its source's (or its
// destination's) address mod 16; the lane table keeps 8 more, so a
// lane word read as two aligned words stays inside it.
struct BatchedLayout {
  size_t lanes, use, dist, soft, ovl, nh, total;  // nh: the row tables' end
};

__host__ __device__ inline size_t region(size_t bytes) { return (bytes + 16 + 15) & ~(size_t)15; }

__host__ __device__ inline BatchedLayout batched_layout(int TP, int V, int C, int D) {
  BatchedLayout L;
  L.lanes = 0;
  L.use = L.lanes + region((size_t)TP * D);
  L.dist = L.use + region((size_t)TP * C);
  L.soft = L.dist + region((size_t)V * 4);
  L.ovl = L.soft + region((size_t)V * 4);
  L.nh = L.ovl + region((size_t)V);
  L.total = L.nh + region((size_t)V * D + 8);
  return L;
}

// The block copies n bytes from global src to shared dst, equal mod 16:
// the head bytes up to a 16-byte boundary, then 16-byte words by cp.async
// (all in flight at once; the caller waits), then the tail bytes.
__device__ __forceinline__ void load_span(uint8_t* dst, const uint8_t* src, size_t n) {
  const size_t head = min(n, (size_t)((16 - ((uintptr_t)src & 15)) & 15));
  const size_t words = (n - head) / 16;
  for (size_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (size_t k = threadIdx.x; k < words; k += blockDim.x) {
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + head + 16 * k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + head + 16 * k));
  }
  for (size_t i = head + 16 * words + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The block copies n bytes from shared src to global dst, equal mod 16:
// head bytes, 16-byte words, tail bytes.
__device__ __forceinline__ void store_span(uint8_t* dst, const uint8_t* src, size_t n) {
  const size_t head = min(n, (size_t)((16 - ((uintptr_t)src & 15)) & 15));
  const size_t words = (n - head) / 16;
  for (size_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  uint4* dw = reinterpret_cast<uint4*>(dst + head);
  const uint4* sw = reinterpret_cast<const uint4*>(src + head);
  for (size_t k = threadIdx.x; k < words; k += blockDim.x) dw[k] = sw[k];
  for (size_t i = head + 16 * words + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Byte offset in its region of a span at global address g (the span sits
// at g's address mod 16).
__device__ __forceinline__ size_t span_at(const void* g) { return (uintptr_t)g & 15; }

// ORs the 4 bytes x into the stage words w at byte offset off (any
// alignment; neighbouring prefixes own the other bytes of the words).
__device__ __forceinline__ void or_word(uint32_t* w, size_t off, uint32_t x) {
  if (!x) return;
  const size_t a = off >> 2;
  const unsigned s = (unsigned)(off & 3) * 8;
  atomicOr(w + a, x << s);
  if (s && (x >> (32 - s))) atomicOr(w + a + 1, x >> (32 - s));
}

// A lane word's bytes clamped at 0 (the max with a non-winner's 0).
__device__ __forceinline__ uint32_t clamp0(uint32_t v) {
  return v & ~(((v & 0x80808080u) >> 7) * 0xFFu);
}

// Word k of a lane row whose first byte is `lo`'s byte sh / 8 (lo, hi the
// aligned words at and after it): from the staged table the next aligned
// word always (it stays inside the table's region); from L2 only where
// the row's `left` bytes reach into it.
template <bool kStaged>
__device__ __forceinline__ uint32_t row_word(const uint32_t* w, int k, unsigned sh, int left) {
  const uint32_t lo = w[k];
  const uint32_t hi = (kStaged || (sh && left > 4 - (int)(sh >> 3))) ? w[k + 1] : 0u;
  return __funnelshift_r(lo, hi, sh);
}

// Kernel 17: block (b, tile) over prefixes p0 .. p0 + np - 1 of row b (see
// the header).  kRows: row b's dist, overloaded and soft are staged;
// kLanes: its lane rows nh[b] too.  At most 64 registers a thread, so 4
// blocks fit an SM where their stages do (the flagship's 50 KB each).
template <bool kRows, bool kLanes>
__global__ void __launch_bounds__(kBatchedThreads, 4) batched_select_kernel(
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
    int32_t* __restrict__ num_out, uint8_t* __restrict__ use_out, int tiles,
    int TP, int V, int P, int C, int D, float big) {
  extern __shared__ __align__(16) uint8_t smem[];
  const BatchedLayout L = batched_layout(TP, V, C, D);
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  const int np = min(TP, P - p0);
  const size_t out0 = (size_t)b * P + p0;  // the tile's first (row, prefix)
  int8_t* lanes_g = nh_out + out0 * D;
  uint8_t* use_g = use_out + out0 * C;

  const float* d = dist + (size_t)b * V;
  const uint8_t* ovl = overloaded + (size_t)b * V;
  const int32_t* sft = soft + (size_t)b * V;
  const int8_t* tab = nh + (size_t)b * V * D;
  if constexpr (kRows) {
    uint8_t* ds = smem + L.dist + span_at(d);
    uint8_t* ss = smem + L.soft + span_at(sft);
    uint8_t* os = smem + L.ovl + span_at(ovl);
    load_span(ds, reinterpret_cast<const uint8_t*>(d), (size_t)V * 4);
    load_span(ss, reinterpret_cast<const uint8_t*>(sft), (size_t)V * 4);
    load_span(os, ovl, V);
    d = reinterpret_cast<const float*>(ds);
    sft = reinterpret_cast<const int32_t*>(ss);
    ovl = os;
  }
  if constexpr (kLanes) {
    uint8_t* ts = smem + L.nh + span_at(tab);
    load_span(ts, reinterpret_cast<const uint8_t*>(tab), (size_t)V * D);
    tab = reinterpret_cast<const int8_t*>(ts);
  }
  // the lane and use stages start at 0: the prefixes OR their bytes in
  uint4* zero = reinterpret_cast<uint4*>(smem);
  for (size_t k = threadIdx.x; k < L.dist / 16; k += blockDim.x) zero[k] = make_uint4(0, 0, 0, 0);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  uint32_t* lanes_w = reinterpret_cast<uint32_t*>(smem + L.lanes);
  uint32_t* use_w = reinterpret_cast<uint32_t*>(smem + L.use);
  const size_t lanes0 = span_at(lanes_g), use0 = span_at(use_g);
  const int root = roots[b];
  const uint64_t every = C == 64 ? ~0ull : bit(C) - 1;
  const int Dw = (D + 3) / 4;
  for (int r = threadIdx.x; r < np; r += blockDim.x) {
    const size_t row = (size_t)(p0 + r) * C;
    const int32_t* node = cand_node + row;
    const Selection sel = select_chain(
        node, cand_ok + row, drain_metric + row, path_pref + row, source_pref + row,
        distance + row, min_nexthop + row, C, root, big, [&](int n) { return d[n]; },
        [&](int n) { return ovl[n] != 0; }, [&](int n) { return sft[n]; });
    // use: 4 candidates' bits a word, one byte each
    for (int k = 0; 4 * k < C; ++k)
      or_word(use_w, use0 + (size_t)r * C + 4 * k,
              (((uint32_t)(sel.use >> (4 * k)) & 0xFu) * 0x00204081u) & 0x01010101u);
    // lanes: the reference's int8 max over the C candidates, a non-winner
    // giving 0 (so the winners' max from 0, or from -128 where every
    // candidate wins), kLaneWords words at a time in registers
    const bool all = sel.winners == every;
    int num = 0;
    for (int k0 = 0; k0 < Dw; k0 += kLaneWords) {
      uint32_t acc[kLaneWords];
      bool first = true;
      for (uint64_t m = sel.winners; m; m &= m - 1) {
        const int8_t* src = tab + (size_t)node[__ffsll(m) - 1] * D + 4 * k0;
        const unsigned below = (unsigned)((uintptr_t)src & 3);  // src's byte in its word
        const uint32_t* w = reinterpret_cast<const uint32_t*>(src - below);
        const unsigned sh = below * 8;
#pragma unroll
        for (int k = 0; k < kLaneWords; ++k) {
          if (k0 + k >= Dw) break;
          const uint32_t v = row_word<kLanes>(w, k, sh, D - 4 * (k0 + k));
          acc[k] = first ? (all ? v : clamp0(v)) : __vmaxs4(acc[k], v);
        }
        first = false;
      }
#pragma unroll
      for (int k = 0; k < kLaneWords; ++k) {
        if (k0 + k >= Dw) break;
        uint32_t x = first ? 0u : acc[k];
        if (k0 + k == Dw - 1 && (D & 3)) x &= (1u << (8 * (D & 3))) - 1u;
        num = __dp4a((int)x, 0x01010101, num);
        or_word(lanes_w, lanes0 + (size_t)r * D + 4 * (k0 + k), x);
      }
    }
    const size_t i = out0 + r;
    metric_out[i] = sel.best_igp;
    num_out[i] = num;
    valid_out[i] = sel.winners && !sel.self_wins && sel.best_igp < big && num > 0 &&
                   num >= sel.req;
  }
  __syncthreads();
  store_span(reinterpret_cast<uint8_t*>(lanes_g), smem + L.lanes + lanes0, (size_t)np * D);
  store_span(use_g, smem + L.use + use0, (size_t)np * C);
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

// Kernel 11's status words: epoch (bits 38-63), flag (36-37), sum (0-35).
constexpr int kStatusSumBits = 36;
constexpr unsigned kEpochMask = (1u << (64 - kStatusSumBits - 2)) - 1u;
constexpr unsigned long long kStatusAggregate = 1ull;
constexpr unsigned long long kStatusPrefix = 2ull;

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          unsigned long long flag,
                                                          long long sum) {
  return ((unsigned long long)epoch << (kStatusSumBits + 2)) | (flag << kStatusSumBits) |
         (unsigned long long)sum;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Warp 0 of tile `tile` (> 0): the sum of every live bit before the tile,
// read from its predecessors' status words (decoupled look-back).  Every
// predecessor has taken its ticket, so it publishes its aggregate without
// waiting on anything: the spin ends.
__device__ long long look_back(const unsigned long long* status, int tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (int base = tile - 1;; base -= 32) {
    const int idx = base - lane;
    unsigned long long flag = kStatusPrefix;
    long long sum = 0;
    if (idx >= 0) {
      unsigned long long s;
      do {
        s = *reinterpret_cast<const volatile unsigned long long*>(status + idx);
        flag = (s >> kStatusSumBits) & 3ull;
      } while ((unsigned)(s >> (kStatusSumBits + 2)) != epoch || flag == 0);
      sum = (long long)(s & ((1ull << kStatusSumBits) - 1));
    }
    const unsigned prefixes = __ballot_sync(kFull, flag == kStatusPrefix);
    if (prefixes) {
      const int stop = __ffs(prefixes) - 1;  // the nearest inclusive prefix
      return before + warp_sum(lane <= stop ? sum : 0);
    }
    before += warp_sum(sum);
  }
}

// In the call whose epoch is the cycle's last, each block once past its
// last read of a status word: the last of them (the word after the status
// words counts them) clears the status words and the count.
__device__ void end_epoch_cycle(unsigned long long* status, int blocks, int status_words) {
  unsigned long long* done = status + status_words;
  __shared__ bool last_s;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last_s = atomicAdd(done, 1ull) == (unsigned long long)(blocks - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = threadIdx.x; i < status_words; i += blockDim.x) status[i] = 0ull;
  if (threadIdx.x == 0) *done = 0ull;
}

// Fill slots [lo, cap) of the compacted outputs (-1 coordinates, 0
// elsewhere) over this thread's share (first, stride) of them: groups of 4
// slots as 16-byte words where the outputs are aligned, the rest slot by
// slot.
__device__ void fill_slots(long long lo, long long cap, long long first, long long stride,
                           int32_t* row_out, int32_t* pref_out, uint8_t* valid_out,
                           float* metric_out, uint32_t* lanes_out, int Dw) {
  const auto scalar = [&](long long i) {
    row_out[i] = -1;
    pref_out[i] = -1;
    valid_out[i] = 0;
    metric_out[i] = 0.0f;
    for (int d = 0; d < Dw; ++d) lanes_out[i * Dw + d] = 0u;
  };
  const uintptr_t words = reinterpret_cast<uintptr_t>(row_out) |
                          reinterpret_cast<uintptr_t>(pref_out) |
                          reinterpret_cast<uintptr_t>(metric_out) |
                          reinterpret_cast<uintptr_t>(lanes_out);
  const long long g0 = (lo + 3) / 4, g1 = cap / 4;
  if ((words & 15) || (reinterpret_cast<uintptr_t>(valid_out) & 3) || g0 >= g1) {
    for (long long i = lo + first; i < cap; i += stride) scalar(i);
    return;
  }
  for (long long i = lo + first; i < 4 * g0; i += stride) scalar(i);
  for (long long i = 4 * g1 + first; i < cap; i += stride) scalar(i);
  for (long long g = g0 + first; g < g1; g += stride) {
    reinterpret_cast<int4*>(row_out)[g] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(pref_out)[g] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<uint32_t*>(valid_out)[g] = 0u;
    reinterpret_cast<float4*>(metric_out)[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    uint4* l = reinterpret_cast<uint4*>(lanes_out + 4 * g * Dw);
    for (int d = 0; d < Dw; ++d) l[d] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Kernel 11: blocks take tickets; the first `tiles` tickets are the scan's
// tiles, the `fillers` after them fill the slots past the count, which
// they read from the last tile's inclusive prefix (every tile has taken
// its ticket by then, so the wait ends).
__global__ void __launch_bounds__(kCompactThreads) compact_deltas_kernel(
    const uint32_t* __restrict__ changed, const uint8_t* __restrict__ valid,
    const float* __restrict__ metric, const uint32_t* __restrict__ lanes,
    const int32_t* __restrict__ row_id, unsigned long long* status,
    unsigned long long* ticket, long long* __restrict__ count, int32_t* __restrict__ row_out,
    int32_t* __restrict__ pref_out, uint8_t* __restrict__ valid_out,
    float* __restrict__ metric_out, uint32_t* __restrict__ lanes_out, size_t words, int Pw,
    int P, int Dw, long long cap, int tiles, int fillers, int status_words) {
  __shared__ int tile_s;
  __shared__ unsigned epoch_s;
  __shared__ long long before_s;
  __shared__ uint32_t words_s[kCompactTileWords];
  __shared__ int32_t first_s[kCompactThreads];
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(ticket, 1ull);
    // the last ticket: every block of this call holds its own, so the next
    // call (stream-ordered) starts again at 0, with the next epoch
    if ((int)(t & 0xffffffffull) == tiles + fillers - 1) atomicExch(ticket, ((t >> 32) + 1) << 32);
    tile_s = (int)(t & 0xffffffffull);
    epoch_s = (unsigned)(t >> 32) & kEpochMask;
  }
  __syncthreads();
  const int tile = tile_s;
  const unsigned epoch = epoch_s;
  if (tile >= tiles) {
    if (threadIdx.x == 0) {
      unsigned long long s;
      do {
        s = *reinterpret_cast<const volatile unsigned long long*>(status + tiles - 1);
      } while ((unsigned)(s >> (kStatusSumBits + 2)) != epoch ||
               ((s >> kStatusSumBits) & 3ull) != kStatusPrefix);
      before_s = (long long)(s & ((1ull << kStatusSumBits) - 1));
    }
    __syncthreads();
    const long long total = before_s;
    if (epoch == kEpochMask) end_epoch_cycle(status, tiles + fillers, status_words);
    fill_slots(total < cap ? total : cap, cap,
               (long long)(tile - tiles) * blockDim.x + threadIdx.x,
               (long long)fillers * blockDim.x, row_out, pref_out, valid_out, metric_out,
               lanes_out, Dw);
    return;
  }
  const size_t g0 = (size_t)tile * kCompactTileWords + (size_t)threadIdx.x * kCompactWords;
  uint32_t m[kCompactWords];
  if (g0 + kCompactWords <= words && (reinterpret_cast<uintptr_t>(changed) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(changed + g0);
    m[0] = v.x;
    m[1] = v.y;
    m[2] = v.z;
    m[3] = v.w;
  } else {
    for (int k = 0; k < kCompactWords; ++k) m[k] = g0 + k < words ? changed[g0 + k] : 0u;
  }
  int c = 0;
  for (int k = 0; k < kCompactWords; ++k) {
    const size_t g = g0 + k;
    if (g >= words) break;
    const size_t r = g / Pw;
    const int tail = P - (int)(g - r * Pw) * 32;
    if (row_id[r] < 0) m[k] = 0u;
    if (tail < 32) m[k] &= (1u << tail) - 1u;
    c += __popc(m[k]);
  }
  long long aggregate;
  const long long in_tile = block_exclusive_scan(c, &aggregate);
  // the tile's live words and each thread's first rank in the tile, for
  // the scatter (made visible by the barrier after the look-back)
  for (int k = 0; k < kCompactWords; ++k) words_s[threadIdx.x * kCompactWords + k] = m[k];
  first_s[threadIdx.x] = (int)in_tile;
  if (threadIdx.x < 32) {
    long long before = 0;
    if (tile == 0) {
      if (threadIdx.x == 0)
        *reinterpret_cast<volatile unsigned long long*>(status) =
            status_word(epoch, kStatusPrefix, aggregate);
    } else {
      if (threadIdx.x == 0)
        *reinterpret_cast<volatile unsigned long long*>(status + tile) =
            status_word(epoch, kStatusAggregate, aggregate);
      before = look_back(status, tile, epoch);
      if (threadIdx.x == 0)
        *reinterpret_cast<volatile unsigned long long*>(status + tile) =
            status_word(epoch, kStatusPrefix, before + aggregate);
    }
    if (threadIdx.x == 0) before_s = before;
  }
  __syncthreads();
  const long long before = before_s;
  // the block reads no status word after its look-back
  if (epoch == kEpochMask) end_epoch_cycle(status, tiles + fillers, status_words);
  if (tile == tiles - 1 && threadIdx.x == 0) count[0] = before + aggregate;
  // the scatter: the tile's set bits (consecutive ranks from `before`)
  // spread over the whole block, bit k to thread k % T, kScatterBits a
  // thread at a time with their loads issued together; a thread finds a
  // bit's word by a binary search over the threads' first ranks and the
  // bit by __fns, so dense words hold up no thread and consecutive threads
  // store to consecutive slots
  const long long room = cap - before;
  const int todo = room <= 0 ? 0 : room < aggregate ? (int)room : (int)aggregate;
  const int T = blockDim.x;
  for (int k0 = 0; k0 < todo; k0 += kScatterBits * T) {
    size_t at[kScatterBits];
    int32_t id[kScatterBits];
    int p[kScatterBits];
#pragma unroll
    for (int u = 0; u < kScatterBits; ++u) {
      const int k = k0 + u * T + (int)threadIdx.x;
      if (k >= todo) continue;
      int t = 0;
      for (int step = T >> 1; step > 0; step >>= 1)
        if (t + step < T && first_s[t + step] <= k) t += step;
      int rank = k - first_s[t];
      int q = t * kCompactWords;
      for (int n = __popc(words_s[q]); rank >= n; n = __popc(words_s[q])) {
        rank -= n;
        ++q;
      }
      const size_t g = (size_t)tile * kCompactTileWords + q;
      const size_t r = g / Pw;
      p[u] = (int)(g - r * Pw) * 32 + (int)__fns(words_s[q], 0, rank + 1);
      at[u] = r * (size_t)P + p[u];
      id[u] = row_id[r];
    }
    uint8_t v[kScatterBits];
    float x[kScatterBits];
    uint32_t l0[kScatterBits];
#pragma unroll
    for (int u = 0; u < kScatterBits; ++u) {
      if (k0 + u * T + (int)threadIdx.x < todo) {
        v[u] = valid[at[u]];
        x[u] = metric[at[u]];
        l0[u] = lanes[at[u] * Dw];
      }
    }
#pragma unroll
    for (int u = 0; u < kScatterBits; ++u) {
      const int k = k0 + u * T + (int)threadIdx.x;
      if (k < todo) {
        const long long pos = before + k;
        row_out[pos] = id[u];
        pref_out[pos] = p[u];
        valid_out[pos] = v[u];
        metric_out[pos] = x[u];
        lanes_out[pos * Dw] = l0[u];
        for (int d = 1; d < Dw; ++d) lanes_out[pos * Dw + d] = lanes[at[u] * Dw + d];
      }
    }
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
  if (b <= 0 || P <= 0) return (int)cudaSuccess;
  // lanes a prefix takes: the snapshots rounded up to a power of two, 32
  // at most
  int bshift = 0;
  while ((1 << bshift) < b && bshift < 5) ++bshift;
  const int TP = bshift >= 3 ? 32 : 256 >> bshift;
  const int Dw = (D + 31) / 32;
  const size_t smem = bshift == 0 ? 0
                      : (size_t)(1 << bshift) * (TP + (32 >> bshift)) * 4 *
                            (2 + (Dw <= kStageWords ? Dw : 0));
  const dim3 grid((P + TP - 1) / TP, (b + 31) / 32);
  select_chunk_kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const float*)dist, (const uint32_t*)nh, (const uint8_t*)overloaded,
      (const int32_t*)soft, (const int32_t*)cand_node,
      (const uint8_t*)cand_ok, (const int32_t*)drain_metric,
      (const int32_t*)path_pref, (const int32_t*)source_pref,
      (const int32_t*)distance, (const int32_t*)min_nexthop,
      (const uint8_t*)base_valid, (const float*)base_metric,
      (const uint32_t*)base_lanes, (uint32_t*)changed, (uint8_t*)valid,
      (float*)metric, (uint32_t*)lanes, b, P, C, D, root, big, bshift);
  (void)V;
  return (int)cudaGetLastError();
}

extern "C" int openr_compact_deltas(
    const void* changed, const void* valid, const void* metric,
    const void* lanes, const void* row_id, void* status, void* ticket, void* count,
    void* row_out, void* pref_out, void* valid_out, void* metric_out,
    void* lanes_out, int R, int P, int Dw, int cap, int tiles, int fillers, int status_words,
    void* stream) {
  const int Pw = (P + 31) / 32;
  const size_t words = (size_t)R * Pw;
  if (cap < 1 || tiles < 1 || fillers < 1 || tiles > status_words ||
      (size_t)tiles * kCompactTileWords < words || words * 32 >= (1ull << kStatusSumBits))
    return (int)cudaErrorInvalidValue;
  compact_deltas_kernel<<<tiles + fillers, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)changed, (const uint8_t*)valid, (const float*)metric,
      (const uint32_t*)lanes, (const int32_t*)row_id, (unsigned long long*)status,
      (unsigned long long*)ticket, (long long*)count, (int32_t*)row_out, (int32_t*)pref_out,
      (uint8_t*)valid_out, (float*)metric_out, (uint32_t*)lanes_out, words, Pw, P, Dw,
      (long long)cap, tiles, fillers, status_words);
  return (int)cudaGetLastError();
}

extern "C" int openr_batched_select_routes(
    const void* dist, const void* nh, const void* overloaded, const void* soft,
    const void* roots, const void* cand_node, const void* cand_ok,
    const void* drain_metric, const void* path_pref, const void* source_pref,
    const void* distance, const void* min_nexthop, void* valid, void* metric,
    void* nh_out, void* num_nh, void* use, int B, int V, int P, int C, int D,
    int tile_rows, float big, void* stream) {
  if (B == 0 || P == 0) return (int)cudaSuccess;
  const int TP = tile_rows < P ? tile_rows : P;
  const BatchedLayout L = batched_layout(TP, V, C, D);
  // the lane and use stages are required; the row tables, then the lane
  // table, are staged where the stage still fits
  if (C < 1 || C > 64 || TP < 1 || L.dist > kBatchedSmemMax) return (int)cudaErrorInvalidValue;
  const bool rows = L.nh <= kBatchedSmemMax;
  const bool lanes = L.total <= kBatchedSmemMax;
  const size_t smem = lanes ? L.total : rows ? L.nh : L.dist;
  const int tiles = (P + TP - 1) / TP;
  constexpr auto all = batched_select_kernel<true, true>;
  constexpr auto rows_only = batched_select_kernel<true, false>;
  constexpr auto none = batched_select_kernel<false, false>;
  const auto kernel = lanes ? all : rows ? rows_only : none;
  const cudaError_t err = lanes  ? allow_smem<all>(smem)
                          : rows ? allow_smem<rows_only>(smem)
                                 : allow_smem<none>(smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((size_t)B * tiles), kBatchedThreads, smem, (cudaStream_t)stream>>>(
      (const float*)dist, (const int8_t*)nh, (const uint8_t*)overloaded,
      (const int32_t*)soft, (const int32_t*)roots, (const int32_t*)cand_node,
      (const uint8_t*)cand_ok, (const int32_t*)drain_metric,
      (const int32_t*)path_pref, (const int32_t*)source_pref,
      (const int32_t*)distance, (const int32_t*)min_nexthop, (uint8_t*)valid,
      (float*)metric, (int8_t*)nh_out, (int32_t*)num_nh, (uint8_t*)use, tiles, TP, V,
      P, C, D, big);
  return (int)cudaGetLastError();
}
