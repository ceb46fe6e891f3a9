// Warm-start SPF kernels for Hopper (sm_90a): the per-area SPF tables of
// a warm topology tick, seeded from the previous generation's tables.
//
// Replaces the jitted XLA kernels of the JAX package
//   openr_tpu/ops/spf.py:449 warm_spf_distances        (kernel 4 here)
//   openr_tpu/ops/spf.py:493 spf_nexthop_lanes_reset   (kernel 5 here)
//   openr_tpu/ops/spf.py:548 warm_subgraph_repair_one  (kernel 6 here)
// vmapped over areas by openr_tpu/ops/route_select.py:200
// warm_multi_area_spf_tables (kernels 4 + 5, through spf.py:636
// warm_spf_one) and :235 warm_multi_area_subgraph_tables (kernel 6), and
// the cold segment-form twins
//   openr_tpu/ops/spf.py:50 spf_distances, :106 spf_nexthop_lanes
//   (:160 spf_one; route_select.py:148 multi_area_spf_tables)
// batched over vantage roots and failure sets by
//   openr_tpu/ops/fleet_tables.py:27 fleet_multi_area_tables and
//   :217 whatif_multi_area_tables                     (kernel 14 here),
// and the KSP2_ED_ECMP k-th-path re-solve
//   openr_tpu/ops/spf.py:226 batched_spf_distances_masked (kernel 15 here)
// called by openr_tpu/decision/ksp2.py:94 Ksp2DeviceEngine._device_resolve,
// and the per-snapshot what-if batches
//   openr_tpu/ops/spf.py:201 batched_spf, :178 batched_spf_link_failures,
//   :247 batched_spf_distinct                         (kernel 16 here)
// behind openr_tpu/ops/route_select.py:449 spf_and_select, the flagship
// step of __graft_entry__.py.
//
// All three read the SEGMENT form of the topology: directed edges sorted
// by dst, so vertex v's in-edges are the run [off[v], off[v+1]) (kernel
// 5: the wrapper derives the offsets from dst; kernel 4 finds its runs
// from dst itself; kernel 6 reads its sub-edge list edge by edge).
// Padding edges carry edge_ok = false and still sit in their dst's run.
//   4. dist: masked Bellman-Ford from the host-planned over-estimate d0
//      (reset vertices BIG, the root pinned at 0).
//   5. lanes with RESET semantics: every round REPLACES lane (v, l) by
//      max(seed, max over v's in-edges of contrib), where a shortest-path
//      DAG edge out of the root seeds its lane (lane_rank) and a DAG edge
//      out of any other node contributes nh[src][l]; every other edge of
//      the run contributes 0.  A vertex with an EMPTY run holds int8
//      -128, exactly the reference's segment_max identity.
//   6. bounded repair of a pure-weakening delta: 4 then 5, relaxing only
//      the reset vertices over the sub-edge list (every in-edge of a reset
//      vertex), every other vertex read from the previous generation.
//
// Kernel 4 is kernel 1's design (spf_dense.cu) on the segment form,
// seeded.  An area's vertices are split into C slices of S = ceil(V / C)
// (C = 1, 2, 4 or 8; ops/spf.py warm_dist_cluster_size: at most 2,048
// edges of the padded list a block); block r of the area's thread block
// cluster owns slice r, whose in-edges are one range of the dst-sorted
// list, found by two binary searches over dst.  The block packs its
// slice's usable in-edges once, edge-parallel over that range (so the
// padding run of vertex V - 1 spreads over the block), the transit rule
// folded in (edge_ok, and the source not overloaded or the root): each an
// 8-byte record {source, bits of w}, placed at its vertex's cursor (a
// shared-memory atomic; a min takes records in any order).  The records
// are stored by group of 32 consecutive vertices in as many rows of 32 as
// the group's largest usable in-degree, a vertex's u-th record at its
// group's run + 32 u + its lane, so a warp's lanes read consecutive
// records; past the room the launcher left in shared memory (the block
// decides from its own count, which only the card knows) each vertex's
// records are one run at its place in the block's range of the area's
// global record list.  Padding and down edges are never read again, and
// the launcher derives nothing.  Every block holds a copy of the area's
// distances in shared memory, seeded from d0 with the root at 0; it
// relaxes its own slice in place and stores each improvement into the
// other blocks' copies too (distributed shared memory), one round before
// the first vote (a seed that is already the answer costs one round) and
// kWarmSweeps rounds between later votes (kernel 1's cluster vote: a block
// that changed something sets the vote's slot in every block, read past
// one cluster.sync(), which also makes every remote store visible), until
// a vote's rounds change nothing anywhere.  Where the distances and heads do
// not fit shared memory (past 45,000 vertices or so at a cluster of 8, or
// forced), the cluster relaxes one copy in the output row itself, read
// volatile, its heads in a global scratch and its records in the global
// list.  The rounds are instantiated once per address space of their
// state and records, so their loads are shared- or global-memory ones.
//
// Kernel 6 works on each area's reset list, not on all V vertices.  One
// solving block per area (1,024 threads) counts and lists the area's
// reset vertices in ascending order (16 flags a thread, one 16-byte load,
// and a block scan; where shared memory still holds it, a [V] map of
// vertex to list index too, else a binary search over the list), then
// reads the sub-edge list once, 4 consecutive edges a thread a pass (the
// dst-ascending order of the planner, pads after): an edge whose dst is
// listed marks its vertex as having a run (even a padding or unusable
// edge: the -128 fill is for an empty run); a usable one becomes a record
// {source, vertex, w, lane rank} in a list the launcher holds ([4, Es] an
// area, a warp's places by one atomicAdd).  An INNER record (its source
// listed too, kept as its list index) goes to the front of that list and
// counts an out-record of its source; an OUTER one (its source keeps its
// previous distance) goes to the back, and its constant candidate
// prev_dist[src] + w lowers the vertex's distance at once (an integer
// atomicMin: distances are >= 0).  The inner records are then placed by
// source (a block scan of the counts, cursors) in the block's state, so
// the rounds touch only the out-records of a frontier, and the launcher
// derives nothing.  The first K threads run the rounds (K = 32 up to 256
// listed vertices, then a warp per 256, 256 at most), kFrontierLanes of
// them a frontier vertex: a ROUND relaxes the out-records of the vertices
// its frontier lists (the first: every vertex the outer records lowered
// below BIG), lists each lowered vertex once for the next round (a
// per-round tag), and ends on the K threads' vote (a warp vote, __syncwarp
// then __any_sync, where K = 32; a reduction on named barrier 1 over the
// K threads above); the last round lowered nothing, and rounds_d and
// rounds_l count them (0 where no vertex is reset).  After the distances
// the records are classified against them (on the DAG: d[src] + w ==
// d[v] < BIG; a thread an outer record, then a thread a source for the
// inner ones): a seed sets its lane bit, an outer source ORs in its
// previous lanes (bit l set where its lane l is 1), an inner record off
// the DAG or out of the root is dropped and the others stay as
// propagating sources.  The lane rounds are frontier rounds too, from
// every vertex with a bit set, each ORing (atomicOr) its bit words (W =
// ceil(D / 32) a vertex, bit l % 32 of word l / 32 lane l) into the
// vertices of its propagating out-records and listing each vertex that
// gained a bit.  The listed rows are written from the block's state (-128
// where the vertex has no run, else the bit); the blocks after the A
// solving blocks copy the other rows of both tables from the previous
// ones, 16 bytes at a time where both are aligned (a word that touches a
// listed row byte by byte, one wholly in listed rows skipped), so no
// solving block copies.  The state ((8 + W) words a listed vertex, 3 an
// inner record) lives in dynamic shared memory where the area's list fits
// the C entry's grant (enough for a list of every vertex and the map, up
// to the block's 226,304 bytes, kRepairSmemMax), else in the area's slice
// of a global scratch held by the launcher, read there through L2
// (__ldcg); the solve is instantiated once per address space.
// Updates are in place (Gauss-Seidel) in kernels 4 and 6, and the fixed
// points are the reference's, bit for bit:
//   * distances: from a seed d0 the relaxation converges to
//     min_u (d0[u] + path(u -> v)) whatever the update order (the fixed
//     point is unique); integral link metrics keep every f32 sum exact.
//     Skipping an unusable edge is exact: its term is BIG, never below a
//     seed.  A vote's rounds in which no block changed anything read a
//     constant state, every copy equal to its owners' values.
//     Folding an outer record's constant candidate in before the rounds
//     is one of those orders.
//   * kernel 6's distances: a frontier round relaxes every out-record of
//     each vertex lowered in the round before, so a round that lowers
//     nothing leaves every record relaxed against the final values.
//   * kernel 6's lanes: propagating edges lie on the shortest-path DAG
//     (d[src] + w == d[dst] < BIG with w >= 1), so they form an acyclic
//     graph and the reset-semantics update has a unique fixed point: by
//     induction on DAG depth, each listed vertex's lanes are its seeds OR
//     its propagating sources' lanes.  A propagating source is reached
//     and not the root, so it has a usable in-edge and its lanes (the
//     previous table's, for an outer source) are 0 or 1, never -128: the
//     reference's int8 max over them (from 0, where the run is not empty)
//     is an OR of bits.  OR-accumulation from the seeds reaches the least
//     fixed point above them, which is that one, in any order; a round in
//     which no owner changed anything read one consistent state.  The
//     round counts are telemetry and differ from the reference's
//     synchronous counts.
// Load balance (kernel 14's round form): padding edges all
// sit in the run of vertex V-1 (half the edge list on a full node bucket),
// so a thread walking that run every round serialises the block.  A
// parallel prologue records, per vertex, the end of its run's last enabled
// edge (seg_end); the rounds walk only [off[v], seg_end[v]).  The skipped
// tail holds disabled edges alone, which contribute nothing (BIG to a
// distance, 0 to a lane); the run's emptiness, which decides the -128
// fill, is still read from off[].
//
// Kernel 5 is kernel 2's design (spf_dense.cu) on the segment form, an
// area on a thread block cluster of C blocks (C = 1, 2, 4 or 8; ops/spf.py
// reset_lanes_cluster_size: at most 512 vertices a block) of 1,024
// threads.  Vertex v belongs to block v % C.  Each block holds the area's
// distances and a copy of its lane words in shared memory: ceil(D / 32)
// uint32 a vertex, bit l % 32 of word l / 32 being lane l.  The blocks
// split the edge list in C ranges, and a thread an edge classifies every
// in-edge once against the distances: a DAG edge out of the root sets its
// seed bit (lane root_rank) in every block's copy, any other DAG edge
// counts a propagating source of its head at the head's owner (atomics on
// distributed shared memory).  Past a cluster barrier, two block scans
// list each block's owned moving vertices (a propagating source at least)
// and the offsets of their sources; past another, a second pass over the
// edge ranges packs each source at its head's owner (in any order: OR
// takes them so).  The OR rounds (or_word_rounds, frontier.cuh, shared
// with kernel 2) run over the owned moving vertices only and only over the
// words a seed can reach (lanes below 1 + the highest seeded rank), in
// place, reading the block's copy and storing each changed word into
// every copy; 8 rounds between two votes (kernel 1's cluster vote; a
// block-wide one where C = 1), until a vote's rounds change nothing
// anywhere.  The int8 table is written once, each block a slice of the
// vertices from its copy, -128 where the run is empty, else the bit
// (write_word_lanes).  The state (distances, words, scan counts) and the
// lane lists (room for a source in every in-edge) live in shared memory
// where they fit; else the lists, and past shared memory the whole state,
// go to each block's slice of a global scratch (StateLayout), so every V
// up to the port's node bound runs.  A vote's rounds in which no block
// changed anything read a constant state, every copy equal to the
// owners' words (the vote's barrier made every earlier store visible).
// Why OR from the seed bits is exact from ANY seed nh0: the reference
// iterates the reset update from nh0, and on an acyclic DAG that update
// has one fixed point, which its loop reaches (within the DAG's depth, <
// V rounds) and at which alone it stops.  The DAG is acyclic because
// every usable edge has w >= 1 (the encoder refuses a non-positive metric
// on an up link, ops/csr.py) and path sums below 2^24 are exact, so d[src]
// < d[dst] on each DAG edge.  That one fixed point is also the least one
// above the seeds, which OR-accumulation from the seeds alone reaches in
// any order; a propagating source is reached and not the root, so it has
// a usable in-edge, its lanes are 0 or 1, never -128, and the int8 max is
// an OR of bits.  So the kernel never reads nh0.
//
// Kernel 14 (spf_segment_batch) is the cold segment-form solve of every
// (batch row, area) pair in one launch.  Per row it takes the row's own
// root (-1: the vantage is absent from the area, and the pair reads dist
// BIG, lanes 0) and, optionally, a failed set of (area, link) pairs: an
// edge is masked iff some member has this area, the edge's link id and a
// link id >= 0, so a -1 pad masks nothing, not even a padding edge (whose
// link id is also -1).  The reference OR-accumulates its cold lanes from
// the seed; lane l of a vertex is 1 iff some shortest path from the root
// leaves by the root's l-th out-edge in edge order, and a vertex whose run
// in the padded edge list is empty holds -128.  Two forms:
//   * the frontier form (segment_frontier_kernel), for pairs of more than
//     SEGMENT_ROUNDS_MAX_NODES vertices (ops/spf.py) and for any pair
//     whose round-form state exceeds shared memory.  The launcher sorts
//     each area's edges by source (stable); from them a layout kernel
//     over the card builds a CSR by source of ALL the area's edges, each
//     slot {dst, w} (an unusable edge a self-loop of +inf) and its link
//     id.  A source's run keeps edge order, so a slot's place in it is
//     its lane rank (its rank among ALL of its source's edges: the lane it
//     seeds when its source is the root), and a binary search over the
//     dst-sorted list says which vertices have a run.  A fill kernel, launched
//     from the same entry point on a grid that covers the card, writes
//     dist BIG and the lanes' -128 / 0 (whole 16-byte words);
//     then blocks walk the pairs in a grid-stride loop, each solving its
//     pair by frontier_pair (frontier.cuh, kernel 12's solve) with the
//     failed set filtered per slot by link id, writing the distances of
//     the reached vertices and only the lanes that become 1.  Threads per
//     block rise to 1,024 while every pair still has its own block.  The
//     state (frontier state, failed links, lane lists) sits in shared
//     memory or a global scratch as kernel 12's does.
//   * the round form (segment_pair), for small pairs, where a pair's
//     fixed cost of frontier rounds loses (PERF.md): one block of 256
//     threads per pair, distances then the lanes by relaxation rounds over
//     each vertex's in-edge run.  The block keeps in shared memory its
//     distances, its run ends, its edge classes and the lane rank of every
//     edge (a block scan), so nothing scales with the batch but the
//     outputs.  The seed edges set their lanes before the rounds, which
//     then run only over lanes a root out-edge can seed and only over
//     vertices with a propagating in-edge.  That state is 4(V + E + 257 +
//     S) + 4V + E bytes, always in shared memory: a small pair whose state
//     does not fit the block's 232,448 bytes takes the frontier form.
// What bounds it: a lone pair's latency (its frontier rounds, then the OR
// lane rounds on the output rows, on one SM) on rows of large pairs; the
// fill's bytes on the hub row, whose solve is one hop; the rounds' barriers
// on the many small pairs of a multi-area what-if (PERF.md).
//
// Kernel 15 (spf_distances_masked) is the KSP2 re-solve from the root
// with the links of paths 1..k-1 masked: distances only, one block per
// row, by frontier relaxation (frontier.cuh) over a CSR by source of the
// usable edges, derived once per launch and shared by every row (L2- and
// L1-resident).  A slot carries its edge's position in the edge list, so
// the row's mask is one bit per edge: from the row's [E] bool row, or from
// its failed link ids through a CSR of link id -> edges, so a [B, E] mask
// never needs to exist.  The row's distances, edge bits and frontier state
// live in shared memory where they fit (the frontier listed at most `cap`
// vertices at a time), else in a global scratch with a grid-stride loop
// over the rows.  A row whose root is cut off ends after its first round.
// Only the vertices an edge or a root touches are solved (a node bucket's
// padding reads BIG), which halves the state on the backbone: 3 rows of
// 256 threads per SM, the fastest of 256, 512 and 1,024 on the H100.
// What bounds it: latency, ~48 rounds per row on the backbone, each about
// nine barrier phases waiting on shared memory or L2 (about 2.6 out-edge
// visits per usable edge per row); not bytes (PERF.md).
//
// Kernel 16 (batched_spf) is kernel 14's frontier form with everything
// per row that kernel 14 shares: the root roots[b], the hard-drain row
// overloaded[b] (an overloaded node relaxes only when it is that row's
// root) and the row's edge bits (kernel 15's: from its [E] bool mask row,
// read 32 bytes a thread, or its failed link ids through the link CSR, or
// none).  The launcher sorts the edges by source (stable; each row's own
// list for batched_spf_distinct), and the same layout kernel builds on the
// card a CSR by source of ALL the edges, an unusable edge a self-loop of
// +inf, each slot with its edge's position in the list (the row's mask
// bit).  A slot's place in its source's run is its lane: its rank among
// ALL of the source's edges in edge order, the reference's numbering
// (is_root_out = src == root, disabled edges included), so rows with
// different roots never share lanes.  A shared list has one layout for
// every row (L2-resident).  The fill kernel writes dist BIG and the
// -128 / 0 lanes over the card in whole 16-byte words of the flat table
// (D = 17 on the flagship world breaks the rows' alignment, so a word's
// bytes walk the rows they cover); then blocks walk the rows in a
// grid-stride loop, each row a frontier_pair solve (frontier.cuh) with
// its edge bits after the frontier state, its lanes as bit words where
// the live lanes fit 32 (D = 17).  Threads per block follow kernel 14's
// rule; the lane lists join the frontier state in shared memory only where
// an SM still holds as many blocks as its threads allow, else they go to
// a global scratch, and past shared memory the whole state does
// (ops/spf.py batched_spf_layout).  What bounds
// it: a row's latency (its frontier rounds, then the lane rounds, on one
// SM), against the bound of one relaxation per usable edge per row and
// the [B, V, D] lane output's bytes (PERF.md).
//
// What bounds kernels 4-6: latency, not bytes.  Kernel 4 loops for the
// depth of the perturbed region from its seed, a round a few shared-memory
// loads per usable edge of a thread's vertices on the cluster's 8 SMs and
// a vote every 16 rounds (kWarmSweeps), after one packing pass over the edges;
// kernel 6 runs for the depth of its reset region (about 30 rounds of
// each fixed point at the grid's weakening, whose list holds 1,984
// vertices, a row of 64 a round), each round the out-records of its
// frontier and a vote on one SM, after a listing pass over the area's V
// reset flags and two passes over its sub-edges; kernel 5
// runs for the depth of the DAG (126 rounds from node0 on the 64 x 64
// grid), each round a few shared-memory loads a thread of the cluster's 8
// SMs, a vote every 8 rounds.
//
// Traps: the seed and the unusable-edge candidate are BIG = 3.4e38, not
// inf: BIG + w rounds to BIG and BIG + BIG is +inf, and padding weights
// are +inf.  min/compare must treat these exactly, so this file is never
// built with --use_fast_math.  int8 lanes are combined in int32 and
// stored as int8, as the reference's int8 multiply-and-max gives them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "frontier.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

// edge classes in the scratch plane
constexpr uint8_t kOffDag = 0;
constexpr uint8_t kSeed = 1;       // on-DAG edge out of the root
constexpr uint8_t kPropagate = 2;  // on-DAG edge out of any other node

// seg_end[v] = end of the last enabled edge of v's run (off[v] if none);
// ends with a barrier.
__device__ void enabled_run_ends(int32_t* seg_end, const int32_t* off,
                                 const int32_t* dst, const uint8_t* enabled,
                                 int V, int E) {
  for (int v = threadIdx.x; v < V; v += blockDim.x) seg_end[v] = off[v];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (enabled[e]) atomicMax(&seg_end[dst[e]], e + 1);
  __syncthreads();
}

// Relax every vertex to the fixed point; returns the number of rounds run.
template <class Edges>
__device__ int relax_distances(float* d, const int32_t* off,
                               const int32_t* seg_end, const int32_t* src,
                               const float* w, Edges edges, int V, float big) {
  int rounds = 0;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const float cur = d[v];
      float best = cur;
      for (int e = off[v]; e < seg_end[v]; ++e) {
        const int s = src[e];
        best = fminf(best, edges.usable(e, s) ? d[s] + w[e] : big);
      }
      if (best < cur) {
        d[v] = best;
        changed = 1;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  return rounds;
}

// Classify every in-edge against the converged distances: shortest-path
// DAG edges seed (lane_rank >= 0: an out-edge of the root) or propagate.
template <class Edges>
__device__ void classify_edges(uint8_t* cls, const float* d,
                               const int32_t* off, const int32_t* seg_end,
                               const int32_t* src, const float* w,
                               const int32_t* lane_rank, Edges edges, int V,
                               float big) {
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float dv = d[v];
    for (int e = off[v]; e < seg_end[v]; ++e) {
      const int s = src[e];
      const bool on = edges.usable(e, s) && dv < big && d[s] + w[e] == dv;
      cls[e] = on ? (lane_rank[e] >= 0 ? kSeed : kPropagate) : kOffDag;
    }
  }
}

// Reset-semantics lane fixed point over the `count` vertices of `list`
// (kernel 14's moving vertices), in place in nh [V, D], over its first L
// lanes; returns the number of rounds run.
__device__ int propagate_lanes(int8_t* nh, const uint8_t* cls,
                               const int32_t* off, const int32_t* seg_end,
                               const int32_t* src, const int32_t* lane_rank,
                               int V, int L, int D, const int32_t* list,
                               int count) {
  int rounds = 0;
  const int n = count * L;
  for (int round = 0; round < V; ++round) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = i / L;
      const int v = list[j];
      const int l = i - j * L;
      const size_t at = (size_t)v * D + l;
      const int e0 = off[v];
      // an empty run keeps the reference's segment_max identity, -128;
      // otherwise non-DAG edges contribute 0, so the value starts at 0
      int x = e0 < off[v + 1] ? 0 : -128;
      for (int e = e0; e < seg_end[v]; ++e) {
        const uint8_t c = cls[e];
        if (c == kSeed) {
          if (lane_rank[e] == l) x = x > 1 ? x : 1;
        } else if (c == kPropagate) {
          const int y = nh[(size_t)src[e] * D + l];
          x = y > x ? y : x;
        }
      }
      if (x != nh[at]) {
        nh[at] = (int8_t)x;
        changed = 1;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  return rounds;
}

// Kernel 4's fixed block state (warm_dist_fixed_ints), in 16-byte words:
// the area's distances [V] (while the block packs, its slice's record
// cursors), its slice's heads [S] {first record, usable in-degree} and the
// first record of each 32-vertex group [ceil(S / 32) + 1]; then room for
// `cap_shared` records where the launcher left it.  In the global layout
// the distances are the output row itself (one copy for the cluster) and
// the heads and groups (warm_dist_head_ints) a slice of a global scratch.
__host__ __device__ inline size_t warm_dist_head_ints(int S) {
  return (2 * (size_t)S + ((size_t)S + 31) / 32 + 1 + 3) / 4 * 4;
}
__host__ __device__ inline size_t warm_dist_fixed_ints(int V, int S) {
  return ((size_t)V + (V & 1) + 3) / 4 * 4 + warm_dist_head_ints(S);
}

// blocks of kernel 4's cluster per area, at most; records a thread loads
// at once in a round, so their loads overlap (kernel 1's)
constexpr int kWarmMaxCluster = 8;
constexpr int kWarmRecordBatch = 4;
// relaxation rounds between two votes of kernel 4 after the first
constexpr int kWarmSweeps = 16;
// dynamic shared memory a kernel-4 block may take beside its static bytes
// (the scan counts, the vote slots and the copies' addresses)
constexpr size_t kWarmDynamicSmem = 232448 - 4352;

// first e in [0, E) with dst[e] >= x (E where none)
__device__ __forceinline__ int first_at_least(const int32_t* dst, int E, int x) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dst[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Kernel 4's rounds over the block's slice [lo, lo + n): the records of
// owned vertex j are rec[heads[j].x + kStride u], u < heads[j].y (kStride
// 32: rows of 32 per 32-vertex group; 1: runs); one round, then
// kWarmSweeps rounds in place between two votes, until a vote's rounds change nothing
// anywhere.  Where
// kGlobal, d is the cluster's one copy in global memory, read volatile;
// else the block's own copy in shared memory, each improvement stored into
// the other blocks' copies too (copies[r]).  Inlined where its pointers'
// address space is known, so the loads are shared- or global-memory ones,
// not generic.  Returns the rounds run.
template <bool kCluster, bool kGlobal, int kStride>
__device__ __forceinline__ int warm_dist_rounds(float* d, const int2* heads, const int2* rec,
                                                float* const* copies, int* votes, int lo,
                                                int n, int rank, int C, int V) {
  using Dist = typename std::conditional<kGlobal, volatile float, float>::type;
  Dist* dd = d;
  int rounds = 0;
  for (int vote = 0; vote < V; ++vote) {
    int changed = 0;
    // the first vote runs one round: where the seed is already the fixed
    // point (a tick that moved nothing in this area), that round and its
    // vote are the whole solve
    const int vote_sweeps = vote == 0 ? 1 : kWarmSweeps;
    for (int sweep = 0; sweep < vote_sweeps; ++sweep) {
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const int2 h = heads[j];
        const int v = lo + j;
        const float cur = dd[v];
        float best = cur;
        for (int u0 = 0; u0 < h.y; u0 += kWarmRecordBatch) {
          int2 r[kWarmRecordBatch];
#pragma unroll
          for (int q = 0; q < kWarmRecordBatch; ++q)
            r[q] = u0 + q < h.y ? rec[h.x + kStride * (u0 + q)] : make_int2(0, 0);
#pragma unroll
          for (int q = 0; q < kWarmRecordBatch; ++q)
            if (u0 + q < h.y) best = fminf(best, dd[r[q].x] + __int_as_float(r[q].y));
        }
        if (best < cur) {
          dd[v] = best;
          changed = 1;
          if constexpr (kCluster && !kGlobal) {
            for (int r = 0; r < C; ++r)
              if (r != rank) reinterpret_cast<volatile float*>(copies[r])[v] = best;
          }
        }
      }
      ++rounds;
      // later sweeps reload what other threads (and blocks) wrote
      if (sweep + 1 < vote_sweeps) __threadfence_block();
    }
    int any;
    if constexpr (kCluster) {
      // kernel 1's vote: a block that changed something sets the vote's
      // slot (by parity) in every block; past the cluster barrier (which
      // also makes every store of the sweeps visible) each block reads its
      // own; the next vote's slot is cleared before that barrier
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
  return rounds;
}

template <bool kCluster, bool kGlobal>
__global__ void __launch_bounds__(kThreads) warm_spf_distances_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ roots,
    const float* __restrict__ d0, float* dist_out, int32_t* __restrict__ rounds_out,
    int2* records, int32_t* head_scratch, int V, int E, int C, int S, int cap_shared,
    float big) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t counts[kThreads + 1];
  __shared__ int votes[2];
  __shared__ float* copies[kWarmMaxCluster];
  __shared__ int e_range[2];
  int rank = 0;
  if constexpr (kCluster) rank = (int)cg::this_cluster().block_rank();
  const int a = blockIdx.x / C;
  const int lo = rank * S;
  const int n = max(0, min(S, V - lo));  // the owned slice [lo, lo + n)
  const int G = (n + 31) / 32;
  const int root = roots[a];
  const size_t edges_at = (size_t)a * E;
  const int32_t* esrc = src + edges_at;
  const int32_t* edst = dst + edges_at;
  const float* ew = w + edges_at;
  const uint8_t* eok = edge_ok + edges_at;
  const uint8_t* ovl = overloaded + (size_t)a * V;
  float* d = kGlobal ? dist_out + (size_t)a * V : reinterpret_cast<float*>(smem);
  int32_t* head_base = kGlobal ? head_scratch + (size_t)blockIdx.x * warm_dist_head_ints(S)
                               : smem + ((size_t)V + (V & 1) + 3) / 4 * 4;
  int2* heads = reinterpret_cast<int2*>(head_base);
  int32_t* gbase = head_base + 2 * (size_t)S;
  // the record cursors live in d's room of the owned slice until the
  // block seeds its distances
  int32_t* cursor = reinterpret_cast<int32_t*>(d) + lo;
  // the usable in-edge: ok, its source free to transit (the reference's
  // src_ok, openr_tpu/ops/spf.py:463)
  const auto usable = [&](int e, int& s) -> bool {
    if (!eok[e]) return false;
    s = esrc[e];
    return !ovl[s] || s == root;
  };

  // 1. the slice's in-edges are one range of the dst-sorted list; each
  // owned vertex's usable in-degree, counted over that range
  if (threadIdx.x < 2) e_range[threadIdx.x] = first_at_least(edst, E, threadIdx.x ? lo + n : lo);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    heads[j] = make_int2(0, 0);
    cursor[j] = 0;
  }
  __syncthreads();
  const int e_lo = e_range[0], e_hi = e_range[1];
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += kThreads) {
    int s;
    if (usable(e, s)) atomicAdd(&heads[edst[e] - lo].y, 1);
  }
  __syncthreads();
  // 2. each group's run, 32 records a row of as many rows as its largest
  // in-degree, in shared memory where the block's count fits; else each
  // vertex's records as one run at its place in the block's range of the
  // area's global records
  const int M = block_offsets(
      counts, G,
      [&](int g) {
        int most = 0;
        const int end = min(n, g * 32 + 32);
        for (int j = g * 32; j < end; ++j) most = max(most, heads[j].y);
        return 32 * most;
      },
      [&](int g, int o) { gbase[g] = o; });
  const bool rows = M <= cap_shared;
  int2* shared_rec = reinterpret_cast<int2*>(smem + warm_dist_fixed_ints(V, S));
  int2* global_rec = records + edges_at;
  if (rows) {
    for (int j = threadIdx.x; j < n; j += kThreads) heads[j].x = gbase[j >> 5] + (j & 31);
  } else {
    block_offsets(
        counts, n, [&](int j) { return heads[j].y; },
        [&](int j, int o) { heads[j].x = e_lo + o; });
  }
  __syncthreads();
  // 3. the records {source, bits of w}, each placed at its vertex's cursor
  // (the order within a vertex does not matter: a min takes them in any)
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += kThreads) {
    int s;
    if (!usable(e, s)) continue;
    const int j = edst[e] - lo;
    const int u = atomicAdd(&cursor[j], 1);
    const int2 r = make_int2(s, __float_as_int(ew[e]));
    if (rows) shared_rec[heads[j].x + 32 * u] = r;
    else global_rec[heads[j].x + u] = r;
  }
  __syncthreads();
  // 4. the distances from the seed, the root pinned at 0: a block seeds
  // its own copy whole (the global copy: its slice)
  const float* seed = d0 + (size_t)a * V;
  const int v_lo = kGlobal ? lo : 0;
  const int v_hi = kGlobal ? lo + n : V;
  for (int v = v_lo + (int)threadIdx.x; v < v_hi; v += kThreads) d[v] = v == root ? 0.f : seed[v];
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    if constexpr (!kGlobal)
      if ((int)threadIdx.x < C) copies[threadIdx.x] = cluster.map_shared_rank(d, (int)threadIdx.x);
    if (threadIdx.x < 2) votes[threadIdx.x] = 0;
    // no block stores into another before that one has seeded its copy
    cluster.sync();
  } else {
    __syncthreads();
  }
  // 5. the rounds
  int rounds;
  if (rows)
    rounds = warm_dist_rounds<kCluster, kGlobal, 32>(d, heads, shared_rec, copies, votes, lo, n,
                                                     rank, C, V);
  else
    rounds = warm_dist_rounds<kCluster, kGlobal, 1>(d, heads, global_rec, copies, votes, lo, n,
                                                    rank, C, V);
  if constexpr (!kGlobal)
    for (int j = threadIdx.x; j < n; j += kThreads) dist_out[(size_t)a * V + lo + j] = d[lo + j];
  if (threadIdx.x == 0 && rank == 0) rounds_out[a] = rounds;
  // no block leaves while another may still store into its shared memory
  if constexpr (kCluster) cg::this_cluster().sync();
}

// Kernel 5's block state (reset_lanes_state_ints), carved from `base`
// (dynamic shared memory, or the area's slice of a global scratch):
// distances [V], lane words [V * W] (W = ceil(D / 32)) and scan counts
// [kThreads + 1]; its lane lists (lane_lists_ints(V, E): source counts,
// the moving vertices, their offsets and a source per in-edge) follow or
// live in the slice.
__host__ __device__ inline size_t reset_lanes_state_ints(int V, int D) {
  return (size_t)V + (size_t)V * ((D + 31) / 32) + kThreads + 1;
}

// blocks of kernel 5's thread block cluster per area, at most
constexpr int kResetMaxCluster = 8;
// OR rounds kernel 5 runs between two votes: on the grid's ticks on the
// H100, 8 was 35-50 % faster than 1 and no slower than 16 (PERF.md)
constexpr int kResetSweeps = 8;

// Kernel 5's work for its block, its state and lists at `state` and
// `lists` (shared memory or its slice of the scratch; shared_ints: the
// block's dynamic shared memory).  Inlined into each branch of the kernel,
// so where both lie in shared memory the compiler emits shared-memory
// loads rather than generic ones.
__device__ __forceinline__ void reset_lanes_block(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ roots,
    const float* __restrict__ dist, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ root_rank, int8_t* __restrict__ nh,
    int32_t* __restrict__ rounds_out, int32_t* scratch, int32_t* shared_ints,
    int32_t* state, int32_t* lists, size_t state_ints, size_t slice_ints, int layout,
    int V, int E, int D, int cshift, float big) {
  __shared__ int lanes_used;
  __shared__ int votes[2];
  __shared__ uint32_t* copies[kResetMaxCluster];
  __shared__ int32_t* rlists[kResetMaxCluster];
  __shared__ int* used[kResetMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = 1 << cshift;
  const int rank = (int)cluster.block_rank();
  const int a = (int)(blockIdx.x >> cshift);
  const int T = blockDim.x;
  const int W = (D + 31) / 32;
  const int root = roots[a];
  const size_t edges_at = (size_t)a * E;
  const int32_t* esrc = src + edges_at;
  const int32_t* edst = dst + edges_at;
  const float* ew = w + edges_at;
  const uint8_t* eok = edge_ok + edges_at;
  const int32_t* erank = root_rank + edges_at;
  const uint8_t* ovl = overloaded + (size_t)a * V;
  const int32_t* off = seg_off + (size_t)a * (V + 1);
  // block (a, r)'s slice of the scratch
  const auto slice_of = [&](int r) { return scratch + ((size_t)a * C + r) * slice_ints; };
  float* d = reinterpret_cast<float*>(state);
  volatile uint32_t* words = reinterpret_cast<volatile uint32_t*>(state + V);
  int32_t* counts = state + V + (size_t)V * W;
  int32_t* count = lists;
  int32_t* moving = count + V;
  int32_t* poff = moving + V;
  int32_t* psrc = poff + V + 1;
  // counts and words are set by atomics (and may live in a global
  // scratch), so they are read past the L1
  const volatile int32_t* vcount = count;

  if (threadIdx.x < C) {
    const int r = threadIdx.x;
    int32_t* base = layout == kGlobalAll ? slice_of(r) : cluster.map_shared_rank(shared_ints, r);
    copies[r] = reinterpret_cast<uint32_t*>(base + V);
    // block r's lane lists: count [V] (then its cursors) and psrc after
    // them (lane_lists_ints)
    rlists[r] = layout == kSharedAll         ? base + state_ints
                : layout == kSharedFrontier ? slice_of(r)
                                            : slice_of(r) + state_ints;
    used[r] = reinterpret_cast<int*>(cluster.map_shared_rank(&lanes_used, r));
  }
  if (threadIdx.x < 2) votes[threadIdx.x] = 0;
  for (int v = threadIdx.x; v < V; v += T) {
    d[v] = dist[(size_t)a * V + v];
    count[v] = 0;
  }
  for (int i = threadIdx.x; i < V * W; i += T) words[i] = 0u;
  if (threadIdx.x == 0) lanes_used = 0;
  // no block adds into another's words or counts before that one has
  // cleared them
  cluster.sync();
  // in-edge e on the shortest-path DAG: usable (ok, its source free to
  // transit) with d[src] + w == d[dst] < BIG; returns its source, else -1
  const auto dag_source = [&](int e) {
    if (!eok[e]) return -1;
    const float dv = d[edst[e]];
    if (dv >= big) return -1;
    const int s = esrc[e];
    if (ovl[s] && s != root) return -1;
    return d[s] + ew[e] == dv ? s : -1;
  };
  // vertex v is owned by block v % C of the area's cluster; the blocks
  // split the edges, block r the r-th of C contiguous ranges
  const int chunk = (E + C - 1) / C;
  const int e_lo = rank * chunk < E ? rank * chunk : E;
  const int e_hi = e_lo + chunk < E ? e_lo + chunk : E;
  // 1. every in-edge classified once, a thread an edge: a DAG edge out of
  // the root sets its seed bit (lane root_rank) in every block's copy of
  // the words, any other counts a propagating source of its head at the
  // head's owner
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += T) {
    const int s = dag_source(e);
    if (s < 0) continue;
    const int v = edst[e];
    if (s != root) {
      atomicAdd(rlists[v & (C - 1)] + v, 1);
      continue;
    }
    const int r = erank[e];
    if (r < D) {
      for (int q = 0; q < C; ++q) {
        atomicOr(copies[q] + (size_t)v * W + (r >> 5), 1u << (r & 31));
        atomicMax(used[q], r + 1);
      }
    }
  }
  cluster.sync();
  // 2. the owned moving vertices (a propagating source at least) and the
  // offsets of their sources (count becomes each one's packing cursor);
  // then, past a cluster barrier, the sources packed at their heads'
  // owners by a second pass over the edges (OR takes them in any order)
  const int num_moving = block_ranks(
      counts, V, [&](int v) { return vcount[v] > 0; },
      [&](int v, int k) {
        if (k >= 0) moving[k] = v;
      });
  const int num_prop = block_offsets(
      counts, num_moving, [&](int k) { return vcount[moving[k]]; },
      [&](int k, int o) {
        poff[k] = o;
        count[moving[k]] = o;
      });
  if (threadIdx.x == 0) poff[num_moving] = num_prop;
  cluster.sync();
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += T) {
    const int s = dag_source(e);
    if (s < 0 || s == root) continue;
    const int v = edst[e];
    int32_t* at = rlists[v & (C - 1)];
    // psrc follows count [V], moving [V] and poff [V + 1]
    at[3 * V + 1 + atomicAdd(at + v, 1)] = s;
  }
  // every source packed (and every seed set) before the rounds read them
  cluster.sync();
  // 3. OR rounds over the owned moving vertices' words that a seed can
  // reach, a changed word stored into every block's copy; a vote every
  // kResetSweeps rounds, kernel 1's where C > 1: a block that changed
  // something sets the vote's slot (by parity) in every block, read past
  // the cluster barrier (which also makes every remote store before it
  // visible); the other slot, the next vote's, is cleared before that
  // barrier
  const int L = lanes_used < D ? lanes_used : D;
  int vote = 0;
  const int rounds = or_word_rounds(
      words, W, (L + 31) / 32, moving, num_moving, poff, psrc, V, kResetSweeps,
      [&](size_t at, uint32_t x) {
        for (int r = 0; r < C; ++r) reinterpret_cast<volatile uint32_t*>(copies[r])[at] = x;
      },
      [&](int changed) {
        const int mine = __syncthreads_or(changed);
        if (C == 1) return mine;
        if (threadIdx.x == 0) votes[(vote + 1) & 1] = 0;
        if (mine && (int)threadIdx.x < C)
          *reinterpret_cast<volatile int*>(cluster.map_shared_rank(&votes[vote & 1], (int)threadIdx.x)) = 1;
        cluster.sync();
        return *reinterpret_cast<volatile int*>(&votes[vote++ & 1]);
      });
  // 4. the int8 table, written once over the cluster (a block a slice of
  // the vertices, from its copy): -128 where the run is empty, else the bit
  const int part = (V + C - 1) / C;
  const int lo = rank * part < V ? rank * part : V;
  const int hi = lo + part < V ? lo + part : V;
  write_word_lanes(nh + (size_t)a * V * D, words, [&](int v) { return off[v] < off[v + 1]; }, lo,
                   hi, D);
  if (threadIdx.x == 0 && rank == 0) rounds_out[a] = rounds;
}

__global__ void __launch_bounds__(kThreads) spf_nexthop_lanes_reset_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ roots,
    const float* __restrict__ dist, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ root_rank, int8_t* __restrict__ nh,
    int32_t* __restrict__ rounds_out, int32_t* scratch, size_t state_ints,
    size_t slice_ints, int layout, int V, int E, int D, int cshift, float big) {
  extern __shared__ int32_t shared_ints[];
  if (layout == kSharedAll) {
    reset_lanes_block(src, dst, w, edge_ok, overloaded, roots, dist, seg_off, root_rank, nh,
                      rounds_out, scratch, shared_ints, shared_ints, shared_ints + state_ints,
                      state_ints, slice_ints, layout, V, E, D, cshift, big);
  } else {
    const size_t at = (size_t)(blockIdx.x >> cshift) * (1 << cshift) +
                      cg::this_cluster().block_rank();
    int32_t* slice = scratch + at * slice_ints;
    reset_lanes_block(src, dst, w, edge_ok, overloaded, roots, dist, seg_off, root_rank, nh,
                      rounds_out, scratch, shared_ints,
                      layout == kGlobalAll ? slice : shared_ints,
                      layout == kSharedFrontier ? slice : slice + state_ints, state_ints,
                      slice_ints, layout, V, E, D, cshift, big);
  }
}

// -- kernel 6: the bounded repair over each area's reset list -------------

// threads of every block of kernel 6 (an area's solving block, the copy
// blocks)
constexpr int kRepairThreads = 1024;
// dynamic shared memory a solving block may take beside its static bytes
// (ops/spf.py SUB_REPAIR_SHARED_BYTES, held equal by a test: the launcher
// sizes the global scratch by it)
constexpr int kRepairSmemMax = 232448 - 6144;
// 16-byte words of the kept rows one copy block takes
constexpr int kRepairCopyWords = 4 * kRepairThreads;
// threads of a frontier round that share a frontier vertex's out-records
constexpr int kFrontierLanes = 4;

// A solving block's state in 4-byte words (ops/spf.py
// sub_repair_state_ints): per listed vertex (n), the vertex, its distance,
// its has-a-sub-edge flag, its out-record count (then cursor), its
// frontier tag, two frontier lists, its W lane words and its out-record run
// (off, n + 1); three words per inner record (at most Es), by source:
// its vertex (~vertex once dropped from the lane rounds), w and lane rank.
__host__ __device__ inline size_t sub_repair_state_ints(int n, int Es, int W) {
  return (size_t)(8 + W) * n + 1 + 3 * (size_t)Es;
}

struct RepairState {
  int32_t* list;
  float* d;
  int32_t* has;
  int32_t* cnt;  // out-record counts, then cursors
  int32_t* tag;  // the round tag of the frontier list a vertex was last put in
  int32_t* fa;   // frontier lists: even rounds read fa, odd ones fb
  int32_t* fb;
  uint32_t* bits;
  int32_t* off;  // [n + 1] out-record runs
  int32_t* ci;   // inner records by source: vertex, w, lane rank
  float* cw;
  int32_t* cr;
  int32_t* map;  // [V] each vertex's list index (-1: not listed), or null
  __device__ __forceinline__ RepairState(int32_t* base, int n, int Es, int W, bool mapped) {
    list = base;
    d = reinterpret_cast<float*>(base + n);
    has = base + 2 * (size_t)n;
    cnt = base + 3 * (size_t)n;
    tag = base + 4 * (size_t)n;
    fa = base + 5 * (size_t)n;
    fb = base + 6 * (size_t)n;
    bits = reinterpret_cast<uint32_t*>(base + 7 * (size_t)n);
    off = base + (size_t)(7 + W) * n;
    ci = off + n + 1;
    cw = reinterpret_cast<float*>(ci + Es);
    cr = ci + 2 * (size_t)Es;
    map = mapped ? cr + Es : nullptr;
  }
};

// A state word: a plain load in shared memory; in the global scratch an L2
// load (__ldcg), so a word another thread stored or changed by an atomic
// is never read from a stale L1 line.
template <bool kShared, class T>
__device__ __forceinline__ T state_load(const T* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldcg(p);
}

// Exclusive scan of c over the block in thread order; the block's sum in
// *total.  Ends with a barrier.
__device__ __forceinline__ int block_scan_count(int c, int* total) {
  __shared__ int32_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    const int x = warp_sums[k];
    before += k < warp ? x : 0;
    all += x;
  }
  __syncthreads();
  *total = all;
  return before + inc - c;
}

// Bit k set where flag f[v + k] is (k < 16, v + k < V): one 16-byte load
// where the flags allow.
__device__ __forceinline__ uint32_t flag_bits16(const uint8_t* f, int v, int V) {
  uint32_t out = 0;
  if (v + 16 <= V && (reinterpret_cast<uintptr_t>(f + v) & 15) == 0) {
    const uint4 x = *reinterpret_cast<const uint4*>(f + v);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) out |= (uint32_t)(((w[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0) << k;
  } else {
    for (int k = 0; k < 16 && v + k < V; ++k) out |= (uint32_t)(f[v + k] != 0) << k;
  }
  return out;
}

// The list index of vertex v in the ascending list, or -1.
template <bool kShared>
__device__ __forceinline__ int find_listed(const int32_t* list, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (state_load<kShared>(list + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && state_load<kShared>(list + lo) == v ? lo : -1;
}

// The list index of vertex v: from the map where the state holds one,
// else by binary search.
template <bool kShared>
__device__ __forceinline__ int listed_index(const RepairState& S, int n, int v) {
  return S.map ? state_load<kShared>(S.map + v) : find_listed<kShared>(S.list, n, v);
}

// The vote that ends a round of the K round threads (the first K of the
// block, K a multiple of 32): warp votes where K is one warp, else a
// reduction on named barrier 1 (the other warps are not held).  Either
// orders the round's shared- and global-memory accesses before the next's.
__device__ __forceinline__ int round_vote(int changed, int K) {
  if (K == 32) {
    __syncwarp();
    return __any_sync(0xffffffffu, changed);
  }
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, %2, p;\n\tselp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"(changed), "r"(K)
      : "memory");
  return out;
}

// Kernel 6's frontier list sizes (three rotating counters), its record
// counts (inner from the front, outer from the back) and block scan
// counts.
__shared__ int frontier_sizes[3];
__shared__ int record_counts[2];
__shared__ int32_t scan_counts[kRepairThreads + 1];

// Round r of a frontier solve by the K round threads, kFrontierLanes
// threads a frontier vertex: each vertex u of the frontier list (fa on
// even rounds, fb on odd ones; its size in sizes[r % 3]) calls move(q, u)
// on each of its out-records q (a thread every kFrontierLanes-th), whose
// vertex is i (returned: moved, i); a moved vertex goes into the next
// round's list once (its tag: base + r + 1).  The sizes rotate over three
// counters: thread 0 clears the one the round before read, so the next
// round's counter is 0 before any thread appends to it (the vote between
// rounds orders both).  Sets *changed; returns r + 1.
template <bool kShared, class Move>
__device__ __forceinline__ int frontier_round(const RepairState& S, int r, int base, int K,
                                              Move move, int* changed) {
  volatile int* sizes = frontier_sizes;
  const int size = sizes[r % 3];
  const int32_t* cur = (r & 1) ? S.fb : S.fa;
  int32_t* next = (r & 1) ? S.fa : S.fb;
  if (threadIdx.x == 0) sizes[(r + 2) % 3] = 0;
  const int tag = base + r + 1;
  const int g = threadIdx.x % kFrontierLanes;
  for (int k = threadIdx.x / kFrontierLanes; k < size; k += K / kFrontierLanes) {
    const int u = state_load<kShared>(cur + k);
    const int q1 = state_load<kShared>(S.off + u + 1);
    for (int q = state_load<kShared>(S.off + u) + g; q < q1; q += kFrontierLanes) {
      const int2 m = move(q, u);
      if (m.x) {
        *changed = 1;
        if (atomicExch(S.tag + m.y, tag) != tag)
          next[atomicAdd(const_cast<int*>(sizes + (r + 1) % 3), 1)] = m.y;
      }
    }
  }
  return r + 1;
}

// OR the lane bits (value > 0: lanes are -128, 0 or 1) of one row of D
// lanes into its W words (atomicOr: an L2 operation in the global scratch).
__device__ __forceinline__ void or_row_bits(uint32_t* words, const int8_t* row, int D) {
  for (int l0 = 0; l0 < D; l0 += 32) {
    const int m = D - l0 < 32 ? D - l0 : 32;
    uint32_t x = 0;
    for (int l = 0; l < m; ++l) x |= (uint32_t)(row[l0 + l] > 0) << l;
    if (x) atomicOr(words + (l0 >> 5), x);
  }
}

// Area a's solve over its n listed (reset) vertices, the state S carved
// from `base`: shared memory, or the area's slice of the global scratch;
// `temp` the area's [4, Es] record list in edge-pass order (inner records
// {source index, vertex, w, rank} from the front, outer ones {source,
// vertex, w, rank} from the back).
template <bool kShared>
__device__ __forceinline__ void repair_area(
    int32_t* base, bool mapped, int32_t* temp, int n, int a, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const float* __restrict__ w,
    const uint8_t* __restrict__ ok, const int32_t* __restrict__ rank,
    const float* __restrict__ prev_dist, const int8_t* __restrict__ prev_nh,
    const uint8_t* __restrict__ reset, float* __restrict__ dist_out, int8_t* nh_out,
    int32_t* rounds_d, int32_t* rounds_l, int V, int Es, int D, float big) {
  const int T = blockDim.x;
  const int W = (D + 31) / 32;
  const RepairState S(base, n, Es, W, mapped);
  const size_t row0 = (size_t)a * V;
  const auto load = [](const auto* p) { return state_load<kShared>(p); };
  int32_t* t_src = temp;
  int32_t* t_dst = temp + Es;
  float* t_w = reinterpret_cast<float*>(temp + 2 * (size_t)Es);
  int32_t* t_rank = temp + 3 * (size_t)Es;
  // 1. the list: the reset vertices in ascending order, 16 flags a thread
  // (and the map, where the state holds one)
  if (mapped) {
    for (int v = threadIdx.x; v < V; v += T) S.map[v] = -1;
    __syncthreads();
  }
  int listed = 0;
  for (int v0 = 0; v0 < V; v0 += 16 * T) {
    const int v = v0 + 16 * (int)threadIdx.x;
    uint32_t mine = v < V ? flag_bits16(reset + row0, v, V) : 0u;
    int total;
    int at = listed + block_scan_count(__popc(mine), &total);
    for (; mine; mine &= mine - 1, ++at) {
      S.list[at] = v + __ffs(mine) - 1;
      if (mapped) S.map[v + __ffs(mine) - 1] = at;
    }
    listed += total;
  }
  for (int i = threadIdx.x; i < n; i += T) {
    S.d[i] = big;
    S.has[i] = 0;
    S.cnt[i] = 0;
    S.tag[i] = 0;
    for (int k = 0; k < W; ++k) S.bits[(size_t)i * W + k] = 0u;
  }
  if (threadIdx.x == 0) {
    record_counts[0] = record_counts[1] = 0;
    frontier_sizes[0] = frontier_sizes[1] = frontier_sizes[2] = 0;
  }
  __syncthreads();
  // 2. the records: each usable sub-edge of a listed vertex, 4 consecutive
  // edges a thread a pass (their loads and searches together), into the
  // temp list: inner (its source listed too) from the front, outer from
  // the back (a warp's places by one atomicAdd); an outer record's
  // candidate is constant and lowers the distance now (an integer
  // atomicMin: distances are >= 0, so integer order is float order), and
  // an inner one counts an out-record of its source
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < Es; e0 += 4 * T) {
    int i[4], j[4], s[4], rk[4];
    float we[4], cand[4];
    bool use[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + 4 * (int)threadIdx.x + u;
      i[u] = -1;
      use[u] = false;
      if (e < Es) {
        s[u] = src[e];
        we[u] = w[e];
        rk[u] = rank[e];
        use[u] = ok[e] != 0;
        cand[u] = prev_dist[row0 + s[u]] + we[u];
        i[u] = listed_index<kShared>(S, n, dst[e]);
        j[u] = listed_index<kShared>(S, n, s[u]);
      }
    }
    int n_in = 0, n_out = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i[u] < 0) continue;
      S.has[i[u]] = 1;  // a padding or unusable edge too: the run is not empty
      if (!use[u]) continue;
      if (j[u] >= 0) {
        ++n_in;
        atomicAdd(S.cnt + j[u], 1);
      } else {
        ++n_out;
        atomicMin(reinterpret_cast<int*>(S.d + i[u]), __float_as_int(cand[u]));
      }
    }
    // the warp's places: an inclusive scan of both counts (inner in the low
    // 16 bits), one atomicAdd each by the last lane
    int both = n_in | (n_out << 16);
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, both, o);
      if (lane >= o) both += y;
    }
    int at_in = 0, at_out = 0;
    if (lane == 31) {
      at_in = atomicAdd(record_counts, both & 0xffff);
      at_out = atomicAdd(record_counts + 1, both >> 16);
    }
    at_in = __shfl_sync(0xffffffffu, at_in, 31) + (both & 0xffff) - n_in;
    at_out = __shfl_sync(0xffffffffu, at_out, 31) + (both >> 16) - n_out;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i[u] < 0 || !use[u]) continue;
      const int p = j[u] >= 0 ? at_in++ : Es - 1 - at_out++;
      t_src[p] = j[u] >= 0 ? j[u] : s[u];
      t_dst[p] = i[u];
      t_w[p] = we[u];
      t_rank[p] = rk[u];
    }
  }
  __syncthreads();
  const int n_in = record_counts[0], n_out = record_counts[1];
  // 3. the inner records by source: offsets (a block scan of the counts)
  // and each record at its source's cursor
  block_offsets(
      scan_counts, n, [&](int u) { return load(S.cnt + u); },
      [&](int u, int o) {
        S.off[u] = o;
        S.cnt[u] = o;
      });
  if (threadIdx.x == 0) S.off[n] = n_in;
  for (int p = threadIdx.x; p < n_in; p += T) {
    const int q = atomicAdd(S.cnt + __ldcg(t_src + p), 1);
    S.ci[q] = __ldcg(t_dst + p);
    S.cw[q] = __ldcg(t_w + p);
    S.cr[q] = __ldcg(t_rank + p);
  }
  // the first frontier: every listed vertex the outer records lowered
  for (int u = threadIdx.x; u < n; u += T) {
    if (load(S.d + u) < big) {
      S.tag[u] = 1;
      S.fa[atomicAdd(frontier_sizes, 1)] = u;
    }
  }
  __syncthreads();
  // 4. distances: frontier rounds of the K round threads, each relaxing
  // its frontier's out-records (an integer atomicMin)
  const int warps = (n + 255) / 256;
  const int K = 32 * (warps < 1 ? 1 : warps > 8 ? 8 : warps);
  const bool rounder = threadIdx.x < K;
  int rd = 0, rl = 0;
  if (n > 0 && rounder) {
    for (;;) {
      int changed = 0;
      rd = frontier_round<kShared>(S, rd, 1, K, [&](int q, int u) {
        const int i = load(S.ci + q);
        const float cand = load(S.d + u) + load(S.cw + q);
        return make_int2(cand < load(S.d + i) &&
                             __float_as_int(cand) <
                                 atomicMin(reinterpret_cast<int*>(S.d + i), __float_as_int(cand)),
                         i);
      }, &changed);
      if (!round_vote(changed, K) || rd > n) break;
    }
  }
  __syncthreads();
  // 5. lanes: the outer records on the DAG seed their lane or OR in their
  // source's previous lanes (bit l set where its lane l is 1); the inner
  // ones on the DAG out of the root seed their lane, and every inner one
  // but those out of another vertex on the DAG is dropped (its vertex
  // complemented)
  for (int p = Es - n_out + (int)threadIdx.x; p < Es; p += T) {
    const int i = __ldcg(t_dst + p), s = __ldcg(t_src + p), rk = __ldcg(t_rank + p);
    const float dv = load(S.d + i);
    if (!(dv < big) || prev_dist[row0 + s] + __ldcg(t_w + p) != dv) continue;
    uint32_t* bi = S.bits + (size_t)i * W;
    if (rk >= 0) {
      if (rk < D) atomicOr(bi + (rk >> 5), 1u << (rk & 31));
    } else {
      or_row_bits(bi, prev_nh + (row0 + s) * D, D);
    }
  }
  for (int u = threadIdx.x; u < n; u += T) {
    const float du = load(S.d + u);
    const int q1 = load(S.off + u + 1);
    for (int q = load(S.off + u); q < q1; ++q) {
      const int i = load(S.ci + q), rk = load(S.cr + q);
      const float dv = load(S.d + i);
      const bool on = dv < big && du + load(S.cw + q) == dv;
      if (on && rk >= 0 && rk < D) atomicOr(S.bits + (size_t)i * W + (rk >> 5), 1u << (rk & 31));
      if (!on || rk >= 0) S.ci[q] = ~i;
    }
  }
  if (threadIdx.x == 0) frontier_sizes[0] = frontier_sizes[1] = frontier_sizes[2] = 0;
  __syncthreads();
  // 6. lane rounds: frontier rounds from every listed vertex with a bit set,
  // each ORing (atomicOr) its words into the vertices of its propagating
  // out-records (its tags after the distances')
  const int tag0 = rd + 2;
  for (int u = threadIdx.x; u < n; u += T) {
    uint32_t any = 0;
    for (int k = 0; k < W; ++k) any |= load(S.bits + (size_t)u * W + k);
    if (any) {
      S.tag[u] = tag0;
      S.fa[atomicAdd(frontier_sizes, 1)] = u;
    }
  }
  __syncthreads();
  if (n > 0 && rounder) {
    for (;;) {
      int changed = 0;
      rl = frontier_round<kShared>(S, rl, tag0, K, [&](int q, int u) {
        const int i = load(S.ci + q);
        bool grew = false;
        for (int k = 0; k < W && i >= 0; ++k) {
          const uint32_t x = load(S.bits + (size_t)u * W + k);
          if ((x & ~load(S.bits + (size_t)i * W + k)) &&
              (x & ~atomicOr(S.bits + (size_t)i * W + k, x)))
            grew = true;
        }
        return make_int2(grew, i);
      }, &changed);
      if (!round_vote(changed, K) || rl > n) break;
    }
  }
  __syncthreads();
  // 7. the listed rows out: distances, and lanes from the words (-128 where
  // the vertex has no sub-edge), 4 lanes an item
  for (int i = threadIdx.x; i < n; i += T) dist_out[row0 + load(S.list + i)] = load(S.d + i);
  const int C4 = (D + 3) / 4;
  for (int it = threadIdx.x; it < n * C4; it += T) {
    const int i = it / C4;
    const int l0 = 4 * (it - i * C4);
    const int l1 = l0 + 4 < D ? l0 + 4 : D;
    int8_t* row = nh_out + (row0 + load(S.list + i)) * D;
    const bool h = load(S.has + i) != 0;
    for (int l = l0; l < l1; ++l) {
      const uint32_t word = load(S.bits + (size_t)i * W + (l >> 5));
      row[l] = h ? (int8_t)((word >> (l & 31)) & 1u) : (int8_t)-128;
    }
  }
  if (threadIdx.x == 0) {
    rounds_d[a] = rd;
    rounds_l[a] = rl;
  }
}

// Copy the rows of a [rows, width]-byte table whose reset flag is clear,
// 16 bytes at a time where both tables are 16-byte aligned, over this
// block's share of the words: a thread issues the loads of 4 words and
// their rows' flags before it stores; a word whose rows are all reset is
// skipped, one with some reset rows stored byte by byte from the word
// loaded (the other tail bytes one at a time).
__device__ void copy_kept_rows(uint8_t* out, const uint8_t* in, const uint8_t* reset, size_t rows,
                               size_t width, size_t first, size_t stride) {
  const size_t total = rows * width;
  size_t done = 0;
  if (((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(in)) & 15) == 0) {
    const size_t words = total / 16;
    for (size_t k0 = first; k0 < words; k0 += 4 * stride) {
      uint4 x[4];
      uint32_t gone[4];  // bit r - r0: row r of the word reset
      size_t r0[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t k = k0 + u * stride;
        if (k >= words) continue;
        x[u] = reinterpret_cast<const uint4*>(in)[k];
        r0[u] = 16 * k / width;
        const size_t r1 = (16 * k + 15) / width;
        gone[u] = 0;
        for (size_t r = r0[u]; r <= r1; ++r) gone[u] |= (uint32_t)(reset[r] != 0) << (r - r0[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t k = k0 + u * stride;
        if (k >= words) continue;
        if (!gone[u]) {
          reinterpret_cast<uint4*>(out)[k] = x[u];
          continue;
        }
        const uint32_t word[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        size_t col = 16 * k - r0[u] * width;
        int row = 0;
#pragma unroll
        for (int b = 0; b < 16; ++b, ++col) {
          if (col == width) {
            col = 0;
            ++row;
          }
          if (!((gone[u] >> row) & 1u)) out[16 * k + b] = (uint8_t)(word[b >> 2] >> (8 * (b & 3)));
        }
      }
    }
    done = 16 * words;
  }
  for (size_t at = done + first; at < total; at += stride)
    if (!reset[at / width]) out[at] = in[at];
}

// Blocks [0, A) solve an area each over its reset list (its state in
// shared memory where sub_repair_state_ints(n, Es, W) fits `smem` bytes,
// else in the area's slice of `scratch`); the blocks after them copy the
// kept (non-reset) rows of both tables.
__global__ void __launch_bounds__(kRepairThreads) warm_subgraph_repair_kernel(
    const int32_t* __restrict__ src_sub, const int32_t* __restrict__ dst_sub,
    const float* __restrict__ w_sub, const uint8_t* __restrict__ ok_sub,
    const int32_t* __restrict__ rank_sub, const float* __restrict__ prev_dist,
    const int8_t* __restrict__ prev_nh, const uint8_t* __restrict__ reset,
    int32_t* __restrict__ scratch, int32_t* __restrict__ temp, float* __restrict__ dist_out,
    int8_t* nh_out, int32_t* __restrict__ rounds_d, int32_t* __restrict__ rounds_l, int A, int V,
    int Es, int D, int smem, float big) {
  extern __shared__ int32_t repair_smem[];
  __shared__ int32_t listed_s;
  const int a = blockIdx.x;
  if (a >= A) {
    const size_t first = (size_t)(a - A) * blockDim.x + threadIdx.x;
    const size_t stride = (size_t)(gridDim.x - A) * blockDim.x;
    const size_t rows = (size_t)A * V;
    copy_kept_rows(reinterpret_cast<uint8_t*>(dist_out),
                   reinterpret_cast<const uint8_t*>(prev_dist), reset, rows, 4, first, stride);
    copy_kept_rows(reinterpret_cast<uint8_t*>(nh_out), reinterpret_cast<const uint8_t*>(prev_nh),
                   reset, rows, D, first, stride);
    return;
  }
  // the area's reset count decides where its state lives
  if (threadIdx.x == 0) listed_s = 0;
  __syncthreads();
  int mine = 0;
  for (int v = 16 * threadIdx.x; v < V; v += 16 * blockDim.x)
    mine += __popc(flag_bits16(reset + (size_t)a * V, v, V));
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&listed_s, mine);
  __syncthreads();
  const int n = listed_s;
  const int W = (D + 31) / 32;
  const size_t edges_at = (size_t)a * Es;
  int32_t* area_temp = temp + (size_t)a * 4 * Es;
  const size_t need = 4 * sub_repair_state_ints(n, Es, W);
  if (need <= (size_t)smem) {
    // the map of vertex to list index too, where it still fits
    repair_area<true>(repair_smem, need + 4 * (size_t)V <= (size_t)smem, area_temp, n, a,
                      src_sub + edges_at, dst_sub + edges_at, w_sub + edges_at,
                      ok_sub + edges_at, rank_sub + edges_at, prev_dist, prev_nh, reset,
                      dist_out, nh_out, rounds_d, rounds_l, V, Es, D, big);
  } else {
    repair_area<false>(scratch + (size_t)a * sub_repair_state_ints(V, Es, W), false, area_temp,
                       n, a, src_sub + edges_at, dst_sub + edges_at, w_sub + edges_at,
                       ok_sub + edges_at, rank_sub + edges_at, prev_dist, prev_nh, reset,
                       dist_out, nh_out, rounds_d, rounds_l, V, Es, D, big);
  }
}

// full edge list minus a failed set: kernel 14's round-form usability (ok,
// its src may transit: an overloaded node other than the root does not
// relax its out-edges, and no edge of a failed link of this area)
struct MaskedEdges {
  const uint8_t* edge_ok;
  const uint8_t* overloaded;
  const int32_t* link_index;
  const int32_t* failed;  // this area's failed link ids (all >= 0)
  int num_failed;
  int root;
  __device__ bool usable(int e, int s) const {
    if (!edge_ok[e] || (overloaded[s] && s != root)) return false;
    for (int k = 0; k < num_failed; ++k)
      if (link_index[e] == failed[k]) return false;
    return true;
  }
};

// kernel 14's round form: threads per pair (the 256 of the
// scan counts in ops/spf.py segment_rounds_state_bytes)
constexpr int kBatchThreads = 256;

// Kernel 14's round-form per-block state in dynamic shared memory: run
// ends [V], lane ranks [E], scan counts [T + 1], failed links [S],
// distances [V], edge classes [E].
__host__ __device__ inline size_t segment_rounds_state_bytes(int V, int E,
                                                             int S) {
  return (size_t)(V + E + kBatchThreads + 1 + S) * 4 +
         (size_t)V * sizeof(float) + (size_t)E;
}

// Kernel 14's round-form work on one (row, area) pair r = batch row * A + area, with
// the block's state carved from `state` (segment_rounds_state_bytes).
__device__ __forceinline__ void segment_pair(
    int32_t* state, int& num_failed, int r, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const float* __restrict__ w,
    const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ link_index,
    const int32_t* __restrict__ roots, const int32_t* __restrict__ fail_area,
    const int32_t* __restrict__ fail_link,
    const int32_t* __restrict__ seg_off, float* __restrict__ dist_out,
    int8_t* nh, int A, int V, int E, int D, int S, float big) {
  int32_t* end = state;
  int32_t* rank = end + V;
  int32_t* counts = rank + E;
  int32_t* failed = counts + blockDim.x + 1;
  float* d = reinterpret_cast<float*>(failed + S);
  uint8_t* cls = reinterpret_cast<uint8_t*>(d + V);
  const int VD = V * D;
  const int b = r / A;  // r = batch row * A + area
  const int a = r - b * A;
  const int root = roots[r];
  float* dist = dist_out + (size_t)r * V;
  int8_t* lanes = nh + (size_t)r * V * D;
  if (root < 0) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = big;
    for (int i = threadIdx.x; i < VD; i += blockDim.x) lanes[i] = 0;
    return;
  }
  const size_t edges_at = (size_t)a * E;
  const int32_t* off = seg_off + (size_t)a * (V + 1);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int s = 0; s < S; ++s) {
      const int fl = fail_link[(size_t)b * S + s];
      if (fail_area[(size_t)b * S + s] == a && fl >= 0) failed[n++] = fl;
    }
    num_failed = n;
  }
  // rank[e] = e's rank among the root's out-edges in edge order (its
  // lane), -1 on every other edge
  const int32_t* esrc = src + edges_at;
  const int root_out = block_ranks(
      counts, E, [&](int e) { return esrc[e] == root; },
      [&](int e, int k) { rank[e] = k; });
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    d[v] = v == root ? 0.f : big;
  enabled_run_ends(end, off, dst + edges_at, edge_ok + edges_at, V, E);
  const MaskedEdges edges{edge_ok + edges_at, overloaded + (size_t)a * V,
                          link_index ? link_index + edges_at : nullptr,
                          failed, link_index ? num_failed : 0, root};
  relax_distances(d, off, end, src + edges_at, w + edges_at, edges, V, big);
  for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = d[v];
  classify_edges(cls, d, off, end, src + edges_at, w + edges_at, rank,
                 edges, V, big);
  // an empty run holds -128; every lane no root out-edge can seed stays 0
  // (16 lanes a store where whole rows of D lanes fill 16-byte words)
  if (D % 16 == 0) {
    uint4* words = reinterpret_cast<uint4*>(lanes);
    for (int i = threadIdx.x; i < VD / 16; i += blockDim.x) {
      const int v = i / (D / 16);
      const uint32_t x = off[v] < off[v + 1] ? 0u : 0x80808080u;
      words[i] = make_uint4(x, x, x, x);
    }
  } else {
    for (int i = threadIdx.x; i < VD; i += blockDim.x) {
      const int v = i / D;
      lanes[i] = off[v] < off[v + 1] ? 0 : -128;
    }
  }
  __syncthreads();
  // each seed edge sets its lane, so a vertex without a propagating
  // in-edge holds its fixed point already and the rounds sweep only the
  // others (kept in d's place: the distances are written out and
  // classified)
  const int L = root_out < D ? root_out : D;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    for (int e = off[v]; e < end[v]; ++e)
      if (cls[e] == kSeed && rank[e] < L) lanes[(size_t)v * D + rank[e]] = 1;
  int32_t* moving = reinterpret_cast<int32_t*>(d);
  const int num_moving = block_ranks(
      counts, V,
      [&](int v) {
        for (int e = off[v]; e < end[v]; ++e)
          if (cls[e] == kPropagate) return true;
        return false;
      },
      [&](int v, int k) {
        if (k >= 0) moving[k] = v;
      });
  propagate_lanes(lanes, cls, off, end, esrc, rank, V, L, D, moving,
                  num_moving);
}

// Kernel 14's round form: one block per (row, area) pair, its state in
// dynamic shared memory.
__global__ void __launch_bounds__(kBatchThreads) spf_segment_batch_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ link_index,
    const int32_t* __restrict__ roots, const int32_t* __restrict__ fail_area,
    const int32_t* __restrict__ fail_link,
    const int32_t* __restrict__ seg_off, float* __restrict__ dist_out,
    int8_t* nh, int A, int V, int E, int D, int S, float big) {
  __shared__ int num_failed;
  extern __shared__ int32_t shared_ints[];
  segment_pair(shared_ints, num_failed, blockIdx.x, src, dst, w, edge_ok,
               overloaded, link_index, roots, fail_area, fail_link, seg_off,
               dist_out, nh, A, V, E, D, S, big);
}

// The first i in [0, n) with a[i] >= x (n if none) of ascending a.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ a,
                                           int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The out-edge CSR of kernels 14 and 16, from each area's edges stably
// sorted by source (src_sorted [A, E]; order [A, E], their positions in
// the area's segment list), over the whole card: slot a E + i holds sorted
// position i's {dst, bits of w} where the edge is usable, else a self-loop
// of +inf (it lowers no distance and is on no shortest-path DAG), and, in
// out_id where it is given, the slot's link id (kernel 14, where
// link_index is given) or its edge's position in the area's edge list
// (kernel 16: the row's mask bit); out_off[a][u] = a E + the first sorted
// position of source u, so each source's run holds ALL of its edges in
// edge order and a slot's lane rank is its place in its run
// (frontier_pair with a null out_rank).  Sources out of [0, V) sort
// outside every run.  out_off[a][V] is segment_trim_kernel's.  has[a][v]:
// v is the dst of an edge of the padded, dst-sorted list.
__global__ void __launch_bounds__(256) segment_layout_kernel(
    const int32_t* __restrict__ src_sorted, const int64_t* __restrict__ order,
    const int32_t* __restrict__ dst, const float* __restrict__ w,
    const uint8_t* __restrict__ edge_ok, const int32_t* __restrict__ link_index,
    int2* __restrict__ out_edge, int32_t* __restrict__ out_id,
    int32_t* __restrict__ out_off, uint8_t* __restrict__ has, int A, int V,
    int E) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t s = first; s < (size_t)A * E; s += stride) {
    const size_t e = s / E * E + order[s];
    out_edge[s] = edge_ok[e] ? make_int2(dst[e], __float_as_int(w[e]))
                             : make_int2(src_sorted[s], 0x7f800000);
    if (out_id) out_id[s] = link_index ? link_index[e] : (int)order[s];
  }
  for (size_t s = first; s < (size_t)A * V; s += stride) {
    const size_t a = s / V;
    const int u = (int)(s - a * V);
    const size_t at = a * E;
    out_off[a * (V + 1) + u] = (int)at + lower_bound(src_sorted + at, E, u);
    const int k = lower_bound(dst + at, E, u);
    has[s] = k < E && dst[at + k] == u;
  }
}

// out_off[a][V] of area a = blockIdx.x: the end of source V - 1's run less
// its trailing unusable edges (the padding edges, all from V - 1 at the
// tail of the edge list), so a reached V - 1 never walks them; a dropped
// slot would relax nothing and seed no lane.
__global__ void __launch_bounds__(1024) segment_trim_kernel(
    const int32_t* __restrict__ src_sorted, const int64_t* __restrict__ order,
    const uint8_t* __restrict__ edge_ok, int32_t* __restrict__ out_off, int V,
    int E) {
  __shared__ int end;
  const size_t at = (size_t)blockIdx.x * E;
  const int lo = lower_bound(src_sorted + at, E, V - 1);
  const int hi = lower_bound(src_sorted + at, E, V);
  if (threadIdx.x == 0) end = lo;
  __syncthreads();
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    if (edge_ok[at + order[at + i]]) atomicMax(&end, i + 1);
  __syncthreads();
  if (threadIdx.x == 0) out_off[blockIdx.x * (size_t)(V + 1) + V] = (int)at + end;
}

// The fill of kernels 14 and 16, spread over the card before the solve:
// dist BIG over every (row, area) pair, and the lanes -128 where the
// vertex's run in the padded edge list is empty (has false) and 0
// elsewhere, or 0 throughout on a pair of a -1 root where roots is given
// (kernel 14).  The flat table is written in whole 16-byte words: where
// whole rows of D lanes fill them, one fill byte a word; else (D = 17 on
// the flagship world) each word's bytes walk the rows they cover, and the
// last partial word byte by byte.
__global__ void __launch_bounds__(256) segment_fill_kernel(
    const int32_t* __restrict__ roots, const uint8_t* __restrict__ has,
    float* __restrict__ dist, int8_t* __restrict__ nh, int rows, int A, int V,
    int D, float big) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RV = (size_t)rows * V;
  for (size_t i = first; i < RV; i += stride) dist[i] = big;
  // the fill byte of row-vertex rv = r * V + v, as 0x00 or 0x80
  const auto fill = [&](size_t rv) -> uint32_t {
    const size_t r = rv / V;
    const int v = (int)(rv - r * V);
    return (roots && roots[r] < 0) || has[(r % A) * V + v] ? 0u : 0x80u;
  };
  uint4* out = reinterpret_cast<uint4*>(nh);
  if (D % 16 == 0) {
    const size_t per = D / 16;
    for (size_t i = first; i < RV * per; i += stride) {
      const uint32_t x = fill(i / per) * 0x01010101u;
      out[i] = make_uint4(x, x, x, x);
    }
    return;
  }
  const size_t total = RV * D;
  for (size_t i = first; i < total / 16; i += stride) {
    size_t rv = i * 16 / D;
    int at = (int)(i * 16 - rv * D);  // the first byte's lane in its row
    uint32_t x = fill(rv);
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (at == D) {
          at = 0;
          x = fill(++rv);
        }
        packed |= x << (8 * k);
        ++at;
      }
      word[q] = packed;
    }
    out[i] = make_uint4(word[0], word[1], word[2], word[3]);
  }
  for (size_t i = total / 16 * 16 + first; i < total; i += stride)
    nh[i] = (int8_t)fill(i / D);
}

// Kernel 14 over rows = B * A pairs: block b walks pairs b, b + grid, ...
// with its state placed by `layout` (StateLayout; slice_ints: its slice
// of `scratch`): the frontier state, the row's failed links of this area
// [S] after it, and the lane lists.  A pair of root -1 keeps the fill.
__global__ void __launch_bounds__(1024) segment_frontier_kernel(
    const int32_t* __restrict__ out_off, const int2* __restrict__ out_edge,
    const int32_t* __restrict__ out_link, const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, const int32_t* __restrict__ fail_area,
    const int32_t* __restrict__ fail_link, float* __restrict__ dist_out,
    int8_t* nh, int32_t* scratch, size_t state_ints, size_t slice_ints,
    int layout, int rows, int A, int V, int D, int S, int cap, float big) {
  extern __shared__ int32_t shared_ints[];
  __shared__ int lanes_used;
  __shared__ int num_failed;
  int32_t* slice = scratch ? scratch + blockIdx.x * slice_ints : nullptr;
  int32_t* state = layout == kGlobalAll ? slice : shared_ints;
  const Frontier f(state, V, cap);
  int32_t* failed = state + frontier_state_ints(V, cap, blockDim.x);
  int32_t* lists = layout == kSharedAll         ? shared_ints + state_ints
                   : layout == kSharedFrontier ? slice
                                               : slice + state_ints;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int root = roots[r];
    if (root >= 0) {
      const int b = r / A;  // r = batch row * A + area
      const int a = r - b * A;
      if (threadIdx.x == 0) {
        int n = 0;
        for (int s = 0; s < S; ++s) {
          const int fl = fail_link[(size_t)b * S + s];
          if (fail_area[(size_t)b * S + s] == a && fl >= 0) failed[n++] = fl;
        }
        num_failed = n;
      }
      __syncthreads();
      // an edge is masked iff some member has this area, the edge's link
      // id and a link id >= 0: the slot's link id against the members
      const int nf = num_failed;
      frontier_pair(
          f, lists, lanes_used, root, out_off + (size_t)a * (V + 1), out_edge, nullptr,
          nf ? out_link : nullptr,
          [&](int link) {
            for (int k = 0; k < nf; ++k)
              if (link == failed[k]) return false;
            return true;
          },
          nullptr, overloaded + (size_t)a * V, dist_out + (size_t)r * V,
          nh + (size_t)r * V * D, V, D, big, true);
    }
    // the next pair rewrites the state this one's threads may still read
    __syncthreads();
  }
}

// Row b's edge bits (one per edge, bit e % 32 of word e / 32): its row of
// edge_enabled [B, E] bool packed 32 to a word, or, when that is null,
// every edge but those of its failed link ids fail_link [B, S] (-1 pads
// and ids past L mask nothing; link_off [L + 1] and link_edges list each
// link's edges), or every edge when both are null.  Ends with a barrier.
__device__ void row_edge_bits(uint32_t* bits, int b, int E,
                              const uint8_t* __restrict__ edge_enabled,
                              const int32_t* __restrict__ fail_link, int S,
                              const int32_t* __restrict__ link_off,
                              const int32_t* __restrict__ link_edges, int L) {
  const int words = (E + 31) / 32;
  if (edge_enabled) {
    const uint8_t* row = edge_enabled + (size_t)b * E;
    // whole 32-byte runs of a 16-byte-aligned row as two 16-byte loads
    const bool vec = ((uintptr_t)row & 15) == 0;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      uint32_t word = 0;
      if (vec && i * 32 + 32 <= E) {
        const uint4* at = reinterpret_cast<const uint4*>(row + i * 32);
        const uint4 lo = at[0], hi = at[1];
        const uint32_t q[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 32; ++j)
          word |= (uint32_t)(((q[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0) << j;
      } else {
        for (int j = 0, e = i * 32; j < 32 && e < E; ++j, ++e)
          word |= (uint32_t)(row[e] != 0) << j;
      }
      bits[i] = word;
    }
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) bits[i] = ~0u;
    if (fail_link) {
      __syncthreads();
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const int f = fail_link[(size_t)b * S + s];
        if (f < 0 || f >= L) continue;  // a -1 pad masks nothing
        for (int k = link_off[f]; k < link_off[f + 1]; ++k) {
          const int e = link_edges[k];
          atomicAnd(&bits[e >> 5], ~(1u << (e & 31)));
        }
      }
    }
  }
  __syncthreads();
}

// Kernel 15's per-block state, carved from `base` (dynamic shared memory,
// or the block's slice of a global scratch): the frontier's
// (frontier_state_ints) and the row's edge bits [ceil(E / 32)].
__host__ __device__ inline size_t masked_state_ints(int V, int E, int cap,
                                                    int T) {
  return frontier_state_ints(V, cap, T) + ((size_t)E + 31) / 32;
}

// Kernel 15 on row b: distances only, from roots[b] (-1: the row reads BIG
// throughout), by frontier relaxation over the out-edge CSR of the usable
// edges (out_off [live + 1], out_edge {dst, w}, out_id the edge's position
// in the edge list), a slot kept where the row's edge bit is set: from its
// row of edge_enabled [B, E], or from its failed link ids fail_link [B, S]
// (-1 pads) through the link CSR (link_off [L + 1], link_edges).  Only the
// first `live` vertices (every endpoint of a usable edge, every root) are
// solved; the rest of the row, a node bucket's padding, reads BIG.
__device__ __forceinline__ void masked_row(
    int32_t* state, int b, const int32_t* __restrict__ out_off,
    const int2* __restrict__ out_edge, const int32_t* __restrict__ out_id,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ roots,
    const uint8_t* __restrict__ edge_enabled,
    const int32_t* __restrict__ fail_link,
    const int32_t* __restrict__ link_off,
    const int32_t* __restrict__ link_edges, float* __restrict__ dist_out,
    int V, int live, int E, int S, int L, int cap, float big) {
  const Frontier f(state, live, cap);
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      state + frontier_state_ints(live, cap, blockDim.x));
  float* dist = dist_out + (size_t)b * V;
  const int root = roots[b];
  if (root < 0) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) dist[v] = big;
    return;
  }
  row_edge_bits(bits, b, E, edge_enabled, fail_link, S, link_off,
                link_edges, L);
  // the set form's bits were cleared by atomics: read them past the L1
  const volatile uint32_t* vbits = bits;
  frontier_distances(
      f, live, root, out_off, out_edge, out_id, overloaded,
      [&](int e) { return (vbits[e >> 5] >> (e & 31)) & 1u; }, big);
  const volatile float* vd = f.d;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    dist[v] = v < live ? vd[v] : big;
}

// Kernel 15 over B rows: one block per row with its state in dynamic shared
// memory (kGlobal false), or a fixed grid walking the rows with each
// block's state in its slice of `scratch` (state_ints each).
template <bool kGlobal>
__global__ void __launch_bounds__(1024) spf_distances_masked_kernel(
    const int32_t* __restrict__ out_off, const int2* __restrict__ out_edge,
    const int32_t* __restrict__ out_id,
    const uint8_t* __restrict__ overloaded, const int32_t* __restrict__ roots,
    const uint8_t* __restrict__ edge_enabled,
    const int32_t* __restrict__ fail_link,
    const int32_t* __restrict__ link_off,
    const int32_t* __restrict__ link_edges, float* __restrict__ dist_out,
    int32_t* scratch, size_t state_ints, int B, int V, int live, int E, int S,
    int L, int cap, float big) {
  if constexpr (!kGlobal) {
    extern __shared__ int32_t shared_ints[];
    masked_row(shared_ints, blockIdx.x, out_off, out_edge, out_id, overloaded,
               roots, edge_enabled, fail_link, link_off, link_edges, dist_out,
               V, live, E, S, L, cap, big);
  } else {
    int32_t* state = scratch + blockIdx.x * state_ints;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      masked_row(state, b, out_off, out_edge, out_id, overloaded, roots,
                 edge_enabled, fail_link, link_off, link_edges, dist_out, V,
                 live, E, S, L, cap, big);
      // the next row rewrites the state this one's threads may still read
      __syncthreads();
    }
  }
}

// Kernel 16 over B rows, after the layout and the fill: block g walks
// rows g, g + grid, ... with its state placed by `layout` (StateLayout;
// slice_ints: its slice of `scratch`): the frontier state, the row's edge
// bits [ceil(E / 32)] after it (row_edge_bits: from its mask row, or its
// failed link ids through the link CSR; none where neither is given), and
// the lane lists.  Row b solves from roots[b] over area b % A's out-edge
// CSR (A = 1: the shared list; A = B: row b's own), a slot kept where the
// row's bit of its edge (out_id) is set, with its own hard-drain row
// overloaded[b]; a root outside [0, V) keeps the fill (the reference's
// all-BIG row, -128 / 0 lanes).
__global__ void __launch_bounds__(1024) batched_frontier_kernel(
    const int32_t* __restrict__ out_off, const int2* __restrict__ out_edge,
    const int32_t* __restrict__ out_id, const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ roots, const uint8_t* __restrict__ edge_enabled,
    const int32_t* __restrict__ fail_link, const int32_t* __restrict__ link_off,
    const int32_t* __restrict__ link_edges, float* __restrict__ dist_out,
    int8_t* nh, int32_t* scratch, size_t state_ints, size_t slice_ints,
    int layout, int B, int A, int V, int E, int D, int S, int L, int cap,
    float big) {
  extern __shared__ int32_t shared_ints[];
  __shared__ int lanes_used;
  int32_t* slice = scratch ? scratch + blockIdx.x * slice_ints : nullptr;
  int32_t* state = layout == kGlobalAll ? slice : shared_ints;
  const Frontier f(state, V, cap);
  uint32_t* bits = reinterpret_cast<uint32_t*>(state + frontier_state_ints(V, cap, blockDim.x));
  int32_t* lists = layout == kSharedAll         ? shared_ints + state_ints
                   : layout == kSharedFrontier ? slice
                                               : slice + state_ints;
  const bool masked = edge_enabled || fail_link;
  // the set form's bits are cleared by atomics: read them past the L1
  const volatile uint32_t* vbits = bits;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int root = roots[b];
    if (root >= 0 && root < V) {
      const int a = b % A;
      if (masked)
        row_edge_bits(bits, b, E, edge_enabled, fail_link, S, link_off, link_edges, L);
      frontier_pair(
          f, lists, lanes_used, root, out_off + (size_t)a * (V + 1), out_edge, nullptr,
          masked ? out_id : nullptr,
          [&](int e) { return ((vbits[e >> 5] >> (e & 31)) & 1u) != 0; }, nullptr,
          overloaded + (size_t)b * V, dist_out + (size_t)b * V, nh + (size_t)b * V * D, V, D,
          big, true);
    }
    // the next row rewrites the state this one's threads may still read
    __syncthreads();
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The derived layout of kernels 14 and 16 in `work` (int32 words; ops/spf.py
// segment_work_ints): the slots' {dst, bits of w} [A E] (int2) and ids
// [A E], the out-edge offsets [A (V + 1)] and the has bytes [A V].
struct SegmentLayout {
  int2* out_edge;
  int32_t* out_id;
  int32_t* out_off;
  uint8_t* has;

  SegmentLayout(void* work, int A, int V, int E) {
    const size_t AE = (size_t)A * E;
    int32_t* ints = (int32_t*)work;
    out_edge = (int2*)ints;
    out_id = ints + 2 * AE;
    out_off = ints + 3 * AE;
    has = (uint8_t*)(out_off + (size_t)A * (V + 1));
  }

  // Build it on `stream` (fill_grid blocks over the card, then one block
  // per area to trim V - 1's run); the slot ids are written where `ids`
  // (link ids where link_index is given, else edge positions).
  cudaError_t build(const void* src_sorted, const void* order, const void* dst,
                    const void* w, const void* edge_ok, const void* link_index,
                    bool ids, int fill_grid, int A, int V, int E,
                    void* stream) const {
    segment_layout_kernel<<<fill_grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src_sorted, (const int64_t*)order, (const int32_t*)dst,
        (const float*)w, (const uint8_t*)edge_ok, (const int32_t*)link_index,
        out_edge, ids ? out_id : nullptr, out_off, has, A, V, E);
    segment_trim_kernel<<<A, 1024, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src_sorted, (const int64_t*)order, (const uint8_t*)edge_ok,
        out_off, V, E);
    return cudaGetLastError();
  }
};

}  // namespace

// records: A E int2 (a block's runs at its range of its area's edges);
// heads: null, or (the global layout) A cluster warm_dist_head_ints(S)
// int32 words, where the distances are relaxed in `dist` itself.
extern "C" int openr_warm_spf_distances(const void* src, const void* dst, const void* w,
                                        const void* edge_ok, const void* overloaded,
                                        const void* roots, const void* d0, void* dist,
                                        void* rounds, void* records, void* heads, int A,
                                        int V, int E, int cluster, int cap_shared, float big,
                                        void* stream) {
  if (A == 0) return (int)cudaSuccess;
  if (cluster < 1 || cluster > kWarmMaxCluster || (cluster & (cluster - 1)) ||
      cap_shared < 0 || (heads && cap_shared))
    return (int)cudaErrorInvalidValue;
  const int S = (V + cluster - 1) / cluster;
  const bool global = heads != nullptr;
  // the distances, the slice's heads and the shared records must fit
  const size_t smem = global ? 0 : warm_dist_fixed_ints(V, S) * 4 + (size_t)cap_shared * 8;
  if (smem > kWarmDynamicSmem) return (int)cudaErrorInvalidValue;
  const auto kernel =
      cluster > 1 ? (global ? warm_spf_distances_kernel<true, true>
                            : warm_spf_distances_kernel<true, false>)
                  : (global ? warm_spf_distances_kernel<false, true>
                            : warm_spf_distances_kernel<false, false>);
  cudaError_t err = allow_smem(kernel, smem);
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
  err = cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)src, (const int32_t*)dst,
                           (const float*)w, (const uint8_t*)edge_ok,
                           (const uint8_t*)overloaded, (const int32_t*)roots,
                           (const float*)d0, (float*)dist, (int32_t*)rounds, (int2*)records,
                           (int32_t*)heads, V, E, cluster, S, cap_shared, big);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// scratch: A cluster slice_ints int32 words where `layout` (StateLayout)
// puts the lane lists or the whole state in the blocks' slices of it.
extern "C" int openr_spf_nexthop_lanes_reset(
    const void* src, const void* dst, const void* w, const void* edge_ok,
    const void* overloaded, const void* roots, const void* dist,
    const void* seg_off, const void* root_rank, void* nh, void* rounds,
    void* scratch, int layout, int A, int V, int E, int D, int cluster,
    float big, void* stream) {
  if (A == 0) return (int)cudaSuccess;
  int cshift = 0;
  while ((1 << cshift) < cluster) ++cshift;
  if ((1 << cshift) != cluster || cluster > kResetMaxCluster)
    return (int)cudaErrorInvalidValue;
  // the state and the lane lists, each rounded up to whole 16-byte words
  const size_t state_ints = (reset_lanes_state_ints(V, D) + 3) / 4 * 4;
  const size_t lists_ints = (lane_lists_ints(V, E) + 3) / 4 * 4;
  const size_t shared_ints = layout == kSharedAll        ? state_ints + lists_ints
                             : layout == kSharedFrontier ? state_ints
                                                         : 0;
  const size_t slice_ints = state_ints + lists_ints - shared_ints;
  cudaError_t err = allow_smem(spf_nexthop_lanes_reset_kernel, shared_ints * 4);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(A * cluster));
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = shared_ints * 4;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, spf_nexthop_lanes_reset_kernel, (const int32_t*)src, (const int32_t*)dst,
      (const float*)w, (const uint8_t*)edge_ok, (const uint8_t*)overloaded,
      (const int32_t*)roots, (const float*)dist, (const int32_t*)seg_off,
      (const int32_t*)root_rank, (int8_t*)nh, (int32_t*)rounds, (int32_t*)scratch,
      state_ints, slice_ints, layout, V, E, D, cshift, big);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int openr_warm_subgraph_repair(
    const void* src_sub, const void* dst_sub, const void* w_sub,
    const void* ok_sub, const void* rank_sub, const void* prev_dist,
    const void* prev_nh, const void* reset, void* scratch, void* temp, void* dist, void* nh,
    void* rounds_d, void* rounds_l, int A, int V, int Es, int D, float big, void* stream) {
  if (A == 0 || V == 0) return (int)cudaSuccess;
  const int W = (D + 31) / 32;
  // the grant: a list of every vertex and the map, up to kRepairSmemMax;
  // the solving blocks need the scratch where a whole area's list may not
  // fit it (ops/spf.py sub_repair_scratch_ints)
  const size_t need = 4 * sub_repair_state_ints(V, Es, W);
  const size_t want = need + 4 * (size_t)V;
  const int smem = (int)(want < (size_t)kRepairSmemMax ? want : (size_t)kRepairSmemMax);
  if (D < 1 || (Es > 0 && temp == nullptr) || (need > (size_t)smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<warm_subgraph_repair_kernel>((size_t)smem);
  if (err != cudaSuccess) return (int)err;
  // copy blocks: one per kRepairCopyWords 16-byte words of both tables
  const size_t words = ((size_t)A * V * (4 + (size_t)D) + 15) / 16;
  const size_t copiers = (words + kRepairCopyWords - 1) / kRepairCopyWords;
  const unsigned grid = (unsigned)A + (unsigned)(copiers < 132 ? copiers : 132);
  warm_subgraph_repair_kernel<<<grid, kRepairThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int32_t*)src_sub, (const int32_t*)dst_sub, (const float*)w_sub,
      (const uint8_t*)ok_sub, (const int32_t*)rank_sub, (const float*)prev_dist,
      (const int8_t*)prev_nh, (const uint8_t*)reset, (int32_t*)scratch, (int32_t*)temp,
      (float*)dist, (int8_t*)nh, (int32_t*)rounds_d, (int32_t*)rounds_l, A, V, Es, D, smem, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_spf_segment_batch_rounds(
    const void* src, const void* dst, const void* w, const void* edge_ok,
    const void* overloaded, const void* link_index, const void* roots,
    const void* fail_area, const void* fail_link, const void* seg_off,
    void* dist, void* nh, int B, int A, int V, int E, int D, int S,
    float big, void* stream) {
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const size_t state = segment_rounds_state_bytes(V, E, S);
  cudaError_t err = allow_smem(spf_segment_batch_kernel, state);
  if (err != cudaSuccess) return (int)err;
  spf_segment_batch_kernel<<<B * A, kBatchThreads, state,
                             (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w,
      (const uint8_t*)edge_ok, (const uint8_t*)overloaded,
      (const int32_t*)link_index, (const int32_t*)roots,
      (const int32_t*)fail_area, (const int32_t*)fail_link,
      (const int32_t*)seg_off, (float*)dist, (int8_t*)nh, A, V, E, D, S,
      big);
  return (int)cudaGetLastError();
}

extern "C" int openr_spf_segment_batch(
    const void* src_sorted, const void* order, const void* dst, const void* w,
    const void* edge_ok, const void* link_index, const void* overloaded,
    const void* roots, const void* fail_area, const void* fail_link,
    void* work, void* dist, void* nh, void* scratch, int layout, int grid,
    int fill_grid, int threads, int B, int A, int V, int E, int D, int S,
    int cap, float big, void* stream) {
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const int rows = B * A;
  const SegmentLayout lay(work, A, V, E);
  cudaError_t err = lay.build(src_sorted, order, dst, w, edge_ok, link_index,
                              link_index != nullptr, fill_grid, A, V, E, stream);
  if (err != cudaSuccess) return (int)err;
  // the frontier state with the failed links, and the lane lists, each
  // rounded up to whole 16-byte words
  const size_t state_ints = (frontier_state_ints(V, cap, threads) + S + 3) / 4 * 4;
  const size_t lists_ints = (lane_lists_ints(V, E) + 3) / 4 * 4;
  const size_t shared_ints = layout == kSharedAll        ? state_ints + lists_ints
                             : layout == kSharedFrontier ? state_ints
                                                         : 0;
  const size_t slice_ints = state_ints + lists_ints - shared_ints;
  const size_t smem = shared_ints * 4;
  segment_fill_kernel<<<fill_grid, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)roots, lay.has, (float*)dist, (int8_t*)nh, rows, A, V, D,
      big);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(segment_frontier_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  segment_frontier_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      lay.out_off, lay.out_edge, link_index ? lay.out_id : nullptr, (const uint8_t*)overloaded,
      (const int32_t*)roots, (const int32_t*)fail_area, (const int32_t*)fail_link, (float*)dist,
      (int8_t*)nh, (int32_t*)scratch, state_ints, slice_ints, layout, rows, A,
      V, D, S, cap, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_spf_distances_masked(
    const void* out_off, const void* out_edge, const void* out_id,
    const void* overloaded, const void* roots, const void* edge_enabled,
    const void* fail_link, const void* link_off, const void* link_edges,
    void* dist, void* scratch, int grid, int threads, int B, int V, int live,
    int E, int S, int L, int cap, float big, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const size_t state = masked_state_ints(live, E, cap, threads) * 4;
  if (scratch) {
    // the global-state path: each block's state in its slice of scratch
    // (grid slices, each rounded up to whole 16-byte words)
    const size_t state_ints = (state + 15) / 16 * 4;
    spf_distances_masked_kernel<true>
        <<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)out_off, (const int2*)out_edge,
            (const int32_t*)out_id, (const uint8_t*)overloaded,
            (const int32_t*)roots, (const uint8_t*)edge_enabled,
            (const int32_t*)fail_link, (const int32_t*)link_off,
            (const int32_t*)link_edges, (float*)dist, (int32_t*)scratch,
            state_ints, B, V, live, E, S, L, cap, big);
    return (int)cudaGetLastError();
  }
  cudaError_t err = allow_smem(spf_distances_masked_kernel<false>, state);
  if (err != cudaSuccess) return (int)err;
  spf_distances_masked_kernel<false>
      <<<B, threads, state, (cudaStream_t)stream>>>(
          (const int32_t*)out_off, (const int2*)out_edge,
          (const int32_t*)out_id, (const uint8_t*)overloaded,
          (const int32_t*)roots, (const uint8_t*)edge_enabled,
          (const int32_t*)fail_link, (const int32_t*)link_off,
          (const int32_t*)link_edges, (float*)dist, nullptr, 0, B, V, live, E,
          S, L, cap, big);
  return (int)cudaGetLastError();
}

extern "C" int openr_batched_spf(
    const void* src_sorted, const void* order, const void* dst, const void* w,
    const void* edge_ok, const void* overloaded, const void* roots,
    const void* edge_enabled, const void* fail_link, const void* link_off,
    const void* link_edges, void* work, void* dist, void* nh, void* scratch,
    int layout, int grid, int fill_grid, int threads, int B, int A, int V,
    int E, int D, int S, int L, int cap, float big, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const bool masked = edge_enabled || fail_link;
  const SegmentLayout lay(work, A, V, E);
  cudaError_t err = lay.build(src_sorted, order, dst, w, edge_ok, nullptr, masked,
                              fill_grid, A, V, E, stream);
  if (err != cudaSuccess) return (int)err;
  // the frontier state with the row's edge bits, and the lane lists, each
  // rounded up to whole 16-byte words
  const size_t state_ints = (frontier_state_ints(V, cap, threads) + ((size_t)E + 31) / 32 + 3) / 4 * 4;
  const size_t lists_ints = (lane_lists_ints(V, E) + 3) / 4 * 4;
  const size_t shared_ints = layout == kSharedAll        ? state_ints + lists_ints
                             : layout == kSharedFrontier ? state_ints
                                                         : 0;
  const size_t slice_ints = state_ints + lists_ints - shared_ints;
  const size_t smem = shared_ints * 4;
  segment_fill_kernel<<<fill_grid, 256, 0, (cudaStream_t)stream>>>(
      nullptr, lay.has, (float*)dist, (int8_t*)nh, B, A, V, D, big);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(batched_frontier_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  batched_frontier_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      lay.out_off, lay.out_edge, lay.out_id, (const uint8_t*)overloaded,
      (const int32_t*)roots, (const uint8_t*)edge_enabled, (const int32_t*)fail_link,
      (const int32_t*)link_off, (const int32_t*)link_edges, (float*)dist, (int8_t*)nh,
      (int32_t*)scratch, state_ints, slice_ints, layout, B, A, V, E, D, S, L, cap, big);
  return (int)cudaGetLastError();
}
