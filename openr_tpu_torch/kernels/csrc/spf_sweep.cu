// Cold batch-minor link-failure sweep for Hopper (sm_90a): kernel 8.
//
// Replaces the jitted XLA kernel of the JAX package
//   openr_tpu/ops/spf.py:878 sweep_spf_link_failures
// with its parts :678 spf_distances_sweep and :716 spf_lanes_sweep (the
// int8 lane form; the reference's 5-bit packed channels, :801, are a TPU
// byte layout the port does not keep).  One topology as a dst-sorted
// edge list (vertex v's in-edges are the run [off[v], off[v+1]); padding
// edges carry edge_ok = false), B snapshots, snapshot b failing the
// undirected link failed[b] (-1: none):
//   dist [V, B] f32: masked Bellman-Ford from the root (BIG unreached);
//     an edge relaxes iff edge_ok, its link is not the failed one and its
//     src may transit (not overloaded, or the root)
//   nh [V, B, D] int8: first-hop lanes.  A shortest-path-DAG edge out of
//     the root (lane_rank >= 0) seeds its lane at its head; every other
//     DAG edge ORs its src's lanes into its head; lanes only ever rise
//     (OR-accumulate).  A vertex with an EMPTY run keeps int8 -128, the
//     reference's segment_max identity; every other vertex starts at 0.
//
// Design.  Two kernels from one entry point.
//
// The layout kernel (one block) gathers the usable edges once per launch:
// edge_ok and the transit rule (its src not overloaded, or the root), the
// part of `relaxes` that no snapshot changes.  Each usable edge becomes a
// record {src, bits of w, link id, lane rank (-1 unless its src is the
// root)} in a global list grouped by the vertex it enters, the vertices
// in (owner block, local index) order, with each vertex's first record
// (per-vertex counts by shared-memory atomics, a block scan over the
// vertices, then each edge placed at its vertex's cursor), and the lanes
// the seeds can reach (1 + the highest usable rank below D).
//
// The sweep kernel runs each 32-snapshot word on a thread block cluster
// of C blocks (C = 1, 2, 4 or 8; ops/spf.py sweep_cluster_size: 8 where V
// allows).  Vertex v belongs to block v % C of the word's cluster, as its
// local vertex v / C; a warp works one owned vertex at a time, a warp lane
// being a snapshot.  A vertex's state is its 32 distance columns and its
// D lane WORDS, one uint32 per lane whose bit b is snapshot b of the
// word.  Where it fits (SweepState), every block holds a copy of every
// vertex's state in shared memory, so a round reads only local shared
// memory and an owner stores each change into every copy (distributed
// shared memory; nothing waits on those stores); else each block holds
// its owned vertices' state, in shared memory (read by the others as
// distributed shared memory) or in its slice of a global scratch.  A
// block copies its records into shared memory where they fit, else reads
// them in place (L2-resident, shared by every word); the rounds address a
// block's own copy and records from its shared array, so the compiler
// emits shared-memory loads rather than generic ones.
//   * distance rounds: each record's source column (32 snapshots in one
//     load), relaxing in a snapshot where the record's link id differs
//     from the snapshot's failed link, a register compare: the only
//     per-snapshot test left in the rounds.
//   * membership: once the distances stand, __ballot_sync turns the 32
//     lanes' DAG-membership flags (d[src] + w == d[v] < BIG, link not
//     failed) into each record's membership word; where the block holds
//     its records, each vertex's records on the DAG in some snapshot are
//     packed in place, once, as {src, membership word, rank}; else the
//     lane rounds recompute the words.
//   * lane rounds: a thread is a lane word of the warp's vertex (32 at a
//     time, over the lanes the seeds reach); a root record ORs its
//     membership word into the lane of its rank (the seed), any other ORs
//     its source's lane word masked by the membership word: one OR covers
//     32 snapshots.
// Rounds are in place; each ends on kernel 1's cluster vote (a block that
// changed something sets the vote's slot in every block, read past one
// cluster.sync(), which also makes every remote store visible).  More
// rounds between votes were slower on the H100 (PERF.md).  The int8
// [V, B, D] table is written once at the end, each warp storing its
// vertex's 32 D contiguous bytes (-128 where the run is empty), the
// distances as one 128-byte line.
//
// Why this is exact.  Distances: the relaxation converges to min over
// paths whatever the update order, and integral link metrics keep every
// f32 sum exact; a round in which no block changed anything read one
// constant state, every copy equal to its owner's values, so all blocks
// stop together and only then.  Lanes: the reference's cold lanes
// OR-accumulate from the seeds, so its fixed point is the least one above
// them, which monotone in-place ORs reach in any order; a propagating
// source is reached and not the root, so it has a usable in-edge and its
// lanes are 0 or 1, never -128, and the int8 max is an OR of bits.  Round
// counts are per word and differ from the reference's synchronous ones;
// they are telemetry.
//
// What bounds it: latency and instructions.  The distance rounds run for
// the word's deepest shortest path and the lane rounds for its DAG depth
// (about 10 each on the headline WAN); a round costs a warp a few
// instructions per record of its vertices (its 32 snapshots at once) and
// the cluster vote.  A launch of many words takes as many waves of
// clusters as the card holds.  Its byte bound is 40-700x below it
// (PERF.md).
//
// Traps: BIG = 3.4e38 and BIG + w rounds to BIG; never built with
// --use_fast_math.  State that other blocks write is read through volatile
// pointers and is never __restrict__.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kLayoutThreads = 1024;
constexpr int kMaxCluster = 8;

// int32 words of the layout's head: each owned vertex's first record by
// (owner, local vertex) [C S + 1] and the lanes the seeds can reach [1],
// rounded up to 16 bytes; the records [E] (int4) follow.
__host__ __device__ inline size_t layout_head_ints(int C, int S) {
  return ((size_t)C * S + 2 + 3) / 4 * 4;
}

// a block's fixed shared head: its vertices' record offsets [S + 1] and
// their DAG records' counts [S]
__host__ __device__ inline size_t head_ints(int S) { return (2 * (size_t)S + 1 + 3) / 4 * 4; }

// one vertex: 32 distance columns then D lane words
__host__ __device__ inline size_t vertex_ints(int D) { return 32 + (size_t)D; }

// n vertices' state, rounded up to 16 bytes
__host__ __device__ inline size_t state_ints(int n, int D) {
  return ((size_t)n * vertex_ints(D) + 3) / 4 * 4;
}

// Where a block's vertex state lives: its owned vertices' in the block's
// slice of a global scratch, or in its shared memory (read by the other
// blocks there), or a copy of EVERY vertex's state in each block's shared
// memory (an owner's changes stored into every copy).
enum SweepState { kOwnedGlobal = 0, kOwnedShared = 1, kCopies = 2 };

__global__ void __launch_bounds__(kLayoutThreads) sweep_layout_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ edge_ok,
    const int32_t* __restrict__ link_index,
    const uint8_t* __restrict__ overloaded,
    const int32_t* __restrict__ lane_rank, int32_t* layout, int V, int E, int D,
    int root, int cshift, int S) {
  extern __shared__ int32_t cnt[];  // [V] usable in-edges, then packing cursors
  __shared__ int32_t counts[kLayoutThreads + 1];
  __shared__ int lanes_used;
  const int C = 1 << cshift;
  const int keys = C * S;
  int32_t* rec_off = layout;  // [C S + 2]
  int4* recs = reinterpret_cast<int4*>(layout + layout_head_ints(C, S));
  for (int v = threadIdx.x; v < V; v += blockDim.x) cnt[v] = 0;
  if (threadIdx.x == 0) lanes_used = 0;
  __syncthreads();
  const auto usable = [&](int e) {
    if (!edge_ok[e]) return false;
    const int s = src[e];
    return !overloaded[s] || s == root;
  };
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    if (!usable(e)) continue;
    atomicAdd(cnt + dst[e], 1);
    const int r = src[e] == root ? lane_rank[e] : -1;
    if (r >= 0 && r < D) atomicMax(&lanes_used, r + 1);
  }
  __syncthreads();
  // vertex v = j C + r at key r S + j: its first record, then its cursor
  const int n = block_offsets(
      counts, keys,
      [&](int k) {
        const int v = ((k % S) << cshift) + k / S;
        return v < V ? cnt[v] : 0;
      },
      [&](int k, int o) {
        rec_off[k] = o;
        const int v = ((k % S) << cshift) + k / S;
        if (v < V) cnt[v] = o;
      });
  if (threadIdx.x == 0) {
    rec_off[keys] = n;
    rec_off[keys + 1] = lanes_used;
  }
  // a vertex's records in any order: min and OR take them so
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    if (!usable(e)) continue;
    const int s = src[e];
    recs[atomicAdd(cnt + dst[e], 1)] =
        make_int4(s, __float_as_int(w[e]), link_index[e], s == root ? lane_rank[e] : -1);
  }
}

template <bool kCopy>
__global__ void __launch_bounds__(kThreads) sweep_words_kernel(
    const int32_t* __restrict__ layout, const int32_t* __restrict__ failed_link,
    const int32_t* __restrict__ seg_off, int32_t* scratch, float* __restrict__ dist,
    int8_t* __restrict__ nh, int32_t* __restrict__ rounds_d,
    int32_t* __restrict__ rounds_l, int V, int E, int B, int D, int S, int root,
    int cshift, int mode, int cap_rec, float big) {
  extern __shared__ int4 smem4[];
  __shared__ int votes[2];
  __shared__ int32_t* bases[kMaxCluster];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = 1 << cshift;
  const int rank = (int)cluster.block_rank();
  const int word = (int)(blockIdx.x >> cshift);
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = T >> 5;
  const int col = word * 32 + lane;
  const bool live = col < B;
  // a lane past B mirrors the word's first snapshot (never written out)
  const int failed = failed_link[live ? col : word * 32];
  const int VS = (int)vertex_ints(D);
  const int32_t* rec_off = layout;
  const int own_n = (V - rank + C - 1) >> cshift;
  const int k0 = rank * S;
  const int rec0 = rec_off[k0];
  const int n_rec = rec_off[k0 + own_n] - rec0;
  const int L = rec_off[C * S + 1];
  int32_t* roff = smem;                  // [S + 1]
  int32_t* pcnt = roff + S + 1;          // [S]
  int32_t* state = smem + head_ints(S);  // where shared: S (or, copied, V) vertices
  const size_t held = mode == kOwnedGlobal ? 0 : state_ints(kCopy ? V : S, D);
  int4* rec_sh = reinterpret_cast<int4*>(state + held);
  const int4* recs = reinterpret_cast<const int4*>(layout + layout_head_ints(C, S)) + rec0;
  const bool rec_in_shared = n_rec <= cap_rec;

  for (int j = threadIdx.x; j <= own_n; j += T) roff[j] = rec_off[k0 + j] - rec0;
  if (rec_in_shared)
    for (int i = threadIdx.x; i < n_rec; i += T) rec_sh[i] = recs[i];
  if (threadIdx.x < C) {
    const int r = threadIdx.x;
    bases[r] = mode == kOwnedGlobal ? scratch + ((size_t)word * C + r) * state_ints(S, D)
               : r == rank          ? state
                                    : cluster.map_shared_rank(state, r);
  }
  if (threadIdx.x < 2) votes[threadIdx.x] = 0;
  __syncthreads();
  volatile float* own = reinterpret_cast<volatile float*>(bases[rank]);
  // vertex s's state: in the block's own copy (addressed from the shared
  // array itself, so the compiler emits shared-memory loads, not generic
  // ones: a third of a distance round on the H100), else at its owner
  const auto column = [&](int s) -> const volatile float* {
    if (kCopy) return reinterpret_cast<volatile float*>(state) + (size_t)s * VS;
    return reinterpret_cast<const volatile float*>(bases[s & (C - 1)]) + (size_t)(s >> cshift) * VS;
  };
  // an owned vertex's state at offset `at` (a distance column or lane
  // word) set to x: in every copy, else at its owner
  const auto store = [&](int v, int jl, int at, int32_t x) {
    if (kCopy) {
      for (int r = 0; r < C; ++r)
        reinterpret_cast<volatile int32_t*>(bases[r])[(size_t)v * VS + at] = x;
    } else {
      reinterpret_cast<volatile int32_t*>(own)[(size_t)jl * VS + at] = x;
    }
  };
  // the state this block initialises: its copy of every vertex, else its
  // owned vertices
  const int init_n = kCopy ? V : own_n;
  for (int i = warp; i < init_n; i += nwarps) {
    volatile float* st = own + (size_t)i * VS;
    const int v = kCopy ? i : (i << cshift) | rank;
    st[lane] = v == root ? 0.f : big;
    for (int l = lane; l < D; l += 32) reinterpret_cast<volatile uint32_t*>(st + 32)[l] = 0u;
  }

  // a vote (kernel 1's): a block that changed something sets the vote's
  // slot (by parity) in every block; past the cluster barrier, which also
  // makes every remote store before it visible, each block reads its own.
  // The other slot, the next vote's, was last read before this barrier
  // and is next written past it, so it is cleared here
  int vote = 0;
  const auto cluster_any = [&](int changed) {
    const int mine = __syncthreads_or(changed);
    if (threadIdx.x == 0) votes[(vote + 1) & 1] = 0;
    if (mine && (int)threadIdx.x < C)
      *reinterpret_cast<volatile int*>(cluster.map_shared_rank(&votes[vote & 1], (int)threadIdx.x)) = 1;
    cluster.sync();
    const int any = *reinterpret_cast<volatile int*>(&votes[vote & 1]);
    ++vote;
    return any;
  };
  // no block stores into another before that one has set its state
  cluster.sync();

  // 1. distances over the owned vertices' records, in place, until no
  // block changes in a round (kBatch records' loads issued before any is
  // used).  The rounds are instantiated once for records in shared
  // memory and once for records read in place, each with its own address
  // space.
  const auto distance_rounds = [&](const int4* rec) {
    int rounds = 0;
    for (int round = 0; round < V; ++round) {
      int changed = 0;
      for (int jl = warp; jl < own_n; jl += nwarps) {
        const int v = (jl << cshift) | rank;
        const float cur = column(v)[lane];
        float best = cur;
        const int r1 = roff[jl + 1];
        for (int c0 = roff[jl]; c0 < r1; c0 += kBatch) {
          int4 q[kBatch];
          float x[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) q[k] = rec[c0 + k < r1 ? c0 + k : c0];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) x[k] = column(q[k].x)[lane];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (c0 + k < r1 && q[k].z != failed) best = fminf(best, x[k] + __int_as_float(q[k].y));
        }
        if (best < cur) {
          store(v, jl, lane, __float_as_int(best));
          changed = 1;
        }
      }
      ++rounds;
      if (!cluster_any(changed)) break;
    }
    return rounds;
  };
  const int rd = rec_in_shared ? distance_rounds(rec_sh) : distance_rounds(recs);

  // each record's membership word, by a ballot over its snapshots (bit b:
  // the edge is on snapshot b's shortest-path DAG); where the block holds
  // its records, the DAG records of each vertex are packed in place, once,
  // as {src, membership, rank}; else the lane rounds recompute them
  const auto members = [&](int jl, int c0, int r1, const int4 (&q)[kBatch],
                           uint32_t (&m)[kBatch]) {
    const float dv = column((jl << cshift) | rank)[lane];
    float x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = column(q[k].x)[lane];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      m[k] = __ballot_sync(kFull, c0 + k < r1 && q[k].z != failed && dv < big &&
                                      x[k] + __int_as_float(q[k].y) == dv);
  };
  if (rec_in_shared) {
    for (int jl = warp; jl < own_n; jl += nwarps) {
      int n = 0;
      const int r0 = roff[jl];
      const int r1 = roff[jl + 1];
      for (int c0 = r0; c0 < r1; c0 += kBatch) {
        int4 q[kBatch];
        uint32_t m[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) q[k] = rec_sh[c0 + k < r1 ? c0 + k : c0];
        members(jl, c0, r1, q, m);
        __syncwarp();  // the batch read before the packed writes
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (m[k]) {
            if (lane == 0) rec_sh[r0 + n] = make_int4(q[k].x, (int)m[k], q[k].w, 0);
            ++n;
          }
      }
      if (lane == 0) pcnt[jl] = n;
    }
    __syncthreads();
  }

  // 2. lanes: OR rounds over the lane words, in place, as the distances.
  // A thread is a lane word (32 at a time) of the warp's vertex: a root
  // record ORs its membership word into the lane of its rank, any other
  // its source's lane word masked by its membership word
  const auto lane_rounds = [&](const int4* rec) {
    int rounds = 0;
    for (int round = 0; round < V; ++round) {
      int changed = 0;
      for (int jl = warp; jl < own_n; jl += nwarps) {
        const int v = (jl << cshift) | rank;
        const int r0 = roff[jl];
        const int r1 = rec_in_shared ? r0 + pcnt[jl] : roff[jl + 1];
        if (r0 == r1) continue;
        const volatile uint32_t* mw = reinterpret_cast<const volatile uint32_t*>(column(v) + 32);
        for (int l0 = 0; l0 < L; l0 += 32) {
          const int l = l0 + lane;
          const uint32_t cur = l < L ? mw[l] : 0u;
          uint32_t acc = cur;
          for (int c0 = r0; c0 < r1; c0 += kBatch) {
            int4 q[kBatch];
            uint32_t m[kBatch], y[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) q[k] = rec[c0 + k < r1 ? c0 + k : c0];
            if (rec_in_shared) {
              // packed: {src, membership, rank}
#pragma unroll
              for (int k = 0; k < kBatch; ++k) {
                m[k] = c0 + k < r1 ? (uint32_t)q[k].y : 0u;
                q[k].w = q[k].z;
              }
            } else {
              members(jl, c0, r1, q, m);
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              y[k] = m[k] && q[k].x != root && l < L
                         ? reinterpret_cast<const volatile uint32_t*>(column(q[k].x) + 32)[l]
                         : 0u;
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              acc |= q[k].x == root ? (q[k].w == l ? m[k] : 0u) : y[k] & m[k];
          }
          if (l < L && acc != cur) {
            store(v, jl, 32 + l, (int32_t)acc);
            changed = 1;
          }
        }
      }
      ++rounds;
      if (!cluster_any(changed)) break;
    }
    return rounds;
  };
  const int rl = rec_in_shared ? lane_rounds(rec_sh) : lane_rounds(recs);

  // 3. the outputs: a warp a vertex, its distance line and its 32 D lane
  // bytes (the word's live snapshots), -128 where its run is empty; byte i
  // is snapshot i / D, lane i % D, stepped by 32 bytes a store
  const int nb = B - word * 32 < 32 ? B - word * 32 : 32;
  const int step_b = 32 / D, step_l = 32 % D;
  for (int jl = warp; jl < own_n; jl += nwarps) {
    const int v = (jl << cshift) | rank;
    const volatile float* mine = column(v);
    if (live) dist[(size_t)v * B + col] = mine[lane];
    const volatile uint32_t* mw = reinterpret_cast<const volatile uint32_t*>(mine + 32);
    const bool empty = seg_off[v] == seg_off[v + 1];
    int8_t* out = nh + ((size_t)v * B + (size_t)word * 32) * D;
    const int n = nb * D;
    int b = lane / D, l = lane % D;
    for (int i = lane; i < n; i += 32) {
      out[i] = empty ? (int8_t)-128 : (int8_t)(l < L ? (mw[l] >> b) & 1u : 0u);
      b += step_b;
      l += step_l;
      if (l >= D) {
        l -= D;
        ++b;
      }
    }
  }
  if (threadIdx.x == 0 && rank == 0) {
    rounds_d[word] = rd;
    rounds_l[word] = rl;
  }
  // no block leaves while another may still store into or read its
  // shared memory
  cluster.sync();
}

}  // namespace

// layout: layout_head_ints(C, ceil(V / C)) + 4 E int32 words; scratch:
// (mode kOwnedGlobal) ceil(B / 32) C state_ints(ceil(V / C), D) words.
// cap_rec: the records a block's shared memory holds beside its head and
// its state; a block with more reads them in place.
extern "C" int openr_sweep_spf_link_failures(
    const void* src, const void* dst, const void* w, const void* edge_ok,
    const void* link_index, const void* failed_link, const void* overloaded,
    const void* lane_rank, const void* seg_off, void* layout, void* scratch,
    void* dist, void* nh, void* rounds_d, void* rounds_l, int V, int E, int B,
    int D, int root, int cluster, int mode, int cap_rec, float big, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  int cshift = 0;
  while ((1 << cshift) < cluster) ++cshift;
  if ((1 << cshift) != cluster || cluster > kMaxCluster || cap_rec < 0 || mode < kOwnedGlobal ||
      mode > kCopies)
    return (int)cudaErrorInvalidValue;
  const int S = (V + cluster - 1) / cluster;
  const size_t held = mode == kOwnedGlobal ? 0 : state_ints(mode == kCopies ? V : S, D);
  const size_t smem = (head_ints(S) + held) * 4 + (size_t)cap_rec * 16;
  // the block's static shared bytes (votes, bases) come beside it
  if (smem > 232448 - 256) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_layout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(V * 4));
  if (err != cudaSuccess) return (int)err;
  sweep_layout_kernel<<<1, kLayoutThreads, V * 4, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w, (const uint8_t*)edge_ok,
      (const int32_t*)link_index, (const uint8_t*)overloaded, (const int32_t*)lane_rank,
      (int32_t*)layout, V, E, D, root, cshift, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto kernel = mode == kCopies ? &sweep_words_kernel<true> : &sweep_words_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + 31) / 32 * cluster));
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)layout, (const int32_t*)failed_link,
                           (const int32_t*)seg_off, (int32_t*)scratch, (float*)dist, (int8_t*)nh,
                           (int32_t*)rounds_d, (int32_t*)rounds_l, V, E, B, D, S, root, cshift,
                           mode, cap_rec, big);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
