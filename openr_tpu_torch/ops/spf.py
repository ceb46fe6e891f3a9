"""SPF tables: masked Bellman-Ford distances and all-shortest-path
first-hop lane sets over the dense in-edge matrix — the counterpart of
``openr_tpu/ops/spf.py``'s ``dense_spf_distances`` /
``dense_spf_nexthop_lanes`` / ``dense_spf_one`` — and, in the sections
below, the warm-start tables, the segment-form cold tables
(``spf_distances`` / ``spf_nexthop_lanes`` / ``spf_one``), their batches
over vantage roots and failure sets, the KSP2 masked re-solve
(``batched_spf_distances_masked``), the what-if sweep and the
per-snapshot what-if batches (``batched_spf`` and its forms).

Every function takes a leading area axis (the reference vmaps its
single-area kernels over areas): ``in_src/in_w/in_ok/in_rank [A, V, K]``,
``in_has/overloaded [A, V]``, ``roots [A]``.

Reference-parity rules:
  * node hard-drain: an overloaded node receives traffic but never relaxes
    its out-edges, except when it is the SPF root (LinkState.cpp:739-752)
  * down links and padding slots are excluded via ``in_ok`` (their ``in_w``
    is +inf)
  * lane r is the r-th out-edge of the root (``in_rank``); lane sets
    propagate along shortest-path-DAG edges, seeded at the root's direct
    successors; vertices absent from the padded edge list keep int8 -128

Each function dispatches on the device of its inputs: a CUDA tensor goes
to the hand-written kernel (``kernels/csrc/spf_dense.cu``), a CPU tensor
to the plain PyTorch version beside it.  The CUDA path never falls back:
a build failure, a refused launch or an unsupported shape raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.kernels.build import (
    check_launch,
    check_tensor,
    function,
    ptr,
    stream,
)
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.frontier import (
    dense_out_edge_csr,
    frontier_state_bytes,
    live_nodes,
    out_edge_csr,
)

#: relaxation rounds per convergence check in the plain versions (the
#: reference's DENSE_UNROLL); extra rounds past the fixed point are no-ops
DENSE_UNROLL = 8

INT8_MIN = -128


def can_transit(overloaded, roots):
    """[A, V] bool: which nodes may relax their out-edges."""
    V = overloaded.shape[1]
    ids = torch.arange(V, device=overloaded.device)
    return (~overloaded) | (ids[None, :] == roots.long()[:, None])


def transit_ok(in_src, in_ok, overloaded, roots):
    """[A, V, K] bool: in-edge usable (ok and its src may transit)."""
    A = in_src.shape[0]
    src = in_src.long()
    transit = can_transit(overloaded, roots)
    return in_ok & torch.gather(transit, 1, src.reshape(A, -1)).reshape(src.shape)


def gather_rows(table, idx):
    """table [A, V, ...] gathered per area at idx [A, ...] (in_src
    [A, V, K] or an edge list [A, E]) → [A, ..., ...]."""
    A = table.shape[0]
    areas = torch.arange(A, device=table.device).view(A, *([1] * (idx.dim() - 1)))
    return table[areas, idx.long()]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def dense_spf_distances_plain(in_src, in_w, in_ok, overloaded, roots) -> torch.Tensor:
    """[A, V] f32 distances from each area's root, BIG where unreachable."""
    A, V, _K = in_src.shape
    ok = transit_ok(in_src, in_ok, overloaded, roots)
    ww = torch.where(ok, in_w, torch.tensor(BIG, dtype=torch.float32, device=in_w.device))
    dist = torch.full((A, V), BIG, dtype=torch.float32, device=in_w.device)
    dist[torch.arange(A, device=dist.device), roots.long()] = 0.0
    i = 0
    while True:
        nd = dist
        for _ in range(DENSE_UNROLL):
            nd = torch.minimum(nd, (gather_rows(nd, in_src) + ww).amin(dim=2))
        changed = bool((nd < dist).any())
        dist = nd
        i += DENSE_UNROLL
        if not changed or i >= V:
            return dist


def dense_spf_nexthop_lanes_plain(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> torch.Tensor:
    """[A, V, D] int8 first-hop lane sets (1 = lane on a shortest path,
    -128 on vertices absent from the padded edge list)."""
    A, V, _K = in_src.shape
    D = max_degree
    ok = transit_ok(in_src, in_ok, overloaded, roots)
    big = torch.tensor(BIG, dtype=torch.float32, device=in_w.device)
    ww = torch.where(ok, in_w, big)
    dv = dist[:, :, None]
    # on-DAG in-edges: reached dst whose distance equals src dist + w
    sp = ok & (gather_rows(dist, in_src) + ww == dv) & (dv < big)
    is_root = in_src.long() == roots.long()[:, None, None]
    lanes = torch.arange(D, device=in_src.device)
    seed = ((sp & is_root)[..., None] & (in_rank[..., None] == lanes)).to(torch.int8)
    empty = torch.full((A, V, D), INT8_MIN, dtype=torch.int8, device=in_src.device)
    has = in_has[:, :, None]
    nh = torch.where(has, seed.amax(dim=2), empty)
    prop = (sp & ~is_root)[..., None].to(torch.int8)  # [A, V, K, 1]
    i = 0
    while True:
        new = nh
        for _ in range(DENSE_UNROLL):
            contrib = (gather_rows(new, in_src) * prop).amax(dim=2)
            new = torch.where(has, torch.maximum(new, contrib), new)
        changed = bool((new != nh).any())
        nh = new
        i += DENSE_UNROLL
        if not changed or i >= V:
            return nh


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


#: the kernels keep one area's f32 distances in shared memory
MAX_KERNEL_NODES = 232448 // 4
#: the most nodes kernel 1 takes: each block of its cluster of 8 holds
#: the area's distances and its slice's heads in shared memory
#: (``dense_dist_fixed_bytes`` at 45,474 nodes fits, at 45,475 does not)
DENSE_MAX_NODES = 45474
#: dynamic shared memory a block may hold beside its few static bytes
BLOCK_SHARED_BYTES = 232448 - 256
#: blocks per area of kernel 1 (a cluster of 1, 2, 4 or 8); None: by the
#: rule of :func:`dense_cluster_size`
DENSE_CLUSTER = None
#: in-slots a block of kernel 1 takes before the rule spreads an area
#: over more blocks: the 3-area world's small areas stay on one block
#: (a cluster only adds its barrier), the grid and the KSP2 backbone go
#: to 8 (PERF.md)
DENSE_BLOCK_SLOTS = 2048
#: relaxation rounds kernel 1 runs between two votes: 4 balances the
#: grid, which gains from more, and the KSP2 backbone, which loses
#: (PERF.md)
DENSE_SWEEPS = 4


def _check_planes(in_src, in_w, in_ok, overloaded, roots, batch=None):
    """Check the dense planes and ``roots`` ([A], or [batch, A] when
    ``batch`` is given: kernel 12, which has no node bound); returns (A, V,
    K, device)."""
    if in_src.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on {in_src.device}")
    A, V, K = in_src.shape
    if batch is None and V > MAX_KERNEL_NODES:
        raise ValueError(f"{V} nodes exceed the kernel's shared-memory bound")
    dev = in_src.device
    check_tensor("in_src", in_src, torch.int32, (A, V, K), dev)
    check_tensor("in_w", in_w, torch.float32, (A, V, K), dev)
    check_tensor("in_ok", in_ok, torch.bool, (A, V, K), dev)
    check_tensor("overloaded", overloaded, torch.bool, (A, V), dev)
    check_tensor("roots", roots, torch.int32, (A,) if batch is None else (batch, A), dev)
    return A, V, K, dev


def dense_cluster_size(V: int, K: int) -> int:
    """Kernel 1's blocks per area (a thread block cluster), by the rule:
    the fewest of 1, 2, 4 and 8 at which each block's share of the plane's
    in-slots (``V * K``, the most the packed records can hold; the usable
    count is known only on the card) stays within ``DENSE_BLOCK_SLOTS``;
    ``DENSE_CLUSTER`` where it is set.  (Where the share fits, so does
    each block's fixed state: at most 8 * 2,048 nodes.)"""
    if DENSE_CLUSTER is not None:
        return int(DENSE_CLUSTER)
    c = 1
    while c < 8 and V * K > c * DENSE_BLOCK_SLOTS:
        c *= 2
    return c


def dense_dist_fixed_bytes(V: int, S: int) -> int:
    """Kernel 1's fixed block state (``dense_dist_fixed_ints``): the area's
    distances (the slice's usable-slot masks while it packs), the slice's
    heads {first record, in-degree}, each 32-vertex group's first record
    and the scan counts of its 1,024 threads, in 16-byte words."""
    return 4 * _words16(4 * (V + V % 2 + 2 * S + (S + 31) // 32 + 1 + 1024 + 1))


def dense_distances_layout(A: int, V: int, K: int, cluster: int):
    """``(S, cap_shared, scratch_records)`` of kernel 1: the slice of each
    block (``S = ceil(V / cluster)`` vertices), the records (8 bytes each)
    its shared memory holds beside its fixed state within
    ``MAX_SHARED_BYTES``, and the records of the global scratch for the
    blocks whose records exceed that (a row of 32 per slot of each
    32-vertex group, ``ceil(S / 32) * 32 * K`` a block; 0 where no block
    can).  The C entry refuses a fixed state past shared memory."""
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster {cluster} must be 1, 2, 4 or 8")
    S = -(-V // cluster)
    most = -(-S // 32) * 32 * K
    budget = min(MAX_SHARED_BYTES, BLOCK_SHARED_BYTES) - dense_dist_fixed_bytes(V, S)
    cap = min(most, max(0, budget // 8))
    return S, cap, 0 if cap >= most else A * cluster * most


def dense_spf_distances_launcher(
    in_src, in_w, in_ok, overloaded, roots
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Check the inputs, allocate the output and bind the kernel once.

    Returns ``(launch, dist)``: each ``launch()`` enqueues the kernel on
    the current stream (no synchronize), writes ``dist`` [A, V] and counts
    one launch.  Each area runs on ``dense_cluster_size`` blocks, whose
    packed records sit in shared memory where they fit
    (:func:`dense_distances_layout`), else in a scratch held here."""
    A, V, K, dev = _check_planes(in_src, in_w, in_ok, overloaded, roots)
    if V > DENSE_MAX_NODES:
        raise ValueError(f"{V} nodes exceed kernel 1's {DENSE_MAX_NODES}")
    cluster = dense_cluster_size(V, K)
    _S, cap, records = dense_distances_layout(A, V, K, cluster)
    scratch = torch.empty(max(1, 2 * records), dtype=torch.int32, device=dev)
    dist = torch.empty((A, V), dtype=torch.float32, device=dev)
    fn = function("spf_dense", "openr_dense_spf_distances", DENSE_SPF_DISTANCES_ARGTYPES)
    args = (
        ptr(in_src), ptr(in_w), ptr(in_ok), ptr(overloaded), ptr(roots),
        ptr(dist), ptr(scratch) if records else None, A, V, K, cluster, cap,
        DENSE_SWEEPS, BIG, stream(dev),
    )

    # the default argument keeps the scratch alive for every later launch
    def launch(_scratch=scratch) -> None:
        if A == 0:
            return
        check_launch("dense_spf_distances", fn(*args))
        LAUNCHES["dense_spf_distances"] += 1

    return launch, dist


def dense_spf_distances_cuda(in_src, in_w, in_ok, overloaded, roots) -> torch.Tensor:
    launch, dist = dense_spf_distances_launcher(in_src, in_w, in_ok, overloaded, roots)
    launch()
    return dist


def dense_lanes_state_bytes(V: int, D: int, threads: int) -> int:
    """Kernel 2's block state (``dense_lanes_state_ints``): distances, the
    lane words (``ceil(D / 32)`` per vertex) and the scan counts."""
    return 4 * (V + V * ((D + 31) // 32) + threads + 1)


def _lanes_layout(V: int, M: int, D: int, threads: int):
    """``(layout, slice_bytes)`` of a block of kernel 2 or 5
    (``StateLayout``): the state (distances, the lane words, the scan
    counts) and the lane lists (room for ``M`` sources) in shared memory
    where both fit, else the lists, and past shared memory the whole state,
    in the block's ``slice_bytes`` of a global scratch."""
    state = 4 * _words16(dense_lanes_state_bytes(V, D, threads))
    lists = 4 * _words16(fleet_lists_bytes(V, M))
    if state + lists <= MAX_SHARED_BYTES:
        return 0, 0
    if state <= MAX_SHARED_BYTES:
        return 1, lists
    return 2, state + lists


def dense_lanes_layout(V: int, K: int, D: int, threads: int):
    """Kernel 2's block layout (:func:`_lanes_layout`): room for a source
    in every in-slot."""
    return _lanes_layout(V, V * K, D, threads)


def dense_spf_nexthop_lanes_launcher(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Like :func:`dense_spf_distances_launcher`: ``(launch, nh)`` with
    ``nh`` [A, V, D] int8 written by each ``launch()``.  Each area's block
    keeps its distances, lane words and scan counts in shared memory, and
    its lane lists beside them where they fit (:func:`dense_lanes_layout`)."""
    A, V, K, dev = _check_planes(in_src, in_w, in_ok, overloaded, roots)
    check_tensor("in_rank", in_rank, torch.int32, (A, V, K), dev)
    check_tensor("in_has", in_has, torch.bool, (A, V), dev)
    check_tensor("dist", dist, torch.float32, (A, V), dev)
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    T = DENSE_LANES_THREADS
    layout, slice_bytes = dense_lanes_layout(V, K, D, T)
    scratch = torch.empty(max(1, A * slice_bytes // 4), dtype=torch.int32, device=dev)
    nh = torch.empty((A, V, D), dtype=torch.int8, device=dev)
    fn = function("spf_dense", "openr_dense_spf_nexthop_lanes", DENSE_SPF_NEXTHOP_LANES_ARGTYPES)
    args = (
        ptr(in_src), ptr(in_w), ptr(in_ok), ptr(in_rank), ptr(in_has),
        ptr(overloaded), ptr(roots), ptr(dist), ptr(nh), ptr(scratch),
        layout, T, A, V, K, D, V * K, BIG, stream(dev),
    )

    # the default argument keeps the scratch alive for every later launch
    def launch(_scratch=scratch) -> None:
        if A == 0:
            return
        check_launch("dense_spf_nexthop_lanes", fn(*args))
        LAUNCHES["dense_spf_nexthop_lanes"] += 1

    return launch, nh


def dense_spf_nexthop_lanes_cuda(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> torch.Tensor:
    launch, nh = dense_spf_nexthop_lanes_launcher(
        in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree
    )
    launch()
    return nh


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------


def dense_spf_distances(in_src, in_w, in_ok, overloaded, roots) -> torch.Tensor:
    """[A, V] f32 distances; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if in_src.device.type == "cpu":
        return dense_spf_distances_plain(in_src, in_w, in_ok, overloaded, roots)
    return dense_spf_distances_cuda(in_src, in_w, in_ok, overloaded, roots)


def dense_spf_nexthop_lanes(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> torch.Tensor:
    """[A, V, D] int8 lane sets; the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    args = (in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree)
    if in_src.device.type == "cpu":
        return dense_spf_nexthop_lanes_plain(*args)
    return dense_spf_nexthop_lanes_cuda(*args)


def dense_spf_one(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist [A, V], nexthop lanes [A, V, D]) over the dense in-edge
    matrix."""
    dist = dense_spf_distances(in_src, in_w, in_ok, overloaded, roots)
    nh = dense_spf_nexthop_lanes(
        in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree
    )
    return dist, nh


# ---------------------------------------------------------------------------
# Warm-start (generation-delta) tables — the counterpart of the reference's
# ``warm_spf_distances``, ``spf_nexthop_lanes_reset`` and
# ``warm_subgraph_repair_one``.  They read the SEGMENT form: per-area edge
# lists ``src/dst/w/edge_ok [A, E]`` sorted by dst, each vertex's in-edges
# one contiguous run.  The seed is the previous generation's tables with
# the host-planned reset vertices at BIG (``ops/repair.py``), so the loops
# run for the depth of the perturbed region, not the hop diameter.  Lanes
# use RESET semantics (each round replaces a value), whose fixed point on
# the shortest-path DAG is unique, so any lane seed is safe.
# ---------------------------------------------------------------------------

#: relaxation rounds per convergence check in the plain warm versions
#: (the reference's WARM_UNROLL); extra rounds past the fixed point are
#: no-ops
WARM_UNROLL = 16

_INF = float("inf")


def segment_reduce(values, dst, num_segments: int, reduce: str, fill):
    """The reference's ``segment_min``/``segment_max`` per area: values
    [A, E, ...] reduced by dst [A, E] into [A, V, ...]; an empty segment
    holds ``fill`` (the reduction's identity: +inf for a f32 min, -128 for
    an int8 max)."""
    A, E = dst.shape
    tail = values.shape[2:]
    base = torch.arange(A, device=dst.device)[:, None] * num_segments
    idx = (dst.long() + base).reshape(A * E, *([1] * len(tail))).expand(A * E, *tail)
    out = torch.full(
        (A * num_segments, *tail), fill, dtype=values.dtype, device=values.device
    )
    out.scatter_reduce_(0, idx, values.reshape(A * E, *tail), reduce, include_self=True)
    return out.reshape(A, num_segments, *tail)


def shortest_path_dag(src, dst, w, edge_ok, overloaded, roots, dist):
    """[A, E] bool: directed edges on some shortest path from the root."""
    big = torch.tensor(BIG, dtype=torch.float32, device=w.device)
    transit = gather_rows(can_transit(overloaded, roots), src)
    dd = gather_rows(dist, dst)
    ds = gather_rows(dist, src)
    return edge_ok & transit & (dd < big) & (ds + torch.where(edge_ok, w, big) == dd)


def warm_spf_distances_plain(
    src, dst, w, edge_ok, overloaded, roots, d0, unroll: int = WARM_UNROLL
):
    """Warm-started masked Bellman-Ford from the over-estimate seed ``d0``
    [A, V] (the root pinned at 0).  Returns (dist [A, V] f32, rounds [A]
    int32, the rounds run: a multiple of ``unroll``, the last one finding
    nothing to change)."""
    A, V = overloaded.shape
    big = torch.tensor(BIG, dtype=torch.float32, device=w.device)
    ww = torch.where(edge_ok, w, big)
    src_ok = gather_rows(can_transit(overloaded, roots), src) & edge_ok
    dist = d0.clone()
    dist[torch.arange(A, device=dist.device), roots.long()] = 0.0

    def relax(d):
        cand = torch.where(src_ok, gather_rows(d, src) + ww, big)
        return torch.minimum(d, segment_reduce(cand, dst, V, "amin", _INF))

    i = 0
    while True:
        nd = dist
        for _ in range(unroll):
            nd = relax(nd)
        changed = bool((nd < dist).any())
        dist = nd
        i += unroll
        if not changed or i >= V:
            return dist, torch.full((A,), i, dtype=torch.int32, device=dist.device)


def spf_nexthop_lanes_reset_plain(
    src, dst, w, edge_ok, overloaded, roots, dist, nh0, max_degree: int,
    unroll: int = WARM_UNROLL,
):
    """Reset-semantics first-hop lane fixed point from the seed ``nh0``
    [A, V, D] int8.  Returns (nh [A, V, D] int8, rounds [A] int32).  Lane
    r is the r-th out-edge of the root in edge order."""
    A, V = overloaded.shape
    D = max_degree
    sp = shortest_path_dag(src, dst, w, edge_ok, overloaded, roots, dist)
    is_root_out = src.long() == roots.long()[:, None]
    rank = torch.cumsum(is_root_out.to(torch.int32), dim=1) - 1
    lanes = torch.arange(D, device=src.device)
    seed = (is_root_out[..., None] & (rank[..., None] == lanes)).to(torch.int8)
    seed_mask = (sp & is_root_out)[..., None].to(torch.int8)
    seed_part = segment_reduce(seed * seed_mask, dst, V, "amax", INT8_MIN)
    prop = (sp & ~is_root_out)[..., None].to(torch.int8)

    def step(nh):
        # int8 arithmetic as the reference's: -128 * 1 = -128, -128 * 0 = 0
        new = segment_reduce(gather_rows(nh, src) * prop, dst, V, "amax", INT8_MIN)
        # RESET: seed | in-edge max, replacing the previous round's value
        return torch.maximum(new, seed_part)

    nh = nh0.to(torch.int8)
    i = 0
    while True:
        new = nh
        for _ in range(unroll):
            new = step(new)
        changed = bool((new != nh).any())
        nh = new
        i += unroll
        if not changed or i >= V:
            return nh, torch.full((A,), i, dtype=torch.int32, device=nh.device)


def warm_subgraph_repair_plain(
    src_sub, dst_sub, w_sub, ok_sub, rank_sub, prev_dist, prev_nh, reset,
    max_degree: int, unroll: int = WARM_UNROLL,
):
    """Bounded repair of a PURE-WEAKENING delta: only the reset vertices
    re-relax, over the sub-edge list ``[A, Es]`` (every in-edge of a reset
    vertex, dst ascending; pads carry ok_sub False, rank -1 and the last
    real dst).  Every other vertex keeps its previous distance and lanes.
    A reset vertex with no sub-edge ends at -128 lanes, as the reference's
    empty segment does.  Returns (dist, nh, rounds_d [A], rounds_l [A])."""
    A, V = prev_dist.shape
    D = max_degree
    big = torch.tensor(BIG, dtype=torch.float32, device=prev_dist.device)
    d = torch.where(reset, big, prev_dist)
    w_sub = torch.where(ok_sub, w_sub, big)

    def relax(d):
        cand = torch.where(ok_sub, gather_rows(d, src_sub) + w_sub, big)
        best = segment_reduce(cand, dst_sub, V, "amin", _INF)
        return torch.where(reset, torch.minimum(d, best), d)

    rounds_d = 0
    while True:
        nd = d
        for _ in range(unroll):
            nd = relax(nd)
        changed = bool((nd < d).any())
        d = nd
        rounds_d += unroll
        if not changed or rounds_d >= V:
            break

    dd = gather_rows(d, dst_sub)
    on = ok_sub & (dd < big) & (gather_rows(d, src_sub) + w_sub == dd)
    lanes = torch.arange(D, device=prev_dist.device)
    seed = ((rank_sub[..., None] == lanes) & on[..., None]).to(torch.int8)
    seed_part = segment_reduce(seed, dst_sub, V, "amax", INT8_MIN)
    prop = (on & (rank_sub < 0))[..., None].to(torch.int8)
    keep = reset[..., None]

    def step(nh):
        new = segment_reduce(gather_rows(nh, src_sub) * prop, dst_sub, V, "amax", INT8_MIN)
        return torch.where(keep, torch.maximum(new, seed_part), nh)

    nh = torch.where(keep, torch.zeros((), dtype=torch.int8, device=prev_nh.device), prev_nh)
    rounds_l = 0
    while True:
        new = nh
        for _ in range(unroll):
            new = step(new)
        changed = bool((new != nh).any())
        nh = new
        rounds_l += unroll
        if not changed or rounds_l >= V:
            break
    full = torch.full((A,), 0, dtype=torch.int32, device=d.device)
    return d, nh, full + rounds_d, full + rounds_l


# -- CUDA kernel wrappers (kernels/csrc/spf_warm.cu) -------------------------


def segment_offsets(dst, num_segments: int):
    """[A, V + 1] int32: where each vertex's run starts in the dst-sorted
    edge list (the segment kernels' layout, derived on the device)."""
    A = dst.shape[0]
    bounds = torch.arange(num_segments + 1, dtype=dst.dtype, device=dst.device)
    return torch.searchsorted(
        dst, bounds.expand(A, num_segments + 1).contiguous(), out_int32=True
    )


def root_lane_rank(src, roots):
    """[A, E] int32: rank of each root out-edge among the root's out-edges
    in edge order (its lane), -1 on every other edge."""
    is_root_out = src == roots[:, None]
    rank = torch.cumsum(is_root_out.to(torch.int32), dim=1, dtype=torch.int32) - 1
    return torch.where(is_root_out, rank, torch.full_like(rank, -1)).contiguous()


def _check_segments(src, dst, w, edge_ok, overloaded, roots, batch=None):
    """Check the edge lists and ``roots`` ([A], or [batch, A] when
    ``batch`` is given: kernel 14, which has no node bound); returns (A, V,
    E, device)."""
    if src.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on {src.device}")
    A, V = overloaded.shape
    if batch is None and V > MAX_KERNEL_NODES:
        raise ValueError(f"{V} nodes exceed the kernel's shared-memory bound")
    E = src.shape[1]
    dev = src.device
    check_tensor("src", src, torch.int32, (A, E), dev)
    check_tensor("dst", dst, torch.int32, (A, E), dev)
    check_tensor("w", w, torch.float32, (A, E), dev)
    check_tensor("edge_ok", edge_ok, torch.bool, (A, E), dev)
    check_tensor("overloaded", overloaded, torch.bool, (A, V), dev)
    check_tensor("roots", roots, torch.int32, (A,) if batch is None else (batch, A), dev)
    return A, V, E, dev


#: blocks of kernel 4's thread block cluster per area (1, 2, 4 or 8);
#: None: by the rule of :func:`warm_dist_cluster_size`
WARM_DIST_CLUSTER = None
#: edges of the padded list a block of kernel 4 takes before the rule
#: spreads an area over more blocks (kernel 1's DENSE_BLOCK_SLOTS)
WARM_BLOCK_EDGES = 2048
#: dynamic shared memory a block of kernel 4 may take beside its static
#: bytes (scan counts, vote slots): ``kWarmDynamicSmem`` of ``spf_warm.cu``,
#: which the C entry checks (a test holds the two equal)
WARM_DIST_SHARED_BYTES = 232448 - 4352


def warm_dist_cluster_size(V: int, E: int) -> int:
    """Kernel 4's blocks per area (a thread block cluster, each block with
    a copy of the area's distances): ``WARM_DIST_CLUSTER`` where it is set,
    else the fewest of 1, 2, 4 and 8 at which each block's share of the
    padded edge list stays within ``WARM_BLOCK_EDGES``, and no more blocks
    than vertices."""
    if WARM_DIST_CLUSTER is not None:
        return int(WARM_DIST_CLUSTER)
    c = 1
    while c < 8 and E > c * WARM_BLOCK_EDGES and 2 * c <= V:
        c *= 2
    return c


def warm_dist_head_ints(S: int) -> int:
    """int32 words of a kernel-4 block's heads {first record, usable
    in-degree} [S] and group runs [ceil(S / 32) + 1], in 16-byte words
    (``warm_dist_head_ints`` of ``spf_warm.cu``)."""
    return _words16(4 * (2 * S + (S + 31) // 32 + 1))


def warm_dist_fixed_bytes(V: int, S: int) -> int:
    """Kernel 4's fixed block state in shared memory: the area's distances
    (during the packing, the slice's record cursors), then the heads."""
    return 4 * (_words16(4 * (V + V % 2)) + warm_dist_head_ints(S))


def warm_distances_layout(V: int, E: int, cluster: int):
    """``(S, cap_shared, global_state)`` of kernel 4: the slice of each
    block (``S = ceil(V / cluster)`` vertices), the records (8 bytes each)
    its shared memory holds beside its fixed state within
    ``MAX_SHARED_BYTES`` (a block whose rows of 32 exceed it keeps its
    records in the global list; at ``32 * E`` every block's rows fit), and
    whether the fixed state itself is past
    shared memory (then the cluster relaxes the output row, its heads in a
    global scratch)."""
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster {cluster} must be 1, 2, 4 or 8")
    S = -(-V // cluster)
    budget = min(MAX_SHARED_BYTES, WARM_DIST_SHARED_BYTES) - warm_dist_fixed_bytes(V, S)
    if budget < 0:
        return S, 0, True
    # rows of 32 hold at most 32 slots per usable edge of the slice
    return S, min(32 * E, budget // 8), False


def warm_spf_distances_launcher(src, dst, w, edge_ok, overloaded, roots, d0):
    """Check the inputs, allocate the outputs and the scratch and bind
    kernel 4 once.  Returns ``(launch, (dist, rounds))``: each ``launch()``
    enqueues the kernel (no synchronize) and counts one launch.  Each area
    runs on :func:`warm_dist_cluster_size` blocks, which pack their usable
    in-edges into records in shared memory where they fit
    (:func:`warm_distances_layout`), else into the global list held here
    (one element where every block's rows fit); nothing is derived from
    the edges here."""
    A, V, E, dev = _check_segments(src, dst, w, edge_ok, overloaded, roots)
    check_tensor("d0", d0, torch.float32, (A, V), dev)
    cluster = warm_dist_cluster_size(V, E)
    S, cap, global_state = warm_distances_layout(V, E, cluster)
    rows_fit = not global_state and cap >= 32 * E
    records = torch.empty(1 if rows_fit else max(1, 2 * A * E), dtype=torch.int32, device=dev)
    heads = (torch.empty(A * cluster * warm_dist_head_ints(S), dtype=torch.int32, device=dev)
             if global_state else None)
    dist = torch.empty((A, V), dtype=torch.float32, device=dev)
    rounds = torch.empty((A,), dtype=torch.int32, device=dev)
    fn = function("spf_warm", "openr_warm_spf_distances", WARM_SPF_DISTANCES_ARGTYPES)
    args = (
        ptr(src), ptr(dst), ptr(w), ptr(edge_ok), ptr(overloaded), ptr(roots),
        ptr(d0), ptr(dist), ptr(rounds), ptr(records),
        ptr(heads) if global_state else None, A, V, E, cluster, cap, BIG,
        stream(dev),
    )

    # the default argument keeps the scratch alive for every later launch
    def launch(_held=(records, heads)) -> None:
        if A == 0:
            return
        check_launch("warm_spf_distances", fn(*args))
        LAUNCHES["warm_spf_distances"] += 1

    return launch, (dist, rounds)


#: threads per block (one area) of kernel 5, a constant of ``spf_warm.cu``
RESET_LANES_THREADS = 1024
#: blocks of kernel 5's thread block cluster per area (1, 2, 4 or 8);
#: None: by the rule of :func:`reset_lanes_cluster_size`
RESET_LANES_CLUSTER = None
#: vertices a block of kernel 5 takes before the rule spreads an area over
#: more blocks
RESET_BLOCK_NODES = 512


def reset_lanes_cluster_size(V: int) -> int:
    """Kernel 5's blocks per area (a thread block cluster, each block with
    a copy of the area's lane words): ``RESET_LANES_CLUSTER`` where it is
    set, else the fewest of 1, 2, 4 and 8 at which each block owns at most
    ``RESET_BLOCK_NODES`` vertices."""
    if RESET_LANES_CLUSTER is not None:
        return int(RESET_LANES_CLUSTER)
    c = 1
    while c < 8 and V > c * RESET_BLOCK_NODES:
        c *= 2
    return c


def reset_lanes_layout(V: int, E: int, D: int):
    """Kernel 5's block layout (:func:`_lanes_layout`): room for a source
    in every in-edge."""
    return _lanes_layout(V, E, D, RESET_LANES_THREADS)


def spf_nexthop_lanes_reset_launcher(
    src, dst, w, edge_ok, overloaded, roots, dist, nh0, max_degree: int
):
    """Like :func:`warm_spf_distances_launcher`: ``(launch, (nh, rounds))``
    with ``nh`` [A, V, D] int8 written by each ``launch()``.  The kernel
    OR-accumulates the lanes from the seed bits, which equals the reset
    iteration from any seed, so ``nh0`` is checked and never read.  Each
    area runs on a cluster of :func:`reset_lanes_cluster_size` blocks,
    each keeping its state and lane lists in shared memory where they fit
    (:func:`reset_lanes_layout`), else in a scratch held here."""
    A, V, E, dev = _check_segments(src, dst, w, edge_ok, overloaded, roots)
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    check_tensor("dist", dist, torch.float32, (A, V), dev)
    check_tensor("nh0", nh0, torch.int8, (A, V, D), dev)
    seg_off = segment_offsets(dst, V)
    rank = root_lane_rank(src, roots)
    layout, slice_bytes = reset_lanes_layout(V, E, D)
    cluster = reset_lanes_cluster_size(V)
    scratch = torch.empty(max(1, A * cluster * slice_bytes // 4), dtype=torch.int32, device=dev)
    nh = torch.empty((A, V, D), dtype=torch.int8, device=dev)
    rounds = torch.empty((A,), dtype=torch.int32, device=dev)
    fn = function("spf_warm", "openr_spf_nexthop_lanes_reset", SPF_NEXTHOP_LANES_RESET_ARGTYPES)
    args = (
        ptr(src), ptr(dst), ptr(w), ptr(edge_ok), ptr(overloaded), ptr(roots),
        ptr(dist), ptr(seg_off), ptr(rank), ptr(nh), ptr(rounds), ptr(scratch),
        layout, A, V, E, D, cluster, BIG, stream(dev),
    )

    # the default argument keeps the derived layout and scratch alive
    def launch(_held=(seg_off, rank, scratch)) -> None:
        if A == 0:
            return
        check_launch("spf_nexthop_lanes_reset", fn(*args))
        LAUNCHES["spf_nexthop_lanes_reset"] += 1

    return launch, (nh, rounds)


#: dynamic shared memory a solving block of kernel 6 takes at most beside
#: its static bytes: ``kRepairSmemMax`` of ``spf_warm.cu`` (a test holds the
#: two equal), which sizes the global scratch here
SUB_REPAIR_SHARED_BYTES = 232448 - 6144


def sub_repair_state_ints(n: int, Es: int, D: int) -> int:
    """Kernel 6's state for a list of ``n`` reset vertices over ``Es``
    sub-edges, in 4-byte words: per listed vertex its id, distance,
    has-a-run flag, out-record count, frontier tag, two frontier lists,
    ceil(D / 32) lane words and out-record run; three words per inner
    record (``sub_repair_state_ints`` of ``spf_warm.cu``)."""
    return (8 + (D + 31) // 32) * n + 1 + 3 * Es


def sub_repair_scratch_ints(V: int, Es: int, D: int) -> int:
    """The global scratch words an area of kernel 6 needs: 0 where a list
    of all ``V`` vertices fits the shared memory its C entry grants (that
    list and a map of vertex to list index, up to
    ``SUB_REPAIR_SHARED_BYTES``), else a whole list's state."""
    need = sub_repair_state_ints(V, Es, D)
    return 0 if 4 * need <= SUB_REPAIR_SHARED_BYTES else need


def warm_subgraph_repair_launcher(
    src_sub, dst_sub, w_sub, ok_sub, rank_sub, prev_dist, prev_nh, reset,
    max_degree: int,
):
    """``(launch, (dist, nh, rounds_d, rounds_l))`` for the bounded
    repair, as :func:`warm_spf_distances_launcher`.  Each area's solving
    block lists its reset vertices and packs their sub-edges on the card;
    nothing is derived here (``prev_nh`` holds lanes -128, 0 or 1, as every
    lane table does).  Its state lives in shared memory where the area's
    list fits its C entry's grant, else in the global scratch
    held here; the records its edge pass finds go through a [4, Es] list
    an area, held here too."""
    dev = src_sub.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    A, V = prev_dist.shape
    Es = src_sub.shape[1]
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    for name, t in (("src_sub", src_sub), ("dst_sub", dst_sub), ("rank_sub", rank_sub)):
        check_tensor(name, t, torch.int32, (A, Es), dev)
    check_tensor("w_sub", w_sub, torch.float32, (A, Es), dev)
    check_tensor("ok_sub", ok_sub, torch.bool, (A, Es), dev)
    check_tensor("prev_dist", prev_dist, torch.float32, (A, V), dev)
    check_tensor("prev_nh", prev_nh, torch.int8, (A, V, D), dev)
    check_tensor("reset", reset, torch.bool, (A, V), dev)
    area_words = sub_repair_scratch_ints(V, Es, D)
    scratch = (torch.empty((A * area_words,), dtype=torch.int32, device=dev)
               if area_words else None)
    # the records in the order the kernel's edge pass finds them, [A, 4, Es]
    temp = torch.empty((max(1, A * 4 * Es),), dtype=torch.int32, device=dev)
    dist = torch.empty((A, V), dtype=torch.float32, device=dev)
    nh = torch.empty((A, V, D), dtype=torch.int8, device=dev)
    rounds_d = torch.empty((A,), dtype=torch.int32, device=dev)
    rounds_l = torch.empty((A,), dtype=torch.int32, device=dev)
    fn = function("spf_warm", "openr_warm_subgraph_repair", WARM_SUBGRAPH_REPAIR_ARGTYPES)
    args = (
        ptr(src_sub), ptr(dst_sub), ptr(w_sub), ptr(ok_sub), ptr(rank_sub),
        ptr(prev_dist), ptr(prev_nh), ptr(reset),
        None if scratch is None else ptr(scratch), ptr(temp), ptr(dist), ptr(nh),
        ptr(rounds_d), ptr(rounds_l), A, V, Es, D, BIG, stream(dev),
    )

    # the default argument keeps the scratch alive
    def launch(_held=(scratch, temp)) -> None:
        if A == 0:
            return
        check_launch("warm_subgraph_repair", fn(*args))
        LAUNCHES["warm_subgraph_repair"] += 1

    return launch, (dist, nh, rounds_d, rounds_l)


def _launched(launcher, *args):
    launch, outs = launcher(*args)
    launch()
    return outs


def warm_spf_distances(src, dst, w, edge_ok, overloaded, roots, d0):
    """(dist [A, V], rounds [A]); the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    args = (src, dst, w, edge_ok, overloaded, roots, d0)
    if src.device.type == "cpu":
        return warm_spf_distances_plain(*args)
    return _launched(warm_spf_distances_launcher, *args)


def spf_nexthop_lanes_reset(
    src, dst, w, edge_ok, overloaded, roots, dist, nh0, max_degree: int
):
    """(nh [A, V, D] int8, rounds [A]); kernel or plain version by device."""
    args = (src, dst, w, edge_ok, overloaded, roots, dist, nh0, max_degree)
    if src.device.type == "cpu":
        return spf_nexthop_lanes_reset_plain(*args)
    return _launched(spf_nexthop_lanes_reset_launcher, *args)


def warm_subgraph_repair(
    src_sub, dst_sub, w_sub, ok_sub, rank_sub, prev_dist, prev_nh, reset,
    max_degree: int,
):
    """Bounded-subgraph warm rebuild of a pure-weakening delta over all
    areas (:func:`warm_subgraph_repair_plain` says what it computes).
    Returns (dist [A, V], nh [A, V, D] int8, rounds_d [A], rounds_l [A]);
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (src_sub, dst_sub, w_sub, ok_sub, rank_sub, prev_dist, prev_nh,
            reset, max_degree)
    if src_sub.device.type == "cpu":
        return warm_subgraph_repair_plain(*args)
    return _launched(warm_subgraph_repair_launcher, *args)


def warm_seeds(prev_dist, prev_nh, reset, lane_keep):
    """(d0, nh0) the full-edge warm kernels start from: reset vertices at
    BIG, and the previous lanes where ``lane_keep`` [A] (root out-edge
    signature unchanged) and the vertex is not reset, else 0."""
    big = torch.tensor(BIG, dtype=torch.float32, device=prev_dist.device)
    d0 = torch.where(reset, big, prev_dist)
    keep = lane_keep[:, None, None] & ~reset[..., None]
    zero = torch.zeros((), dtype=torch.int8, device=prev_nh.device)
    return d0, torch.where(keep, prev_nh, zero)


def warm_spf_one(
    src,  # [A, E] the NEW generation's edge lists (dst-sorted)
    dst,  # [A, E]
    w,  # [A, E]
    edge_ok,  # [A, E]
    overloaded,  # [A, V]
    roots,  # [A]
    prev_dist,  # [A, V] previous generation's distances
    prev_nh,  # [A, V, D] previous generation's lanes
    reset,  # [A, V] bool host-planned affected vertices
    lane_keep,  # [A] bool root out-edge signature unchanged
    max_degree: int,
):
    """Generation-delta warm rebuild of the per-area SPF tables over the
    full edge lists (two kernels: distances, reset-semantics lanes),
    warm-started from the previous generation (:func:`warm_seeds`).
    Exact: the tables a cold solve gives.  Returns (dist [A, V], nh
    [A, V, D] int8, rounds_d [A], rounds_l [A])."""
    d0, nh0 = warm_seeds(prev_dist, prev_nh, reset, lane_keep)
    dist, rounds_d = warm_spf_distances(src, dst, w, edge_ok, overloaded, roots, d0)
    nh, rounds_l = spf_nexthop_lanes_reset(
        src, dst, w, edge_ok, overloaded, roots, dist, nh0, max_degree
    )
    return dist, nh, rounds_d, rounds_l


# ---------------------------------------------------------------------------
# Cold segment-form SPF — the counterpart of the reference's
# ``spf_distances``, ``spf_nexthop_lanes`` and ``spf_one`` (over the
# dst-sorted edge lists ``[R, E]``, one row per area), and their batch over
# vantage roots and failure sets, kernel 14 (``spf_segment_batch``,
# ``kernels/csrc/spf_warm.cu``).  Lanes OR-accumulate from the seed (the
# root's shortest-path out-edges, by rank in edge order); a vertex whose
# run in the padded dst list is empty keeps int8 -128.
#
# And the dense form batched over vantage roots, kernel 12
# (``fleet_spf_dense``, ``kernels/csrc/spf_dense.cu``): kernels 1 and 2 for
# every (root, area) pair in one launch.
#
# In a batch, ``roots [B, A]`` holds each row's root per area; -1 means
# the vantage is absent from the area and its slice reads dist BIG and
# lanes 0 (the reference masks the slice after solving from root 0).
# ---------------------------------------------------------------------------

#: elements the plain batched versions materialise per row chunk
PLAIN_CHUNK_ELEMENTS = 1 << 26


def spf_distances_plain(src, dst, w, edge_ok, overloaded, roots):
    """[R, V] f32 shortest distances from each row's root over the
    segment form, BIG where unreachable."""
    R, V = overloaded.shape
    d0 = torch.full((R, V), BIG, dtype=torch.float32, device=w.device)
    return warm_spf_distances_plain(src, dst, w, edge_ok, overloaded, roots, d0)[0]


def spf_nexthop_lanes_plain(src, dst, w, edge_ok, overloaded, roots, dist, max_degree: int):
    """[R, V, D] int8 first-hop lane sets, OR-accumulated along the
    shortest-path DAG from the seed, as the reference's loop."""
    R, V = overloaded.shape
    D = max_degree
    sp = shortest_path_dag(src, dst, w, edge_ok, overloaded, roots, dist)
    is_root_out = src.long() == roots.long()[:, None]
    rank = torch.cumsum(is_root_out.to(torch.int32), dim=1) - 1
    lanes = torch.arange(D, device=src.device)
    seed = (is_root_out[..., None] & (rank[..., None] == lanes)).to(torch.int8)
    seed_mask = (sp & is_root_out)[..., None].to(torch.int8)
    nh = segment_reduce(seed * seed_mask, dst, V, "amax", INT8_MIN)
    prop = (sp & ~is_root_out)[..., None].to(torch.int8)
    i = 0
    while True:
        new = nh
        for _ in range(WARM_UNROLL):
            # int8 arithmetic as the reference's: -128 * 1 = -128, -128 * 0 = 0
            contrib = segment_reduce(gather_rows(new, src) * prop, dst, V, "amax", INT8_MIN)
            new = torch.maximum(contrib, new)
        changed = bool((new != nh).any())
        nh = new
        i += WARM_UNROLL
        if not changed or i >= V:
            return nh


def _row_chunks(rows: int, per_row: int):
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(per_row, 1))
    for r0 in range(0, rows, step):
        yield r0, min(rows, r0 + step)


def _absent_masked(dist, nh, roots):
    """Rows whose root is -1 read dist BIG and lanes 0 (in place: both are
    the caller's fresh tables)."""
    absent = roots.reshape(-1) < 0
    dist[absent] = BIG
    nh[absent] = 0
    return dist, nh


def failed_edge_mask(link_index, fail_area, fail_link):
    """[B, A, E] bool: the edges of each row's failed set, the reference's
    rule (fleet_tables.py:260-267): some member with this area, the edge's
    link id and a link id >= 0 (a -1 pad masks nothing)."""
    A = link_index.shape[0]
    areas = torch.arange(A, dtype=torch.int32, device=link_index.device)
    fa = fail_area[:, :, None, None]
    fl = fail_link[:, :, None, None]
    hit = (areas[None, None, :, None] == fa) & (link_index[None, None] == fl) & (fl >= 0)
    return hit.any(dim=1)


def spf_segment_batch_plain(
    src, dst, w, edge_ok, overloaded, roots, max_degree: int,
    link_index=None, fail_area=None, fail_link=None,
):
    """(dist [B, A, V] f32, nh [B, A, V, D] int8): the segment-form cold
    tables of every (row, area) pair, from ``roots`` [B, A] (-1 absent),
    with row b's failed set ``fail_area/fail_link`` [B, S] masked from the
    edge lists when given."""
    B, A = roots.shape
    E = src.shape[1]
    V = overloaded.shape[1]
    D = max_degree
    ok = edge_ok[None].expand(B, A, E)
    if fail_area is not None:
        ok = ok & ~failed_edge_mask(link_index, fail_area, fail_link)
    ok = ok.reshape(B * A, E)
    flat_roots = roots.reshape(B * A)
    dists, lanes = [], []
    for r0, r1 in _row_chunks(B * A, E * D):
        area = torch.arange(r0, r1, device=src.device) % A
        rr = flat_roots[r0:r1].clamp(min=0)
        args = (src[area], dst[area], w[area], ok[r0:r1], overloaded[area], rr)
        dist = spf_distances_plain(*args)
        dists.append(dist)
        lanes.append(spf_nexthop_lanes_plain(*args, dist, D))
    dist, nh = _absent_masked(torch.cat(dists), torch.cat(lanes), roots)
    return dist.reshape(B, A, V), nh.reshape(B, A, V, D)


def fleet_spf_dense_plain(in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree: int):
    """(dist [B, A, V] f32, nh [B, A, V, D] int8): the dense cold tables of
    every (row, area) pair, from ``roots`` [B, A] (-1 absent)."""
    B, A = roots.shape
    _A, V, K = in_src.shape
    D = max_degree
    flat_roots = roots.reshape(B * A)
    dists, lanes = [], []
    for r0, r1 in _row_chunks(B * A, V * K * D):
        area = torch.arange(r0, r1, device=in_src.device) % A
        rr = flat_roots[r0:r1].clamp(min=0)
        planes = (in_src[area], in_w[area], in_ok[area])
        dist = dense_spf_distances_plain(*planes, overloaded[area], rr)
        dists.append(dist)
        lanes.append(dense_spf_nexthop_lanes_plain(
            *planes, in_rank[area], in_has[area], overloaded[area], rr, dist, D
        ))
    dist, nh = _absent_masked(torch.cat(dists), torch.cat(lanes), roots)
    return dist.reshape(B, A, V), nh.reshape(B, A, V, D)


#: the kernels' shared-memory budget per block (bytes)
MAX_SHARED_BYTES = 232448
#: threads per block of kernel 14's frontier form; None: by the pairs,
#: the most of 1,024, 512 and 256 at which the card holds a block for
#: every pair at once (a lone pair's solve is latency-bound, so more
#: threads help it only while no pair waits for a block).  Each branch
#: was the fastest of the three on the H100 where it applies: 1 and 8
#: pairs (hub row, (g) rows), 512 and 1,024 pairs ((d); PERF.md)
BATCH_THREADS = None
#: kernel 14 solves pairs of at most this many vertices by its round form
#: where its state fits shared memory (one block per pair, relaxation
#: rounds over each vertex's in-edge run):
#: on the H100 it beats the frontier form at phase (f)'s V = 256 (63 small
#: areas) and loses at V = 1,024 (phase (d)'s world; PERF.md)
SEGMENT_ROUNDS_MAX_NODES = 256
#: threads per block (one area) of kernel 2
DENSE_LANES_THREADS = 1024
#: threads per block of kernel 14's fill
FILL_THREADS = 256
#: threads per block of kernel 12 (one (root, area) pair at a time)
FLEET_THREADS = 512
#: threads per block of kernel 16 (one what-if row at a time); None: by
#: the rows, as kernel 14's rule (:func:`_segment_threads`)
ROW_THREADS = None
#: threads per block (one row) of kernel 15
MASKED_THREADS = 256
#: frontier vertices kernels 12 and 15 list at a time where their frontier
#: state lives in shared memory (a larger frontier runs in chunks)
FRONTIER_CAP = 2048
#: threads an SM holds at once (sm_90)
SM_THREADS = 2048
#: shared memory an SM holds, and what the runtime keeps of it per block
#: (sm_90)
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
#: kernels 12 and 14 keep their lane lists in shared memory beside their
#: frontier state up to this many bytes a block (two blocks an SM)
FLEET_SHARED_ALL_BYTES = SM_SHARED_BYTES // 2 - BLOCK_RESERVED_BYTES


def segment_rounds_state_bytes(V: int, E: int, S: int) -> int:
    """The per-block state of kernel 14's round form
    (``segment_rounds_state_bytes`` in ``spf_warm.cu``): run ends, lane
    ranks, the scan counts of its 256 threads, failed links, distances and
    edge classes."""
    return 4 * (V + E + 256 + 1 + S) + 4 * V + E


def fleet_lists_bytes(V: int, M: int) -> int:
    """Kernel 12's lane lists per block (``fleet_lists_ints``): source
    counts and cursors, the moving vertices, their offsets and ``M`` packed
    sources."""
    return 4 * (3 * V + 1 + M)


def fleet_dense_state_bytes(V: int, K: int) -> int:
    """Kernel 12's per-pair state when its lane lists hold every in-edge
    slot of the planes (``M = V * K``, the most a pair can pack): the
    frontier state (shared memory where it fits) and the lane lists
    (always in a global scratch, sized by the usable edges)."""
    return frontier_state_bytes(V, min(V, FRONTIER_CAP), FLEET_THREADS) + fleet_lists_bytes(V, V * K)


def masked_state_bytes(V: int, E: int, cap: int, threads: int) -> int:
    """Kernel 15's per-block state (``masked_state_ints``): the frontier
    state and the row's edge bits."""
    return frontier_state_bytes(V, cap, threads) + 4 * ((E + 31) // 32)


#: the ctypes argument types of the C entry points of this module's
#: kernels (``openr_<name>``), in order: pointers (and the stream) as
#: c_void_p, then the ints and BIG
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DENSE_SPF_DISTANCES_ARGTYPES = [_P] * 7 + [_I] * 6 + [_F, _P]
DENSE_SPF_NEXTHOP_LANES_ARGTYPES = [_P] * 10 + [_I] * 7 + [_F, _P]
WARM_SPF_DISTANCES_ARGTYPES = [_P] * 11 + [_I] * 5 + [_F, _P]
SPF_NEXTHOP_LANES_RESET_ARGTYPES = [_P] * 12 + [_I] * 6 + [_F, _P]
WARM_SUBGRAPH_REPAIR_ARGTYPES = [_P] * 14 + [_I] * 4 + [_F, _P]
SWEEP_SPF_LINK_FAILURES_ARGTYPES = [_P] * 15 + [_I] * 8 + [_F, _P]
FLEET_SPF_DENSE_ARGTYPES = [_P] * 9 + [_I] * 9 + [_F, _P]
SPF_SEGMENT_BATCH_ARGTYPES = [_P] * 14 + [_I] * 11 + [_F, _P]
SPF_SEGMENT_BATCH_ROUNDS_ARGTYPES = [_P] * 12 + [_I] * 6 + [_F, _P]
SPF_DISTANCES_MASKED_ARGTYPES = [_P] * 11 + [_I] * 9 + [_F, _P]
BATCHED_SPF_ARGTYPES = [_P] * 15 + [_I] * 12 + [_F, _P]


def _words16(nbytes: int) -> int:
    """int32 words of ``nbytes`` rounded up to whole 16-byte words."""
    return (nbytes + 15) // 16 * 4


def _resident_grid(rows: int, dev, threads: int, smem: int = 0) -> int:
    """Blocks of ``threads`` (``smem`` dynamic shared bytes each) the card
    holds at once, at most one per row."""
    per_sm = SM_THREADS // threads
    if smem:
        per_sm = min(per_sm, SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(rows, sms * max(per_sm, 1)))


def _global_state(state_bytes: int, rows: int, dev, threads: int):
    """(scratch, grid) of the global-state path of kernel 15: as
    many blocks of ``threads`` as the SMs hold at once (at most one
    per pair), each with a 16-byte-rounded slice of the scratch, walking
    the pairs in a grid-stride loop."""
    grid = _resident_grid(rows, dev, threads)
    return torch.empty(grid * _words16(state_bytes), dtype=torch.int32, device=dev), grid


def _pair_layout(V: int, M: int, threads: int, extra_bytes: int = 0,
                 all_bytes: int = None):
    """``(layout, cap, smem, slice_bytes)`` of a frontier pair kernel's
    block state (kernels 12, 14 and 16, ``StateLayout`` in
    ``frontier.cuh``): the frontier state (``extra_bytes`` after it) and
    the lane lists of ``M`` sources in shared memory up to ``all_bytes``
    (default: where two blocks still fit an SM), else the frontier state
    alone there, else neither (the frontier then listed whole)."""
    cap = min(V, FRONTIER_CAP)
    state = 4 * _words16(frontier_state_bytes(V, cap, threads) + extra_bytes)
    lists = 4 * _words16(fleet_lists_bytes(V, M))
    if all_bytes is None:
        all_bytes = FLEET_SHARED_ALL_BYTES
    if state + lists <= min(MAX_SHARED_BYTES, FLEET_SHARED_ALL_BYTES, all_bytes):
        return 0, cap, state + lists, 0
    if state <= MAX_SHARED_BYTES:
        return 1, cap, state, lists
    state = 4 * _words16(frontier_state_bytes(V, V, threads) + extra_bytes)
    return 2, V, 0, state + lists


def _segment_threads(pairs: int, dev, fixed) -> int:
    """Threads per block of kernel 14 (``fixed``: ``BATCH_THREADS``) or 16
    (``ROW_THREADS``): ``fixed`` where it is set, else by the pairs."""
    if fixed:
        return fixed
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return next((T for T in (1024, 512) if pairs <= sms * (SM_THREADS // T)), 256)


def segment_work_ints(A: int, V: int, E: int) -> int:
    """int32 words of the derived layout of kernels 14 and 16 (``work``,
    ``SegmentLayout`` in ``spf_warm.cu``): the slots' (dst, w) pairs and
    ids, the out-edge offsets and the has bytes."""
    return 3 * A * E + A * (V + 1) + (A * V + 3) // 4


def segment_batch_layout(pairs: int, V: int, E: int, S: int, dev):
    """``(threads, layout, cap, smem, slice_bytes)`` of kernel 14's
    frontier form over ``pairs`` (row, area) pairs of ``V`` vertices and
    ``E`` edge slots with failed sets of ``S`` members: the threads of
    :func:`_segment_threads` and the block state of :func:`_pair_layout`,
    its lane lists sized for every slot of an area."""
    T = _segment_threads(pairs, dev, BATCH_THREADS)
    return (T, *_pair_layout(V, E, T, 4 * S))


def spf_segment_batch_launcher(
    src, dst, w, edge_ok, overloaded, roots, max_degree: int,
    link_index=None, fail_area=None, fail_link=None,
):
    """Check the inputs, sort each area's edges by source (stable, so each
    source keeps edge order), allocate the outputs, kernel 14's derived
    layout and the scratch of the resident blocks' state (placed as
    :func:`segment_batch_layout` says) and bind kernel 14 once: from the
    sorted edges, a CSR by source of each area's edges (each source's run
    in segment order, so a slot's place in it is its lane rank; an
    unusable edge relaxes nothing; each slot's link id where a failed set
    is given) and which vertices have a run in the padded edge list; a
    fill over the card; then the frontier solve of every (row, area)
    pair.  Pairs of at most ``SEGMENT_ROUNDS_MAX_NODES``
    vertices whose round-form state fits shared memory take the round form
    instead (:func:`_segment_rounds_launcher`).  Nothing here waits for
    the card.  Returns ``(launch, (dist, nh))``: each ``launch()``
    enqueues the kernel (no synchronize) and counts one launch."""
    B = roots.shape[0]
    A, V, E, dev = _check_segments(src, dst, w, edge_ok, overloaded, roots, batch=B)
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    S = 0
    if fail_area is not None:
        S = fail_area.shape[1]
        check_tensor("link_index", link_index, torch.int32, (A, E), dev)
        check_tensor("fail_area", fail_area, torch.int32, (B, S), dev)
        check_tensor("fail_link", fail_link, torch.int32, (B, S), dev)
    if V <= SEGMENT_ROUNDS_MAX_NODES and segment_rounds_state_bytes(V, E, S) <= MAX_SHARED_BYTES:
        return _segment_rounds_launcher(
            src, dst, w, edge_ok, overloaded, roots, D, link_index, fail_area, fail_link, S
        )
    src_sorted, order = torch.sort(src, dim=1, stable=True)
    work = torch.empty(max(1, segment_work_ints(A, V, E)), dtype=torch.int32, device=dev)
    T, layout, cap, smem, slice_bytes = segment_batch_layout(B * A, V, E, S, dev)
    grid = _resident_grid(B * A, dev, T, smem)
    scratch = torch.empty(max(1, grid * slice_bytes // 4), dtype=torch.int32, device=dev)
    dist = torch.empty((B, A, V), dtype=torch.float32, device=dev)
    nh = torch.empty((B, A, V, D), dtype=torch.int8, device=dev)
    # the fill's blocks: as many as the card holds at once, at most one per
    # FILL_THREADS 16-byte words
    fill_grid = _resident_grid(max(1, -(-B * A * V * D // (16 * FILL_THREADS))), dev, FILL_THREADS)
    fn = function("spf_warm", "openr_spf_segment_batch", SPF_SEGMENT_BATCH_ARGTYPES)
    opt = lambda t: ptr(t) if S else None  # noqa: E731
    args = (
        ptr(src_sorted), ptr(order), ptr(dst), ptr(w), ptr(edge_ok), opt(link_index),
        ptr(overloaded), ptr(roots), opt(fail_area), opt(fail_link), ptr(work), ptr(dist),
        ptr(nh), ptr(scratch), layout, grid, fill_grid, T, B, A, V, E, D, S, cap, BIG,
        stream(dev),
    )

    # the default argument keeps the sorted edges, the derived layout and
    # the scratch alive
    def launch(_held=(src_sorted, order, work, scratch)) -> None:
        if B == 0 or A == 0:
            return
        check_launch("spf_segment_batch", fn(*args))
        LAUNCHES["spf_segment_batch"] += 1

    return launch, (dist, nh)


def _segment_rounds_launcher(
    src, dst, w, edge_ok, overloaded, roots, D, link_index, fail_area, fail_link, S
):
    """Kernel 14's round form, bound as :func:`spf_segment_batch_launcher`:
    one block per pair with its state in shared memory."""
    B = roots.shape[0]
    A, V = overloaded.shape
    E = src.shape[1]
    dev = src.device
    seg_off = segment_offsets(dst, V)
    dist = torch.empty((B, A, V), dtype=torch.float32, device=dev)
    nh = torch.empty((B, A, V, D), dtype=torch.int8, device=dev)
    fn = function("spf_warm", "openr_spf_segment_batch_rounds", SPF_SEGMENT_BATCH_ROUNDS_ARGTYPES)
    sets = (ptr(link_index), ptr(fail_area), ptr(fail_link)) if S else (None, None, None)
    args = (
        ptr(src), ptr(dst), ptr(w), ptr(edge_ok), ptr(overloaded), sets[0],
        ptr(roots), sets[1], sets[2], ptr(seg_off), ptr(dist), ptr(nh),
        B, A, V, E, D, S, BIG, stream(dev),
    )

    # the default argument keeps the derived layout alive
    def launch(_held=seg_off) -> None:
        if B == 0 or A == 0:
            return
        check_launch("spf_segment_batch", fn(*args))
        LAUNCHES["spf_segment_batch"] += 1

    return launch, (dist, nh)


def spf_segment_batch(
    src, dst, w, edge_ok, overloaded, roots, max_degree: int,
    link_index=None, fail_area=None, fail_link=None,
):
    """(dist [B, A, V], nh [B, A, V, D]) of every (row, area) pair; kernel 14
    for CUDA tensors, the plain version for CPU tensors."""
    args = (src, dst, w, edge_ok, overloaded, roots, max_degree, link_index,
            fail_area, fail_link)
    if src.device.type == "cpu":
        return spf_segment_batch_plain(*args)
    return _launched(spf_segment_batch_launcher, *args)


def spf_one(src, dst, w, edge_ok, overloaded, roots, max_degree: int):
    """(dist [A, V], nh [A, V, D]) over the segment form from each area's
    root: kernel 14 at one batch row for CUDA tensors, the plain versions
    for CPU tensors."""
    if src.device.type == "cpu":
        dist = spf_distances_plain(src, dst, w, edge_ok, overloaded, roots)
        return dist, spf_nexthop_lanes_plain(src, dst, w, edge_ok, overloaded, roots, dist, max_degree)
    dist, nh = spf_segment_batch(src, dst, w, edge_ok, overloaded, roots[None], max_degree)
    return dist[0], nh[0]


def fleet_spf_dense_launcher(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree: int
):
    """Like :func:`spf_segment_batch_launcher`, for kernel 12: derives the
    out-edge CSR of each area's usable slots (:func:`dense_out_edge_csr`)
    and places each resident block's state (the frontier state and the
    lane lists) in shared memory or its slice of a global scratch:
    ``(launch, (dist, nh))``."""
    B = roots.shape[0]
    A, V, K, dev = _check_planes(in_src, in_w, in_ok, overloaded, roots, batch=B)
    check_tensor("in_rank", in_rank, torch.int32, (A, V, K), dev)
    check_tensor("in_has", in_has, torch.bool, (A, V), dev)
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    out_off, out_edge, out_rank = dense_out_edge_csr(in_src, in_w, in_ok, in_rank)
    M = int((out_off[:, V] - out_off[:, 0]).max()) if A else 0
    T = FLEET_THREADS
    layout, cap, smem, slice_bytes = _pair_layout(V, M, T)
    grid = _resident_grid(B * A, dev, T, smem)
    scratch = torch.empty(max(1, grid * slice_bytes // 4), dtype=torch.int32, device=dev)
    dist = torch.empty((B, A, V), dtype=torch.float32, device=dev)
    nh = torch.empty((B, A, V, D), dtype=torch.int8, device=dev)
    fn = function("spf_dense", "openr_fleet_spf_dense", FLEET_SPF_DENSE_ARGTYPES)
    args = (
        ptr(out_off), ptr(out_edge), ptr(out_rank), ptr(in_has), ptr(overloaded), ptr(roots),
        ptr(dist), ptr(nh), ptr(scratch), layout, grid, T, B, A, V, M, D, cap, BIG, stream(dev),
    )

    # the default argument keeps the derived layout and the scratch alive
    def launch(_held=(out_off, out_edge, out_rank, scratch)) -> None:
        if B == 0 or A == 0:
            return
        check_launch("fleet_spf_dense", fn(*args))
        LAUNCHES["fleet_spf_dense"] += 1

    return launch, (dist, nh)


def fleet_spf_dense(in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree: int):
    """(dist [B, A, V], nh [B, A, V, D]) of every (root row, area) pair over
    the dense planes; kernel 12 for CUDA tensors, the plain version for CPU
    tensors."""
    args = (in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree)
    if in_src.device.type == "cpu":
        return fleet_spf_dense_plain(*args)
    return _launched(fleet_spf_dense_launcher, *args)


# ---------------------------------------------------------------------------
# The KSP2_ED_ECMP k-th-path re-solve — the counterpart of the reference's
# ``batched_spf_distances_masked`` (kernel 15, ``spf_distances_masked``,
# ``kernels/csrc/spf_warm.cu``).  One topology in the single-area edge-list
# form (``src/dst/w/edge_ok [E]``, dst sorted, ``overloaded [V]``), B rows:
# row b solves distances only from ``roots[b]`` with ``edge_ok &
# edge_enabled[b]``.  The set form takes row b's failed undirected link
# ids (``failed [B, S]``, -1 pads mask nothing) and ``link_index [E]``
# instead of the [B, E] mask, which is how the KSP2 engine calls it: at
# 8,191 rows over 32,768 edges the mask alone would be 268 MB.
# ---------------------------------------------------------------------------


def failed_links_mask(link_index, failed):
    """[B, E] bool edge-enable mask of the rows' failed link id sets
    ``failed`` [B, S] (-1 pads mask nothing): an edge is off iff its link
    id is in its row's set, the reference's ``link_failure_batch`` rule."""
    B = failed.shape[0]
    L = int(link_index.max()) + 1 if link_index.numel() else 0
    hit = torch.zeros((B, L + 1), dtype=torch.bool, device=failed.device)
    ids = torch.where((failed >= 0) & (failed < L), failed, L).long()
    hit.scatter_(1, ids, True)
    hit[:, L] = False
    cols = torch.where(link_index >= 0, link_index, L).long()
    return ~hit[:, cols]


def batched_spf_distances_masked_plain(src, dst, w, edge_ok, edge_enabled, overloaded, roots):
    """[B, V] f32 distances of each row from its root with its row of
    ``edge_enabled`` ANDed into ``edge_ok``, BIG where unreachable."""
    B, E = edge_enabled.shape
    V = overloaded.shape[0]
    out = []
    for r0, r1 in _row_chunks(B, E):
        n = r1 - r0
        rows = (src.expand(n, E), dst.expand(n, E), w.expand(n, E),
                edge_ok[None] & edge_enabled[r0:r1], overloaded.expand(n, V), roots[r0:r1])
        out.append(spf_distances_plain(*rows))
    if not out:
        return torch.empty((0, V), dtype=torch.float32, device=w.device)
    return torch.cat(out)


def batched_spf_distances_masked_sets_plain(src, dst, w, edge_ok, link_index, failed, overloaded, roots):
    """The set form of :func:`batched_spf_distances_masked_plain`."""
    out = [
        batched_spf_distances_masked_plain(
            src, dst, w, edge_ok, failed_links_mask(link_index, failed[r0:r1]),
            overloaded, roots[r0:r1],
        )
        for r0, r1 in _row_chunks(failed.shape[0], src.shape[0])
    ]
    if not out:
        return torch.empty((0, overloaded.shape[0]), dtype=torch.float32, device=w.device)
    return torch.cat(out)


def link_edge_csr(link_index, num_links: int):
    """(link_off [L + 1], link_edges) int32: the edge positions of each
    undirected link id, in edge order."""
    valid = torch.nonzero(link_index >= 0).squeeze(1)
    ids = link_index[valid]
    order = torch.sort(ids, stable=True).indices
    bounds = torch.arange(num_links + 1, dtype=ids.dtype, device=ids.device)
    link_off = torch.searchsorted(ids[order], bounds, out_int32=True)
    return link_off, valid[order].to(torch.int32).contiguous()


def spf_distances_masked_launcher(
    src, dst, w, edge_ok, overloaded, roots, edge_enabled=None, link_index=None, failed=None,
):
    """Check the inputs, derive the out-edge CSR of the usable edges
    (:func:`out_edge_csr`; in the set form, also the link id -> edges CSR),
    allocate the output (and, where a row's state exceeds shared memory,
    the scratch of the resident blocks) and bind kernel 15 once.  Pass
    ``edge_enabled`` [B, E] bool, or ``link_index`` [E] and ``failed``
    [B, S] int32.  Returns ``(launch, dist)``: each ``launch()`` enqueues
    the kernel (no synchronize) and counts one launch."""
    if src.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on {src.device}")
    dev = src.device
    V = overloaded.shape[0]
    E = src.shape[0]
    B = roots.shape[0]
    check_tensor("src", src, torch.int32, (E,), dev)
    check_tensor("dst", dst, torch.int32, (E,), dev)
    check_tensor("w", w, torch.float32, (E,), dev)
    check_tensor("edge_ok", edge_ok, torch.bool, (E,), dev)
    check_tensor("overloaded", overloaded, torch.bool, (V,), dev)
    check_tensor("roots", roots, torch.int32, (B,), dev)
    S = L = 0
    link_off = link_edges = None
    if edge_enabled is not None:
        check_tensor("edge_enabled", edge_enabled, torch.bool, (B, E), dev)
    else:
        S = failed.shape[1]
        check_tensor("link_index", link_index, torch.int32, (E,), dev)
        check_tensor("failed", failed, torch.int32, (B, S), dev)
        L = int(link_index.max()) + 1 if E else 0
        link_off, link_edges = link_edge_csr(link_index, L)
    out_off, out_edge, out_id = out_edge_csr(src, dst, w, edge_ok, V)
    # the rows solve only the vertices an edge or a root touches
    live = live_nodes(out_off, out_edge, roots)
    T = MASKED_THREADS
    cap = min(live, FRONTIER_CAP)
    scratch, grid = None, B
    if masked_state_bytes(live, E, cap, T) > MAX_SHARED_BYTES:
        cap = live
        scratch, grid = _global_state(masked_state_bytes(live, E, cap, T), B, dev, T)
    dist = torch.empty((B, V), dtype=torch.float32, device=dev)
    fn = function("spf_warm", "openr_spf_distances_masked", SPF_DISTANCES_MASKED_ARGTYPES)
    opt = lambda t: None if t is None else ptr(t)  # noqa: E731
    args = (
        ptr(out_off), ptr(out_edge), ptr(out_id), ptr(overloaded), ptr(roots),
        opt(edge_enabled), opt(failed), opt(link_off), opt(link_edges), ptr(dist), opt(scratch),
        grid, T, B, V, live, E, S, L, cap, BIG, stream(dev),
    )

    # the default argument keeps the derived layout and the scratch alive
    def launch(_held=(out_off, out_edge, out_id, link_off, link_edges, scratch)) -> None:
        if B == 0:
            return
        check_launch("spf_distances_masked", fn(*args))
        LAUNCHES["spf_distances_masked"] += 1

    return launch, dist


def batched_spf_distances_masked(src, dst, w, edge_ok, edge_enabled, overloaded, roots):
    """[B, V] distances of each row from its root over ``edge_ok &
    edge_enabled[b]``: kernel 15 for CUDA tensors, the plain version for
    CPU tensors."""
    if src.device.type == "cpu":
        return batched_spf_distances_masked_plain(
            src, dst, w, edge_ok, edge_enabled, overloaded, roots
        )
    return _launched(
        spf_distances_masked_launcher, src, dst, w, edge_ok, overloaded, roots, edge_enabled
    )


def batched_spf_distances_masked_sets(src, dst, w, edge_ok, link_index, failed, overloaded, roots):
    """[B, V] distances of each row from its root with the edges of its
    failed link ids ``failed`` [B, S] (-1 pads) masked: kernel 15 for CUDA
    tensors, the plain version for CPU tensors."""
    if src.device.type == "cpu":
        return batched_spf_distances_masked_sets_plain(
            src, dst, w, edge_ok, link_index, failed, overloaded, roots
        )
    return _launched(
        spf_distances_masked_launcher, src, dst, w, edge_ok, overloaded, roots, None,
        link_index, failed,
    )


# ---------------------------------------------------------------------------
# Cold batch-minor link-failure sweep — the counterpart of the reference's
# ``sweep_spf_link_failures`` (with ``spf_distances_sweep``,
# ``spf_lanes_sweep`` and ``spf_lanes_sweep_packed``).  One topology in the
# single-area edge-list form (``src/dst/w/edge_ok/link_index [E]``, dst
# sorted), B snapshots, snapshot b failing the link ``failed_link[b]`` (-1:
# none).  Tables are batch-minor: dist [V, B], lanes [V, B, D] int8.  The
# lane fixed point OR-accumulates (a lane once set stays set), seeded at
# the root's shortest-path out-edges; a vertex absent from the padded dst
# list keeps the segment-max identity, int8 -128.
#
# The reference can also pack the lanes 6 to a uint32 channel as 5-bit
# digits (a TPU byte layout); the port computes the int8 form only, and
# ``unpack_lanes`` decodes the reference's packed channels for the parity
# tests.
# ---------------------------------------------------------------------------

#: the reference's packed-lane encoding: 6 lanes per uint32 channel, 5
#: bits per lane digit
LANES_PER_CHANNEL = 6
LANE_BITS = 5


def lane_channels(max_degree: int) -> int:
    return (max_degree + LANES_PER_CHANNEL - 1) // LANES_PER_CHANNEL


def unpack_lanes(packed, max_degree: int):
    """[..., C] uint32 packed channels (numpy) → [..., D] int8 0/1."""
    import numpy as np

    d = np.arange(max_degree)
    chan = d // LANES_PER_CHANNEL
    shift = (d % LANES_PER_CHANNEL) * LANE_BITS
    vals = packed[..., chan] >> shift.astype(packed.dtype)
    return ((vals & ((1 << LANE_BITS) - 1)) > 0).astype(np.int8)


def _segment_1d(values, dst, V: int, reduce: str, fill):
    """:func:`segment_reduce` of one edge list: values [E, ...] → [V, ...]."""
    return segment_reduce(values[None], dst[None], V, reduce, fill)[0]


def sweep_spf_link_failures_plain(
    src, dst, w, edge_ok, link_index, failed_link, overloaded, root: int,
    max_degree: int,
):
    """Synchronous (Jacobi) rounds, as the reference's while loops.
    Returns (dist [V, B] f32, nh [V, B, D] int8, rounds_d, rounds_l): the
    rounds each loop ran, the last one finding nothing to change."""
    V = overloaded.shape[0]
    D = max_degree
    dev = w.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    en = edge_ok[:, None] & (link_index[:, None] != failed_link[None, :])  # [E, B]
    transit = ~overloaded | (torch.arange(V, device=dev) == root)
    src_l = src.long()
    dst_l = dst.long()
    src_ok = transit[src_l][:, None] & en
    wcol = torch.where(en, w[:, None], big)
    dist = torch.full((V, failed_link.shape[0]), BIG, dtype=torch.float32, device=dev)
    dist[root] = 0.0
    rounds_d = 0
    while True:
        cand = torch.where(src_ok, dist[src_l] + wcol, big)
        nd = torch.minimum(dist, _segment_1d(cand, dst, V, "amin", _INF))
        rounds_d += 1
        changed = bool((nd < dist).any())
        dist = nd
        if not changed or rounds_d >= V:
            break

    sp = src_ok & (dist[dst_l] < big) & (dist[src_l] + wcol == dist[dst_l])  # [E, B]
    is_root_out = src_l == root
    rank = torch.cumsum(is_root_out.to(torch.int32), dim=0) - 1
    lanes = torch.arange(D, device=dev)
    seed = (is_root_out[:, None] & (rank[:, None] == lanes)).to(torch.int8)  # [E, D]
    seed_mask = (sp & is_root_out[:, None]).to(torch.int8)  # [E, B]
    nh = _segment_1d(seed[:, None, :] * seed_mask[:, :, None], dst, V, "amax", INT8_MIN)
    prop = (sp & ~is_root_out[:, None]).to(torch.int8)[:, :, None]
    rounds_l = 0
    while True:
        # int8 arithmetic as the reference's: -128 * 1 = -128
        new = torch.maximum(_segment_1d(nh[src_l] * prop, dst, V, "amax", INT8_MIN), nh)
        rounds_l += 1
        changed = bool((new != nh).any())
        nh = new
        if not changed or rounds_l >= V:
            break
    return dist, nh, rounds_d, rounds_l


#: the most nodes kernel 8 takes (each block of a cluster holds its
#: vertices' record offsets in shared memory)
MAX_SWEEP_NODES = 32768
#: blocks of kernel 8's thread block cluster per 32-snapshot word (1, 2,
#: 4 or 8); None: by the rule of :func:`sweep_cluster_size`
SWEEP_CLUSTER = None
#: kernel 8's dynamic shared memory per block for its vertex state and
#: records beside its head, at most (a block's 227 KB less room for its
#: static shared memory); 0 puts both in global memory
SWEEP_SHARED_BYTES = 232448 - 256


def sweep_cluster_size(V: int) -> int:
    """Kernel 8's blocks per 32-snapshot word: ``SWEEP_CLUSTER`` where it
    is set, else 8, or the largest power of two up to V where V < 8 (8
    was the fastest of 1, 2, 4 and 8 at 1, 32 and 96 words on the H100;
    PERF.md)."""
    if SWEEP_CLUSTER is not None:
        return int(SWEEP_CLUSTER)
    c = 8
    while c > V:
        c //= 2
    return c


def sweep_layout(V: int, E: int, B: int, D: int, cluster: int):
    """``(S, mode, cap_rec, layout_ints, scratch_ints)`` of kernel 8
    (``spf_sweep.cu``): each block of a word's cluster owns ``S =
    ceil(V / cluster)`` vertices, a vertex's state 32 distance columns and
    D lane words.  ``mode`` (``SweepState``): 2, every block holds a copy
    of every vertex's state in shared memory (where it fits
    ``SWEEP_SHARED_BYTES`` with the head, the owned vertices' record
    offsets and counts, and room for E / cluster records); 1, each block
    holds its owned vertices' (read by the others there); 0, the owned
    vertices' state in a global scratch of ``scratch_ints`` words.  A block copies its
    usable-edge records (16 bytes each) into the ``cap_rec`` left, or
    reads them in place.  The layout (the records of the usable edges and
    their offsets) is ``layout_ints`` words."""
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster {cluster} must be 1, 2, 4 or 8")
    S = -(-V // cluster)
    head = (2 * S + 1 + 3) // 4 * 4
    if head > BLOCK_SHARED_BYTES // 4:
        raise ValueError(f"{V} nodes exceed kernel 8's head at cluster {cluster}")
    budget = min(SWEEP_SHARED_BYTES, BLOCK_SHARED_BYTES) // 4
    owned = (S * (32 + D) + 3) // 4 * 4
    every = (V * (32 + D) + 3) // 4 * 4
    # copies where they leave room for a block's share of the edges as
    # records (its own records in shared memory: the lanes then read only
    # the packed DAG records)
    if cluster > 1 and head + every + 4 * -(-E // cluster) <= budget:
        mode, held = 2, every
    elif head + owned <= budget:
        mode, held = 1, owned
    else:
        mode, held = 0, 0
    cap_rec = min(E, max(0, budget - head - held) // 4)
    layout = (cluster * S + 2 + 3) // 4 * 4 + 4 * E
    scratch = 0 if mode else -(-B // 32) * cluster * owned
    return S, mode, cap_rec, layout, scratch


def sweep_spf_link_failures_launcher(
    src, dst, w, edge_ok, link_index, failed_link, overloaded, root: int,
    max_degree: int,
):
    """Check the inputs, derive the segment offsets and lane ranks,
    allocate the outputs, the layout and the state scratch, and bind
    kernel 8 (``kernels/csrc/spf_sweep.cu``) once: each 32-snapshot word
    on a cluster of :func:`sweep_cluster_size` blocks, placed by
    :func:`sweep_layout`.  Returns ``(launch, (dist, nh, rounds_d,
    rounds_l))``: each ``launch()`` enqueues the kernel (no synchronize)
    and counts one launch; the round counts are per 32-snapshot word, in
    place, so they differ from the plain version's synchronous counts."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    V = overloaded.shape[0]
    E = src.shape[0]
    B = failed_link.shape[0]
    D = int(max_degree)
    if V > MAX_SWEEP_NODES:
        raise ValueError(f"{V} nodes exceed the sweep kernel's {MAX_SWEEP_NODES}")
    if D < 1 or not 0 <= root < V:
        raise ValueError(f"bad max_degree {D} or root {root}")
    for name, t in (("src", src), ("dst", dst), ("link_index", link_index)):
        check_tensor(name, t, torch.int32, (E,), dev)
    check_tensor("w", w, torch.float32, (E,), dev)
    check_tensor("edge_ok", edge_ok, torch.bool, (E,), dev)
    check_tensor("failed_link", failed_link, torch.int32, (B,), dev)
    check_tensor("overloaded", overloaded, torch.bool, (V,), dev)
    seg_off = segment_offsets(dst[None], V)[0].contiguous()
    # the root's out-edges' ranks (root_lane_rank), with no copy to the card
    is_root_out = src == root
    rank = torch.cumsum(is_root_out, 0, dtype=torch.int32) - 1
    lane_rank = torch.where(is_root_out, rank, -1).to(torch.int32)
    words = (B + 31) // 32
    cluster = sweep_cluster_size(V)
    _S, mode, cap_rec, layout_ints, scratch_ints = sweep_layout(V, E, B, D, cluster)
    layout = torch.empty((layout_ints,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, scratch_ints),), dtype=torch.int32, device=dev)
    dist = torch.empty((V, B), dtype=torch.float32, device=dev)
    nh = torch.empty((V, B, D), dtype=torch.int8, device=dev)
    rounds_d = torch.empty((words,), dtype=torch.int32, device=dev)
    rounds_l = torch.empty((words,), dtype=torch.int32, device=dev)
    fn = function("spf_sweep", "openr_sweep_spf_link_failures", SWEEP_SPF_LINK_FAILURES_ARGTYPES)
    args = (
        ptr(src), ptr(dst), ptr(w), ptr(edge_ok), ptr(link_index),
        ptr(failed_link), ptr(overloaded), ptr(lane_rank), ptr(seg_off),
        ptr(layout), ptr(scratch), ptr(dist), ptr(nh), ptr(rounds_d), ptr(rounds_l),
        V, E, B, D, root, cluster, mode, cap_rec, BIG, stream(dev),
    )

    # the default argument keeps the derived layout and the scratch alive
    def launch(_held=(seg_off, lane_rank, layout, scratch)) -> None:
        if B == 0:
            return
        check_launch("sweep_spf_link_failures", fn(*args))
        LAUNCHES["sweep_spf_link_failures"] += 1

    return launch, (dist, nh, rounds_d, rounds_l)


def sweep_spf_link_failures(
    src, dst, w, edge_ok, link_index, failed_link, overloaded, root: int,
    max_degree: int,
):
    """Cold single-link-failure sweep, batch-minor: (dist [V, B] f32, nh
    [V, B, D] int8, rounds_d, rounds_l).  Kernel 8 for CUDA tensors, the
    plain version for CPU tensors; exact either way (unique fixed
    points)."""
    args = (src, dst, w, edge_ok, link_index, failed_link, overloaded, root, max_degree)
    if src.device.type == "cpu":
        return sweep_spf_link_failures_plain(*args)
    return _launched(sweep_spf_link_failures_launcher, *args)


# ---------------------------------------------------------------------------
# Per-snapshot batches — the counterpart of the reference's
# ``batched_spf`` (``ops/spf.py:201``), ``batched_spf_link_failures``
# (``:178``) and ``batched_spf_distinct`` (``:247``): ``spf_one`` for every
# row b, from ``roots[b]`` with row b's own hard-drain row ``overloaded[b]``
# and enable mask, giving distances and lanes (kernel 16, ``batched_spf``,
# ``kernels/csrc/spf_warm.cu``).  The edge list is shared (``[E]``) with a
# per-row mask — ``edge_enabled [B, E]`` bool, or each row's failed link
# ids through ``link_index`` — or is row b's own (``[B, E]``, each row
# dst-sorted, ``batched_spf_distinct``).  Lane r of a row is the r-th
# out-edge of ITS root in edge order, disabled edges included.
# ---------------------------------------------------------------------------


def hop_count_weights(w):
    """useLinkMetric=false mode: every edge costs 1 (LinkState.cpp:789)."""
    return torch.ones_like(w)


def _batched_rows_plain(src, dst, w, edge_ok, overloaded, roots, max_degree: int, ok_rows):
    """(dist [B, V], nh [B, V, D]) of :func:`spf_distances_plain` and
    :func:`spf_nexthop_lanes_plain` over row chunks; the edge arrays are
    [E] (shared) or [B, E], ``ok_rows(r0, r1)`` gives the chunk's [n, E]
    usable edges."""
    B = overloaded.shape[0]
    E = src.shape[-1]
    D = max_degree
    dists, lanes = [], []
    for r0, r1 in list(_row_chunks(B, E * D)) or [(0, 0)]:
        n = r1 - r0
        rows = [a[r0:r1] if a.dim() == 2 else a.expand(n, E) for a in (src, dst, w)]
        args = (*rows, ok_rows(r0, r1), overloaded[r0:r1], roots[r0:r1])
        dist = spf_distances_plain(*args)
        dists.append(dist)
        lanes.append(spf_nexthop_lanes_plain(*args, dist, D))
    return torch.cat(dists), torch.cat(lanes)


def batched_spf_plain(src, dst, w, edge_ok, edge_enabled, overloaded, roots, max_degree: int):
    """Row b: ``spf_one`` from ``roots[b]`` over ``edge_ok & edge_enabled[b]``
    with hard-drain row ``overloaded[b]``.  Returns (dist [B, V] f32, nh
    [B, V, D] int8)."""
    return _batched_rows_plain(
        src, dst, w, edge_ok, overloaded, roots, max_degree,
        lambda r0, r1: edge_ok[None] & edge_enabled[r0:r1],
    )


def batched_spf_link_failures_plain(
    src, dst, w, edge_ok, link_index, failed_link, overloaded, roots, max_degree: int
):
    """Row b fails the undirected link ``failed_link[b]`` (-1: none): the
    reference's ``link_index != failed_link[b]`` mask, expanded per chunk."""
    return _batched_rows_plain(
        src, dst, w, edge_ok, overloaded, roots, max_degree,
        lambda r0, r1: edge_ok[None] & (link_index[None] != failed_link[r0:r1, None]),
    )


def batched_spf_distinct_plain(src, dst, w, edge_ok, overloaded, roots, max_degree: int):
    """Row b over its own edge list ``src/dst/w/edge_ok [B, E]`` (each
    row dst-sorted, padded to the common E)."""
    return _batched_rows_plain(
        src, dst, w, edge_ok, overloaded, roots, max_degree, lambda r0, r1: edge_ok[r0:r1]
    )


def batched_spf_layout(B: int, V: int, E: int, dev):
    """``(threads, layout, cap, smem, slice_bytes)`` of kernel 16 over ``B``
    rows of ``V`` vertices and ``E`` edge slots: the threads of
    :func:`_segment_threads` (``ROW_THREADS``) and the block state of
    :func:`_pair_layout`, the row's edge bits after the frontier state and
    the lane lists sized for every slot, in shared memory only where an SM
    still holds as many blocks as its threads allow (else the lists go to
    the global scratch: at the flagship shape and 256 threads, 8 rows an
    SM instead of 3, 14 % faster on the H100, PERF.md)."""
    T = _segment_threads(B, dev, ROW_THREADS)
    return (T, *batched_spf_state(V, E, T))


def batched_spf_state(V: int, E: int, threads: int):
    """``(layout, cap, smem, slice_bytes)`` of kernel 16's block state at
    ``threads`` (:func:`batched_spf_layout`)."""
    all_bytes = SM_SHARED_BYTES // max(1, SM_THREADS // threads) - BLOCK_RESERVED_BYTES
    return _pair_layout(V, E, threads, 4 * ((E + 31) // 32), all_bytes)


def batched_spf_launcher(
    src, dst, w, edge_ok, overloaded, roots, max_degree: int,
    edge_enabled=None, link_index=None, failed=None,
):
    """Check the inputs, sort the edges by source (stable; per row for
    per-row lists), allocate the outputs, kernel 16's derived layout (and,
    in the set form, the link id -> edges CSR) and the scratch of the
    resident blocks' state (placed as :func:`batched_spf_layout` says) and
    bind kernel 16 once: on the card, a CSR by source of every edge of the
    list (each source's run in edge order, so a slot's place in it is its
    lane rank; an unusable edge relaxes nothing; each slot's edge position
    for the row's mask bit), shared by every row of a shared list (one
    area) or one per row; a fill over the card; then the frontier solve of
    every row.  The edge arrays are [E] (shared; pass ``edge_enabled``
    [B, E] bool, or ``link_index`` [E] and ``failed`` [B, S] int32, or
    neither) or [B, E] (row b's own list, no mask).  Nothing here waits
    for the card but the set form's ``link_index.max()``.  Returns
    ``(launch, (dist, nh))``: each ``launch()`` enqueues the kernel (no
    synchronize) and counts one launch."""
    if src.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on {src.device}")
    dev = src.device
    B, V = overloaded.shape
    distinct = src.dim() == 2
    E = src.shape[-1]
    eshape = (B, E) if distinct else (E,)
    for name, t in (("src", src), ("dst", dst)):
        check_tensor(name, t, torch.int32, eshape, dev)
    check_tensor("w", w, torch.float32, eshape, dev)
    check_tensor("edge_ok", edge_ok, torch.bool, eshape, dev)
    check_tensor("overloaded", overloaded, torch.bool, (B, V), dev)
    check_tensor("roots", roots, torch.int32, (B,), dev)
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    if distinct and (edge_enabled is not None or failed is not None):
        raise ValueError("per-row edge lists take no enable mask")
    S = L = 0
    link_off = link_edges = None
    if edge_enabled is not None:
        check_tensor("edge_enabled", edge_enabled, torch.bool, (B, E), dev)
    elif failed is not None:
        S = failed.shape[1]
        check_tensor("link_index", link_index, torch.int32, (E,), dev)
        check_tensor("failed", failed, torch.int32, (B, S), dev)
        # the one host sync of the bind: the link CSR's size
        L = int(link_index.max()) + 1 if E else 0
        link_off, link_edges = link_edge_csr(link_index, L)
    A = B if distinct else 1
    src_sorted, order = torch.sort(src if distinct else src[None], dim=1, stable=True)
    work = torch.empty(max(1, segment_work_ints(A, V, E)), dtype=torch.int32, device=dev)
    T, layout, cap, smem, slice_bytes = batched_spf_layout(B, V, E, dev)
    grid = _resident_grid(B, dev, T, smem)
    scratch = torch.empty(max(1, grid * slice_bytes // 4), dtype=torch.int32, device=dev)
    dist = torch.empty((B, V), dtype=torch.float32, device=dev)
    nh = torch.empty((B, V, D), dtype=torch.int8, device=dev)
    # the layout's and the fill's blocks: as many as the card holds at
    # once, at most one per FILL_THREADS 16-byte words of the table
    fill_grid = _resident_grid(max(1, -(-B * V * D // (16 * FILL_THREADS))), dev, FILL_THREADS)
    fn = function("spf_warm", "openr_batched_spf", BATCHED_SPF_ARGTYPES)
    opt = lambda t: None if t is None else ptr(t)  # noqa: E731
    args = (
        ptr(src_sorted), ptr(order), ptr(dst), ptr(w), ptr(edge_ok), ptr(overloaded),
        ptr(roots), opt(edge_enabled), opt(failed), opt(link_off), opt(link_edges), ptr(work),
        ptr(dist), ptr(nh), ptr(scratch), layout, grid, fill_grid, T, B, A, V, E, D, S, L, cap,
        BIG, stream(dev),
    )

    # the default argument keeps the sorted edges, the derived layouts and
    # the scratch alive
    def launch(_held=(src_sorted, order, work, link_off, link_edges, scratch, failed)) -> None:
        if B == 0:
            return
        check_launch("batched_spf", fn(*args))
        LAUNCHES["batched_spf"] += 1

    return launch, (dist, nh)


def batched_spf(src, dst, w, edge_ok, edge_enabled, overloaded, roots, max_degree: int):
    """(dist [B, V], nh [B, V, D]) of every what-if snapshot (shared edge
    list, per-row mask, hard drains and root): kernel 16 for CUDA tensors,
    the plain version for CPU tensors."""
    if src.device.type == "cpu":
        return batched_spf_plain(
            src, dst, w, edge_ok, edge_enabled, overloaded, roots, max_degree
        )
    return _launched(
        batched_spf_launcher, src, dst, w, edge_ok, overloaded, roots, max_degree, edge_enabled
    )


def batched_spf_link_failures(
    src, dst, w, edge_ok, link_index, failed_link, overloaded, roots, max_degree: int
):
    """The single-link-failure sweep with the mask expanded on the device:
    row b fails ``failed_link[b]`` (-1: none).  Kernel 16 in its set form
    (S = 1; a -1 masks nothing there, where the reference's rule masks the
    pad edges, which are never usable) for CUDA tensors, the plain version
    for CPU tensors."""
    if src.device.type == "cpu":
        return batched_spf_link_failures_plain(
            src, dst, w, edge_ok, link_index, failed_link, overloaded, roots, max_degree
        )
    return _launched(
        batched_spf_launcher, src, dst, w, edge_ok, overloaded, roots, max_degree, None,
        link_index, failed_link[:, None].contiguous(),
    )


def batched_spf_distinct(src, dst, w, edge_ok, overloaded, roots, max_degree: int):
    """Fully distinct topologies per row (``[B, E]`` edge lists, padded to
    a common E): kernel 16 for CUDA tensors, the plain version for CPU
    tensors."""
    if src.device.type == "cpu":
        return batched_spf_distinct_plain(src, dst, w, edge_ok, overloaded, roots, max_degree)
    return _launched(
        batched_spf_launcher, src, dst, w, edge_ok, overloaded, roots, max_degree
    )
