"""Per-area SPF tables and multi-area best-route selection — the
counterpart of ``openr_tpu/ops/route_select.py``'s
``multi_area_spf_tables``, ``multi_area_spf_tables_dense``,
``multi_area_select_from_tables``, ``multi_area_select_delta_from_tables``,
``gather_selection_rows`` and the single-area chain ``select_routes_one``
(the what-if sweep's selection), plus the selection batched over vantage
roots or failure snapshots (``fleet_select``, the vmap the reference's
``ops/fleet_tables.py`` runs), the single-area chain batched over
what-if snapshots with per-snapshot drains and roots
(``batched_select_routes``) and the flagship step ``spf_and_select``
(its warm table builders, ``warm_multi_area_spf_tables`` and
``warm_multi_area_subgraph_tables``, are ``ops/spf.py``'s
``warm_spf_one`` and ``warm_subgraph_repair``: one call over all areas).

Selection implements SpfSolver's per-prefix semantics
(SpfSolver.cpp:161-312, 456-556; LsdbUtil.cpp:761-823) over [P] prefix
rows × [C] candidate advertisements, given each area's SPF tables from
me (dist [A, V], nexthop lanes [A, V, D]):

  1. reachability filter (candidate node reached by SPF in its own area)
  2. hard-drain filter with all-drained fallback (filterHardDrainedNodes)
  3. metric chain: NOT drained (drain_metric or node soft-drained)
     ▸ higher path_preference ▸ higher source_preference
  4. SHORTEST_DISTANCE on metrics.distance, globally or per area
  5. per area (only areas holding a winner advertisement): the min SPF
     metric over the winners' node names, and the union of the min-cost
     winners' first-hop lanes

The host does skip-if-self, the min-nexthop gate and the cross-area
min-metric merge during decode.  The delta variant also diffs every row
against the previous generation's outputs, so a full rebuild moves only
the changed rows to the host, gathered by ``gather_selection_rows``.  The
selections and the gather dispatch on the device of their inputs: the
hand-written kernel (``kernels/csrc/route_select.cu``: the selection and
the delta are kernel 13's tile body at one batch row, the delta with a
per-row diff; the gather its own) for CUDA tensors, the plain version for
CPU tensors, never a fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Tuple

import torch

from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.kernels.build import (
    check_launch,
    check_tensor,
    function,
    ptr,
    sm_count,
    stream,
)
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.spf import _row_chunks, batched_spf, dense_spf_one, spf_one

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1

#: the kernel holds a row's candidate sets as 64-bit masks
MAX_KERNEL_CANDIDATES = 64

#: prefix rows per block (tile) of kernels 13 and 3; None: by the rule of
#: :func:`fleet_select_tile_rows`
SELECT_TILE_ROWS = None

#: a kernel-17 block's dynamic shared memory (``kBatchedSmemMax`` in
#: ``kernels/csrc/sweep_select.cu``), which its tile's stage must fit
BATCHED_SELECT_SMEM = 232448

#: the ctypes argument types of the C entry points of this module's
#: kernels (``openr_<name>``), in order: pointers (and the stream) as
#: c_void_p, then the ints and BIG
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MULTI_AREA_SELECT_ARGTYPES = [_P] * 16 + [_I] * 7 + [_F, _P]
MULTI_AREA_SELECT_DELTA_ARGTYPES = [_P] * 22 + [_I] * 7 + [_F, _P]
FLEET_SELECT_ARGTYPES = [_P] * 21 + [_I] * 8 + [_F, _P]
BATCHED_SELECT_ROUTES_ARGTYPES = [_P] * 17 + [_I] * 6 + [_F, _P]
GATHER_SELECTION_ROWS_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]


def select_routes_one(
    cand_node,  # [P, C] int32
    cand_ok,  # [P, C] bool
    drain_metric,  # [P, C] int32
    path_pref,  # [P, C] int32
    source_pref,  # [P, C] int32
    distance,  # [P, C] int32
    min_nexthop,  # [P, C] int32 (0 = no requirement)
    dist,  # [..., V] f32 SPF distances from the root
    nh,  # [..., V, D] int8 first-hop lanes from the root
    overloaded,  # [V] bool, or [..., V] per snapshot
    soft,  # [V] int32 node soft-drain increments, or [..., V]
    root,  # int, or an int tensor broadcastable to [..., P, C]
):
    """The single-area selection chain (the reference's
    ``select_routes_one``, SpfSolver.cpp:161-312) for one snapshot, or a
    batch of snapshots along leading axes of ``dist`` / ``nh`` (and, per
    snapshot, of ``overloaded`` / ``soft`` and ``root``): reach ▸
    hard-drain with fallback ▸ not drained ▸ path_pref ▸ source_pref ▸
    min distance ▸ skip-if-self ▸ igp-tie ECMP lane union (a max of the
    winners' lanes) ▸ min-nexthop gate.  Plain PyTorch: the what-if
    sweep's selection kernel (``ops/sweep_select.py``) runs this chain per
    snapshot.  Returns (valid [..., P], metric [..., P] f32, nexthops
    [..., P, D] int8, num_nexthops [..., P], use [..., P, C])."""
    cn = cand_node.long()
    cdist = dist[..., cn]  # [..., P, C]
    reach = cand_ok & (cdist < BIG)
    hard = overloaded[..., cn]
    nonhard = reach & ~hard
    use = torch.where(nonhard.any(dim=-1, keepdim=True), nonhard, reach)
    drained = (drain_metric > 0) | (soft[..., cn] > 0)
    not_drained = (~drained).to(torch.int32)

    def keep_max(mask, key):
        best = torch.where(mask, key, I32_MIN).amax(dim=-1, keepdim=True)
        return mask & (key == best)

    def keep_min(mask, key):
        best = torch.where(mask, key, I32_MAX).amin(dim=-1, keepdim=True)
        return mask & (key == best)

    use = keep_max(use, not_drained)
    use = keep_max(use, path_pref)
    use = keep_max(use, source_pref)
    use = keep_min(use, distance)
    self_wins = (use & (cand_node == root)).any(dim=-1)
    best_igp = torch.where(use, cdist, BIG).amin(dim=-1)  # [..., P]
    winners = use & (cdist == best_igp[..., None])
    cand_nh = nh[..., cn, :]  # [..., P, C, D]
    zero = torch.zeros((), dtype=torch.int8, device=nh.device)
    nh_out = torch.where(winners[..., None], cand_nh, zero).amax(dim=-2)
    num_nh = nh_out.to(torch.int32).sum(dim=-1)
    req = torch.where(use, min_nexthop, 0).amax(dim=-1)
    valid = (
        winners.any(dim=-1)
        & ~self_wins
        & (best_igp < BIG)
        & (num_nh > 0)
        & (num_nh >= req)
    )
    return valid, best_igp, nh_out, num_nh, use


def multi_area_spf_tables_dense(
    in_src,  # [A, V, K] dense in-edge sources (ops/csr.py)
    in_w,  # [A, V, K]
    in_ok,  # [A, V, K]
    in_rank,  # [A, V, K] out-edge rank of each in-edge (-1 = none)
    in_has,  # [A, V]
    overloaded,  # [A, V]
    roots,  # [A]
    max_degree: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-area SPF from me → (dist [A, V] f32, nh [A, V, D] int8)."""
    return dense_spf_one(
        in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree
    )


def multi_area_spf_tables(
    src,  # [A, E] per-area dst-sorted edge lists (padded to common buckets)
    dst,  # [A, E]
    w,  # [A, E]
    edge_ok,  # [A, E]
    overloaded,  # [A, V]
    roots,  # [A] my node id in each area
    max_degree: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-area SPF from me over the segment form (encodings that decline
    the dense layout, and the multi-area what-if's base) → (dist [A, V]
    f32, nh [A, V, D] int8), bit-equal to the dense tables where both
    exist."""
    return spf_one(src, dst, w, edge_ok, overloaded, roots, max_degree)


def multi_area_select_from_tables_plain(
    dist,  # [A, V] SPF distances from me, per area
    nh,  # [A, V, D] first-hop lane sets from me, per area
    overloaded,  # [A, V]
    soft,  # [A, V]
    cand_area,  # [P, C] int32 area index of each candidate advertisement
    cand_node,  # [P, C] int32 node id in the candidate's OWN area
    cand_ok,  # [P, C] bool
    drain_metric,  # [P, C] int32
    path_pref,  # [P, C] int32
    source_pref,  # [P, C] int32
    distance,  # [P, C] int32
    cand_node_in_area,  # [P, C, A] int32 (-1 = absent from that area)
    per_area_distance: bool,  # PER_AREA_SHORTEST_DISTANCE algorithm
):
    """Returns (use [P, C] bool, shortest [P, A] f32, lanes [P, A, D]
    bool, valid [P, A] bool)."""
    A = dist.shape[0]
    dev = dist.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    ca = cand_area.long()
    cn = cand_node.long()

    # global best-route selection chain (LsdbUtil.cpp:761-823)
    cdist_own = dist[ca, cn]  # [P, C] metric in own area
    reach = cand_ok & (cdist_own < big)
    hard = overloaded[ca, cn]
    nonhard = reach & ~hard
    use = torch.where(nonhard.any(dim=1, keepdim=True), nonhard, reach)
    drained = (drain_metric > 0) | (soft[ca, cn] > 0)
    not_drained = (~drained).to(torch.int32)

    def keep_max(mask, key):
        fill = torch.tensor(I32_MIN, dtype=key.dtype, device=dev)
        best = torch.where(mask, key, fill).amax(dim=1, keepdim=True)
        return mask & (key == best)

    use = keep_max(use, not_drained)
    use = keep_max(use, path_pref)
    use = keep_max(use, source_pref)
    imax = torch.tensor(I32_MAX, dtype=distance.dtype, device=dev)
    if per_area_distance:
        # min distance within each area's surviving candidates
        same = ca[:, :, None] == ca[:, None, :]  # [P, C, C]
        key = torch.where(use[:, None, :] & same, distance[:, None, :], imax)
        use = use & (distance == key.amin(dim=2))
    else:
        best = torch.where(use, distance, imax).amin(dim=1, keepdim=True)
        use = use & (distance == best)

    # per-area nexthop lane sets over the winner node names — only in
    # areas that contain a winner ADVERTISEMENT (areas_with_best,
    # SpfSolver.cpp:276-283)
    area_ids = torch.arange(A, device=dev)
    area_has_winner = (use[:, :, None] & (ca[:, :, None] == area_ids)).any(dim=1)
    cnia_ok = cand_node_in_area >= 0  # [P, C, A]
    cnia = cand_node_in_area.clamp(min=0).long()
    ddist = dist[area_ids[None, None, :], cnia]  # [P, C, A]
    dmask = use[:, :, None] & cnia_ok & (ddist < big) & area_has_winner[:, None, :]
    shortest = torch.where(dmask, ddist, big).amin(dim=1)  # [P, A]
    mc = dmask & (ddist == shortest[:, None, :])  # [P, C, A] min-cost dsts
    # the reference's einsum(mc, nh) > 0: a SUM over min-cost winners (an
    # int8 -128 fill row cancels), kept exact in int32
    nh_g = nh[area_ids[None, None, :], cnia]  # [P, C, A, D]
    hits = (mc[..., None].to(torch.int32) * nh_g.to(torch.int32)).sum(dim=1)
    lanes = hits > 0  # [P, A, D]
    valid = mc.any(dim=1) & (lanes.sum(dim=2) > 0)
    return use, shortest, lanes, valid


def _check_select(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area,
):
    """Check the selection inputs (dist [..., A, V] and nh [..., A, V, D]
    with any leading batch axes); returns (P, C, A, V, D)."""
    dev = dist.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    A, V = dist.shape[-2:]
    D = nh.shape[-1]
    P, C = cand_area.shape
    if C > MAX_KERNEL_CANDIDATES:
        raise ValueError(f"{C} candidates exceed the kernel's {MAX_KERNEL_CANDIDATES}")
    lead = tuple(dist.shape[:-2])
    check_tensor("dist", dist, torch.float32, (*lead, A, V), dev)
    check_tensor("nh", nh, torch.int8, (*lead, A, V, D), dev)
    check_tensor("overloaded", overloaded, torch.bool, (A, V), dev)
    check_tensor("soft", soft, torch.int32, (A, V), dev)
    for name, t in (("cand_area", cand_area), ("cand_node", cand_node),
                    ("drain_metric", drain_metric), ("path_pref", path_pref),
                    ("source_pref", source_pref), ("distance", distance)):
        check_tensor(name, t, torch.int32, (P, C), dev)
    check_tensor("cand_ok", cand_ok, torch.bool, (P, C), dev)
    check_tensor("cand_node_in_area", cand_node_in_area, torch.int32, (P, C, A), dev)
    return P, C, A, V, D


def _select_operands(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area,
):
    """Check the selection inputs and allocate the four outputs; returns
    ((P, C, A, V, D), the input pointers, the output tensors)."""
    if dist.dim() != 2:
        raise ValueError(f"dist must be [A, V], got {tuple(dist.shape)}")
    P, C, A, V, D = _check_select(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
    )
    dev = dist.device
    outs = (
        torch.empty((P, C), dtype=torch.bool, device=dev),
        torch.empty((P, A), dtype=torch.float32, device=dev),
        torch.empty((P, A, D), dtype=torch.bool, device=dev),
        torch.empty((P, A), dtype=torch.bool, device=dev),
    )
    ins = (dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
           drain_metric, path_pref, source_pref, distance, cand_node_in_area)
    return (P, C, A, V, D), tuple(ptr(t) for t in ins), outs


def multi_area_select_from_tables_launcher(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area, per_area_distance: bool,
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """Check the inputs, allocate the outputs and bind the kernel once.

    Returns ``(launch, (use, shortest, lanes, valid))``: each ``launch()``
    enqueues the kernel on the current stream (no synchronize), writes the
    four outputs and counts one launch.  The kernel is kernel 13's at one
    batch row: a block per tile of :func:`fleet_select_tile_rows` prefix
    rows (at most 256)."""
    dims, ins, outs = _select_operands(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
    )
    P, _C, A, _V, _D = dims
    sms = sm_count(dist.device)
    fn = function("route_select", "openr_multi_area_select", MULTI_AREA_SELECT_ARGTYPES)
    args = (*ins, *(ptr(o) for o in outs), *dims, int(bool(per_area_distance)),
            fleet_select_tile_rows(1, P, A, sms, most=256), BIG, stream(dist.device))

    def launch() -> None:
        if dims[0] == 0:
            return
        check_launch("multi_area_select_from_tables", fn(*args))
        LAUNCHES["multi_area_select_from_tables"] += 1

    return launch, outs


def multi_area_select_from_tables_cuda(*args):
    launch, outs = multi_area_select_from_tables_launcher(*args)
    launch()
    return outs


def multi_area_select_from_tables(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area, per_area_distance: bool,
):
    """Multi-area buildRouteDb selection: GLOBAL across areas
    (SpfSolver.cpp:456-495), per-area ECMP lane sets back separately for
    the host's cross-area min-metric merge.  Row-independent over P.

    Returns (use [P, C], shortest [P, A], lanes [P, A, D], valid [P, A])."""
    args = (
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
        per_area_distance,
    )
    if dist.device.type == "cpu":
        return multi_area_select_from_tables_plain(*args)
    return multi_area_select_from_tables_cuda(*args)


# ---------------------------------------------------------------------------
# fused selection + generation delta
# ---------------------------------------------------------------------------


def multi_area_select_delta_from_tables_plain(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area,
    prev_use,  # [P, C] previous generation's selection outputs
    prev_shortest,  # [P, A]
    prev_lanes,  # [P, A, D]
    prev_valid,  # [P, A]
    node_changed,  # [A, V] bool: nodes whose drain inputs moved
    per_area_distance: bool,
):
    """Selection, then a per-row diff against the previous generation's
    outputs, OR rows whose candidates touch a node in ``node_changed``
    (own-area cell and every area's resolution, cand_ok slots only):
    decode wraps the winning entry from LinkState's drain lookups, so
    those rows re-decode even with identical outputs.  Returns (use,
    shortest, lanes, valid, changed [P] bool)."""
    use, shortest, lanes, valid = multi_area_select_from_tables_plain(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
        per_area_distance,
    )
    changed = (
        (use != prev_use).any(dim=1)
        | (valid != prev_valid).any(dim=1)
        | (shortest != prev_shortest).any(dim=1)
        | (lanes != prev_lanes).any(dim=2).any(dim=1)
    )
    touch_own = (node_changed[cand_area.long(), cand_node.long()] & cand_ok).any(dim=1)
    A = dist.shape[0]
    a_idx = torch.arange(A, device=dist.device)[None, None, :]
    cnia_ok = (cand_node_in_area >= 0) & cand_ok[:, :, None]
    touch_x = (
        cnia_ok & node_changed[a_idx, cand_node_in_area.clamp(min=0).long()]
    ).any(dim=2).any(dim=1)
    return use, shortest, lanes, valid, changed | touch_own | touch_x


def multi_area_select_delta_from_tables_launcher(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area, prev_use,
    prev_shortest, prev_lanes, prev_valid, node_changed,
    per_area_distance: bool,
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """As :func:`multi_area_select_from_tables_launcher`, for the fused
    select + diff kernel: ``(launch, (use, shortest, lanes, valid,
    changed))``.  The kernel is kernel 3's tile body with a flag a row:
    tiles of :func:`fleet_select_tile_rows` rows (at most 256)."""
    dims, ins, outs = _select_operands(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
    )
    P, C, A, V, D = dims
    dev = dist.device
    check_tensor("prev_use", prev_use, torch.bool, (P, C), dev)
    check_tensor("prev_shortest", prev_shortest, torch.float32, (P, A), dev)
    check_tensor("prev_lanes", prev_lanes, torch.bool, (P, A, D), dev)
    check_tensor("prev_valid", prev_valid, torch.bool, (P, A), dev)
    check_tensor("node_changed", node_changed, torch.bool, (A, V), dev)
    changed = torch.empty((P,), dtype=torch.bool, device=dev)
    fn = function("route_select", "openr_multi_area_select_delta", MULTI_AREA_SELECT_DELTA_ARGTYPES)
    prev = (prev_use, prev_shortest, prev_lanes, prev_valid, node_changed)
    args = (*ins, *(ptr(o) for o in outs), *(ptr(t) for t in prev), ptr(changed),
            *dims, int(bool(per_area_distance)),
            fleet_select_tile_rows(1, P, A, sm_count(dev), most=256), BIG, stream(dev))

    def launch() -> None:
        if P == 0:
            return
        check_launch("multi_area_select_delta_from_tables", fn(*args))
        LAUNCHES["multi_area_select_delta_from_tables"] += 1

    return launch, (*outs, changed)


def multi_area_select_delta_from_tables(*args):
    """Fused selection + on-device generation delta: (use, shortest,
    lanes, valid, changed [P]); the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if args[0].device.type == "cpu":
        return multi_area_select_delta_from_tables_plain(*args)
    launch, outs = multi_area_select_delta_from_tables_launcher(*args)
    launch()
    return outs


def gather_selection_rows_plain(use, shortest, lanes, valid, idx):
    """Rows ``idx`` [G] of the four selection tables, a
    ``torch.index_select`` each."""
    return tuple(torch.index_select(a, 0, idx) for a in (use, shortest, lanes, valid))


def gather_selection_rows_launcher(
    use, shortest, lanes, valid, idx
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """Check the tables (contiguous, one leading row axis N, any row shape
    and dtype) and ``idx`` (int64 [G] on the same card), allocate the
    [G, ...] outputs and bind kernel 18 once: ``(launch, (use, shortest,
    lanes, valid))``.  Each ``launch()`` enqueues one kernel for all four
    tables (no synchronize; ``idx`` is never read back) and counts one
    launch; G = 0 launches nothing.  An index outside [0, N) writes its
    output row as zero bytes."""
    tables = (use, shortest, lanes, valid)
    dev = use.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    N = use.shape[0]
    # the checks a gather needs, lighter than check_tensor's: a call's host
    # time is most of its cost at the delta build's few rows
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.device != dev or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous int64 vector on {dev}")
    for name, t in zip(("use", "shortest", "lanes", "valid"), tables):
        if t.device != dev or t.dim() == 0 or t.shape[0] != N or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous table of {N} rows on {dev}")
    G = idx.shape[0]
    row_bytes = [math.prod(t.shape[1:]) * t.element_size() for t in tables]
    if max(G, N, *row_bytes) > I32_MAX:
        raise ValueError(f"G {G}, N {N} or a row of {max(row_bytes)} bytes exceeds the kernel's int32")
    outs = tuple(torch.empty((G, *t.shape[1:]), dtype=t.dtype, device=dev) for t in tables)
    fn = function("route_select", "openr_gather_selection_rows", GATHER_SELECTION_ROWS_ARGTYPES)
    args = (*(ptr(t) for t in tables), *(ptr(o) for o in outs), ptr(idx), G, N, *row_bytes,
            stream(dev))

    def launch() -> None:
        if G == 0:
            return
        check_launch("gather_selection_rows", fn(*args))
        LAUNCHES["gather_selection_rows"] += 1

    return launch, outs


def gather_selection_rows(use, shortest, lanes, valid, idx):
    """Compaction of the changed selection rows ``idx`` [G] (int64): the
    rows of each table as :func:`gather_selection_rows_plain` gives them,
    kernel 18 for CUDA tensors (one launch), the plain version for CPU
    tensors."""
    if use.device.type == "cpu":
        return gather_selection_rows_plain(use, shortest, lanes, valid, idx)
    launch, outs = gather_selection_rows_launcher(use, shortest, lanes, valid, idx)
    launch()
    return outs


# ---------------------------------------------------------------------------
# selection batched over vantage roots or failure snapshots (kernel 13)
# ---------------------------------------------------------------------------


def fleet_select_plain(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area, per_area_distance: bool,
    prev_use=None, prev_shortest=None, prev_lanes=None, prev_valid=None,
):
    """The selection of :func:`multi_area_select_from_tables` for every
    batch row b of dist [B, A, V] / nh [B, A, V, D], the candidate tables
    shared (the reference's vmap, one row at a time).  Returns (use
    [B, P, C], shortest [B, P, A], lanes [B, P, A, D], valid [B, P, A]),
    plus changed [B] when the previous generation's ``prev_*`` [B, ...]
    are given: some output of the row's P rows differs."""
    cand = (cand_area, cand_node, cand_ok, drain_metric, path_pref,
            source_pref, distance, cand_node_in_area)
    rows = [
        multi_area_select_from_tables_plain(
            dist[b], nh[b], overloaded, soft, *cand, per_area_distance
        )
        for b in range(dist.shape[0])
    ]
    outs = tuple(torch.stack(parts) for parts in zip(*rows))
    if prev_use is None:
        return outs
    changed = torch.zeros(dist.shape[0], dtype=torch.bool, device=dist.device)
    for now, prev in zip(outs, (prev_use, prev_shortest, prev_lanes, prev_valid)):
        changed |= (now != prev).flatten(1).any(dim=1)
    return (*outs, changed)


def fleet_select_tile_rows(B: int, P: int, A: int, sms: int, most: int = 128) -> int:
    """Prefix rows per block of kernel 13, or of kernel 3 (``most`` 256:
    at one batch row the grid build's tiles of 256 were 7 % faster than
    of 128, PERF.md) where ``SELECT_TILE_ROWS`` is not set: the
    most, up to ``most``, whose winner masks and lane flags
    (``fleet_select_smem``: 8 bytes a row and 12 a (row, area) pair) fit
    24 KiB, halved (not below 16) while the B * ceil(P / rows) blocks would
    give the card's ``sms`` SMs fewer than 4 each, and at most P."""
    if SELECT_TILE_ROWS is not None:
        rows = int(SELECT_TILE_ROWS)
    else:
        rows = min(most, max(1, 24576 // (8 + 12 * A)))
        while rows > 16 and B * -(-P // rows) < 4 * sms:
            rows //= 2
    return max(1, min(rows, P))


def fleet_select_launcher(
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, cand_node_in_area, per_area_distance: bool,
    prev_use=None, prev_shortest=None, prev_lanes=None, prev_valid=None,
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """As :func:`multi_area_select_from_tables_launcher`, for kernel 13:
    ``(launch, (use, shortest, lanes, valid))``, and ``changed`` [B] last
    when ``prev_*`` are given.  A block takes a tile of
    :func:`fleet_select_tile_rows` prefix rows of one batch row."""
    if dist.dim() != 3:
        raise ValueError(f"dist must be [B, A, V], got {tuple(dist.shape)}")
    B = dist.shape[0]
    P, C, A, V, D = _check_select(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
    )
    dev = dist.device
    outs = (
        torch.empty((B, P, C), dtype=torch.bool, device=dev),
        torch.empty((B, P, A), dtype=torch.float32, device=dev),
        torch.empty((B, P, A, D), dtype=torch.bool, device=dev),
        torch.empty((B, P, A), dtype=torch.bool, device=dev),
    )
    prev = (None, None, None, None)
    changed = None
    if prev_use is not None:
        prev = (prev_use, prev_shortest, prev_lanes, prev_valid)
        for name, t, like in zip(("prev_use", "prev_shortest", "prev_lanes", "prev_valid"),
                                 prev, outs):
            check_tensor(name, t, like.dtype, like.shape, dev)
        changed = torch.empty((B,), dtype=torch.bool, device=dev)
    rows = fleet_select_tile_rows(B, P, A, sm_count(dev))
    fn = function("route_select", "openr_fleet_select", FLEET_SELECT_ARGTYPES)
    ins = (dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
           drain_metric, path_pref, source_pref, distance, cand_node_in_area)
    args = (
        *(ptr(t) for t in ins), *(ptr(o) for o in outs),
        *(None if t is None else ptr(t) for t in (*prev, changed)),
        B, P, C, A, V, D, int(bool(per_area_distance)), rows, BIG, stream(dev),
    )

    def launch() -> None:
        if B == 0:
            return
        check_launch("fleet_select", fn(*args))
        LAUNCHES["fleet_select"] += 1

    return launch, outs if changed is None else (*outs, changed)


def fleet_select(*args, **kwargs):
    """Kernel 13 for CUDA tensors, the plain version for CPU tensors (see
    :func:`fleet_select_plain`)."""
    if args[0].device.type == "cpu":
        return fleet_select_plain(*args, **kwargs)
    launch, outs = fleet_select_launcher(*args, **kwargs)
    launch()
    return outs


# ---------------------------------------------------------------------------
# The single-area chain per what-if snapshot (kernel 17) and the flagship
# step — the counterpart of the reference's ``batched_select_routes``
# (``ops/route_select.py:112``) and ``spf_and_select`` (``:449``).  The
# candidate tables [P, C] are shared; row b reads its own SPF tables
# dist [B, V] / nh [B, V, D] int8, hard drains ``overloaded[b]``, soft
# drains ``soft[b]`` and root ``roots[b]``.
# ---------------------------------------------------------------------------


def batched_select_routes_plain(
    cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop,
    dist, nh, overloaded, soft, roots,
):
    """:func:`select_routes_one` for every row, with the row's drains and
    root, over row chunks.  Returns (valid [B, P] bool, metric [B, P] f32,
    nh [B, P, D] int8, num_nexthops [B, P] int32, use [B, P, C] bool)."""
    B = dist.shape[0]
    P, C = cand_node.shape
    D = nh.shape[-1]
    cand = (cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop)
    parts = [
        select_routes_one(
            *cand, dist[r0:r1], nh[r0:r1], overloaded[r0:r1], soft[r0:r1],
            roots[r0:r1].view(-1, 1, 1),
        )
        for r0, r1 in list(_row_chunks(B, P * C * D)) or [(0, 0)]
    ]
    valid, metric, nh_out, num, use = (torch.cat(x) for x in zip(*parts))
    return valid, metric, nh_out, num.to(torch.int32), use


def batched_select_stage_bytes(TP: int, C: int, D: int) -> int:
    """A kernel-17 block's lane and use stages for TP prefixes
    (``batched_layout``: each region 16 bytes past its data, rounded up to
    16)."""
    return ((TP * D + 31) & ~15) + ((TP * C + 31) & ~15)


def batched_select_tile_rows(B: int, P: int, C: int, D: int, sms: int) -> int:
    """Prefixes per block of kernel 17: a whole row of P where its lane
    and use stage (D + C bytes a prefix) fits 48 KiB and the B * ceil(P /
    rows) blocks give the card's ``sms`` SMs 4 each, else P halved
    (rounded up) until both hold or 32 is reached; below 32 it is halved
    further only while the stage does not fit ``BATCHED_SELECT_SMEM``
    (wide lanes: at D 8,192 a tile of 28)."""
    rows = max(P, 1)
    while rows > 1 and (
        batched_select_stage_bytes(rows, C, D) > BATCHED_SELECT_SMEM
        or rows > 32 and (rows * (D + C) > 49152 or B * -(-P // rows) < 4 * sms)
    ):
        rows = -(-rows // 2)
    return rows


def batched_select_routes_launcher(
    cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop,
    dist, nh, overloaded, soft, roots,
) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """Check the inputs, allocate the five outputs and bind kernel 17
    (``kernels/csrc/sweep_select.cu``) once: ``(launch, (valid, metric,
    nh, num_nexthops, use))``, each ``launch()`` enqueueing the kernel (no
    synchronize) and counting one launch.  A block takes a tile of
    :func:`batched_select_tile_rows` prefixes of one row; a prefix's D
    lane and C use bytes must fit ``BATCHED_SELECT_SMEM``."""
    dev = dist.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    if dist.dim() != 2:
        raise ValueError(f"dist must be [B, V], got {tuple(dist.shape)}")
    B, V = dist.shape
    P, C = cand_node.shape
    D = nh.shape[-1]
    if not 1 <= C <= MAX_KERNEL_CANDIDATES:
        raise ValueError(f"{C} candidates: the kernel takes 1 to {MAX_KERNEL_CANDIDATES}")
    check_tensor("dist", dist, torch.float32, (B, V), dev)
    check_tensor("nh", nh, torch.int8, (B, V, D), dev)
    check_tensor("overloaded", overloaded, torch.bool, (B, V), dev)
    check_tensor("soft", soft, torch.int32, (B, V), dev)
    check_tensor("roots", roots, torch.int32, (B,), dev)
    cand = (cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop)
    for name, t in zip(("cand_node", "cand_ok", "drain_metric", "path_pref",
                        "source_pref", "distance", "min_nexthop"), cand):
        check_tensor(name, t, torch.bool if name == "cand_ok" else torch.int32, (P, C), dev)
    outs = (
        torch.empty((B, P), dtype=torch.bool, device=dev),
        torch.empty((B, P), dtype=torch.float32, device=dev),
        torch.empty((B, P, D), dtype=torch.int8, device=dev),
        torch.empty((B, P), dtype=torch.int32, device=dev),
        torch.empty((B, P, C), dtype=torch.bool, device=dev),
    )
    rows = batched_select_tile_rows(B, P, C, D, sm_count(dev))
    if batched_select_stage_bytes(rows, C, D) > BATCHED_SELECT_SMEM:
        raise ValueError(f"{D} lanes and {C} candidates a prefix exceed the kernel's "
                         f"{BATCHED_SELECT_SMEM} bytes of shared memory")
    fn = function("sweep_select", "openr_batched_select_routes", BATCHED_SELECT_ROUTES_ARGTYPES)
    args = (
        *(ptr(t) for t in (dist, nh, overloaded, soft, roots, *cand)),
        *(ptr(o) for o in outs), B, V, P, C, D, rows, BIG, stream(dev),
    )

    def launch() -> None:
        if B == 0 or P == 0:
            return
        check_launch("batched_select_routes", fn(*args))
        LAUNCHES["batched_select_routes"] += 1

    return launch, outs


def batched_select_routes(
    cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop,
    dist, nh, overloaded, soft, roots,
):
    """The single-area chain for every what-if snapshot: kernel 17 for
    CUDA tensors, the plain version for CPU tensors.  Returns (valid,
    metric, nh, num_nexthops, use) with a leading [B] axis."""
    args = (cand_node, cand_ok, drain_metric, path_pref, source_pref, distance,
            min_nexthop, dist, nh, overloaded, soft, roots)
    if dist.device.type == "cpu":
        return batched_select_routes_plain(*args)
    launch, outs = batched_select_routes_launcher(*args)
    launch()
    return outs


def spf_and_select(
    src, dst, w, edge_ok,
    edge_enabled,  # [B, E] per-snapshot what-if mask
    overloaded,  # [B, V]
    soft,  # [B, V]
    roots,  # [B]
    cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop,
    max_degree: int,
):
    """The flagship what-if step: per-snapshot SPF (kernel 16), then the
    per-snapshot selection (kernel 17) on the same stream, the [B, V, D]
    tables staying on the device and no host sync between them (the plain
    versions for CPU tensors).  Returns (valid [B, P], metric [B, P],
    nh [B, P, D] int8, num_nexthops [B, P], use [B, P, C])."""
    dist, nh = batched_spf(src, dst, w, edge_ok, edge_enabled, overloaded, roots, max_degree)
    return batched_select_routes(
        cand_node, cand_ok, drain_metric, path_pref, source_pref, distance, min_nexthop,
        dist, nh, overloaded, soft, roots,
    )
