"""Batched multi-area tables: every vantage root, or every failure
snapshot, in one solve — the counterpart of
``openr_tpu/ops/fleet_tables.py``.

For each batch row, per-area SPF runs from the row's per-area root (-1:
the root does not take part in that area, and its whole area slice reads
unreachable: dist BIG, lanes 0, the scalar semantics of a node computing
SPF only where it has adjacencies), then the global multi-area selection
chain (``ops/route_select.py``) gives the row's winner sets, per-area
shortest metrics and ECMP lane sets, which the host decode turns into
RouteDbs.

Each function is two kernels, dispatched by the device of its inputs (the
plain PyTorch versions on the CPU, never a fallback on the card):

  * SPF: kernel 12 (``fleet_spf_dense``) over the dense in-edge planes, or
    kernel 14 (``spf_segment_batch``) over the segment form
  * selection: kernel 13 (``fleet_select``), with the per-row diff against
    the previous generation in the delta variant

The reference pads each root chunk to a power of two and each failure
batch to a bucket for its jit cache; here every batch takes its exact
size.
"""

from __future__ import annotations

from openr_tpu_torch.ops.route_select import fleet_select
from openr_tpu_torch.ops.spf import fleet_spf_dense, spf_segment_batch


def fleet_multi_area_tables(
    src,  # [A, E] dst-sorted edge lists
    dst,  # [A, E]
    w,  # [A, E]
    edge_ok,  # [A, E]
    overloaded,  # [A, V]
    soft,  # [A, V]
    roots,  # [B, A] int32: each root's id in each area, -1 = absent
    cand_area,  # [P, C]
    cand_node,  # [P, C]
    cand_ok,  # [P, C]
    drain_metric,  # [P, C]
    path_pref,  # [P, C]
    source_pref,  # [P, C]
    distance,  # [P, C]
    cand_node_in_area,  # [P, C, A]
    max_degree: int,
    per_area_distance: bool,
):
    """Per-root (use [B, P, C], shortest [B, P, A], lanes [B, P, A, D],
    valid [B, P, A]) over the segment form."""
    dist, nh = spf_segment_batch(src, dst, w, edge_ok, overloaded, roots, max_degree)
    return fleet_select(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
        per_area_distance,
    )


def fleet_multi_area_tables_dense(
    in_src,  # [A, V, K] dense in-edge planes (ops/csr.py)
    in_w,  # [A, V, K]
    in_ok,  # [A, V, K]
    in_rank,  # [A, V, K]
    in_has,  # [A, V]
    overloaded,  # [A, V]
    soft,  # [A, V]
    roots,  # [B, A]
    cand_area,
    cand_node,
    cand_ok,
    drain_metric,
    path_pref,
    source_pref,
    distance,
    cand_node_in_area,
    max_degree: int,
    per_area_distance: bool,
):
    """The dense twin of :func:`fleet_multi_area_tables`: the same
    outputs; the root-independent planes are shared by the batch."""
    dist, nh = fleet_spf_dense(in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree)
    return fleet_select(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
        per_area_distance,
    )


def fleet_multi_area_tables_dense_delta(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, soft, roots,
    cand_area, cand_node, cand_ok, drain_metric, path_pref, source_pref,
    distance, cand_node_in_area,
    prev_use,  # [B, P, C] the previous generation's chunk outputs
    prev_shortest,  # [B, P, A]
    prev_lanes,  # [B, P, A, D]
    prev_valid,  # [B, P, A]
    max_degree: int,
    per_area_distance: bool,
):
    """Fleet tables + on-device generation delta: (use, shortest, lanes,
    valid, changed [B] bool), changed[b] when any output of root b differs
    from the previous generation's, so the host fetches the mask and then
    only the changed roots' rows."""
    dist, nh = fleet_spf_dense(in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree)
    return fleet_select(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
        per_area_distance, prev_use=prev_use, prev_shortest=prev_shortest,
        prev_lanes=prev_lanes, prev_valid=prev_valid,
    )


def whatif_multi_area_tables(
    src,  # [A, E]
    dst,  # [A, E]
    w,  # [A, E]
    edge_ok,  # [A, E]
    link_index,  # [A, E] per-area undirected link ids (-1 pad)
    overloaded,  # [A, V]
    soft,  # [A, V]
    roots,  # [A] my id per area (me is interned into every area)
    fail_area,  # [B, S] int32 area index of each failed link (-1 = none)
    fail_link,  # [B, S] int32 link id within that area
    cand_area,  # [P, C]
    cand_node,  # [P, C]
    cand_ok,  # [P, C]
    drain_metric,  # [P, C]
    path_pref,  # [P, C]
    source_pref,  # [P, C]
    distance,  # [P, C]
    cand_node_in_area,  # [P, C, A]
    max_degree: int,
    per_area_distance: bool,
):
    """Multi-area link-failure what-if from one vantage: snapshot b masks
    its failed set (up to S links, -1 padded) in each member's own area,
    every other area solves unperturbed, and the global selection runs per
    snapshot.  Returns per-snapshot (use [B, P, C], shortest [B, P, A],
    lanes [B, P, A, D], valid [B, P, A])."""
    B = fail_area.shape[0]
    dist, nh = spf_segment_batch(
        src, dst, w, edge_ok, overloaded, roots[None].expand(B, -1).contiguous(),
        max_degree, link_index=link_index, fail_area=fail_area, fail_link=fail_link,
    )
    return fleet_select(
        dist, nh, overloaded, soft, cand_area, cand_node, cand_ok,
        drain_metric, path_pref, source_pref, distance, cand_node_in_area,
        per_area_distance,
    )
