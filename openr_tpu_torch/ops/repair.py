"""Generation-delta planning for the warm topology tick (host, numpy).

The counterpart of ``openr_tpu/ops/repair.py``'s ``GenerationDelta`` and
``plan_generation_delta``, copied (the port imports nothing of the JAX
package).  Given one area's previous encoding, its converged distances
and the new (patched) encoding, the planner classifies the delta and
returns what the warm SPF kernels need:

  * Bellman-Ford converges to the exact fixed point from ANY pointwise
    over-estimate with d[root] = 0.  A vertex keeps its old distance as
    an over-estimate unless some old shortest path to it crossed a
    removed-or-weakened edge; those vertices are the DAG descendants of
    the heads of perturbed on-DAG edges, and they are reset to BIG.
    Added/cheapened edges only lower true distances, so they need no
    reset.
  * Lanes are recomputed with RESET semantics (each round replaces a
    vertex's value), whose fixed point on the shortest-path DAG is
    unique, so any lane seed is safe; the old lanes are kept where the
    root's out-edge signature is unchanged (``lanes_compatible``).
  * For a PURE-WEAKENING delta (no improvement anywhere) nothing outside
    the reset set changes — neither distance nor lanes — so the bounded
    repair relaxes only the reset region's in-edges (``sub_edges``).

The second half of the module is the what-if sweep's warm repair (the
reference's ``RepairPlan``, ``build_repair_plan``, its content-hash cache,
``_repair_sweep_impl``, ``RepairSweep``, ``warm_base_from_previous`` and
``sort_by_depth``): B failure snapshots of one (topology, root), each
warm-started from the base solve with only the provably affected vertices
(base-DAG descendants of the failed edges' heads) reset, so the loops run
for the affected region's depth instead of the hop diameter.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.kernels.build import (
    check_launch,
    check_tensor,
    function,
    ptr,
    stream,
)
from openr_tpu_torch.ops.bits import pack_bits_last
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.spf import segment_offsets, segment_reduce

_BIGF = np.float32(BIG)
_INF = float("inf")


@dataclasses.dataclass
class GenerationDelta:
    """Host-planned warm-rebuild inputs for ONE area's topology delta."""

    #: [V] bool — vertices whose distance may have INCREASED (reset to BIG
    #: in the warm seed)
    reset: np.ndarray
    #: root out-edge signature unchanged: previous lanes are a valid warm
    #: init (reset semantics make any init safe; this only speeds
    #: convergence) and the bounded repair may keep them outside the reset
    lanes_compatible: bool
    #: BFS depth of the affected region on the old DAG (telemetry)
    est_depth: int
    num_reset: int
    num_perturbed_edges: int
    #: an ADDED or CHEAPENED edge (incl. overload clears / links up):
    #: distances may decrease outside the reset set, so the bounded
    #: repair is ineligible (the full-edge warm kernels still apply)
    has_improvements: bool
    #: positions (ascending, into the NEW topology's dst-sorted edge
    #: arrays) of every edge whose head is in the reset set — the bounded
    #: repair's whole working set
    sub_edges: np.ndarray


def _min_weight_edge_keys(topo, ok: np.ndarray, V: int):
    """(sorted int64 keys src*V+dst, min weight per key) over the enabled
    directed edges."""
    key = topo.src[ok].astype(np.int64) * V + topo.dst[ok].astype(np.int64)
    w = topo.w[ok].astype(np.float32)
    order = np.argsort(key, kind="stable")
    key = key[order]
    w = w[order]
    uniq, starts = np.unique(key, return_index=True)
    wmin = np.minimum.reduceat(w, starts) if len(key) else w
    return uniq, wmin


def plan_generation_delta(
    old_topo,
    root_id: int,
    old_dist: np.ndarray,
    new_topo,
    force_reset: Optional[np.ndarray] = None,
    trust_layout: bool = False,
) -> Optional[GenerationDelta]:
    """Classify one area's LSDB delta and plan the warm rebuild.

    Returns None when the delta is STRUCTURAL (different node symbol
    tables or padded node shape): the caller solves cold.  Link weight
    changes, link up/down, overload flips and parallel adjacencies are
    warm-eligible.  The descendant sweep is a frontier BFS over the old
    shortest-path DAG.

    ``trust_layout``: the caller has proven that both encodings share one
    layout (the new one was slot-patched from the old: the same src and
    link_index array objects), so the symbol tables are not compared and
    membership churn is warm-eligible.  ``force_reset`` ([V] bool) names
    the slots whose membership changed: they seed the reset BFS (a
    renamed slot's old distance says nothing of its new node), the root
    excepted."""
    if not trust_layout and new_topo.id_to_node != old_topo.id_to_node:
        return None
    V = old_topo.padded_nodes
    if new_topo.padded_nodes != V or old_dist.shape[0] != V:
        return None

    def transit_ok(topo):
        transit = (~topo.overloaded) | (np.arange(V) == root_id)
        return topo.edge_ok & transit[topo.src]

    old_ok = transit_ok(old_topo)
    new_ok = transit_ok(new_topo)
    old_keys, old_w = _min_weight_edge_keys(old_topo, old_ok, V)
    new_keys, new_w = _min_weight_edge_keys(new_topo, new_ok, V)
    # removed-or-weakened: an old (u, v) absent from the new map, or
    # present only at a strictly larger weight
    pos = np.searchsorted(new_keys, old_keys)
    pos_c = np.clip(pos, 0, max(len(new_keys) - 1, 0))
    survived = np.zeros(len(old_keys), bool)
    if len(new_keys):
        present = (pos < len(new_keys)) & (new_keys[pos_c] == old_keys)
        survived = present & (new_w[pos_c] <= old_w)
    perturbed = ~survived
    # improvements: an enabled (u, v) that is new, or cheaper than before
    opos = np.searchsorted(old_keys, new_keys)
    opos_c = np.clip(opos, 0, max(len(old_keys) - 1, 0))
    in_old = (
        (opos < len(old_keys)) & (old_keys[opos_c] == new_keys)
        if len(old_keys)
        else np.zeros(len(new_keys), bool)
    )
    has_improvements = bool(
        (~in_old).any()
        or (len(old_keys) and (new_w < old_w[opos_c])[in_old].any())
    )

    # the old shortest-path DAG
    reached = old_dist < _BIGF
    on_edge = (
        old_ok
        & reached[old_topo.dst]
        & (old_dist[old_topo.src] + old_topo.w == old_dist[old_topo.dst])
    )
    dag_src = old_topo.src[on_edge]
    dag_dst = old_topo.dst[on_edge]

    # reset seeds: heads of perturbed directed edges that were ON the old
    # DAG (an off-DAG removal changes nothing), and the forced slots
    seed = np.zeros(V, bool)
    if force_reset is not None:
        seed |= force_reset.astype(bool)
        seed[root_id] = False
    if perturbed.any():
        pk = old_keys[perturbed]
        dag_keys = dag_src.astype(np.int64) * V + dag_dst.astype(np.int64)
        seed[dag_dst[np.isin(dag_keys, pk)]] = True

    reset = np.zeros(V, bool)
    frontier = seed
    depth = 0
    while frontier.any():
        reset |= frontier
        depth += 1
        nxt = np.zeros(V, bool)
        hit = frontier[dag_src]
        if hit.any():
            nxt[dag_dst[hit]] = True
        frontier = nxt & ~reset
    reset[root_id] = False  # the root's distance is pinned at 0

    def lane_sig(topo):
        es = np.nonzero((topo.src == root_id) & (topo.link_index >= 0))[0]
        return [
            (int(topo.dst[e]), float(topo.w[e]), bool(topo.edge_ok[e]))
            for e in es
        ]

    return GenerationDelta(
        reset=reset,
        lanes_compatible=lane_sig(new_topo) == lane_sig(old_topo),
        est_depth=depth,
        num_reset=int(reset.sum()),
        num_perturbed_edges=int(perturbed.sum()),
        has_improvements=has_improvements,
        # ascending positions into the dst-sorted layout keep the
        # gathered sub-edge list dst-sorted (the kernels' segments rely
        # on it)
        sub_edges=np.nonzero(reset[new_topo.dst])[0].astype(np.int32),
    )


# ---------------------------------------------------------------------------
# What-if sweep: host-side planning (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RepairPlan:
    """Per-(topology, root) constants for the repair sweep."""

    root_id: int
    lanes: int  # number of root-out edges == lane count
    vw: int  # ceil(V/32) descendant-bitset words
    #: [L, vw] uint32 — affected-vertex bitset per undirected link (a zero
    #: row: failing this link cannot change the SPF result)
    aff_link_words: np.ndarray
    #: [L] int32 — upper bound on repair rounds per link (sort key)
    repair_depth: np.ndarray
    #: [L] bool — link has a directed edge on the base DAG
    on_dag_link: np.ndarray
    # pull-mode lane tables (static per topology+root)
    din: int
    nbr_flat: np.ndarray  # [V*Din] int32 in-neighbor per pull slot
    pull_perm: np.ndarray  # [V*Din] int32 edge position per pull slot
    pull_valid: np.ndarray  # [V*Din] bool
    nbr_is_root: np.ndarray  # [V*Din] bool
    # seed scatter: pull slots whose in-neighbor is the root
    seed_v: np.ndarray  # [S] int32 dst node
    seed_r: np.ndarray  # [S] int32 lane rank
    seed_slot: np.ndarray  # [S] int32 pull-slot index
    # base solution
    base_dist: np.ndarray  # [V] float32
    base_nh: np.ndarray  # [V, lanes] int8
    transit_src_ok: np.ndarray  # [E] bool


def build_repair_plan(topo, root_id: int, base_dist: np.ndarray,
                      base_nh: np.ndarray, pull_tables=None) -> RepairPlan:
    """Host-side planner.  ``base_nh`` is dense [V, >=lanes] int8 from the
    base solve (columns beyond the root's out-degree are dropped);
    ``pull_tables`` reuses a :func:`build_pull_tables` result (they are
    base-independent)."""
    V = topo.padded_nodes
    src, dst, w = topo.src, topo.dst, topo.w
    edge_ok, link_index = topo.edge_ok, topo.link_index
    L = len(topo.links)
    vw = (V + 31) // 32

    transit = (~topo.overloaded) | (np.arange(V) == root_id)
    transit_src_ok = edge_ok & transit[src]

    # base shortest-path DAG (LinkState.cpp:747-800 semantics)
    reached = base_dist < _BIGF
    on_edge = (
        transit_src_ok & reached[dst] & (base_dist[src] + w == base_dist[dst])
    )
    dag_e = np.nonzero(on_edge)[0]
    dag_src = src[dag_e]
    dag_dst = dst[dag_e]

    # hop level: max hops over shortest paths (monotone fixed point over
    # the DAG edges)
    level = np.zeros(V, np.int32)
    while True:
        prev = level.copy()
        np.maximum.at(level, dag_dst, level[dag_src] + 1)
        if np.array_equal(level, prev):
            break

    # descendant bitsets (desc[v] holds v and every DAG descendant) and
    # the deepest level below each vertex, in one reverse-topological
    # pass: DAG edges u->v in descending base_dist[u] (w >= 1, so
    # dist[v] > dist[u] and v's row is final before u reads it)
    desc = np.zeros((V, vw), np.uint32)
    idx = np.arange(V)
    desc[idx, idx // 32] = np.uint32(1) << (idx % 32).astype(np.uint32)
    deepest = level.copy()
    order = np.argsort(-base_dist[dag_src], kind="stable")
    for u, v in zip(dag_src[order].tolist(), dag_dst[order].tolist()):
        desc[u] |= desc[v]
        if deepest[v] > deepest[u]:
            deepest[u] = deepest[v]

    # per-link affected set = union of desc(head) over its on-DAG
    # directed edges; repair depth = deepest affected level minus the
    # shallowest head level (+1 slack for the convergence round)
    depth = np.zeros(L, np.int32)
    on_dag_link = np.zeros(L, bool)
    dag_li = link_index[dag_e]
    linked = dag_li >= 0
    li_arr = dag_li[linked]
    head_arr = dag_dst[linked]
    aff = np.zeros((L, vw), np.uint32)
    np.bitwise_or.at(aff, li_arr, desc[head_arr])
    on_dag_link[li_arr] = True
    top_l = np.zeros(L, np.int32)
    np.maximum.at(top_l, li_arr, deepest[head_arr])
    base_l = np.full(L, np.iinfo(np.int32).max, np.int32)
    np.minimum.at(base_l, li_arr, level[head_arr])
    has = on_dag_link
    depth[has] = np.maximum(1, top_l[has] - base_l[has] + 2)

    lanes, pt = (
        pull_tables if pull_tables is not None else build_pull_tables(topo, root_id)
    )
    return RepairPlan(
        root_id=root_id,
        lanes=lanes,
        vw=vw,
        aff_link_words=aff,
        repair_depth=depth,
        on_dag_link=on_dag_link,
        base_dist=base_dist.astype(np.float32),
        base_nh=base_nh[:, :lanes].astype(np.int8),
        transit_src_ok=transit_src_ok,
        **pt,
    )


def topology_content_hash(topo, root_id: Optional[int] = None) -> str:
    """Stable content address of everything the repair planner reads from
    an encoded topology (node symbol table, directed edges with weights,
    validity and link ids, drain bits), plus the SPF root when given:
    equal hashes give identical base solves and repair plans."""
    h = hashlib.sha256()
    h.update("\x00".join(topo.id_to_node).encode())
    for arr in (
        topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index,
        topo.overloaded, topo.soft,
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    if root_id is not None:
        h.update(int(root_id).to_bytes(8, "little", signed=True))
    return h.hexdigest()


class PlanCache:
    """Content-addressed, LRU-bounded RepairPlan memo: repeated what-if
    sweeps over an unchanged graph (the change sequence bumps on every
    prefix churn, the graph usually does not move) skip the planner.  A
    hit returns the SAME plan object; consumers never mutate plans."""

    DEFAULT_CAP = 8

    def __init__(self) -> None:
        self.cap = self.DEFAULT_CAP
        self.entries: "collections.OrderedDict[tuple, RepairPlan]" = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def set_cap(self, cap: int) -> int:
        """Bound the cache to ``cap`` entries (0 restores the default),
        trimming the oldest at once; returns the effective cap."""
        self.cap = int(cap) if cap and cap > 0 else self.DEFAULT_CAP
        self._trim()
        return self.cap

    def _trim(self) -> None:
        while len(self.entries) > self.cap:
            self.entries.popitem(last=False)
            self.evictions += 1

    def plan(self, topo, root_id, base_dist, base_nh, pull_tables=None) -> RepairPlan:
        key = (
            topology_content_hash(topo, root_id),
            hashlib.sha256(np.ascontiguousarray(base_dist, np.float32).tobytes()).hexdigest(),
            hashlib.sha256(np.ascontiguousarray(base_nh, np.int8).tobytes()).hexdigest(),
        )
        plan = self.entries.get(key)
        if plan is not None:
            self.entries.move_to_end(key)
            self.hits += 1
            return plan
        self.misses += 1
        plan = build_repair_plan(topo, root_id, base_dist, base_nh, pull_tables=pull_tables)
        self.entries[key] = plan
        self._trim()
        return plan

    def gauges(self) -> dict:
        """The cache's observability surface, without a prefix (the
        Decision backend namespaces it under ``decision.backend.``)."""
        return {
            "plan_cache.hits": float(self.hits),
            "plan_cache.misses": float(self.misses),
            "plan_cache.evictions": float(self.evictions),
            "plan_cache.size": float(len(self.entries)),
            "plan_cache.cap": float(self.cap),
        }


#: the process-wide plan cache the sweep engines share
PLAN_CACHE = PlanCache()


def build_pull_tables(topo, root_id: int):
    """Topology-only (base-independent) kernel tables: pull-mode lane
    slots (slot v*Din + k holds v's k-th valid in-edge in edge order) and
    the root-lane seed scatter.  Returns (lanes, dict of the RepairPlan
    pull/seed fields)."""
    V = topo.padded_nodes
    src, dst = topo.src, topo.dst
    valid = topo.edge_ok
    din = max(1, int(np.bincount(dst[valid], minlength=V).max()))
    # slot v*din + k: v's k-th valid in-edge in edge order
    edges = np.nonzero(valid)[0]
    vdst = dst[edges].astype(np.int64)
    order = np.argsort(vdst, kind="stable")
    sd = vdst[order]
    rank = np.empty(len(edges), np.int64)
    rank[order] = np.arange(len(sd)) - np.searchsorted(sd, sd)
    slot = vdst * din + rank
    nbr_flat = np.zeros(V * din, np.int32)
    pull_perm = np.zeros(V * din, np.int32)
    pull_valid = np.zeros(V * din, bool)
    nbr_flat[slot] = src[edges]
    pull_perm[slot] = edges
    pull_valid[slot] = True
    nbr_is_root = pull_valid & (nbr_flat == root_id)

    # lane ranks: r-th valid directed out-edge of the root, in edge order
    root_out = np.nonzero((src == root_id) & (topo.link_index >= 0))[0]
    lanes = max(1, len(root_out))
    rank_of_edge = {int(e): r for r, e in enumerate(root_out)}
    sv, sr, ss = [], [], []
    for s in np.nonzero(nbr_is_root)[0]:
        e = int(pull_perm[s])
        if e in rank_of_edge:
            sv.append(s // din)
            sr.append(rank_of_edge[e])
            ss.append(s)
    return lanes, dict(
        din=din,
        nbr_flat=nbr_flat,
        pull_perm=pull_perm,
        pull_valid=pull_valid,
        nbr_is_root=nbr_is_root,
        seed_v=np.asarray(sv, np.int32),
        seed_r=np.asarray(sr, np.int32),
        seed_slot=np.asarray(ss, np.int32),
    )


def warm_base_from_previous(new_topo, root_id: int, old_topo, old_plan: RepairPlan):
    """Cross-generation warm seed for a NEW topology's base solve:
    (d0 [V] f32 over-estimate, nh0 [V, lanes_old] int8 or None,
    lanes_compatible), or None when the generations are incompatible
    (different node symbol tables or root).

    A vertex keeps its old distance as an over-estimate unless some old
    shortest path to it crossed a removed-or-weakened edge; those vertices
    are covered by the old plan's per-link affected bitsets, so resetting
    them to BIG restores the over-estimate invariant and the repair sweep
    converges to the exact new fixed point.  Added/cheapened edges only
    lower distances.  Lanes have a unique reset-semantics fixed point, so
    any lane seed is safe; the old lanes are reused only when the root's
    out-edge list is identical."""
    if new_topo.node_ids != old_topo.node_ids:
        return None
    if root_id != old_plan.root_id:
        return None
    V = old_plan.base_dist.shape[0]
    if new_topo.padded_nodes != V:
        return None

    def edge_map(topo, transit_ok):
        m = {}
        src, dst, w, li = topo.src, topo.dst, topo.w, topo.link_index
        for e in np.nonzero(transit_ok)[0]:
            k = (int(src[e]), int(dst[e]))
            wv = float(w[e])
            if k not in m or wv < m[k][0]:
                m[k] = (wv, int(li[e]))
        return m

    new_transit = (~new_topo.overloaded) | (np.arange(new_topo.padded_nodes) == root_id)
    new_ok = new_topo.edge_ok & new_transit[new_topo.src]
    old_edges = edge_map(old_topo, old_plan.transit_src_ok)
    new_edges = edge_map(new_topo, new_ok)

    reset_words = np.zeros(old_plan.vw, np.uint32)
    L_old = old_plan.aff_link_words.shape[0]
    for (u, v), (wv, li) in old_edges.items():
        nw = new_edges.get((u, v))
        if nw is not None and nw[0] <= wv:
            continue  # edge survives at no worse weight
        if 0 <= li < L_old:
            reset_words |= old_plan.aff_link_words[li]
        else:
            return None  # an old edge without a link id: give up
    idx = np.arange(V)
    reset = (reset_words[idx // 32] >> (idx % 32).astype(np.uint32)) & 1
    d0 = np.where(reset.astype(bool), _BIGF, old_plan.base_dist).astype(np.float32)
    d0[root_id] = 0.0

    def lane_sig(topo):
        es = np.nonzero((topo.src == root_id) & (topo.link_index >= 0))[0]
        return [(int(topo.dst[e]), float(topo.w[e])) for e in es]

    lanes_same = lane_sig(new_topo) == lane_sig(old_topo)
    nh0 = old_plan.base_nh if lanes_same else None
    return d0, nh0, lanes_same


def sort_by_depth(plan: RepairPlan, fails: np.ndarray):
    """Order a failure batch by estimated repair depth (shallow first):
    (sorted_fails, order) with fails == sorted_fails[argsort(order)].  A
    [B, K] set's key is its deepest member."""
    per_link = np.where(fails >= 0, plan.repair_depth[np.clip(fails, 0, None)], 0)
    keys = per_link.max(axis=-1) if fails.ndim == 2 else per_link
    order = np.argsort(keys, kind="stable")
    return fails[order], order


# ---------------------------------------------------------------------------
# What-if sweep: the warm repair of B failure sets (kernel 9)
# ---------------------------------------------------------------------------


def repair_sweep_init(lid, fails, aff_link_table, base_dist, V: int):
    """The repair's per-snapshot starting point: (aff [V, B] bool, the
    affected vertices: the union over the set's links of their affected
    bitsets; d0 [V, B] f32, BIG on affected vertices and the base
    distance elsewhere; en [E, B] bool, an edge enabled iff its link id
    differs from EVERY member of the set — the -1 pads of a set equal the
    -1 link id of padding edges, which the reference disables the same
    way)."""
    dev = base_dist.device
    live = (fails >= 0).to(torch.int32)[:, :, None]
    aff_k = aff_link_table[fails.clamp(min=0).long()] * live  # [B, K, Vw]
    words = aff_k[:, 0]
    for k in range(1, aff_k.shape[1]):
        words = words | aff_k[:, k]
    rep = words.t().repeat_interleave(32, dim=0)[:V]  # [V, B]
    vbit = (torch.arange(V, device=dev) % 32).to(torch.int32)[:, None]
    aff = ((rep >> vbit) & 1).to(torch.bool)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    d0 = torch.where(aff, big, base_dist[:, None])
    en = (lid[:, None, None] != fails[None, :, :]).all(dim=-1)
    return aff, d0, en


def repair_sweep_plain(
    src, dst, w, lid, transit_src_ok, fails, aff_link_table, base_dist,
    base_nh, nbr_flat, pull_perm, pull_valid, nbr_is_root, seed_v, seed_r,
    seed_slot, d_lanes: int, din: int,
):
    """The reference's ``_repair_sweep_impl`` in plain PyTorch: synchronous
    (Jacobi) rounds, the lanes with reset semantics (each round replaces
    a word).  ``fails`` [B, K] int32 (-1 pads), B a multiple of 32;
    ``aff_link_table`` [L, Vw] and every packed word int32 bit patterns.

    Returns (dist [V, B] f32, nh [V, D, B/32] int32 words, bit b % 32 of
    word b // 32 the lane of snapshot b; rounds_d, rounds_l: the rounds
    each loop ran)."""
    V = base_dist.shape[0]
    B = fails.shape[0]
    if B % 32:
        raise ValueError("repair sweep batch must be a multiple of 32")
    Bw = B // 32
    D = d_lanes
    dev = base_dist.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    aff, d, en = repair_sweep_init(lid, fails, aff_link_table, base_dist, V)
    ok = en & transit_src_ok[:, None]
    src_l = src.long()
    dst_l = dst.long()
    wcol = w[:, None]
    rounds_d = 0
    while True:
        cand = torch.where(ok, d[src_l] + wcol, big)
        nd = torch.minimum(d, segment_reduce(cand[None], dst[None], V, "amin", _INF)[0])
        rounds_d += 1
        changed = bool((nd < d).any())
        d = nd
        if not changed or rounds_d >= V:
            break

    # shortest-path-DAG membership, bit-packed over the snapshots
    gs = torch.where(ok, d[src_l] + wcol, big)
    on = (gs == d[dst_l]) & (d[dst_l] < big)  # [E, B]
    on_bits = pack_bits_last(on, B)  # [E, Bw]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    on_pull = torch.where(pull_valid[:, None], on_bits[pull_perm.long()], zero)
    # the reference's .at[seed_v, seed_r].max is a plain store only
    # because each (v, lane) pair occurs once (one root out-edge per lane)
    pairs = seed_v.long() * D + seed_r.long()
    if pairs.numel() != torch.unique(pairs).numel():
        raise ValueError("seed scatter has a repeated (vertex, lane) pair")
    seed_full = torch.zeros((V * D, Bw), dtype=torch.int32, device=dev)
    seed_full[pairs] = on_pull[seed_slot.long()]
    seed_full = seed_full.reshape(V, D, Bw)
    on_prop = torch.where(nbr_is_root[:, None], zero, on_pull).reshape(V, din, 1, Bw)

    # warm lane init: base lanes masked off the affected vertices
    naff_bits = pack_bits_last(~aff, B)  # [V, Bw]
    base_mask = (0 - base_nh.to(torch.int32))[:, :, None]  # 0 or all ones
    nh = (base_mask & naff_bits[:, None, :]) | seed_full
    nbr = nbr_flat.long()
    rounds_l = 0
    while True:
        g = nh[nbr].reshape(V, din, D, Bw) & on_prop
        acc = seed_full
        for k in range(din):
            acc = acc | g[:, k]
        rounds_l += 1
        changed = bool((acc != nh).any())
        nh = acc
        if not changed or rounds_l >= V:
            break
    return d, nh, rounds_d, rounds_l


#: kernel 9 keeps the ranks of its words' lists (two ints per 32
#: vertices) in shared memory
MAX_REPAIR_NODES = 16384
#: threads per block of kernel 9, and blocks of its thread block cluster
#: per 32-snapshot word (1, 2, 4 or 8): a launch lasts as long as its
#: deepest word's rounds, which spread over the cluster; 1,024 threads by
#: 8 blocks was the fastest of 256 / 512 / 1,024 by 1 / 2 / 4 / 8 at the
#: what-if sweep's chunk on the H100 (PERF.md)
REPAIR_THREADS = 1024
REPAIR_CLUSTER = 8
#: kernel 9's dynamic shared memory per block, at most: a block's 227 KB
#: (an SM holds one block of 1,024 threads at the kernel's 64 registers a
#: thread) less room for its static shared memory
REPAIR_SHARED_BYTES = 232448 - 256

#: the ctypes argument types of the C entry points of this module's
#: kernels (``openr_<name>``), in order: pointers (and the stream) as
#: c_void_p, then the ints and BIG
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
REPAIR_SWEEP_ARGTYPES = [_P] * 21 + [_I] * 10 + [_F, _P]


def repair_head_ints(V: int, K: int, threads: int) -> int:
    """int32 words of kernel 9's fixed shared head (``head_ints`` in
    ``repair_sweep.cu``): the word's sets, the list's union words and
    their ranks, the scan counts, rounded up to 16 bytes."""
    return (32 * K + 2 * ((V + 31) // 32) + threads + 1 + 3) // 4 * 4


def repair_vertex_ints(D: int, din: int) -> int:
    """int32 words of one listed vertex's state in kernel 9
    (``vertex_ints``): 32 distance columns, its vertex, two counts and its
    not-affected word, then its listed in-edges (four words each) for the
    distance rounds, over which its active lane sources (two words each),
    its pull slots' membership words, its seed words and two lane planes;
    rounded up to even."""
    return (32 + 4 + max(4 * din, 3 * din + 3 * D) + 1) // 2 * 2


def repair_layout(Bw: int, V: int, K: int, D: int, din: int):
    """``(threads, cluster, cap_shared, scratch_ints)`` of kernel 9 over
    ``Bw`` words: a word's cluster of ``REPAIR_CLUSTER`` blocks holds up to
    ``cap_shared`` listed vertices a block in shared memory
    (``REPAIR_SHARED_BYTES``); a word whose list exceeds them keeps its
    state in a global scratch of ``scratch_ints`` words (``Bw`` x
    ``cluster`` slices of ceil(V / cluster) vertices)."""
    T = REPAIR_THREADS
    C = REPAIR_CLUSTER
    per = repair_vertex_ints(D, din)
    free = max(0, REPAIR_SHARED_BYTES // 4 - repair_head_ints(V, K, T))
    cap_shared = min(free // per, -(-V // C))
    return T, C, cap_shared, Bw * C * -(-V // C) * per


def repair_sweep_launcher(
    src, dst, w, lid, transit_src_ok, fails, aff_link_table, base_dist,
    base_nh, nbr_flat, pull_perm, pull_valid, nbr_is_root, seed_v, seed_r,
    seed_slot, d_lanes: int, din: int, exact_base: bool = False,
):
    """Check the inputs, derive the segment offsets, allocate the outputs
    and the global scratch and bind kernel 9
    (``kernels/csrc/repair_sweep.cu``) once.  With
    ``exact_base`` (the plan's base is the topology's own solve, as
    ``PLAN_CACHE.plan`` builds it) each word's rounds run over the union
    of its snapshots' affected vertices only; else (a warm seed: an
    over-estimate that added or cheapened links lower anywhere) over every
    vertex.  Nothing here waits for the card.  Returns ``(launch, (dist,
    nh, rounds_d, rounds_l))`` with the round counts per 32-snapshot word;
    each ``launch()`` enqueues the kernel (no synchronize) and counts one
    launch."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    V = base_dist.shape[0]
    E = src.shape[0]
    B, K = fails.shape
    D = int(d_lanes)
    din = int(din)
    L, Vw = aff_link_table.shape
    S = seed_v.shape[0]
    if B % 32:
        raise ValueError("repair sweep batch must be a multiple of 32")
    if V > MAX_REPAIR_NODES:
        raise ValueError(f"{V} nodes exceed the repair kernel's {MAX_REPAIR_NODES}")
    if Vw != (V + 31) // 32 or D < 1 or din < 1 or K < 1:
        raise ValueError(f"bad repair shapes Vw={Vw} D={D} din={din} K={K}")
    for name, t in (("src", src), ("dst", dst), ("lid", lid)):
        check_tensor(name, t, torch.int32, (E,), dev)
    check_tensor("w", w, torch.float32, (E,), dev)
    check_tensor("transit_src_ok", transit_src_ok, torch.bool, (E,), dev)
    check_tensor("fails", fails, torch.int32, (B, K), dev)
    check_tensor("aff_link_table", aff_link_table, torch.int32, (L, Vw), dev)
    check_tensor("base_dist", base_dist, torch.float32, (V,), dev)
    check_tensor("base_nh", base_nh, torch.int8, (V, D), dev)
    for name, t in (("nbr_flat", nbr_flat), ("pull_perm", pull_perm)):
        check_tensor(name, t, torch.int32, (V * din,), dev)
    for name, t in (("pull_valid", pull_valid), ("nbr_is_root", nbr_is_root)):
        check_tensor(name, t, torch.bool, (V * din,), dev)
    for name, t in (("seed_v", seed_v), ("seed_r", seed_r), ("seed_slot", seed_slot)):
        check_tensor(name, t, torch.int32, (S,), dev)
    Bw = B // 32
    T, C, cap_shared, scratch_ints = repair_layout(Bw, V, K, D, din)
    seg_off = segment_offsets(dst[None], V)[0].contiguous()
    dist = torch.empty((V, B), dtype=torch.float32, device=dev)
    nh = torch.empty((V, D, Bw), dtype=torch.int32, device=dev)
    rounds_d = torch.empty((Bw,), dtype=torch.int32, device=dev)
    rounds_l = torch.empty((Bw,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, scratch_ints),), dtype=torch.int32, device=dev)
    fn = function("repair_sweep", "openr_repair_sweep", REPAIR_SWEEP_ARGTYPES)
    args = (
        ptr(src), ptr(w), ptr(lid), ptr(transit_src_ok), ptr(fails),
        ptr(aff_link_table), ptr(base_dist), ptr(base_nh), ptr(nbr_flat),
        ptr(pull_perm), ptr(pull_valid), ptr(nbr_is_root), ptr(seed_v),
        ptr(seed_r), ptr(seed_slot), ptr(seg_off), ptr(scratch), ptr(dist), ptr(nh), ptr(rounds_d),
        ptr(rounds_l), V, B, K, D, din, S, int(not exact_base), T, C, cap_shared, BIG,
        stream(dev),
    )

    # the default argument keeps the derived layout and the scratch alive
    def launch(_held=(seg_off, scratch)) -> None:
        check_launch("repair_sweep", fn(*args))
        LAUNCHES["repair_sweep"] += 1

    return launch, (dist, nh, rounds_d, rounds_l)


def repair_sweep(*args, exact_base: bool = False, **kwargs):
    """The warm repair of B failure sets (arguments of
    :func:`repair_sweep_plain`; ``exact_base`` as
    :func:`repair_sweep_launcher`): kernel 9 for CUDA tensors, the plain
    version for CPU tensors.  Exact either way: both loops reach unique
    fixed points, so only the round counts differ."""
    if args[0].device.type == "cpu":
        return repair_sweep_plain(*args, **kwargs)
    launch, outs = repair_sweep_launcher(*args, exact_base=exact_base, **kwargs)
    launch()
    return outs


#: RepairPlan fields the repair sweep reads, in kernel argument order
#: after the edge arrays and ``fails``
_PLAN_FIELDS = (
    "aff_link_words", "base_dist", "base_nh", "nbr_flat", "pull_perm",
    "pull_valid", "nbr_is_root", "seed_v", "seed_r", "seed_slot",
)


class RepairSweep:
    """Device-side warm-start sweep over one (topology, root).

    ``solve(fails)`` returns (dist [V, B] f32, nh [V, lanes, B/32] int32
    words, rounds_d, rounds_l) for [B] single-link failures or [B, K]
    failure sets; exact per snapshot (the warm start is an optimization,
    not an approximation)."""

    batch_granularity = 32

    def __init__(self, topo, plan: RepairPlan, device, edges=None,
                 exact_base: bool = False) -> None:
        """``edges``: the (src, dst, w, link_index) tensors the sweep
        engine already holds on ``device``, to avoid a second copy.
        ``exact_base``: the plan's base is the topology's own solve (a plan
        of ``PLAN_CACHE``), so kernel 9 works on each word's affected
        vertices only; False for a warm seed (``_warm_base_solve``)."""
        self.topo = topo
        self.plan = plan
        self.exact_base = exact_base
        self.device = torch.device(device)
        if edges is None:
            edges = tables_from_numpy(
                (topo.src, topo.dst, topo.w, topo.link_index), self.device
            )
        self._edges = tuple(edges)
        (self._tsok,) = tables_from_numpy((plan.transit_src_ok,), self.device)
        self._plan_t = tables_from_numpy(
            [getattr(plan, name) for name in _PLAN_FIELDS], self.device
        )

    def solve(self, fails: np.ndarray):
        """``fails``: [B] single-link failures or [B, K] simultaneous sets
        (-1 pads both); B a multiple of 32."""
        fails = np.asarray(fails, np.int32)
        if fails.ndim == 1:
            fails = fails[:, None]
        if fails.shape[0] % self.batch_granularity:
            raise ValueError(
                f"repair sweep batch must be a multiple of {self.batch_granularity}"
            )
        src, dst, w, lid = self._edges
        (fails_t,) = tables_from_numpy((fails,), self.device)
        return repair_sweep(
            src, dst, w, lid, self._tsok, fails_t, *self._plan_t,
            d_lanes=self.plan.lanes, din=self.plan.din, exact_base=self.exact_base,
        )
