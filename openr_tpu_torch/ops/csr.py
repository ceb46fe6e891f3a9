"""Topology encoding: LinkState graphs → padded numpy arrays (cold path).

The host↔device bridge of the route build.  Node names are interned to
dense int ids, bidirectional links become two directed edges carrying the
soft-drain MAX metric (LinkState.cpp:789 semantics), and everything is
padded to shape buckets.  The SPF kernels read the **dense in-edge
matrix**: slot ``(v, k)`` holds the k-th directed edge INTO v in
dst-sorted edge order, so a relaxation round is a gather ``d[in_src] +
in_w`` and a min over K — no scatter.

This is the numpy encoder of ``openr_tpu.ops.csr`` (``encode_link_state``
/ ``encode_multi_area``) and produces the same arrays bit for bit, plus
its O(links) perturbation patch (``patch_encoded_topology``) and its
slot-stable membership patch (``patch_encoded_topology_slots``), which
``patch_encoded_multi_area_slots`` tries in that order per area: a node or
link that joins or leaves keeps the layout, its slot and rows tombstoned or
revived in place.  The reference's native fill is not part
of this package.

Layout (single topology; the multi-area encoding stacks a leading area
axis):
  * ``src[E], dst[E]`` int32 directed edge endpoints, dst-sorted, padding
    edges at the tail with ``src = dst = V_pad - 1``
  * ``w[E]`` float32 edge metric; ``INF`` for padding/down links
  * ``edge_ok[E]`` bool validity (up, usable, not padding)
  * ``link_index[E]`` int32 undirected link id (-1 pad)
  * ``overloaded[V]`` bool node hard-drain bits, ``soft[V]`` int32 node
    soft-drain increments
  * ``in_src/in_w/in_ok/in_rank [V, K]`` the dense in-edge matrix and
    ``in_has[V]`` (v appears in the padded ``dst`` at all)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from openr_tpu_torch.decision.link_state import Link, LinkState

INF = np.float32(np.inf)

#: in-degree buckets for the dense in-edge matrix (K axis).  Beyond the
#: largest bucket the dense layout is declined (fields stay None).
IN_DEGREE_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)


class CapacityError(ValueError):
    """A world the device layout cannot hold (a count past its largest
    bucket, a metric the device SPF cannot take), found on the host before
    any kernel launch.  ``CudaBackend`` answers such a build through its
    counted scalar fallback; every other ``ValueError`` (a kernel's launcher
    refusing a shape or a device) propagates."""


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise CapacityError(f"{value} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class EncodedTopology:
    """Device-ready arrays + host-side decode tables for ONE topology."""

    src: np.ndarray  # [E] int32
    dst: np.ndarray  # [E] int32
    w: np.ndarray  # [E] float32
    edge_ok: np.ndarray  # [E] bool
    overloaded: np.ndarray  # [V] bool
    soft: np.ndarray  # [V] int32
    link_index: np.ndarray  # [E] int32 (undirected link id, -1 pad)

    # host decode tables
    node_ids: Dict[str, int]
    id_to_node: List[str]
    links: List[Link]  # undirected link objects by link id
    #: [L, 2] positions of each undirected link's two directed edges in
    #: the (dst-sorted) edge arrays — what the patch refreshes
    link_edge_pos: np.ndarray
    num_nodes: int
    num_edges: int  # valid directed edges

    # dense in-edge matrix; all None when the max in-degree exceeds
    # IN_DEGREE_BUCKETS.  ``in_rank`` is the src node's out-edge rank of
    # the edge (rank among edges sharing the same src, in edge order) —
    # the nexthop lane id whenever ``in_src == root``.  ``in_has`` marks
    # vertices present in the padded dst[]: the reference's segment
    # kernels leave int8-min (-128) in lane rows of absent dsts, and the
    # dense kernels reproduce that exactly.  ``in_edge_pos`` maps each
    # edge-list position to its flat V*K slot (-1 for padding edges), so
    # the patch refreshes in_w/in_ok without re-deriving the layout.
    in_src: Optional[np.ndarray] = None  # [V, K] int32 (0 on padding)
    in_w: Optional[np.ndarray] = None  # [V, K] float32 (INF pad/down)
    in_ok: Optional[np.ndarray] = None  # [V, K] bool
    in_rank: Optional[np.ndarray] = None  # [V, K] int32 (-1 = no lane)
    in_edge_pos: Optional[np.ndarray] = None  # [E] int64 flat slot (-1)
    in_has: Optional[np.ndarray] = None  # [V] bool

    # slot-stable membership state (:func:`patch_encoded_topology_slots`):
    # a node that leaves keeps its slot and its links keep their rows,
    # tombstoned (``edge_ok=False, w=INF``: a down link), so the layout
    # never moves; a cold encode carries none of it
    #: names in the symbol table but absent from the current LSDB
    tombstoned_nodes: frozenset = frozenset()
    #: undirected link ids whose rows hold no current link
    tombstoned_links: frozenset = frozenset()
    #: [V] bool: slots whose membership changed in the patch that made
    #: this encoding (tombstoned, revived or renamed); None on cold encodes
    #: and perturbation patches.  The warm planner forces them into its
    #: reset set, and the selective and delta selections treat them as
    #: changed nodes.
    slot_changed: Optional[np.ndarray] = None

    @property
    def has_dense(self) -> bool:
        return self.in_src is not None

    @property
    def padded_nodes(self) -> int:
        return int(self.overloaded.shape[0])

    @property
    def padded_edges(self) -> int:
        return int(self.src.shape[0])

    def node_id(self, name: str) -> int:
        return self.node_ids[name]

    def root_out_edges(self, root: str) -> List[Tuple[Link, str]]:
        """Lane r of the nexthop bitmask (for SPF rooted at `root`)
        corresponds to the r-th directed edge with src == root, in edge
        order.  Returns [(link, neighbor_node_name)] by lane; a root
        absent from this area's graph has no lanes."""
        rid = self.node_ids.get(root)
        if rid is None:
            return []
        idx = np.nonzero((self.src == rid) & (self.link_index >= 0))[0]
        return [
            (self.links[self.link_index[e]], self.id_to_node[self.dst[e]])
            for e in idx
        ]

    def max_out_degree(self) -> int:
        valid = self.link_index >= 0
        if not valid.any():
            return 0
        counts = np.bincount(self.src[valid], minlength=self.padded_nodes)
        return int(counts.max())


def build_in_edge_matrix(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    edge_ok: np.ndarray,
    link_index: np.ndarray,
    padded_v: int,
    in_degree_bucket: Optional[int] = None,
):
    """Dense in-edge layout for dst-sorted edge arrays.

    Returns ``(in_src, in_w, in_ok, in_rank, in_has)`` or None when the
    max in-degree exceeds the largest bucket.  Every REAL edge
    (``link_index >= 0``) owns a slot, down links included; padding slots
    read ``in_ok=False, in_w=INF`` and gather node 0."""
    dense = _in_edge_layout(
        src, dst, w, edge_ok, link_index, padded_v, in_degree_bucket
    )
    if dense is None:
        return None
    in_src, in_w, in_ok, in_rank, _in_edge_pos, in_has = dense
    return in_src, in_w, in_ok, in_rank, in_has


def _in_edge_layout(
    src, dst, w, edge_ok, link_index, padded_v, in_degree_bucket=None
):
    """:func:`build_in_edge_matrix` plus ``in_edge_pos`` [E] (each edge's
    flat V*K slot, -1 for padding), which the patch re-scatters through."""
    valid = np.nonzero(link_index >= 0)[0]
    n = len(valid)
    max_in = int(np.bincount(dst[valid], minlength=padded_v).max()) if n else 0
    try:
        K = in_degree_bucket or bucket_for(max(max_in, 1), IN_DEGREE_BUCKETS)
    except CapacityError:
        return None
    if K < max_in:
        return None
    in_src = np.zeros((padded_v, K), np.int32)
    in_w = np.full((padded_v, K), INF, np.float32)
    in_ok = np.zeros((padded_v, K), bool)
    in_rank = np.full((padded_v, K), -1, np.int32)
    in_edge_pos = np.full(src.shape[0], -1, np.int64)
    if n:
        d = dst[valid]
        # edges are dst-sorted, so each dst's run is contiguous: slot k
        # = position within the run (first-occurrence searchsorted)
        run_start = np.searchsorted(d, d, side="left")
        flat = d.astype(np.int64) * K + (np.arange(n) - run_start)
        in_edge_pos[valid] = flat
        s = src[valid]
        # out-edge rank per edge: index among same-src edges in edge
        # order (a stable sort by src preserves position order)
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        first = np.searchsorted(s_sorted, s_sorted, side="left")
        rank = np.empty(n, np.int32)
        rank[order] = (np.arange(n) - first).astype(np.int32)
        in_src.flat[flat] = s
        in_w.flat[flat] = w[valid]
        in_ok.flat[flat] = edge_ok[valid]
        in_rank.flat[flat] = rank
    in_has = np.bincount(dst, minlength=padded_v) > 0
    return in_src, in_w, in_ok, in_rank, in_edge_pos, in_has


def encode_link_state(
    link_state: LinkState,
    node_bucket: Optional[int] = None,
    edge_bucket: Optional[int] = None,
    node_buckets: Sequence[int] = (16, 64, 256, 1024, 4096, 16384),
    edge_multiplier: int = 8,
    extra_nodes: Sequence[str] = (),
    in_degree_bucket: Optional[int] = None,
) -> EncodedTopology:
    """Encode one LinkState area graph.

    Only up/usable links are emitted as valid edges (interface hard-drain
    excluded here, exactly as Link::isUp excludes them from SPF).  Node
    hard/soft drain bits ride separately.  `extra_nodes` forces
    symbol-table entries for nodes known to other modules (e.g. the SPF
    root in an area where it has no adjacencies)."""
    names = sorted(
        set(link_state.get_adjacency_databases().keys()) | set(extra_nodes)
    )
    node_ids = {n: i for i, n in enumerate(names)}
    V = len(names)
    padded_v = node_bucket or bucket_for(max(V, 1), node_buckets)

    links = link_state.all_links()
    L = len(links)
    col_a = np.fromiter((node_ids[l.n1] for l in links), np.int32, L)
    col_b = np.fromiter((node_ids[l.n2] for l in links), np.int32, L)
    col_m = np.fromiter((l.get_max_metric() for l in links), np.float32, L)
    col_ok = np.fromiter((l.is_up() for l in links), bool, L)

    E = 2 * L
    padded_e = edge_bucket or bucket_for(
        max(E, 1), [b * edge_multiplier for b in node_buckets]
    )
    if padded_v < V:
        raise CapacityError(f"node bucket {padded_v} < {V} nodes")
    if padded_e < E:
        raise CapacityError(f"edge bucket {padded_e} < {E} directed edges")
    # the DAG-equality nexthop propagation assumes strictly positive
    # metrics (a 0-cost edge would union lanes across equidistant nodes
    # where heap Dijkstra keeps them distinct)
    if np.any(col_ok & (col_m <= 0)):
        raise CapacityError(
            "non-positive metric on an up link; device SPF requires "
            "metrics >= 1"
        )

    # padding endpoints use the highest padded node id so the dst-sort
    # below leaves padding at the tail (lane-rank correctness for root 0)
    pad_node = padded_v - 1
    src = np.full(padded_e, pad_node, np.int32)
    dst = np.full(padded_e, pad_node, np.int32)
    w = np.full(padded_e, INF, np.float32)
    edge_ok = np.zeros(padded_e, bool)
    link_index = np.full(padded_e, -1, np.int32)
    src[:E:2], dst[:E:2] = col_a, col_b
    src[1:E:2], dst[1:E:2] = col_b, col_a
    m_dir = np.where(col_ok, col_m, INF)
    w[:E:2] = m_dir
    w[1:E:2] = m_dir
    edge_ok[:E:2] = col_ok
    edge_ok[1:E:2] = col_ok
    link_index[:E:2] = np.arange(L, dtype=np.int32)
    link_index[1:E:2] = np.arange(L, dtype=np.int32)

    overloaded = np.zeros(padded_v, bool)
    soft = np.zeros(padded_v, np.int32)
    for n, i in node_ids.items():
        overloaded[i] = link_state.is_node_overloaded(n)
        soft[i] = link_state.get_node_metric_increment(n)

    # canonical layout: edges sorted by dst (stable, so each dst's run
    # keeps edge order and padding stays at the tail)
    order = np.argsort(dst, kind="stable")
    src = src[order]
    dst = dst[order]
    w = w[order]
    edge_ok = edge_ok[order]
    link_index = link_index[order]
    # positions of each link's two directed edges in the sorted layout:
    # stable-argsort link_index groups pads (-1) first, then pairs per li
    by_link = np.argsort(link_index, kind="stable")
    pad_count = int((link_index < 0).sum())
    link_edge_pos = by_link[pad_count:].reshape(L, 2).astype(np.int32)

    dense = _in_edge_layout(
        src, dst, w, edge_ok, link_index, padded_v, in_degree_bucket
    )
    in_src = in_w = in_ok = in_rank = in_edge_pos = in_has = None
    if dense is not None:
        in_src, in_w, in_ok, in_rank, in_edge_pos, in_has = dense

    return EncodedTopology(
        src=src,
        dst=dst,
        w=w,
        edge_ok=edge_ok,
        overloaded=overloaded,
        soft=soft,
        link_index=link_index,
        node_ids=node_ids,
        id_to_node=names,
        links=links,
        link_edge_pos=link_edge_pos,
        num_nodes=V,
        num_edges=E,
        in_src=in_src,
        in_w=in_w,
        in_ok=in_ok,
        in_rank=in_rank,
        in_edge_pos=in_edge_pos,
        in_has=in_has,
    )


@dataclasses.dataclass
class EncodedPrefixCandidates:
    """One area's per-prefix candidate advertisements as [P, C] arrays:
    for each of P prefixes (sorted), up to C candidate (node, metrics)
    advertisements — the single-area selection's input (the what-if
    sweep's candidate table)."""

    cand_node: np.ndarray  # [P, C] int32 node ids
    cand_ok: np.ndarray  # [P, C] bool
    drain_metric: np.ndarray  # [P, C] int32
    path_pref: np.ndarray  # [P, C] int32
    source_pref: np.ndarray  # [P, C] int32
    distance: np.ndarray  # [P, C] int32
    min_nexthop: np.ndarray  # [P, C] int32 (0 = unset)
    prefixes: List[str]

    @property
    def num_prefixes(self) -> int:
        return len(self.prefixes)


def encode_prefix_candidates(
    prefix_state,
    topo: EncodedTopology,
    area: str,
    max_candidates: Optional[int] = None,
    cand_buckets: Sequence[int] = (8, 16, 32, 64),
) -> EncodedPrefixCandidates:
    """Flatten PrefixState (for one area) into padded candidate arrays.

    The candidate axis is padded to the smallest bucket in `cand_buckets`
    that fits the widest prefix; `max_candidates` pins the width
    instead.  Raises CapacityError past the largest bucket."""
    table = prefix_state.prefixes()
    prefixes = sorted(table.keys())
    P = max(len(prefixes), 1)
    if max_candidates is not None:
        C = max_candidates
    else:
        widest = 1
        for prefix in prefixes:
            n = sum(
                1
                for (node, parea) in table[prefix]
                if parea == area and node in topo.node_ids
            )
            widest = max(widest, n)
        C = bucket_for(widest, cand_buckets)
    cand_node = np.zeros((P, C), np.int32)
    cand_ok = np.zeros((P, C), bool)
    drain = np.zeros((P, C), np.int32)
    pp = np.zeros((P, C), np.int32)
    sp = np.zeros((P, C), np.int32)
    dist = np.zeros((P, C), np.int32)
    minnh = np.zeros((P, C), np.int32)
    for p, prefix in enumerate(prefixes):
        c = 0
        for (node, parea), entry in sorted(table[prefix].items()):
            if parea != area or node not in topo.node_ids:
                continue
            if c >= C:
                raise CapacityError(
                    f"prefix {prefix}: more than {C} candidates; raise "
                    "max_candidates"
                )
            cand_node[p, c] = topo.node_ids[node]
            cand_ok[p, c] = True
            drain[p, c] = entry.metrics.drain_metric
            pp[p, c] = entry.metrics.path_preference
            sp[p, c] = entry.metrics.source_preference
            dist[p, c] = entry.metrics.distance
            minnh[p, c] = entry.min_nexthop or 0
            c += 1
    return EncodedPrefixCandidates(
        cand_node=cand_node,
        cand_ok=cand_ok,
        drain_metric=drain,
        path_pref=pp,
        source_pref=sp,
        distance=dist,
        min_nexthop=minnh,
        prefixes=prefixes,
    )


@dataclasses.dataclass
class EncodedMultiArea:
    """Per-area EncodedTopologies padded to COMMON buckets + stacked
    arrays (leading axis = area, in `areas` order)."""

    areas: List[str]
    topos: List[EncodedTopology]
    src: np.ndarray  # [A, E] (the segment form the warm kernels read)
    dst: np.ndarray  # [A, E]
    w: np.ndarray  # [A, E]
    edge_ok: np.ndarray  # [A, E]
    overloaded: np.ndarray  # [A, V]
    soft: np.ndarray  # [A, V]
    roots: np.ndarray  # [A] my node id per area
    #: stacked dense in-edge planes (None when any area declined the
    #: dense layout)
    in_src: Optional[np.ndarray] = None  # [A, V, K]
    in_w: Optional[np.ndarray] = None  # [A, V, K]
    in_ok: Optional[np.ndarray] = None  # [A, V, K]
    in_rank: Optional[np.ndarray] = None  # [A, V, K]
    in_has: Optional[np.ndarray] = None  # [A, V]

    @property
    def has_dense(self) -> bool:
        return self.in_src is not None

    @property
    def num_areas(self) -> int:
        return len(self.areas)

    def max_out_degree(self) -> int:
        return max((t.max_out_degree() for t in self.topos), default=0)


def encode_multi_area(
    area_link_states,
    me: str,
    node_buckets: Sequence[int] = (16, 64, 256, 1024, 4096, 16384),
    edge_multiplier: int = 8,
) -> EncodedMultiArea:
    """Encode all areas to common node/edge buckets so the kernels' area
    axis is a clean batch dim.  `me` is interned into every area's symbol
    table (even where it has no adjacencies) so per-area SPF roots always
    resolve — an area where I'm isolated yields dist=[0 at me, BIG else],
    exactly the scalar get_spf_result(me) semantics there."""
    areas = sorted(area_link_states.keys())
    sizes_v = []
    sizes_e = []
    for a in areas:
        ls = area_link_states[a]
        sizes_v.append(len(set(ls.get_adjacency_databases().keys()) | {me}))
        sizes_e.append(2 * len(ls.all_links()))
    edge_buckets = [b * edge_multiplier for b in node_buckets]
    pv = bucket_for(max(max(sizes_v), 1), node_buckets)
    pe = bucket_for(max(max(sizes_e), 1), edge_buckets)
    topos = [
        encode_link_state(
            area_link_states[a],
            node_bucket=pv,
            edge_bucket=pe,
            extra_nodes=(me,),
        )
        for a in areas
    ]
    return EncodedMultiArea(
        areas=areas,
        topos=topos,
        src=np.stack([t.src for t in topos]),
        dst=np.stack([t.dst for t in topos]),
        w=np.stack([t.w for t in topos]),
        edge_ok=np.stack([t.edge_ok for t in topos]),
        overloaded=np.stack([t.overloaded for t in topos]),
        soft=np.stack([t.soft for t in topos]),
        roots=np.asarray([t.node_id(me) for t in topos], np.int32),
        **_stack_dense(topos),
    )


def _stack_dense(topos: List[EncodedTopology]) -> dict:
    """Stack per-area dense in-edge planes to a common K bucket; {} when
    any area declined the dense layout."""
    if not topos or not all(t.has_dense for t in topos):
        return {}
    K = max(t.in_src.shape[1] for t in topos)

    def widen(a, fill):
        pad = K - a.shape[1]
        if not pad:
            return a
        return np.concatenate(
            [a, np.full((a.shape[0], pad), fill, a.dtype)], axis=1
        )

    return dict(
        in_src=np.stack([widen(t.in_src, 0) for t in topos]),
        in_w=np.stack([widen(t.in_w, INF) for t in topos]),
        in_ok=np.stack([widen(t.in_ok, False) for t in topos]),
        in_rank=np.stack([widen(t.in_rank, -1) for t in topos]),
        in_has=np.stack([t.in_has for t in topos]),
    )


# ---------------------------------------------------------------------------
# perturbation patch: the warm topology tick's O(links) re-encode
# ---------------------------------------------------------------------------


def patch_encoded_topology(
    old: EncodedTopology, link_state: LinkState, me: Optional[str] = None
) -> Optional[EncodedTopology]:
    """O(links) re-encode of a PERTURBED topology (link weight / up-down /
    overload / soft-drain churn): when the node symbol table and the
    undirected link identity set are unchanged, only the weight, validity
    and drain columns are refreshed and every layout array (src, dst,
    link_index, link_edge_pos, the dense in_src/in_rank/in_edge_pos/in_has
    and the symbol tables) is the previous encoding's own object.  Returns
    None on any membership change; the caller then re-encodes cold."""
    names = set(link_state.get_adjacency_databases().keys())
    if me is not None:
        names.add(me)
    if names != set(old.node_ids.keys()):
        return None
    links = link_state.all_links()
    L = len(links)
    if L != len(old.links):
        return None
    if any(link._key != prev._key for link, prev in zip(links, old.links)):
        return None

    col_m = np.fromiter((l.get_max_metric() for l in links), np.float32, L)
    col_ok = np.fromiter((l.is_up() for l in links), bool, L)
    return dataclasses.replace(
        old, links=links, tombstoned_nodes=frozenset(), tombstoned_links=frozenset(),
        slot_changed=None, **_refreshed_planes(old, col_m, col_ok, old.node_ids, link_state),
    )


def _refreshed_planes(old: EncodedTopology, col_m, col_ok, node_ids, link_state) -> dict:
    """The weight, validity and drain planes of a patch on ``old``'s layout:
    link row li's metric ``col_m[li]`` and up bit ``col_ok[li]`` scattered
    to its two directed edges, each named node's drain bits, and the dense
    ``in_w`` / ``in_ok`` re-scattered through ``in_edge_pos``."""
    if np.any(col_ok & (col_m <= 0)):
        raise CapacityError(
            "non-positive metric on an up link; device SPF requires "
            "metrics >= 1"
        )
    w = np.full(old.padded_edges, INF, np.float32)
    edge_ok = np.zeros(old.padded_edges, bool)
    if len(col_m):
        m_dir = np.where(col_ok, col_m, INF)
        for side in (0, 1):
            w[old.link_edge_pos[:, side]] = m_dir
            edge_ok[old.link_edge_pos[:, side]] = col_ok

    overloaded = np.zeros(old.padded_nodes, bool)
    soft = np.zeros(old.padded_nodes, np.int32)
    for n, i in node_ids.items():
        # a tombstoned name reads LinkState's defaults (False / 0)
        overloaded[i] = link_state.is_node_overloaded(n)
        soft[i] = link_state.get_node_metric_increment(n)

    in_w = in_ok = None
    if old.has_dense:
        pos = old.in_edge_pos
        m = pos >= 0
        in_w = np.full_like(old.in_w, INF)
        in_ok = np.zeros_like(old.in_ok)
        in_w.flat[pos[m]] = w[m]
        in_ok.flat[pos[m]] = edge_ok[m]
    return dict(w=w, edge_ok=edge_ok, overloaded=overloaded, soft=soft, in_w=in_w, in_ok=in_ok)


def _restacked(prev: EncodedMultiArea, areas, topos) -> EncodedMultiArea:
    """The stacked [A, ...] view of patched per-area encodings: the weight
    and drain planes are restacked; the layout arrays (src, dst, in_src,
    in_rank, in_has, roots) stay the previous encoding's objects, which is
    how the warm planner and the delta selection recognise one layout
    chain."""
    dense = {}
    if prev.has_dense:
        K = prev.in_src.shape[2]

        def widen(a, fill):
            pad = K - a.shape[1]
            if not pad:
                return a
            return np.concatenate(
                [a, np.full((a.shape[0], pad), fill, a.dtype)], axis=1
            )

        dense = dict(
            in_src=prev.in_src,
            in_rank=prev.in_rank,
            in_has=prev.in_has,
            in_w=np.stack([widen(t.in_w, INF) for t in topos]),
            in_ok=np.stack([widen(t.in_ok, False) for t in topos]),
        )
    return EncodedMultiArea(
        areas=areas,
        topos=topos,
        src=prev.src,
        dst=prev.dst,
        w=np.stack([t.w for t in topos]),
        edge_ok=np.stack([t.edge_ok for t in topos]),
        overloaded=np.stack([t.overloaded for t in topos]),
        soft=np.stack([t.soft for t in topos]),
        roots=prev.roots,
        **dense,
    )


# ---------------------------------------------------------------------------
# slot-stable membership patch: the structural tick's O(links) re-encode
# ---------------------------------------------------------------------------


def patch_encoded_topology_slots(
    old: EncodedTopology, link_state: LinkState, me: Optional[str] = None
) -> Tuple[Optional[EncodedTopology], Optional[str]]:
    """O(links) re-encode of membership churn (a node or link joining or
    leaving: a rolling restart, autoscaling, key expiry) with every layout
    array the previous encoding's own object.

      * a node that LEAVES keeps its slot, tombstoned, and each of its
        links' rows is invalidated in place (``edge_ok=False, w=INF``,
        byte for byte a down link, so lane ranks, the dst-sort order and
        the dense in-edge layout never move);
      * a node that REJOINS revives its slot, and its links reclaim their
        rows by link identity key;
      * a NEW name takes the lowest free slot of a tombstoned name that is
        not rejoining (that name is forgotten: a cold encode is the
        garbage collector), and its links reclaim tombstoned rows joining
        the same slot endpoints (a replacement node: new name, same
        neighbours).

    Returns ``(encoding, None)``, or ``(None, reason)`` for a cold
    re-encode: ``slot_exhaustion`` (a new name and no free slot) or
    ``new_link`` (a current link with neither its key's row nor a
    tombstoned row between the same slots)."""
    names = set(link_state.get_adjacency_databases().keys())
    if me is not None:
        names.add(me)
    joins = sorted(names - set(old.node_ids.keys()))
    node_ids = old.node_ids
    id_to_node = old.id_to_node
    renamed_slots: List[int] = []
    if joins:
        # lowest slot first, so a replay assigns the same slots
        free = sorted(old.node_ids[n] for n in old.tombstoned_nodes if n not in names)
        if len(free) < len(joins):
            return None, "slot_exhaustion"
        node_ids = dict(old.node_ids)
        id_to_node = list(old.id_to_node)
        for name, slot in zip(joins, free):
            del node_ids[id_to_node[slot]]
            node_ids[name] = slot
            id_to_node[slot] = name
            renamed_slots.append(slot)

    # link rows: the identity key's row first, then a tombstoned row
    # between the same slots for a new key
    n_rows = len(old.links)
    assigned: Dict[int, Link] = {}
    key_to_li = {lk._key: li for li, lk in enumerate(old.links)}
    unmatched: List[Link] = []
    for lk in link_state.all_links():
        li = key_to_li.get(lk._key)
        if li is not None and li not in assigned:
            assigned[li] = lk
        else:
            unmatched.append(lk)
    if unmatched:
        avail: Dict[Tuple[int, int], List[int]] = {}
        for li in range(n_rows):
            if li in assigned:
                continue
            e0 = old.link_edge_pos[li, 0]
            a, b = int(old.src[e0]), int(old.dst[e0])
            avail.setdefault((min(a, b), max(a, b)), []).append(li)
        for lk in unmatched:
            a = node_ids.get(lk.n1)
            b = node_ids.get(lk.n2)
            if a is None or b is None:
                return None, "new_link"
            cand = avail.get((min(a, b), max(a, b)))
            if not cand:
                return None, "new_link"
            assigned[cand.pop(0)] = lk

    # a tombstoned row reads as a down link
    col_m = np.full(n_rows, INF, np.float32)
    col_ok = np.zeros(n_rows, bool)
    links = list(old.links)
    for li, lk in assigned.items():
        links[li] = lk
        col_m[li] = lk.get_max_metric()
        col_ok[li] = lk.is_up()
    planes = _refreshed_planes(old, col_m, col_ok, node_ids, link_state)

    tombstoned_nodes = frozenset(set(node_ids) - names)
    tombstoned_links = frozenset(li for li in range(n_rows) if li not in assigned)
    slot_changed = np.zeros(old.padded_nodes, bool)
    for name in old.tombstoned_nodes ^ tombstoned_nodes:
        nid = node_ids.get(name)
        if nid is not None:
            slot_changed[nid] = True
    slot_changed[renamed_slots] = True
    # a link whose tombstone flipped marks both endpoint slots (the
    # distance and lane diffs catch them too)
    for li in old.tombstoned_links ^ tombstoned_links:
        e0 = old.link_edge_pos[li, 0]
        slot_changed[int(old.src[e0])] = True
        slot_changed[int(old.dst[e0])] = True

    return (
        dataclasses.replace(
            old, node_ids=node_ids, id_to_node=id_to_node, links=links,
            tombstoned_nodes=tombstoned_nodes, tombstoned_links=tombstoned_links,
            slot_changed=slot_changed, **planes,
        ),
        None,
    )


def patch_encoded_multi_area_slots(
    prev: EncodedMultiArea, area_link_states, me: str
) -> Tuple[Optional[EncodedMultiArea], str, Optional[str]]:
    """Per area, the perturbation patch first (on an area without
    tombstones), then the slot-stable patch.  Returns ``(enc, kind,
    reason)``: kind ``"patch"`` (every area took the perturbation patch),
    ``"slot"`` (at least one area took the slot patch) or ``"cold"`` (enc
    None; reason ``area_change``, ``slot_exhaustion`` or ``new_link``)."""
    areas = sorted(area_link_states.keys())
    if areas != prev.areas:
        return None, "cold", "area_change"
    topos = []
    any_slot = False
    for a, old_topo in zip(areas, prev.topos):
        patched = None
        if not old_topo.tombstoned_nodes and not old_topo.tombstoned_links:
            patched = patch_encoded_topology(old_topo, area_link_states[a], me)
        if patched is None:
            patched, reason = patch_encoded_topology_slots(
                old_topo, area_link_states[a], me
            )
            if patched is None:
                return None, "cold", reason
            any_slot = True
        topos.append(patched)
    return _restacked(prev, areas, topos), "slot" if any_slot else "patch", None


def link_failure_batch(
    topo: EncodedTopology, failed_links_per_snapshot: List[List[int]]
) -> np.ndarray:
    """[B, E] bool edge-enable mask from per-snapshot failed undirected
    link ids: an edge is off iff its link id is in its snapshot's list
    (the reference's numpy path; it has no native fill here)."""
    mask = np.ones((len(failed_links_per_snapshot), topo.padded_edges), bool)
    for b, failed in enumerate(failed_links_per_snapshot):
        if failed:
            mask[b, np.isin(topo.link_index, np.asarray(failed, np.int32))] = False
    return mask


def link_failure_sets(failed_links_per_snapshot: List[List[int]]) -> np.ndarray:
    """The same sets as a -1-padded [B, S] int32 array (S >= 1), the form
    the batched kernels read instead of a [B, E] mask."""
    S = max((len(f) for f in failed_links_per_snapshot), default=0)
    out = np.full((len(failed_links_per_snapshot), max(S, 1)), -1, np.int32)
    for b, failed in enumerate(failed_links_per_snapshot):
        out[b, : len(failed)] = failed
    return out
