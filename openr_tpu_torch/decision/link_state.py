"""LinkState: per-area topology graph + SPF (scalar reference core).

Faithful Python equivalent of the reference's pure compute core
(openr/decision/LinkState.{h,cpp}) — the piece the CUDA SPF kernels
replace.  This scalar implementation is the semantic oracle: the batched
kernels in ``openr_tpu_torch.ops`` are validated against it.

Key semantics preserved (citations into the reference Open/R sources):
  * Links exist only when BOTH directions advertise matching adjacencies
    (maybeMakeLink, LinkState.cpp:407-423).
  * Hard-drain: node overload bit → node is reachable but never transits
    (runSpf, LinkState.cpp:739-752); interface overload on either side → link
    unusable (Link::isUp, LinkState.h:118-121).
  * Soft-drain: per-direction metric override; SPF uses the MAX of the two
    directional metrics (LinkState.cpp:780-790 comment block).
  * All-shortest-paths: NodeSpfResult carries the full nexthop set (first
    hops at the root) and predecessor path-links (LinkState.h:290-345).
  * adjOnlyUsedByOtherNode: adjacency usable only by the initializing
    neighbor (adjUsable, LinkState.h:18-40).
  * SPF + k-shortest-path results memoized until topology changes
    (LinkState.h:346-390, cleared in updateAdjacencyDatabase).
  * getKthPaths: edge-disjoint k-th paths by re-running SPF ignoring links
    used by paths 1..k-1 (LinkState.cpp:675-699); traceOnePath recursive
    path extraction (LinkState.cpp:227-247).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from openr_tpu_torch.types import Adjacency, AdjacencyDatabase

INF = float("inf")


def _adj_usable(adj: Adjacency, my_node_name: str) -> bool:
    """adjUsable (LinkState.h:18-40): if adj_only_used_by_other_node is set,
    only the *other* node of that adjacency may use it."""
    if not adj.adj_only_used_by_other_node:
        return True
    return adj.other_node_name == my_node_name


class Link:
    """A bidirectional link (openr/decision/LinkState.h:64-260).

    Holds per-direction metric/overload/adj-label/weight/nexthop-addr; the
    canonical identity is the ordered (node, iface) pair tuple.
    """

    __slots__ = (
        "area",
        "n1",
        "if1",
        "n2",
        "if2",
        "metric1",
        "metric2",
        "overload1",
        "overload2",
        "usable",
        "adj_label1",
        "adj_label2",
        "weight1",
        "weight2",
        "nh_v4_1",
        "nh_v4_2",
        "nh_v6_1",
        "nh_v6_2",
        "_key",
    )

    def __init__(
        self,
        area: str,
        node1: str,
        adj1: Adjacency,
        node2: str,
        adj2: Adjacency,
        usable: bool = True,
    ) -> None:
        self.area = area
        # normalize: n1 is the lexicographically first (node, iface) end,
        # mirroring the reference's orderedNames_ so identity is symmetric
        if (node1, adj1.if_name) <= (node2, adj2.if_name):
            a, an, b, bn = adj1, node1, adj2, node2
        else:
            a, an, b, bn = adj2, node2, adj1, node1
        self.n1, self.if1 = an, a.if_name
        self.n2, self.if2 = bn, b.if_name
        # metricN / overloadN describe the direction *from* nN
        self.metric1, self.metric2 = a.metric, b.metric
        self.overload1, self.overload2 = a.is_overloaded, b.is_overloaded
        self.adj_label1, self.adj_label2 = a.adj_label, b.adj_label
        self.weight1, self.weight2 = a.weight, b.weight
        # adjacency advertised BY nN carries the address of the *other* end,
        # which is what nN uses as its nexthop over this link
        self.nh_v4_1, self.nh_v6_1 = a.next_hop_v4, a.next_hop_v6
        self.nh_v4_2, self.nh_v6_2 = b.next_hop_v4, b.next_hop_v6
        self.usable = usable
        self._key = (self.n1, self.if1, self.n2, self.if2)

    # -- identity ----------------------------------------------------------

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return self._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return isinstance(other, Link) and self._key == other._key

    def __lt__(self, other: "Link") -> bool:
        return self._key < other._key

    def __repr__(self) -> str:
        return f"Link({self.n1}:{self.if1} <-> {self.n2}:{self.if2})"

    def directional_str(self, from_node: str) -> str:
        o = self.get_other_node_name(from_node)
        return f"{from_node}:{self.get_iface_from_node(from_node)} -> {o}"

    # -- accessors (LinkState.h:118-240) -----------------------------------

    def is_up(self) -> bool:
        return (not self.overload1) and (not self.overload2) and self.usable

    def get_other_node_name(self, node: str) -> str:
        if node == self.n1:
            return self.n2
        if node == self.n2:
            return self.n1
        raise ValueError(node)

    def _side(self, node: str) -> int:
        if node == self.n1:
            return 1
        if node == self.n2:
            return 2
        raise ValueError(node)

    def get_iface_from_node(self, node: str) -> str:
        return self.if1 if self._side(node) == 1 else self.if2

    def get_metric_from_node(self, node: str) -> int:
        return self.metric1 if self._side(node) == 1 else self.metric2

    def set_metric_from_node(self, node: str, metric: int) -> bool:
        """Returns True if the topology changed (reference setMetricFromNode)."""
        if self._side(node) == 1:
            changed = self.metric1 != metric
            self.metric1 = metric
        else:
            changed = self.metric2 != metric
            self.metric2 = metric
        return changed

    def get_max_metric(self) -> int:
        """Soft-drain rule: SPF uses max of both directions
        (LinkState.cpp:789)."""
        return max(self.metric1, self.metric2)

    def get_overload_from_node(self, node: str) -> bool:
        return self.overload1 if self._side(node) == 1 else self.overload2

    def set_overload_from_node(self, node: str, overloaded: bool) -> bool:
        was_up = self.is_up()
        if self._side(node) == 1:
            self.overload1 = overloaded
        else:
            self.overload2 = overloaded
        return was_up != self.is_up()

    def get_adj_label_from_node(self, node: str) -> int:
        return self.adj_label1 if self._side(node) == 1 else self.adj_label2

    def get_weight_from_node(self, node: str) -> int:
        return self.weight1 if self._side(node) == 1 else self.weight2

    def get_nh_v4_from_node(self, node: str) -> str:
        return self.nh_v4_1 if self._side(node) == 1 else self.nh_v4_2

    def get_nh_v6_from_node(self, node: str) -> str:
        return self.nh_v6_1 if self._side(node) == 1 else self.nh_v6_2


@dataclass
class NodeSpfResult:
    """SPF result for one destination (LinkState.h:290-345): distance,
    first-hop neighbor set at the root, and predecessor links for path
    tracing."""

    metric: float
    next_hops: Set[str] = field(default_factory=set)
    #: (link, prev_node) pairs on shortest paths into this node
    path_links: List[Tuple[Link, str]] = field(default_factory=list)

    def reset(self, new_metric: float) -> None:
        self.metric = new_metric
        self.next_hops.clear()
        self.path_links.clear()


SpfResult = Dict[str, NodeSpfResult]
Path = List[Link]


@dataclass
class LinkStateChange:
    """What an LSDB update changed (LinkState.h:396-430)."""

    topology_changed: bool = False
    link_attributes_changed: bool = False
    node_label_changed: bool = False
    added_links: List[Link] = field(default_factory=list)
    #: usable links that went DOWN in this update (a clean up->down
    #: flip, or an up link leaving the LSDB — one side withdrawing its
    #: adjacency).  The protection tier's failure classifier reads this:
    #: a tick whose ONLY topology change is down_links is patch-servable
    down_links: List[Link] = field(default_factory=list)
    #: any OTHER SPF-relevant change (link up/add, metric shift,
    #: overload/drain flip, node-metric increment, node membership) —
    #: such a tick is never served from a protection patch
    other_topology_change: bool = False


class LinkState:
    """Per-area link-state graph with memoized SPF
    (openr/decision/LinkState.h:270-600)."""

    def __init__(self, area: str, my_node_name: str = "") -> None:
        self.area = area
        self.my_node_name = my_node_name
        self._adj_dbs: Dict[str, AdjacencyDatabase] = {}
        self._link_map: Dict[str, Set[Link]] = {}
        self._all_links: Set[Link] = set()
        self._node_overloads: Dict[str, bool] = {}
        self._node_metric_increments: Dict[str, int] = {}
        # memoization (invalidated on topology change)
        self._spf_results: Dict[Tuple[str, bool], SpfResult] = {}
        self._kth_path_results: Dict[Tuple[str, str, int], List[Path]] = {}
        self.num_spf_runs = 0
        #: bumped on every SPF-relevant change — downstream encoders (the
        #: device CSR bridge) key their caches on it, so prefix-only
        #: rebuilds skip topology re-encoding entirely
        self.topology_seq = 0
        self._all_links_cache: Optional[Tuple[int, List[Link]]] = None
        #: per-node sorted adjacency, invalidated structurally on
        #: add/remove — run_spf iterates it so path_links order (and thus
        #: the greedy KSP2 trace) is deterministic across runs, which the
        #: device-backed k-path reconstruction reproduces exactly
        self._ordered_links_cache: Dict[str, List[Link]] = {}

    # -- introspection -----------------------------------------------------

    def has_node(self, node: str) -> bool:
        return node in self._link_map or node in self._adj_dbs

    def num_links(self) -> int:
        return len(self._all_links)

    def num_nodes(self) -> int:
        return len(self._link_map)

    def get_adjacency_databases(self) -> Dict[str, AdjacencyDatabase]:
        return self._adj_dbs

    def is_node_overloaded(self, node: str) -> bool:
        return self._node_overloads.get(node, False)

    def get_node_metric_increment(self, node: str) -> int:
        return self._node_metric_increments.get(node, 0)

    def links_from_node(self, node: str) -> Set[Link]:
        return self._link_map.get(node, set())

    def clear_spf_memoization(self) -> None:
        """Drop memoized SPF/k-path results without touching the graph —
        benchmarking hook for measuring cold solves (the memo is otherwise
        invalidated only by topology changes)."""
        self._spf_results.clear()
        self._kth_path_results.clear()

    def all_links(self) -> List[Link]:
        """All undirected links, in canonical order (stable across calls).
        Cached per topology_seq — sorting a 4096-node LSDB's link set costs
        ~20ms, which the encoder would otherwise pay on every rebuild."""
        cached = self._all_links_cache
        if cached is not None and cached[0] == self.topology_seq:
            return cached[1]
        links = sorted(self._all_links)
        self._all_links_cache = (self.topology_seq, links)
        return links

    def ordered_links_from_node(self, node: str) -> List[Link]:
        cached = self._ordered_links_cache.get(node)
        if cached is None:
            cached = sorted(self._link_map.get(node, set()))
            self._ordered_links_cache[node] = cached
        return cached

    # -- link construction (LinkState.cpp:407-438) -------------------------

    def _maybe_make_link(self, node: str, adj: Adjacency) -> Optional[Link]:
        """Only bidirectionally-confirmed adjacencies become links."""
        other_db = self._adj_dbs.get(adj.other_node_name)
        if other_db is None:
            return None
        for other_adj in other_db.adjacencies:
            if (
                other_adj.other_node_name == node
                and adj.other_if_name == other_adj.if_name
                and adj.if_name == other_adj.other_if_name
            ):
                usable = _adj_usable(adj, self.my_node_name) and _adj_usable(
                    other_adj, self.my_node_name
                )
                return Link(
                    self.area, node, adj, adj.other_node_name, other_adj, usable
                )
        return None

    def _ordered_link_set(self, adj_db: AdjacencyDatabase) -> List[Link]:
        links = []
        for adj in adj_db.adjacencies:
            link = self._maybe_make_link(adj_db.this_node_name, adj)
            if link is not None:
                links.append(link)
        links.sort()
        return links

    def _add_link(self, link: Link) -> None:
        self._link_map.setdefault(link.n1, set()).add(link)
        self._link_map.setdefault(link.n2, set()).add(link)
        self._all_links.add(link)
        # a DOWN link joining/leaving doesn't set topology_changed (no SPF
        # impact), so invalidate the ordered-list caches structurally
        self._all_links_cache = None
        self._ordered_links_cache.pop(link.n1, None)
        self._ordered_links_cache.pop(link.n2, None)

    def _remove_link(self, link: Link) -> None:
        self._link_map.get(link.n1, set()).discard(link)
        self._link_map.get(link.n2, set()).discard(link)
        self._all_links.discard(link)
        self._all_links_cache = None
        self._ordered_links_cache.pop(link.n1, None)
        self._ordered_links_cache.pop(link.n2, None)

    def _update_node_overloaded(self, node: str, overloaded: bool) -> bool:
        prior = self._node_overloads.get(node)
        self._node_overloads[node] = overloaded
        # a brand-new node or an unchanged bit is not a topology change
        return prior is not None and prior != overloaded

    # -- LSDB updates (LinkState.cpp:441-643) ------------------------------

    def update_adjacency_database(
        self, new_db: AdjacencyDatabase, in_initialization: bool = False
    ) -> LinkStateChange:
        assert new_db.area == self.area or not new_db.area, (
            f"area mismatch {new_db.area} != {self.area}"
        )
        change = LinkStateChange()
        node = new_db.this_node_name
        prior_db = self._adj_dbs.get(node, AdjacencyDatabase(node, area=self.area))
        self._adj_dbs[node] = new_db

        if self._update_node_overloaded(node, new_db.is_overloaded):
            change.topology_changed = True
            change.other_topology_change = True
        if prior_db.node_metric_increment_val != new_db.node_metric_increment_val:
            change.topology_changed = True
            change.other_topology_change = True
        self._node_metric_increments[node] = new_db.node_metric_increment_val
        change.node_label_changed = prior_db.node_label != new_db.node_label

        old_links = self.ordered_links_from_node(node)
        new_links = self._ordered_link_set(new_db)

        # ordered merge of old/new link sets → adds, removes, attribute diffs
        # (LinkState.cpp:492-637)
        i = j = 0
        while i < len(new_links) or j < len(old_links):
            if i < len(new_links) and (
                j >= len(old_links) or new_links[i] < old_links[j]
            ):
                nl = new_links[i]
                if nl.is_up():
                    change.topology_changed = True
                    change.other_topology_change = True
                self._add_link(nl)
                change.added_links.append(nl)
                i += 1
                continue
            if j < len(old_links) and (
                i >= len(new_links) or old_links[j] < new_links[i]
            ):
                ol = old_links[j]
                if ol.is_up():
                    change.topology_changed = True
                    change.down_links.append(ol)
                self._remove_link(ol)
                j += 1
                continue
            # same link identity: diff attributes in place on the live object
            nl, ol = new_links[i], old_links[j]
            if nl.get_metric_from_node(node) != ol.get_metric_from_node(node):
                if ol.set_metric_from_node(
                    node, nl.get_metric_from_node(node)
                ):
                    change.topology_changed = True
                    change.other_topology_change = True
            if nl.is_up() != ol.is_up():
                if ol.is_up():
                    change.down_links.append(ol)
                else:
                    change.other_topology_change = True
                ol.usable = nl.usable
                change.topology_changed = True
            if nl.get_overload_from_node(node) != ol.get_overload_from_node(node):
                # simplex overloads unsupported: only an up<->down flip is a
                # topology change (Link::setOverloadFromNode, LinkState.cpp:159)
                was_up = ol.is_up()
                ol.set_overload_from_node(node, nl.get_overload_from_node(node))
                if was_up != ol.is_up():
                    # operator drain, not a failure: never patch-served
                    change.topology_changed = True
                    change.other_topology_change = True
            if nl.get_adj_label_from_node(node) != ol.get_adj_label_from_node(node):
                change.link_attributes_changed = True
                if ol._side(node) == 1:
                    ol.adj_label1 = nl.get_adj_label_from_node(node)
                else:
                    ol.adj_label2 = nl.get_adj_label_from_node(node)
            if nl.get_weight_from_node(node) != ol.get_weight_from_node(node):
                change.link_attributes_changed = True
                if ol._side(node) == 1:
                    ol.weight1 = nl.get_weight_from_node(node)
                else:
                    ol.weight2 = nl.get_weight_from_node(node)
            if nl.get_nh_v4_from_node(node) != ol.get_nh_v4_from_node(
                node
            ) or nl.get_nh_v6_from_node(node) != ol.get_nh_v6_from_node(node):
                change.link_attributes_changed = True
                if ol._side(node) == 1:
                    ol.nh_v4_1, ol.nh_v6_1 = (
                        nl.get_nh_v4_from_node(node),
                        nl.get_nh_v6_from_node(node),
                    )
                else:
                    ol.nh_v4_2, ol.nh_v6_2 = (
                        nl.get_nh_v4_from_node(node),
                        nl.get_nh_v6_from_node(node),
                    )
            i += 1
            j += 1

        if change.topology_changed:
            self._spf_results.clear()
            self._kth_path_results.clear()
            self.topology_seq += 1
        return change

    def delete_adjacency_database(self, node: str) -> LinkStateChange:
        change = LinkStateChange()
        if node not in self._adj_dbs:
            return change
        for link in list(self._link_map.get(node, set())):
            self._remove_link(link)
        self._link_map.pop(node, None)
        self._node_overloads.pop(node, None)
        self._node_metric_increments.pop(node, None)
        del self._adj_dbs[node]
        self._spf_results.clear()
        self._kth_path_results.clear()
        self.topology_seq += 1
        change.topology_changed = True
        # a node leaving the LSDB fails ALL its links at once — outside
        # the single-link protection envelope by construction
        change.other_topology_change = True
        return change

    # -- SPF (LinkState.cpp:721-807) ---------------------------------------

    def run_spf(
        self,
        root: str,
        use_link_metric: bool = True,
        links_to_ignore: FrozenSet[Link] = frozenset(),
    ) -> SpfResult:
        """Dijkstra from `root` with all-shortest-paths nexthop tracking.

        Nexthops are first-hop *neighbor node names* at the root; every
        equal-cost predecessor contributes its nexthop set (the reference's
        addNextHops accumulation).
        """
        self.num_spf_runs += 1
        result: SpfResult = {}
        # pending nodes: name -> NodeSpfResult being refined; heap for order
        pending: Dict[str, NodeSpfResult] = {root: NodeSpfResult(0)}
        heap: List[Tuple[float, str]] = [(0, root)]
        while heap:
            metric, name = heapq.heappop(heap)
            node_res = pending.get(name)
            if node_res is None or name in result or metric > node_res.metric:
                continue  # stale heap entry
            del pending[name]
            result[name] = node_res

            # Node hard-drain: record reachability, never transit
            # (LinkState.cpp:739-752)
            if self.is_node_overloaded(name) and name != root:
                continue

            for link in self.ordered_links_from_node(name):
                other = link.get_other_node_name(name)
                if (not link.is_up()) or other in result or link in links_to_ignore:
                    continue
                metric_over_link = link.get_max_metric() if use_link_metric else 1
                cand = node_res.metric + metric_over_link
                other_res = pending.get(other)
                if other_res is None:
                    other_res = pending[other] = NodeSpfResult(cand)
                    heapq.heappush(heap, (cand, other))
                if other_res.metric >= cand:
                    if other_res.metric > cand:
                        other_res.reset(cand)
                        heapq.heappush(heap, (cand, other))
                    other_res.path_links.append((link, name))
                    other_res.next_hops.update(node_res.next_hops)
                    if not other_res.next_hops:
                        # directly connected to root
                        other_res.next_hops.add(other)
        return result

    def get_spf_result(self, root: str, use_link_metric: bool = True) -> SpfResult:
        key = (root, use_link_metric)
        if key not in self._spf_results:
            self._spf_results[key] = self.run_spf(root, use_link_metric)
        return self._spf_results[key]

    def get_metric_from_a_to_b(
        self, a: str, b: str, use_link_metric: bool = True
    ) -> Optional[float]:
        if a == b:
            return 0
        res = self.get_spf_result(a, use_link_metric)
        if b in res:
            return res[b].metric
        return None

    # -- k-shortest edge-disjoint paths (LinkState.cpp:653-703) ------------

    def has_kth_paths(self, src: str, dest: str, k: int) -> bool:
        return (src, dest, k) in self._kth_path_results

    def seed_kth_paths(
        self, src: str, dest: str, k: int, paths: List[Path]
    ) -> None:
        """Install externally-computed k-th paths into the memo (invalidated
        on topology change like every memoized result).  Used by the device
        backend: the expensive masked re-solves run batched on the device and
        the traced paths are seeded here, so ``get_kth_paths`` — and thus
        the whole scalar KSP2 selection chain — never runs host Dijkstra.
        """
        self._kth_path_results[(src, dest, k)] = paths

    def get_kth_paths(self, src: str, dest: str, k: int) -> List[Path]:
        assert k >= 1
        key = (src, dest, k)
        if key not in self._kth_path_results:
            links_to_ignore: Set[Link] = set()
            for i in range(1, k):
                for path in self.get_kth_paths(src, dest, i):
                    links_to_ignore.update(path)
            res = (
                self.get_spf_result(src, True)
                if not links_to_ignore
                else self.run_spf(src, True, frozenset(links_to_ignore))
            )
            paths: List[Path] = []
            if dest in res:
                visited: Set[Link] = set()
                path = self._trace_one_path(src, dest, res, visited)
                while path:
                    paths.append(path)
                    path = self._trace_one_path(src, dest, res, visited)
            self._kth_path_results[key] = paths
        return self._kth_path_results[key]

    def _trace_one_path(
        self, src: str, dest: str, result: SpfResult, links_to_ignore: Set[Link]
    ) -> Optional[Path]:
        """Extract one not-yet-traced path from the shortest-path DAG
        (traceOnePath, LinkState.cpp:227-247).  Returns None when exhausted;
        [] when src == dest."""
        if src == dest:
            return []
        for link, prev_node in result[dest].path_links:
            if link in links_to_ignore:
                continue
            links_to_ignore.add(link)
            sub = self._trace_one_path(src, prev_node, result, links_to_ignore)
            if sub is not None:
                sub.append(link)
                return sub
        return None

    @staticmethod
    def path_a_in_path_b(a: Path, b: Path) -> bool:
        """True if path A appears as a contiguous ordered sub-path of B
        (LinkState.h:483-503)."""
        if len(a) > len(b):
            return False
        for i in range(len(b) - len(a) + 1):
            if all(a[j] == b[i + j] for j in range(len(a))):
                return True
        return False
