"""SpfSolver: turn SPF results + prefix advertisements into a RouteDb.

Scalar reference implementation of openr/decision/SpfSolver.{h,cpp} and the
best-route selection helpers from openr/common/LsdbUtil.cpp:640-830.  The
batched device path in ``openr_tpu_torch.ops`` implements the same
selection semantics; this module is the oracle it is held against.

Semantics preserved:
  * candidate filtering by per-area reachability (SpfSolver.cpp:195-215)
  * hard-drain candidate filter w/ all-drained fallback (SpfSolver.cpp:527-545)
  * soft-drain detection feeding the drain tie-breaker (SpfSolver.cpp:512-525)
  * best-route metric chain: drained ▸ path_preference ▸ source_preference,
    then SHORTEST_DISTANCE / PER_AREA_SHORTEST_DISTANCE on metrics.distance
    (LsdbUtil.cpp:761-823)
  * skip-if-self: no route programmed for prefixes the local node advertises
    (SpfSolver.cpp:253-260)
  * ECMP nexthop computation: min-cost dest set, per-neighbor distance
    check distOverLink == minMetric (getNextHopsWithMetric/getNextHopsThrift,
    SpfSolver.cpp:649-768)
  * cross-area min-metric nexthop merge (SpfSolver.cpp:276-302)
  * min-nexthop threshold (addBestPaths, SpfSolver.cpp:596-620)
  * node-segment-label MPLS routes w/ PHP/SWAP/POP_AND_LOOKUP
    (buildRouteDb, SpfSolver.cpp:354-445)
  * static-route overlay (SpfSolver.cpp:109-137, 343-349)
  * KSP2_ED_ECMP restored as a first-class algorithm (the snapshot removed
    the solver path but kept the IDL + LinkState::getKthPaths; see stale
    comment SpfSolver.h:215): routes over the union of 1st and 2nd
    edge-disjoint shortest paths, with SR-MPLS label stacks pinning the
    non-shortest path when forwarding type is SR_MPLS.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from openr_tpu_torch.decision.link_state import INF, LinkState, Path
from openr_tpu_torch.decision.prefix_state import NodeAndArea, PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb, RibMplsEntry, RibUnicastEntry
from openr_tpu_torch.types import (
    MplsAction,
    MplsActionCode,
    NextHop,
    PrefixEntry,
    prefix_is_v4,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    RouteComputationRules,
)
from openr_tpu_torch import constants as C

PrefixEntries = Dict[NodeAndArea, PrefixEntry]


def is_mpls_label_valid(label: int) -> bool:
    return C.MPLS_MIN_LABEL <= label <= C.MPLS_MAX_LABEL


def drained_entry(entry: PrefixEntry) -> PrefixEntry:
    """best-entry copy with drain_metric=1 so other areas learn this path
    crosses a drained node (addBestPaths, SpfSolver.cpp:628-636); shares
    every unchanged field — PrefixState never mutates entries in place,
    so the shared references are safe and no deepcopy is needed."""
    import dataclasses

    return dataclasses.replace(
        entry,
        metrics=type(entry.metrics)(
            version=entry.metrics.version,
            drain_metric=1,
            path_preference=entry.metrics.path_preference,
            source_preference=entry.metrics.source_preference,
            distance=entry.metrics.distance,
        ),
    )


@dataclass
class RouteSelectionResult:
    """Winner set of best-route selection (SpfSolver.h RouteSelectionResult)."""

    all_node_areas: Set[NodeAndArea] = field(default_factory=set)
    best_node_area: NodeAndArea = ("", "")
    is_best_node_drained: bool = False

    def has_node(self, node: str) -> bool:
        return any(n == node for n, _ in self.all_node_areas)


def select_routes(
    prefix_entries: PrefixEntries,
    algorithm: RouteComputationRules,
    drained_nodes: Set[NodeAndArea],
) -> Set[NodeAndArea]:
    """Best-route selection metric chain (LsdbUtil.cpp:761-823)."""
    best_tuple = (-(2**31), -(2**31), -(2**31))
    node_area_set: Set[NodeAndArea] = set()
    for key, entry in prefix_entries.items():
        m = entry.metrics
        t = (
            -int(bool(m.drain_metric or (key in drained_nodes))),
            m.path_preference,
            m.source_preference,
        )
        if t < best_tuple:
            continue
        if t > best_tuple:
            best_tuple = t
            node_area_set.clear()
        node_area_set.add(key)

    if algorithm == RouteComputationRules.SHORTEST_DISTANCE:
        return _select_shortest_distance(prefix_entries, node_area_set)
    if algorithm == RouteComputationRules.PER_AREA_SHORTEST_DISTANCE:
        by_area: Dict[str, Set[NodeAndArea]] = {}
        for na in node_area_set:
            by_area.setdefault(na[1], set()).add(na)
        out: Set[NodeAndArea] = set()
        for in_area in by_area.values():
            out |= _select_shortest_distance(prefix_entries, in_area)
        return out
    return set()


def _select_shortest_distance(
    prefix_entries: PrefixEntries, node_area_set: Set[NodeAndArea]
) -> Set[NodeAndArea]:
    shortest = 2**31
    ret: Set[NodeAndArea] = set()
    for na in node_area_set:
        if na not in prefix_entries:
            continue
        dist = prefix_entries[na].metrics.distance
        if dist > shortest:
            continue
        if dist < shortest:
            shortest = dist
            ret.clear()
        ret.add(na)
    return ret


def select_best_node_area(
    all_node_areas: Set[NodeAndArea], my_node_name: str
) -> NodeAndArea:
    """Deterministic pick; prefer self (LsdbUtil.cpp:701-712)."""
    best = min(all_node_areas)
    for na in all_node_areas:
        if na[0] == my_node_name:
            return na
    return best


class SpfSolver:
    """Scalar route computation engine (openr/decision/SpfSolver.h:100-260)."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = True,
        enable_node_segment_label: bool = False,
        enable_best_route_selection: bool = True,
        v4_over_v6_nexthop: bool = False,
        route_selection_algorithm: RouteComputationRules = (
            RouteComputationRules.SHORTEST_DISTANCE
        ),
    ) -> None:
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.enable_node_segment_label = enable_node_segment_label
        self.enable_best_route_selection = enable_best_route_selection
        self.v4_over_v6_nexthop = v4_over_v6_nexthop
        self.route_selection_algorithm = route_selection_algorithm
        self._static_unicast_routes: Dict[str, RibUnicastEntry] = {}
        self.best_routes_cache: Dict[str, RouteSelectionResult] = {}

    # -- static routes (SpfSolver.cpp:109-137) -----------------------------

    def update_static_unicast_routes(
        self,
        routes_to_update: Dict[str, RibUnicastEntry],
        routes_to_delete: List[str],
    ) -> None:
        for prefix, entry in routes_to_update.items():
            self._static_unicast_routes[prefix] = entry
        for prefix in routes_to_delete:
            self._static_unicast_routes.pop(prefix, None)

    def get_static_routes(self) -> Dict[str, RibUnicastEntry]:
        return self._static_unicast_routes

    # -- drain helpers (SpfSolver.cpp:512-556) -----------------------------

    @staticmethod
    def _filter_hard_drained_nodes(
        prefixes: PrefixEntries, area_link_states: Dict[str, LinkState]
    ) -> PrefixEntries:
        filtered = {
            na: e
            for na, e in prefixes.items()
            if not area_link_states[na[1]].is_node_overloaded(na[0])
        }
        # unless everything is hard-drained
        return filtered if filtered else prefixes

    @staticmethod
    def _get_soft_drained_nodes(
        prefixes: PrefixEntries, area_link_states: Dict[str, LinkState]
    ) -> Set[NodeAndArea]:
        return {
            na
            for na in prefixes
            if area_link_states[na[1]].get_node_metric_increment(na[0]) > 0
        }

    @staticmethod
    def _is_node_drained(
        node_area: NodeAndArea, area_link_states: Dict[str, LinkState]
    ) -> bool:
        node, area = node_area
        ls = area_link_states[area]
        return ls.is_node_overloaded(node) or ls.get_node_metric_increment(node) != 0

    # -- best route selection (SpfSolver.cpp:456-495) ----------------------

    def select_best_routes(
        self,
        prefix_entries: PrefixEntries,
        area_link_states: Dict[str, LinkState],
    ) -> RouteSelectionResult:
        assert prefix_entries, "no prefixes for best route selection"
        ret = RouteSelectionResult()
        filtered = self._filter_hard_drained_nodes(prefix_entries, area_link_states)
        soft_drained = self._get_soft_drained_nodes(prefix_entries, area_link_states)

        if self.enable_best_route_selection:
            ret.all_node_areas = select_routes(
                filtered, self.route_selection_algorithm, soft_drained
            )
            if not ret.all_node_areas:
                return ret
            ret.best_node_area = select_best_node_area(
                ret.all_node_areas, self.my_node_name
            )
        else:
            ret.all_node_areas = set(filtered)
            ret.best_node_area = min(ret.all_node_areas)

        ret.is_best_node_drained = self._is_node_drained(
            ret.best_node_area, area_link_states
        )
        return ret

    # -- nexthop computation (SpfSolver.cpp:649-768) -----------------------

    def get_next_hops_with_metric(
        self,
        dst_node_areas: Set[NodeAndArea],
        link_state: LinkState,
    ) -> Tuple[float, Dict[str, float]]:
        """Returns (min metric src→dest set, {nexthop node: distance from
        that nexthop to the dest})."""
        spf = link_state.get_spf_result(self.my_node_name)
        shortest = INF
        min_cost_nodes: Set[str] = set()
        for dst, _ in dst_node_areas:
            res = spf.get(dst)
            if res is None:
                continue
            if shortest >= res.metric:
                if shortest > res.metric:
                    shortest = res.metric
                    min_cost_nodes.clear()
                min_cost_nodes.add(dst)

        next_hop_nodes: Dict[str, float] = {}
        for dst in min_cost_nodes:
            for nh in spf[dst].next_hops:
                dist_nh = link_state.get_metric_from_a_to_b(self.my_node_name, nh)
                next_hop_nodes[nh] = shortest - (dist_nh or 0)
        return shortest, next_hop_nodes

    def get_next_hops(
        self,
        dst_node_areas: Set[NodeAndArea],
        is_v4: bool,
        best_metrics: Tuple[float, Dict[str, float]],
        swap_label: Optional[int],
        area: str,
        link_state: LinkState,
    ) -> Set[NextHop]:
        min_metric, next_hop_nodes = best_metrics
        assert next_hop_nodes
        next_hops: Set[NextHop] = set()
        for link in link_state.links_from_node(self.my_node_name):
            neighbor = link.get_other_node_name(self.my_node_name)
            if neighbor not in next_hop_nodes or not link.is_up():
                continue
            dist_over_link = link.get_max_metric() + next_hop_nodes[neighbor]
            if dist_over_link != min_metric:
                continue
            mpls_action = None
            if swap_label is not None:
                is_nh_also_dst = (neighbor, area) in dst_node_areas
                mpls_action = MplsAction(
                    MplsActionCode.PHP if is_nh_also_dst else MplsActionCode.SWAP,
                    swap_label=None if is_nh_also_dst else swap_label,
                )
            next_hops.add(
                NextHop(
                    address=(
                        link.get_nh_v4_from_node(self.my_node_name)
                        if is_v4 and not self.v4_over_v6_nexthop
                        else link.get_nh_v6_from_node(self.my_node_name)
                    ),
                    if_name=link.get_iface_from_node(self.my_node_name),
                    metric=int(dist_over_link),
                    area=link.area,
                    neighbor_node_name=neighbor,
                    mpls_action=mpls_action,
                )
            )
        return next_hops

    # -- per-prefix route creation (SpfSolver.cpp:161-312) -----------------

    def create_route_for_prefix(
        self,
        prefix: str,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> Optional[RibUnicastEntry]:
        is_v4 = prefix_is_v4(prefix)
        if is_v4 and not self.enable_v4 and not self.v4_over_v6_nexthop:
            return None
        self.best_routes_cache.pop(prefix, None)
        all_entries = prefix_state.prefixes().get(prefix)
        if not all_entries:
            return None

        # keep only entries from nodes reachable in their own area
        prefix_entries: PrefixEntries = {}
        local_prefix_considered = False
        for (node, parea), entry in all_entries.items():
            if node == self.my_node_name:
                local_prefix_considered = True
            ls = area_link_states.get(parea)
            if ls is None:
                continue
            spf = ls.get_spf_result(self.my_node_name)
            if node in spf:
                prefix_entries[(node, parea)] = entry
        if not prefix_entries:
            return None

        selection = self.select_best_routes(prefix_entries, area_link_states)
        if not selection.all_node_areas:
            return None
        self.best_routes_cache[prefix] = selection

        # local node advertises this prefix → nothing to program
        if selection.has_node(self.my_node_name):
            return None

        # which areas contain winners
        areas_with_best: Set[str] = {area for _, area in selection.all_node_areas}

        forwarding_algorithm = prefix_entries[
            min(selection.all_node_areas)
        ].forwarding_algorithm

        total_next_hops: Set[NextHop] = set()
        shortest_metric = INF
        for area in areas_with_best:
            link_state = area_link_states.get(area)
            if link_state is None:
                continue
            if forwarding_algorithm == PrefixForwardingAlgorithm.KSP2_ED_ECMP:
                best_metric, nhs = self._select_best_paths_ksp2(
                    selection, prefix_entries, area, link_state, is_v4
                )
            else:
                best_metric, nhs = self._select_best_paths_spf(
                    selection, area, link_state, is_v4
                )
            if not nhs:
                continue
            # cross-area min-metric merge (SpfSolver.cpp:294-302)
            if shortest_metric >= best_metric:
                if shortest_metric > best_metric:
                    shortest_metric = best_metric
                    total_next_hops.clear()
                total_next_hops |= nhs

        return self._add_best_paths(
            prefix,
            selection,
            prefix_entries,
            total_next_hops,
            shortest_metric,
            local_prefix_considered,
        )

    def _select_best_paths_spf(
        self,
        selection: RouteSelectionResult,
        area: str,
        link_state: LinkState,
        is_v4: bool,
    ) -> Tuple[float, Set[NextHop]]:
        best_metrics = self.get_next_hops_with_metric(
            selection.all_node_areas, link_state
        )
        if not best_metrics[1]:
            return best_metrics[0], set()
        return best_metrics[0], self.get_next_hops(
            selection.all_node_areas, is_v4, best_metrics, None, area, link_state
        )

    def _select_best_paths_ksp2(
        self,
        selection: RouteSelectionResult,
        prefix_entries: PrefixEntries,
        area: str,
        link_state: LinkState,
        is_v4: bool,
    ) -> Tuple[float, Set[NextHop]]:
        """2-shortest edge-disjoint paths ECMP.

        For each winning dest, paths k=1 and k=2 from LinkState::getKthPaths.
        Nexthop = first link of each path; when the prefix's forwarding type
        is SR_MPLS, non-shortest paths are pinned with a PUSH label stack of
        the downstream nodes' segment labels (top = second hop).
        """
        paths: List[Tuple[Path, int]] = []
        for na in selection.all_node_areas:
            if na[1] != area:
                continue
            for k in (1, 2):
                for p in link_state.get_kth_paths(self.my_node_name, na[0], k):
                    if p:
                        paths.append((p, sum(l.get_max_metric() for l in p)))
        if not paths:
            return INF, set()

        use_mpls = (
            prefix_entries[min(selection.all_node_areas)].forwarding_type
            == PrefixForwardingType.SR_MPLS
        )
        adj_dbs = link_state.get_adjacency_databases()
        next_hops: Set[NextHop] = set()
        best_metric = min(cost for _, cost in paths)
        for path, cost in paths:
            first = path[0]
            neighbor = first.get_other_node_name(self.my_node_name)
            mpls_action = None
            if use_mpls and len(path) > 1:
                # label stack top-first: steer through each node past the
                # first hop using its node segment label
                labels = []
                cur = neighbor
                for link in path[1:]:
                    cur = link.get_other_node_name(cur)
                    db = adj_dbs.get(cur)
                    if db is not None and is_mpls_label_valid(db.node_label):
                        labels.append(db.node_label)
                if labels:
                    mpls_action = MplsAction(
                        MplsActionCode.PUSH, push_labels=tuple(labels)
                    )
            next_hops.add(
                NextHop(
                    address=(
                        first.get_nh_v4_from_node(self.my_node_name)
                        if is_v4 and not self.v4_over_v6_nexthop
                        else first.get_nh_v6_from_node(self.my_node_name)
                    ),
                    if_name=first.get_iface_from_node(self.my_node_name),
                    metric=int(cost),
                    area=area,
                    neighbor_node_name=neighbor,
                    mpls_action=mpls_action,
                )
            )
        return best_metric, next_hops

    def _add_best_paths(
        self,
        prefix: str,
        selection: RouteSelectionResult,
        prefix_entries: PrefixEntries,
        next_hops: Set[NextHop],
        shortest_metric: float,
        local_prefix_considered: bool,
    ) -> Optional[RibUnicastEntry]:
        """min-nexthop gate + entry construction (SpfSolver.cpp:596-640)."""
        if not next_hops:
            return None
        min_next_hop: Optional[int] = None
        for na in selection.all_node_areas:
            mh = prefix_entries[na].min_nexthop
            if mh is not None and (min_next_hop is None or mh > min_next_hop):
                min_next_hop = mh
        if min_next_hop is not None and min_next_hop > len(next_hops):
            return None

        entry = prefix_entries[selection.best_node_area]
        if selection.is_best_node_drained:
            entry = drained_entry(entry)
        return RibUnicastEntry(
            prefix=prefix,
            nexthops=next_hops,
            best_prefix_entry=entry,
            best_area=selection.best_node_area[1],
            igp_cost=shortest_metric,
            local_prefix_considered=local_prefix_considered,
        )

    # -- full build (SpfSolver.cpp:314-449) --------------------------------

    def build_route_db(
        self,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> Optional[DecisionRouteDb]:
        if not any(ls.has_node(self.my_node_name) for ls in area_link_states.values()):
            return None
        route_db = DecisionRouteDb()
        self.best_routes_cache.clear()

        for prefix in prefix_state.prefixes():
            entry = self.create_route_for_prefix(
                prefix, area_link_states, prefix_state
            )
            if entry is not None:
                route_db.add_unicast_route(entry)

        # static routes: prefixState wins on conflict (SpfSolver.cpp:343-349)
        for prefix, sentry in self._static_unicast_routes.items():
            if prefix in route_db.unicast_routes:
                continue
            route_db.add_unicast_route(sentry)

        if self.enable_node_segment_label:
            self._build_node_label_routes(area_link_states, route_db)
        return route_db

    def _build_node_label_routes(
        self,
        area_link_states: Dict[str, LinkState],
        route_db: DecisionRouteDb,
    ) -> None:
        """MPLS routes for every node segment label
        (SpfSolver.cpp:354-445)."""
        label_to_node: Dict[int, Tuple[str, RibMplsEntry]] = {}
        for area, link_state in area_link_states.items():
            for node, adj_db in link_state.get_adjacency_databases().items():
                top_label = adj_db.node_label
                if top_label == 0 or not is_mpls_label_valid(top_label):
                    continue
                # label collision: the reference keeps the entry whose node
                # name is SMALLER (SpfSolver.cpp:389-392 skips the new entry
                # when existing < new; equal names from later areas replace)
                existing = label_to_node.get(top_label)
                if existing is not None and existing[0] < node:
                    continue
                if node == self.my_node_name:
                    label_to_node[top_label] = (
                        node,
                        RibMplsEntry(
                            top_label,
                            {
                                NextHop(
                                    address="::",
                                    area=area,
                                    mpls_action=MplsAction(
                                        MplsActionCode.POP_AND_LOOKUP
                                    ),
                                )
                            },
                        ),
                    )
                    continue
                metric_nhs = self.get_next_hops_with_metric(
                    {(node, area)}, link_state
                )
                if not metric_nhs[1]:
                    continue
                label_to_node[top_label] = (
                    node,
                    RibMplsEntry(
                        top_label,
                        self.get_next_hops(
                            {(node, area)},
                            False,
                            metric_nhs,
                            top_label,
                            area,
                            link_state,
                        ),
                    ),
                )
        for _, (_, entry) in label_to_node.items():
            route_db.add_mpls_route(entry)
