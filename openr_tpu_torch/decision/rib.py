"""RIB entry types and route-update deltas
(reference: openr/decision/RibEntry.h, RouteUpdate.h).

`DecisionRouteDb` is the full computed RIB; `DecisionRouteUpdate` is the
delta container pushed Decision → Fib → PrefixManager with FULL_SYNC or
INCREMENTAL semantics (RouteUpdate.h:30-80).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from openr_tpu_torch.types import (
    MplsRoute,
    NextHop,
    PerfEvents,
    PrefixEntry,
    RouteDatabase,
    RouteDatabaseDelta,
    TraceContext,
    UnicastRoute,
)


@dataclass
class RibUnicastEntry:
    """One computed unicast route (RibEntry.h:60-140)."""

    prefix: str
    #: SHARED-OWNERSHIP INVARIANT: the backend memoizes nexthop sets and
    #: hands the SAME (frozen) set to many entries, and
    #: best_prefix_entry aliases the live PrefixState entry.  Never
    #: mutate either in place — reassign (as RibPolicy does).
    nexthops: Set[NextHop] = field(default_factory=set)
    best_prefix_entry: PrefixEntry = field(default_factory=lambda: PrefixEntry("::/0"))
    best_area: str = ""
    do_not_install: bool = False
    igp_cost: float = 0
    #: was the local node's own advertisement part of best-path selection
    local_prefix_considered: bool = False

    def to_unicast_route(self) -> UnicastRoute:
        return UnicastRoute(dest=self.prefix, next_hops=sorted_nexthops(self.nexthops))

    def eq_ignoring_cost(self, other: "RibUnicastEntry") -> bool:
        """Reference equality (RibEntry.h:82-87): igp_cost and best_area are
        deliberately EXCLUDED so remote metric shifts that leave nexthops
        unchanged do not churn the FIB."""
        return (
            self.prefix == other.prefix
            and self.nexthops == other.nexthops
            and self.best_prefix_entry == other.best_prefix_entry
            and self.do_not_install == other.do_not_install
            and self.local_prefix_considered == other.local_prefix_considered
        )


@dataclass
class RibMplsEntry:
    """One computed MPLS label route (RibEntry.h:150-198)."""

    label: int
    nexthops: Set[NextHop] = field(default_factory=set)

    def to_mpls_route(self) -> MplsRoute:
        return MplsRoute(top_label=self.label, next_hops=sorted_nexthops(self.nexthops))


def sorted_nexthops(nhs) -> List[NextHop]:
    return sorted(
        nhs,
        key=lambda nh: (nh.area, nh.neighbor_node_name, nh.if_name, nh.address),
    )


def _nexthop_summary(nh: NextHop):
    return (
        nh.neighbor_node_name,
        nh.if_name,
        nh.address,
        nh.metric,
        nh.weight,
        nh.area,
        None
        if nh.mpls_action is None
        else (
            nh.mpls_action.action,
            nh.mpls_action.swap_label,
            nh.mpls_action.push_labels,
        ),
    )


def route_db_summary(db):
    """Canonical comparable view of a full RouteDb — unicast AND MPLS
    routes with every field that affects forwarding (nexthop addresses,
    metrics, weights, label actions, igp cost, best area).  Differential
    tests and the parity benches compare THIS, so a device-path
    regression in any dimension fails loudly."""
    if db is None:
        return None
    return {
        "unicast": {
            p: (
                round(e.igp_cost, 3),
                e.best_area,
                e.best_prefix_entry.metrics.drain_metric
                if e.best_prefix_entry is not None
                else None,
                sorted(_nexthop_summary(nh) for nh in e.nexthops),
            )
            for p, e in db.unicast_routes.items()
        },
        "mpls": {
            label: sorted(_nexthop_summary(nh) for nh in e.nexthops)
            for label, e in db.mpls_routes.items()
        },
    }


@dataclass
class DecisionRouteDb:
    """Full RIB keyed by prefix / label (RouteUpdate.h DecisionRouteDb)."""

    unicast_routes: Dict[str, RibUnicastEntry] = field(default_factory=dict)
    mpls_routes: Dict[int, RibMplsEntry] = field(default_factory=dict)

    def add_unicast_route(self, entry: RibUnicastEntry) -> None:
        self.unicast_routes[entry.prefix] = entry

    def add_mpls_route(self, entry: RibMplsEntry) -> None:
        self.mpls_routes[entry.label] = entry

    def calculate_update(self, new_db: "DecisionRouteDb") -> "DecisionRouteUpdate":
        """Diff self → new_db (reference DecisionRouteDb::calculateUpdate)."""
        update = DecisionRouteUpdate(type=DecisionRouteUpdateType.INCREMENTAL)
        for prefix, entry in new_db.unicast_routes.items():
            old = self.unicast_routes.get(prefix)
            if old is None or not old.eq_ignoring_cost(entry):
                update.unicast_routes_to_update[prefix] = entry
        for prefix in self.unicast_routes:
            if prefix not in new_db.unicast_routes:
                update.unicast_routes_to_delete.append(prefix)
        for label, mentry in new_db.mpls_routes.items():
            old_m = self.mpls_routes.get(label)
            if old_m is None or old_m != mentry:
                update.mpls_routes_to_update[label] = mentry
        for label in self.mpls_routes:
            if label not in new_db.mpls_routes:
                update.mpls_routes_to_delete.append(label)
        return update

    def calculate_update_for(
        self, new_db: "DecisionRouteDb", prefixes
    ) -> "DecisionRouteUpdate":
        """Diff self → new_db restricted to ``prefixes`` — O(changed), not
        O(total).  Valid when the caller guarantees every other unicast
        route is unchanged (the incremental-rebuild contract: backends
        patch only the changed prefixes, Decision.cpp:908-952).  MPLS
        routes are diffed in full (O(labels) = O(nodes), cheap relative
        to the prefix table)."""
        update = DecisionRouteUpdate(type=DecisionRouteUpdateType.INCREMENTAL)
        for prefix in prefixes:
            old = self.unicast_routes.get(prefix)
            new = new_db.unicast_routes.get(prefix)
            if new is None:
                if old is not None:
                    update.unicast_routes_to_delete.append(prefix)
            elif old is None or not old.eq_ignoring_cost(new):
                update.unicast_routes_to_update[prefix] = new
        for label, mentry in new_db.mpls_routes.items():
            old_m = self.mpls_routes.get(label)
            if old_m is None or old_m != mentry:
                update.mpls_routes_to_update[label] = mentry
        for label in self.mpls_routes:
            if label not in new_db.mpls_routes:
                update.mpls_routes_to_delete.append(label)
        return update

    def to_route_database(self, node_name: str = "") -> RouteDatabase:
        return RouteDatabase(
            this_node_name=node_name,
            unicast_routes=[
                e.to_unicast_route() for e in self.unicast_routes.values()
            ],
            mpls_routes=[e.to_mpls_route() for e in self.mpls_routes.values()],
        )


class DecisionRouteUpdateType(enum.IntEnum):
    FULL_SYNC = 0
    INCREMENTAL = 1


@dataclass
class DecisionRouteUpdate:
    """Delta pushed on routeUpdatesQueue (RouteUpdate.h:30-184)."""

    type: DecisionRouteUpdateType = DecisionRouteUpdateType.INCREMENTAL
    unicast_routes_to_update: Dict[str, RibUnicastEntry] = field(default_factory=dict)
    unicast_routes_to_delete: List[str] = field(default_factory=list)
    mpls_routes_to_update: Dict[int, RibMplsEntry] = field(default_factory=dict)
    mpls_routes_to_delete: List[int] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None
    #: causal-trace handle from the Decision rebuild that produced this
    #: delta; Fib parents its programming span here and closes the trace
    trace_ctx: Optional["TraceContext"] = None
    #: fast-reroute provenance: True when this delta is a precomputed
    #: protection patch published ahead of the confirming warm solve.
    #: ``frr_generation`` is the Decision change_seq the patch was
    #: applied AT — the streaming tier and Fib stamp it so monotone
    #: generation ordering holds across the patch and its confirm
    frr: bool = False
    frr_generation: int = 0

    def empty(self) -> bool:
        return not (
            self.unicast_routes_to_update
            or self.unicast_routes_to_delete
            or self.mpls_routes_to_update
            or self.mpls_routes_to_delete
        )

    def size(self) -> int:
        return (
            len(self.unicast_routes_to_update)
            + len(self.unicast_routes_to_delete)
            + len(self.mpls_routes_to_update)
            + len(self.mpls_routes_to_delete)
        )

    def to_route_database_delta(self) -> RouteDatabaseDelta:
        return RouteDatabaseDelta(
            unicast_routes_to_update=[
                e.to_unicast_route() for e in self.unicast_routes_to_update.values()
            ],
            unicast_routes_to_delete=list(self.unicast_routes_to_delete),
            mpls_routes_to_update=[
                e.to_mpls_route() for e in self.mpls_routes_to_update.values()
            ],
            mpls_routes_to_delete=list(self.mpls_routes_to_delete),
            perf_events=self.perf_events,
        )
