"""Core data model of the port: the slice of ``openr_tpu.types`` that the
Decision route build reads and writes.

Idiomatic Python dataclasses carrying the same information as the
reference's thrift IDL (openr/if/Types.thrift, Network.thrift,
OpenrConfig.thrift): the LSDB inputs (``AdjacencyDatabase``,
``PrefixDatabase``) and the route outputs (``NextHop``, ``UnicastRoute``,
``RouteDatabase``).  Everything round-trips through ``to_wire`` /
``from_wire`` as plain dicts, which is how state crosses from the JAX
reference package into this one (``openr_tpu_torch.interop``).  The
device compute plane never sees prefixes as strings; they are interned to
dense int ids by ``openr_tpu_torch.ops.csr``.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import ipaddress
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple


# ---------------------------------------------------------------------------
# Enums (reference: openr/if/Types.thrift, OpenrConfig.thrift)
# ---------------------------------------------------------------------------


class DrainState(enum.IntEnum):
    """Node drain state (Types.thrift:30-34)."""

    UNDRAINED = 0
    HARD_DRAINED = 1
    SOFT_DRAINED = 2


class PrefixForwardingType(enum.IntEnum):
    """IP vs SR_MPLS forwarding (OpenrConfig.thrift:19-26)."""

    IP = 0
    SR_MPLS = 1


class PrefixForwardingAlgorithm(enum.IntEnum):
    """Route computation algorithm (OpenrConfig.thrift:28-41)."""

    SP_ECMP = 0
    KSP2_ED_ECMP = 1


class RouteComputationRules(enum.IntEnum):
    """Best-route selection algorithm (OpenrConfig.thrift:82-100)."""

    SHORTEST_DISTANCE = 0
    PER_AREA_SHORTEST_DISTANCE = 1


class PrefixType(enum.IntEnum):
    """Origin of a prefix advertisement (Network.thrift PrefixType)."""

    LOOPBACK = 1
    DEFAULT = 2
    BGP = 3
    PREFIX_ALLOCATOR = 4
    BREEZE = 5
    RIB = 6
    CONFIG = 7
    VIP = 8

class LinkStatusEnum(enum.IntEnum):
    DOWN = 0
    UP = 1


# ---------------------------------------------------------------------------
# Wire helpers
# ---------------------------------------------------------------------------


#: exact-type fast path for the overwhelmingly common leaf values; an
#: IntEnum is an int subclass so `type(v) is int` stays correct for it
#: only via the explicit enum branch below (exact-type check excludes it)
_WIRE_PRIMITIVES = frozenset((str, int, float, bool, bytes, type(None)))


def _to_wire_value(v: Any) -> Any:
    # serialization runs per route per RPC: at serving-plane rates the
    # generic dataclass walk below is the ctrl plane's hottest loop, and
    # nearly every value is a primitive — test its exact type first
    if type(v) in _WIRE_PRIMITIVES:
        return v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return v.to_wire()  # type: ignore[union-attr]
    if isinstance(v, enum.Enum):
        return int(v.value)
    if isinstance(v, dict):
        return {k: _to_wire_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_wire_value(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(_to_wire_value(x) for x in v)
    return v


#: per-class codec cache: dataclasses.fields()/annotation resolution cost
#: real time when (de)serialization runs per prefix at benchmark scale
_CODEC_CACHE: Dict[type, tuple] = {}


@functools.lru_cache(maxsize=None)
def _cached_fields(cls) -> tuple:
    return tuple(dataclasses.fields(cls))


class Wire:
    """Mixin: flat dict serialization for RPC payloads and golden tests."""

    def to_wire(self) -> Dict[str, Any]:
        return {
            f.name: _to_wire_value(getattr(self, f.name))
            for f in _cached_fields(type(self))
        }

    @classmethod
    def from_wire(cls, d: Dict[str, Any]):
        codec = _CODEC_CACHE.get(cls)
        if codec is None:
            # built lazily at first use — by then every @wire_type class
            # and the enum registry are fully populated
            codec = _CODEC_CACHE[cls] = tuple(
                (f.name, _make_converter(str(f.type)))
                for f in _cached_fields(cls)
            )
        kwargs = {}
        for name, conv in codec:
            if name in d:
                v = d[name]
                kwargs[name] = None if v is None else conv(v)
        return cls(**kwargs)  # type: ignore[call-arg]


_WIRE_REGISTRY: Dict[str, type] = {}


def _make_converter(s: str):
    """Resolve one field annotation to a converter ONCE (the string scans
    over the registries used to run per field per message)."""
    for name, klass in _WIRE_REGISTRY.items():
        if s == name or s == f"Optional[{name}]":
            return lambda v, k=klass: (
                k.from_wire(v) if isinstance(v, dict) else v
            )
        if s in (f"List[{name}]", f"list[{name}]"):
            return lambda v, k=klass: (
                [k.from_wire(x) if isinstance(x, dict) else x for x in v]
                if isinstance(v, list)
                else v
            )
        if (
            s.startswith("Dict[str, ") or s.startswith("dict[str, ")
        ) and s.endswith(f"{name}]"):
            return lambda v, k=klass: (
                {
                    key: k.from_wire(x) if isinstance(x, dict) else x
                    for key, x in v.items()
                }
                if isinstance(v, dict)
                else v
            )
    if s.startswith("Set[") or s.startswith("set["):
        return set
    if s.startswith("Tuple[") or s.startswith("tuple["):
        return lambda v: tuple(v) if isinstance(v, list) else v
    if "Tuple[" in s:
        # e.g. Dict[str, Tuple[int, int]] — rebuild tuple values
        return lambda v: (
            {k: tuple(x) if isinstance(x, list) else x for k, x in v.items()}
            if isinstance(v, dict)
            else v
        )
    for e in _ENUM_REGISTRY:
        if s == e.__name__ or s == f"Optional[{e.__name__}]":
            return e
    return lambda v: v


def _all_enums() -> List[type]:
    import sys

    mod = sys.modules[__name__]
    return [
        obj
        for obj in vars(mod).values()
        if isinstance(obj, type) and issubclass(obj, enum.Enum) and obj is not enum.Enum
    ]


# Populated at end of module import (after all enums are defined).
_ENUM_REGISTRY: List[type] = []


def wire_type(cls):
    """Register a dataclass for nested from_wire reconstruction."""
    _WIRE_REGISTRY[cls.__name__] = cls
    return cls


def prefix_is_v4(prefix: str) -> bool:
    """Address family of a normalized prefix without the full ipaddress
    parse (the per-prefix ip_network() call was ~40% of route decode at
    10k prefixes; normalized v6 always contains ':')."""
    return ":" not in prefix


#: generation-swapped memo for normalize_prefix: two dicts, the active
#: one swapped out when it exceeds the cap.  The stable prefix table
#: stays hot (every pass re-sees it, re-inserting into the fresh dict
#: before the next swap) while churn of distinct prefixes — including a
#: buggy/hostile peer flooding unique prefixes forever — can
#: retain at most 2 * _NORM_CACHE_MAX entries instead of growing
#: monotonically the way an unbounded lru_cache did.  An LRU bound would
#: instead flood to ~0% hits: each pass re-visits the whole table in
#: roughly the same order.
_NORM_CACHE_MAX = 1_000_000
_norm_active: dict = {}
_norm_stale: dict = {}


def normalize_prefix(prefix: str) -> str:
    """Canonicalize an IP prefix string (host bits zeroed)."""
    global _norm_active, _norm_stale
    v = _norm_active.get(prefix)
    if v is not None:
        return v
    v = _norm_stale.get(prefix)
    if v is None:
        v = str(ipaddress.ip_network(prefix, strict=False))
    if len(_norm_active) >= _NORM_CACHE_MAX:
        _norm_stale = _norm_active
        _norm_active = {}
    _norm_active[prefix] = v
    return v


# ---------------------------------------------------------------------------
# Performance-event breadcrumbs (Types.thrift:80-96) + causal trace context
# ---------------------------------------------------------------------------


@wire_type
@dataclass
class TraceContext(Wire):
    """Causal-trace propagation handle (the reference's tracing plane).

    Minted by a Tracer at an event origin (Spark neighbor up/down,
    LinkMonitor interface event, KvStore key arrival) and carried through
    queue items, KvStore flooding metadata (Publication.trace_ctx) and
    flooded LSDB payloads (PerfEvents.trace_context) so every stage's
    span — on every node the event reaches — shares one ``trace_id``.
    ``span_id`` names the nearest upstream span (the parent for the next
    stage); origin fields stay pinned to the minting event so the closing
    stage (Fib programming ack) can compute end-to-end latency from
    ``t0_ms`` without walking the tree.
    """

    trace_id: str = ""
    span_id: str = ""
    origin_node: str = ""
    origin_event: str = ""
    t0_ms: int = 0


@wire_type
@dataclass
class PerfEvent(Wire):
    node_name: str
    event_descr: str
    unix_ts_ms: int = 0


@wire_type
@dataclass
class PerfEvents(Wire):
    """Ordered breadcrumb list for convergence-latency measurement; newest
    event appended at the back (Types.thrift:88-96)."""

    events: List[PerfEvent] = field(default_factory=list)
    #: causal-trace handle riding the flooded LSDB payload: survives
    #: KvStore storage, so even keys delivered later via full sync keep
    #: their origin trace
    trace_context: Optional[TraceContext] = None

    def add(self, node: str, descr: str, ts_ms: int) -> None:
        self.events.append(PerfEvent(node, descr, ts_ms))

    def total_duration_ms(self) -> int:
        if len(self.events) < 2:
            return 0
        return self.events[-1].unix_ts_ms - self.events[0].unix_ts_ms


# ---------------------------------------------------------------------------
# Link-state types (Types.thrift:145-270)
# ---------------------------------------------------------------------------


@wire_type
@dataclass
class Adjacency(Wire):
    """One established adjacency (Types.thrift:145-213)."""

    other_node_name: str
    if_name: str
    metric: int = 1
    #: SR adjacency-segment label; node-local, 0 = invalid (Types.thrift:174-179)
    adj_label: int = 0
    #: drain bit: adjacency unavailable for transit (Types.thrift:181-185)
    is_overloaded: bool = False
    #: round-trip time to neighbor, microseconds
    rtt: int = 0
    #: adjacency establishment time (s since epoch)
    timestamp: int = 0
    #: weighted-ECMP weight (unused by routing, carried for parity)
    weight: int = 1
    other_if_name: str = ""
    #: if true, only the neighbor may use this adj for routing
    #: (Types.thrift:206-212, used for initialization warm-up)
    adj_only_used_by_other_node: bool = False
    #: IPv6 link-local / IPv4 nexthop addresses of neighbor over if_name
    next_hop_v6: str = ""
    next_hop_v4: str = ""


@wire_type
@dataclass
class LinkStatusRecords(Wire):
    """if_name -> (LinkStatusEnum, unix_ts) (Types.thrift:99-133)."""

    link_status_map: Dict[str, Tuple[int, int]] = field(default_factory=dict)


@wire_type
@dataclass
class AdjacencyDatabase(Wire):
    """Per-(node, area) link state, flooded under key ``adj:<node>``
    (Types.thrift:223-270)."""

    this_node_name: str
    is_overloaded: bool = False  # hard drain: no transit through this node
    adjacencies: List[Adjacency] = field(default_factory=list)
    #: SR nodal segment label, globally unique, 0 = invalid
    node_label: int = 0
    perf_events: Optional[PerfEvents] = None
    area: str = "0"
    #: soft drain: added to every link metric through this node
    node_metric_increment_val: int = 0
    link_status_records: Optional[LinkStatusRecords] = None


# ---------------------------------------------------------------------------
# Prefix types (Types.thrift:287-430)
# ---------------------------------------------------------------------------


@wire_type
@dataclass(frozen=True)
class PrefixMetrics(Wire):
    """Best-prefix-selection metric chain (Types.thrift:287-347).

    Tie-break order (openr/decision/PrefixState + RibEntry semantics):
      1. drain_metric       prefer LOWER
      2. path_preference    prefer HIGHER
      3. source_preference  prefer HIGHER
      4. distance           prefer LOWER
    """

    version: int = 1
    drain_metric: int = 0
    path_preference: int = 0
    source_preference: int = 0
    distance: int = 0

    def sort_key(self) -> Tuple[int, int, int, int]:
        """Lower sorts better."""
        return (
            self.drain_metric,
            -self.path_preference,
            -self.source_preference,
            self.distance,
        )


@wire_type
@dataclass
class PrefixEntry(Wire):
    """One advertised route (Types.thrift:349-413)."""

    prefix: str
    type: PrefixType = PrefixType.LOOPBACK
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    )
    #: if set, Decision withholds the route unless >= this many nexthops
    min_nexthop: Optional[int] = None
    metrics: PrefixMetrics = field(default_factory=PrefixMetrics)
    tags: Set[str] = field(default_factory=set)
    #: areas traversed; [0] = originating area, appended on redistribution;
    #: used for inter-area loop prevention (Decision.cpp:762-773)
    area_stack: List[str] = field(default_factory=list)
    weight: Optional[int] = None

    def __post_init__(self) -> None:
        self.prefix = normalize_prefix(self.prefix)


@wire_type
@dataclass
class PrefixDatabase(Wire):
    """Route advertisement flooded under ``prefix:<node>:[<prefix>]``
    (Types.thrift:415-440)."""

    this_node_name: str
    prefix_entries: List[PrefixEntry] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None
    #: per-prefix-key deletion marker (reference advertises deletion by
    #: flooding a PrefixDatabase with deletePrefix=true)
    delete_prefix: bool = False
    area: str = "0"


# ---------------------------------------------------------------------------
# KvStore types (KvStore.thrift:100-420)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Routes (Network.thrift UnicastRoute/MplsRoute, fib/)
# ---------------------------------------------------------------------------


class MplsActionCode(enum.IntEnum):
    """MPLS label actions (Network.thrift MplsActionCode)."""

    PUSH = 0
    SWAP = 1
    PHP = 2  # Penultimate hop popping: implicit-null
    POP_AND_LOOKUP = 3


@wire_type
@dataclass(frozen=True)
class MplsAction(Wire):
    action: MplsActionCode = MplsActionCode.PHP
    swap_label: Optional[int] = None
    push_labels: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.push_labels is not None and not isinstance(self.push_labels, tuple):
            object.__setattr__(self, "push_labels", tuple(self.push_labels))


@wire_type
@dataclass(frozen=True)
class NextHop(Wire):
    """A route nexthop (Network.thrift NextHopThrift): address + interface,
    weight (0 = ECMP), optional MPLS action, and the metric/area it came
    from."""

    address: str = ""
    if_name: str = ""
    metric: int = 0
    weight: int = 0
    area: str = ""
    neighbor_node_name: str = ""
    mpls_action: Optional[MplsAction] = None


@wire_type
@dataclass
class UnicastRoute(Wire):
    dest: str = ""
    next_hops: List[NextHop] = field(default_factory=list)


@wire_type
@dataclass
class MplsRoute(Wire):
    top_label: int = 0
    next_hops: List[NextHop] = field(default_factory=list)


@wire_type
@dataclass
class RouteDatabase(Wire):
    this_node_name: str = ""
    unicast_routes: List[UnicastRoute] = field(default_factory=list)
    mpls_routes: List[MplsRoute] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None


@wire_type
@dataclass
class RouteDatabaseDelta(Wire):
    unicast_routes_to_update: List[UnicastRoute] = field(default_factory=list)
    unicast_routes_to_delete: List[str] = field(default_factory=list)
    mpls_routes_to_update: List[MplsRoute] = field(default_factory=list)
    mpls_routes_to_delete: List[int] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None


_ENUM_REGISTRY.extend(_all_enums())
