"""Synthetic topology generators for the port's worlds: grids, rings,
3-tier fabrics, random connected graphs, the multi-pod fat-tree (the
``fattree_multipod`` topology class) and the WAN hierarchy (the
``wan_hierarchy`` class and its ``wan_multi_area`` split), as adjacency
databases.

Copied from ``openr_tpu.emulation.topology`` (itself after the reference
benchmark generators, openr/decision/tests/RoutingBenchmarkUtils.cpp:251
createGrid) so that ``chip_smoke.py`` and the tests build the same LSDBs
without importing the JAX package.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.types import Adjacency, AdjacencyDatabase

Edge = Tuple[str, str, int]  # (node_a, node_b, metric)


def if_name(a: str, b: str) -> str:
    return f"if_{a}_{b}"


def make_adjacency(
    a: str, b: str, metric: int = 1, **kwargs
) -> Adjacency:
    """Directional adjacency a -> b with canonical interface naming.

    Nexthop addresses are derived deterministically (crc32, not the salted
    builtin hash) so serialized route dumps are stable across processes.
    """
    import zlib

    h = zlib.crc32(f"{b}|{if_name(b, a)}".encode())
    return Adjacency(
        other_node_name=b,
        if_name=if_name(a, b),
        other_if_name=if_name(b, a),
        metric=metric,
        next_hop_v6=f"fe80::{(h >> 16) & 0xFFFF:x}:{h & 0xFFFF:x}",
        next_hop_v4="",
        **kwargs,
    )


def build_adj_dbs(
    edges: List[Edge],
    area: str = "0",
    node_labels: Optional[Dict[str, int]] = None,
    overloaded: Optional[List[str]] = None,
    soft_drained: Optional[Dict[str, int]] = None,
) -> Dict[str, AdjacencyDatabase]:
    """Build per-node AdjacencyDatabases from an undirected edge list.

    Metrics are symmetric unless an edge appears twice with different
    metrics ((a,b,m1) and (b,a,m2) → asymmetric).
    """
    node_labels = node_labels or {}
    overloaded = overloaded or []
    soft_drained = soft_drained or {}
    adjs: Dict[str, List[Adjacency]] = {}
    seen_directed = set()
    # pass 1: explicit directed entries win (allows asymmetric metrics)
    for a, b, m in edges:
        adjs.setdefault(a, [])
        adjs.setdefault(b, [])
        if (a, b) not in seen_directed:
            adjs[a].append(make_adjacency(a, b, m))
            seen_directed.add((a, b))
    # pass 2: fill missing reverse directions symmetrically
    for a, b, m in edges:
        if (b, a) not in seen_directed:
            adjs[b].append(make_adjacency(b, a, m))
            seen_directed.add((b, a))
    dbs = {}
    for node, alist in adjs.items():
        dbs[node] = AdjacencyDatabase(
            this_node_name=node,
            adjacencies=alist,
            area=area,
            node_label=node_labels.get(node, 0),
            is_overloaded=node in overloaded,
            node_metric_increment_val=soft_drained.get(node, 0),
        )
    return dbs


def ring_edges(n: int, prefix: str = "node") -> List[Edge]:
    return [
        (f"{prefix}{i}", f"{prefix}{(i + 1) % n}", 1) for i in range(n)
    ]


def grid_edges(n: int, prefix: str = "node") -> List[Edge]:
    """n x n grid, nodes named `{prefix}{row*n+col}`
    (RoutingBenchmarkUtils.cpp:251 createGrid)."""
    edges: List[Edge] = []
    for r in range(n):
        for c in range(n):
            me = f"{prefix}{r * n + c}"
            if c + 1 < n:
                edges.append((me, f"{prefix}{r * n + c + 1}", 1))
            if r + 1 < n:
                edges.append((me, f"{prefix}{(r + 1) * n + c}", 1))
    return edges


def fabric_edges(
    num_pods: int = 2,
    rsws_per_pod: int = 4,
    fsws_per_pod: int = 2,
    num_ssws: int = 4,
) -> List[Edge]:
    """3-tier fat-tree fabric: rack (rsw) - fabric (fsw) - spine (ssw)
    (RoutingBenchmarkUtils.cpp:422)."""
    edges: List[Edge] = []
    for p in range(num_pods):
        fsws = [f"fsw{p}_{f}" for f in range(fsws_per_pod)]
        for r in range(rsws_per_pod):
            rsw = f"rsw{p}_{r}"
            for fsw in fsws:
                edges.append((rsw, fsw, 1))
        for fi, fsw in enumerate(fsws):
            # each fsw uplinks to a disjoint slice of spines
            for s in range(num_ssws):
                if s % fsws_per_pod == fi:
                    edges.append((fsw, f"ssw{s}", 1))
    return edges


def multipod_fattree_edges(
    num_pods: int = 4,
    rsws_per_pod: int = 24,
    fsws_per_pod: int = 4,
    ssws_per_pod: int = 4,
    num_spines: int = 16,
) -> List[Edge]:
    """Multi-pod fat-tree: each pod is an instance of the 3-tier fabric
    (rack rsw → fabric fsw → pod-spine ssw, rsw-fsw and fsw-ssw full
    bipartite inside the pod), pods joined by a super-spine layer —
    every pod-spine ``ssw{p}_{s}`` uplinks to the super-spines ``k``
    with ``k % ssws_per_pod == s``, so pods share the spine plane on
    disjoint slices (the PAPER's DC-fabric shape at multi-pod scale).
    Uniform metric 1: path diversity comes from structure, so ECMP
    lanes stress the selection kernels."""
    edges: List[Edge] = []
    for p in range(num_pods):
        fsws = [f"fsw{p}_{f}" for f in range(fsws_per_pod)]
        ssws = [f"ssw{p}_{s}" for s in range(ssws_per_pod)]
        for r in range(rsws_per_pod):
            rsw = f"rsw{p}_{r}"
            for fsw in fsws:
                edges.append((rsw, fsw, 1))
        for fsw in fsws:
            for ssw in ssws:
                edges.append((fsw, ssw, 1))
        for s, ssw in enumerate(ssws):
            for k in range(num_spines):
                if k % ssws_per_pod == s:
                    edges.append((ssw, f"spine{k}", 1))
    return edges


def random_connected_edges(
    n: int, extra_edges: int, seed: int = 0, prefix: str = "node"
) -> List[Edge]:
    """Random connected graph: spanning tree + `extra_edges` chords.
    Deterministic per seed; used for WAN-like what-if sweeps."""
    rng = random.Random(seed)
    nodes = [f"{prefix}{i}" for i in range(n)]
    edges: List[Edge] = []
    seen = set()
    for i in range(1, n):
        j = rng.randrange(i)
        m = rng.randint(1, 10)
        edges.append((nodes[j], nodes[i], m))
        seen.add((min(i, j), max(i, j)))
    # can't add more chords than non-tree pairs exist
    extra_edges = min(extra_edges, n * (n - 1) // 2 - (n - 1))
    added = 0
    while added < extra_edges:
        i, j = rng.randrange(n), rng.randrange(n)
        if i == j:
            continue
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        edges.append((nodes[i], nodes[j], rng.randint(1, 10)))
        added += 1
    return edges


def wan_hierarchy_edges(
    num_backbone: int = 32,
    num_metros: int = 62,
    metro_size: int = 16,
    backbone_extra: int = 32,
    seed: int = 0,
) -> List[Edge]:
    """WAN hierarchy: metro access rings dual-homed onto a sparse
    backbone mesh, with ASYMMETRIC long-haul metrics (a->b and b->a
    drawn independently — the Express-Backbone shape where forward and
    reverse paths legitimately differ).  Deterministic per seed.

    Structure: ``core{i}`` backbone = random spanning tree +
    ``backbone_extra`` chords, metrics 10..100 per direction;
    ``m{j}_{k}`` metro rings, metrics 1..5 symmetric; each metro homes
    its ring node 0 and its antipode onto two distinct cores (metrics
    5..20 per direction)."""
    rng = random.Random(seed)
    cores = [f"core{i}" for i in range(num_backbone)]
    edges: List[Edge] = []

    def asym(a: str, b: str, lo: int, hi: int) -> None:
        # two explicit directed entries: build_adj_dbs pass 1 keeps both
        edges.append((a, b, rng.randint(lo, hi)))
        edges.append((b, a, rng.randint(lo, hi)))

    for i in range(1, num_backbone):
        asym(cores[rng.randrange(i)], cores[i], 10, 100)
    max_chords = num_backbone * (num_backbone - 1) // 2 - (num_backbone - 1)
    seen = {
        (min(a, b), max(a, b))
        for a, b, _ in edges
    }
    added = 0
    while added < min(backbone_extra, max_chords):
        i, j = rng.randrange(num_backbone), rng.randrange(num_backbone)
        if i == j:
            continue
        key = (min(cores[i], cores[j]), max(cores[i], cores[j]))
        if key in seen:
            continue
        seen.add(key)
        asym(cores[i], cores[j], 10, 100)
        added += 1
    for m in range(num_metros):
        ring = [f"m{m}_{k}" for k in range(metro_size)]
        for k in range(metro_size):
            w = rng.randint(1, 5)
            edges.append((ring[k], ring[(k + 1) % metro_size], w))
        # dual-homing: ring node 0 and its antipode onto distinct cores
        c1 = rng.randrange(num_backbone)
        c2 = (c1 + 1 + rng.randrange(num_backbone - 1)) % num_backbone
        asym(ring[0], cores[c1], 5, 20)
        asym(ring[metro_size // 2], cores[c2], 5, 20)
    return edges


_FATTREE_RSWS, _FATTREE_FSWS, _FATTREE_SSWS = 24, 4, 4
_FATTREE_POD = _FATTREE_RSWS + _FATTREE_FSWS + _FATTREE_SSWS  # 32/pod
_FATTREE_SPINES = 16


def _fattree_params(scale: int) -> Dict[str, int]:
    pods = max(2, round((scale - _FATTREE_SPINES) / _FATTREE_POD))
    per_pod_edges = (
        _FATTREE_RSWS * _FATTREE_FSWS  # rack <-> fabric, full bipartite
        + _FATTREE_FSWS * _FATTREE_SSWS  # fabric <-> pod-spine
        + _FATTREE_SPINES  # pod-spine slices cover every super-spine once
    )
    return {
        "pods": pods,
        "rsws_per_pod": _FATTREE_RSWS,
        "fsws_per_pod": _FATTREE_FSWS,
        "ssws_per_pod": _FATTREE_SSWS,
        "spines": _FATTREE_SPINES,
        "nodes": pods * _FATTREE_POD + _FATTREE_SPINES,
        "undirected_edges": pods * per_pod_edges,
    }


_WAN_METRO_SIZE = 16


def _wan_params(scale: int) -> Dict[str, int]:
    backbone = max(4, scale // 32)
    metros = max(1, (scale - backbone) // _WAN_METRO_SIZE)
    return {
        "backbone": backbone,
        "metros": metros,
        "metro_size": _WAN_METRO_SIZE,
        "backbone_extra": backbone,
        "nodes": backbone + metros * _WAN_METRO_SIZE,
        # spanning tree + chords + rings + 2 homing links per metro
        "undirected_edges": (
            (backbone - 1)
            + min(
                backbone,
                backbone * (backbone - 1) // 2 - (backbone - 1),
            )
            + metros * (_WAN_METRO_SIZE + 2)
        ),
    }


def _build_fattree(scale: int, seed: int) -> List[Edge]:
    del seed  # structural class: uniform-metric fabric, seed-invariant
    return multipod_fattree_edges(
        num_pods=_fattree_params(scale)["pods"],
        rsws_per_pod=_FATTREE_RSWS,
        fsws_per_pod=_FATTREE_FSWS,
        ssws_per_pod=_FATTREE_SSWS,
        num_spines=_FATTREE_SPINES,
    )


def _build_wan(scale: int, seed: int) -> List[Edge]:
    p = _wan_params(scale)
    return wan_hierarchy_edges(
        num_backbone=p["backbone"],
        num_metros=p["metros"],
        metro_size=p["metro_size"],
        backbone_extra=p["backbone_extra"],
        seed=seed,
    )


def wan_area_of(node: str) -> str:
    """Area assignment for the multi-area WAN variant: the backbone is
    area "0", each metro ring its own area (gateway ring members are
    the ABRs — their homing links live in area "0")."""
    if node.startswith("core"):
        return "0"
    return "metro" + node[1:].split("_", 1)[0]


def wan_multi_area_dbs(
    scale: int, seed: int
) -> Dict[str, Dict[str, AdjacencyDatabase]]:
    """The multi-area WAN world as per-area AdjacencyDatabase maps:
    intra-metro ring edges land in the metro's area, backbone mesh AND
    metro-homing links in area "0" (the gateway ring nodes appear in
    both — the ABR model the cross-area redistribution tests want)."""
    by_area: Dict[str, List[Edge]] = {}
    for a, b, m in _build_wan(scale, seed):
        area_a, area_b = wan_area_of(a), wan_area_of(b)
        area = area_a if area_a == area_b else "0"
        by_area.setdefault(area, []).append((a, b, m))
    return {
        area: build_adj_dbs(edges, area=area)
        for area, edges in sorted(by_area.items())
    }
