"""Synthetic topology generators for the port's worlds: grids and random
connected graphs, as adjacency databases.

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
