"""The port's flagship entry — the counterpart of the repository root's
``__graft_entry__.py`` (``_build_problem``, ``entry`` and
``_scalar_route_oracle``).

``entry()`` returns the flagship forward step, ``ops/route_select.py``
``spf_and_select`` (per-snapshot SPF, kernel 16, then per-snapshot
best-route selection, kernel 17, on one stream), with its example inputs
on the card: a 4x4 grid, two advertised prefixes and four single-link
failure snapshots from node0.  ``entry(device="cpu")`` runs the plain
PyTorch versions instead.  The multi-device dry run of the reference
entry is not ported here: it runs the batch-shard wrappers.

    from openr_tpu_torch.graft_entry import entry
    forward, args = entry()
    valid, metric, nexthops, num_nexthops, use = forward(*args)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.emulation.topology import build_adj_dbs, grid_edges
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops.csr import (
    encode_link_state,
    encode_prefix_candidates,
    link_failure_batch,
)
from openr_tpu_torch.ops.route_select import spf_and_select
from openr_tpu_torch.types import PrefixEntry


def build_problem(batch: int, grid: int = 4, device: DeviceLike = None):
    """What-if problem: grid x grid topology, two advertised prefixes, B
    single-link-failure snapshots (snapshot b fails link b % L) from node0
    with the base drains.  Returns (args, max_degree, link_state, topo,
    cands), ``args`` in ``spf_and_select``'s order on ``device`` (the
    card unless the caller names another)."""
    dev = resolve_device(device)
    ls = LinkState("0")
    for db in build_adj_dbs(grid_edges(grid)).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    ps.update_prefix(f"node{grid * grid - 1}", "0", PrefixEntry("10.0.0.0/24"))
    ps.update_prefix(f"node{grid}", "0", PrefixEntry("2001:db8::/64"))
    topo = encode_link_state(ls)
    cands = encode_prefix_candidates(ps, topo, "0")
    D = topo.max_out_degree()
    mask = link_failure_batch(topo, [[b % len(topo.links)] for b in range(batch)])
    arrays = (
        topo.src, topo.dst, topo.w, topo.edge_ok, mask,
        np.tile(topo.overloaded, (batch, 1)), np.tile(topo.soft, (batch, 1)),
        np.zeros(batch, np.int32), cands.cand_node, cands.cand_ok,
        cands.drain_metric, cands.path_pref, cands.source_pref, cands.distance,
        cands.min_nexthop,
    )
    return tables_from_numpy(arrays, dev), D, ls, topo, cands


def entry(device: DeviceLike = None):
    """(forward, example_args): the flagship forward step, fused batched
    SPF + on-device best-route selection, and its inputs on ``device``
    (``cuda:0`` by default; raises without a card)."""
    args, max_degree, _ls, _topo, _cands = build_problem(batch=4, device=device)

    def forward(*a):
        return spf_and_select(*a, max_degree=max_degree)

    return forward, args


def scalar_route_oracle(ls, topo, root: str, link, prefix_node: str,
                        cache: Optional[Dict] = None):
    """Scalar-reference (metric, first-hop neighbour set) of ``prefix_node``'s
    prefix from ``root`` with ``link`` removed (None: nothing removed), by
    the pure-Python Dijkstra of ``LinkState.run_spf``: a neighbour n over
    an up link is a first hop iff w(root -> n) + dist_n(prefix_node) ==
    metric.  A hard-drained neighbour does not transit, so it is a first
    hop only to itself.  The SPF maps depend on the root and the link alone, so
    ``cache`` (a dict the caller keeps per LinkState) holds them across
    prefixes."""
    ignore = frozenset([link]) if link is not None else frozenset()
    key = (root, link)
    hit = None if cache is None else cache.get(key)
    if hit is None:
        res = ls.run_spf(root, links_to_ignore=ignore)
        subs = [
            (lnk, nbr, ls.run_spf(nbr, links_to_ignore=ignore))
            for lnk, nbr in topo.root_out_edges(root)
            if lnk not in ignore and lnk.is_up()
        ]
        hit = (res, subs)
        if cache is not None:
            cache[key] = hit
    res, subs = hit
    if prefix_node not in res:
        return None, set()
    metric = res[prefix_node].metric
    hops = set()
    for lnk, nbr, sub in subs:
        if nbr == prefix_node:
            d_n = 0
        elif ls.is_node_overloaded(nbr) or prefix_node not in sub:
            continue
        else:
            d_n = sub[prefix_node].metric
        if lnk.get_max_metric() + d_n == metric:
            hops.add(nbr)
    return metric, hops
