"""Device-backed KSP2_ED_ECMP: batched masked re-solves + host path trace —
the counterpart of ``openr_tpu/decision/ksp2.py``.

The reference computes the k-th edge-disjoint shortest paths by re-running
full Dijkstra with the links of paths 1..k-1 ignored, once per destination
(LinkState.cpp:675-699).  Here the k = 2 re-solves of every destination
that is not yet memoized run as ONE batched device call (kernel 15,
``ops/spf.py`` ``batched_spf_distances_masked_sets``: each row's failed
link ids, so no [B, E] mask is built), fetched to the host once, and only
the greedy path trace over the shortest-path DAG (traceOnePath,
LinkState.cpp:227-247) runs on the host, from the device distance fields.

Exactness: ``LinkState.run_spf`` iterates sorted adjacency, so its
``path_links`` order is (settle order of the predecessor, link order); the
trace sorts by exactly that key, so the traced paths are bit-identical to
the scalar ones.  They are seeded into the LinkState k-path memo
(``seed_kth_paths``), after which the unmodified scalar KSP2 selection
chain (``SpfSolver._select_best_paths_ksp2``: SR-MPLS label stacks,
cross-area merge, min-nexthop gate) runs without any host Dijkstra.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from openr_tpu_torch.decision.link_state import Link, LinkState, Path
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops.csr import EncodedTopology, link_failure_sets
from openr_tpu_torch.ops.spf import batched_spf_distances_masked_sets

_BIG = np.float32(3.4e38)


class Ksp2DeviceEngine:
    """Per-(area LinkState, encoded topology) KSP2 seeding engine.

    ``seed(dests)`` guarantees ``link_state.get_kth_paths(root, d, k)`` for
    k in (1, 2) is memoized for every d in dests without running host
    Dijkstra for the k = 2 re-solves.  Results live in the LinkState memo,
    so repeat rebuilds on an unchanged topology are free; LinkState clears
    the memo on a topology change, which re-arms this engine.
    """

    def __init__(
        self, link_state: LinkState, topo: EncodedTopology, root: str,
        device: DeviceLike = None,
    ) -> None:
        self.link_state = link_state
        self.topo = topo
        self.root = root
        self.device = resolve_device(device)
        self._link_id: Dict[Tuple[str, str, str, str], int] = {
            link.key: i for i, link in enumerate(topo.links)
        }
        #: the topology's arrays on the device, uploaded at the first batch
        self._arrays = None
        self.num_device_batches = 0
        self.num_seeded = 0

    # -- public entry ------------------------------------------------------

    def seed(self, dests: Sequence[str]) -> None:
        ls = self.link_state
        root = self.root
        todo = [
            d
            for d in dict.fromkeys(dests)  # stable de-dup
            if d != root and not ls.has_kth_paths(root, d, 2)
        ]
        if not todo:
            return
        # k = 1: trace over the (memoized) base SPF — cheap, scalar-exact
        ignore_ids: List[List[int]] = []
        for d in todo:
            ignored: Set[Link] = set()
            for path in ls.get_kth_paths(root, d, 1):
                ignored.update(path)
            ignore_ids.append(sorted(self._link_id[l.key] for l in ignored))

        dist2 = self._device_resolve(ignore_ids)
        for row, d in enumerate(todo):
            ignored_links = {self.topo.links[i] for i in ignore_ids[row]}
            paths = self._trace_all(d, dist2[row], ignored_links)
            ls.seed_kth_paths(root, d, 2, paths)
            self.num_seeded += 1

    # -- device batch ------------------------------------------------------

    def _device_resolve(self, ignore_ids: List[List[int]]) -> np.ndarray:
        """[B, V] distances of the masked re-solves, one row per
        destination (exact batch size), in one launch and one fetch."""
        topo = self.topo
        if self._arrays is None:
            self._arrays = tables_from_numpy(
                [topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index, topo.overloaded],
                self.device,
            )
        src, dst, w, edge_ok, link_index, overloaded = self._arrays
        failed, roots = tables_from_numpy(
            [
                link_failure_sets(ignore_ids),
                np.full(len(ignore_ids), topo.node_id(self.root), np.int32),
            ],
            self.device,
        )
        dist = batched_spf_distances_masked_sets(
            src, dst, w, edge_ok, link_index, failed, overloaded, roots
        )
        self.num_device_batches += 1
        # one host fetch for the whole batch
        return dist.cpu().numpy()

    # -- host trace over the device distance field -------------------------

    def _path_links(
        self,
        node: str,
        dist: np.ndarray,
        ignored: Set[Link],
    ) -> List[Tuple[Link, str]]:
        """Reconstruct NodeSpfResult.path_links for `node` in run_spf's
        append order: predecessors settle in (metric, name) heap order and
        each relaxes its sorted links (run_spf iterates
        ordered_links_from_node), so the key is (dist[prev], prev, link)."""
        ls = self.link_state
        ids = self.topo.node_ids
        dv = dist[ids[node]]
        out: List[Tuple[np.float32, str, Link]] = []
        for link in ls.ordered_links_from_node(node):
            prev = link.get_other_node_name(node)
            if not link.is_up() or link in ignored:
                continue
            if ls.is_node_overloaded(prev) and prev != self.root:
                continue
            du = dist[ids[prev]]
            if du >= _BIG:
                continue
            if np.float32(du + np.float32(link.get_max_metric())) == dv:
                out.append((du, prev, link))
        out.sort(key=lambda t: (t[0], t[1], t[2].key))
        return [(link, prev) for _, prev, link in out]

    def _trace_all(
        self, dest: str, dist: np.ndarray, ignored: Set[Link]
    ) -> List[Path]:
        if dist[self.topo.node_id(dest)] >= _BIG:
            return []
        visited: Set[Link] = set()
        pl_cache: Dict[str, List[Tuple[Link, str]]] = {}

        def path_links(v: str) -> List[Tuple[Link, str]]:
            cached = pl_cache.get(v)
            if cached is None:
                cached = pl_cache[v] = self._path_links(v, dist, ignored)
            return cached

        def trace_one(v: str) -> Optional[Path]:
            # mirrors LinkState._trace_one_path exactly
            if v == self.root:
                return []
            for link, prev in path_links(v):
                if link in visited:
                    continue
                visited.add(link)
                sub = trace_one(prev)
                if sub is not None:
                    sub.append(link)
                    return sub
            return None

        paths: List[Path] = []
        path = trace_one(dest)
        while path:
            paths.append(path)
            path = trace_one(dest)
        return paths
