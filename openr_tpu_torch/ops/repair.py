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

The reference's what-if sweep planner (``RepairPlan``, ``_repair_sweep_impl``
and the plan cache) is a later port slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from openr_tpu_torch.ops.consts import BIG

_BIGF = np.float32(BIG)


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
    old_topo, root_id: int, old_dist: np.ndarray, new_topo
) -> Optional[GenerationDelta]:
    """Classify one area's LSDB delta and plan the warm rebuild.

    Returns None when the delta is STRUCTURAL (different node symbol
    tables or padded node shape): the caller solves cold.  Link weight
    changes, link up/down, overload flips and parallel adjacencies are
    warm-eligible.  The descendant sweep is a frontier BFS over the old
    shortest-path DAG."""
    if new_topo.id_to_node != old_topo.id_to_node:
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
    # DAG (an off-DAG removal changes nothing)
    seed = np.zeros(V, bool)
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
