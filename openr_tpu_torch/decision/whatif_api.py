"""Operator what-if: "which of MY routes change if link X fails?" — the
counterpart of ``openr_tpu/decision/whatif_api.py``'s single-area device
engine, its criticality report and its scalar fallback.

``WhatIfApiEngine`` runs the candidate failures as one sweep on the card
(``ops/whatif.py`` + ``ops/sweep_select.py``) against the current LSDB
from this node's vantage and returns per-failure route changes (removed /
added / rerouted, metric) decoded to neighbour names.  The engine (base
solve, repair plan, selection tables) is cached per LSDB generation, and
a new generation's base solve is warm-started from the previous one.

``MultiAreaWhatIfEngine`` answers them on a multi-area LSDB: every
candidate failure set (a single link, a parallel bundle, or one
simultaneous set) is a snapshot of one batched solve on the card
(``ops/fleet_tables.py`` ``whatif_multi_area_tables``) whose selection is
global across areas; the host merges the areas' routes per snapshot and
diffs each against the unperturbed base row.

``GenericSolverWhatIfEngine`` answers the same queries with full scalar
``SpfSolver`` builds on the LSDB with the links removed: slow, but it
touches no device, and it is the oracle the card's answers are held to.
``DeviceBuildWhatIfEngine`` is the same rebuild-and-diff with each build
on a dedicated ``CudaBackend``: the what-if surface for LSDBs the sweep
kernels do not cover, such as KSP2_ED_ECMP prefixes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS, CudaBackend
from openr_tpu_torch.decision.cand_table import CandidateTable
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.device import resolve_device
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.csr import (
    bucket_for,
    encode_link_state,
    encode_multi_area,
    encode_prefix_candidates,
)
from openr_tpu_torch.ops.fleet_tables import whatif_multi_area_tables
from openr_tpu_torch.ops.route_select import multi_area_spf_tables
from openr_tpu_torch.ops.sweep_select import HostFetch, SweepRouteSelector
from openr_tpu_torch.ops.whatif import LinkFailureSweep
from openr_tpu_torch.types import RouteComputationRules, prefix_is_v4


def resolve_pair_failures(pair_links: Dict, link_failures):
    """Resolve (n1, n2) pairs against a pair→links map: (values, errors),
    one entry per failure.  values[i] is the tuple of every link between
    the pair (a parallel bundle fails as one set) or None; errors[i] is
    None or a ready-to-emit "unknown link" row."""
    values, errors = [], []
    for n1, n2 in link_failures:
        hits = pair_links.get(frozenset((n1, n2)), [])
        if hits:
            values.append(tuple(hits))
            errors.append(None)
        else:
            values.append(None)
            errors.append({"link": [n1, n2], "error": "unknown link"})
    return values, errors


def build_pair_links(links, area_index=None) -> Dict:
    """(n1, n2) → every link between the pair (parallel links are distinct
    links): plain link ids, or (area_index, link id) pairs when
    ``area_index`` is given."""
    out: Dict[frozenset, list] = {}
    for i, link in enumerate(links):
        val = i if area_index is None else (area_index, i)
        out.setdefault(frozenset((link.n1, link.n2)), []).append(val)
    return out


def lane_names_for(topo, root: str) -> List[str]:
    """Lane rank → neighbour name for decoding first-hop lane rows."""
    return [nbr for (_link, nbr) in topo.root_out_edges(root)]


def decode_lane_names(lane_names: List[str], row) -> List[str]:
    return [lane_names[i] for i in np.nonzero(row)[0] if i < len(lane_names)]


def change_kind(was: bool, now: bool) -> str:
    if was and not now:
        return "removed"
    if now and not was:
        return "added"
    return "rerouted"


class WhatIfApiEngine:
    """Cached sweep→routes pipeline for one node's vantage (a single-area
    LSDB)."""

    def __init__(self, solver, device=None) -> None:
        """``device`` defaults to the first CUDA card (raises without
        one); tests pass ``"cpu"`` for the plain path."""
        self.solver = solver
        self.device = resolve_device(device)
        self._cache_key = None
        self._sweep = None
        self._selector = None
        self._topo = None
        self._prefixes: List[str] = []
        self._pair_links: Dict = {}
        self.num_engine_builds = 0
        self.num_sweeps = 0

    def _engine_for(self, area_link_states, prefix_state, change_seq) -> None:
        ((area, ls),) = area_link_states.items()
        key = (area, ls.topology_seq, change_seq)
        if self._cache_key == key:
            return
        topo = encode_link_state(ls)
        me = self.solver.my_node_name
        cands = encode_prefix_candidates(prefix_state, topo, area)
        sweep = LinkFailureSweep(topo, me, device=self.device)
        # seed the base solve from the previous generation (exact; only
        # removal-affected vertices re-converge)
        sweep.seed_base_from(self._sweep)
        self._sweep = sweep
        self._selector = SweepRouteSelector(topo, me, cands, max_degree=sweep.D, device=self.device)
        self._topo = topo
        self._prefixes = cands.prefixes
        #: node pair → undirected link ids (parallel links are distinct)
        self._pair_links = build_pair_links(topo.links)
        self._cache_key = key
        self.num_engine_builds += 1

    def run(
        self,
        link_failures: List[Tuple[str, str]],
        area_link_states,
        prefix_state,
        change_seq: int,
        simultaneous: bool = False,
    ) -> Dict:
        """One sweep over the candidate failures: per-failure route deltas
        from this node's vantage.  With ``simultaneous`` ALL listed links
        fail at once (one combined failure entry)."""
        self._engine_for(area_link_states, prefix_state, change_seq)
        me = self.solver.my_node_name
        lane_names = lane_names_for(self._topo, me)
        v4_ok = self.solver.enable_v4 or self.solver.v4_over_v6_nexthop
        lid_sets, errors = resolve_pair_failures(self._pair_links, link_failures)

        def changes_from_row(deltas, row: int) -> List[dict]:
            changes = []
            if row == 0:
                return changes
            base_valid = deltas.base_valid
            p_idx, valid, metric, lanes = deltas.deltas_of_row(row)
            for k in range(len(p_idx)):
                p = int(p_idx[k])
                prefix = self._prefixes[p]
                if prefix_is_v4(prefix) and not v4_ok:
                    continue
                was, now = bool(base_valid[p]), bool(valid[k])
                changes.append(
                    {
                        "prefix": prefix,
                        "change": change_kind(was, now),
                        "old_nexthops": (
                            decode_lane_names(lane_names, deltas.base_lanes[p]) if was else []
                        ),
                        "new_nexthops": decode_lane_names(lane_names, lanes[k]) if now else [],
                        "old_metric": float(deltas.base_metric[p]) if was else None,
                        "new_metric": float(metric[k]) if now else None,
                    }
                )
            return changes

        if simultaneous:
            bad = [e for e in errors if e is not None]
            if bad:
                return {
                    "eligible": True, "vantage": me, "engine": "device",
                    "simultaneous": True, "failures": bad,
                }
            fail_set = tuple(int(l) for tup in lid_sets for l in tup)
            deltas = self._selector.run(self._sweep.run_sets([fail_set], fetch=False))
            self.num_sweeps += 1
            changes = changes_from_row(deltas, int(deltas.snap_row[0]))
            on_dag = self._sweep.on_dag_links()
            return {
                "eligible": True,
                "vantage": me,
                "engine": "device",
                "simultaneous": True,
                "failures": [
                    {
                        "links": [list(f) for f in link_failures],
                        "on_shortest_path_dag": bool(any(on_dag[l] for l in fail_set)),
                        "routes_changed": len(changes),
                        "changes": changes,
                    }
                ],
            }

        # per-failure snapshots; error rows become empty sets (the base)
        deltas = self._selector.run(
            self._sweep.run_sets([s if s is not None else () for s in lid_sets], fetch=False)
        )
        self.num_sweeps += 1
        on_dag = self._sweep.on_dag_links()
        out = []
        for s, ((n1, n2), tup) in enumerate(zip(link_failures, lid_sets)):
            if tup is None:
                out.append(errors[s])
                continue
            changes = changes_from_row(deltas, int(deltas.snap_row[s]))
            entry = {
                "link": [n1, n2],
                "on_shortest_path_dag": bool(any(on_dag[l] for l in tup)),
                "routes_changed": len(changes),
                "changes": changes,
            }
            if len(tup) > 1:
                entry["links_failed"] = len(tup)  # a bundle: ALL failed
            out.append(entry)
        return {"eligible": True, "vantage": me, "engine": "device", "failures": out}


def _whatif_engine_criticality(
    engine: WhatIfApiEngine, area_link_states, prefix_state, change_seq: int,
    max_pairs: int = 0,
) -> Dict:
    """Criticality report over the engine's cached sweep context."""
    engine._engine_for(area_link_states, prefix_state, change_seq)
    v4_ok = engine.solver.enable_v4 or engine.solver.v4_over_v6_nexthop
    return _criticality_from_engine(
        engine._sweep, engine._selector, engine._topo, engine._prefixes, max_pairs, v4_ok
    )


def _criticality_from_engine(sweep, selector, topo, prefixes, max_pairs: int, v4_ok: bool) -> Dict:
    """One single-failure sweep over EVERY link ranks blast radius; an
    optional double-failure scan (at most ``max_pairs`` pairs with at
    least one on-DAG member: an off-DAG link can carry the reroute once
    its on-DAG partner fails, but two off-DAG links change nothing) finds
    pairs whose combined failure withdraws routes neither single failure
    withdraws.  Counts skip v4 prefixes the node would not install."""
    L = len(topo.links)
    deltas = selector.run(sweep.run(np.arange(L, dtype=np.int32), fetch=False))
    on_dag = sweep.on_dag_links()
    skip_p = (
        np.asarray([prefix_is_v4(p) for p in prefixes], bool)
        if not v4_ok
        else np.zeros(len(prefixes), bool)
    )

    def removed_of_row(dl, row: int):
        if row == 0:
            return 0, 0
        p_idx, valid, _m, _l = dl.deltas_of_row(row)
        keep = ~skip_p[p_idx]
        return int(keep.sum()), int((~valid[keep]).sum())

    links = []
    single_removed = {}
    for li in range(L):
        changed, removed = removed_of_row(deltas, int(deltas.snap_row[li]))
        link = topo.links[li]
        single_removed[li] = removed
        links.append(
            {
                "link": sorted((link.n1, link.n2)),
                "on_shortest_path_dag": bool(on_dag[li]),
                "routes_changed": changed,
                "routes_withdrawn": removed,
            }
        )
    links.sort(key=lambda e: (-e["routes_withdrawn"], -e["routes_changed"], e["link"]))

    pairs_out = None
    if max_pairs > 0:
        n_off = int((~on_dag[:L]).sum())

        def gen_pairs():
            for a, b in itertools.combinations(range(L), 2):
                if on_dag[a] or on_dag[b]:
                    yield (a, b)

        capped = list(itertools.islice(gen_pairs(), max_pairs))
        total = L * (L - 1) // 2 - n_off * (n_off - 1) // 2
        pair_deltas = selector.run(sweep.run_sets(capped, fetch=False))
        risky = []
        for s, (a, b) in enumerate(capped):
            _c, removed = removed_of_row(pair_deltas, int(pair_deltas.snap_row[s]))
            extra = removed - single_removed[a] - single_removed[b]
            if extra > 0:
                la, lb = topo.links[a], topo.links[b]
                risky.append(
                    {
                        "links": [sorted((la.n1, la.n2)), sorted((lb.n1, lb.n2))],
                        "routes_withdrawn": removed,
                        "beyond_single_failures": extra,
                    }
                )
        risky.sort(key=lambda e: -e["beyond_single_failures"])
        pairs_out = {
            "checked": len(capped),
            "total": total,
            "truncated": len(capped) < total,
            "risky": risky[:64],
            "risky_count": len(risky),
            "risky_truncated": len(risky) > 64,
        }
    return {"links": links, "pairs": pairs_out}


class MultiAreaWhatIfEngine:
    """Multi-area link-failure what-if from this node's vantage.

    The context (topology encode, candidate table, device tables) is cached
    per LSDB change generation; each ``run`` solves the candidate failures
    plus one unperturbed base row as a single batch on the card and
    decodes only the prefixes whose merged route view changed."""

    def __init__(self, solver, device=None) -> None:
        """``device`` defaults to the first CUDA card (raises without
        one); tests pass ``"cpu"`` for the plain path."""
        self.solver = solver
        self.device = resolve_device(device)
        self._cache_key = None
        self._state = None
        self.num_engine_builds = 0
        self.num_sweeps = 0

    def _context(self, area_link_states, prefix_state, change_seq):
        key = (
            tuple((a, area_link_states[a].topology_seq) for a in sorted(area_link_states)),
            change_seq,
        )
        if self._cache_key == key and self._state is not None:
            return self._state
        me = self.solver.my_node_name
        enc = encode_multi_area(area_link_states, me)
        table = CandidateTable()
        table.full_sync(prefix_state)
        dv = table.derived(enc)
        link_index = np.stack([t.link_index for t in enc.topos])
        # (n1, n2) -> [(area index, link id)]: a pair joined in several
        # areas, or by parallel links, fails as one bundle
        pair_links: Dict[frozenset, list] = {}
        for ai, t in enumerate(enc.topos):
            for pair, vals in build_pair_links(t.links, area_index=ai).items():
                pair_links.setdefault(pair, []).extend(vals)
        topo = tables_from_numpy(
            (enc.src, enc.dst, enc.w, enc.edge_ok, link_index, enc.overloaded, enc.soft, enc.roots),
            self.device,
        )
        cand = tables_from_numpy(dv.selection_inputs(), self.device)
        self._state = dict(
            enc=enc,
            table=table,
            dv=dv,
            pair_links=pair_links,
            out_edges_by_area=[t.root_out_edges(me) for t in enc.topos],
            D=bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS),
            topo=topo,
            cand=cand,
            base_dist=None,  # the on-DAG flags' base, filled on first run
        )
        self._cache_key = key
        self.num_engine_builds += 1
        return self._state

    def _base_dist(self, st) -> np.ndarray:
        """[A, V] distances from me on the unperturbed LSDB (cold segment
        SPF, once per generation)."""
        if st["base_dist"] is None:
            src, dst, w, edge_ok, _li, ovl, _soft, roots = st["topo"]
            dist, _nh = multi_area_spf_tables(src, dst, w, edge_ok, ovl, roots, st["D"])
            (st["base_dist"],) = HostFetch((dist,)).wait()
        return st["base_dist"]

    def run(
        self,
        link_failures: List[Tuple[str, str]],
        area_link_states,
        prefix_state,
        change_seq: int,
        simultaneous: bool = False,
    ) -> Dict:
        """One batched solve over the candidate failures: per-failure route
        changes from this node's vantage.  A pair with several links (in
        one area or across areas) fails as a bundle; with ``simultaneous``
        ALL listed links fail at once (one combined failure entry)."""
        st = self._context(area_link_states, prefix_state, change_seq)
        enc, dv, table = st["enc"], st["dv"], st["table"]
        me = self.solver.my_node_name
        per_area = (
            self.solver.route_selection_algorithm
            == RouteComputationRules.PER_AREA_SHORTEST_DISTANCE
        )
        pairs, errors = resolve_pair_failures(st["pair_links"], link_failures)
        if simultaneous:
            bad = [e for e in errors if e is not None]
            if bad:
                return {
                    "eligible": True, "vantage": me, "engine": "multiarea",
                    "simultaneous": True, "failures": bad,
                }
            # ONE snapshot failing the union of every listed link
            fail_sets: List[Optional[tuple]] = [
                tuple(hit for tup in pairs if tup is not None for hit in tup)
            ]
        else:
            fail_sets = pairs
        # one row per set, then row B: no member at all, the base snapshot
        B = len(fail_sets)
        S = max([len(tup) for tup in fail_sets if tup is not None] or [1])
        fa = np.full((B + 1, S), -1, np.int32)
        fl = np.full((B + 1, S), -1, np.int32)
        for i, tup in enumerate(fail_sets):
            for s, (ai, li) in enumerate(tup or ()):
                fa[i, s], fl[i, s] = ai, li
        src, dst, w, edge_ok, link_index, ovl, soft, roots = st["topo"]
        fa_t, fl_t = tables_from_numpy((fa, fl), self.device)
        outs = whatif_multi_area_tables(
            src, dst, w, edge_ok, link_index, ovl, soft, roots, fa_t, fl_t,
            *st["cand"], max_degree=st["D"], per_area_distance=per_area,
        )
        use, shortest, lanes, valid = HostFetch(outs).wait()
        base_dist = self._base_dist(st)
        self.num_sweeps += 1

        # ---- merged route view per snapshot (SpfSolver.cpp:276-302) ----
        B1, P, _A = valid.shape
        m = np.where(valid, shortest, np.inf)  # [B1, P, A]
        m_star = m.min(axis=2)  # [B1, P]
        at_min = valid & (m == m_star[:, :, None])
        eff_lanes = lanes & at_min[:, :, :, None]  # [B1, P, A, D]
        merged = eff_lanes.sum(axis=(2, 3))  # nexthop count
        req = np.max(np.where(use, dv.min_nexthop[None, :, :], 0), axis=2)  # [B1, P]
        my_gid = table._node_gid.get(me)
        if my_gid is None:
            self_win = np.zeros((B1, P), bool)
        else:
            self_win = (use & (table.adv_gid[None, :, :] == my_gid)).any(axis=2)
        v4_ok = self.solver.enable_v4 or self.solver.v4_over_v6_nexthop
        include = np.asarray(
            [p is not None and (v4_ok or not prefix_is_v4(p)) for p in table.row_prefix],
            bool,
        )
        route_ok = (
            include[None, :] & valid.any(axis=2) & ~self_win & (merged > 0) & (merged >= req)
        )
        base = B
        out_edges_by_area = st["out_edges_by_area"]

        def nh_names(b, p):
            names = []
            for ai, lane in zip(*np.nonzero(eff_lanes[b, p])):
                oe = out_edges_by_area[ai]
                if lane < len(oe):
                    names.append(oe[lane][1])
            return sorted(set(names))

        def on_dag(ai, li):
            """Some directed edge of the link lies on a shortest path from
            me in its area."""
            t = enc.topos[ai]
            d = base_dist[ai]
            transit = (~t.overloaded) | (np.arange(t.padded_nodes) == int(enc.roots[ai]))
            for e in np.nonzero(t.link_index == li)[0]:
                u, v = int(t.src[e]), int(t.dst[e])
                if (
                    t.edge_ok[e] and transit[u] and d[u] < BIG and d[v] < BIG
                    and d[u] + t.w[e] == d[v]
                ):
                    return True
            return False

        def changes_for(s) -> List[dict]:
            # validity flipped, metric moved, or the merged lane set moved
            diff = (route_ok[s] != route_ok[base]) | (
                route_ok[s] & route_ok[base] & (
                    (m_star[s] != m_star[base])
                    | (eff_lanes[s] != eff_lanes[base]).any(axis=(1, 2))
                )
            )
            changes = []
            for p in np.nonzero(diff)[0]:
                was, now = bool(route_ok[base, p]), bool(route_ok[s, p])
                changes.append(
                    {
                        "prefix": table.row_prefix[p],
                        "change": change_kind(was, now),
                        "old_nexthops": nh_names(base, p) if was else [],
                        "new_nexthops": nh_names(s, p) if now else [],
                        "old_metric": float(m_star[base, p]) if was else None,
                        "new_metric": float(m_star[s, p]) if now else None,
                    }
                )
            return changes

        if simultaneous:
            changes = changes_for(0)
            return {
                "eligible": True,
                "vantage": me,
                "engine": "multiarea",
                "simultaneous": True,
                "failures": [
                    {
                        "links": [list(f) for f in link_failures],
                        "on_shortest_path_dag": any(on_dag(ai, li) for ai, li in fail_sets[0]),
                        "routes_changed": len(changes),
                        "changes": changes,
                    }
                ],
            }
        out = []
        for s, ((n1, n2), tup) in enumerate(zip(link_failures, pairs)):
            if tup is None:
                out.append(errors[s])
                continue
            changes = changes_for(s)
            entry = {
                "link": [n1, n2],
                "area": enc.areas[tup[0][0]],
                "on_shortest_path_dag": any(on_dag(ai, li) for ai, li in tup),
                "routes_changed": len(changes),
                "changes": changes,
            }
            if len(tup) > 1:
                # a parallel bundle (within or across areas): all failed
                entry["links_failed"] = len(tup)
                entry["areas"] = sorted({enc.areas[ai] for ai, _ in tup})
            out.append(entry)
        return {"eligible": True, "vantage": me, "engine": "multiarea", "failures": out}


class GenericSolverWhatIfEngine:
    """Algorithm-complete what-if: rebuild the LSDB with the candidate
    links removed and run the full scalar ``SpfSolver``, then diff the
    route databases.  One scalar build per failure (or per simultaneous
    set); it touches no device."""

    engine_label = "generic-solver"

    def __init__(self, solver) -> None:
        self.solver = solver
        self.num_builds = 0
        self._cache_key = None
        self._base_view = None
        self._pair_links: Dict = {}

    def _build(self, states, prefix_state):
        """One full route build; subclasses swap the compute engine."""
        return self.solver.build_route_db(states, prefix_state)

    @staticmethod
    def _pairs_map(area_link_states) -> Dict:
        """pair → occurrences across every area (only the pair's
        uniqueness is read)."""
        m: Dict = {}
        for _area, ls in sorted(area_link_states.items()):
            for pair, vals in build_pair_links(ls.all_links()).items():
                m.setdefault(pair, []).extend(vals)
        return m

    @staticmethod
    def _states_without(area_link_states, drop_pairs) -> Dict:
        out: Dict = {}
        for area, ls in area_link_states.items():
            nls = LinkState(area, ls.my_node_name)
            for _node, db in sorted(ls.get_adjacency_databases().items()):
                filtered = dataclasses.replace(
                    db,
                    adjacencies=[
                        a
                        for a in db.adjacencies
                        if frozenset((db.this_node_name, a.other_node_name)) not in drop_pairs
                    ],
                )
                nls.update_adjacency_database(filtered)
            out[area] = nls
        return out

    def run(
        self,
        link_failures: List[Tuple[str, str]],
        area_link_states,
        prefix_state,
        change_seq: int,
        simultaneous: bool = False,
    ) -> Optional[Dict]:
        me = self.solver.my_node_name

        def view(db):
            if db is None:  # the vantage is absent from the (modified) LSDB
                return {}
            return {
                p: (float(e.igp_cost), sorted({n.neighbor_node_name for n in e.nexthops}))
                for p, e in db.unicast_routes.items()
            }

        key = (
            change_seq,
            tuple((a, area_link_states[a].topology_seq) for a in sorted(area_link_states)),
        )
        if self._cache_key != key:
            base = self._build(area_link_states, prefix_state)
            self.num_builds += 1
            if base is None:
                return None  # no vantage in the LSDB yet: ineligible
            self._base_view = view(base)
            self._pair_links = self._pairs_map(area_link_states)
            self._cache_key = key
        base_view = self._base_view
        # removal is by node PAIR, which drops every parallel adjacency
        resolved, errors = resolve_pair_failures(self._pair_links, link_failures)
        v4_ok = self.solver.enable_v4 or self.solver.v4_over_v6_nexthop

        def diff_against(mod_db) -> List[dict]:
            mod_view = view(mod_db)
            changes = []
            for p in sorted(set(base_view) | set(mod_view)):
                if prefix_is_v4(p) and not v4_ok:
                    continue
                old, new = base_view.get(p), mod_view.get(p)
                if old == new:
                    continue
                changes.append(
                    {
                        "prefix": p,
                        "change": change_kind(old is not None, new is not None),
                        "old_nexthops": old[1] if old else [],
                        "new_nexthops": new[1] if new else [],
                        "old_metric": old[0] if old else None,
                        "new_metric": new[0] if new else None,
                    }
                )
            return changes

        def solve_without(drop_pairs) -> List[dict]:
            mod = self._states_without(area_link_states, drop_pairs)
            self.num_builds += 1
            return diff_against(self._build(mod, prefix_state))

        if simultaneous:
            bad = [e for e in errors if e is not None]
            if bad:
                return {
                    "eligible": True, "vantage": me, "engine": self.engine_label,
                    "simultaneous": True, "failures": bad,
                }
            changes = solve_without({frozenset(p) for p in link_failures})
            return {
                "eligible": True,
                "vantage": me,
                "engine": self.engine_label,
                "simultaneous": True,
                "failures": [
                    {
                        "links": [list(f) for f in link_failures],
                        "on_shortest_path_dag": bool(changes),
                        "routes_changed": len(changes),
                        "changes": changes,
                    }
                ],
            }

        out = []
        for (n1, n2), hit, err in zip(link_failures, resolved, errors):
            if hit is None:
                out.append(err)
                continue
            changes = solve_without({frozenset((n1, n2))})
            entry = {
                "link": [n1, n2],
                "on_shortest_path_dag": bool(changes),
                "routes_changed": len(changes),
                "changes": changes,
            }
            if len(hit) > 1:
                entry["links_failed"] = len(hit)
            out.append(entry)
        return {"eligible": True, "vantage": me, "engine": self.engine_label, "failures": out}


class DeviceBuildWhatIfEngine(GenericSolverWhatIfEngine):
    """What-if for LSDBs outside the sweep kernels' algebra (KSP2_ED_ECMP
    prefixes) served by device full builds instead of the scalar solver:
    the generic engine's rebuild-and-diff, with each build on a dedicated
    ``CudaBackend`` (SPF and selection on the card, KSP2 prefixes through
    the device KSP2 engine), the compute path of the daemon's own route
    builds.  The dedicated backend keeps what-if builds on modified
    topologies out of the daemon backend's caches.

    A build the device does not implement (disabled best-route selection,
    another selection algorithm, a candidate row wider than the largest
    bucket) is the backend's counted scalar build, so answers never differ
    from ``GenericSolverWhatIfEngine``'s."""

    engine_label = "device-build"

    def __init__(self, solver, device=None) -> None:
        super().__init__(solver)
        self._backend = CudaBackend(solver, device=device)

    def _build(self, states, prefix_state):
        return self._backend.build_route_db(
            states, prefix_state, force_full=True, cache_result=False
        )
