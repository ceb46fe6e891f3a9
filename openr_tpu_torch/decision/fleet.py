"""Fleet RIB engine: every node's RouteDb from one batched solve on the
card — the counterpart of ``openr_tpu/decision/fleet.py``.

The ctrl API's getRouteDbComputed answers "what routes would node X
compute?"; the reference daemon runs a fresh scalar SpfSolver pass per
call (Decision.cpp:342), so a fleet-wide sweep costs |V| Dijkstras.  Here
every vantage node is one row of a batched solve (``ops/fleet_tables.py``:
per-area SPF from the row's root, an area the node is absent from masked
unreachable, then the global selection), the tables are cached until the
LSDB changes, and each request decodes only its own row through the same
decode the route build uses (``CudaBackend._decode_rows``).

Eligibility (else the caller answers with the scalar solver):
SHORTEST_DISTANCE or PER_AREA_SHORTEST_DISTANCE with best-route
selection, and no KSP2_ED_ECMP advertisement.

After an LSDB change the engine re-solves every root, and when the
previous generation's outputs are still on the card (dense encodings,
tables up to ``DELTA_MAX_TABLE_BYTES``) and every input of the decode maps
the same way, each chunk diffs against them on the card: only the changed
roots' rows cross to the host, the others patch through from the previous
host tables.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS, CudaBackend
from openr_tpu_torch.decision.cand_table import CandidateTable
from openr_tpu_torch.decision.rib import DecisionRouteDb
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops.csr import bucket_for, encode_multi_area
from openr_tpu_torch.ops.fleet_tables import (
    fleet_multi_area_tables,
    fleet_multi_area_tables_dense,
    fleet_multi_area_tables_dense_delta,
)
from openr_tpu_torch.ops.route_select import gather_selection_rows
from openr_tpu_torch.ops.sweep_select import HostFetch
from openr_tpu_torch.types import (
    PrefixForwardingAlgorithm,
    RouteComputationRules,
    prefix_is_v4,
)

#: vantage roots per solve: the chunk layout of the generation delta
ROOT_CHUNK = 1024

_DENSE_FIELDS = ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "soft")
_SEGMENT_FIELDS = ("src", "dst", "w", "edge_ok", "overloaded", "soft")


class FleetRibEngine:
    """Caches all-roots selection tables per LSDB change generation."""

    #: device-resident fleet outputs beyond this size are not retained as
    #: a delta base
    DELTA_MAX_TABLE_BYTES = 64 << 20

    def __init__(self, solver: SpfSolver, device: DeviceLike = None) -> None:
        self.solver = solver  # settings template (v4 flags, labels, algo)
        self.device = resolve_device(device)
        self._cache_key = None
        self._state = None  # cached tables + decode context
        self._ksp2_scan = None  # (change_seq, result)
        #: the previous generation's delta base (device chunk outputs,
        #: host tables and the input mappings they are valid for)
        self._prev_gen = None
        self.num_batched_solves = 0
        self.num_decodes = 0
        self.num_delta_solves = 0
        self.num_delta_roots_fetched = 0
        self.num_delta_roots_skipped = 0

    # -- eligibility -------------------------------------------------------

    def eligible(self, area_link_states, prefix_state, change_seq) -> bool:
        if not area_link_states:
            return False
        s = self.solver
        if not s.enable_best_route_selection or s.route_selection_algorithm not in (
            RouteComputationRules.SHORTEST_DISTANCE,
            RouteComputationRules.PER_AREA_SHORTEST_DISTANCE,
        ):
            return False
        # the O(P*C) KSP2 scan is cached on the change generation
        if self._ksp2_scan is not None and self._ksp2_scan[0] == change_seq:
            return self._ksp2_scan[1]
        ok = not any(
            entry.forwarding_algorithm == PrefixForwardingAlgorithm.KSP2_ED_ECMP
            for entries in prefix_state.prefixes().values()
            for entry in entries.values()
        )
        self._ksp2_scan = (change_seq, ok)
        return ok

    # -- table computation (cached) ---------------------------------------

    def _tables_for(self, area_link_states, prefix_state, change_seq):
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
        # every node taking part in ANY area gets a vantage row
        names = sorted(set().union(*[set(t.node_ids) for t in enc.topos]))
        roots_mat = np.asarray(
            [[t.node_ids.get(n, -1) for t in enc.topos] for n in names], np.int32
        )
        D = bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
        per_area = (
            self.solver.route_selection_algorithm
            == RouteComputationRules.PER_AREA_SHORTEST_DISTANCE
        )
        fields = _DENSE_FIELDS if enc.has_dense else _SEGMENT_FIELDS
        topo = tables_from_numpy([getattr(enc, k) for k in fields], self.device)
        cand = tables_from_numpy(dv.selection_inputs(), self.device)
        B = len(names)
        P, C = dv.cand_ok.shape
        A = enc.num_areas

        delta = self._fleet_delta_ctx(enc, table, names, roots_mat, D, dv)
        if delta is not None:
            use = delta["use"].copy()
            shortest = delta["shortest"].copy()
            lanes = delta["lanes"].copy()
            valid = delta["valid"].copy()
            self.num_delta_solves += 1
        else:
            use = np.empty((B, P, C), bool)
            shortest = np.empty((B, P, A), np.float32)
            lanes = np.empty((B, P, A, D), bool)
            valid = np.empty((B, P, A), bool)

        # every chunk is enqueued with its host copy before the first wait
        kw = dict(max_degree=D, per_area_distance=per_area)
        chunk_outs: Dict[int, tuple] = {}
        fetches = []
        for off in range(0, B, ROOT_CHUNK):
            (roots,) = tables_from_numpy((roots_mat[off : off + ROOT_CHUNK],), self.device)
            if delta is not None:
                *out, ch = fleet_multi_area_tables_dense_delta(
                    *topo, roots, *cand, *delta["chunks"][off], **kw
                )
                fetches.append(HostFetch((ch,)))
            elif enc.has_dense:
                out = fleet_multi_area_tables_dense(*topo, roots, *cand, **kw)
                fetches.append(HostFetch(out))
            else:
                out = fleet_multi_area_tables(*topo, roots, *cand, **kw)
                fetches.append(HostFetch(out))
            chunk_outs[off] = tuple(out)
        for off, fetch in zip(chunk_outs, fetches):
            n = min(ROOT_CHUNK, B - off)
            if delta is None:
                u, s_, l, v = fetch.wait()
                use[off : off + n] = u
                shortest[off : off + n] = s_
                lanes[off : off + n] = l
                valid[off : off + n] = v
                continue
            (ch,) = fetch.wait()
            rows = np.nonzero(ch)[0]
            self.num_delta_roots_fetched += len(rows)
            self.num_delta_roots_skipped += n - len(rows)
            if not len(rows):
                continue
            (idx,) = tables_from_numpy((rows.astype(np.int64),), self.device)
            gu, gs, gl, gv = HostFetch(gather_selection_rows(*chunk_outs[off], idx)).wait()
            use[off + rows] = gu
            shortest[off + rows] = gs
            lanes[off + rows] = gl
            valid[off + rows] = gv
        self._state = dict(
            enc=enc,
            dv=dv,
            table=table,
            names=names,
            index={n: i for i, n in enumerate(names)},
            use=use,
            shortest=shortest,
            lanes=lanes,
            valid=valid,
        )
        self._retain_fleet_delta(enc, table, names, roots_mat, D, dv, chunk_outs)
        self._cache_key = key
        self.num_batched_solves += 1
        return self._state

    def _fleet_delta_ctx(self, enc, table, names, roots_mat, D, dv):
        """The previous generation's device outputs may vouch for "root
        unchanged" only when every kernel input maps the same way: the same
        vantage list and per-area root ids, the same symbol tables (value
        equality: every generation re-encodes), the same candidate
        row → prefix mapping and shapes.  The decode reads prefix entries,
        drain lookups and min-nexthop fresh per request, so they pin
        nothing."""
        prev = self._prev_gen
        if prev is None or not enc.has_dense:
            return None
        if (
            prev["degree"] != D
            or prev["names"] != names
            or not np.array_equal(prev["roots_mat"], roots_mat)
            or prev["shape"] != dv.cand_ok.shape
            or prev["row_prefix"] != table.row_prefix
            or prev["id_to_node"] != [t.id_to_node for t in enc.topos]
        ):
            return None
        return prev

    def _retain_fleet_delta(self, enc, table, names, roots_mat, D, dv, chunk_outs) -> None:
        st = self._state
        table_bytes = sum(st[k].nbytes for k in ("use", "shortest", "lanes", "valid"))
        if not enc.has_dense or table_bytes > self.DELTA_MAX_TABLE_BYTES:
            self._prev_gen = None
            return
        self._prev_gen = dict(
            degree=D,
            names=list(names),
            roots_mat=roots_mat,
            shape=dv.cand_ok.shape,
            row_prefix=list(table.row_prefix),
            id_to_node=[t.id_to_node for t in enc.topos],
            chunks=chunk_outs,
            use=st["use"],
            shortest=st["shortest"],
            lanes=st["lanes"],
            valid=st["valid"],
        )

    # -- per-root decode (the route build's own decode) ---------------------

    def compute_for_node(
        self, node: str, area_link_states, prefix_state, change_seq
    ) -> Optional[DecisionRouteDb]:
        """The RouteDb ``node`` would compute, decoded from the cached batch
        tables; None when the node is unknown (the caller falls back)."""
        st = self._tables_for(area_link_states, prefix_state, change_seq)
        ri = st["index"].get(node)
        if ri is None:
            return None
        self.num_decodes += 1
        # a host-side decoder: the backend allocates nothing on the device
        decoder = CudaBackend(self._vantage_solver(node), device=self.device)
        table = st["table"]
        row_items = [
            (int(r), table.row_prefix[r])
            for r in np.nonzero(st["use"][ri].any(axis=1))[0]
            if table.row_prefix[r] is not None
        ]
        results = decoder._decode_rows(
            row_items, st["use"][ri], st["shortest"][ri], st["lanes"][ri],
            st["valid"][ri], st["dv"], None, st["enc"], area_link_states,
            prefix_state,
        )
        db = DecisionRouteDb()
        for _prefix, entry in sorted(results.items()):
            if entry is not None:
                db.add_unicast_route(entry)
        if self.solver.enable_node_segment_label:
            decoder.solver._build_node_label_routes(area_link_states, db)
        return db

    def _vantage_solver(self, node: str) -> SpfSolver:
        s = self.solver
        return SpfSolver(
            node,
            enable_v4=s.enable_v4,
            enable_node_segment_label=s.enable_node_segment_label,
            enable_best_route_selection=s.enable_best_route_selection,
            v4_over_v6_nexthop=s.v4_over_v6_nexthop,
            route_selection_algorithm=s.route_selection_algorithm,
        )

    # -- fleet summary -----------------------------------------------------

    def fleet_summary(self, area_link_states, prefix_state, change_seq) -> Dict[str, dict]:
        """Per-node unicast route counts and total nexthops from one batch
        solve, with the decode's own gates (v4 family, skip-if-self,
        min-nexthop over the cross-area merge), so the counts always match
        ``compute_for_node``."""
        st = self._tables_for(area_link_states, prefix_state, change_seq)
        dv, table = st["dv"], st["table"]
        use, shortest, lanes, valid = st["use"], st["shortest"], st["lanes"], st["valid"]
        B, P, _A = valid.shape
        v4_ok = self.solver.enable_v4 or self.solver.v4_over_v6_nexthop
        include = np.asarray(
            [p is not None and (v4_ok or not prefix_is_v4(p)) for p in table.row_prefix],
            bool,
        )  # [P]
        # cross-area min-metric merge, vectorized (SpfSolver.cpp:276-302)
        m = np.where(valid, shortest, np.inf)  # [B, P, A]
        m_star = m.min(axis=2)  # [B, P]
        at_min = valid & (m == m_star[:, :, None])
        num_nh_area = lanes.sum(axis=3)  # [B, P, A]
        merged = (num_nh_area * at_min).sum(axis=2)  # [B, P]
        # per-root gates, as the decode applies them: the min-nexthop
        # requirement is the max over THIS root's selection winners only,
        # and skip-if-self is by global advertiser identity (a root that
        # never advertises has no gid and never self-wins)
        adv_gid = table.adv_gid  # [P, C] (-1 = empty slot)
        gid_of = table._node_gid
        self_win = np.zeros((B, P), bool)
        req = np.zeros((B, P), np.int32)
        for i, name in enumerate(st["names"]):
            req[i] = np.max(np.where(use[i], dv.min_nexthop, 0), axis=1)
            g = gid_of.get(name)
            if g is not None:
                self_win[i] = (use[i] & (adv_gid == g)).any(axis=1)
        route_ok = (
            include[None, :]
            & valid.any(axis=2)
            & ~self_win
            & (merged > 0)
            & (merged >= req)
        )
        return {
            name: {
                "num_routes": int(route_ok[i].sum()),
                "total_nexthops": int(merged[i][route_ok[i]].sum()),
            }
            for i, name in enumerate(st["names"])
        }
