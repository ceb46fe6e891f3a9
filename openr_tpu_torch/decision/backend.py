"""Decision compute backend on a CUDA card: the cold full route build.

The backend seam is the reference's pure-compute boundary (SpfSolver takes
LinkState/PrefixState in, RouteDb out, SpfSolver.h:136).  `CudaBackend` is
the counterpart of ``openr_tpu.decision.backend.TpuBackend``'s cold,
single-device, full build:

  1. encode: LinkStates → dense in-edge planes (``ops/csr.py``) and
     PrefixState → [cap, C] candidate table (``decision/cand_table.py``),
     copied to the device
  2. per-area SPF from me: ``multi_area_spf_tables_dense`` (two CUDA
     kernels: distances, nexthop lanes)
  3. global best-route selection over the whole [cap, C] table:
     ``multi_area_select_from_tables`` (one CUDA kernel)
  4. host decode: selection winners → RibUnicastEntries, with the
     per-area lane → Link decode and the cross-area min-metric merge
     (SpfSolver.cpp:276-302); then the static-route overlay and the
     node-segment-label MPLS routes, which stay scalar (O(nodes))

On a CUDA device every build runs the hand kernels, with no fallback; on
the CPU (``device="cpu"``) the same path runs their plain PyTorch
versions.  Both must produce the RouteDb the scalar ``SpfSolver``
produces.

Not in this backend, each raising ``NotImplementedError`` instead of
taking a silent scalar path: KSP2_ED_ECMP prefixes, encodings without the
dense in-edge planes (in-degree above the largest bucket), prefixes with
more candidates than the largest candidate bucket, and disabled
best-route selection.  Incremental, warm and delta hints are accepted and
answered with a full cold build, which yields the same RouteDb.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from openr_tpu_torch.decision.cand_table import CandidateTable
from openr_tpu_torch.decision.link_state import INF, LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb, RibUnicastEntry
from openr_tpu_torch.decision.spf_solver import SpfSolver, drained_entry
from openr_tpu_torch.device import DeviceLike, resolve_device, synchronize
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops.csr import bucket_for, encode_multi_area
from openr_tpu_torch.ops.route_select import (
    multi_area_select_from_tables,
    multi_area_spf_tables_dense,
)
from openr_tpu_torch.types import (
    NextHop,
    PrefixForwardingAlgorithm,
    RouteComputationRules,
    prefix_is_v4,
)

#: max-out-degree lane buckets (the D axis of the lane tables)
DEGREE_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)


class DecisionBackend:
    def build_route_db(
        self,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
        changed_prefixes=None,
        force_full: bool = False,
        cache_result: bool = True,
        warm_delta: bool = False,
        structural_delta: bool = False,
    ) -> Optional[DecisionRouteDb]:
        """Full RouteDb for the solver's node, or None when that node is
        in no area.  The hints (``changed_prefixes``, ``force_full``,
        ``cache_result``, ``warm_delta``, ``structural_delta``) carry the
        reference's meaning; a backend may ignore them as long as the
        result equals a cold full build."""
        raise NotImplementedError


class CudaBackend(DecisionBackend):
    """Device-accelerated buildRouteDb (cold full build)."""

    def __init__(self, solver: SpfSolver, device: DeviceLike = None) -> None:
        self.solver = solver  # static/MPLS routes, drain lookups
        self.device = resolve_device(device)
        self._cand_table = CandidateTable()
        #: (area/topology_seq key, pinned LinkStates, encoding, device
        #: planes): prefix-only rebuilds reuse the encoding
        self._enc_cache: Optional[tuple] = None
        self.num_device_builds = 0
        self.num_encode_hits = 0
        #: host wall time of the last build's phases, in ms; phases end
        #: with a device synchronize so kernel time lands in its phase
        self.last_phase_ms: Dict[str, float] = {}

    # -- build -------------------------------------------------------------

    def build_route_db(
        self,
        area_link_states,
        prefix_state,
        changed_prefixes=None,
        force_full=False,
        cache_result=True,
        warm_delta=False,
        structural_delta=False,
    ):
        solver = self.solver
        if not solver.enable_best_route_selection or (
            solver.route_selection_algorithm
            not in (
                RouteComputationRules.SHORTEST_DISTANCE,
                RouteComputationRules.PER_AREA_SHORTEST_DISTANCE,
            )
        ):
            raise NotImplementedError(
                "the device route build implements enabled best-route "
                "selection with SHORTEST_DISTANCE or "
                "PER_AREA_SHORTEST_DISTANCE only"
            )
        me = solver.my_node_name
        if not any(ls.has_node(me) for ls in area_link_states.values()):
            return None
        dev = self.device
        phase: Dict[str, float] = {}
        t0 = t = time.perf_counter()

        def lap(name):
            nonlocal t
            synchronize(dev)
            now = time.perf_counter()
            phase[name] = (now - t) * 1e3
            t = now

        enc, planes = self._encoded(area_link_states, me)
        table = self._cand_table
        try:
            table.full_sync(prefix_state)
        except ValueError as e:
            raise NotImplementedError(
                f"{e}; wider candidate rows are not supported by the "
                "device selection kernel"
            ) from e
        dv = table.derived(enc)
        cand = tables_from_numpy(
            (
                dv.cand_area,
                dv.cand_node,
                dv.cand_ok,
                dv.drain_metric,
                dv.path_pref,
                dv.source_pref,
                dv.distance,
                dv.cand_node_in_area,
            ),
            dev,
        )
        lap("encode")

        D = bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
        in_src, in_w, in_ok, in_rank, in_has, ovl, roots, soft = planes
        dist, nh = self._spf_tables(
            in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D
        )
        lap("spf")

        per_area = (
            solver.route_selection_algorithm
            == RouteComputationRules.PER_AREA_SHORTEST_DISTANCE
        )
        outs = self._select(dist, nh, ovl, soft, *cand, per_area)
        lap("select")

        use, shortest, lanes, valid = (o.cpu().numpy() for o in outs)
        winners = np.nonzero(use.any(axis=1))[0]
        row_items = [
            (int(r), table.row_prefix[r])
            for r in winners
            if table.row_prefix[r] is not None
        ]
        results = self._decode_rows(
            row_items, use, shortest, lanes, valid, dv, enc,
            area_link_states, prefix_state,
        )
        route_db = DecisionRouteDb()
        for entry in results.values():
            if entry is not None:
                route_db.add_unicast_route(entry)
        # static-route overlay + MPLS labels: scalar (small)
        for prefix, sentry in solver.get_static_routes().items():
            if prefix not in route_db.unicast_routes:
                route_db.add_unicast_route(sentry)
        if solver.enable_node_segment_label:
            solver._build_node_label_routes(area_link_states, route_db)
        lap("decode")
        phase["total"] = (time.perf_counter() - t0) * 1e3
        self.last_phase_ms = phase
        self.num_device_builds += 1
        return route_db

    # -- device steps (kernel dispatch by device) --------------------------

    def _spf_tables(self, in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D):
        return multi_area_spf_tables_dense(
            in_src, in_w, in_ok, in_rank, in_has, ovl, roots, max_degree=D
        )

    def _select(self, dist, nh, ovl, soft, *cand_and_flag):
        return multi_area_select_from_tables(dist, nh, ovl, soft, *cand_and_flag)

    # -- encoding (cached across prefix-only rebuilds) ---------------------

    def _encoded(self, area_link_states, me):
        areas = sorted(area_link_states)
        key = tuple((a, area_link_states[a].topology_seq) for a in areas)
        cached = self._enc_cache
        # identity is compared via held references (a bare id() could be
        # reused by a replacement object after GC and serve stale arrays)
        if (
            cached is not None
            and cached[0] == key
            and all(ls is area_link_states[a] for a, ls in zip(areas, cached[1]))
        ):
            self.num_encode_hits += 1
            return cached[2], cached[3]
        enc = encode_multi_area(area_link_states, me)
        if not enc.has_dense:
            raise NotImplementedError(
                "an area's in-degree exceeds the dense in-edge buckets; the "
                "segment-form SPF kernels are a later port slice"
            )
        planes = tables_from_numpy(
            (
                enc.in_src,
                enc.in_w,
                enc.in_ok,
                enc.in_rank,
                enc.in_has,
                enc.overloaded,
                enc.roots,
                enc.soft,
            ),
            self.device,
        )
        self._enc_cache = (key, [area_link_states[a] for a in areas], enc, planes)
        return enc, planes

    # -- decode ------------------------------------------------------------

    def _decode_rows(
        self,
        row_items: List[Tuple[int, str]],
        use,  # [cap, C]
        shortest,  # [cap, A]
        lanes,  # [cap, A, D]
        valid,  # [cap, A]
        dv,
        enc,
        area_link_states,
        prefix_state,
    ) -> Dict[str, Optional[RibUnicastEntry]]:
        """Decode device outputs for the given (row, prefix) pairs.

        Everything per-winner is vectorized up front (one object-array
        fancy-index resolves every winner name; one ufunc.at pass each
        computes the skip-if-self and min-nexthop gates) and the ECMP
        memo is keyed by the row's raw bytes: many prefixes share one
        advertiser, and their nexthop set + igp metric are fully
        determined by (v4ness, lane bits, per-area validity and metric)."""
        me = self.solver.my_node_name
        all_entries = prefix_state.prefixes()
        out_edges_by_area = [t.root_out_edges(me) for t in enc.topos]
        v4_ok = self.solver.enable_v4 or self.solver.v4_over_v6_nexthop

        R = use.shape[0]
        u_rows, u_cols = np.nonzero(use)
        u_starts = np.searchsorted(u_rows, np.arange(R + 1)).tolist()
        ai_w = dv.cand_area[u_rows, u_cols]
        nid_w = dv.cand_node[u_rows, u_cols]
        num_areas = len(enc.topos)
        max_v = max((len(t.id_to_node) for t in enc.topos), default=1)
        name_lut = np.full((num_areas, max(max_v, 1)), None, dtype=object)
        for ai, t in enumerate(enc.topos):
            name_lut[ai, : len(t.id_to_node)] = t.id_to_node
        names_obj = name_lut[ai_w, nid_w]  # [W] object
        names_w = names_obj.tolist()
        areas_w = [enc.areas[a] for a in ai_w.tolist()]
        # row gates: any-winner-is-self, min-nexthop requirement (max
        # over winners, addBestPaths SpfSolver.cpp:596-620; unset is
        # encoded 0 and never gates)
        self_any = np.zeros(R, bool)
        req = np.zeros(R, np.int64)
        if len(u_rows):
            np.logical_or.at(self_any, u_rows, names_obj == me)
            np.maximum.at(req, u_rows, dv.min_nexthop[u_rows, u_cols])
        self_l = self_any.tolist()
        req_l = req.tolist()
        comp = np.concatenate(
            [
                np.ascontiguousarray(lanes.reshape(R, -1), dtype=np.uint8),
                valid.astype(np.uint8),
                np.ascontiguousarray(shortest, dtype=np.float32)
                .view(np.uint8)
                .reshape(R, -1),
            ],
            axis=1,
        )
        nh_memo: Dict[tuple, Optional[tuple]] = {}
        drain_cache: Dict[Tuple[str, str], bool] = {}

        results: Dict[str, Optional[RibUnicastEntry]] = {}
        for i, prefix in row_items:
            c0 = u_starts[i]
            c1 = u_starts[i + 1]
            if c0 == c1:
                results[prefix] = None
                continue
            if c1 - c0 == 1:
                best = (names_w[c0], areas_w[c0])
            else:
                best = min((names_w[k], areas_w[k]) for k in range(c0, c1))
            entries = all_entries[prefix]
            # the forwarding algorithm of the MIN selection winner
            # classifies the prefix (SpfSolver.cpp:247-250)
            if (
                entries[best].forwarding_algorithm
                == PrefixForwardingAlgorithm.KSP2_ED_ECMP
            ):
                raise NotImplementedError(
                    f"prefix {prefix} selects KSP2_ED_ECMP; the KSP2 "
                    "device engine is a later port slice"
                )
            is_v4 = prefix_is_v4(prefix)
            if is_v4 and not v4_ok:
                results[prefix] = None
                continue
            if self_l[i]:
                results[prefix] = None  # skip-if-self (SpfSolver.cpp:253)
                continue
            key = (comp[i].tobytes(), is_v4)
            cached = nh_memo.get(key, False)
            if cached is False:
                cached = self._merged_nexthops(
                    is_v4, lanes[i], valid[i], shortest[i], out_edges_by_area
                )
                nh_memo[key] = cached
            if cached is None:
                results[prefix] = None
                continue
            total_next_hops, shortest_metric = cached
            if req_l[i] > len(total_next_hops):
                results[prefix] = None
                continue
            best_entry = entries.get(best)
            if best_entry is None:
                results[prefix] = None
                continue
            dr = drain_cache.get(best)
            if dr is None:
                dr = self.solver._is_node_drained(best, area_link_states)
                drain_cache[best] = dr
            entry = drained_entry(best_entry) if dr else best_entry
            local_considered = any(n == me for (n, _a) in entries.keys())
            results[prefix] = RibUnicastEntry(
                prefix=prefix,
                nexthops=total_next_hops,
                best_prefix_entry=entry,
                best_area=best[1],
                igp_cost=shortest_metric,
                local_prefix_considered=local_considered,
            )
        return results

    def _merged_nexthops(
        self,
        is_v4,
        lanes_row,  # [A, D] for this row
        valid_row,  # [A]
        shortest_row,  # [A]
        out_edges_by_area,
    ) -> Optional[tuple]:
        """Per-area lane decode + cross-area min-metric nexthop merge
        (SpfSolver.cpp:276-302) for one distinct route signature; the
        caller memoizes the result.  Returns (frozen nexthop set, igp
        metric) or None when no usable nexthops survive."""
        me = self.solver.my_node_name
        shortest_metric = INF
        total_next_hops: set = set()
        a_idx, l_idx = np.nonzero(lanes_row)
        by_area: Dict[int, list] = {}
        for ai, lane in zip(a_idx.tolist(), l_idx.tolist()):
            by_area.setdefault(ai, []).append(lane)
        for ai, lanes_hit in by_area.items():
            if not valid_row[ai]:
                continue
            m = float(shortest_row[ai])
            out_edges = out_edges_by_area[ai]
            nhs = set()
            for lane in lanes_hit:
                if lane >= len(out_edges):
                    continue
                link, neighbor = out_edges[lane]
                nhs.add(
                    NextHop(
                        address=(
                            link.get_nh_v4_from_node(me)
                            if is_v4 and not self.solver.v4_over_v6_nexthop
                            else link.get_nh_v6_from_node(me)
                        ),
                        if_name=link.get_iface_from_node(me),
                        metric=int(m),
                        area=link.area,
                        neighbor_node_name=neighbor,
                    )
                )
            if not nhs:
                continue
            if shortest_metric >= m:
                if shortest_metric > m:
                    shortest_metric = m
                    total_next_hops.clear()
                total_next_hops |= nhs
        # the memoized value is handed to MANY RibUnicastEntry objects;
        # freeze it so no later in-place mutation of one route's
        # nexthops can corrupt its siblings
        if not total_next_hops:
            return None
        return frozenset(total_next_hops), shortest_metric
