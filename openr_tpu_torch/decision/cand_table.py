"""Columnar candidate table: PrefixState → [cap, C] selection inputs.

Every prefix is one row; its advertisements ((node, area) → PrefixEntry),
in sorted (node, area) order, are the row's C candidate columns.  The
metric columns ([cap, C] int32: drain / path-pref / source-pref /
distance / min-nexthop) are topology-independent, so a prefix churn
touches only its own row (``apply_dirty``).  Advertiser identity is
stored as interned GLOBAL ids (node gid, area gid), so a topology
re-encode never re-reads PrefixState: the per-area candidate ids the
kernels read (`cand_node`, `cand_area`, `cand_node_in_area`) are derived
from them by vectorized lookups against the current encoding, and the
derived view is refreshed only for dirty rows while the encoding is
unchanged.  Row capacity and candidate width grow in buckets.  Rows of
deleted prefixes go on a free list and are reused; a free row is
all-invalid (`adv_gid == -1`) and produces no route.

This is ``openr_tpu.decision.cand_table``, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from openr_tpu_torch.ops.csr import CapacityError, EncodedMultiArea, bucket_for

ROW_BUCKETS = (
    64,
    256,
    1024,
    4096,
    16384,
    65536,
    262144,
    1048576,
    4194304,
    16777216,
)
CAND_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass
class DerivedCandidates:
    """Per-EncodedMultiArea view of the table (numpy, [cap, C])."""

    cand_area: np.ndarray  # [cap, C] int32 area index (0 where not ok)
    cand_node: np.ndarray  # [cap, C] int32 id in own area (0 where not ok)
    cand_ok: np.ndarray  # [cap, C] bool
    drain_metric: np.ndarray  # [cap, C] int32
    path_pref: np.ndarray  # [cap, C] int32
    source_pref: np.ndarray  # [cap, C] int32
    distance: np.ndarray  # [cap, C] int32
    min_nexthop: np.ndarray  # [cap, C] int32 (0 = unset)
    cand_node_in_area: np.ndarray  # [cap, C, A] int32 (-1 = absent)

    def selection_inputs(self):
        """The eight columns the multi-area selection takes, in its
        argument order."""
        return (
            self.cand_area, self.cand_node, self.cand_ok, self.drain_metric,
            self.path_pref, self.source_pref, self.distance, self.cand_node_in_area,
        )


class CandidateTable:
    def __init__(
        self,
        row_buckets: Sequence[int] = ROW_BUCKETS,
        cand_buckets: Sequence[int] = CAND_BUCKETS,
    ) -> None:
        self.row_buckets = tuple(row_buckets)
        self.cand_buckets = tuple(cand_buckets)
        # interning (grow-only; survives topology re-encodes)
        self._node_gid: Dict[str, int] = {}
        self._gid_names: List[str] = []
        self._area_gid: Dict[str, int] = {}
        self._area_names: List[str] = []
        # rows
        self.pid: Dict[str, int] = {}
        self.row_prefix: List[Optional[str]] = []
        self._free: List[int] = []
        self.cap = 0
        self.C = self.cand_buckets[0]
        # columns [cap, C]
        self.adv_gid = np.full((0, self.C), -1, np.int32)
        self.adv_area = np.zeros((0, self.C), np.int32)
        self.drain = np.zeros((0, self.C), np.int32)
        self.pp = np.zeros((0, self.C), np.int32)
        self.sp = np.zeros((0, self.C), np.int32)
        self.dist = np.zeros((0, self.C), np.int32)
        self.minnh = np.zeros((0, self.C), np.int32)
        # derived-view cache, and the gid → per-area id lookups of the
        # encoding it was derived for
        self._derived: Optional[DerivedCandidates] = None
        self._lookup_cache: Optional[tuple] = None
        self._derived_enc: Optional[EncodedMultiArea] = None
        self._derived_dirty_rows: Set[int] = set()
        self._full_synced = False

    # -- interning ---------------------------------------------------------

    def _gid(self, node: str) -> int:
        g = self._node_gid.get(node)
        if g is None:
            g = len(self._gid_names)
            self._node_gid[node] = g
            self._gid_names.append(node)
        return g

    def _agid(self, area: str) -> int:
        g = self._area_gid.get(area)
        if g is None:
            g = len(self._area_names)
            self._area_gid[area] = g
            self._area_names.append(area)
        return g

    # -- capacity management ----------------------------------------------

    def _grow_rows(self, need: int) -> None:
        new_cap = bucket_for(need, self.row_buckets)
        if new_cap <= self.cap:
            return
        pad = new_cap - self.cap

        def grow(a, fill):
            return np.concatenate(
                [a, np.full((pad, a.shape[1]), fill, a.dtype)]
            )

        self.adv_gid = grow(self.adv_gid, -1)
        self.adv_area = grow(self.adv_area, 0)
        self.drain = grow(self.drain, 0)
        self.pp = grow(self.pp, 0)
        self.sp = grow(self.sp, 0)
        self.dist = grow(self.dist, 0)
        self.minnh = grow(self.minnh, 0)
        self._free.extend(range(new_cap - 1, self.cap - 1, -1))
        self.row_prefix.extend([None] * pad)
        self.cap = new_cap
        self._derived = None  # shapes changed; regenerate view

    def _widen(self, need: int) -> None:
        new_c = bucket_for(need, self.cand_buckets)
        if new_c <= self.C:
            return
        pad = new_c - self.C

        def widen(a, fill):
            return np.concatenate(
                [a, np.full((a.shape[0], pad), fill, a.dtype)], axis=1
            )

        self.adv_gid = widen(self.adv_gid, -1)
        self.adv_area = widen(self.adv_area, 0)
        self.drain = widen(self.drain, 0)
        self.pp = widen(self.pp, 0)
        self.sp = widen(self.sp, 0)
        self.dist = widen(self.dist, 0)
        self.minnh = widen(self.minnh, 0)
        self.C = new_c
        self._derived = None

    # -- row encoding ------------------------------------------------------

    def _encode_row(self, r: int, entries) -> None:
        """Fill row r from one prefix's {(node, area) -> PrefixEntry} map.
        Candidate order is sorted (node, area) — deterministic, matching
        the scalar path's iteration for bestNodeArea recovery."""
        items = sorted(entries.items())
        if len(items) > self.C:
            if len(items) > self.cand_buckets[-1]:
                raise CapacityError(
                    f"prefix with {len(items)} candidates exceeds the "
                    f"largest candidate bucket {self.cand_buckets[-1]}"
                )
            self._widen(len(items))
        self.adv_gid[r, :] = -1
        for c, ((node, area), entry) in enumerate(items):
            m = entry.metrics
            self.adv_gid[r, c] = self._gid(node)
            self.adv_area[r, c] = self._agid(area)
            self.drain[r, c] = m.drain_metric
            self.pp[r, c] = m.path_preference
            self.sp[r, c] = m.source_preference
            self.dist[r, c] = m.distance
            self.minnh[r, c] = entry.min_nexthop or 0
        self._derived_dirty_rows.add(r)

    def _clear_row(self, r: int) -> None:
        self.adv_gid[r, :] = -1
        self._derived_dirty_rows.add(r)

    # -- sync API ----------------------------------------------------------

    def full_sync(self, prefix_state) -> None:
        """Rebuild every row from PrefixState (initial build / fallback)."""
        all_prefixes = prefix_state.prefixes()
        self.pid.clear()
        self._free.clear()
        self._grow_rows(max(len(all_prefixes), 1))
        self.row_prefix = [None] * self.cap
        self.adv_gid[:, :] = -1
        # columnar fill: one pass building flat index/value lists, then a
        # single scatter per column — no per-cell numpy __setitem__
        rows: List[int] = []
        cols: List[int] = []
        v_gid: List[int] = []
        v_area: List[int] = []
        v_drain: List[int] = []
        v_pp: List[int] = []
        v_sp: List[int] = []
        v_dist: List[int] = []
        v_minnh: List[int] = []
        widest = 1
        for r, (prefix, entries) in enumerate(all_prefixes.items()):
            self.pid[prefix] = r
            self.row_prefix[r] = prefix
            items = sorted(entries.items())
            widest = max(widest, len(items))
            for c, ((node, area), entry) in enumerate(items):
                m = entry.metrics
                rows.append(r)
                cols.append(c)
                v_gid.append(self._gid(node))
                v_area.append(self._agid(area))
                v_drain.append(m.drain_metric)
                v_pp.append(m.path_preference)
                v_sp.append(m.source_preference)
                v_dist.append(m.distance)
                v_minnh.append(entry.min_nexthop or 0)
        if widest > self.C:
            if widest > self.cand_buckets[-1]:
                raise CapacityError(
                    f"prefix with {widest} candidates exceeds the largest "
                    f"candidate bucket {self.cand_buckets[-1]}"
                )
            self._widen(widest)
        n = len(all_prefixes)
        self._free = list(range(self.cap - 1, n - 1, -1))
        if rows:
            ri = np.asarray(rows, np.int64)
            ci = np.asarray(cols, np.int64)
            self.adv_gid[ri, ci] = np.asarray(v_gid, np.int32)
            self.adv_area[ri, ci] = np.asarray(v_area, np.int32)
            self.drain[ri, ci] = np.asarray(v_drain, np.int32)
            self.pp[ri, ci] = np.asarray(v_pp, np.int32)
            self.sp[ri, ci] = np.asarray(v_sp, np.int32)
            self.dist[ri, ci] = np.asarray(v_dist, np.int32)
            self.minnh[ri, ci] = np.asarray(v_minnh, np.int32)
        self._derived = None
        self._full_synced = True

    def apply_dirty(self, prefix_state, changed: Iterable[str]) -> None:
        """Re-encode only the changed prefixes (add/update/delete)."""
        if not self._full_synced:
            self.full_sync(prefix_state)
            return
        all_prefixes = prefix_state.prefixes()
        for prefix in changed:
            entries = all_prefixes.get(prefix)
            r = self.pid.get(prefix)
            if entries:
                if r is None:
                    if not self._free:
                        self._grow_rows(self.cap + 1)
                    r = self._free.pop()
                    self.pid[prefix] = r
                    self.row_prefix[r] = prefix
                self._encode_row(r, entries)
            elif r is not None:
                del self.pid[prefix]
                self.row_prefix[r] = None
                self._clear_row(r)
                self._free.append(r)

    # -- derived view ------------------------------------------------------

    def derived(self, enc: EncodedMultiArea) -> DerivedCandidates:
        """Vectorized gid → per-area-id resolution for the current
        topology encoding.  Candidates advertised in unknown areas or by
        nodes absent from their area's graph come out cand_ok=False
        (scalar: unreachable, filtered before selection —
        SpfSolver.cpp:195-215)."""
        A = enc.num_areas
        G = len(self._gid_names)
        AG = len(self._area_names)
        cache = self._lookup_cache
        if cache is not None and cache[0] is enc and cache[1] == (G, AG):
            gid_to_area_ids, area_gid_to_ai = cache[2], cache[3]
        else:
            gid_to_area_ids = np.full((G + 1, A), -1, np.int32)  # +1: -1 pad
            for ai, topo in enumerate(enc.topos):
                node_ids = topo.node_ids
                for g, name in enumerate(self._gid_names):
                    nid = node_ids.get(name)
                    if nid is not None:
                        gid_to_area_ids[g, ai] = nid
            area_gid_to_ai = np.full(AG + 1, -1, np.int32)
            for ai, a in enumerate(enc.areas):
                ag = self._area_gid.get(a)
                if ag is not None:
                    area_gid_to_ai[ag] = ai
            self._lookup_cache = (enc, (G, AG), gid_to_area_ids, area_gid_to_ai)

        if self._derived is not None and self._derived_enc is enc:
            rows = sorted(self._derived_dirty_rows)
            if not rows:
                return self._derived
            ri = np.asarray(rows, np.int64)
            d = self._derived
            self._fill_derived(
                d, gid_to_area_ids, area_gid_to_ai, ri
            )
            self._derived_dirty_rows.clear()
            return d

        d = DerivedCandidates(
            cand_area=np.zeros((self.cap, self.C), np.int32),
            cand_node=np.zeros((self.cap, self.C), np.int32),
            cand_ok=np.zeros((self.cap, self.C), bool),
            drain_metric=self.drain,
            path_pref=self.pp,
            source_pref=self.sp,
            distance=self.dist,
            min_nexthop=self.minnh,
            cand_node_in_area=np.full((self.cap, self.C, A), -1, np.int32),
        )
        self._fill_derived(d, gid_to_area_ids, area_gid_to_ai, None)
        self._derived = d
        self._derived_enc = enc
        self._derived_dirty_rows.clear()
        return d

    def _fill_derived(
        self, d, gid_to_area_ids, area_gid_to_ai, rows: Optional[np.ndarray]
    ) -> None:
        sl = slice(None) if rows is None else rows
        gid = self.adv_gid[sl]  # [R, C]
        agid = self.adv_area[sl]
        present = gid >= 0
        ai = np.where(present, area_gid_to_ai[agid], -1)  # [R, C]
        # node id in own area (gid -1 → lookup row G, all -1)
        nid_by_area = gid_to_area_ids[np.where(present, gid, -1)]  # [R, C, A]
        nid = np.take_along_axis(
            nid_by_area, np.maximum(ai, 0)[:, :, None], axis=2
        )[:, :, 0]
        ok = present & (ai >= 0) & (nid >= 0)
        d.cand_area[sl] = np.where(ok, ai, 0)
        d.cand_node[sl] = np.where(ok, nid, 0)
        d.cand_ok[sl] = ok
        d.cand_node_in_area[sl] = np.where(
            present[:, :, None], nid_by_area, -1
        )
        # metric columns are shared references (self.drain etc.) — no copy

    # -- introspection -----------------------------------------------------

    def rows_for(self, prefixes: Iterable[str]) -> List[int]:
        return [self.pid[p] for p in prefixes if p in self.pid]

    @property
    def num_prefixes(self) -> int:
        return len(self.pid)
