"""Columnar candidate table: PrefixState → [cap, C] selection inputs.

Every prefix is one row; its advertisements ((node, area) → PrefixEntry),
in sorted (node, area) order, are the row's C candidate columns.  The
metric columns ([cap, C] int32: drain / path-pref / source-pref /
distance / min-nexthop) are topology-independent.  Advertiser identity is
stored as interned GLOBAL ids (node gid, area gid), and the per-area
candidate ids the kernels read (`cand_node`, `cand_area`,
`cand_node_in_area`) are derived from them by vectorized lookups against
the current encoding.  Row capacity and candidate width grow in buckets.

This is the full-sync half of ``openr_tpu.decision.cand_table``; the
incremental dirty-row path belongs to the delta-selection build.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from openr_tpu_torch.ops.csr import EncodedMultiArea, bucket_for

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


class CandidateTable:
    def __init__(self) -> None:
        # interning (grow-only; survives topology re-encodes)
        self._node_gid: Dict[str, int] = {}
        self._gid_names: List[str] = []
        self._area_gid: Dict[str, int] = {}
        self._area_names: List[str] = []
        self.pid: Dict[str, int] = {}
        self.row_prefix: List[Optional[str]] = []
        self.cap = 0
        self.C = CAND_BUCKETS[0]
        self._alloc(0, self.C)

    def _alloc(self, cap: int, C: int) -> None:
        self.cap, self.C = cap, C
        self.adv_gid = np.full((cap, C), -1, np.int32)
        self.adv_area = np.zeros((cap, C), np.int32)
        self.drain = np.zeros((cap, C), np.int32)
        self.pp = np.zeros((cap, C), np.int32)
        self.sp = np.zeros((cap, C), np.int32)
        self.dist = np.zeros((cap, C), np.int32)
        self.minnh = np.zeros((cap, C), np.int32)

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

    def full_sync(self, prefix_state) -> None:
        """Rebuild every row from PrefixState.  Raises ValueError when a
        prefix has more candidates than the largest candidate bucket."""
        all_prefixes = prefix_state.prefixes()
        widest = max((len(e) for e in all_prefixes.values()), default=1)
        if widest > CAND_BUCKETS[-1]:
            raise ValueError(
                f"prefix with {widest} candidates exceeds the largest "
                f"candidate bucket {CAND_BUCKETS[-1]}"
            )
        cap = max(self.cap, bucket_for(max(len(all_prefixes), 1), ROW_BUCKETS))
        C = max(self.C, bucket_for(max(widest, 1), CAND_BUCKETS))
        self._alloc(cap, C)
        self.pid = {}
        self.row_prefix = [None] * cap
        # columnar fill: one pass building flat index/value lists, then a
        # single scatter per column — no per-cell numpy __setitem__
        rows: List[int] = []
        cols: List[int] = []
        vals: List[tuple] = []
        for r, (prefix, entries) in enumerate(all_prefixes.items()):
            self.pid[prefix] = r
            self.row_prefix[r] = prefix
            for c, ((node, area), entry) in enumerate(sorted(entries.items())):
                m = entry.metrics
                rows.append(r)
                cols.append(c)
                vals.append(
                    (
                        self._gid(node),
                        self._agid(area),
                        m.drain_metric,
                        m.path_preference,
                        m.source_preference,
                        m.distance,
                        entry.min_nexthop or 0,
                    )
                )
        if rows:
            ri = np.asarray(rows, np.int64)
            ci = np.asarray(cols, np.int64)
            v = np.asarray(vals, np.int32)
            for j, col in enumerate(
                (self.adv_gid, self.adv_area, self.drain, self.pp, self.sp,
                 self.dist, self.minnh)
            ):
                col[ri, ci] = v[:, j]

    def derived(self, enc: EncodedMultiArea) -> DerivedCandidates:
        """Vectorized gid → per-area-id resolution for the current
        topology encoding.  Candidates advertised in unknown areas or by
        nodes absent from their area's graph come out cand_ok=False
        (scalar: unreachable, filtered before selection —
        SpfSolver.cpp:195-215)."""
        A = enc.num_areas
        G = len(self._gid_names)
        gid_to_area_ids = np.full((G + 1, A), -1, np.int32)  # +1: -1 pad
        for ai, topo in enumerate(enc.topos):
            node_ids = topo.node_ids
            for g, name in enumerate(self._gid_names):
                nid = node_ids.get(name)
                if nid is not None:
                    gid_to_area_ids[g, ai] = nid
        area_gid_to_ai = np.full(len(self._area_names) + 1, -1, np.int32)
        for ai, a in enumerate(enc.areas):
            ag = self._area_gid.get(a)
            if ag is not None:
                area_gid_to_ai[ag] = ai

        gid = self.adv_gid
        present = gid >= 0
        ai = np.where(present, area_gid_to_ai[self.adv_area], -1)  # [R, C]
        # node id in every area (gid -1 → lookup row G, all -1)
        nid_by_area = gid_to_area_ids[np.where(present, gid, -1)]  # [R, C, A]
        nid = np.take_along_axis(
            nid_by_area, np.maximum(ai, 0)[:, :, None], axis=2
        )[:, :, 0]
        ok = present & (ai >= 0) & (nid >= 0)
        return DerivedCandidates(
            cand_area=np.where(ok, ai, 0).astype(np.int32),
            cand_node=np.where(ok, nid, 0).astype(np.int32),
            cand_ok=ok,
            drain_metric=self.drain,
            path_pref=self.pp,
            source_pref=self.sp,
            distance=self.dist,
            min_nexthop=self.minnh,
            cand_node_in_area=np.where(
                present[:, :, None], nid_by_area, -1
            ).astype(np.int32),
        )
