"""What-if sweep engine: N link-failure snapshots → full SPF tables — the
counterpart of ``openr_tpu/ops/whatif.py`` (the flagship workload: 10k
single-link failures of a 1024-node WAN).

Exact optimizations over the device kernels:

  1. the unperturbed topology is solved once (the base);
  2. a failure of a link on NO shortest path from the root changes
     neither distances nor first-hop sets, so it aliases the base;
  3. identical failures alias one solve;
  4. each remaining solve is the warm repair of ``ops/repair.py``
     (kernel 9), depth-sorted so each chunk holds similar depths.

Lanes stay bit-packed over the snapshots ([V, lanes, b/32] words).
Results come back as a unique-solve table plus a per-snapshot row map.

The base solve is, in order: a cross-generation warm seed (kernel 9 with
no failed link, from the previous engine's plan) ▸ the cold sweep kernel
(kernel 8, ``ops/spf.py``).  The reference's native C++ step between the
two is not part of the port; all of them reach the same fixed point.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from openr_tpu_torch.device import resolve_device, synchronize
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels.build import KernelError
from openr_tpu_torch.ops.bits import unpack_bits_last
from openr_tpu_torch.ops.csr import EncodedTopology
from openr_tpu_torch.ops.repair import (
    RepairPlan,
    RepairSweep,
    PLAN_CACHE,
    build_pull_tables,
    warm_base_from_previous,
)
from openr_tpu_torch.ops.spf import sweep_spf_link_failures

@dataclasses.dataclass
class SweepResult:
    """Unique-solve dist/nh tables + snapshot index map.

    Row 0 is the base solve; snapshot s lives at row ``snap_row[s]``.
    Device-resident while ``chunks`` is set (downstream selection reads
    them in place); ``materialize()`` fetches them to dense host tables."""

    snap_row: np.ndarray  # [B] int32
    num_device_solves: int  # unique on-DAG solves computed
    num_snapshots: int
    lanes: int  # lane count == root out-degree
    dist: Optional[np.ndarray] = None  # [U, V] f32 (host)
    nh: Optional[np.ndarray] = None  # [U, V, lanes] int8 (host)
    #: device-resident chunks: (row_offset, n, dist [V, b], nh [V, lanes, b/32])
    chunks: Optional[List[tuple]] = None
    #: (base_dist [V], base_nh [V, lanes]) host copies
    base: Optional[tuple] = None

    def block(self) -> None:
        """Wait for the device work (a timing barrier; no fetch)."""
        if self.chunks:
            synchronize(self.chunks[-1][2].device)

    def materialize(self) -> "SweepResult":
        if self.dist is not None:
            return self
        V = self.base[0].shape[0]
        U = 1 + self.num_device_solves
        self.dist = np.empty((U, V), np.float32)
        self.nh = np.empty((U, V, self.lanes), np.int8)
        self.dist[0] = self.base[0]
        self.nh[0] = self.base[1]
        for off, n, dist_d, nh_d in self.chunks or []:
            self.dist[1 + off : 1 + off + n] = dist_d[:, :n].t().cpu().numpy()
            bits = unpack_bits_last(nh_d, n)  # [V, lanes, n]
            self.nh[1 + off : 1 + off + n] = bits.permute(2, 0, 1).to(torch.int8).cpu().numpy()
        self.chunks = None
        return self

    def dist_of(self, snapshot: int) -> np.ndarray:
        self.materialize()
        return self.dist[self.snap_row[snapshot]]

    def nh_of(self, snapshot: int) -> np.ndarray:
        """Dense [V, lanes] int8 first-hop lane sets for one snapshot."""
        self.materialize()
        return self.nh[self.snap_row[snapshot]]


def root_lane_count(topo: EncodedTopology, root_id: int) -> int:
    """Lane count for a sweep vantage: the root's out-degree (lane r is
    the r-th directed out-edge of the root in edge order)."""
    return max(int(((topo.src == root_id) & (topo.link_index >= 0)).sum()), 1)


class LinkFailureSweep:
    """Per-(topology, root) sweep engine over the warm repair kernel,
    with base aliasing, the off-DAG skip and dedup."""

    def __init__(
        self,
        topo: EncodedTopology,
        root: str,
        max_chunk: int = 4096,
        device=None,
    ) -> None:
        """``max_chunk``: most unique solves per repair launch (rounded up
        to a multiple of 32).  ``device`` defaults to the first CUDA card."""
        self.device = resolve_device(device)
        self.topo = topo
        self.root = root
        self.root_id = topo.node_id(root)
        self.max_chunk = max(32, ((max_chunk + 31) // 32) * 32)
        self.D = root_lane_count(topo, self.root_id)
        (
            self._src, self._dst, self._w, self._edge_ok, self._link_index,
            self._overloaded,
        ) = tables_from_numpy(
            (topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index, topo.overloaded),
            self.device,
        )
        self._base: Optional[tuple] = None  # (dist [V], nh [V, D] int8)
        self._repair = None  # lazy RepairSweep
        self._plan = None
        self._base_seed = None  # cross-generation warm init
        self._pull_tables = None  # (lanes, tables) reused by plan()
        #: how the base solve was produced: "warm" | "device"
        self.base_source = "unset"

    # -- base solve + repair plan ------------------------------------------

    def seed_base_from(self, old_engine) -> bool:
        """Warm-start this engine's base solve from a previous generation's
        engine (same root, same node symbol table): only vertices affected
        by removed/weakened links re-solve.  True when the seed applies;
        exact either way.  An old generation whose plan fails leaves this
        engine cold, unless a kernel failed to build, load or launch
        (:class:`KernelError`): that propagates."""
        if old_engine is None or self._base is not None or old_engine.root_id != self.root_id:
            return False
        try:
            old_plan = old_engine.plan()
        except KernelError:  # a kernel that fails to build or launch is no cold start
            raise
        except Exception:  # the old generation is unusable: stay cold
            return False
        seed = warm_base_from_previous(self.topo, self.root_id, old_engine.topo, old_plan)
        if seed is None:
            return False
        self._base_seed = seed
        return True

    def _edges(self):
        return (self._src, self._dst, self._w, self._link_index)

    def _warm_base_solve(self):
        """Base solve through the repair kernel from the warm seed: no
        failed link, the seed's reset vertices at BIG."""
        d0, nh0, _lanes_same = self._base_seed
        V = self.topo.padded_nodes
        vw = (V + 31) // 32
        transit = (~self.topo.overloaded) | (np.arange(V) == self.root_id)
        # pull tables are base-independent: build once, reuse in plan()
        lanes, pt = build_pull_tables(self.topo, self.root_id)
        self._pull_tables = (lanes, pt)
        if nh0 is None or nh0.shape[1] != lanes:
            nh0 = np.zeros((V, lanes), np.int8)
        plan = RepairPlan(
            root_id=self.root_id,
            lanes=lanes,
            vw=vw,
            aff_link_words=np.zeros((1, vw), np.uint32),
            repair_depth=np.ones(1, np.int32),
            on_dag_link=np.zeros(1, bool),
            base_dist=d0,
            base_nh=nh0,
            transit_src_ok=self.topo.edge_ok & transit[self.topo.src],
            **pt,
        )
        # the seed is an over-estimate, not the topology's own solve: every
        # vertex is worked
        rs = RepairSweep(self.topo, plan, self.device, edges=self._edges(), exact_base=False)
        dist, nh, _, _ = rs.solve(np.full(rs.batch_granularity, -1, np.int32))
        return (
            dist[:, 0].cpu().numpy(),
            (nh[:, :, 0] & 1).to(torch.int8).cpu().numpy(),  # snapshot 0
        )

    def base_solve(self):
        """(dist [V] f32, nh [V, D] int8) for the unperturbed topology:
        the warm seed's repair when there is one, else the cold sweep
        kernel over one word of unperturbed snapshots."""
        if self._base is None:
            if self._base_seed is not None:
                self._base = self._warm_base_solve()
                self.base_source = "warm"
                return self._base
            failed = torch.full((32,), -1, dtype=torch.int32, device=self.device)
            dist, nh, _, _ = sweep_spf_link_failures(
                self._src, self._dst, self._w, self._edge_ok, self._link_index,
                failed, self._overloaded, self.root_id, self.D,
            )
            self._base = (
                dist[:, 0].cpu().numpy(),
                (nh[:, 0] > 0).to(torch.int8).cpu().numpy(),
            )
            self.base_source = "device"
        return self._base

    def plan(self) -> RepairPlan:
        """Host-side repair plan, built once per engine and memoized
        across engines by topology content (``ops/repair.py``)."""
        if self._plan is None:
            base_dist, base_nh = self.base_solve()
            self._plan = PLAN_CACHE.plan(
                self.topo, self.root_id, base_dist, base_nh, self._pull_tables
            )
        return self._plan

    def repair_sweep(self) -> RepairSweep:
        if self._repair is None:
            # the plan's base is this topology's own solve
            self._repair = RepairSweep(
                self.topo, self.plan(), self.device, edges=self._edges(), exact_base=True
            )
        return self._repair

    def on_dag_links(self) -> np.ndarray:
        """bool [L]: links with a directed edge on some shortest path from
        the root; failing any other link leaves the result unchanged."""
        return self.plan().on_dag_link

    @property
    def base_was_warm(self) -> bool:
        return self.base_source == "warm"

    def _chunk_sizes(self, n: int) -> List[int]:
        """Chunks of ``max_chunk`` solves, the last one the rest rounded
        up to a multiple of 32 (the lane words pack 32 snapshots)."""
        sizes: List[int] = []
        remaining = n
        while remaining > 0:
            b = min(self.max_chunk, ((remaining + 31) // 32) * 32)
            sizes.append(b)
            remaining -= b
        return sizes

    def _solve_chunks(self, todo_sorted, k: int) -> List[tuple]:
        """Dispatch every chunk of the depth-sorted unique solves (a [b]
        or [b, k] -1 padded failure array each); nothing waits."""
        rs = self.repair_sweep()
        chunks: List[tuple] = []
        off = 0
        for b in self._chunk_sizes(len(todo_sorted)):
            chunk = todo_sorted[off : off + b]
            padded = np.full((b, k), -1, np.int32)
            for i, key in enumerate(chunk):
                padded[i, : len(key)] = key
            dist_d, nh_d, _, _ = rs.solve(padded)
            chunks.append((off, len(chunk), dist_d, nh_d))
            off += len(chunk)
        return chunks

    # -- the sweep ---------------------------------------------------------

    def run(self, failed_links: np.ndarray, fetch: bool = True) -> SweepResult:
        """Single-link sweep.  With ``fetch=False`` the unique-solve tables
        stay on the device (``block()`` / ``materialize()`` as needed)."""
        failed_links = np.asarray(failed_links, np.int32)
        B = len(failed_links)
        base = self.base_solve()
        plan = self.plan()
        # off-DAG failures (and -1) alias row 0; the rest map to one row
        # per unique link id
        effective = np.where(
            (failed_links >= 0) & plan.on_dag_link[np.clip(failed_links, 0, None)],
            failed_links,
            -1,
        )
        unique, inverse = np.unique(effective, return_inverse=True)
        if len(unique) == 0 or unique[0] != -1:
            unique = np.concatenate([[-1], unique]).astype(np.int32)
            inverse = inverse + 1
        todo = unique[1:]
        # depth-sort the unique solves (similar depths share a chunk)
        depth_order = (
            np.argsort(plan.repair_depth[todo], kind="stable")
            if len(todo) else np.zeros(0, np.int64)
        )
        todo_sorted = todo[depth_order]
        row_of_unique = np.empty(1 + len(todo), np.int32)
        row_of_unique[0] = 0
        row_of_unique[1 + depth_order] = 1 + np.arange(len(todo), dtype=np.int32)
        snap_row = row_of_unique[inverse].astype(np.int32)

        chunks = self._solve_chunks([(int(l),) for l in todo_sorted], 1)
        result = SweepResult(
            snap_row=snap_row,
            num_device_solves=len(todo_sorted),
            num_snapshots=B,
            lanes=self.D,
            chunks=chunks,
            base=base,
        )
        return result.materialize() if fetch else result

    def run_sets(self, fail_sets, fetch: bool = True) -> SweepResult:
        """Simultaneous failures: snapshot b fails EVERY link of
        ``fail_sets[b]`` at once.  The affected region of a set is the
        union of its links' regions; off-DAG members contribute none but
        their edges are still disabled (they may carry the reroute).  A
        set with no on-DAG member aliases the base, and duplicate sets
        share one solve."""
        plan = self.plan()
        base = self.base_solve()
        L = len(plan.on_dag_link)
        eff: List[tuple] = []
        for s in fail_sets:
            members = sorted(
                {int(l) for l in np.atleast_1d(np.asarray(s, np.int32)) if 0 <= int(l) < L}
            )
            eff.append(tuple(members))
        B = len(eff)
        uniq: Dict[tuple, int] = {}
        todo: List[tuple] = []
        snap_row = np.zeros(B, np.int32)
        for key in eff:
            if not any(plan.on_dag_link[l] for l in key):
                continue  # the whole set off-DAG: base alias
            if key not in uniq:
                uniq[key] = len(todo)
                todo.append(key)
        # depth-sort the unique sets by their deepest member
        depths = (
            np.asarray([max(plan.repair_depth[list(k)]) for k in todo], np.int32)
            if todo else np.zeros(0, np.int32)
        )
        order = np.argsort(depths, kind="stable")
        row_of_uniq = np.empty(len(todo), np.int32)
        row_of_uniq[order] = 1 + np.arange(len(todo), dtype=np.int32)
        for b, key in enumerate(eff):
            if key in uniq:
                snap_row[b] = row_of_uniq[uniq[key]]
        todo_sorted = [todo[i] for i in order]
        k = max((len(key) for key in todo_sorted), default=1)
        result = SweepResult(
            snap_row=snap_row,
            num_device_solves=len(todo_sorted),
            num_snapshots=B,
            lanes=self.D,
            chunks=self._solve_chunks(todo_sorted, k),
            base=base,
        )
        return result.materialize() if fetch else result
