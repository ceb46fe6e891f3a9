#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openr_tpu_torch``) on one card.

Drives the port's main path, ``CudaBackend.build_route_db``, on a 4096-node
grid with 100 prefixes per node (409,600 prefixes), then on a small 3-area
world once per selection algorithm:

  1. a cold build
  2. a rebuild after a link metric change (unhinted: a cold solve)
  3. a rebuild after a node is hard-drained (unhinted)
  4. the 3-area world, SHORTEST_DISTANCE and PER_AREA_SHORTEST_DISTANCE

and then the steady-state ticks on the same grid, each with the hints
Decision passes:

  5. prefix churn: 2,048 withdrawals and 2,048 new prefixes with
     ``changed_prefixes`` (the gathered [K, C] selection)
  6. node1 undrained, ``warm_delta`` (the full-edge warm kernels; the
     root's second lane opens, so most lanes move from their warm seed,
     and too many rows move for a gathered selection)
  7. a pure-weakening metric increase on one link, ``warm_delta`` (the
     bounded warm repair and the warm-selective selection)
  8. the metric restored, ``warm_delta`` (the full-edge warm kernels; the
     lanes below the link move back from their seed)
  9. two unhinted drain ticks with ``changed_prefixes=set()``: the first
     keeps its selection outputs, the second diffs against them on the
     card (the fused select + delta kernel and the changed-row gather);
     then the 3-area world of step 4, each algorithm through two unhinted
     drain ticks (c3, then b4), both on the delta path

and, between them, membership churn on the grid's backends (a node or link
joining or leaving: the slot-stable encode), each tick with its hints:

  m-a. node3640, far from node0, leaves (``structural_delta``): its slot
       and rows tombstoned, the bounded warm repair, a warm-selective
       selection
  m-b. it rejoins: the full-edge warm kernels, warm-selective
  m-c. node1, a root neighbour, leaves: the root's lanes change, so the
       full-edge warm kernels and a full selection
  m-d. unhinted: node4096 takes node1's slot, links and prefixes: a cold
       solve, the fused select + delta with the renamed slot in its
       changed-node mask, the changed-row gather
  m-e. node568 leaves and node4097 joins on its links in one tick: no slot
       is free yet (``slot_exhaustion``), a cold encode and solve
  m-f. a new link node4048-node4050 (``new_link``): a cold encode on the
       same symbol table, the full-edge warm kernels, warm-selective

each checking its slot-patch and decline counters and printing its encode
phase (on m-a and m-d beside a fresh cold build's, whose RouteDb it must
equal; the others are held by the plain path and the oracle sample) and
the wall of all six (the grid is then put back without a build); and after
the 3-area drain ticks, c5 leaving area 3 per algorithm (the slot patch
there, the perturbation patch in areas 1 and 2)

and then the single-area link-failure what-if path (kernels 8-11):

 10. the headline world of the reference's benchmark (1024-node WAN, 2048
     chords, seed 7, a loopback per node, vantage node0): 10,240 seeded
     single-link failures through ``LinkFailureSweep.run`` and
     ``SweepRouteSelector.run`` (a cold base: the cold sweep kernel), then
     a second generation with one of node0's links raised, warm-seeded
     from the first (the repair kernel solves the base)
 11. ``_whatif_engine_criticality`` over every link of that world with a
     16,384-pair scan, through ``WhatIfApiEngine``
 12. ``WhatIfApiEngine.run`` on the grid: node0's two links plus 30 seeded
     random links, then one simultaneous set of 3 links (failing a root
     link moves about half the routes, so the compaction overflows its
     first buffer and re-runs on the card)

and then the fleet RIB and the multi-area what-if (kernels 12-14):

 13. ``FleetRibEngine`` on the reference benchmark's fleet world (the same
     WAN, a /24 per node, benchmarks/suite.py:437-455 at --full): a cold
     ``fleet_summary`` (kernels 12 and 13), ``compute_for_node`` for every
     one of the 1,024 roots (timed: decode-all), then a generation with one
     link raised and one restoring it (the delta on the card: the changed
     roots fetched, the rest skipped)
 14. the fleet on the 3-area world (both algorithms; most roots are absent
     from two areas) and on a hub with 1,025 leaves, whose in-degree
     declines the dense layout (kernels 14 and 13), ``CudaBackend`` on the
     hub world (kernel 14 at one row) and two unhinted drain ticks there
     (leaf0, then leaf1: the delta path at D = 2,048), and kernel 14 at one
     row against kernels 1/2 on the grid
 15. ``MultiAreaWhatIfEngine`` from the ABR m0_0 of the registered
     wan_multi_area class at 1,024 nodes, seed 7 (63 areas): every single
     link failure of area "0" and metro0 in one batch (203 rows and the
     base row), then metro0's two homing links as one simultaneous set

and then KSP2_ED_ECMP on a backbone (kernel 15) and the shapes whose
block state exceeds shared memory (kernels 12 and 14's frontier form,
whose lane lists live in a global scratch beside its frontier state):

 16. the wan_hierarchy class at 8,192 nodes, seed 7 (V = 16,384,
     E = 32,768), vantage core0, node labels on every node and a KSP2 /32
     loopback on all but the last two (every second one also SR-MPLS): a
     cold build (kernel 15 at one row per destination), prefix churn that
     adds the last two nodes' loopbacks and withdraws one (kernel 15 at
     two rows), a ``warm_delta`` weakening of a backbone link (the k-path
     memo clears: kernel 15 at every destination again), then
     ``DeviceBuildWhatIfEngine`` on 4 seeded backbone links over 64 seeded
     loopbacks
 17. ``FleetRibEngine`` on the fattree_multipod class at 2,048 (2,064
     roots, V = 4,096, K = 64: kernels 12 and 13),
     ``CudaBackend`` on a hub of 5,000 leaves (V = 16,384, the segment
     form: kernel 14's frontier form at one row, its fill over the card),
     and kernel 14 at 8 rows of 1-3-link failed sets on the backbone

and then the flagship what-if step (kernels 16 and 17):

 18. ``spf_and_select`` (per-snapshot SPF, kernel 16, then per-snapshot
     selection, kernel 17, with no host sync between) on the headline
     world (V = 1,024, 3,071 links, E = 8,192, D = 17) at 4,096 rows: rows
     0-3,070 fail each link once from node0; rows 3,071-4,095 fail link
     7b mod 3,071, hard-drain node 13b mod 1,024, soft-drain node 29b mod
     1,024 by 60 and root at node b mod 1,024; a loopback per node and 64
     anycast /24s of 4 advertisers (P = 1,088, C = 4).  Then
     ``batched_spf_distinct`` on 64 WANs of the same class (seeds 7-70)
     and ``graft_entry.entry()`` at the reference's own shape (grid 4,
     B = 4)

and last the backend's admission path, under a health governor on a
``SimClock`` (1 build in 8 shadow-verified, the first always; the breaker
open after 2 counted failures; no jitter):

 19. on a new copy of the grid, (a) a cold build (kernels 1-3), verified
     clean, equal to step 1's; on the 3-area world (on the grid they
     would add three full scalar builds of it: PERF.md §5), after its own
     verified cold build, (b) injected silent corruption and a forced build: the kernels
     launch, the shadow check finds the mismatch, the backend is
     quarantined and serves the scalar RouteDb, (c) one quarantined build
     (no launch, a counted injected fallback), (d) healed, the clock past
     the hold, a forced build: the probe runs the cold kernels, is verified
     and restores the device; on the grid again, (e) kernel 3's launcher
     raises ``build.KernelError`` once: it propagates out of
     ``build_route_db`` with every counter, the breaker and the latch as
     they were, and the next build launches kernel 3.  On the 3-area
     world: disabled best-route selection, an empty area map and
     ``min_device_prefixes`` above the prefix count, and a 65-candidate
     prefix on a 66-node line, each a counted scalar build with no launch;
     a ``RuntimeError`` twice from the device build opens the breaker.
     The auto cutover's measured dispatch round trip and its choice for
     the grid, the 3-area world and a 6-node ring.

Every backend of steps 1-18 runs without a governor
(``ResilienceConfig(enabled=False)``: any error raises), and each phase
ends by checking that its backends counted no scalar build, no dispatch
error and no injected fallback.

The CUDA kernels are built from ``openr_tpu_torch/kernels/csrc`` at first
use.  Every build checks, with exact equality:
  * each kernel against its plain PyTorch version on the card, on the
    inputs the build gave it (tables bit-equal, all selection outputs
    bit-equal); warm tables also against the cold kernels' tables of the
    same topology, and the reset-semantics lane kernel once more from an
    all-zero seed (any seed reaches the same fixed point), so its
    propagation runs whatever the tick's seed was
  * the RouteDb (``route_db_summary``) against a backend that runs the
    plain versions on the card through the same builds, and on the
    steady-state ticks (of the membership ticks, m-a and m-d) against a
    fresh backend's cold build
  * on the steady-state ticks, that the changed set the backend reports
    covers every route that moved
  * ~200 sampled prefixes (all of them on the small world) against the
    scalar ``SpfSolver.create_route_for_prefix`` oracle
and that the build launched exactly the kernels its path needs (launch
counts are reset just before each build and read just after).  The
what-if phases check, exactly: every call of kernels 8-11 against its
plain version on the inputs the run gave it; the repair sweep's tables
against the cold sweep kernel's for 1,024 failures (where lanes move from
the warm seed); the warm base against a cold one; ``WhatIfApiEngine``
answers against ``GenericSolverWhatIfEngine`` (the scalar solver on the
LSDB with the links removed) on sampled failures and a simultaneous set
of the headline world; and on the grid the answers against the same
engine running the plain versions on the card plus a scalar-oracle
sample of prefixes.  The fleet and multi-area phases check, exactly:
every call of kernels 12-14 against its plain version on the inputs the
run gave it; kernel 14 at one row against kernels 1/2; the fleet RouteDbs
against the scalar ``SpfSolver(node).build_route_db`` (16 sampled roots
of the WAN, every root of the 3-area and hub worlds) and the summary
against the plain path; each delta generation's summary against a fresh
engine's; the multi-area answers against the plain path and against
``GenericSolverWhatIfEngine`` on sampled failures and the set.  The KSP2
and bound phases check, exactly: every kernel-15 call against its plain
version; each KSP2 RouteDb against the plain path (on its own LinkStates,
so no k-path memo is shared) and 32 seeded prefixes against the scalar
solver on a third copy; the device-build what-if against
``GenericSolverWhatIfEngine``; the fat-tree fleet's summary against the
plain path and 16 roots against the scalar solver; the large hub's
RouteDb against the plain path and the scalar solver; kernel 14's rows, its
hub row and, at the (f) shape, its frontier form's all-global layout
(beside the round form the shape takes) against their plain versions.  The flagship phase checks,
exactly: every call of kernels 16 and 17 against its plain version; rows 0-3,070 against the
cold sweep kernel's tables (kernel 8) from node0, transposed; 32 seeded
rows, half from each half, on every prefix against the scalar oracle
(``graft_entry.scalar_route_oracle`` per advertiser, then the selection
chain in plain Python); ``entry()`` on the card against its CPU forward.
Any mismatch or exception exits non-zero.

Prints the kernel and phase times with the card's name and power limit
(kernels 3 and 7 at each shape the run gives them, with their launches
there; the changed-row gather, kernel 18, at each call, each call also
held against its plain version as it returns; kernel
17 at the flagship step and at ``entry()``), a ``{"kernels": [...]}``
line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from openr_tpu_torch import graft_entry
from openr_tpu_torch.common.runtime import SimClock
from openr_tpu_torch.config import ResilienceConfig
from openr_tpu_torch.decision import backend as backend_mod
from openr_tpu_torch.decision import fleet as fleet_mod
from openr_tpu_torch.decision import ksp2 as ksp2_mod
from openr_tpu_torch.decision import whatif_api
from openr_tpu_torch.decision.backend import DEGREE_BUCKETS, CudaBackend
from openr_tpu_torch.decision.fleet import FleetRibEngine
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb, route_db_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.emulation.topology import (
    _build_fattree,
    _build_wan,
    build_adj_dbs,
    grid_edges,
    make_adjacency,
    random_connected_edges,
    wan_area_of,
    wan_multi_area_dbs,
)
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import KERNEL_NAMES, LAUNCHES, build, reset_launch_counts
from openr_tpu_torch.ops import csr, fleet_tables, repair, spf, sweep_select
from openr_tpu_torch.ops import route_select as rs
from openr_tpu_torch.ops import whatif as whatif_ops
from openr_tpu_torch.ops.bits import unpack_bits_last
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.resilience import STATE_OPEN
from openr_tpu_torch.types import (
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixMetrics,
    RouteComputationRules,
)

#: the main path's world: grid_edges(64), 4096 nodes, 100 prefixes each
GRID_SIDE = 64
PREFIXES_PER_NODE = 100
#: prefixes withdrawn and advertised by the churn tick
CHURN = 2048

#: back-to-back launches per timed span, and timed spans per figure
TIMED_LAUNCHES = 50
TIMED_SPANS = 5
#: clock cycles the card spins before a queued span (about 2 ms at 1.98
#: GHz: longer than the host takes to issue the span's launches)
QUEUE_CYCLES = 4_000_000

#: NVIDIA H100 SXM data-sheet peaks (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores; used for int ALU work too

COLD = {"dense_spf_distances", "dense_spf_nexthop_lanes"}
SELECT = "multi_area_select_from_tables"
DELTA = "multi_area_select_delta_from_tables"
GATHER = "gather_selection_rows"

SOURCES = {
    "dense_spf_distances": (
        "openr_tpu_torch/kernels/csrc/spf_dense.cu",
        "openr_tpu/ops/spf.py:291",
    ),
    "dense_spf_nexthop_lanes": (
        "openr_tpu_torch/kernels/csrc/spf_dense.cu",
        "openr_tpu/ops/spf.py:331",
    ),
    "multi_area_select_from_tables": (
        "openr_tpu_torch/kernels/csrc/route_select.cu",
        "openr_tpu/ops/route_select.py:267",
    ),
    "warm_spf_distances": (
        "openr_tpu_torch/kernels/csrc/spf_warm.cu",
        "openr_tpu/ops/spf.py:449",
    ),
    "spf_nexthop_lanes_reset": (
        "openr_tpu_torch/kernels/csrc/spf_warm.cu",
        "openr_tpu/ops/spf.py:493",
    ),
    "warm_subgraph_repair": (
        "openr_tpu_torch/kernels/csrc/spf_warm.cu",
        "openr_tpu/ops/spf.py:548",
    ),
    "multi_area_select_delta_from_tables": (
        "openr_tpu_torch/kernels/csrc/route_select.cu",
        "openr_tpu/ops/route_select.py:368",
    ),
    "sweep_spf_link_failures": (
        "openr_tpu_torch/kernels/csrc/spf_sweep.cu",
        "openr_tpu/ops/spf.py:878",
    ),
    "repair_sweep": (
        "openr_tpu_torch/kernels/csrc/repair_sweep.cu",
        "openr_tpu/ops/repair.py:367",
    ),
    "select_chunk": (
        "openr_tpu_torch/kernels/csrc/sweep_select.cu",
        "openr_tpu/ops/sweep_select.py:155",
    ),
    "compact_deltas": (
        "openr_tpu_torch/kernels/csrc/sweep_select.cu",
        "openr_tpu/ops/sweep_select.py:274",
    ),
    "fleet_spf_dense": (
        "openr_tpu_torch/kernels/csrc/spf_dense.cu",
        "openr_tpu/ops/fleet_tables.py:89",
    ),
    "fleet_select": (
        "openr_tpu_torch/kernels/csrc/route_select.cu",
        "openr_tpu/ops/fleet_tables.py:89",
    ),
    "spf_segment_batch": (
        "openr_tpu_torch/kernels/csrc/spf_warm.cu",
        "openr_tpu/ops/fleet_tables.py:217",
    ),
    "spf_distances_masked": (
        "openr_tpu_torch/kernels/csrc/spf_warm.cu",
        "openr_tpu/ops/spf.py:226",
    ),
    "batched_spf": (
        "openr_tpu_torch/kernels/csrc/spf_warm.cu",
        "openr_tpu/ops/spf.py:201",
    ),
    "batched_select_routes": (
        "openr_tpu_torch/kernels/csrc/sweep_select.cu",
        "openr_tpu/ops/route_select.py:112",
    ),
    "gather_selection_rows": (
        "openr_tpu_torch/kernels/csrc/route_select.cu",
        "openr_tpu/ops/route_select.py:439",
    ),
}

#: the what-if phases: the reference benchmark's headline world
#: (bench.py:106 build_headline_world) and its failure draw (bench.py:5389)
WHATIF_NODES = 1024
WHATIF_FAILURES = 10240
#: criticality: pairs scanned after the single-failure sweep
CRIT_PAIRS = 16384
#: what-if on the grid: random links besides node0's two
GRID_RANDOM_LINKS = 30
#: failures of the headline world held against the scalar solver
GENERIC_SAMPLE = 8
#: snapshots on which the repair tables are held against the cold kernel
COLD_HOLD = 1024

#: the fleet phases: the reference benchmark's fleet world
#: (benchmarks/suite.py:437-455 at --full), roots held against the scalar
#: solver there, and the hub world's leaves (tests/test_stream_delta.py:184)
FLEET_NODES = 1024
FLEET_ORACLE_SAMPLE = 16
HUB_LEAVES = csr.IN_DEGREE_BUCKETS[-1] + 1
#: the multi-area what-if: the registered wan_multi_area class at this
#: scale and seed, vantage the ABR m0_0, and the failures held against the
#: scalar solver
MULTIAREA_SCALE = 1024
MULTIAREA_GENERIC_SAMPLE = 8

#: phase (g), KSP2 on a backbone: the wan_hierarchy class at this scale,
#: seed 7 (8,192 nodes, V = 16,384, E = 32,768), vantage core0; prefixes
#: held against the scalar solver per build; the what-if's backbone links
#: and the KSP2 prefixes its answers cover (the scalar engine it is held
#: against runs a host Dijkstra per destination and failure)
KSP2_SCALE = 8192
KSP2_ORACLE_SAMPLE = 32
KSP2_WHATIF_LINKS = 4
KSP2_WHATIF_PREFIXES = 64
#: phase (h), shapes past the shared-memory bound: the fattree_multipod
#: class at this scale (2,064 nodes, V = 4,096, K = 64), its roots held
#: against the scalar solver, the hub world's leaves (V = 16,384, segment
#: form) and kernel 14's rows on the (g) world
FATTREE_SCALE = 2048
FATTREE_ORACLE_SAMPLE = 16
HUB_LEAVES_LARGE = 5000
SEGMENT_ROWS = 8
#: launches and spans per timing at the shapes past the bound
LARGE_LAUNCHES = 5
LARGE_SPANS = 3
#: phase (i), the flagship step: rows of the batch, anycast /24s and their
#: advertisers (the candidate width), rows held against the scalar oracle,
#: and the distinct WANs of the same class (seeds 7...) for
#: batched_spf_distinct
FLAGSHIP_ROWS = 4096
FLAGSHIP_ANYCAST = 64
FLAGSHIP_CANDIDATES = 4
FLAGSHIP_ORACLE_ROWS = 32
DISTINCT_WANS = 64


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


#: the backends of the phase in progress, each held at the phase's end to
#: no scalar build, no dispatch error and no injected fallback
WATCHED = []

#: a backend whose every error raises and whose every build runs the device
#: path: no health governor (no shadow check adds a scalar build to a wall)
NO_GOVERNOR = ResilienceConfig(enabled=False)


def watch(backend):
    WATCHED.append(backend)
    return backend


def counters(be):
    return {name: getattr(be, name) for name in (
        "num_device_builds", "num_scalar_builds", "num_small_scalar_builds",
        "num_fallback_cand_overflow", "num_fallback_injected", "num_dispatch_errors")}


def check_no_fallback(label, backends=None):
    """Every backend of the phase answered on the device: a caught failure
    or a scalar build anywhere fails the run."""
    for be in WATCHED if backends is None else backends:
        counts = counters(be)
        del counts["num_device_builds"]
        check(not any(counts.values()), f"{label}: a backend fell back to scalar: {counts}")
    n = len(WATCHED if backends is None else backends)
    print(f"[{label}] {n} backends: 0 scalar builds, 0 dispatch errors, 0 injected "
          f"fallbacks", flush=True)
    if backends is None:
        WATCHED.clear()


class KernelPath(CudaBackend):
    """The port's backend, recording the inputs and outputs its kernels
    saw in the last build so they can be held against the plain versions
    afterwards.  Without a ``resilience`` argument it has no governor."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("resilience", NO_GOVERNOR)
        super().__init__(*args, **kwargs)
        watch(self)

    def build_route_db(self, *args, **kwargs):
        self.io = {}
        return super().build_route_db(*args, **kwargs)

    def _spf_tables(self, *args):
        out = super()._spf_tables(*args)
        self.io["spf"] = (args, out)
        return out

    def _warm_tables(self, *args):
        out = super()._warm_tables(*args)
        self.io["warm"] = (args, out)
        return out

    def _subgraph_tables(self, *args):
        out = super()._subgraph_tables(*args)
        self.io["sub"] = (args, out)
        return out

    def _segment_tables(self, *args):
        out = super()._segment_tables(*args)
        self.io["segment"] = (args, out)
        return out

    def _select(self, *args):
        out = super()._select(*args)
        self.io["select"] = (args, out)
        self.io.setdefault("select_calls", []).append(args)
        return out

    def _select_delta(self, *args):
        out = super()._select_delta(*args)
        self.io["delta"] = (args, out)
        return out


def segment_plain(src, dst, w, ok, ovl, roots, D):
    """The segment-form cold tables by the plain versions."""
    dist = spf.spf_distances_plain(src, dst, w, ok, ovl, roots)
    return dist, spf.spf_nexthop_lanes_plain(src, dst, w, ok, ovl, roots, dist, D)


def warm_plain(*args):
    src, dst, w, ok, ovl, roots, prev_dist, prev_nh, reset, lane_keep, D = args
    d0, nh0 = spf.warm_seeds(prev_dist, prev_nh, reset, lane_keep)
    dist, rd = spf.warm_spf_distances_plain(src, dst, w, ok, ovl, roots, d0)
    nh, rl = spf.spf_nexthop_lanes_reset_plain(src, dst, w, ok, ovl, roots, dist, nh0, D)
    return dist, nh, rd, rl


class PlainPath(CudaBackend):
    """The same builds with the kernels' plain PyTorch versions, on the card
    (no governor)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, resilience=NO_GOVERNOR, **kwargs)
        watch(self)

    def _spf_tables(self, in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D):
        dist = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
        nh = spf.dense_spf_nexthop_lanes_plain(
            in_src, in_w, in_ok, in_rank, in_has, ovl, roots, dist, D
        )
        return dist, nh

    def _segment_tables(self, *args):
        return segment_plain(*args)

    def _warm_tables(self, *args):
        return warm_plain(*args)

    def _subgraph_tables(self, *args):
        return spf.warm_subgraph_repair_plain(*args)

    def _select(self, *args):
        return rs.multi_area_select_from_tables_plain(*args)

    def _select_delta(self, *args):
        return rs.multi_area_select_delta_from_tables_plain(*args)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def per_launch_ms(fn, launches=TIMED_LAUNCHES, spans=TIMED_SPANS):
    """Median over ``spans`` of (device ms, host-issue ms) per call of
    ``fn``: CUDA events around ``launches`` back-to-back calls, divided
    by the count.  Given a pre-bound kernel launch (no checks, allocation
    or binding between launches) the device figure is the kernel's own
    time unless the host issue time per launch reaches it."""
    fn()  # warm-up
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(spans):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        issued = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / launches)
        host.append(issued * 1e3 / launches)
    return statistics.median(dev), statistics.median(host)


def queued_ms(launch, launches=TIMED_LAUNCHES, spans=TIMED_SPANS):
    """Median device ms per launch of a pre-bound ``launch`` with the span's
    launches queued behind a kernel that keeps the card busy while the host
    issues them (``torch.cuda._sleep``), so the events bracket the kernels'
    own back-to-back time and not the host's issue rate."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(spans):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(launches):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def plain_ms(fn, spans=TIMED_SPANS):
    """Median CUDA-event ms of one call of a plain version (its host
    work and synchronizes included: that is what the plain version
    costs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(spans):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b):
    check(a.dtype == b.dtype and a.shape == b.shape, "kernel/plain dtype or shape differ")
    if torch.equal(a, b):  # the common case, without a temporary of the tables' size
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    if a.dtype == torch.float32:
        same = (a == b) | (torch.isinf(a) & torch.isinf(b) & (a.sign() == b.sign()))
        if bool(same.all()):
            return 0.0
        return float((a.double() - b.double()).abs().max().item())
    differ = a != b
    return float((a[differ].int() - b[differ].int()).abs().max().item())


def relax_rounds(in_src, in_w, in_ok, ovl, roots):
    """Synchronous Bellman-Ford rounds this input needs to reach its fixed
    point, plus the round that finds nothing to change."""
    A, V, _K = in_src.shape
    ok = spf.transit_ok(in_src, in_ok, ovl, roots)
    ww = torch.where(ok, in_w, torch.tensor(BIG, device=in_w.device))
    d = torch.full((A, V), BIG, device=in_w.device)
    d[torch.arange(A), roots.long()] = 0
    rounds = 0
    while True:
        rounds += 1
        nd = torch.minimum(d, (spf.gather_rows(d, in_src) + ww).amin(dim=2))
        if not bool((nd < d).any()):
            return rounds
        d = nd


def lane_rounds(planes, dist):
    """Synchronous lane-propagation rounds this input needs: the longest
    shortest-path-DAG path from the root's successors, plus the round
    that finds nothing to change."""
    in_src, in_w, in_ok, _in_rank, _in_has, ovl, roots = planes
    ok = spf.transit_ok(in_src, in_ok, ovl, roots)
    big = torch.tensor(BIG, device=in_w.device)
    dv = dist[:, :, None]
    sp = ok & (spf.gather_rows(dist, in_src) + torch.where(ok, in_w, big) == dv) & (dv < big)
    is_root = in_src.long() == roots.long()[:, None, None]
    prop = sp & ~is_root
    depth = torch.where((sp & is_root).any(dim=2), 0, -1)
    rounds = 1
    while True:
        g = spf.gather_rows(depth, in_src)
        cand = torch.where(prop & (g >= 0), g + 1, -1).amax(dim=2)
        new = torch.maximum(depth, cand)
        if torch.equal(new, depth):
            return rounds
        depth = new
        rounds += 1


def dense_relaxations(in_src, in_ok, in_rank, ovl, roots, D):
    """(usable [R], lanes [R]) of each row of the dense planes: its usable
    in-edge slots (ok, and the source may transit) and the lanes a root
    out-edge can seed (one per out-edge of the root, at most D).  The
    operation term of a bound is one relaxation per usable edge per row:
    an add and a min for the distances, a max per live lane for the lanes
    (however many rounds a kernel runs)."""
    usable = spf.transit_ok(in_src, in_ok, ovl, roots).flatten(1).sum(dim=1)
    out = (in_src == roots[:, None, None]) & (in_rank >= 0)
    return usable, out.flatten(1).sum(dim=1).clamp(max=D)


def segment_relaxations(src, ok, ovl, roots, D):
    """:func:`dense_relaxations` over segment-form rows: ``ok`` [R, E] the
    edges each row may use before the transit rule."""
    transit = spf.can_transit(ovl, roots)
    usable = (ok & spf.gather_rows(transit, src)).sum(dim=1)
    return usable, (src == roots[:, None]).sum(dim=1).clamp(max=D)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def select_shape(args):
    """(P, C, A, V, D) of a call of kernel 3."""
    P, C = args[4].shape
    A, V, D = args[1].shape
    return P, C, A, V, D


def select_ops(P, C, A, D):
    # ~8 compare/select ops per candidate per chain stage, plus the
    # per-area lane sums
    return P * C * (48 + A * (4 + D))


def chunk_ops(args):
    """Operations kernel 10 needs on these inputs: the chain of
    :func:`select_ops` for each snapshot over each candidate that is ok
    (a slot that is not ok joins no selection)."""
    b, D = args[0].shape[1], args[-1]
    return b * select_ops(int(args[6].sum()), 1, 1, D)


def chunk_bytes(args, outs):
    """Bytes kernel 10 must move on these inputs: the distances, lane
    words, drains and base rows once, the candidates' node and ok columns
    whole and their five other columns for the slots that are ok (a slot
    that is not ok joins no selection), and the outputs once."""
    dist, nh, ovl, soft, _root, node, ok = args[:7]
    return (nbytes(dist, nh, ovl, soft, node, ok, *args[12:15]) + 20 * int(ok.sum())
            + nbytes(*outs))


def dense_distances_bytes(in_src, in_ok, ovl, roots, dist):
    """Bytes kernel 1 must move on these planes: ``in_ok`` whole, the
    source and weight (8 bytes) of each usable slot, the source of each ok
    slot whose source may not transit, ``overloaded``, ``roots`` and the
    distances once; not the planes' padding."""
    ok = int(in_ok.sum())
    usable = int(spf.transit_ok(in_src, in_ok, ovl, roots).sum())
    return nbytes(in_ok, ovl, roots, dist) + 8 * usable + 4 * (ok - usable)


def warm_distances_bytes(src, ok, ovl, roots, d0, dist):
    """Bytes kernel 4 must move on these edges: ``edge_ok`` whole, the
    source, destination and weight (12 bytes) of each usable edge, the
    source of each ok edge whose source may not transit, ``overloaded``,
    ``roots``, the seed and the distances once; not the list's padding or
    down edges (a slice's edge range is found by binary search)."""
    n_ok = int(ok.sum())
    usable = int((ok & spf.gather_rows(spf.can_transit(ovl, roots), src)).sum())
    return nbytes(ok, ovl, roots, d0, dist) + 12 * usable + 4 * (n_ok - usable)


def select_bytes(args, kw, outs, ok_only=False):
    """Bytes kernels 13 and 3 must move on these inputs (kernel 3 as
    [1, A, V] tables): the candidate tables, drains, ``prev_*`` and
    outputs once; per batch row, the distance of each cell a candidate
    names in its own area and of each cell a surviving candidate (``use``)
    resolves to in an area that holds a winner, and the D lane bytes of
    each cell a min-cost winner of a (row, area) pair resolves to (its
    distance equals the pair's ``shortest``); not the whole [B, A, V, D]
    tables.  ``ok_only`` (kernel 3, which reads a row's ok bytes first):
    the candidates' seven other columns and own cells only for the slots
    that are ok (a slot that is not ok joins no selection, and a row with
    no ok slot, such as the candidate table's bucket padding, reads its ok
    bytes alone)."""
    dist, nh, overloaded, soft, cand_area, cand_node, cand_ok = args[:7]
    metrics, cnia = args[7:11], args[11]
    use, shortest = outs[0], outs[1]
    B, A, V = dist.shape
    D = nh.shape[-1]
    dev = dist.device
    area = torch.arange(A, device=dev)
    own = cand_area.long() * V + cand_node.long()
    own = own[cand_ok] if ok_only else own.reshape(-1)
    cell = area * V + cnia.clamp(min=0).long()  # [P, C, A]
    named = cnia >= 0
    winner_area = cand_area.long()[:, :, None] == area  # [P, C, A]
    cells = 0
    for b in range(B):
        read = use[b][:, :, None] & named
        read &= (use[b][:, :, None] & winner_area).any(dim=1)[:, None, :]
        d = dist[b].reshape(-1)[cell]
        mc = read & (d < BIG) & (d == shortest[b][:, None, :])
        seen = torch.zeros(A * V, dtype=torch.bool, device=dev)
        seen[own] = True
        seen[cell[read]] = True
        lanes = torch.zeros(A * V, dtype=torch.bool, device=dev)
        lanes[cell[mc]] = True
        cells += 4 * int(seen.sum()) + D * int(lanes.sum())
    if not ok_only:
        return nbytes(overloaded, soft, *args[4:12], *kw.values(), *outs) + cells
    columns = (4 * len(metrics) + 8 + 4 * A) * int(cand_ok.sum())
    return nbytes(overloaded, soft, cand_ok, *kw.values(), *outs) + columns + cells


def delta_bytes(args, outs):
    """Bytes kernel 7 must move on these inputs: kernel 3's count on them
    (:func:`select_bytes` with ``ok_only``, on the [1, A, V] view), the
    previous generation's four tables and ``changed`` [P] once, and each
    ``node_changed`` cell an ok slot names (its own-area cell and every
    cell it resolves to in an area: the touches read no other)."""
    dist, nh = args[:2]
    cand_area, cand_node, cand_ok, cnia = args[4], args[5], args[6], args[11]
    A, V = dist.shape
    sel = select_bytes((dist[None], nh[None], *args[2:12]), {},
                       tuple(o[None] for o in outs[:4]), ok_only=True)
    own = (cand_area.long() * V + cand_node.long())[cand_ok]
    cell = torch.arange(A, device=dist.device) * V + cnia.clamp(min=0).long()  # [P, C, A]
    seen = torch.zeros(A * V, dtype=torch.bool, device=dist.device)
    seen[own] = True
    seen[cell[(cnia >= 0) & cand_ok[:, :, None]]] = True
    return sel + nbytes(*args[12:16]) + int(seen.sum()) + nbytes(outs[4])


class KernelReport:
    def __init__(self):
        self.launches = {n: 0 for n in KERNEL_NAMES}
        self.err = {n: 0.0 for n in KERNEL_NAMES}
        self.timing = {}
        #: (v, lane) cells the last warm tick's lanes moved from their seed
        self.lane_moves = 0
        #: the lane kernel's ms from an all-zero seed, where first timed
        self.zero_seed_ms = None
        #: the label of the build whose kernels are being held and timed
        self.tick = None
        #: (tick, arguments) of each call of kernel 18 the main path made,
        #: in order (held as it returned; timed by :meth:`time_gathers`)
        self.gather_calls = []
        #: set while the plain path builds: its gathers run the plain version
        self.plain_path = False
        #: (device ms, host-issue ms) per call of a kernel's entry point as
        #: the main path calls it (its checks, derived layout and
        #: allocations, and the launch), by label
        self.per_call = {}
        #: kernel 3's timing key by shape (P, C, A, V, D): each shape the run
        #: gives it is timed once, on the first build that runs it
        self.select_keys = {}
        #: kernel 7's, the same way (the grid's drain delta first)
        self.delta_keys = {}
        #: the phases of the last steady tick's fresh cold build
        self.fresh_phase_ms = {}
        #: the card's name and power limit, printed beside the walls
        self.smi = ""

    def held(self, name, pairs):
        """Record and require exact agreement of (kernel, plain) output
        pairs."""
        e = 0.0
        for k, p in pairs:
            e = max(e, max_abs_err(k, p))
        check(e == 0.0, f"{name} kernel != plain (err {e})")
        self.err[name] = max(self.err[name], e)

    def time(self, name, launch, plain_fn, t_bytes, ops, per_round_bytes, rounds,
             library_fn=None, key=None, launches=TIMED_LAUNCHES, spans=TIMED_SPANS,
             plain_spans=None):
        """Time kernel ``name`` (under ``key``, default the name: the
        kernels line reads the names, the other keys are the timings of a
        kernel's other path or shape); the plain version over
        ``plain_spans`` calls (default ``spans``)."""
        key = key or name
        if key in self.timing:
            return
        dev_ms, host_ms = per_launch_ms(launch, launches, spans)
        self.timing[key] = dict(
            ms=dev_ms, host_issue_ms=host_ms,
            plain_ms=plain_ms(plain_fn, plain_spans or spans),
            bytes=t_bytes, ops=ops, per_round_bytes=per_round_bytes, rounds=rounds,
            library_ms=None if library_fn is None else plain_ms(library_fn),
        )

    def bound_ms(self, key):
        t = self.timing[key]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops"] / F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def kernel_checks(self, backend, timed):
        """Hold each kernel the last build ran against its plain version
        on the inputs the build gave it; time it on the first main-shape
        build that ran it."""
        io = backend.io
        if "spf" in io:
            self._check_cold(*io["spf"], timed)
        if "segment" in io:
            args, out = io["segment"]
            want = segment_plain(*args)
            self.held("spf_segment_batch", list(zip(out, want)))
        if "warm" in io:
            self._check_warm(*io["warm"], timed)
        if "sub" in io:
            self._check_sub(*io["sub"])
        if "select" in io:
            self._check_select(*io["select"], io["select_calls"])
        if "delta" in io:
            self._check_delta(*io["delta"])

    def _check_cold(self, args, out, timed):
        dist_main, nh_main = out
        in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D = args
        planes = (in_src, in_w, in_ok, in_rank, in_has, ovl, roots)

        def p_dist():
            return spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)

        dist_p = p_dist()
        dist_k = spf.dense_spf_distances_cuda(in_src, in_w, in_ok, ovl, roots)
        self.held("dense_spf_distances", [(dist_k, dist_p), (dist_main, dist_p)])

        def p_nh():
            return spf.dense_spf_nexthop_lanes_plain(*planes, dist_p, D)

        nh_p = p_nh()
        nh_k = spf.dense_spf_nexthop_lanes_cuda(*planes, dist_p, D)
        self.held("dense_spf_nexthop_lanes", [(nh_k, nh_p), (nh_main, nh_p)])
        if not timed:
            return
        A, V, K = in_src.shape
        r_d = relax_rounds(in_src, in_w, in_ok, ovl, roots)
        r_l = lane_rounds(planes, dist_p)
        usable, lanes = dense_relaxations(in_src, in_ok, in_rank, ovl, roots, D)
        launch_d, _ = spf.dense_spf_distances_launcher(in_src, in_w, in_ok, ovl, roots)
        launch_n, _ = spf.dense_spf_nexthop_lanes_launcher(*planes, dist_p, D)
        self.time(
            "dense_spf_distances", launch_d, p_dist,
            dense_distances_bytes(in_src, in_ok, ovl, roots, dist_p), 2 * int(usable.sum()),
            nbytes(in_src, in_w, in_ok) + 2 * nbytes(dist_p), r_d,
        )
        self.time(
            "dense_spf_nexthop_lanes", launch_n, p_nh,
            nbytes(*planes, dist_p, nh_p), int((usable * lanes).sum()),
            A * V * K * 5 + 2 * nbytes(nh_p), r_l,
        )

    def _check_warm(self, args, out, timed):
        src, dst, w, ok, ovl, roots, prev_dist, prev_nh, reset, lane_keep, D = args
        seg = (src, dst, w, ok, ovl, roots)
        d0, nh0 = spf.warm_seeds(prev_dist, prev_nh, reset, lane_keep)

        def p_dist():
            return spf.warm_spf_distances_plain(*seg, d0)

        dist_p = p_dist()[0]
        launch_d, (dist_k, _) = spf.warm_spf_distances_launcher(*seg, d0)
        launch_d()
        self.held("warm_spf_distances", [(dist_k, dist_p), (out[0], dist_p)])

        def p_nh():
            return spf.spf_nexthop_lanes_reset_plain(*seg, dist_p, nh0, D)

        nh_p = p_nh()[0]
        launch_n, (nh_k, _) = spf.spf_nexthop_lanes_reset_launcher(*seg, dist_p, nh0, D)
        launch_n()
        self.lane_moves = int((nh0 != nh_p).sum())
        # reset semantics make any seed safe: from all zeros every lane
        # must propagate down the whole DAG to the same tables
        zero = torch.zeros_like(nh0)
        nh_zp = spf.spf_nexthop_lanes_reset_plain(*seg, dist_p, zero, D)[0]
        launch_z, (nh_zk, _) = spf.spf_nexthop_lanes_reset_launcher(*seg, dist_p, zero, D)
        launch_z()
        self.held(
            "spf_nexthop_lanes_reset",
            [(nh_k, nh_p), (out[1], nh_p), (nh_zk, nh_zp), (nh_zk, out[1])],
        )
        # kernel 4 at every warm tick (the grid's undrain first, its key the
        # kernels line's), per launch and per call
        A, E = src.shape
        usable, lanes = segment_relaxations(src, ok, ovl, roots, D)
        name = "warm_spf_distances"
        key = name if name not in self.timing else f"{name} at {self.tick}"
        if key not in self.timing:
            r_d = int(spf.warm_spf_distances_plain(*seg, d0, unroll=1)[1].max())
            self.time(
                name, launch_d, p_dist, warm_distances_bytes(src, ok, ovl, roots, d0, dist_p),
                2 * int(usable.sum()),
                nbytes(src, w, ok) + 2 * nbytes(dist_p), r_d, key=key,
            )
            self.timing[key]["launches"] = 1
            self.per_call[f"{name} at {self.tick}, spf.warm_spf_distances"] = (
                per_launch_ms(lambda: spf.warm_spf_distances(*seg, d0)))
        if not timed:
            return
        # kernel 5 at this tick, its seed and an all-zero one; the kernel
        # never reads the seed, so no seed byte is in its bound
        name = "spf_nexthop_lanes_reset"
        first = name not in self.timing
        for seed, launch, what in ((nh0, launch_n, ""), (zero, launch_z, " from an all-zero seed")):
            r_l = int(spf.spf_nexthop_lanes_reset_plain(*seg, dist_p, seed, D, unroll=1)[1].max())
            key = name if first and not what else f"{name} at {self.tick}{what}"
            self.time(
                name, launch, lambda seed=seed: spf.spf_nexthop_lanes_reset_plain(*seg, dist_p, seed, D),
                nbytes(*seg, dist_p, nh_p), int((usable * lanes).sum()),
                nbytes(src) + A * E + 2 * nbytes(nh_p), r_l, key=key,
            )
            self.per_call[f"{name} at {self.tick}{what}, spf.spf_nexthop_lanes_reset"] = (
                per_launch_ms(lambda seed=seed: spf.spf_nexthop_lanes_reset(*seg, dist_p, seed, D)))
            if what and self.zero_seed_ms is None:
                self.zero_seed_ms = self.timing[key]["ms"]

    def _check_sub(self, args, out):
        """Hold kernel 6 against its plain version on the build's inputs and
        time it at every tick that runs it (the grid's weakening first,
        under the kernels line's key), per launch back to back and queued
        and per call."""
        def p_sub():
            return spf.warm_subgraph_repair_plain(*args)

        want = p_sub()
        launch, got = spf.warm_subgraph_repair_launcher(*args)
        launch()
        self.held(
            "warm_subgraph_repair",
            [(got[0], want[0]), (got[1], want[1]), (out[0], want[0]), (out[1], want[1])],
        )
        name = "warm_subgraph_repair"
        key = name if name not in self.timing else f"{name} at {self.tick}"
        if key in self.timing:
            return
        ok_sub, rank_sub, reset, D = args[3], args[4], args[7], args[-1]
        _d, _n, r_d, r_l = spf.warm_subgraph_repair_plain(*args, unroll=1)
        r_d, r_l = int(r_d.max()), int(r_l.max())
        # one relaxation per usable sub-edge, a max per lane a root
        # out-edge of the sub-edge list can seed
        usable = ok_sub.sum(dim=1)
        lanes = (rank_sub >= 0).sum(dim=1).clamp(max=D)
        self.time(
            name, launch, p_sub,
            nbytes(*args[:-1], want[0], want[1]), int((2 * usable + usable * lanes).sum()),
            nbytes(*args[:4]) + 2 * nbytes(want[0]) + 2 * nbytes(want[1]), r_d + r_l, key=key,
        )
        self.timing[key]["launches"] = 1
        self.timing[key]["queued_ms"] = queued_ms(launch)
        self.timing[key]["shape"] = [*reset.shape, args[0].shape[1], D, int(reset.sum())]
        self.per_call[f"{name} at {self.tick}, spf.warm_subgraph_repair"] = (
            per_launch_ms(lambda: spf.warm_subgraph_repair(*args)))

    def _check_select(self, args, out, calls):
        """Hold kernel 3's last call of the build against its plain
        version; time and count the build's calls by shape."""
        want = rs.multi_area_select_from_tables_plain(*args)
        got = rs.multi_area_select_from_tables_cuda(*args)
        self.held(SELECT, list(zip(got, want)) + list(zip(out, want)))
        self.select_shapes(calls)

    def select_shapes(self, calls):
        """Time kernel 3 once at each shape (P, C, A, V, D) the run gives
        it, on the first build that runs it (the first, the grid's cold
        build, under the kernel's name), and count each of ``calls`` (its
        arguments) under its shape's key."""
        for args in calls:
            shape = select_shape(args)
            if shape not in self.select_keys:
                P, C, A, V, D = shape
                key = SELECT if not self.select_keys else (
                    f"{SELECT} at {self.tick} [P {P}, C {C}, A {A}, V {V}, D {D}]")
                self.select_keys[shape] = key
                launch, outs = rs.multi_area_select_from_tables_launcher(*args)
                launch()
                t_bytes = select_bytes((args[0][None], args[1][None], *args[2:12]), {},
                                       tuple(o[None] for o in outs), ok_only=True)
                self.time(key, launch, lambda: rs.multi_area_select_from_tables_plain(*args),
                          t_bytes, select_ops(P, C, A, D), t_bytes, 1)
                self.timing[key]["launches"] = 0
            self.timing[self.select_keys[shape]]["launches"] += 1

    def _check_delta(self, args, out):
        """Hold kernel 7's call of the build against its plain version;
        time it once at each shape (P, C, A, V, D) the run gives it (the
        first, the grid's drain delta, under the kernel's name), back to
        back and queued, and count the call under its shape's key."""
        def p_delta():
            return rs.multi_area_select_delta_from_tables_plain(*args)

        want = p_delta()
        launch, got = rs.multi_area_select_delta_from_tables_launcher(*args)
        launch()
        self.held(DELTA, list(zip(got, want)) + list(zip(out, want)))
        shape = select_shape(args)
        if shape not in self.delta_keys:
            P, C, A, V, D = shape
            key = DELTA if not self.delta_keys else (
                f"{DELTA} at {self.tick} [P {P}, C {C}, A {A}, V {V}, D {D}]")
            self.delta_keys[shape] = key
            t_bytes = delta_bytes(args, want)
            ops = select_ops(P, C, A, D) + P * (2 * C + A * (4 + D) + C * A)
            self.time(DELTA, launch, p_delta, t_bytes, ops, t_bytes, 1, key=key)
            self.timing[key].update(queued_ms=queued_ms(launch), launches=0, shape=list(shape))
            self.per_call[f"{key}, rs.multi_area_select_delta_from_tables"] = (
                per_launch_ms(lambda: rs.multi_area_select_delta_from_tables(*args)))
        self.timing[self.delta_keys[shape]]["launches"] += 1

    def time_gathers(self):
        """Time kernel 18 at each call the main path made (the first, the
        grid's drain delta, under the kernel's name): per launch back to
        back and queued, per call, and its plain version, four
        ``torch.index_select`` calls, which is also the library's time (one
        PyTorch call a table computes the same rows)."""
        for i, (tick, args) in enumerate(self.gather_calls):
            G = args[4].numel()
            rows = [math.prod(t.shape[1:]) * t.element_size() for t in args[:4]]
            key = GATHER if i == 0 else f"{GATHER} at {tick} (call {i + 1}: G {G}, row bytes {rows})"
            launch, outs = rs.gather_selection_rows_launcher(*args)
            launch()

            def plain(args=args):
                return rs.gather_selection_rows_plain(*args)

            t_bytes = nbytes(args[4]) + 2 * nbytes(*outs)
            self.time(GATHER, launch, plain, t_bytes, 0, t_bytes, 1, library_fn=plain, key=key)
            self.timing[key].update(queued_ms=queued_ms(launch), launches=1, shape=[G, *rows])
            self.per_call[f"{key}, rs.gather_selection_rows"] = (
                per_launch_ms(lambda args=args: rs.gather_selection_rows(*args)))

    def json_line(self):
        rows = []
        for name in KERNEL_NAMES:
            t = self.timing[name]
            bound, bound_by = self.bound_ms(name)
            source, replaces = SOURCES[name]
            rows.append(
                {
                    "name": name,
                    "route": "cuda",
                    "source": source,
                    "replaces": replaces,
                    "launches": self.launches[name],
                    "max_abs_err": self.err[name],
                    "ms": t["ms"],
                    "plain_ms": t["plain_ms"],
                    "bound_ms": bound,
                    "bound_by": bound_by,
                    "library_ms": t["library_ms"],
                }
            )
        return json.dumps({"kernels": rows})


def warm_tables_equal_cold(backend):
    """The tables a warm tick left on the card against the cold kernels'
    tables of the same topology (the backend's current encoding)."""
    dist, nh = backend._tables[:2]
    a = backend._enc_cache[3]
    planes = [a[k] for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")]
    cold_d, cold_n = spf.dense_spf_one(*planes, max_degree=nh.shape[2])
    check(torch.equal(dist, cold_d) and torch.equal(nh, cold_n), "warm tables != cold tables")


def same_route_db(a, b):
    """``route_db_summary(a) == route_db_summary(b)``.  Routes that are
    equal as entries (every field, nexthops as sets) have equal summaries,
    so that cheaper test comes first (a quarter of the summaries' time on
    the grid's 409,501 routes); the summaries decide otherwise."""
    if a.unicast_routes == b.unicast_routes and a.mpls_routes == b.mpls_routes:
        return True
    return route_db_summary(a) == route_db_summary(b)


def moved_routes(prev, new):
    """Prefixes whose route differs between two RouteDbs (identical
    objects are the same route)."""
    a, b = prev.unicast_routes, new.unicast_routes
    return {p for p in a.keys() | b.keys() if a.get(p) is not b.get(p) and a.get(p) != b.get(p)}


def sample_oracle(db, oracle, areas, ps, picks, label):
    got, ref = DecisionRouteDb(), DecisionRouteDb()
    for p in picks:
        if p in db.unicast_routes:
            got.add_unicast_route(db.unicast_routes[p])
        entry = oracle.create_route_for_prefix(p, areas, ps)
        if entry is not None:
            ref.add_unicast_route(entry)
    check(route_db_summary(got) == route_db_summary(ref), f"{label}: scalar oracle mismatch")
    check(len(got.unicast_routes) > 0, f"{label}: sampled prefixes produced no routes")


def drive(report, kernel_be, plain_be, oracle, areas, ps, label, rng, sample,
          expect, hints=None, timed=False, steady=False, fresh=True):
    """One request through the port's main path plus its checks.
    ``expect`` is the exact set of kernels the path must launch.  A
    ``steady`` tick also holds its changed set against the moved routes
    and, with ``fresh``, its RouteDb against a fresh backend's cold build."""
    hints = hints or {}
    prev_db = kernel_be._last_db
    report.tick = label
    reset_launch_counts()
    t0 = time.perf_counter()
    db = kernel_be.build_route_db(areas, ps, **hints)
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(LAUNCHES)
    launched = {name for name, n in counts.items() if n}
    check(launched == set(expect), f"{label}: launched {sorted(launched)}, expected {sorted(expect)}")
    for name in KERNEL_NAMES:
        report.launches[name] += counts[name]
    changed = kernel_be.take_last_changed_prefixes()
    if changed is not None:
        shown = len(changed)
    else:
        incremental = hints.get("changed_prefixes") is not None and not hints.get("force_full")
        shown = "the churned prefixes" if incremental else "full"
    phases = " ".join(f"{k}={v:.1f}ms" for k, v in kernel_be.last_phase_ms.items())
    rows = " ".join(f"{k}={v}" for k, v in kernel_be.last_rows.items())
    print(f"[{label}] build wall={wall:.1f}ms {phases} rows: {rows} "
          f"launches={ {k: v for k, v in counts.items() if v} } routes={len(db.unicast_routes)} "
          f"changed={shown}", flush=True)

    spent = {}  # ms of each check after the build
    t0 = time.perf_counter()
    report.kernel_checks(kernel_be, timed)
    if "warm" in kernel_be.io or "sub" in kernel_be.io:
        warm_tables_equal_cold(kernel_be)
        moved = f" lane cells moved from seed={report.lane_moves}" if "warm" in kernel_be.io else ""
        print(f"[{label}] warm rounds={kernel_be.warm_last_rounds} "
              f"reset nodes={kernel_be.warm_last_reset_nodes} "
              f"est depth={kernel_be.warm_last_est_depth}{moved}: warm tables == cold tables",
              flush=True)
    t0 = lap(spent, "kernels", t0)
    report.plain_path = True
    try:
        plain_db = plain_be.build_route_db(areas, ps, **hints)
    finally:
        report.plain_path = False
    plain_be.take_last_changed_prefixes()
    check(same_route_db(plain_db, db), f"{label}: RouteDb != plain-path RouteDb")
    t0 = lap(spent, "plain", t0)

    prefixes = sorted(ps.prefixes())
    picks = prefixes if sample is None else [
        prefixes[i] for i in rng.choice(len(prefixes), sample, replace=False)
    ]
    t0 = lap(spent, "sample", t0)
    if steady:
        if fresh:
            cold_be = CudaBackend(SpfSolver(
                oracle.my_node_name, route_selection_algorithm=oracle.route_selection_algorithm),
                resilience=NO_GOVERNOR)
            check(same_route_db(cold_be.build_route_db(areas, ps), db),
                  f"{label}: RouteDb != a fresh backend's cold build")
            report.fresh_phase_ms = cold_be.last_phase_ms
            check_no_fallback(label, [cold_be])
            t0 = lap(spent, "fresh", t0)
        # a patched build names its changed set; an incremental one may
        # change only the churned prefixes; a full build claims nothing
        claimed = changed
        if claimed is None and not hints.get("force_full"):
            claimed = hints.get("changed_prefixes")
        if claimed is not None:
            moved = sorted(moved_routes(prev_db, db))
            check(set(moved) <= claimed, f"{label}: moved routes outside the changed set")
            print(f"[{label}] {len(moved)} routes moved, all inside the changed set of "
                  f"{len(claimed)}" + ("; RouteDb == fresh cold build" if fresh else ""),
                  flush=True)
            if moved and sample is not None:  # a quarter of the oracle sample from the moved routes
                k = min(sample // 4, len(moved))
                picks = picks[: sample - k] + [moved[i] for i in rng.choice(len(moved), k, replace=False)]
            t0 = lap(spent, "moved", t0)
    sample_oracle(db, oracle, areas, ps, picks, label)
    lap(spent, "oracle", t0)
    print(f"[{label}] kernels == plain, RouteDb == plain path, "
          f"{len(picks)} prefixes == scalar oracle; checks took "
          + " ".join(f"{k}={v:.1f}ms" for k, v in spent.items()), flush=True)
    return db


def lap(spent, name, t0):
    """Books the wall since ``t0`` under ``name``; returns the new start."""
    t = time.perf_counter()
    spent[name] = (t - t0) * 1e3
    return t


def grid_world():
    dbs = build_adj_dbs(grid_edges(GRID_SIDE))
    ls = LinkState("0", "node0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i, node in enumerate(sorted(dbs)):
        for p in range(PREFIXES_PER_NODE):
            ps.update_prefix(node, "0", PrefixEntry(f"10.{(i >> 8) & 255}.{i & 255}.{p}/32"))
    return dbs, {"0": ls}, ps


def three_area_world():
    me = "me"
    ring = [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
    area_edges = {
        "1": grid_edges(4, prefix="a") + [("a0", me, 1)],
        "2": ring + [("b0", me, 2), ("b3", me, 5)],
        "3": random_connected_edges(10, 6, seed=7, prefix="c") + [("c0", me, 1)],
    }
    drains = {"1": {"overloaded": ["a5"]}, "2": {"soft_drained": {"b2": 40}}, "3": {}}
    areas = {}
    for a, edges in area_edges.items():
        ls = LinkState(a, me)
        for db in build_adj_dbs(edges, area=a, **drains[a]).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    ps = PrefixState()
    for i in range(16):
        ps.update_prefix(f"a{i}", "1", PrefixEntry(f"10.1.{i}.0/24"))
    for i in range(6):
        ps.update_prefix(f"b{i}", "2", PrefixEntry(f"10.2.{i}.0/24"))
    for i in range(10):
        ps.update_prefix(f"c{i}", "3", PrefixEntry(f"10.3.{i}.0/24"))
    # anycast across areas, preferences, distances, a min-nexthop gate
    for node, area, d in (("a15", "1", 3), ("b3", "2", 1), ("c9", "3", 2)):
        ps.update_prefix(node, area, PrefixEntry("10.9.0.0/16", metrics=PrefixMetrics(distance=d)))
    ps.update_prefix("a5", "1", PrefixEntry("10.8.0.0/16"))  # hard-drained
    ps.update_prefix("b2", "2", PrefixEntry("10.8.0.0/16"))  # soft-drained
    ps.update_prefix("c4", "3", PrefixEntry("10.7.0.0/16", metrics=PrefixMetrics(path_preference=900)))
    ps.update_prefix("a9", "1", PrefixEntry("10.7.0.0/16", metrics=PrefixMetrics(path_preference=800)))
    ps.update_prefix("b4", "2", PrefixEntry("2001:db8::/64", min_nexthop=2))
    ps.update_prefix(me, "3", PrefixEntry("10.6.0.0/16"))  # self
    return areas, ps, me


def set_metric(areas, dbs, node, neighbor, metric):
    db = dbs[node]
    adjs = [dataclasses.replace(a, metric=metric) if a.other_node_name == neighbor else a
            for a in db.adjacencies]
    dbs[node] = dataclasses.replace(db, adjacencies=adjs)
    areas["0"].update_adjacency_database(dbs[node])


def set_overload(areas, dbs, node, overloaded):
    dbs[node] = dataclasses.replace(dbs[node], is_overloaded=overloaded)
    areas["0"].update_adjacency_database(dbs[node])


def steady_state_ticks(report, kernel_be, plain_be, oracle, dbs, areas, ps, rng):
    """The Decision steady state on the grid, each tick with its hints."""
    common = dict(rng=rng, sample=200, steady=True)
    side = GRID_SIDE

    # 5. prefix churn: withdraw CHURN prefixes, advertise CHURN new ones
    owners = {p: next(iter(e))[0] for p, e in ps.prefixes().items()}
    names = sorted(dbs)
    held = sorted(owners)
    gone = [held[i] for i in rng.choice(len(held), CHURN, replace=False)]
    changed = set()
    for p in gone:
        changed |= ps.delete_prefix(owners[p], "0", p)
    for i in range(CHURN):
        node = names[int(rng.integers(len(names)))]
        changed |= ps.update_prefix(node, "0", PrefixEntry(f"10.100.{i >> 8}.{i & 255}/32"))
    before = kernel_be.num_incremental_builds
    drive(report, kernel_be, plain_be, oracle, areas, ps, "prefix-churn", expect={SELECT},
          hints=dict(changed_prefixes=changed), **common)
    check(kernel_be.num_incremental_builds == before + 1, "prefix churn did not patch")

    # 6. node1 undrained: an improvement that opens the root's second
    # lane, so the warm lane kernel must move lanes from its seed
    warm = dict(changed_prefixes=set(), force_full=True, warm_delta=True)
    warm_kernels = {"warm_spf_distances", "spf_nexthop_lanes_reset"}
    set_overload(areas, dbs, "node1", False)
    before = kernel_be.num_warm_builds
    drive(report, kernel_be, plain_be, oracle, areas, ps, "undrain:node1",
          expect=warm_kernels | {SELECT}, hints=warm, timed=True, **common)
    check(kernel_be.num_warm_builds == before + 1, "undrain did not take the warm path")
    check(report.lane_moves > 0, "undrain: no lane moved from its warm seed")

    # 7. pure weakening: the column-0 link half-way down, whose head's
    # column is reached through it alone
    a, b = f"node{(side // 2) * side}", f"node{(side // 2 + 1) * side}"
    set_metric(areas, dbs, a, b, 11)
    set_metric(areas, dbs, b, a, 11)
    before = kernel_be.num_warm_subgraph_builds
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"weaken:{a}-{b}",
          expect={"warm_subgraph_repair", SELECT}, hints=warm, timed=True, **common)
    check(kernel_be.num_warm_subgraph_builds == before + 1, "weakening did not take the bounded repair")

    # 8. the metric restored: an improvement, the full-edge warm kernels;
    # the column below the link leaves over node64's lane alone again
    set_metric(areas, dbs, a, b, 1)
    set_metric(areas, dbs, b, a, 1)
    before = kernel_be.num_warm_selective_builds
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"restore:{a}-{b}",
          expect=warm_kernels | {SELECT}, hints=warm, timed=True, **common)
    check(kernel_be.num_warm_selective_builds == before + 1, "restore did not re-select selectively")
    check(report.lane_moves > 0, "restore: no lane moved from its warm seed")

    # 9. two unhinted drain ticks: the first keeps its outputs, the second
    # diffs against them on the card
    unhinted = dict(changed_prefixes=set(), force_full=True)
    first = f"node{(side * 3 // 8) * side + side * 3 // 8}"
    set_overload(areas, dbs, first, True)
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"drain:{first}",
          expect=COLD | {SELECT}, hints=unhinted, **common)
    drained = f"node{(side * 5 // 8) * side + side * 5 // 8}"
    set_overload(areas, dbs, drained, True)
    before = kernel_be.num_delta_builds
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"drain:{drained}",
          expect=COLD | {DELTA, GATHER}, hints=unhinted, timed=True, **common)
    check(kernel_be.num_delta_builds == before + 1, "the drain tick did not take the delta path")


def replace_node(areas, dbs, old, new):
    """``new`` takes ``old``'s place in the grid's LSDB on the same
    neighbours and metrics: ``old`` withdraws (if it has not yet), each
    neighbour re-advertises with its adjacency to ``new`` in place of the one
    to ``old``, and ``new`` advertises."""
    ls = areas["0"]
    gone = dbs.pop(old)
    ls.delete_adjacency_database(old)
    for a in gone.adjacencies:
        nbr = dbs[a.other_node_name]
        adjs = [x for x in nbr.adjacencies if x.other_node_name != old]
        adjs.append(make_adjacency(nbr.this_node_name, new, a.metric))
        dbs[nbr.this_node_name] = dataclasses.replace(nbr, adjacencies=adjs)
        ls.update_adjacency_database(dbs[nbr.this_node_name])
    dbs[new] = dataclasses.replace(gone, this_node_name=new, adjacencies=[
        make_adjacency(new, a.other_node_name, a.metric) for a in gone.adjacencies])
    ls.update_adjacency_database(dbs[new])


def move_prefixes(ps, old, new, area="0"):
    """``old``'s prefixes withdrawn and advertised by ``new``: the changed set."""
    changed = set()
    for p, entries in list(ps.prefixes().items()):
        entry = entries.get((old, area))
        if entry is not None:
            changed |= ps.delete_prefix(old, area, p)
            changed |= ps.update_prefix(new, area, entry)
    return changed


def add_link(areas, dbs, a, b, metric):
    for x, y in ((a, b), (b, a)):
        dbs[x] = dataclasses.replace(dbs[x], adjacencies=dbs[x].adjacencies + [
            make_adjacency(x, y, metric)])
        areas["0"].update_adjacency_database(dbs[x])


def membership_tick(report, kernel_be, plain_be, oracle, areas, ps, rng, label, expect, hints,
                    decline=None, me="node0", sample=200, fresh=True):
    """One membership-churn tick through ``drive`` (its exact ``expect``
    set, its RouteDb against the plain path and the oracle sample, with
    ``fresh`` a fresh cold build too, its changed set against the moved
    routes), then: one slot patch and nothing else counted, or with
    ``decline`` one ``slot_decline.<decline>`` and nothing else; the tick's
    encode phase (beside the fresh cold build's), and the topology encode
    alone: the patch against a cold encode of the same LSDB."""
    t_tick = time.perf_counter()
    be = kernel_be
    slots, patches = be.num_encode_slot_patches, be.num_encode_patches
    declines = dict(be._slot_decline_reasons)
    prev_enc = be._enc_cache[2]
    drive(report, be, plain_be, oracle, areas, ps, f"member:{label}", rng=rng, sample=sample,
          expect=expect, hints=hints, steady=True, fresh=fresh)
    if decline is None:
        slots += 1
    else:
        declines[decline] = declines.get(decline, 0) + 1
    check((be.num_encode_slot_patches, be.num_encode_patches, be._slot_decline_reasons)
          == (slots, patches, declines),
          f"{label}: slot patches / patches / declines moved to {be.num_encode_slot_patches}, "
          f"{be.num_encode_patches}, {be._slot_decline_reasons}")
    t0 = time.perf_counter()
    _enc, kind, reason = csr.patch_encoded_multi_area_slots(prev_enc, areas, me)
    patch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    csr.encode_multi_area(areas, me)
    cold_ms = (time.perf_counter() - t0) * 1e3
    check((kind, reason) == (("cold", decline) if decline else ("slot", None)),
          f"{label}: the patch re-run gave {kind} / {reason}")
    cold_build = (f", the fresh cold build's {report.fresh_phase_ms['encode']:.1f} ms (wall "
                  f"{report.fresh_phase_ms['total']:.1f} ms)" if fresh else "")
    print(f"[member:{label}] encode phase {be.last_phase_ms['encode']:.1f} ms{cold_build}; "
          f"topology alone: {kind} patch {patch_ms:.1f} ms, cold encode {cold_ms:.1f} ms; "
          f"the tick with its checks {(time.perf_counter() - t_tick) * 1e3:.1f} ms "
          f"({report.smi})", flush=True)


def membership_ticks(report, kernel_be, plain_be, oracle, dbs, areas, ps, rng):
    """Membership churn on the grid after step 9, on the same backends (no
    world is rebuilt), each tick with its exact kernel set; the grid and its
    prefixes are put back afterwards (without a build) for the later
    phases."""
    side = GRID_SIDE
    n = side * side
    be = kernel_be
    saved_dbs = dict(dbs)
    routes = ps.get_received_routes_count()
    structural = dict(changed_prefixes=set(), force_full=True, structural_delta=True)
    unhinted = dict(changed_prefixes=set(), force_full=True)
    warm_kernels = {"warm_spf_distances", "spf_nexthop_lanes_reset"}
    tick = dict(report=report, kernel_be=be, plain_be=plain_be, oracle=oracle, areas=areas,
                ps=ps, rng=rng)
    struct_fb = be._warm_class_fallbacks["structural"]
    start = {name: getattr(be, f"num_{name}") for name in (
        "scalar_builds", "warm_subgraph_builds", "warm_builds", "warm_selective_builds",
        "delta_builds")}

    def moved(name):
        return getattr(be, f"num_{name}") - start[name]

    # a. an interior node far from node0 leaves: its slot and its four
    # links' rows tombstoned; a removal with the root's lanes unchanged,
    # so the bounded repair, then the warm-selective selection
    far = f"node{(side * 7 // 8) * side + side * 7 // 8}"
    areas["0"].delete_adjacency_database(far)
    membership_tick(label=f"leave:{far}", expect={"warm_subgraph_repair", SELECT},
                    hints=structural, **tick)
    # b. it rejoins: its rows revived (an improvement: the full-edge warm kernels)
    areas["0"].update_adjacency_database(dbs[far])
    membership_tick(label=f"rejoin:{far}", expect=warm_kernels | {SELECT}, hints=structural,
                    fresh=False, **tick)
    check(moved("warm_subgraph_builds") == 1 and moved("warm_selective_builds") == 2,
          "the leave and rejoin did not take the bounded repair and the warm-selective path")
    # c. a root neighbour leaves: the root's lane basis changes (no bounded
    # repair), and too many rows move for a gathered selection
    areas["0"].delete_adjacency_database("node1")
    membership_tick(label="leave:node1", expect=warm_kernels | {SELECT}, hints=structural,
                    fresh=False, **tick)
    check(moved("warm_builds") == 3 and moved("warm_selective_builds") == 2,
          "the root neighbour's leave did not take the full-edge warm kernels and a full selection")
    # d. unhinted: a new name takes node1's slot on node1's links and
    # prefixes; the delta selection diffs against c's outputs with the
    # renamed slot folded into its changed-node mask (most prefixes move,
    # but fewer than half the table's rows: the changed rows are gathered)
    slot1 = be._enc_cache[2].topos[0].node_id("node1")
    repl = f"node{n}"
    replace_node(areas, dbs, "node1", repl)
    hints = dict(unhinted, changed_prefixes=move_prefixes(ps, "node1", repl))
    membership_tick(label=f"replace:node1->{repl}", expect=COLD | {DELTA, GATHER}, hints=hints,
                    **tick)
    node_changed = be.io["delta"][0][-2]
    check(moved("delta_builds") == 1 and bool(node_changed[0, slot1])
          and be._enc_cache[2].topos[0].node_id(repl) == slot1,
          "the replacement did not take the delta path with its slot as a changed node")
    check(be._warm_class_fallbacks["structural"] == struct_fb and moved("scalar_builds") == 0,
          "a membership tick fell back to a cold solve or a scalar build")
    # e. in one tick a node leaves and a new name joins on its links: no
    # slot is free yet (slot_exhaustion), so a cold encode, whose symbol
    # table differs, so a cold solve
    gone = f"node{(side // 8) * side + side * 7 // 8}"
    repl2 = f"node{n + 1}"
    replace_node(areas, dbs, gone, repl2)
    hints = dict(structural, changed_prefixes=move_prefixes(ps, gone, repl2))
    membership_tick(label=f"replace-at-once:{gone}->{repl2}", expect=COLD | {SELECT}, hints=hints,
                    decline="slot_exhaustion", fresh=False, **tick)
    check(be._warm_class_fallbacks["structural"] == struct_fb + 1,
          "the slot_exhaustion tick was not a counted structural fallback")
    # f. a new link between two live border nodes (degree 3 to 4, so the
    # degree bucket holds), a shortcut for the bottom row past it: no
    # tombstoned row to reclaim (new_link), a cold encode on the same
    # symbol table, so the planner warm-starts (an improvement)
    a, b = f"node{(side - 1) * side + side // 4}", f"node{(side - 1) * side + side // 4 + 2}"
    add_link(areas, dbs, a, b, 1)
    membership_tick(label=f"new-link:{a}-{b}", expect=warm_kernels | {SELECT}, hints=structural,
                    decline="new_link", fresh=False, **tick)
    check(be._warm_class_fallbacks["structural"] == struct_fb + 1,
          "the new_link tick fell back to a cold solve")

    # the grid and its prefixes as they were, for the later phases
    ls = areas["0"]
    for name in (repl, repl2):
        ls.delete_adjacency_database(name)
        del dbs[name]
    for node, db in saved_dbs.items():
        if dbs.get(node) is not db:
            dbs[node] = db
            ls.update_adjacency_database(db)
    # the only prefix moves were d's and e's
    for p, entries in list(ps.prefixes().items()):
        for new, old in ((repl, "node1"), (repl2, gone)):
            entry = entries.get((new, "0"))
            if entry is not None:
                ps.delete_prefix(new, "0", p)
                ps.update_prefix(old, "0", entry)
    check(sorted(ls.get_adjacency_databases()) == sorted(saved_dbs)
          and len(ls.all_links()) == 2 * side * (side - 1)
          and ps.get_received_routes_count() == routes, "the grid was not put back")


def three_area_leaves(report, three_area, rng):
    """On the 3-area world after its drain ticks, per algorithm: c5 leaves
    area 3 (the slot patch there, the perturbation patch in areas 1 and
    2)."""
    structural = dict(changed_prefixes=set(), force_full=True, structural_delta=True)
    leave = {"warm_subgraph_repair", SELECT}
    for kb, pb, oracle3, a3, ps3, label in three_area:
        a3["3"].delete_adjacency_database("c5")
        membership_tick(report, kb, pb, oracle3, a3, ps3, rng, f"{label}:leave:c5", leave,
                        structural, me="me", sample=None)
        by_area = dict(zip(kb._last_enc.areas, kb._last_enc.topos))
        check(by_area["3"].tombstoned_nodes == {"c5"} and by_area["1"].slot_changed is None
              and by_area["2"].slot_changed is None,
              f"{label}: not a slot patch in area 3 and perturbation patches elsewhere")


def drain_ticks(report, kernel_be, plain_be, oracle, areas, ps, rng, label, drains, expect):
    """Unhinted drain ticks (``changed_prefixes=set()``, ``force_full``) on a
    world the backend has built: each (area, node) of ``drains`` hard-drained
    in turn; every tick must take the delta path (kernel 7, then kernel 18
    for its changed rows) beside ``expect``, the world's cold kernels."""
    unhinted = dict(changed_prefixes=set(), force_full=True)
    for area, node in drains:
        db = areas[area].get_adjacency_databases()[node]
        areas[area].update_adjacency_database(dataclasses.replace(db, is_overloaded=True))
        before = kernel_be.num_delta_builds
        drive(report, kernel_be, plain_be, oracle, areas, ps, f"{label}:drain:{node}",
              rng=rng, sample=None, expect=expect | {DELTA, GATHER}, hints=unhinted, steady=True)
        check(kernel_be.num_delta_builds == before + 1,
              f"the drain tick of {node} did not take the delta path")


# ---------------------------------------------------------------------------
# the what-if path: kernels 8-11
# ---------------------------------------------------------------------------

WHATIF_KERNELS = ("sweep_spf_link_failures", "repair_sweep", "select_chunk", "compact_deltas")


def _plain_compact(*args, **kwargs):
    count, *rest = sweep_select.compact_deltas_plain(*args, **kwargs)
    return (count.reshape(1), *rest)


def _plain_repair(*args, exact_base=False, **kwargs):
    """Kernel 9's plain version, called as ``repair.repair_sweep`` (the
    plain version works every vertex, whatever the base)."""
    return repair.repair_sweep_plain(*args, **kwargs)


#: (module, attribute, kernel name, plain version) of each kernel entry
#: point the what-if path calls
WHATIF_ENTRIES = (
    (whatif_ops, "sweep_spf_link_failures", "sweep_spf_link_failures",
     spf.sweep_spf_link_failures_plain),
    (repair, "repair_sweep", "repair_sweep", _plain_repair),
    (sweep_select, "select_chunk", "select_chunk", sweep_select.select_chunk_plain),
    (sweep_select, "compact_deltas", "compact_deltas", _plain_compact),
)


class Recorder:
    """Within ``with``: every call of a path's kernel entry points
    (``entries``, the what-if path's by default) keeps its inputs and
    outputs (``calls[name]``), so each kernel can be held against its plain
    version on them afterwards.  With ``plain=True`` the entry points run
    the plain versions instead (the plain path on the card)."""

    def __init__(self, plain=False, entries=None):
        self.plain = plain
        self.entries = WHATIF_ENTRIES if entries is None else entries
        self.calls = {name: [] for _m, _a, name, _p in self.entries}
        self._saved = []

    def __enter__(self):
        for mod, attr, name, plain_fn in self.entries:
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            target = plain_fn if self.plain else orig

            def wrapped(*args, _fn=target, _name=name, **kwargs):
                outs = _fn(*args, **kwargs)
                self.calls[_name].append((args, kwargs, outs))
                return outs

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        self._saved = []
        return False


def whatif_run(report, label, expect, fn, entries=None):
    """One request through the port (the what-if path's, or ``entries``'):
    launch counts zeroed just before and read just after; the run must
    launch exactly ``expect``; every recorded kernel call is then held
    against its plain version."""
    report.tick = label
    with Recorder(entries=entries) as rec:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(LAUNCHES)
    launched = {name for name, n in counts.items() if n}
    check(launched == set(expect), f"{label}: launched {sorted(launched)}, expected {sorted(expect)}")
    for name in KERNEL_NAMES:
        report.launches[name] += counts[name]
    print(f"[{label}] wall={wall:.1f}ms launches={ {k: v for k, v in counts.items() if v} }",
          flush=True)
    if entries is None:
        hold_whatif(report, rec)
        time_compacts(report, rec, label)
    else:
        hold_recorded(report, rec)
    return out, rec, wall


def hold_whatif(report, rec):
    """Every recorded kernel call against its plain version on the same
    inputs, exactly."""
    for args, kw, outs in rec.calls["sweep_spf_link_failures"]:
        want = spf.sweep_spf_link_failures_plain(*args, **kw)
        report.held("sweep_spf_link_failures", [(outs[0], want[0]), (outs[1], want[1])])
    for args, kw, outs in rec.calls["repair_sweep"]:
        want = _plain_repair(*args, **kw)
        report.held("repair_sweep", [(outs[0], want[0]), (outs[1], want[1])])
    for args, kw, outs in rec.calls["select_chunk"]:
        kw = {k: v for k, v in kw.items() if k != "out"}
        want = sweep_select.select_chunk_plain(*args, **kw)
        report.held("select_chunk", list(zip(outs, want)))
    for args, kw, outs in rec.calls["compact_deltas"]:
        report.held("compact_deltas", list(zip(outs, _plain_compact(*args, **kw))))


def time_sweep(report, key, label, args):
    """Hold kernel 8 against its plain version on ``args`` and time it
    under ``key``, per launch and per call of
    ``spf.sweep_spf_link_failures``, with its bound from these inputs: one
    relaxation per usable edge per snapshot (its failed link's edges off)
    and a max per lane a root out-edge can seed; inputs read once, outputs
    written once."""
    src, dst, w, ok, li, failed, ovl, root, D = args
    want_d, want_n, r_d, r_l = spf.sweep_spf_link_failures_plain(*args)
    B = failed.shape[0]
    transit = ~ovl | (torch.arange(ovl.shape[0], device=ovl.device) == root)
    base = ok & transit[src.long()]
    usable = B * int(base.sum()) - int((base[:, None] & (li[:, None] == failed[None])).sum())
    lanes = min(int((src == root).sum()), D)
    launch, outs = spf.sweep_spf_link_failures_launcher(*args)
    report.time(
        "sweep_spf_link_failures", launch, lambda: spf.sweep_spf_link_failures_plain(*args),
        nbytes(src, dst, w, ok, li, failed, ovl, outs[0], outs[1]), (2 + lanes) * usable,
        nbytes(src, w, ok, li) + 2 * nbytes(outs[0]), r_d + r_l, key=key,
    )
    report.held("sweep_spf_link_failures", [(outs[0], want_d), (outs[1], want_n)])
    report.per_call[f"sweep_spf_link_failures at {label} (B = {B}), spf.sweep_spf_link_failures"] = (
        per_launch_ms(lambda: spf.sweep_spf_link_failures(*args)))


def time_chunks(report, rec, label):
    """Time kernel 10 at each snapshot count of the calls ``rec`` holds
    (the base at b = 1, the chunks), under ``select_chunk at <label> (b =
    ...)``, per launch and per call of ``sweep_select.select_chunk``, with
    its bound from these inputs and its launches at that shape; the
    ``select_chunk`` key (the kernels line's) at the first run's largest
    chunk."""
    shapes = {}
    for args, kw, outs in rec.calls["select_chunk"]:
        shapes.setdefault(args[0].shape[1], []).append((args, kw, outs))
    print(f"[{label}] select_chunk launches by snapshots b: "
          f"{ {b: len(c) for b, c in sorted(shapes.items())} }", flush=True)
    for b, calls in sorted(shapes.items()):
        args, kw, outs = calls[0]
        kw = {k: v for k, v in kw.items() if k != "out"}
        key = f"select_chunk at {label} (b = {b})"
        launch, _fresh = sweep_select.select_chunk_launcher(*args, **kw)
        t_bytes = chunk_bytes(args, outs)
        report.time(
            "select_chunk", launch, lambda: sweep_select.select_chunk_plain(*args, **kw),
            t_bytes, chunk_ops(args), t_bytes, 1, key=key,
        )
        report.timing[key]["launches"] = len(calls)
        if "select_chunk" not in report.timing and b == max(shapes):
            report.timing["select_chunk"] = report.timing[key]
        report.per_call[f"select_chunk at {label} (b = {b}), sweep_select.select_chunk"] = (
            per_launch_ms(lambda: sweep_select.select_chunk(*args, **kw)))


def time_whatif(report, rec, label):
    """Time each of kernels 8 and 9 on the first call ``rec`` holds for it,
    and kernel 10 at each of its shapes (:func:`time_chunks`), with its
    bound from these inputs (kernel 11: :func:`time_compacts`, at every
    call of every what-if run)."""
    if rec.calls["sweep_spf_link_failures"] and "sweep_spf_link_failures" not in report.timing:
        args, _kw, _outs = rec.calls["sweep_spf_link_failures"][0]
        time_sweep(report, "sweep_spf_link_failures", "the base solve", args)
    if rec.calls["repair_sweep"] and "repair_sweep" not in report.timing:
        args, kw, outs = max(rec.calls["repair_sweep"], key=lambda c: c[0][5].shape[0])
        _d, _n, r_d, r_l = _plain_repair(*args, **kw)
        src, dst, _w, lid, transit_src_ok, fails, aff_table, base_dist = args[:8]
        V, D, Bw = outs[1].shape
        # what these snapshots need: one relaxation of each usable in-edge
        # (its set's links off) of each affected vertex per snapshot, a max
        # per lane; every vertex where the base is a warm seed
        aff, _d0, en = repair.repair_sweep_init(lid, fails, aff_table, base_dist, V)
        if not kw.get("exact_base"):
            aff = torch.ones_like(aff)
        usable = int((en & transit_src_ok[:, None] & aff[dst.long()]).sum())
        launch, _ = repair.repair_sweep_launcher(*args, **kw)
        report.time(
            "repair_sweep", launch, lambda: _plain_repair(*args, **kw),
            nbytes(*args, outs[0], outs[1]), (2 + D) * usable,
            nbytes(*args[:5]) + 2 * nbytes(outs[0]), r_d + r_l,
        )
    if rec.calls["select_chunk"]:
        time_chunks(report, rec, label)


def time_compacts(report, rec, label):
    """Time kernel 11 at each call ``rec`` holds (the first of the run under
    the kernels line's key), per launch back to back and queued and per
    call of ``sweep_select.compact_deltas``, with its bound from these
    inputs (the changed words and row ids read once, the min(count, cap)
    rows it copies, its outputs written once) and the one PyTorch call that
    finds the same rows (``torch.nonzero`` of the flat changed mask)."""
    name = "compact_deltas"
    for i, (args, kw, outs) in enumerate(rec.calls[name]):
        changed, valid, metric, lanes, row_id, cap = args
        R, P = valid.shape
        Dw = lanes.shape[2]
        count = int(outs[0][0])
        key = name if name not in report.timing else (
            f"{name} at {label} (call {i + 1}: R {R}, P {P}, Dw {Dw}, cap {cap}, count {count})")
        launch, _ = sweep_select.compact_deltas_launcher(*args)
        flat = (unpack_bits_last(changed, P) & (row_id >= 0)[:, None]).reshape(-1)
        t_bytes = nbytes(changed, row_id) + min(count, cap) * (1 + 4 + 4 * Dw) + nbytes(*outs)
        report.time(
            name, launch, lambda: _plain_compact(*args),
            t_bytes, 3 * changed.numel(), t_bytes, 1, key=key,
            library_fn=lambda: torch.nonzero(flat),
        )
        report.timing[key]["launches"] = 1
        report.timing[key]["queued_ms"] = queued_ms(launch)
        report.per_call[f"{key}, sweep_select.compact_deltas"] = (
            per_launch_ms(lambda: sweep_select.compact_deltas(*args, **kw)))


def headline_world(metric_bump=None):
    """The reference benchmark's world: LinkState, a loopback prefix per
    node (PrefixState) and its encoding.  ``metric_bump`` raises node0's
    first link both ways by that much (the second generation)."""
    edges = random_connected_edges(WHATIF_NODES, 2 * WHATIF_NODES, seed=7)
    if metric_bump:
        first = next(i for i, (a, b, _m) in enumerate(edges) if "node0" in (a, b))
        a, b, m = edges[first]
        edges[first] = (a, b, m + metric_bump)
    ls = LinkState("0", "node0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i in range(WHATIF_NODES):
        ps.update_prefix(f"node{i}", "0", PrefixEntry(f"10.{200 + (i >> 8)}.{i & 255}.0/24"))
    return ls, ps, csr.encode_link_state(ls)


def headline_failures(topo):
    """(a)'s WHATIF_FAILURES single-link failures, drawn with seed 0."""
    return np.random.default_rng(0).integers(
        0, len(topo.links), size=WHATIF_FAILURES).astype(np.int32)


def headline_sweep(topo, engine, fails, device=None):
    """(a)'s sweep: ``fails`` through ``engine`` (a ``LinkFailureSweep``
    on ``topo``), then node0's route selection over a loopback prefix per
    node."""
    cands = sweep_select.SweepCandidates.single_advertiser(np.arange(topo.num_nodes))
    sel = sweep_select.SweepRouteSelector(topo, "node0", cands, max_degree=engine.D,
                                          device=device)
    return sel.run(engine.run(fails, fetch=False))


def criticality(engine, ls, ps):
    """(b)'s criticality report over every link of ``ls``, with the scan
    of CRIT_PAIRS pairs."""
    return whatif_api._whatif_engine_criticality(engine, {"0": ls}, ps, 1, max_pairs=CRIT_PAIRS)


def grid_queries(grid_areas, rng):
    """(c)'s operator queries on the grid: node0's links and
    GRID_RANDOM_LINKS others drawn with ``rng``; and a root link with two
    of the random links, the set of 3 (about half the routes move
    again)."""
    gtopo = csr.encode_link_state(grid_areas["0"])
    root_links = [i for i, l in enumerate(gtopo.links) if "node0" in (l.n1, l.n2)]
    rest = [i for i in range(len(gtopo.links)) if i not in root_links]
    others = [int(i) for i in rng.choice(rest, GRID_RANDOM_LINKS, replace=False)]
    query = [(gtopo.links[i].n1, gtopo.links[i].n2) for i in root_links + others]
    return query, [query[0], query[2], query[3]]


def lane_bits_on_affected(rs_engine, fails):
    """Lane bits the repair sets on affected vertices that are not the
    root's neighbours: they start from zero in the warm seed, so every one
    is a lane that moved."""
    plan = rs_engine.plan
    fails_t = torch.from_numpy(fails[:, None]).to(rs_engine.device)
    aff, _d0, _en = repair.repair_sweep_init(
        rs_engine._edges[3], fails_t, rs_engine._plan_t[0], rs_engine._plan_t[1],
        plan.base_dist.shape[0],
    )
    aff[torch.from_numpy(plan.seed_v).long().to(aff.device)] = False
    _d, nh, _, _ = rs_engine.solve(fails)
    bits = unpack_bits_last(nh, len(fails))  # [V, D, B]
    return int((bits & aff[:, None, :]).sum())


def normalized_changes(resp):
    return [
        [dict(c, old_nexthops=sorted(c["old_nexthops"]), new_nexthops=sorted(c["new_nexthops"]))
         for c in f.get("changes", [])]
        for f in resp["failures"]
    ]


def whatif_phases(report, rng, grid_areas, grid_ps):
    """The what-if path: (a) the headline sweep, cold then warm-seeded,
    (b) the criticality report, (c) operator queries on the grid."""
    walls = {}
    kernels = set(WHATIF_KERNELS)
    warm_kernels = kernels - {"sweep_spf_link_failures"}

    # (a) the headline sweep: 10,240 single-link failures
    ls, ps, topo = headline_world()
    fails = headline_failures(topo)
    eng = whatif_ops.LinkFailureSweep(topo, "node0")
    deltas, rec, walls["a: cold sweep"] = whatif_run(
        report, "whatif:headline-cold", kernels, lambda: headline_sweep(topo, eng, fails)
    )
    check(eng.base_source == "device", "the cold base did not come from the sweep kernel")
    time_whatif(report, rec, "(a)")
    # kernel 9 per call of RepairSweep.solve at the main run's largest chunk
    chunk = max(rec.calls["repair_sweep"], key=lambda c: c[0][5].shape[0])[0][5].cpu().numpy()
    rs_engine = eng.repair_sweep()
    report.per_call[f"repair_sweep, RepairSweep.solve at (a)'s chunk of {len(chunk)}"] = (
        per_launch_ms(lambda: rs_engine.solve(chunk)))
    solves = len(np.unique(deltas.snap_row)) - 1
    print(f"[whatif:headline-cold] {WHATIF_FAILURES} failures, {solves} unique on-DAG solves, "
          f"{deltas.num_deltas} route deltas, fetch groups {deltas.fetch_groups}", flush=True)
    check(deltas.num_deltas > 0 and deltas.fetch_groups >= 1, "headline sweep found no deltas")

    # the repair tables against the cold kernel's, on COLD_HOLD failures
    hold = fails[:COLD_HOLD]
    r_dist, r_nh, _, _ = rs_engine.solve(hold)
    hold_args = (eng._src, eng._dst, eng._w, eng._edge_ok, eng._link_index,
                 torch.from_numpy(hold).to(eng.device), eng._overloaded, eng.root_id, eng.D)
    c_dist, c_nh, _, _ = spf.sweep_spf_link_failures(*hold_args)
    bits = unpack_bits_last(r_nh, COLD_HOLD).permute(0, 2, 1).to(torch.int8)
    check(torch.equal(r_dist, c_dist) and torch.equal(bits, (c_nh > 0).to(torch.int8)),
          "repair tables != cold sweep tables")
    moved = lane_bits_on_affected(rs_engine, hold)
    check(moved > 0, "no lane moved from the warm seed")
    time_sweep(report, f"sweep_spf_link_failures at the repair hold ({COLD_HOLD} failures)",
               "the repair hold", hold_args)
    print(f"[whatif:headline-cold] repair tables == cold sweep tables on {COLD_HOLD} failures; "
          f"{moved} lane bits set on affected vertices (zero in the warm seed)", flush=True)

    # the second generation: node0's first link raised, warm-seeded base
    _ls2, _ps2, topo2 = headline_world(metric_bump=5)
    eng2 = whatif_ops.LinkFailureSweep(topo2, "node0")
    check(eng2.seed_base_from(eng), "the second generation did not take the warm seed")
    deltas2, _rec, walls["a: warm-seeded sweep"] = whatif_run(
        report, "whatif:headline-warm", warm_kernels, lambda: headline_sweep(topo2, eng2, fails)
    )
    check(eng2.base_source == "warm", "the second generation's base was not warm")
    cold2 = whatif_ops.LinkFailureSweep(topo2, "node0").base_solve()
    check(all(np.array_equal(a, b) for a, b in zip(cold2, eng2.base_solve())),
          "warm base != cold base")
    print(f"[whatif:headline-warm] {deltas2.num_deltas} route deltas; warm base == cold base",
          flush=True)

    # (b) criticality over every link, with the pair scan
    engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
    areas = {"0": ls}
    crit, rec, walls["b: criticality"] = whatif_run(
        report, "whatif:criticality", kernels, lambda: criticality(engine, ls, ps)
    )
    time_chunks(report, rec, "(b)")
    pairs = crit["pairs"]
    check(len(crit["links"]) == len(topo.links) and pairs["checked"] == CRIT_PAIRS,
          "criticality did not cover every link and the pair budget")
    print(f"[whatif:criticality] {len(crit['links'])} links, top withdraws "
          f"{crit['links'][0]['routes_withdrawn']}; {pairs['checked']} of {pairs['total']} pairs, "
          f"{pairs['risky_count']} risky", flush=True)

    # answers against the scalar solver with the links removed
    on_dag = engine._sweep.on_dag_links()
    cand = [int(l) for l in np.unique(fails) if on_dag[l]]
    picks = [cand[i] for i in rng.choice(len(cand), GENERIC_SAMPLE, replace=False)]
    root_link = next(i for i, l in enumerate(topo.links) if "node0" in (l.n1, l.n2))
    pair_names = [(topo.links[i].n1, topo.links[i].n2) for i in [root_link] + picks]
    generic = whatif_api.GenericSolverWhatIfEngine(SpfSolver("node0"))
    got = engine.run(pair_names, areas, ps, 1)
    want = generic.run(pair_names, areas, ps, 1)
    check(normalized_changes(got) == normalized_changes(want), "what-if != generic solver")
    sim = pair_names[:3]
    got = engine.run(sim, areas, ps, 1, simultaneous=True)
    want = generic.run(sim, areas, ps, 1, simultaneous=True)
    check(normalized_changes(got) == normalized_changes(want), "simultaneous what-if != generic solver")
    changed = sum(f["routes_changed"] for f in engine.run(pair_names, areas, ps, 1)["failures"])
    print(f"[whatif:headline] {len(pair_names)} failures ({changed} route changes) and a set of 3 "
          f"== GenericSolverWhatIfEngine", flush=True)

    # (c) operator queries on the grid at full prefix width
    query, sim = grid_queries(grid_areas, rng)
    grid_engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
    got, rec, walls["c: grid query"] = whatif_run(
        report, "whatif:grid", kernels, lambda: grid_engine.run(query, grid_areas, grid_ps, 1)
    )
    check(len(rec.calls["compact_deltas"]) >= 2, "the grid query did not overflow the compaction")
    time_chunks(report, rec, "(c)")
    got_sim, rec, walls["c: grid set of 3"] = whatif_run(
        report, "whatif:grid-set", warm_kernels,
        lambda: grid_engine.run(sim, grid_areas, grid_ps, 1, simultaneous=True),
    )
    time_chunks(report, rec, "(c) set of 3")
    plain_engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
    with Recorder(plain=True):
        reset_launch_counts()
        want = plain_engine.run(query, grid_areas, grid_ps, 1)
        want_sim = plain_engine.run(sim, grid_areas, grid_ps, 1, simultaneous=True)
        check(not any(LAUNCHES.values()), "the plain path launched a kernel")
    check(got == want and got_sim == want_sim, "grid what-if != plain path")
    moved = [f["routes_changed"] for f in got["failures"]]
    print(f"[whatif:grid] {len(query)} failures, routes changed per failure: max {max(moved)}, "
          f"total {sum(moved)}; set of 3: {got_sim['failures'][0]['routes_changed']}; "
          f"== plain path", flush=True)
    grid_oracle_sample(rng, grid_areas, grid_ps, query[0], got["failures"][0])
    grid_oracle_sample(rng, grid_areas, grid_ps, query[-1], got["failures"][-1])
    return walls


def grid_oracle_sample(rng, areas, ps, link, failure, sample=100):
    """A sample of the grid's prefixes, changed and unchanged, against the
    scalar solver on the LSDB with the link removed."""
    drop = {frozenset(link)}
    mod = whatif_api.GenericSolverWhatIfEngine._states_without(areas, drop)
    base_oracle, mod_oracle = SpfSolver("node0"), SpfSolver("node0")
    by_prefix = {c["prefix"]: c for c in failure["changes"]}
    prefixes = sorted(ps.prefixes())
    changed = sorted(by_prefix)
    picks = [prefixes[i] for i in rng.choice(len(prefixes), sample, replace=False)]
    if changed:
        picks += [changed[i] for i in rng.choice(len(changed), min(sample, len(changed)), replace=False)]

    def view(entry):
        if entry is None:
            return None
        return float(entry.igp_cost), sorted({n.neighbor_node_name for n in entry.nexthops})

    for p in picks:
        old = view(base_oracle.create_route_for_prefix(p, areas, ps))
        new = view(mod_oracle.create_route_for_prefix(p, mod, ps))
        c = by_prefix.get(p)
        if old == new:
            check(c is None, f"grid what-if {link}: {p} reported changed, oracle unchanged")
            continue
        check(c is not None, f"grid what-if {link}: {p} changed in the oracle, not reported")
        check((c["old_metric"], sorted(c["old_nexthops"])) == (old if old else (None, [])),
              f"grid what-if {link}: {p} old route != oracle")
        check((c["new_metric"], sorted(c["new_nexthops"])) == (new if new else (None, [])),
              f"grid what-if {link}: {p} new route != oracle")
    print(f"[whatif:grid] link {link[0]}-{link[1]}: {len(picks)} sampled prefixes "
          f"== scalar oracle ({len(changed)} changed)", flush=True)


# ---------------------------------------------------------------------------
# the fleet RIB and the multi-area what-if: kernels 12-14
# ---------------------------------------------------------------------------

#: (module, attribute, kernel name, plain version) of each kernel entry
#: point the fleet and multi-area paths call (``ops/spf.py``'s own name is
#: the one ``multi_area_spf_tables`` reaches)
FLEET_ENTRIES = (
    (fleet_tables, "fleet_spf_dense", "fleet_spf_dense", spf.fleet_spf_dense_plain),
    (fleet_tables, "spf_segment_batch", "spf_segment_batch", spf.spf_segment_batch_plain),
    (spf, "spf_segment_batch", "spf_segment_batch", spf.spf_segment_batch_plain),
    (fleet_tables, "fleet_select", "fleet_select", rs.fleet_select_plain),
)
PLAIN_OF = {name: plain_fn for _m, _a, name, plain_fn in FLEET_ENTRIES}
DENSE_FLEET = {"fleet_spf_dense", "fleet_select"}
SEGMENT_FLEET = {"spf_segment_batch", "fleet_select"}


def hold_recorded(report, rec):
    """Every recorded call of kernels 12-14 against its plain version on
    the same inputs, exactly."""
    for name, calls in rec.calls.items():
        for args, kw, outs in calls:
            report.held(name, list(zip(outs, PLAIN_OF[name](*args, **kw))))


def _present_rows(roots, A):
    """(flat row index, area index) of the (row, area) pairs with a root."""
    flat = roots.reshape(-1)
    rows = torch.nonzero(flat >= 0).squeeze(1)
    return rows, rows % A


def time_fleet(report, name, call, key=None, force_global=False, launches=TIMED_LAUNCHES,
               spans=TIMED_SPANS):
    """Time kernel ``name`` on one recorded call, with its bound from these
    inputs: bytes read and written once, and one relaxation per usable
    edge (or in-edge slot) per (row, area) pair solved, a max per lane a
    root out-edge can seed for the lanes (kernel 13: the selection chain's
    operations per batch row).  ``force_global`` binds kernel 12 or 14 on
    its global-state layout (a shared-memory budget of 0 while the launch
    is bound) and first holds its outputs against the recorded ones.
    ``key``, ``launches`` and ``spans`` as in ``KernelReport.time``."""
    if (key or name) in report.timing:
        return
    args, kw, outs = call
    plain = PLAIN_OF[name]
    t_bytes = nbytes(*args, *kw.values(), *outs)
    if name == "fleet_spf_dense":
        in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D = args
        A, V, K = in_src.shape
        rows, area = _present_rows(roots, A)
        planes = (in_src[area], in_w[area], in_ok[area], in_rank[area], in_has[area],
                  ovl[area], roots.reshape(-1)[rows])
        r_d = relax_rounds(planes[0], planes[1], planes[2], planes[5], planes[6])
        r_l = lane_rounds(planes, outs[0].reshape(-1, V)[rows])
        R = len(rows)
        usable, lanes = dense_relaxations(planes[0], planes[2], planes[3], planes[5],
                                          planes[6], D)
        ops = int((2 * usable + usable * lanes).sum())
        per_round = R * nbytes(in_src[0], in_w[0], in_ok[0])
        launcher = spf.fleet_spf_dense_launcher
    elif name == "spf_segment_batch":
        src, dst, w, ok, ovl, roots, D = args[:7]
        A, E = src.shape
        rows, area = _present_rows(roots, A)
        fail = kw.get("fail_area")
        ok_rows = ok[None].expand(roots.shape[0], A, E)
        if fail is not None:
            ok_rows = ok_rows & ~spf.failed_edge_mask(kw["link_index"], fail, kw["fail_link"])
        seg = (src[area], dst[area], w[area], ok_rows.reshape(-1, E)[rows], ovl[area],
               roots.reshape(-1)[rows])
        d0 = torch.full(ovl[area].shape, BIG, device=src.device)
        dist, r_d = spf.warm_spf_distances_plain(*seg, d0, unroll=1)
        zero = torch.zeros((len(rows), ovl.shape[1], D), dtype=torch.int8, device=src.device)
        r_l = spf.spf_nexthop_lanes_reset_plain(*seg, dist, zero, D, unroll=1)[1]
        r_d, r_l = int(r_d.max()), int(r_l.max())
        R = len(rows)
        usable, lanes = segment_relaxations(seg[0], seg[3], seg[4], seg[5], D)
        ops = int((2 * usable + usable * lanes).sum())
        per_round = R * nbytes(src[0], w[0], ok[0])
        launcher = spf.spf_segment_batch_launcher
    else:
        B, A, _V = args[0].shape
        P, C = args[4].shape
        D = args[1].shape[-1]
        t_bytes = select_bytes(args, kw, outs)
        ops = B * select_ops(P, C, A, D)
        per_round, r_d, r_l = t_bytes, 1, 0
        launcher = rs.fleet_select_launcher
    budget = spf.MAX_SHARED_BYTES
    if force_global:
        spf.MAX_SHARED_BYTES = 0
    try:
        launch, got = launcher(*args, **kw)
    finally:
        spf.MAX_SHARED_BYTES = budget
    if force_global:
        launch()
        report.held(name, list(zip(got, outs)))
    report.time(name, launch, lambda: plain(*args, **kw), t_bytes, ops, per_round, r_d + r_l,
                key=key, launches=launches, spans=spans)


def fleet_world(metric_bump=0):
    """The reference benchmark's fleet world: the headline WAN, one /24 per
    node in sorted order, LinkState with vantage node0.  ``metric_bump``
    raises one link (the 100th, both ways) by that much."""
    edges = random_connected_edges(FLEET_NODES, 2 * FLEET_NODES, seed=7)
    if metric_bump:
        a, b, m = edges[100]
        edges[100] = (a, b, m + metric_bump)
    dbs = build_adj_dbs(edges)
    ls = LinkState("0", "node0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    nodes = sorted(dbs)
    ps = PrefixState()
    for i, node in enumerate(nodes):
        ps.update_prefix(node, "0", PrefixEntry(f"10.{(i >> 8) & 255}.{i & 255}.0/24"))
    return {"0": ls}, ps, nodes


def hold_every_root(eng, areas, ps, seq, roots, summary, label):
    """Each root's fleet RouteDb against the scalar solver's, and the
    summary's count against the RouteDb."""
    for node in roots:
        db = eng.compute_for_node(node, areas, ps, seq)
        want = SpfSolver(node, route_selection_algorithm=eng.solver.route_selection_algorithm)
        ref = want.build_route_db(areas, ps)
        check(route_db_summary(db) == route_db_summary(ref), f"{label}: {node} != scalar oracle")
        check(summary[node]["num_routes"] == len(ref.unicast_routes),
              f"{label}: {node} summary count != scalar oracle")


def fleet_phases(report, rng, grid_areas):
    """(d) the fleet on the reference benchmark's world, cold, decode-all,
    then two delta generations; (e) the fleet on the 3-area world and the
    hub world (segment form), the backend on the hub world, kernel 14
    against kernels 1/2 on the grid; (f) the multi-area what-if on the
    wan_multi_area class."""
    walls = {}
    # (d) cold
    areas, ps, nodes = fleet_world()
    eng = FleetRibEngine(SpfSolver("node0"))
    check(eng.eligible(areas, ps, 1), "the fleet world is not eligible")
    summary, rec, walls["d: fleet solve, cold"] = whatif_run(
        report, "fleet:wan-cold", DENSE_FLEET, lambda: eng.fleet_summary(areas, ps, 1),
        entries=FLEET_ENTRIES,
    )
    time_fleet(report, "fleet_spf_dense", rec.calls["fleet_spf_dense"][0])
    time_fleet(report, "fleet_select", rec.calls["fleet_select"][0])
    t0 = time.perf_counter()
    dbs = [eng.compute_for_node(node, areas, ps, 1) for node in nodes]
    walls["d: decode all"] = (time.perf_counter() - t0) * 1e3
    check(all(db is not None for db in dbs) and eng.num_batched_solves == 1,
          "decode-all re-solved or missed a root")
    for node, db in zip(nodes, dbs):
        check(summary[node]["num_routes"] == len(db.unicast_routes), f"fleet: {node} count")
    picks = ["node0"] + [nodes[i] for i in rng.choice(len(nodes), FLEET_ORACLE_SAMPLE - 1, replace=False)]
    hold_every_root(eng, areas, ps, 1, picks, summary, "fleet:wan")
    plain_eng = FleetRibEngine(SpfSolver("node0"))
    with Recorder(plain=True, entries=FLEET_ENTRIES):
        reset_launch_counts()
        check(plain_eng.fleet_summary(areas, ps, 1) == summary, "fleet summary != plain path")
        check(not any(LAUNCHES.values()), "the plain path launched a kernel")
    routes = sum(len(db.unicast_routes) for db in dbs)
    rate = len(nodes) / ((walls["d: fleet solve, cold"] + walls["d: decode all"]) / 1e3)
    print(f"[fleet:wan-cold] {len(nodes)} vantage RIBs ({routes} routes), decode-all "
          f"{walls['d: decode all']:.1f} ms: {rate:.1f} vantage RIBs per second (solve + "
          f"decode-all); {len(picks)} roots == scalar oracle; summary == plain path", flush=True)
    # (d) two delta generations: one link raised, then restored
    for seq, bump, label in ((2, 7, "raised"), (3, 0, "restored")):
        areas, ps, _ = fleet_world(metric_bump=bump)
        before = (eng.num_delta_roots_fetched, eng.num_delta_roots_skipped)
        got, _rec, walls[f"d: delta generation, {label}"] = whatif_run(
            report, f"fleet:wan-delta-{label}", DENSE_FLEET | {GATHER},
            lambda: eng.fleet_summary(areas, ps, seq), entries=FLEET_ENTRIES,
        )
        check(eng.num_delta_solves == seq - 1, f"the {label} generation did not take the delta")
        fresh = FleetRibEngine(SpfSolver("node0")).fleet_summary(areas, ps, seq)
        check(got == fresh, f"delta summary ({label}) != a fresh engine's")
        if bump == 0:
            check(got == summary, "the restored generation != the first")
        fetched = eng.num_delta_roots_fetched - before[0]
        skipped = eng.num_delta_roots_skipped - before[1]
        print(f"[fleet:wan-delta-{label}] roots fetched {fetched}, skipped {skipped}; summary == "
              f"a fresh engine's", flush=True)

    # (e) the 3-area world under both algorithms: most roots absent somewhere
    for algo in (RouteComputationRules.SHORTEST_DISTANCE,
                 RouteComputationRules.PER_AREA_SHORTEST_DISTANCE):
        a3, ps3, me = three_area_world()
        eng3 = FleetRibEngine(SpfSolver(me, route_selection_algorithm=algo))
        s3, _rec, _wall = whatif_run(report, f"fleet:3-area:{algo.name}", DENSE_FLEET,
                                     lambda: eng3.fleet_summary(a3, ps3, 1), entries=FLEET_ENTRIES)
        hold_every_root(eng3, a3, ps3, 1, sorted(s3), s3, f"fleet:3-area:{algo.name}")
        print(f"[fleet:3-area:{algo.name}] {len(s3)} roots == scalar oracle", flush=True)
    # (e) the hub world: declines the dense layout
    hub_edges = [("hub", f"leaf{i}", 1) for i in range(HUB_LEAVES)]
    hub = LinkState("0", "hub")
    for db in build_adj_dbs(hub_edges).values():
        hub.update_adjacency_database(db)
    hub_ps = PrefixState()
    for i in range(64):
        hub_ps.update_prefix(f"leaf{i}", "0", PrefixEntry(f"10.3.{i}.0/24"))
    hub_areas = {"0": hub}
    check(not csr.encode_multi_area(hub_areas, "hub").has_dense, "the hub world kept the dense layout")
    hub_eng = FleetRibEngine(SpfSolver("hub"))
    hs, _rec, walls["e: hub fleet solve"] = whatif_run(
        report, "fleet:hub", SEGMENT_FLEET, lambda: hub_eng.fleet_summary(hub_areas, hub_ps, 1),
        entries=FLEET_ENTRIES,
    )
    hold_every_root(hub_eng, hub_areas, hub_ps, 1, sorted(hs), hs, "fleet:hub")
    print(f"[fleet:hub] {len(hs)} roots == scalar oracle", flush=True)
    hub_be, hub_plain = KernelPath(SpfSolver("hub")), PlainPath(SpfSolver("hub"))
    drive(report, hub_be, hub_plain, SpfSolver("hub"), hub_areas, hub_ps, "backend:hub",
          rng=rng, sample=None, expect={"spf_segment_batch", SELECT})
    drain_ticks(report, hub_be, hub_plain, SpfSolver("hub"), hub_areas, hub_ps, rng,
                "backend:hub", (("0", "leaf0"), ("0", "leaf1")), {"spf_segment_batch"})
    # (e) kernel 14 at one row against kernels 1/2 on the grid
    enc = csr.encode_multi_area(grid_areas, "node0")
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    seg = tables_from_numpy(
        [getattr(enc, k) for k in ("src", "dst", "w", "edge_ok", "overloaded", "roots")], "cuda"
    )
    planes = tables_from_numpy(
        [getattr(enc, k) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")],
        "cuda",
    )
    one = spf.spf_one(*seg, D)
    cold = spf.dense_spf_one(*planes, max_degree=D)
    report.held("spf_segment_batch", [(one[0], cold[0]), (one[1], cold[1])])
    print("[grid] kernel 14 at one row == kernels 1/2 (dist and int8 lanes)", flush=True)

    walls.update(multiarea_phase(report, rng))
    return walls


def multiarea_world():
    """The wan_multi_area class at MULTIAREA_SCALE, seed 7: a /32 loopback
    per node in its own area, and each metro's two gateways advertising
    the metro's /24 into the backbone area "0" (an anycast pair)."""
    area_dbs = wan_multi_area_dbs(MULTIAREA_SCALE, 7)
    me = "m0_0"
    areas = {}
    for area, dbs in area_dbs.items():
        ls = LinkState(area, me)
        for db in dbs.values():
            ls.update_adjacency_database(db)
        areas[area] = ls
    nodes = sorted({n for dbs in area_dbs.values() for n in dbs})
    ps = PrefixState()
    for i, node in enumerate(nodes):
        ps.update_prefix(node, wan_area_of(node), PrefixEntry(f"10.{(i >> 8) & 255}.{i & 255}.1/32"))
    metros = sorted({wan_area_of(n) for n in nodes} - {"0"}, key=lambda a: int(a[5:]))
    for a in metros:
        j = int(a[5:])
        for gw in (f"m{j}_0", f"m{j}_8"):
            ps.update_prefix(gw, "0", PrefixEntry(f"172.16.{j}.0/24"))
    return areas, ps, me


def normalized(resp):
    return [
        sorted((c["prefix"], c["change"], c["old_metric"], tuple(sorted(c["old_nexthops"])),
                c["new_metric"], tuple(sorted(c["new_nexthops"])))
               for c in f.get("changes", []))
        for f in resp["failures"]
    ]


def multiarea_phase(report, rng):
    """(f) every single-link failure of area "0" and metro0 in one batch,
    then the set of metro0's two homing links, from the ABR m0_0."""
    walls = {}
    areas, ps, me = multiarea_world()
    enc = csr.encode_multi_area(areas, me)
    by_area = dict(zip(enc.areas, enc.topos))
    singles = [(l.n1, l.n2) for a in ("0", "metro0") for l in by_area[a].links]
    homing = [(l.n1, l.n2) for l in by_area["0"].links
              if wan_area_of(l.n1) == "metro0" or wan_area_of(l.n2) == "metro0"]
    check(len(homing) == 2, f"metro0 has {len(homing)} homing links")
    print(f"[multiarea] {len(areas)} areas, V={enc.overloaded.shape[1]}, "
          f"E={enc.src.shape[1]}, {len(ps.prefixes())} prefixes, {len(singles)} single failures",
          flush=True)
    eng = whatif_api.MultiAreaWhatIfEngine(SpfSolver(me))
    got, rec, walls["f: multi-area sweep"] = whatif_run(
        report, "multiarea:singles", SEGMENT_FLEET, lambda: eng.run(singles, areas, ps, 1),
        entries=FLEET_ENTRIES,
    )
    sweep_call = max(rec.calls["spf_segment_batch"], key=lambda c: c[0][5].shape[0])
    time_fleet(report, "spf_segment_batch", sweep_call)
    time_fleet(report, "spf_segment_batch", sweep_call,
               key="spf_segment_batch global path, (f) shape", force_global=True)
    got_set, _rec, walls["f: homing-link set"] = whatif_run(
        report, "multiarea:set", SEGMENT_FLEET,
        lambda: eng.run(homing, areas, ps, 1, simultaneous=True), entries=FLEET_ENTRIES,
    )
    plain_eng = whatif_api.MultiAreaWhatIfEngine(SpfSolver(me))
    with Recorder(plain=True, entries=FLEET_ENTRIES):
        reset_launch_counts()
        check(plain_eng.run(singles, areas, ps, 1) == got, "multi-area answers != plain path")
        check(plain_eng.run(homing, areas, ps, 1, simultaneous=True) == got_set,
              "multi-area set != plain path")
        check(not any(LAUNCHES.values()), "the plain path launched a kernel")
    generic = whatif_api.GenericSolverWhatIfEngine(SpfSolver(me))
    picks = [singles[i] for i in rng.choice(len(singles), MULTIAREA_GENERIC_SAMPLE, replace=False)]
    picks += [h for h in homing if h not in picks]
    sample = eng.run(picks, areas, ps, 1)
    check(normalized(sample) == normalized(generic.run(picks, areas, ps, 1)),
          "multi-area answers != GenericSolverWhatIfEngine")
    check(normalized(got_set) == normalized(generic.run(homing, areas, ps, 1, simultaneous=True)),
          "multi-area set != GenericSolverWhatIfEngine")
    moved = [f["routes_changed"] for f in got["failures"]]
    print(f"[multiarea] {len(singles)} failures, routes changed per failure: max {max(moved)}, "
          f"total {sum(moved)}; homing set: {got_set['failures'][0]['routes_changed']}; == plain "
          f"path; {len(picks)} failures and the set == GenericSolverWhatIfEngine", flush=True)
    return walls


# ---------------------------------------------------------------------------
# (g) KSP2_ED_ECMP on a backbone: kernel 15; (h) the shapes past the
# shared-memory bound: kernels 12 and 14's lane lists in a global scratch
# ---------------------------------------------------------------------------

#: the KSP2 engine's entry point of kernel 15 (decision/ksp2.py's own name)
KSP2_ENTRIES = (
    (ksp2_mod, "batched_spf_distances_masked_sets", "spf_distances_masked",
     spf.batched_spf_distances_masked_sets_plain),
)
PLAIN_OF["spf_distances_masked"] = spf.batched_spf_distances_masked_sets_plain
#: kernel 3 as the backend calls it (the device-build what-if's builds)
SELECT_ENTRIES = (
    (backend_mod, "multi_area_select_from_tables", SELECT, rs.multi_area_select_from_tables_plain),
)
PLAIN_OF[SELECT] = rs.multi_area_select_from_tables_plain
KSP2_COLD = COLD | {SELECT, "spf_distances_masked"}


def backbone_dbs():
    """The wan_hierarchy class at KSP2_SCALE, seed 7, with node labels as
    tests/test_ksp2_device.py sets them: (adjacency databases, node names)."""
    edges = _build_wan(KSP2_SCALE, 7)
    nodes = sorted({n for e in edges for n in e[:2]})
    labels = {n: 100 + i for i, n in enumerate(nodes)}
    return build_adj_dbs(edges, node_labels=labels), nodes


def backbone_copy(dbs):
    ls = LinkState("0", "core0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    return {"0": ls}


def loopback(i):
    """Node i's KSP2 /32 loopback; every second node's also SR-MPLS."""
    ftype = PrefixForwardingType.SR_MPLS if i % 2 else PrefixForwardingType.IP
    return PrefixEntry(f"10.{100 + (i >> 8)}.{i & 255}.1/32",
                       forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
                       forwarding_type=ftype)


def masked_enabled_edges(ok, li, failed):
    """Sum over kernel 15's rows of the edges each row may relax (usable
    and not of its failed links): the least work of any solver, one
    relaxation per enabled edge per row."""
    total = 0
    for r0, r1 in spf._row_chunks(failed.shape[0], 4 * ok.shape[0]):
        total += int((ok[None] & spf.failed_links_mask(li, failed[r0:r1])).sum())
    return total


def time_masked(report, call, key):
    """Time kernel 15 on one recorded call (under ``key``, as in
    ``KernelReport.time``), with its bound: inputs read and the [B, V]
    output written once, and one relaxation per enabled edge per row
    (however many rounds the kernel takes)."""
    args, _kw, outs = call
    src, dst, w, ok, li, failed, ovl, roots = args
    edges = masked_enabled_edges(ok, li, failed)
    launch, _ = spf.spf_distances_masked_launcher(src, dst, w, ok, ovl, roots, None, li, failed)
    report.time("spf_distances_masked", launch, lambda: PLAIN_OF["spf_distances_masked"](*args),
                nbytes(*args, outs), 2 * edges, nbytes(src, w, ok, li), 1, key=key)
    t = report.timing[key]
    cut = int(((outs < BIG).sum(dim=1) == 1).sum())
    print(f"[ksp2] {key} at B={failed.shape[0]}, S={failed.shape[1]}: {t['ms']:.4f} ms per "
          f"launch, plain {t['plain_ms']:.2f} ms; {edges / failed.shape[0]:.1f} enabled edges per "
          f"row; {cut} rows cut off at the root", flush=True)


def drive_ksp2(report, kernel_be, plain_be, areas, ps, label, rng, expect, rows, hints=None,
               timed=None):
    """One request through the port's main path on the KSP2 world: launch
    counts zeroed just before and read just after; ``expect`` the exact
    kernels and ``rows`` the rows of each kernel-15 launch; every kernel
    the build ran held against its plain version on its inputs; the
    RouteDb against the plain path on its own LinkStates
    (``areas["plain"]``) and a seeded sample against the scalar solver on
    a third copy (``areas["oracle"]``), so no k-path memo is shared.
    ``expect`` may be a function of the backend, read after the build
    (the warm path the planner chose).  ``timed``, a key, times kernel 15
    on the build's first call under it."""
    hints = hints or {}
    with Recorder(entries=KSP2_ENTRIES) as rec:
        reset_launch_counts()
        t0 = time.perf_counter()
        db = kernel_be.build_route_db(areas["kernel"], ps, **hints)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(LAUNCHES)
    if callable(expect):
        expect = expect(kernel_be)
    launched = {name for name, n in counts.items() if n}
    check(launched == set(expect), f"{label}: launched {sorted(launched)}, expected {sorted(expect)}")
    got_rows = [c[0][5].shape[0] for c in rec.calls["spf_distances_masked"]]
    check(got_rows == rows, f"{label}: kernel-15 rows {got_rows}, expected {rows}")
    for name in KERNEL_NAMES:
        report.launches[name] += counts[name]
    phases = " ".join(f"{k}={v:.1f}ms" for k, v in kernel_be.last_phase_ms.items())
    print(f"[{label}] build wall={wall:.1f}ms {phases} launches="
          f"{ {k: v for k, v in counts.items() if v} } kernel-15 rows={got_rows} "
          f"routes={len(db.unicast_routes)}", flush=True)
    report.tick = label
    report.kernel_checks(kernel_be, False)
    if "warm" in kernel_be.io or "sub" in kernel_be.io:
        warm_tables_equal_cold(kernel_be)
    hold_recorded(report, rec)
    if timed:
        time_masked(report, rec.calls["spf_distances_masked"][0], timed)
    with Recorder(plain=True, entries=KSP2_ENTRIES):
        reset_launch_counts()
        plain_db = plain_be.build_route_db(areas["plain"], ps, **hints)
        check(not LAUNCHES["spf_distances_masked"], "the plain path launched kernel 15")
    plain_be.take_last_changed_prefixes()
    check(route_db_summary(plain_db) == route_db_summary(db), f"{label}: RouteDb != plain path")
    prefixes = sorted(ps.prefixes())
    picks = [prefixes[i] for i in rng.choice(len(prefixes), KSP2_ORACLE_SAMPLE, replace=False)]
    sample_oracle(db, SpfSolver("core0"), areas["oracle"], ps, picks, label)
    stacks = sum(nh.mpls_action is not None for p in picks if p in db.unicast_routes
                 for nh in db.unicast_routes[p].nexthops)
    print(f"[{label}] kernels == plain, RouteDb == plain path, {len(picks)} prefixes == scalar "
          f"oracle ({stacks} SR-MPLS push stacks among their nexthops)", flush=True)
    return wall


def ksp2_phase(report, rng):
    """(g) KSP2_ED_ECMP on the backbone WAN: a cold build, prefix churn
    with two new destinations, a warm_delta weakening of a backbone link
    (the topology change clears the k-path memo: every destination solves
    again), then ``DeviceBuildWhatIfEngine`` on seeded backbone links.
    Returns (walls, the world's encoding)."""
    walls = {}
    t0 = time.perf_counter()
    dbs, nodes = backbone_dbs()
    areas = {k: backbone_copy(dbs) for k in ("kernel", "plain", "oracle")}
    # every node advertises its loopback but the last two by name, which
    # join on the churn tick: a prefix-only tick adds a KSP2 destination
    # only where the node had none
    ps = PrefixState()
    for i, node in enumerate(nodes[:-2]):
        ps.update_prefix(node, "0", loopback(i))
    enc = csr.encode_multi_area(areas["kernel"], "core0")
    check(enc.has_dense, "the backbone declined the dense layout")
    dests = len(nodes) - 3  # the advertisers but core0
    print(f"[ksp2] backbone: {len(nodes)} nodes, {enc.topos[0].num_edges // 2} links, "
          f"V={enc.overloaded.shape[1]}, E={enc.src.shape[1]}, K={enc.in_src.shape[2]}, "
          f"{len(ps.prefixes())} KSP2 loopbacks, built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    kernel_be = KernelPath(SpfSolver("core0"))
    plain_be = PlainPath(SpfSolver("core0"))
    walls["g: KSP2 cold build"] = drive_ksp2(
        report, kernel_be, plain_be, areas, ps, "ksp2:cold", rng, KSP2_COLD, [dests],
        hints=dict(force_full=True), timed="spf_distances_masked")

    # prefix churn: the two late nodes' loopbacks, one withdrawal
    changed = set()
    for i in (len(nodes) - 2, len(nodes) - 1):
        changed |= ps.update_prefix(nodes[i], "0", loopback(i))
    gone = int(rng.integers(1, len(nodes) - 2))
    changed |= ps.delete_prefix(nodes[gone], "0", loopback(gone).prefix)
    before = kernel_be.num_incremental_builds
    walls["g: KSP2 prefix churn"] = drive_ksp2(
        report, kernel_be, plain_be, areas, ps, "ksp2:churn", rng,
        {SELECT, "spf_distances_masked"}, [2], hints=dict(changed_prefixes=changed),
        timed="spf_distances_masked, churn")
    check(kernel_be.num_incremental_builds == before + 1, "the churn tick did not patch")

    # warm_delta: one backbone link (not core0's) weakened both ways: the
    # warm kernels (4 and 5, or the bounded repair 6, as the planner
    # decides); KSP2 prefixes are live, so the warm-selective branch
    # declines and every row is selected and decoded again
    core = sorted((l.n1, l.n2) for l in enc.topos[0].links
                  if l.n1.startswith("core") and l.n2.startswith("core") and "core0" not in (l.n1, l.n2))
    a, b = core[int(rng.integers(len(core)))]
    metric = next(x.metric for x in dbs[a].adjacencies if x.other_node_name == b)
    for copy in areas.values():
        set_metric(copy, dbs, a, b, metric + 5)
        set_metric(copy, dbs, b, a, metric + 5)
    before = (kernel_be.num_warm_builds, kernel_be.num_warm_subgraph_builds,
              kernel_be.num_warm_selective_builds)

    def warm_expect(be):
        sub = be.num_warm_subgraph_builds > before[1]
        warm = {"warm_subgraph_repair"} if sub else {"warm_spf_distances", "spf_nexthop_lanes_reset"}
        return warm | {SELECT, "spf_distances_masked"}

    walls["g: KSP2 warm_delta weakening"] = drive_ksp2(
        report, kernel_be, plain_be, areas, ps, f"ksp2:weaken:{a}-{b}", rng, warm_expect,
        [dests + 1], hints=dict(changed_prefixes=set(), force_full=True, warm_delta=True),
        timed="spf_distances_masked, weakening")
    check(kernel_be.num_warm_builds == before[0] + 1, "the weakening did not solve warm")
    check(kernel_be.num_warm_selective_builds == before[2], "the warm-selective branch ran")

    # the device-build what-if over a seeded sample of the loopbacks, on
    # seeded backbone links of their destinations' first paths (so the
    # failures move routes)
    wps = PrefixState()
    owners = {p: next(iter(e)) for p, e in ps.prefixes().items()}
    held = sorted(owners)
    on_paths = []
    for i in rng.choice(len(held), KSP2_WHATIF_PREFIXES, replace=False):
        node, area = owners[held[i]]
        wps.update_prefix(node, area, ps.prefixes()[held[i]][(node, area)])
        for path in areas["kernel"]["0"].get_kth_paths("core0", node, 1)[:1]:
            on_paths += [(l.n1, l.n2) for l in path if (l.n1, l.n2) in core and (l.n1, l.n2) not in on_paths]
    check(on_paths, "no backbone link on the sampled destinations' first paths")
    links = [on_paths[i] for i in rng.choice(
        len(on_paths), min(KSP2_WHATIF_LINKS, len(on_paths)), replace=False)]
    eng = whatif_api.DeviceBuildWhatIfEngine(SpfSolver("core0"))
    eng._backend = CudaBackend(eng.solver, resilience=NO_GOVERNOR)
    watch(eng._backend)
    got, rec, walls["g: device-build what-if"] = whatif_run(
        report, "ksp2:whatif", KSP2_COLD, lambda: eng.run(links, areas["kernel"], wps, 1),
        entries=KSP2_ENTRIES + SELECT_ENTRIES)
    report.tick = "ksp2:whatif"
    report.select_shapes([args for args, _kw, _outs in rec.calls[SELECT]])
    generic = whatif_api.GenericSolverWhatIfEngine(SpfSolver("core0"))
    want = generic.run(links, areas["oracle"], wps, 1)
    check(got["failures"] == want["failures"], "device-build answers != GenericSolverWhatIfEngine")
    moved = [f["routes_changed"] for f in got["failures"]]
    check(any(moved), "the what-if's failures moved no route")
    print(f"[ksp2:whatif] {len(links)} backbone links, {KSP2_WHATIF_PREFIXES} KSP2 prefixes: "
          f"routes changed {moved}; {eng.num_builds} device builds == GenericSolverWhatIfEngine",
          flush=True)
    return walls, enc


def fattree_world():
    """The fattree_multipod class at FATTREE_SCALE: one SHORTEST_DISTANCE
    /24 per rack, LinkState with vantage rsw0_0."""
    dbs = build_adj_dbs(_build_fattree(FATTREE_SCALE, 0))
    ls = LinkState("0", "rsw0_0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    nodes = sorted(dbs)
    ps = PrefixState()
    for i, node in enumerate(n for n in nodes if n.startswith("rsw")):
        ps.update_prefix(node, "0", PrefixEntry(f"10.{(i >> 8) & 255}.{i & 255}.0/24"))
    return {"0": ls}, ps, nodes


def c4_phase(report, rng, backbone_enc):
    """(h) the shapes whose block state exceeds shared memory: the fleet
    on the fat-tree (kernels 12 and 13), ``CudaBackend`` on
    the hub world at HUB_LEAVES_LARGE leaves (kernel 14's frontier form at
    one row), kernel 14 at SEGMENT_ROWS rows with failed sets on the (g)
    world."""
    walls = {}
    large = dict(launches=LARGE_LAUNCHES, spans=LARGE_SPANS)
    areas, ps, nodes = fattree_world()
    enc = csr.encode_multi_area(areas, "rsw0_0")
    V, K = enc.overloaded.shape[1], enc.in_src.shape[2]
    check(spf.fleet_dense_state_bytes(V, K) > spf.MAX_SHARED_BYTES,
          "the fat-tree's kernel-12 block state fits shared memory")
    print(f"[c4] fat-tree: {len(nodes)} nodes, V={V}, K={K}, D="
          f"{csr.bucket_for(enc.max_out_degree(), DEGREE_BUCKETS)}, {len(ps.prefixes())} prefixes; "
          f"kernel 12 per-pair state up to {spf.fleet_dense_state_bytes(V, K)} B, of it the "
          f"frontier state {spf.frontier_state_bytes(V, min(V, spf.FRONTIER_CAP), spf.FLEET_THREADS)}"
          f" B", flush=True)
    eng = FleetRibEngine(SpfSolver("rsw0_0"))
    check(eng.eligible(areas, ps, 1), "the fat-tree is not eligible")
    summary, rec, walls["h: fat-tree fleet solve"] = whatif_run(
        report, "fleet:fattree", DENSE_FLEET, lambda: eng.fleet_summary(areas, ps, 1),
        entries=FLEET_ENTRIES)
    call = max(rec.calls["fleet_spf_dense"], key=lambda c: c[0][6].shape[0])
    time_fleet(report, "fleet_spf_dense", call, key="fleet_spf_dense, fat-tree",
               **large)
    picks = [nodes[i] for i in rng.choice(len(nodes), FATTREE_ORACLE_SAMPLE, replace=False)]
    hold_every_root(eng, areas, ps, 1, picks, summary, "fleet:fattree")
    with Recorder(plain=True, entries=FLEET_ENTRIES):
        reset_launch_counts()
        check(FleetRibEngine(SpfSolver("rsw0_0")).fleet_summary(areas, ps, 1) == summary,
              "fat-tree fleet summary != plain path")
        check(not any(LAUNCHES.values()), "the plain path launched a kernel")
    print(f"[fleet:fattree] {len(summary)} roots: {len(picks)} == scalar oracle, summary == "
          f"plain path", flush=True)

    hub_edges = [("hub", f"leaf{i}", 1) for i in range(HUB_LEAVES_LARGE)]
    hub = LinkState("0", "hub")
    for db in build_adj_dbs(hub_edges).values():
        hub.update_adjacency_database(db)
    hub_ps = PrefixState()
    for i in range(64):
        hub_ps.update_prefix(f"leaf{i}", "0", PrefixEntry(f"10.3.{i}.0/24"))
    hub_enc = csr.encode_multi_area({"0": hub}, "hub")
    V, E = hub_enc.overloaded.shape[1], hub_enc.src.shape[1]
    hub_layout = spf.segment_batch_layout(1, V, E, 0, "cuda")
    check(not hub_enc.has_dense and hub_layout[1] != 0,
          "the large hub's kernel-14 state fits shared memory")
    print(f"[c4] hub: {HUB_LEAVES_LARGE} leaves, V={V}, E={E}; kernel 14 threads, layout, "
          f"shared and scratch bytes {hub_layout[:2] + hub_layout[3:]}", flush=True)
    kernel_be = KernelPath(SpfSolver("hub"))
    t0 = time.perf_counter()
    drive(report, kernel_be, PlainPath(SpfSolver("hub")), SpfSolver("hub"), {"0": hub}, hub_ps,
          "backend:hub-large", rng=rng, sample=None, expect={"spf_segment_batch", SELECT})
    walls["h: hub backend build (checks included)"] = (time.perf_counter() - t0) * 1e3
    args, out = kernel_be.io["segment"]
    src, dst, w, ok, ovl, roots, D = args
    time_fleet(report, "spf_segment_batch", (args[:5] + (roots[None], D), {}, out),
               key="spf_segment_batch, hub row", **large)

    # kernel 14 on the (g) world's segment arrays, SEGMENT_ROWS rows of
    # 1-3-link failed sets
    topo = backbone_enc.topos[0]
    seg = tables_from_numpy([getattr(backbone_enc, k) for k in
                             ("src", "dst", "w", "edge_ok", "overloaded")], "cuda")
    D = csr.bucket_for(max(backbone_enc.max_out_degree(), 1), DEGREE_BUCKETS)
    B, S = SEGMENT_ROWS, 3
    fl = np.full((B, S), -1, np.int32)
    for r in range(B):
        k = 1 + r % 3
        fl[r, :k] = rng.choice(len(topo.links), k, replace=False)
    picks = rng.choice(topo.num_nodes, B, replace=False).astype(np.int32)
    roots, li, fa, fl = tables_from_numpy(
        (picks[:, None], topo.link_index[None], np.where(fl >= 0, 0, -1).astype(np.int32), fl),
        "cuda")
    kw = dict(link_index=li, fail_area=fa, fail_link=fl)
    with Recorder(entries=FLEET_ENTRIES) as rec:
        reset_launch_counts()
        spf.spf_segment_batch(*seg, roots, D, **kw)
        torch.cuda.synchronize()
        check(LAUNCHES["spf_segment_batch"] == 1, "kernel 14 did not launch on the (g) rows")
        report.launches["spf_segment_batch"] += 1
    hold_recorded(report, rec)
    time_fleet(report, "spf_segment_batch", rec.calls["spf_segment_batch"][0],
               key="spf_segment_batch, (g) rows", **large)
    print(f"[c4] kernel 14 at {B} rows with 1-3-link failed sets on the backbone (V="
          f"{backbone_enc.overloaded.shape[1]}, E={backbone_enc.src.shape[1]}) == plain", flush=True)
    return walls


# ---------------------------------------------------------------------------
# (i) the flagship step: kernels 16 and 17
# ---------------------------------------------------------------------------

FLAGSHIP_ENTRIES = (
    (rs, "batched_spf", "batched_spf", spf.batched_spf_plain),
    (rs, "batched_select_routes", "batched_select_routes", rs.batched_select_routes_plain),
)
PLAIN_OF["batched_spf"] = spf.batched_spf_plain
PLAIN_OF["batched_select_routes"] = rs.batched_select_routes_plain
FLAGSHIP = {"batched_spf", "batched_select_routes"}


def flagship_world(rng):
    """The headline world (bench.py:106) with a loopback per node and
    FLAGSHIP_ANYCAST anycast /24s of FLAGSHIP_CANDIDATES advertisers each,
    mixed path and source preferences and drain metrics, every 8th with a
    min-nexthop of 2.  Returns (edges, LinkState, encoding, candidates)."""
    edges = random_connected_edges(WHATIF_NODES, 2 * WHATIF_NODES, seed=7)
    ls, ps, topo = headline_world()
    names = topo.id_to_node
    for k in range(FLAGSHIP_ANYCAST):
        for node in rng.choice(names, FLAGSHIP_CANDIDATES, replace=False):
            metrics = PrefixMetrics(
                drain_metric=int(rng.random() < 0.25),
                path_preference=int(rng.choice([100, 200])),
                source_preference=int(rng.choice([0, 50])),
                distance=int(rng.integers(0, 2)),
            )
            ps.update_prefix(str(node), "0", PrefixEntry(
                f"10.250.{k}.0/24", metrics=metrics, min_nexthop=2 if k % 8 == 0 else None))
    cands = csr.encode_prefix_candidates(ps, topo, "0", max_candidates=FLAGSHIP_CANDIDATES)
    return edges, ls, topo, cands


def flagship_rows(topo):
    """Rows 0..L-1 fail link b from node0 with the base drains; row b >= L
    fails link 7b mod L, hard-drains node 13b mod V, soft-drains node
    29b mod V by 60 and roots at node b mod V (node ids).  Returns
    (failed [B], overloaded [B, V], soft [B, V], roots [B])."""
    L, n = len(topo.links), topo.num_nodes
    b = np.arange(FLAGSHIP_ROWS)
    tail = b >= L
    failed = np.where(tail, (7 * b) % L, b).astype(np.int32)
    ovl = np.tile(topo.overloaded, (FLAGSHIP_ROWS, 1))
    ovl[b[tail], (13 * b[tail]) % n] = True
    soft = np.tile(topo.soft, (FLAGSHIP_ROWS, 1))
    soft[b[tail], (29 * b[tail]) % n] += 60
    roots = np.where(tail, b % n, topo.node_id("node0")).astype(np.int32)
    return failed, ovl, soft, roots


def oracle_routes(ls, topo, cands, root, link, ovl_row, soft_row, cache):
    """Each prefix's (valid, metric or None, first-hop set) from the scalar
    oracle: every advertiser's (metric, first hops) by
    ``graft_entry.scalar_route_oracle`` on ``ls`` (the row's hard drain set
    on it) with ``link`` removed, then the selection chain in plain Python
    (reach, hard-drain filter with fallback, not drained, path and source
    preference, least distance, skip-if-self, the least-metric winners'
    first hops, the min-nexthop gate)."""
    root_name = topo.id_to_node[root]
    out = []
    for p in range(cands.cand_node.shape[0]):
        ans = {}
        for c in np.nonzero(cands.cand_ok[p])[0]:
            node = topo.id_to_node[cands.cand_node[p, c]]
            ans[c] = graft_entry.scalar_route_oracle(ls, topo, root_name, link, node, cache)
        reach = [c for c in ans if ans[c][0] is not None]
        use = [c for c in reach if not ovl_row[cands.cand_node[p, c]]] or reach

        def keep(keys, best):
            vals = [keys(c) for c in use]
            return [c for c in use if keys(c) == best(vals)] if vals else []

        node_of = lambda c: cands.cand_node[p, c]  # noqa: E731
        use = keep(lambda c: int(not (cands.drain_metric[p, c] > 0 or soft_row[node_of(c)] > 0)),
                   max)
        use = keep(lambda c: cands.path_pref[p, c], max)
        use = keep(lambda c: cands.source_pref[p, c], max)
        use = keep(lambda c: cands.distance[p, c], min)
        if not use:
            out.append((False, None, set()))
            continue
        best = min(ans[c][0] for c in use)
        hops = set().union(*(ans[c][1] for c in use if ans[c][0] == best))
        req = max(int(cands.min_nexthop[p, c]) for c in use)
        self_wins = any(node_of(c) == root for c in use)
        out.append((not self_wins and len(hops) > 0 and len(hops) >= req, best, hops))
    return out


def hold_flagship_oracle(rng, edges, ls, topo, cands, rows, outs):
    """FLAGSHIP_ORACLE_ROWS seeded rows, half from each half of the batch,
    every prefix against :func:`oracle_routes`: validity, metric (where any
    advertiser is selected) and the first-hop set of valid routes."""
    failed, ovl, soft, roots = rows
    valid, metric, lanes = (t.cpu().numpy() for t in outs[:3])
    L = len(topo.links)
    half = FLAGSHIP_ORACLE_ROWS // 2
    picks = sorted(rng.choice(L, half, replace=False).tolist()
                   + (L + rng.choice(FLAGSHIP_ROWS - L, half, replace=False)).tolist())
    checked = 0
    for b in picks:
        drained = [topo.id_to_node[v] for v in np.nonzero(ovl[b] & ~topo.overloaded)[0]]
        row_ls = ls
        if drained:
            row_ls = LinkState("0")
            for db in build_adj_dbs(edges, overloaded=drained).values():
                row_ls.update_adjacency_database(db)
        link = topo.links[failed[b]]
        want = oracle_routes(row_ls, topo, cands, int(roots[b]), link, ovl[b], soft[b], {})
        out_edges = topo.root_out_edges(topo.id_to_node[roots[b]])
        for p, (ok, best, hops) in enumerate(want):
            check(bool(valid[b, p]) == ok, f"flagship row {b} prefix {p}: valid != oracle")
            check(metric[b, p] == (BIG if best is None else best),
                  f"flagship row {b} prefix {p}: metric {metric[b, p]} != oracle {best}")
            if ok:
                got = {out_edges[r][1] for r in np.nonzero(lanes[b, p] > 0)[0]}
                check(got == hops, f"flagship row {b} prefix {p}: first hops {got} != {hops}")
            checked += 1
    return picks, checked


def time_flagship(report, rec, mask, rows_d):
    """Time kernels 16 and 17 on the main run's inputs, with their
    bounds: inputs read and outputs written once; kernel 16 one
    relaxation per usable edge per row (an add and a min, then a max per
    live lane), kernel 17 the chain's operations per row."""
    (args, _kw, (dist, nh)), = rec.calls["batched_spf"]
    src, dst, w, ok, _mask, ovl, roots, D = args
    B = roots.shape[0]
    usable = lanes = 0
    for r0, r1 in spf._row_chunks(B, src.shape[0]):
        u, ln = segment_relaxations(src.expand(r1 - r0, -1), ok[None] & mask[r0:r1], ovl[r0:r1],
                                    roots[r0:r1], D)
        usable += int(u.sum())
        lanes += int((u * ln).sum())
    t_bytes = nbytes(src, dst, w, ok, mask, ovl, roots, dist, nh)
    launch, _ = spf.batched_spf_launcher(src, dst, w, ok, ovl, roots, D, edge_enabled=mask)
    report.time("batched_spf", launch, lambda: spf.batched_spf_plain(*args), t_bytes,
                2 * usable + lanes, nbytes(src, w, ok), 1, launches=20, plain_spans=2)
    report.per_call[f"batched_spf, spf.batched_spf at {B} rows"] = per_launch_ms(
        lambda: spf.batched_spf(*args), launches=20)
    (args, _kw, outs), = rec.calls["batched_select_routes"]
    time_batched_select(report, args, outs)
    print(f"[flagship] kernel 16 rows: {usable / B:.1f} usable edges per row", flush=True)
    for name in ("batched_spf", "batched_select_routes"):
        t = report.timing[name]
        bound, by = report.bound_ms(name)
        print(f"[flagship] {name}: {t['ms']:.4f} ms per launch (host issue "
              f"{t['host_issue_ms']:.4f}), plain {t['plain_ms']:.2f} ms, bound {bound:.5f} ms "
              f"({by})", flush=True)


def time_batched_select(report, args, outs, key=None):
    """Time kernel 17 on one recorded call (under ``key``, default its
    name), with its bound: inputs read and outputs written once, the
    chain's operations per row."""
    B, D = args[8].shape[0], args[8].shape[-1]
    P, C = args[0].shape
    launch, _ = rs.batched_select_routes_launcher(*args)
    t_bytes = nbytes(*args, *outs)
    report.time("batched_select_routes", launch, lambda: rs.batched_select_routes_plain(*args),
                t_bytes, B * select_ops(P, C, 1, D), t_bytes, 1, key=key, plain_spans=2)


def flagship_phase(report, rng):
    """(i) the flagship step, ``spf_and_select`` (kernel 16 then kernel 17),
    on the headline world at FLAGSHIP_ROWS rows; rows 0..L-1 against the
    cold sweep kernel (kernel 8) from node0; seeded rows against the scalar
    oracle; ``batched_spf_distinct`` on DISTINCT_WANS WANs of the same class;
    ``graft_entry.entry()`` at the reference's own shape.  Every kernel
    16/17 call is held against its plain version."""
    walls = {}
    dev = torch.device("cuda", 0)
    edges, ls, topo, cands = flagship_world(rng)
    rows = failed, ovl, soft, roots = flagship_rows(topo)
    D = topo.max_out_degree()
    mask = csr.link_failure_batch(topo, [[int(f)] for f in failed])
    P, C = cands.cand_node.shape
    print(f"[flagship] world: V={topo.padded_nodes}, {len(topo.links)} links, "
          f"E={topo.padded_edges} ({topo.num_edges} real), D={D}, B={FLAGSHIP_ROWS}, P={P}, "
          f"C={C}; mask {mask.nbytes / 1e6:.1f} MB", flush=True)
    arrays = [topo.src, topo.dst, topo.w, topo.edge_ok, mask, ovl, soft, roots,
              cands.cand_node, cands.cand_ok, cands.drain_metric, cands.path_pref,
              cands.source_pref, cands.distance, cands.min_nexthop]
    args = tables_from_numpy(arrays, dev)
    outs, rec, walls["i: flagship step"] = whatif_run(
        report, "flagship", FLAGSHIP, lambda: rs.spf_and_select(*args, max_degree=D),
        entries=FLAGSHIP_ENTRIES)
    valid = outs[0]
    print(f"[flagship] kernels 16 and 17 == plain; {int(valid.sum())} of {valid.numel()} routes "
          f"valid", flush=True)

    # rows 0..L-1 against the cold sweep kernel's tables from node0
    (_a, _k, (dist, nh)), = rec.calls["batched_spf"]
    L = len(topo.links)
    src, dst, w, ok, li, ovl0 = tables_from_numpy(
        [topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index, topo.overloaded], dev)
    (fails_t,) = tables_from_numpy([failed[:L]], dev)
    cross_args = (src, dst, w, ok, li, fails_t, ovl0, topo.node_id("node0"), D)
    d8, nh8, _, _ = spf.sweep_spf_link_failures(*cross_args)
    check(torch.equal(dist[:L], d8.t()) and torch.equal(nh[:L], nh8.permute(1, 0, 2)),
          "flagship rows != the cold sweep kernel's tables")
    print(f"[flagship] rows 0..{L - 1} == kernel 8 (sweep_spf_link_failures) from node0, "
          f"transposed", flush=True)
    time_sweep(report, f"sweep_spf_link_failures at the flagship cross-check ({L} failures)",
               "the flagship cross-check", cross_args)

    t0 = time.perf_counter()
    picks, checked = hold_flagship_oracle(rng, edges, ls, topo, cands, rows, outs)
    print(f"[flagship] {len(picks)} rows x {P} prefixes ({checked}) == scalar oracle "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    time_flagship(report, rec, args[4], rows)

    # batched_spf_distinct on WANs of the same class, one per row
    topos = []
    for seed in range(7, 7 + DISTINCT_WANS):
        row_ls = LinkState("0")
        for db in build_adj_dbs(random_connected_edges(WHATIF_NODES, 2 * WHATIF_NODES,
                                                       seed=seed)).values():
            row_ls.update_adjacency_database(db)
        topos.append(csr.encode_link_state(row_ls, node_bucket=topo.padded_nodes,
                                           edge_bucket=topo.padded_edges))
    n = len(topos)
    stack = [np.stack([getattr(t, f) for t in topos]) for f in ("src", "dst", "w", "edge_ok")]
    d_ovl = np.stack([t.overloaded for t in topos])
    d_ovl[np.arange(n), (13 * np.arange(n)) % topo.num_nodes] = True
    d_roots = (np.arange(n) % topo.num_nodes).astype(np.int32)
    d_max = max(t.max_out_degree() for t in topos)
    d_args = tables_from_numpy(stack + [d_ovl, d_roots], dev)
    reset_launch_counts()
    got = spf.batched_spf_distinct(*d_args, d_max)
    torch.cuda.synchronize()
    check({k for k, v in LAUNCHES.items() if v} == {"batched_spf"}, "distinct: not kernel 16 alone")
    report.launches["batched_spf"] += LAUNCHES["batched_spf"]
    report.held("batched_spf", list(zip(got, spf.batched_spf_distinct_plain(*d_args, d_max))))
    print(f"[flagship] batched_spf_distinct on {n} WANs (seeds 7..{6 + n}, "
          f"{min(t.num_edges for t in topos)}-{max(t.num_edges for t in topos)} real edges of "
          f"E={topo.padded_edges}, D={d_max}) == plain", flush=True)

    # the entry point at the reference's own shape
    forward, e_args = graft_entry.entry()
    e_outs, e_rec, walls["i: entry()"] = whatif_run(
        report, "flagship:entry", FLAGSHIP, lambda: forward(*e_args), entries=FLAGSHIP_ENTRIES)
    (s_args, _kw, s_outs), = e_rec.calls["batched_select_routes"]
    key = f"batched_select_routes at entry() (B = {s_args[8].shape[0]})"
    time_batched_select(report, s_args, s_outs, key=key)
    report.timing[key]["launches"] = 1
    cpu_forward, cpu_args = graft_entry.entry(device="cpu")
    check(all(torch.equal(g.cpu(), c) for g, c in zip(e_outs, cpu_forward(*cpu_args))),
          "entry() on the card != entry(device='cpu')")
    print("[flagship:entry] graft_entry.entry() == its CPU forward", flush=True)
    return walls


def hold_gathers(report):
    """Hold every call of kernel 18 that the main path makes, through the
    names its callers (the backend's delta build, the fleet's changed
    roots) call it by, against its plain version on the same rows as it
    returns; keep each call's arguments for :meth:`KernelReport.time_gathers`.
    The plain path's builds gather by the plain version."""
    def held(*args, _fn=rs.gather_selection_rows):
        if report.plain_path:
            return rs.gather_selection_rows_plain(*args)
        outs = _fn(*args)
        report.held(GATHER, list(zip(outs, rs.gather_selection_rows_plain(*args))))
        report.gather_calls.append((report.tick, args))
        return outs

    backend_mod.gather_selection_rows = held
    fleet_mod.gather_selection_rows = held


# ---------------------------------------------------------------------------
# the admission path: health governor, breaker, counted scalar builds
# ---------------------------------------------------------------------------

#: the admission phase's governor: 1 device build in 8 shadow-verified (the
#: first always), the breaker open after 2 counted failures, no jitter
ADMISSION = dict(shadow_sample_every=8, failure_threshold=2, jitter_pct=0.0)


def admission_step(report, label, expect, build):
    """One request through ``build``: launch counts reset just before and
    read just after, the launched set held to ``expect`` (drive's rule).
    Returns (result, wall ms)."""
    report.tick = label
    reset_launch_counts()
    t0 = time.perf_counter()
    out = build()
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(LAUNCHES)
    launched = {name for name, n in counts.items() if n}
    check(launched == set(expect), f"{label}: launched {sorted(launched)}, expected {sorted(expect)}")
    for name in KERNEL_NAMES:
        report.launches[name] += counts[name]
    print(f"[{label}] wall={wall:.1f}ms launches={ {k: v for k, v in counts.items() if v} }",
          flush=True)
    return out, wall


def timed_shadow_checks(gov):
    """Record the wall (ms) of each shadow check's scalar build."""
    walls = []
    scalar_db = gov._scalar_db

    def timed(*args):
        t0 = time.perf_counter()
        out = scalar_db(*args)
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    gov._scalar_db = timed
    return walls


def governed(me, clock, **solver_kw):
    be = KernelPath(SpfSolver(me, **solver_kw), clock=clock,
                    resilience=ResilienceConfig(**ADMISSION))
    return be, timed_shadow_checks(be.governor)


def admission_corruption_steps(report, be, clock, areas, ps, want, label):
    """(b) injected corruption: the kernels launch, the shadow check finds
    the mismatch, the backend is quarantined and serves the scalar RouteDb;
    (c) one quarantined build: no launch, a counted injected fallback; (d)
    healed, past the hold, a probe: the cold kernels, verified, restored."""
    gov = be.governor
    full = COLD | {SELECT}
    be.inject_silent_corruption(True)
    db, _ = admission_step(report, f"{label}:b corruption", full,
                           lambda: be.build_route_db(areas, ps, force_full=True))
    report.kernel_checks(be, False)
    check(gov.num_shadow_mismatches == 1 and be.device_failed and gov.num_quarantines == 1,
          f"{label} (b): the corruption was not found and quarantined: {gov.status()}")
    check(route_db_summary(db) == want, f"{label} (b): the served RouteDb != (a)'s")
    before = counters(be)
    db, c_wall = admission_step(report, f"{label}:c quarantined", set(),
                                lambda: be.build_route_db(areas, ps))
    check(be.num_fallback_injected == before["num_fallback_injected"] + 1
          and be.num_scalar_builds == before["num_scalar_builds"] + 1,
          f"{label} (c): the quarantined build was not a counted scalar build")
    check(route_db_summary(db) == want, f"{label} (c): RouteDb != (a)'s")
    be.inject_silent_corruption(False)
    clock._now += gov.breaker.current_hold_s() + 0.5
    db, _ = admission_step(report, f"{label}:d probe", full,
                           lambda: be.build_route_db(areas, ps, force_full=True))
    report.kernel_checks(be, False)
    check(not be.device_failed and gov.num_restores == 1 and gov.last_probe.get("passed"),
          f"{label} (d): the probe did not restore the device: {gov.status()}")
    check(route_db_summary(db) == want, f"{label} (d): RouteDb != (a)'s")
    return c_wall


def raising_launcher(*args, **kwargs):
    raise build.KernelError("multi_area_select_from_tables: injected launch failure")


def admission_phase(report, smi, cold_db):
    """19. The admission path, under a governor on a SimClock: on the grid
    (a) a shadow-verified cold build and (e) a kernel error that propagates
    uncounted; on the 3-area world, where a full scalar build costs far
    less than the grid's, (b) injected corruption found and quarantined,
    (c) a quarantined build, (d) a probe that restores; on the 3-area
    world also the counted scalar builds (disabled
    selection, an empty area map, the small-build cutover, a 65-candidate
    prefix) and the breaker opened by dispatch failures; the auto
    cutover's measured round trip and choice.  Returns the walls (ms),
    each shadow check's scalar build among them."""
    walls = {}
    t_phase = time.perf_counter()
    full = COLD | {SELECT}
    _dbs, areas, ps = grid_world()
    clock = SimClock()
    be, checks = governed("node0", clock)
    gov = be.governor
    db, _ = admission_step(report, "admission:a cold", full, lambda: be.build_route_db(areas, ps))
    report.kernel_checks(be, False)
    want = route_db_summary(db)
    check(want == route_db_summary(cold_db), "admission (a): RouteDb != phase 1's cold build")
    check(gov.num_shadow_checks == 1 and gov.num_shadow_mismatches == 0,
          f"admission (a): the cold build was not verified clean: {gov.status()}")
    check(not any(v for k, v in counters(be).items() if k != "num_device_builds"),
          f"admission (a): scalar builds counted: {counters(be)}")
    print(f"[admission:a cold] shadow-verified (check's scalar build {checks[-1]:.1f} ms); "
          f"RouteDb == phase 1's cold build", flush=True)

    a3, ps3, me3 = three_area_world()
    oracle3 = SpfSolver(me3).build_route_db(a3, ps3)
    clock3 = SimClock()
    be3, checks3 = governed(me3, clock3)
    db3, _ = admission_step(report, "admission:3-area a", full,
                            lambda: be3.build_route_db(a3, ps3))
    report.kernel_checks(be3, False)
    c_wall = admission_corruption_steps(report, be3, clock3, a3, ps3,
                                        route_db_summary(db3), "admission:3-area")
    checks += checks3
    print(f"[admission] steps b-d on the 3-area world: "
          f"corruption found and quarantined, the quarantined build scalar "
          f"({c_wall:.1f} ms), the probe restored; RouteDbs == (a)'s", flush=True)

    # (e) a kernel error, and the launcher's own refusal of a dtype,
    # propagate uncounted
    launcher = rs.multi_area_select_from_tables_launcher

    def wrong_dtype(*args):  # soft as int64: check_tensor refuses it
        return launcher(*args[:3], args[3].long(), *args[4:])

    raised = []
    for injected, error in ((raising_launcher, build.KernelError), (wrong_dtype, TypeError)):
        before = counters(be)
        breaker = gov.breaker.status()
        rs.multi_area_select_from_tables_launcher = injected
        reset_launch_counts()
        try:
            be.build_route_db(areas, ps, force_full=True)
        except error as e:
            raised.append(type(e).__name__)
        finally:
            rs.multi_area_select_from_tables_launcher = launcher
        check(len(raised) and raised[-1] == error.__name__,
              f"admission (e): the {error.__name__} did not propagate")
        check(not any(LAUNCHES.values()), f"admission (e): launched {dict(LAUNCHES)}")
        check(counters(be) == before and gov.breaker.status() == breaker
              and not be.device_failed,
              f"admission (e): the {error.__name__} was counted: {counters(be)} {gov.status()}")
    db, _ = admission_step(report, "admission:e next build", {SELECT},
                           lambda: be.build_route_db(areas, ps, force_full=True))
    report.kernel_checks(be, False)
    check(route_db_summary(db) == want, "admission (e): the next build != (a)'s")
    print(f"[admission:e] {' and '.join(raised)} propagated; counters, breaker and latch "
          f"unchanged; the next build == (a)'s", flush=True)
    steps_ms = (time.perf_counter() - t_phase) * 1e3

    # the counted scalar builds, with no launch
    r3 = route_db_summary(oracle3)
    disabled, _ = governed(me3, SimClock(), enable_best_route_selection=False)
    oracle_off = SpfSolver(me3, enable_best_route_selection=False).build_route_db(a3, ps3)
    line = [(f"node{i}", f"node{i + 1}", 1) for i in range(65)]
    line_ls = LinkState("1", "node0")
    for adj_db in build_adj_dbs(line, area="1").values():
        line_ls.update_adjacency_database(adj_db)
    line_ps = PrefixState()
    for i in range(1, 66):
        line_ps.update_prefix(f"node{i}", "1", PrefixEntry("10.0.0.0/24"))
    line_be, _ = governed("node0", SimClock())
    small_be = KernelPath(SpfSolver(me3), clock=SimClock(),
                          min_device_prefixes=len(ps3.prefixes()) + 1,
                          resilience=ResilienceConfig(**ADMISSION))
    empty_be, _ = governed(me3, SimClock())
    cases = (
        ("disabled selection", disabled, a3, ps3, oracle_off, "num_scalar_builds"),
        ("empty area map", empty_be, {}, ps3, SpfSolver(me3).build_route_db({}, ps3),
         "num_scalar_builds"),
        ("min_device_prefixes above the count", small_be, a3, ps3, oracle3,
         "num_small_scalar_builds"),
        ("65 candidates", line_be, {"1": line_ls}, line_ps,
         SpfSolver("node0").build_route_db({"1": line_ls}, line_ps), "num_fallback_cand_overflow"),
    )
    for label, case_be, case_areas, case_ps, oracle_db, counter in cases:
        db, _ = admission_step(report, f"admission:{label}", set(),
                               lambda: case_be.build_route_db(case_areas, case_ps))
        got = counters(case_be)
        check(got[counter] == 1 and got["num_device_builds"] == 0
              and got["num_scalar_builds"] + got["num_small_scalar_builds"] == 1,
              f"admission ({label}): not one counted scalar build: {got}")
        same = (db is None and oracle_db is None) or (
            db is not None and oracle_db is not None
            and route_db_summary(db) == route_db_summary(oracle_db))
        check(same, f"admission ({label}): RouteDb != the scalar solver's")
        routes = "None" if db is None else len(db.unicast_routes)
        print(f"[admission:{label}] counted {counter} 1, no launch; routes {routes} == scalar "
              f"solver", flush=True)

    # a RuntimeError twice from the device build opens the breaker
    failing, _ = governed(me3, SimClock())

    def fell_over(*args, **kwargs):
        raise RuntimeError("device build fell over")

    failing._build_device = fell_over
    for i in (1, 2):
        db, _ = admission_step(report, f"admission:dispatch failure {i}", set(),
                               lambda: failing.build_route_db(a3, ps3))
        check(route_db_summary(db) == r3, "admission (dispatch failure): RouteDb != oracle")
    fgov = failing.governor
    check(failing.num_dispatch_errors == 2 and failing.device_failed
          and fgov.breaker.state == STATE_OPEN and fgov.num_quarantines == 1,
          f"admission (dispatch failures): the breaker did not open: {fgov.status()}")
    print(f"[admission:dispatch failures] 2 counted, breaker open "
          f"({fgov.quarantine_reason}); RouteDbs == scalar solver", flush=True)

    # the auto cutover: measured round trip and choice
    ring = LinkState("0", "node0")
    for adj_db in build_adj_dbs([(f"node{i}", f"node{(i + 1) % 6}", 1) for i in range(6)]).values():
        ring.update_adjacency_database(adj_db)
    ring_ps = PrefixState()
    for i in range(6):
        ring_ps.update_prefix(f"node{i}", "0", PrefixEntry(f"10.7.{i}.0/24"))
    for label, w_areas, w_ps, me in (("grid", areas, ps, "node0"), ("3-area", a3, ps3, me3),
                                     ("6-node ring", {"0": ring}, ring_ps, "node0")):
        auto = KernelPath(SpfSolver(me), min_device_prefixes=None)
        device = auto._device_worth_it(w_areas, w_ps)
        work = backend_mod.estimate_scalar_work_items(w_areas, w_ps)
        print(f"[admission:cutover] {label}: dispatch round trip {auto.auto_dispatch_rt_ms:.4f} ms, "
              f"{work} work items: scalar estimate {work * auto.SCALAR_US_PER_ITEM / 1e3:.3f} ms "
              f"vs device {auto.DEVICE_OVERHEAD_TRIPS * auto.auto_dispatch_rt_ms:.4f} ms -> "
              f"{'device' if device else 'scalar'} ({smi})", flush=True)
        if label == "grid":
            continue
        db, _ = admission_step(report, f"admission:cutover {label}", full if device else set(),
                               lambda: auto.build_route_db(w_areas, w_ps))
        report.kernel_checks(auto, False)
        check(auto.num_small_scalar_builds == (0 if device else 1),
              f"admission (cutover {label}): the build did not follow the choice")
        check(route_db_summary(db) == route_db_summary(SpfSolver(me).build_route_db(w_areas, w_ps)),
              f"admission (cutover {label}): RouteDb != scalar solver")
    WATCHED.clear()  # this phase's scalar builds are its checks
    walls["admission: steps a-e"] = steps_ms
    walls["admission: quarantined build (c)"] = c_wall
    for i, ms in enumerate(checks):
        walls[f"admission: shadow check {i + 1}'s scalar build"] = ms
    walls["admission"] = (time.perf_counter() - t_phase) * 1e3
    print(f"[admission] phase wall {walls['admission']:.1f} ms (steps a-e {steps_ms:.1f} ms); "
          f"shadow checks' scalar builds {', '.join(f'{w:.1f}' for w in checks)} ms ({smi})",
          flush=True)
    return walls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s (nvcc, sm_90a)", flush=True)
    for name, log in sorted(build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    dbs, areas, ps = grid_world()
    n = len(dbs)
    print(f"world: grid {GRID_SIDE}x{GRID_SIDE} = {n} nodes, "
          f"{len(ps.prefixes())} prefixes, built in {time.perf_counter() - t0:.1f}s", flush=True)

    report = KernelReport()
    report.smi = smi
    hold_gathers(report)
    kernel_be = KernelPath(SpfSolver("node0"))
    plain_be = PlainPath(SpfSolver("node0"))
    oracle = SpfSolver("node0")
    full = COLD | {SELECT}
    common = dict(rng=rng, sample=200, expect=full)
    cold_db = drive(report, kernel_be, plain_be, oracle, areas, ps, "cold", timed=True, **common)

    # 2. a link metric change in the middle of the grid
    mid = f"node{n // 2 + GRID_SIDE // 2}"
    adj = dbs[mid].adjacencies[0]
    set_metric(areas, dbs, mid, adj.other_node_name, adj.metric + 4)
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"metric:{mid}->{adj.other_node_name}", **common)

    # 3. a hard-drained node next to me
    set_overload(areas, dbs, "node1", True)
    drive(report, kernel_be, plain_be, oracle, areas, ps, "overload:node1", **common)

    # 4. a 3-area world, once per selection algorithm
    three_area = []
    for algo in (
        RouteComputationRules.SHORTEST_DISTANCE,
        RouteComputationRules.PER_AREA_SHORTEST_DISTANCE,
    ):
        a3, ps3, me = three_area_world()
        kb = KernelPath(SpfSolver(me, route_selection_algorithm=algo))
        pb = PlainPath(SpfSolver(me, route_selection_algorithm=algo))
        oracle3 = SpfSolver(me, route_selection_algorithm=algo)
        drive(report, kb, pb, oracle3, a3, ps3, f"3-area:{algo.name}", rng=rng, sample=None,
              expect=full)
        three_area.append((kb, pb, oracle3, a3, ps3, f"3-area:{algo.name}"))
    check_no_fallback("route builds", list(WATCHED))

    # 5-9. the steady-state ticks on the grid, then its membership churn
    steady_state_ticks(report, kernel_be, plain_be, oracle, dbs, areas, ps, rng)
    t0 = time.perf_counter()
    membership_ticks(report, kernel_be, plain_be, oracle, dbs, areas, ps, rng)
    print(f"[member] membership_ticks wall {time.perf_counter() - t0:.1f} s ({report.smi})",
          flush=True)
    # the 3-area world's drain ticks, after the grid's (whose delta shape
    # and gather lead the kernels line), then its membership churn
    for kb, pb, oracle3, a3, ps3, label in three_area:
        drain_ticks(report, kb, pb, oracle3, a3, ps3, rng, label, (("3", "c3"), ("2", "b4")), COLD)
    t0 = time.perf_counter()
    three_area_leaves(report, three_area, rng)
    print(f"[member] three_area_leaves wall {time.perf_counter() - t0:.1f} s ({report.smi})",
          flush=True)
    check_no_fallback("route builds, steady-state and membership ticks")

    # 10-12. the link-failure what-if path
    walls = whatif_phases(report, rng, areas, ps)
    check_no_fallback("what-if")

    # 13-15. the fleet RIB and the multi-area what-if
    walls.update(fleet_phases(report, rng, areas))
    check_no_fallback("fleet and multi-area")

    # 16-17. KSP2 on the backbone; the shapes past the shared-memory bound
    ksp2_walls, backbone_enc = ksp2_phase(report, rng)
    walls.update(ksp2_walls)
    check_no_fallback("ksp2")
    walls.update(c4_phase(report, rng, backbone_enc))
    check_no_fallback("shapes past the shared-memory bound")

    # 18. the flagship step
    walls.update(flagship_phase(report, rng))
    check_no_fallback("flagship")

    # 19. the admission path: governor, breaker, counted scalar builds
    walls.update(admission_phase(report, smi, cold_db))
    report.time_gathers()

    for name in KERNEL_NAMES:
        t = report.timing[name]
        bound_rounds_ms = t["per_round_bytes"] * t["rounds"] / HBM_BYTES_PER_S * 1e3
        queued = f", queued {t['queued_ms']:.4f}" if "queued_ms" in t else ""
        library = f", library {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
        print(f"kernel {name}: {t['ms']:.4f} ms per launch over {TIMED_LAUNCHES} "
              f"back-to-back launches (host issue {t['host_issue_ms']:.4f} ms per launch"
              f"{queued}), "
              f"plain {t['plain_ms']:.4f} ms{library}, launches {report.launches[name]}, "
              f"rounds {t['rounds']}, bytes-per-round x rounds bound {bound_rounds_ms:.5f} ms "
              f"({smi})", flush=True)
    for key, t in report.timing.items():
        if key in KERNEL_NAMES:
            continue
        bound, bound_by = report.bound_ms(key)
        queued = f", queued {t['queued_ms']:.4f}" if "queued_ms" in t else ""
        library = f", library {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
        print(f"kernel {key}: {t['ms']:.4f} ms per launch (host issue {t['host_issue_ms']:.4f}"
              f"{queued}), plain {t['plain_ms']:.4f} ms{library}, bound {bound:.5f} ms "
              f"({bound_by}), rounds {t['rounds']}, launches there {t.get('launches', 'n/a')}, "
              f"shape {t.get('shape', 'n/a')} ({smi})", flush=True)
    for name, keys, first in ((SELECT, report.select_keys, "the grid's cold build shape"),
                              (DELTA, report.delta_keys, "the grid's drain delta shape")):
        shapes = {key: report.timing[key]["launches"] for key in keys.values()}
        check(sum(shapes.values()) == report.launches[name],
              f"{name}'s launches by shape do not sum to its launches")
        print(f"kernel {name} launches by shape: {name} ({first}) {shapes[name]}; "
              + "; ".join(f"{k} {n}" for k, n in shapes.items() if k != name), flush=True)
    check(len(report.gather_calls) == report.launches[GATHER],
          "kernel 18's held calls differ from its launches")
    for key, (dev_ms, host_ms) in report.per_call.items():
        print(f"per call {key}: {dev_ms:.4f} ms (host issue {host_ms:.4f}) ({smi})", flush=True)
    print(f"kernel spf_nexthop_lanes_reset from an all-zero seed (undrain tick's input): "
          f"{report.zero_seed_ms:.4f} ms per launch ({smi})", flush=True)
    t = report.timing["compact_deltas"]
    print(f"library compact_deltas (torch.nonzero of the flat changed mask): "
          f"{t['library_ms']:.4f} ms ({smi})", flush=True)
    print("what-if and fleet walls: " + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items())
          + f" ({smi})", flush=True)
    print(report.json_line(), flush=True)
    print(smi, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
