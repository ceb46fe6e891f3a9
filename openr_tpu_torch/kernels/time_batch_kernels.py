"""Time the batched SPF kernels on one card, to compare two checkouts in one
call (parent, change, change, parent):

  * ``fleet``: kernel 12 (``fleet_spf_dense``; where the checkout has
    ``spf.FLEET_THREADS``, also at 256, 512 and 1,024 threads, its lane
    lists in shared memory or not) and kernel 14
    (``spf_segment_batch``) over the fleet world of ``chip_smoke.py``'s
    phase (d), the reference benchmark's 1,024-node WAN
    (``random_connected_edges(1024, 2048, seed=7)``), every node a root,
    and kernel 12 over the topology of phase (e)'s 3-area world, every
    node a root (-1 in the areas it is absent from); kernels 12 and 14
    at (d) on the path the shape takes and again with
    ``spf.MAX_SHARED_BYTES`` lowered to 0 while the launch is bound (their
    global-state paths; null where the checkout refuses the shape),
    kernel 14 at (d) again and at its first 512 roots, each, where the
    checkout has ``spf.BATCH_THREADS``, at 256, 512 and 1,024 threads
    and, where it has ``spf.SEGMENT_ROUNDS_MAX_NODES``, in each form; and
    kernel 14 at phase (f)'s shape: the multi-area what-if's batch
    (``wan_multi_area_dbs(1024, 7)``, vantage m0_0, every single-link
    failure of areas "0" and metro0 in one call, recorded from
    ``MultiAreaWhatIfEngine.run``), where the checkout has
    ``spf.SEGMENT_ROUNDS_MAX_NODES``, in its frontier form and its round
    form;
  * ``hub``: kernel 14 at one row on phase (h)'s hub of 5,000 leaves
    (V = 16,384, D = 8,192; null where the checkout refuses the shape), at
    each thread count and form as above;
  * ``rows``: kernel 14 at 8 rows of 1-3 failed links each on phase (g)'s
    backbone (the wan_hierarchy class at 8,192 nodes, seed 7: V = 16,384,
    E = 32,768; roots and links drawn with seed 3), at each thread count
    and form as above;
  * ``cold``: kernel 2 (``dense_spf_nexthop_lanes``) at the route build's
    cold shape, the 64 x 64 grid from node0 (V = 4,096, K = 4, D = 4), on
    the distances of its plain version; where the checkout has
    ``spf.DENSE_LANES_THREADS``, at 256, 512 and 1,024 threads;
  * ``masked``: kernel 15 (``spf_distances_masked``), where the checkout
    has it, at phase (g)'s inputs: the wan_hierarchy class at 8,192
    nodes, seed 7, one row per destination of core0, each row's failed
    set the links of its destination's first paths (what the KSP2 engine
    sends): every destination (cold), the last two (churn), and every
    destination again after one backbone link is raised by 5 both ways
    (weakening); where the checkout has ``spf.MASKED_THREADS``, the cold
    rows again at 256, 512 and 1,024 threads per row, with a frontier cap
    of 1,024 and 2,048, and on the global-state path at 128, 256 and 512;
  * ``fattree``: kernel 12 over phase (h)'s fat-tree (the
    fattree_multipod class at 2,048: 2,064 roots, V = 4,096, K = 64),
    on the path the shape takes, with a budget of 0 and, where the
    checkout has ``spf.FLEET_THREADS``, at 256, 512 and 1,024 threads;
  * ``flagship``: kernel 16 (``batched_spf``) at ``chip_smoke.py``'s
    phase (i) inputs (the headline WAN, 4,096 rows of
    ``chip_smoke.flagship_rows``, the per-row mask), per launch, per call
    of ``spf.batched_spf`` and per bind; where the checkout has
    ``spf.batched_spf_layout``, at 128, 256, 512 and 1,024 threads, with a
    shared-memory budget of 0, with the lane lists in the global scratch
    and with a frontier cap of 256 and 512 (at 256 and 512 threads); and
    the step's wall (``spf_and_select``,
    kernels 16 then 17, on ``chip_smoke.flagship_world``'s candidates with
    a generator of seed 0: host clock to a synchronize, median of 5);
  * ``repair``: kernel 9 (``repair_sweep``) at phase (a)'s largest chunk
    (the headline WAN, 10,240 failures drawn with seed 0 through
    ``LinkFailureSweep.run``), per launch, per call of
    ``RepairSweep.solve`` and per bind; where the checkout has
    ``repair.REPAIR_CLUSTER``, at 256, 512 and 1,024 threads by clusters
    of 1, 2, 4 and 8 blocks, and with every vertex listed (the warm-seed
    mode); and the walls of phase (a)'s cold sweep and warm-seeded
    second generation (``LinkFailureSweep.run`` then
    ``SweepRouteSelector.run`` on fresh engines, host clock to a
    synchronize, median of 3);
  * ``dense``: kernel 1 (``dense_spf_distances``) at each shape the run
    gives it: the route build's 64 x 64 grid from node0 ([1, 4,096, 4]),
    the 3-area world of ``chip_smoke.three_area_world`` and the KSP2
    backbone's cold planes (``_build_wan(8192, 7)`` from core0:
    [1, 16,384, 32]), each with its synchronous relaxation rounds, usable
    slots and bound, per launch and per call of
    ``spf.dense_spf_distances``; where the checkout has
    ``spf.DENSE_CLUSTER``, at clusters of 1, 2, 4 and 8 blocks an area
    with the records in shared memory and (a budget of 0) in the global
    scratch, and (where it has ``spf.DENSE_SWEEPS``) at 1-16 rounds
    between votes;
  * ``select``: kernel 13 (``fleet_select``) at each shape the run gives
    it, recorded from the engines on ``chip_smoke``'s worlds: (d) cold and
    the (d) delta (the diff variant, one link raised by 7), (e) the 3-area
    fleet and the hub of 1,025 leaves, (f) the 63-area batch of 203
    failures and the homing set, and (h) the fat-tree fleet; each with its
    B, P, C, A and D and bound, per launch and per call of
    ``rs.fleet_select``; where the checkout has ``rs.SELECT_TILE_ROWS``,
    at tiles of 16-512 rows;
  * ``sweep``: kernel 8 (``sweep_spf_link_failures``) at each shape
    ``chip_smoke.py`` launches it, on the headline WAN (V = 1,024,
    E = 8,192): ``LinkFailureSweep``'s cold base solve (32 unperturbed
    snapshots, D = node0's lanes), the first 1,024 of phase (a)'s failures
    (the repair tables' hold) and the flagship's cross-check (every link
    failed once, 3,071 snapshots, D = 17); each with its synchronous
    rounds and bound, per launch and per call of
    ``spf.sweep_spf_link_failures``; where the checkout has
    ``spf.SWEEP_CLUSTER``, at clusters of 1, 2, 4 and 8 blocks a word with
    the state in shared memory and (a budget of 0) in the global scratch;
  * ``reset``: kernel 5 (``spf_nexthop_lanes_reset``) at the grid's warm
    ticks, recorded from ``chip_smoke.KernelPath`` on the 64 x 64 grid
    (one prefix a node) through the same topology changes as
    ``chip_smoke.py``: the undrain of node1 (its seed the previous lanes),
    the same inputs from an all-zero seed, and the restoring tick; each
    with its synchronous rounds and bound (the kernel does not read its
    seed, so the bound counts no seed bytes), per launch and per call of
    ``spf.spf_nexthop_lanes_reset``; where the checkout has
    ``spf.RESET_LANES_CLUSTER``, at clusters of 1, 2, 4 and 8 blocks an
    area;
  * ``chunkwarm``: kernel 10 (``select_chunk``) at each shape
    ``chip_smoke.py`` launches it, recorded from its engines: (a) the
    headline sweep's chunks and its base at b = 1 (P = 1,024), (b) the
    criticality report's chunks, (c) the grid query's chunks and its base
    at b = 1 (P = 409,600) and the grid's set of 3; and kernel 4
    (``warm_spf_distances``) at the grid's undrain and restoring ticks
    (recorded as for ``reset``) and at phase (g)'s warm weakening of a
    backbone link (V = 16,384, E = 32,768); each with its launches or
    rounds and bound, per launch, per launch queued behind a busy kernel
    (``chip_smoke.queued_ms``: the kernel's own time where the host's issue time
    exceeds it) and per call; kernel 4 also per bind and,
    where the checkout has ``spf.WARM_DIST_CLUSTER``, at clusters of 1, 2,
    4 and 8, and with its records in the global list and its state global.
    The group drives ``chip_smoke.py``'s own helpers and bounds: to time
    an older checkout, copy this file and ``chip_smoke.py`` into it.
  * ``selection``: kernel 17 (``batched_select_routes``) at phase (i)'s
    4,096 flagship rows on kernel 16's tables and at ``entry()``'s batch;
    kernel 3 (``multi_area_select_from_tables``) at every shape
    ``chip_smoke.py`` gives it, recorded through ``chip_smoke.KernelPath``
    (the grid's full build, also at tiles of 32-512 rows, the churn's
    gathered rows, the restore's warm-selective rows, the 3-area world,
    the hubs of (e) and (h), (g)'s KSP2 cold build, churn and device-build
    what-if); kernel
    7 at the grid's drain delta; the flagship step's wall; kernel 10 at
    the (a) and (c) chunks and kernel 13 at its seven shapes; each per
    launch, queued and per call, with its bound (``chip_smoke``'s byte
    counts: kernel 3's on its [1, A, V] view).  It reads the checkout's
    ``chip_smoke.py`` for the worlds.
  * ``repaircompact``: kernel 6 (``warm_subgraph_repair``) at the grid's
    weakening tick (recorded as for ``reset``) and at phase (g)'s backbone
    where a weakening takes the bounded repair (the first of the backbone
    links, drawn with seed 0, whose weakening by 5 the planner sends to
    kernel 6; none read null), and kernel 11 (``compact_deltas``) at every
    call ``chip_smoke.py``'s what-if phases make, recorded from the engines
    as for ``chunkwarm`` ((a), (b), (c) with its overflow re-run, the set
    of 3); each with its shape, rounds or count and bound, per launch back
    to back (the host's issue rate where the launch is shorter), queued
    behind a busy kernel (the device's own time) and per call of the
    entry point, kernel 6 also per bind.
  * ``delta``: kernel 7 (``multi_area_select_delta_from_tables``) at the
    grid's drain delta, at the 3-area world's and the (e) hub's unhinted
    drain ticks (two each, both algorithms on the 3-area world) and at
    kernel 3's nine recorded shapes (kernel 3's outputs as the previous
    generation, one drained node in ``node_changed``); kernel 18
    (``gather_selection_rows``) at each call of those ticks and of the (d)
    fleet's two delta generations, beside ``torch.index_select`` a table;
    kernels 3 and 13 at their recorded shapes: per launch back to back and
    queued, per call, with each shape's bound (kernel 7 also by the
    parent's count, every argument whole).

Run from the root of the checkout to time, naming the groups (default:
all of them)::

    python3 -m openr_tpu_torch.kernels.time_batch_kernels [fleet] [hub] [rows] [cold] [masked] [fattree] [flagship] [repair] [dense] [select] [sweep] [reset] [chunkwarm] [selection] [repaircompact] [delta]

Prints one JSON line: the card's name and power limit, and per kernel and
path the ms per launch (CUDA events around 50 back-to-back launches of a
pre-bound launch, median of 5 spans; 3 launches at the hub row, 5 at
the (g) rows and the fat-tree).  Kernel 14 is also timed per call of
``spf.spf_segment_batch`` (``..., per call``: the launcher's checks,
derived layout and allocations, and the launch, as the main path pays
them; CUDA events as above) and per bind of its launcher (``..., bind
(host)``: host wall per call of the launcher alone, mean of as many
back-to-back binds) at (d), (f), the hub row and the (g) rows.
"""

from __future__ import annotations

import inspect
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.emulation import topology
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import build
from openr_tpu_torch.ops import csr, spf

LAUNCHES = 50
SPANS = 5


def launch_ms(launch, launches: int = LAUNCHES) -> float:
    launch()
    torch.cuda.synchronize()
    spans = []
    for _ in range(SPANS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            launch()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end) / launches)
    return statistics.median(spans)


def link_state(edges, root: str, area: str = "0", **drains) -> LinkState:
    ls = LinkState(area, root)
    for db in topology.build_adj_dbs(edges, area=area, **drains).values():
        ls.update_adjacency_database(db)
    return ls


def fleet_roots(enc) -> np.ndarray:
    """[B, A] int32: every node a root, -1 in the areas it is absent from."""
    names = sorted(set().union(*[set(t.node_ids) for t in enc.topos]))
    return np.asarray([[t.node_ids.get(n, -1) for t in enc.topos] for n in names], np.int32)


def bind_ms(make, binds: int = LAUNCHES) -> float:
    """Host ms per call of ``make()`` (a launcher's bind: its checks,
    derived layout and allocations), mean of ``binds`` back-to-back
    calls after one warm-up."""
    make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(binds):
        make()
    host = (time.perf_counter() - t0) * 1e3 / binds
    torch.cuda.synchronize()
    return host


def timed(make, launches: int = LAUNCHES):
    """ms per launch of the launch ``make()`` binds; None where the
    checkout refuses the shape (a ValueError of its launcher, or a C
    entry that refuses the launch: RuntimeError)."""
    try:
        launch, _ = make()
        launch()
    except (ValueError, RuntimeError):
        return None
    return launch_ms(launch, launches)


def both_paths(make, label: str, out: dict) -> None:
    """Time the launch ``make()`` binds on the path the shape takes, then
    with a shared-memory budget of 0."""
    out[f"{label}, default path"] = timed(make)
    saved = spf.MAX_SHARED_BYTES
    spf.MAX_SHARED_BYTES = 0
    try:
        out[f"{label}, budget 0"] = timed(make)
    finally:
        spf.MAX_SHARED_BYTES = saved


def sweep(make, label: str, knobs: dict, out: dict, launches: int = LAUNCHES, mod=spf) -> None:
    """Where the checkout has every ``<mod>.<knob>`` of ``knobs`` (knob ->
    values: a kernel's threads per block, its frontier cap, a layout
    budget; ``mod`` is ``ops/spf.py`` unless given), time the launch
    ``make()`` binds at each combination."""
    if not all(hasattr(mod, k) for k in knobs):
        return
    saved = {k: getattr(mod, k) for k in knobs}
    try:
        for values in itertools.product(*knobs.values()):
            for k, v in zip(knobs, values):
                setattr(mod, k, v)
            tag = ", ".join(f"{k}={v}" for k, v in zip(knobs, values))
            out[f"{label}, {tag}"] = timed(make, launches)
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def encoded(areas: dict, me: str, dev):
    enc = csr.encode_multi_area(areas, me)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    (roots,) = tables_from_numpy((fleet_roots(enc),), dev)
    return enc, D, roots


def fleet_kernels(dev) -> dict:
    out = {}
    enc, D, r = encoded(
        {"0": link_state(topology.random_connected_edges(1024, 2048, seed=7), "node0")}, "node0", dev
    )
    dense = tables_from_numpy(
        [getattr(enc, k) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded")], dev
    )
    seg = tables_from_numpy([getattr(enc, k) for k in ("src", "dst", "w", "edge_ok", "overloaded")], dev)
    both_paths(lambda: spf.fleet_spf_dense_launcher(*dense, r, D), "fleet_spf_dense (d)", out)
    sweep(lambda: spf.fleet_spf_dense_launcher(*dense, r, D), "fleet_spf_dense (d)",
          {"FLEET_THREADS": (256, 512, 1024), "FLEET_SHARED_ALL_BYTES": (0, spf.MAX_SHARED_BYTES)},
          out)
    both_paths(lambda: spf.spf_segment_batch_launcher(*seg, r, D), "spf_segment_batch (d)", out)
    segment_forms(lambda: spf.spf_segment_batch_launcher(*seg, r, D), "spf_segment_batch (d)", out,
                  call=lambda: spf.spf_segment_batch(*seg, r, D))
    half = r[:512]
    segment_forms(lambda: spf.spf_segment_batch_launcher(*seg, half, D),
                  "spf_segment_batch (d) 512 rows", out)
    # phase (e)'s 3-area world (its prefixes do not reach kernel 12)
    ring = [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
    areas = {
        "1": link_state(topology.grid_edges(4, prefix="a") + [("a0", "me", 1)], "me", "1",
                        overloaded=["a5"]),
        "2": link_state(ring + [("b0", "me", 2), ("b3", "me", 5)], "me", "2",
                        soft_drained={"b2": 40}),
        "3": link_state(topology.random_connected_edges(10, 6, seed=7, prefix="c") + [("c0", "me", 1)],
                        "me", "3"),
    }
    enc, D, r = encoded(areas, "me", dev)
    dense = tables_from_numpy(
        [getattr(enc, k) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded")], dev
    )
    out["fleet_spf_dense (e)"] = timed(lambda: spf.fleet_spf_dense_launcher(*dense, r, D))
    args, kw = multiarea_call(dev)
    out["(f) rows x areas"] = list(args[5].shape)
    segment_forms(lambda: spf.spf_segment_batch_launcher(*args, **kw), "spf_segment_batch (f)", out,
                  call=lambda: spf.spf_segment_batch(*args, **kw), threads=False)
    return out


#: kernel 14's knobs, where the checkout has them: threads per block, and
#: the frontier form or the round form (one block per pair) for every pair
SEGMENT_KNOBS = {"BATCH_THREADS": (256, 512, 1024)}
ROUND_FORM = {"SEGMENT_ROUNDS_MAX_NODES": (0, 1 << 30)}


def segment_forms(make, label: str, out: dict, launches: int = LAUNCHES, call=None,
                  threads: bool = True) -> None:
    """Kernel 14 on the form the shape takes, per call of ``call()`` and
    per bind where ``call`` is given, then (where the checkout has the
    knobs) at each thread count of its frontier form unless ``threads``
    is false (a shape the round form takes ignores them), and in each
    form."""
    out[label] = timed(make, launches)
    if call is not None:
        out[f"{label}, per call"] = launch_ms(call, launches)
        out[f"{label}, bind (host)"] = bind_ms(make, launches)
    if threads:
        sweep(make, label, SEGMENT_KNOBS, out, launches)
    sweep(make, label, ROUND_FORM, out, launches)


def multiarea_call(dev):
    """The (args, kwargs) of phase (f)'s kernel-14 call, recorded from
    ``MultiAreaWhatIfEngine.run`` on the card (the call with the most
    rows)."""
    from openr_tpu_torch.decision import whatif_api
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.ops import fleet_tables
    from openr_tpu_torch.types import PrefixEntry

    area_dbs = topology.wan_multi_area_dbs(1024, 7)
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
        ps.update_prefix(node, topology.wan_area_of(node), PrefixEntry(f"10.{(i >> 8) & 255}.{i & 255}.1/32"))
    enc = csr.encode_multi_area(areas, me)
    by_area = dict(zip(enc.areas, enc.topos))
    singles = [(l.n1, l.n2) for a in ("0", "metro0") for l in by_area[a].links]
    calls = []
    real = fleet_tables.spf_segment_batch

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    fleet_tables.spf_segment_batch = record
    try:
        whatif_api.MultiAreaWhatIfEngine(SpfSolver(me), device=dev).run(singles, areas, ps, 1)
    finally:
        fleet_tables.spf_segment_batch = real
    return max(calls, key=lambda c: c[0][5].shape[0])


def hub_kernel(dev) -> dict:
    hub = link_state([("hub", f"leaf{i}", 1) for i in range(5000)], "hub")
    enc = csr.encode_multi_area({"0": hub}, "hub")
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    seg = tables_from_numpy([getattr(enc, k) for k in ("src", "dst", "w", "edge_ok", "overloaded")], dev)
    (roots,) = tables_from_numpy((enc.roots[None],), dev)
    out = {"hub D": D}
    segment_forms(lambda: spf.spf_segment_batch_launcher(*seg, roots, D), "spf_segment_batch, hub row",
                  out, 3, call=lambda: spf.spf_segment_batch(*seg, roots, D))
    return out


def rows_kernel(dev) -> dict:
    ls = link_state(topology._build_wan(8192, 7), "core0")
    enc = csr.encode_multi_area({"0": ls}, "core0")
    topo = enc.topos[0]
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    rng = np.random.default_rng(3)
    B, S = 8, 3
    picks = rng.choice(topo.num_nodes, B, replace=False).astype(np.int32)
    fl = np.full((B, S), -1, np.int32)
    for b in range(B):
        k = 1 + b % 3
        fl[b, :k] = rng.choice(len(topo.links), k, replace=False)
    fa = np.where(fl >= 0, 0, -1).astype(np.int32)
    seg = tables_from_numpy([getattr(enc, k) for k in ("src", "dst", "w", "edge_ok", "overloaded")], dev)
    roots, li, fa_t, fl_t = tables_from_numpy((picks[:, None], topo.link_index[None], fa, fl), dev)
    kw = dict(link_index=li, fail_area=fa_t, fail_link=fl_t)
    out = {"(g) rows D": D}
    segment_forms(lambda: spf.spf_segment_batch_launcher(*seg, roots, D, **kw),
                  "spf_segment_batch, (g) 8 rows", out, 5,
                  call=lambda: spf.spf_segment_batch(*seg, roots, D, **kw))
    return out


def cold_kernel(dev) -> dict:
    enc = csr.encode_multi_area({"0": link_state(topology.grid_edges(64), "node0")}, "node0")
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    planes = tables_from_numpy(
        [getattr(enc, k) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")],
        dev)
    in_src, in_w, in_ok, _rank, _has, ovl, roots = planes
    dist = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    make = lambda: spf.dense_spf_nexthop_lanes_launcher(*planes, dist, D)  # noqa: E731
    out = {"grid D": D, "dense_spf_nexthop_lanes (grid)": timed(make)}
    sweep(make, "dense_spf_nexthop_lanes (grid)", {"DENSE_LANES_THREADS": (256, 512, 1024)}, out)
    return out


def masked_rows(edges, dev):
    """Kernel 15's set-form inputs on a wan_hierarchy world: one row per
    destination of core0 (sorted), its failed set the links of the
    destination's first paths.  Returns (edge-list args, link index,
    failed sets)."""
    ls = link_state(edges, "core0")
    topo = csr.encode_multi_area({"0": ls}, "core0").topos[0]
    link_id = {link.key: i for i, link in enumerate(topo.links)}
    sets = []
    for d in sorted(ls.get_adjacency_databases()):
        if d != "core0":
            sets.append(sorted({link_id[l.key] for p in ls.get_kth_paths("core0", d, 1) for l in p}))
    roots = np.full(len(sets), topo.node_id("core0"), np.int32)
    args = tables_from_numpy(
        [topo.src, topo.dst, topo.w, topo.edge_ok, topo.overloaded, roots], dev
    )
    li, failed = tables_from_numpy((topo.link_index, csr.link_failure_sets(sets)), dev)
    return args, li, failed


def masked_kernel(dev) -> dict:
    edges = topology._build_wan(8192, 7)
    args, li, failed = masked_rows(edges, dev)
    out = {"rows": int(failed.shape[0]), "max_failed": int(failed.shape[1])}
    out["spf_distances_masked, cold"] = timed(
        lambda: spf.spf_distances_masked_launcher(*args, None, li, failed))
    *edge_args, roots = args
    out["spf_distances_masked, churn (2 rows)"] = timed(
        lambda: spf.spf_distances_masked_launcher(*edge_args, roots[-2:], None, li, failed[-2:]))
    sweep(lambda: spf.spf_distances_masked_launcher(*args, None, li, failed),
          "spf_distances_masked, cold",
          {"FRONTIER_CAP": (1024, 2048), "MASKED_THREADS": (256, 512, 1024)}, out)
    sweep(lambda: spf.spf_distances_masked_launcher(*args, None, li, failed),
          "spf_distances_masked, cold, global state",
          {"MAX_SHARED_BYTES": (0,), "MASKED_THREADS": (128, 256, 512)}, out)
    # the weakening: the first backbone link not at core0 raised by 5
    a, b, _m = next(e for e in edges if e[0].startswith("core") and e[1].startswith("core")
                    and "core0" not in e[:2])
    weak = [(x, y, w + 5) if (x, y) in ((a, b), (b, a)) else (x, y, w) for x, y, w in edges]
    args, li, failed = masked_rows(weak, dev)
    out["spf_distances_masked, weakening"] = timed(
        lambda: spf.spf_distances_masked_launcher(*args, None, li, failed))
    return out


def fattree_kernel(dev) -> dict:
    ls = link_state(topology._build_fattree(2048, 0), "rsw0_0")
    enc, D, r = encoded({"0": ls}, "rsw0_0", dev)
    dense = tables_from_numpy(
        [getattr(enc, k) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded")], dev
    )
    out = {"fat-tree roots": int(r.shape[0]), "fat-tree V": int(enc.overloaded.shape[1])}
    make = lambda: spf.fleet_spf_dense_launcher(*dense, r, D)  # noqa: E731
    out["fleet_spf_dense (h) fat-tree, default path"] = timed(make, 5)
    sweep(make, "fleet_spf_dense (h) fat-tree", {"FLEET_THREADS": (256, 512, 1024)}, out, 5)
    saved = spf.MAX_SHARED_BYTES
    spf.MAX_SHARED_BYTES = 0
    try:
        out["fleet_spf_dense (h) fat-tree, budget 0"] = timed(make, 5)
    finally:
        spf.MAX_SHARED_BYTES = saved
    return out


def wall_ms(fn, runs: int) -> float:
    """Host ms of ``fn()`` to a synchronize, median of ``runs`` after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def flagship_kernel(dev) -> dict:
    import chip_smoke as cs
    from openr_tpu_torch.ops import route_select as rs

    _edges, _ls, topo, cands = cs.flagship_world(np.random.default_rng(0))
    failed, ovl, soft, roots = cs.flagship_rows(topo)
    mask = csr.link_failure_batch(topo, [[int(f)] for f in failed])
    D = topo.max_out_degree()
    args = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok, mask, ovl, roots], dev)
    src, dst, w, ok, m, o, r = args
    out = {"flagship rows": int(r.shape[0]), "flagship D": D}
    make = lambda: spf.batched_spf_launcher(src, dst, w, ok, o, r, D, edge_enabled=m)  # noqa: E731
    out["batched_spf (i)"] = timed(make, 20)
    out["batched_spf (i), per call"] = launch_ms(lambda: spf.batched_spf(*args, D), 20)
    out["batched_spf (i), bind (host)"] = bind_ms(make, 20)
    if hasattr(spf, "batched_spf_layout"):
        sweep(make, "batched_spf (i)", {"ROW_THREADS": (128, 256, 512, 1024)}, out, 20)
        sweep(make, "batched_spf (i)", {"MAX_SHARED_BYTES": (0,)}, out, 5)
        sweep(make, "batched_spf (i)", {"ROW_THREADS": (256, 512), "FLEET_SHARED_ALL_BYTES": (0,)},
              out, 20)
        sweep(make, "batched_spf (i)", {"ROW_THREADS": (256, 512), "FRONTIER_CAP": (256, 512)},
              out, 20)
    cand = [cands.cand_node, cands.cand_ok, cands.drain_metric, cands.path_pref,
            cands.source_pref, cands.distance, cands.min_nexthop]
    step = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok, mask, ovl, soft, roots]
                             + cand, dev)
    out["flagship step wall (host ms)"] = wall_ms(lambda: rs.spf_and_select(*step, max_degree=D), 5)
    return out


def repair_kernel(dev) -> dict:
    import chip_smoke as cs
    from openr_tpu_torch.ops import repair, sweep_select
    from openr_tpu_torch.ops import whatif as whatif_ops

    _ls, _ps, topo = cs.headline_world()
    fails = np.random.default_rng(0).integers(0, len(topo.links), size=cs.WHATIF_FAILURES)
    fails = fails.astype(np.int32)
    calls = []
    real = repair.repair_sweep

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    eng = whatif_ops.LinkFailureSweep(topo, "node0", device=dev)
    repair.repair_sweep = record
    try:
        eng.run(fails, fetch=False)
        torch.cuda.synchronize()
    finally:
        repair.repair_sweep = real
    args, kw = max(calls, key=lambda c: c[0][5].shape[0])
    out = {"(a) chunk": int(args[5].shape[0])}
    make = lambda: repair.repair_sweep_launcher(*args, **kw)  # noqa: E731
    out["repair_sweep (a)"] = timed(make)
    chunk = args[5].cpu().numpy()
    engine = eng.repair_sweep()
    out["repair_sweep (a), per call"] = launch_ms(lambda: engine.solve(chunk))
    out["repair_sweep (a), bind (host)"] = bind_ms(make)
    if hasattr(repair, "REPAIR_CLUSTER"):
        sweep(make, "repair_sweep (a)",
              {"REPAIR_THREADS": (256, 512, 1024), "REPAIR_CLUSTER": (1, 2, 4, 8)}, out,
              mod=repair)
        every = dict(kw, exact_base=False)
        out["repair_sweep (a), every vertex listed"] = timed(
            lambda: repair.repair_sweep_launcher(*args, **every))
    cands = sweep_select.SweepCandidates.single_advertiser(np.arange(topo.num_nodes))

    def sweep_once(t, engine):
        sel = sweep_select.SweepRouteSelector(t, "node0", cands, max_degree=engine.D)
        return sel.run(engine.run(fails, fetch=False))

    out["(a) cold sweep wall (host ms)"] = wall_ms(
        lambda: sweep_once(topo, whatif_ops.LinkFailureSweep(topo, "node0", device=dev)), 3)
    _ls2, _ps2, topo2 = cs.headline_world(metric_bump=5)

    def warm_once():
        eng2 = whatif_ops.LinkFailureSweep(topo2, "node0", device=dev)
        assert eng2.seed_base_from(eng)
        return sweep_once(topo2, eng2)

    out["(a) warm-seeded sweep wall (host ms)"] = wall_ms(warm_once, 3)
    return out


def bound_ms(t_bytes: int, ops: int) -> float:
    """The least time of the work, with ``chip_smoke``'s rates: its bytes
    (inputs read once, outputs written once) over the HBM rate or its
    operations over the f32 rate."""
    import chip_smoke as cs

    return max(t_bytes / cs.HBM_BYTES_PER_S, ops / cs.F32_OPS_PER_S) * 1e3


def dense_shape(label: str, planes, out: dict) -> None:
    """Kernel 1 on one shape: its rounds, usable slots and bound, per
    launch and per call, and the knobs' sweep."""
    import chip_smoke as cs

    in_src, in_w, in_ok, ovl, roots = planes
    dist = spf.dense_spf_distances_plain(*planes)
    usable = int(spf.transit_ok(in_src, in_ok, ovl, roots).sum())
    out[f"{label} shape"] = list(in_src.shape)
    out[f"{label} rounds"] = cs.relax_rounds(*planes)
    out[f"{label} usable slots"] = usable
    out[f"{label} bound ms"] = bound_ms(cs.dense_distances_bytes(in_src, in_ok, ovl, roots, dist),
                                        2 * usable)
    make = lambda: spf.dense_spf_distances_launcher(*planes)  # noqa: E731
    out[label] = timed(make)
    out[f"{label}, per call"] = launch_ms(lambda: spf.dense_spf_distances(*planes))
    if hasattr(spf, "DENSE_CLUSTER"):
        out[f"{label} rule cluster"] = spf.dense_cluster_size(in_src.shape[1], in_src.shape[2])
        sweep(make, label, {"DENSE_CLUSTER": (1, 2, 4, 8),
                            "MAX_SHARED_BYTES": (spf.MAX_SHARED_BYTES, 0)}, out)
        sweep(make, label, {"DENSE_CLUSTER": (1, 4, 8), "DENSE_SWEEPS": (1, 2, 4, 8, 16)}, out)


def dense_kernel(dev) -> dict:
    import chip_smoke as cs

    fields = ("in_src", "in_w", "in_ok", "overloaded", "roots")
    out = {}
    for label, areas, me in (
        ("dense_spf_distances (grid)", {"0": link_state(topology.grid_edges(64), "node0")}, "node0"),
        ("dense_spf_distances (3-area)", *cs.three_area_world()[::2]),
        ("dense_spf_distances (g) cold", {"0": link_state(topology._build_wan(8192, 7), "core0")},
         "core0"),
    ):
        enc = csr.encode_multi_area(areas, me)
        dense_shape(label, tables_from_numpy([getattr(enc, k) for k in fields], dev), out)
    return out


def recorded_selects(dev) -> dict:
    """label -> (args, kwargs) of kernel 13's call (the largest where a run
    makes several) in each phase of ``chip_smoke`` that runs it."""
    import chip_smoke as cs
    from openr_tpu_torch.decision import whatif_api
    from openr_tpu_torch.decision.fleet import FleetRibEngine
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.ops import fleet_tables
    from openr_tpu_torch.types import PrefixEntry

    calls = []
    real = fleet_tables.fleet_select

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    def take(run):
        calls.clear()
        run()
        torch.cuda.synchronize()
        return max(calls, key=lambda c: c[0][0].shape[0] * c[0][4].shape[0])

    fleet_tables.fleet_select = record
    out = {}
    try:
        areas, ps, _nodes = cs.fleet_world()
        eng = FleetRibEngine(SpfSolver("node0"), device=dev)
        out["(d) cold"] = take(lambda: eng.fleet_summary(areas, ps, 1))
        areas2, ps2, _ = cs.fleet_world(metric_bump=7)
        out["(d) delta"] = take(lambda: eng.fleet_summary(areas2, ps2, 2))
        a3, ps3, me = cs.three_area_world()
        out["(e) 3-area"] = take(
            lambda: FleetRibEngine(SpfSolver(me), device=dev).fleet_summary(a3, ps3, 1))
        hub = link_state([("hub", f"leaf{i}", 1) for i in range(cs.HUB_LEAVES)], "hub")
        hub_ps = PrefixState()
        for i in range(64):
            hub_ps.update_prefix(f"leaf{i}", "0", PrefixEntry(f"10.3.{i}.0/24"))
        out["(e) hub"] = take(
            lambda: FleetRibEngine(SpfSolver("hub"), device=dev).fleet_summary({"0": hub}, hub_ps, 1))
        am, psm, mm = cs.multiarea_world()
        enc = csr.encode_multi_area(am, mm)
        by_area = dict(zip(enc.areas, enc.topos))
        singles = [(l.n1, l.n2) for a in ("0", "metro0") for l in by_area[a].links]
        homing = [(l.n1, l.n2) for l in by_area["0"].links
                  if topology.wan_area_of(l.n1) == "metro0" or topology.wan_area_of(l.n2) == "metro0"]
        weng = whatif_api.MultiAreaWhatIfEngine(SpfSolver(mm), device=dev)
        out["(f) singles"] = take(lambda: weng.run(singles, am, psm, 1))
        out["(f) homing set"] = take(lambda: weng.run(homing, am, psm, 1, simultaneous=True))
        af, psf, _ = cs.fattree_world()
        out["(h) fat-tree"] = take(
            lambda: FleetRibEngine(SpfSolver("rsw0_0"), device=dev).fleet_summary(af, psf, 1))
    finally:
        fleet_tables.fleet_select = real
    return out


def select_kernel(dev) -> dict:
    import chip_smoke as cs
    from openr_tpu_torch.ops import route_select as rs

    out = {}
    for label, (args, kw) in recorded_selects(dev).items():
        key = f"fleet_select {label}"
        B, A, _V = args[0].shape
        P, C = args[4].shape
        D = args[1].shape[-1]
        launch, outs = rs.fleet_select_launcher(*args, **kw)
        out[f"{key} B,P,C,A,D"] = [B, P, C, A, D]
        # the bound counts the winners' cells: the kernel's outputs (equal
        # to the plain version's, which chip_smoke holds it to) name them
        launch()
        out[f"{key} bound ms"] = bound_ms(cs.select_bytes(args, kw, outs),
                                          B * cs.select_ops(P, C, A, D))
        out[key] = launch_ms(launch)
        out[f"{key}, per call"] = launch_ms(lambda: rs.fleet_select(*args, **kw))
        make = lambda: rs.fleet_select_launcher(*args, **kw)  # noqa: E731
        sweep(make, key, {"SELECT_TILE_ROWS": (16, 32, 64, 128, 256, 512)}, out, mod=rs)
    return out


def sweep_inputs(dev) -> dict:
    """label -> the arguments of kernel 8 at each shape ``chip_smoke.py``
    launches it."""
    import chip_smoke as cs
    from openr_tpu_torch.ops import whatif as whatif_ops

    _ls, _ps, topo = cs.headline_world()
    eng = whatif_ops.LinkFailureSweep(topo, "node0", device=dev)
    edges = (eng._src, eng._dst, eng._w, eng._edge_ok, eng._link_index)
    fails = np.random.default_rng(0).integers(0, len(topo.links), size=cs.WHATIF_FAILURES)
    base = torch.full((32,), -1, dtype=torch.int32, device=dev)
    (hold,) = tables_from_numpy([fails[: cs.COLD_HOLD].astype(np.int32)], dev)
    _e, _l, ftopo, _c = cs.flagship_world(np.random.default_rng(0))
    failed = cs.flagship_rows(ftopo)[0][: len(ftopo.links)]
    flag = tables_from_numpy(
        [ftopo.src, ftopo.dst, ftopo.w, ftopo.edge_ok, ftopo.link_index, failed, ftopo.overloaded],
        dev)
    return {
        "(a) base solve": (*edges, base, eng._overloaded, eng.root_id, eng.D),
        "(a) cold hold": (*edges, hold, eng._overloaded, eng.root_id, eng.D),
        "(i) cross-check": (*flag, ftopo.node_id("node0"), ftopo.max_out_degree()),
    }


def sweep_kernel(dev) -> dict:
    import chip_smoke as cs

    out = {}
    for label, args in sweep_inputs(dev).items():
        key = f"sweep_spf_link_failures {label}"
        src, dst, w, ok, li, failed, ovl, root, D = args
        V, E, B = ovl.shape[0], src.shape[0], failed.shape[0]
        launch, (dist, nh, k_rd, k_rl) = spf.sweep_spf_link_failures_launcher(*args)
        launch()
        out[f"{key} kernel rounds (most of a word)"] = [int(k_rd.max()), int(k_rl.max())]
        # one relaxation per usable edge per snapshot (its failed link's
        # edges off), a max per lane a root out-edge can seed; inputs read
        # once, outputs written once
        transit = ~ovl | (torch.arange(V, device=dev) == root)
        usable_e = ok & transit[src.long()]
        usable = B * int(usable_e.sum()) - int((usable_e[:, None] & (li[:, None] == failed[None])).sum())
        lanes = min(int((src == root).sum()), D)
        _d, _n, r_d, r_l = spf.sweep_spf_link_failures_plain(*args)
        out[f"{key} V,E,B,D"] = [V, E, B, D]
        out[f"{key} rounds"] = [r_d, r_l]
        out[f"{key} bound ms"] = bound_ms(
            cs.nbytes(src, dst, w, ok, li, failed, ovl, dist, nh), (2 + lanes) * usable)
        out[key] = launch_ms(launch)
        out[f"{key}, per call"] = launch_ms(lambda: spf.sweep_spf_link_failures(*args))
        make = lambda: spf.sweep_spf_link_failures_launcher(*args)  # noqa: E731
        sweep(make, key, {"SWEEP_CLUSTER": (1, 2, 4, 8),
                          "SWEEP_SHARED_BYTES": (spf.BLOCK_SHARED_BYTES, 0)}, out)
    return out


def grid_warm_ticks():
    """Yield ``(tick, KernelPath)`` after each of the grid's ``warm_delta``
    ticks (the undrain of node1, the weakening, the restore), through
    ``chip_smoke.py``'s topology changes before and at them (one prefix a
    node: prefixes do not reach the warm kernels)."""
    import chip_smoke as cs
    from openr_tpu_torch.decision.spf_solver import SpfSolver

    saved = cs.PREFIXES_PER_NODE
    cs.PREFIXES_PER_NODE = 1
    try:
        dbs, areas, ps = cs.grid_world()
    finally:
        cs.PREFIXES_PER_NODE = saved
    side = cs.GRID_SIDE
    be = cs.KernelPath(SpfSolver("node0"))
    be.build_route_db(areas, ps)
    mid = f"node{len(dbs) // 2 + side // 2}"
    adj = dbs[mid].adjacencies[0]
    cs.set_metric(areas, dbs, mid, adj.other_node_name, adj.metric + 4)
    be.build_route_db(areas, ps)
    cs.set_overload(areas, dbs, "node1", True)
    be.build_route_db(areas, ps)
    warm = dict(changed_prefixes=set(), force_full=True, warm_delta=True)
    cs.set_overload(areas, dbs, "node1", False)
    be.build_route_db(areas, ps, **warm)
    yield "grid undrain", be
    a, b = f"node{(side // 2) * side}", f"node{(side // 2 + 1) * side}"
    for metric, tick in ((11, "grid weakening"), (1, "grid restore")):
        cs.set_metric(areas, dbs, a, b, metric)
        cs.set_metric(areas, dbs, b, a, metric)
        be.build_route_db(areas, ps, **warm)
        yield tick, be


def reset_inputs(dev) -> dict:
    """label -> the arguments of ``CudaBackend._warm_tables`` at the grid's
    undrain and restoring ticks (:func:`grid_warm_ticks`)."""
    return {tick: be.io["warm"][0] for tick, be in grid_warm_ticks()
            if tick != "grid weakening"}


def reset_kernel(dev) -> dict:
    import chip_smoke as cs

    out = {}
    for label, args in reset_inputs(dev).items():
        src, dst, w, ok, ovl, roots, prev_dist, prev_nh, reset, lane_keep, D = args
        seg = (src, dst, w, ok, ovl, roots)
        d0, nh0 = spf.warm_seeds(prev_dist, prev_nh, reset, lane_keep)
        dist = spf.warm_spf_distances_plain(*seg, d0)[0]
        usable, lanes = cs.segment_relaxations(src, ok, ovl, roots, D)
        seeds = [(label, nh0)]
        if label == "grid undrain":
            seeds.append(("grid zero seed", torch.zeros_like(nh0)))
        for name, seed in seeds:
            key = f"spf_nexthop_lanes_reset ({name})"
            launch, (nh, k_r) = spf.spf_nexthop_lanes_reset_launcher(*seg, dist, seed, D)
            launch()
            out[f"{key} kernel rounds"] = int(k_r.max())
            out[f"{key} A,V,E,D"] = [*src.shape[:1], ovl.shape[1], src.shape[1], D]
            out[f"{key} rounds"] = int(
                spf.spf_nexthop_lanes_reset_plain(*seg, dist, seed, D, unroll=1)[1].max())
            out[f"{key} lane cells moved from the seed"] = int((seed != nh).sum())
            out[f"{key} bound ms"] = bound_ms(cs.nbytes(*seg, dist, nh),
                                              int((usable * lanes).sum()))
            out[key] = launch_ms(launch)
            out[f"{key}, per call"] = launch_ms(
                lambda: spf.spf_nexthop_lanes_reset(*seg, dist, seed, D))
            sweep(lambda: spf.spf_nexthop_lanes_reset_launcher(*seg, dist, seed, D), key,
                  {"RESET_LANES_CLUSTER": (1, 2, 4, 8)}, out)
    return out


def recorded_chunks(dev) -> dict:
    """label -> [(args, kwargs)] of kernel 10's calls (``select_chunk``) in
    each what-if phase of ``chip_smoke.py``, run through its own helpers:
    (a) the headline sweep (its base at b = 1 and its chunks), (b) the
    criticality report over the same world, (c) the grid query (node0's
    two links and 30 links drawn with seed 0) and the grid's set of 3, on
    the 64 x 64 grid at 100 prefixes a node."""
    import chip_smoke as cs
    from openr_tpu_torch.decision import whatif_api
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.ops import sweep_select
    from openr_tpu_torch.ops import whatif as whatif_ops

    calls = []
    real = sweep_select.select_chunk

    def record(*args, **kwargs):
        calls.append((args, {k: v for k, v in kwargs.items() if k != "out"}))
        return real(*args, **kwargs)

    def take(run):
        calls.clear()
        run()
        torch.cuda.synchronize()
        return list(calls)

    sweep_select.select_chunk = record
    out = {}
    try:
        ls, ps, topo = cs.headline_world()
        fails = cs.headline_failures(topo)
        out["(a)"] = take(lambda: cs.headline_sweep(
            topo, whatif_ops.LinkFailureSweep(topo, "node0", device=dev), fails, device=dev))
        engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
        out["(b)"] = take(lambda: cs.criticality(engine, ls, ps))
        _dbs, areas, gps = cs.grid_world()
        query, sim = cs.grid_queries(areas, np.random.default_rng(0))
        grid_engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
        out["(c)"] = take(lambda: grid_engine.run(query, areas, gps, 1))
        out["(c) set of 3"] = take(
            lambda: grid_engine.run(sim, areas, gps, 1, simultaneous=True))
    finally:
        sweep_select.select_chunk = real
    return out


def backbone_weakenings():
    """Yield the ``KernelPath`` on phase (g)'s KSP2 backbone
    (``chip_smoke.backbone_dbs``: V = 16,384, E = 32,768, vantage core0,
    eight plain loopbacks) after each ``warm_delta`` weakening by 5 of a
    backbone link, the links drawn with seed 0, each weakening kept."""
    import chip_smoke as cs
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.types import PrefixEntry

    dbs, nodes = cs.backbone_dbs()
    areas = cs.backbone_copy(dbs)
    ps = PrefixState()
    for i in range(8):
        ps.update_prefix(nodes[i * 997 % len(nodes)], "0", PrefixEntry(f"10.9.{i}.1/32"))
    be = cs.KernelPath(SpfSolver("core0"))
    be.build_route_db(areas, ps)
    enc = csr.encode_multi_area(areas, "core0")
    core = sorted((l.n1, l.n2) for l in enc.topos[0].links
                  if l.n1.startswith("core") and l.n2.startswith("core")
                  and "core0" not in (l.n1, l.n2))
    warm = dict(changed_prefixes=set(), force_full=True, warm_delta=True)
    for k in np.random.default_rng(0).permutation(len(core)):
        a, b = core[int(k)]
        metric = next(x.metric for x in dbs[a].adjacencies if x.other_node_name == b)
        cs.set_metric(areas, dbs, a, b, metric + 5)
        cs.set_metric(areas, dbs, b, a, metric + 5)
        be.build_route_db(areas, ps, **warm)
        yield be


def warm_dist_inputs(dev) -> dict:
    """label -> the arguments of ``CudaBackend._warm_tables`` where the
    main path runs kernel 4: the grid's undrain and restoring ticks
    (:func:`reset_inputs`), and phase (g)'s warm weakening on the KSP2
    backbone: the first of :func:`backbone_weakenings` that the planner
    sends to kernels 4 and 5."""
    out = reset_inputs(dev)
    for be in backbone_weakenings():
        if "warm" in be.io:
            out["(g) weakening"] = be.io["warm"][0]
            break
    return out


def chunk_warm_kernels(dev) -> dict:
    """Kernels 10 and 4 at every shape ``chip_smoke.py`` launches them:
    per launch and per call of the entry point, with each shape's bound
    (``chip_smoke.chunk_bytes`` and ``chunk_ops``, ``warm_distances_bytes``
    and one relaxation per usable edge); kernel 4 also at its rounds, and
    where the checkout has ``spf.WARM_DIST_CLUSTER``, at clusters of 1, 2,
    4 and 8, its records in the global list and its state global."""
    import chip_smoke as cs
    from openr_tpu_torch.ops import sweep_select

    out = {}
    for label, calls in recorded_chunks(dev).items():
        shapes = {}
        for args, kw in calls:
            shapes.setdefault(args[0].shape[1], (args, kw, []))[2].append(1)
        for b, (args, kw, n) in sorted(shapes.items()):
            key = f"select_chunk {label} b={b}"
            P, C = args[5].shape
            launch, outs = sweep_select.select_chunk_launcher(*args, **kw)
            launch()
            out[f"{key} V,b,P,C,D,launches"] = [args[0].shape[0], b, P, C, args[-1], len(n)]
            out[f"{key} bound ms"] = bound_ms(cs.chunk_bytes(args, outs), cs.chunk_ops(args))
            out[key] = launch_ms(launch)
            out[f"{key}, queued"] = cs.queued_ms(launch)
            out[f"{key}, per call"] = launch_ms(lambda: sweep_select.select_chunk(*args, **kw))
    for label, args in warm_dist_inputs(dev).items():
        key = f"warm_spf_distances ({label})"
        src, dst, w, ok, ovl, roots, prev_dist, prev_nh, reset, lane_keep, D = args
        seg = (src, dst, w, ok, ovl, roots)
        d0, _nh0 = spf.warm_seeds(prev_dist, prev_nh, reset, lane_keep)
        launch, (dist, k_r) = spf.warm_spf_distances_launcher(*seg, d0)
        launch()
        usable, _lanes = cs.segment_relaxations(src, ok, ovl, roots, D)
        out[f"{key} A,V,E"] = [src.shape[0], ovl.shape[1], src.shape[1]]
        out[f"{key} kernel rounds"] = int(k_r.max())
        out[f"{key} rounds"] = int(spf.warm_spf_distances_plain(*seg, d0, unroll=1)[1].max())
        out[f"{key} reset vertices"] = int(reset.sum())
        out[f"{key} bound ms"] = bound_ms(cs.warm_distances_bytes(src, ok, ovl, roots, d0, dist),
                                          2 * int(usable.sum()))
        out[key] = launch_ms(launch)
        out[f"{key}, queued"] = cs.queued_ms(launch)
        out[f"{key}, per call"] = launch_ms(lambda: spf.warm_spf_distances(*seg, d0))
        make = lambda: spf.warm_spf_distances_launcher(*seg, d0)  # noqa: E731
        out[f"{key}, bind (host)"] = bind_ms(make)
        if hasattr(spf, "WARM_DIST_CLUSTER"):
            V = ovl.shape[1]
            out[f"{key} rule cluster"] = spf.warm_dist_cluster_size(V, src.shape[1])
            sweep(make, key, {"WARM_DIST_CLUSTER": (1, 2, 4, 8)}, out)
            fixed = spf.warm_dist_fixed_bytes(V, -(-V // spf.warm_dist_cluster_size(V, src.shape[1])))
            sweep(make, key, {"MAX_SHARED_BYTES": (fixed, 0)}, out)
    return out


def hub_world(leaves: int):
    """``chip_smoke``'s hub: ``leaves`` leaves on one hub, 64 of them with a
    /24 (phases (e) and (h))."""
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.types import PrefixEntry

    hub = link_state([("hub", f"leaf{i}", 1) for i in range(leaves)], "hub")
    ps = PrefixState()
    for i in range(64):
        ps.update_prefix(f"leaf{i}", "0", PrefixEntry(f"10.3.{i}.0/24"))
    return {"0": hub}, ps


def recorded_route_selects() -> dict:
    """label -> (kernel, args) of kernels 3 and 7 where ``chip_smoke.py``'s
    main path runs them, recorded through ``chip_smoke.KernelPath`` on
    its ticks in its order: kernel 3 at the grid's full build (64 x 64,
    100 prefixes a node), at the churn tick's gathered rows (2,048
    withdrawals and 2,048 new prefixes drawn with seed 0), at the
    warm-selective rows of the restore tick (after the link-metric change,
    node1's drain and undrain and the weakening), on the 3-area world, the
    hubs of phases (e) and (h), phase (g)'s KSP2 cold build (the
    wan_hierarchy backbone at 8,192 nodes, a loopback a node but the last
    two), its churn tick (the two late loopbacks and one withdrawal) and
    the device-build what-if's builds (64 loopbacks drawn with seed 0, on
    backbone links of their first paths); kernel 7 at the grid's second
    unhinted drain tick."""
    import chip_smoke as cs
    from openr_tpu_torch.decision import backend as backend_mod
    from openr_tpu_torch.decision import whatif_api
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.types import PrefixEntry

    out = {}

    def build(label, be, areas, ps, key="select", **hints):
        be.build_route_db(areas, ps, **hints)
        torch.cuda.synchronize()
        if label:
            out[label] = ("multi_area_select_from_tables", be.io[key][0])
        return be

    dbs, areas, ps = cs.grid_world()
    be = build("grid full build", cs.KernelPath(SpfSolver("node0")), areas, ps)
    side = cs.GRID_SIDE
    n = len(dbs)
    mid = f"node{n // 2 + side // 2}"
    adj = dbs[mid].adjacencies[0]
    cs.set_metric(areas, dbs, mid, adj.other_node_name, adj.metric + 4)
    build(None, be, areas, ps)
    cs.set_overload(areas, dbs, "node1", True)
    build(None, be, areas, ps)
    owners = {p: next(iter(e))[0] for p, e in ps.prefixes().items()}
    held = sorted(owners)
    rng = np.random.default_rng(0)
    changed = set()
    for p in [held[i] for i in rng.choice(len(held), cs.CHURN, replace=False)]:
        changed |= ps.delete_prefix(owners[p], "0", p)
    names = sorted(dbs)
    for i in range(cs.CHURN):
        node = names[int(rng.integers(len(names)))]
        changed |= ps.update_prefix(node, "0", PrefixEntry(f"10.100.{i >> 8}.{i & 255}/32"))
    build("churn's gathered rows", be, areas, ps, changed_prefixes=changed)
    warm = dict(changed_prefixes=set(), force_full=True, warm_delta=True)
    cs.set_overload(areas, dbs, "node1", False)
    build(None, be, areas, ps, **warm)
    a, b = f"node{(side // 2) * side}", f"node{(side // 2 + 1) * side}"
    for metric in (11, 1):  # the weakening, then the restore
        cs.set_metric(areas, dbs, a, b, metric)
        cs.set_metric(areas, dbs, b, a, metric)
        build(None, be, areas, ps, **warm)
    out["warm-selective rows"] = ("multi_area_select_from_tables", be.io["select"][0])
    unhinted = dict(changed_prefixes=set(), force_full=True)
    for node in (f"node{(side * 3 // 8) * side + side * 3 // 8}",
                 f"node{(side * 5 // 8) * side + side * 5 // 8}"):
        cs.set_overload(areas, dbs, node, True)
        build(None, be, areas, ps, **unhinted)
    out["grid drain delta"] = ("multi_area_select_delta_from_tables", be.io["delta"][0])
    a3, ps3, me = cs.three_area_world()
    build("3-area", cs.KernelPath(SpfSolver(me)), a3, ps3)
    build("(e) hub", cs.KernelPath(SpfSolver("hub")), *hub_world(cs.HUB_LEAVES))
    build("(h) hub", cs.KernelPath(SpfSolver("hub")), *hub_world(cs.HUB_LEAVES_LARGE))

    bdbs, nodes = cs.backbone_dbs()
    bps = PrefixState()
    for i, node in enumerate(nodes[:-2]):
        bps.update_prefix(node, "0", cs.loopback(i))
    backbone = cs.backbone_copy(bdbs)
    be = build("(g) KSP2 cold", cs.KernelPath(SpfSolver("core0")), backbone, bps, force_full=True)
    changed = set()
    for i in (len(nodes) - 2, len(nodes) - 1, 1):
        if i == 1:
            changed |= bps.delete_prefix(nodes[i], "0", cs.loopback(i).prefix)
        else:
            changed |= bps.update_prefix(nodes[i], "0", cs.loopback(i))
    build("(g) churn", be, backbone, bps, changed_prefixes=changed)
    wps = PrefixState()
    owners = {p: next(iter(e)) for p, e in bps.prefixes().items()}
    held = sorted(owners)
    links = []
    for i in np.random.default_rng(0).choice(len(held), cs.KSP2_WHATIF_PREFIXES, replace=False):
        node, area = owners[held[i]]
        wps.update_prefix(node, area, bps.prefixes()[held[i]][(node, area)])
        for path in backbone["0"].get_kth_paths("core0", node, 1)[:1]:
            links += [(l.n1, l.n2) for l in path if (l.n1, l.n2) not in links
                      and l.n1.startswith("core") and l.n2.startswith("core")
                      and "core0" not in (l.n1, l.n2)]
    calls = []
    real = backend_mod.multi_area_select_from_tables

    def record(*args):
        calls.append(args)
        return real(*args)

    backend_mod.multi_area_select_from_tables = record
    try:
        whatif_api.DeviceBuildWhatIfEngine(SpfSolver("core0")).run(
            links[:cs.KSP2_WHATIF_LINKS], backbone, wps, 1)
        torch.cuda.synchronize()
    finally:
        backend_mod.multi_area_select_from_tables = real
    out["(g) device-build what-if"] = ("multi_area_select_from_tables", calls[0])
    return out


def selection_kernels(dev) -> dict:
    """Kernels 17 and 3 at every shape ``chip_smoke.py`` runs them, per
    launch (back to back and queued) and per call of the entry point, with
    each shape's bound: kernel 17 at phase (i) (the flagship rows of
    ``chip_smoke.flagship_rows`` on kernel 16's tables, with candidates of
    ``chip_smoke.flagship_world`` drawn with seed 0) and at ``entry()``'s
    batch; kernel 3 at :func:`recorded_route_selects`' shapes, the grid's also at
    tiles of 32-512 rows (``rs.SELECT_TILE_ROWS``); kernel 7 at the grid's
    drain delta; the flagship step's wall; kernel 10 at the (a) and (c)
    chunks of :func:`recorded_chunks` and kernel 13 at the seven shapes
    of :func:`recorded_selects`, as in the ``chunkwarm`` and ``select``
    groups."""
    import chip_smoke as cs
    from openr_tpu_torch import graft_entry
    from openr_tpu_torch.ops import route_select as rs
    from openr_tpu_torch.ops import sweep_select

    def timings(key, launch, call, t_bytes, ops):
        out[f"{key} bound ms"] = bound_ms(t_bytes, ops)
        out[key] = launch_ms(launch)
        out[f"{key}, queued"] = cs.queued_ms(launch)
        out[f"{key}, per call"] = launch_ms(call)

    out = {}
    _edges, _ls, topo, cands = cs.flagship_world(np.random.default_rng(0))
    failed, ovl, soft, roots = cs.flagship_rows(topo)
    mask = csr.link_failure_batch(topo, [[int(f)] for f in failed])
    D = topo.max_out_degree()
    src, dst, w, ok, m, o, s, r = tables_from_numpy(
        [topo.src, topo.dst, topo.w, topo.edge_ok, mask, ovl, soft, roots], dev)
    cand = tables_from_numpy([cands.cand_node, cands.cand_ok, cands.drain_metric,
                              cands.path_pref, cands.source_pref, cands.distance,
                              cands.min_nexthop], dev)
    dist, nh = spf.batched_spf(src, dst, w, ok, m, o, r, D)
    flagship = (*cand, dist, nh, o, s, r)
    calls = []
    real = rs.batched_select_routes

    def record(*args):
        calls.append(args)
        return real(*args)

    forward, e_args = graft_entry.entry()
    rs.batched_select_routes = record
    try:
        forward(*e_args)
        torch.cuda.synchronize()
    finally:
        rs.batched_select_routes = real
    for label, args in (("(i)", flagship), (f"entry() B={calls[0][8].shape[0]}", calls[0])):
        key = f"batched_select_routes {label}"
        launch, outs = rs.batched_select_routes_launcher(*args)
        B, P, C, Dk = args[8].shape[0], args[0].shape[0], args[0].shape[1], args[8].shape[-1]
        out[f"{key} B,V,P,C,D"] = [B, args[7].shape[1], P, C, Dk]
        timings(key, launch, lambda: rs.batched_select_routes(*args),
                cs.nbytes(*args, *outs), B * cs.select_ops(P, C, 1, Dk))
    step = (src, dst, w, ok, m, o, s, r, *cand)
    out["flagship step wall (host ms)"] = wall_ms(lambda: rs.spf_and_select(*step, max_degree=D), 5)

    for label, (name, args) in recorded_route_selects().items():
        key = f"{name} {label}"
        if name == "multi_area_select_delta_from_tables":
            make = lambda: rs.multi_area_select_delta_from_tables_launcher(*args)  # noqa: E731
            call = lambda: rs.multi_area_select_delta_from_tables(*args)  # noqa: E731
        else:
            make = lambda: rs.multi_area_select_from_tables_launcher(*args)  # noqa: E731
            call = lambda: rs.multi_area_select_from_tables(*args)  # noqa: E731
        launch, outs = make()
        launch()
        P, C = args[4].shape
        A, V, Dk = args[1].shape
        out[f"{key} P,C,A,V,D"] = [P, C, A, V, Dk]
        out[f"{key} rows with no ok candidate"] = int((~args[6].any(dim=1)).sum())
        if name == "multi_area_select_delta_from_tables":  # chip_smoke's count for kernel 7
            t_bytes = cs.nbytes(*args, *outs)
        else:  # kernel 3 counted by its ok slots where the checkout's count has them
            view = (args[0][None], args[1][None], *args[2:12])
            ok_only = {"ok_only": True} if "ok_only" in inspect.signature(cs.select_bytes).parameters else {}
            t_bytes = cs.select_bytes(view, {}, tuple(o[None] for o in outs), **ok_only)
        timings(key, launch, call, t_bytes, cs.select_ops(P, C, A, Dk))
        if label == "grid full build":
            sweep(make, key, {"SELECT_TILE_ROWS": (32, 64, 128, 256, 512)}, out, mod=rs)

    for label, chunk_calls in recorded_chunks(dev).items():
        if label not in ("(a)", "(c)"):
            continue
        shapes = {}
        for args, kw in chunk_calls:
            shapes.setdefault(args[0].shape[1], (args, kw, []))[2].append(1)
        for b, (args, kw, n) in sorted(shapes.items()):
            key = f"select_chunk {label} b={b}"
            launch, outs = sweep_select.select_chunk_launcher(*args, **kw)
            launch()
            out[f"{key} launches"] = len(n)
            timings(key, launch, lambda: sweep_select.select_chunk(*args, **kw),
                    cs.chunk_bytes(args, outs), cs.chunk_ops(args))
    for label, (args, kw) in recorded_selects(dev).items():
        key = f"fleet_select {label}"
        B, A, _V = args[0].shape
        P, C = args[4].shape
        launch, outs = rs.fleet_select_launcher(*args, **kw)
        launch()
        timings(key, launch, lambda: rs.fleet_select(*args, **kw), cs.select_bytes(args, kw, outs),
                B * cs.select_ops(P, C, A, args[1].shape[-1]))
    return out


def drain(areas: dict, area: str, node: str) -> None:
    """Hard-drain ``node`` in ``area`` (a new adjacency database)."""
    import dataclasses

    db = areas[area].get_adjacency_databases()[node]
    areas[area].update_adjacency_database(dataclasses.replace(db, is_overloaded=True))


def recorded_deltas():
    """(kernel 3's shapes, kernel 7's calls, kernel 18's calls) where
    ``chip_smoke.py``'s main path runs them, each a dict label -> arguments:
    kernel 3's as :func:`recorded_route_selects` records them (with kernel
    7 at the grid's drain delta and kernel 18's gather there); kernel 7 and
    18 at the 3-area world's two unhinted drain ticks (c3, then b4) under
    each selection algorithm and at the (e) hub's (leaf0, then leaf1),
    recorded through ``chip_smoke.KernelPath``; and kernel 18 at the (d)
    fleet's delta generations (one link raised by 7, then restored), the
    changed roots of each chunk."""
    import chip_smoke as cs
    from openr_tpu_torch.decision import backend as backend_mod
    from openr_tpu_torch.decision import fleet as fleet_mod
    from openr_tpu_torch.decision.fleet import FleetRibEngine
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.types import RouteComputationRules

    gathers, tick = {}, [""]

    def recording(real):
        def record(*args):
            gathers[f"{tick[0]} call {sum(k.startswith(tick[0]) for k in gathers) + 1}"] = args
            return real(*args)
        return record

    reals = backend_mod.gather_selection_rows, fleet_mod.gather_selection_rows
    backend_mod.gather_selection_rows = recording(reals[0])
    fleet_mod.gather_selection_rows = recording(reals[1])
    deltas = {}
    try:
        tick[0] = "grid drain delta"
        selects = recorded_route_selects()
        deltas["grid drain delta"] = selects.pop("grid drain delta")[1]
        unhinted = dict(changed_prefixes=set(), force_full=True)
        worlds = []
        for algo in (RouteComputationRules.SHORTEST_DISTANCE,
                     RouteComputationRules.PER_AREA_SHORTEST_DISTANCE):
            a3, ps3, me = cs.three_area_world()
            worlds.append((f"3-area ({algo.name})", a3, ps3, me, algo, (("3", "c3"), ("2", "b4"))))
        worlds.append(("(e) hub", *hub_world(cs.HUB_LEAVES), "hub",
                       RouteComputationRules.SHORTEST_DISTANCE, (("0", "leaf0"), ("0", "leaf1"))))
        for label, areas, ps, me, algo, drains in worlds:
            be = cs.KernelPath(SpfSolver(me, route_selection_algorithm=algo))
            be.build_route_db(areas, ps)
            for area, node in drains:
                drain(areas, area, node)
                tick[0] = f"{label} drain:{node}"
                be.build_route_db(areas, ps, **unhinted)
                torch.cuda.synchronize()
                deltas[tick[0]] = be.io["delta"][0]
        areas, ps, _nodes = cs.fleet_world()
        eng = FleetRibEngine(SpfSolver("node0"))
        eng.fleet_summary(areas, ps, 1)
        for seq, bump, label in ((2, 7, "raised"), (3, 0, "restored")):
            tick[0] = f"(d) delta {label}"
            eng.fleet_summary(*cs.fleet_world(metric_bump=bump)[:2], seq)
            torch.cuda.synchronize()
    finally:
        backend_mod.gather_selection_rows, fleet_mod.gather_selection_rows = reals
    return {k: v[1] for k, v in selects.items()}, deltas, gathers


def drained_cell(args) -> torch.Tensor:
    """``node_changed`` [A, V] with one drained node: the own-area cell of
    the first ok candidate of the middle row that has one."""
    cand_area, cand_node, cand_ok = args[4], args[5], args[6]
    rows = torch.nonzero(cand_ok.any(dim=1)).squeeze(1)
    p = int(rows[len(rows) // 2])
    c = int(torch.nonzero(cand_ok[p])[0])
    A, V = args[0].shape
    out = torch.zeros((A, V), dtype=torch.bool, device=args[0].device)
    out[int(cand_area[p, c]), int(cand_node[p, c])] = True
    return out


def delta_kernels(dev) -> dict:
    """Kernels 7 and 18 at every shape ``chip_smoke.py``'s main path gives
    them (:func:`recorded_deltas`), kernel 7 also at kernel 3's nine
    recorded shapes (kernel 3's own outputs as the previous generation,
    :func:`drained_cell` in ``node_changed``), and kernels 3 and 13 at
    their recorded shapes beside them: per launch back to back and queued
    behind a busy kernel, and per call of the entry point.  Bounds:
    kernel 7 ``chip_smoke.delta_bytes`` (kernel 3's count, the ``prev_*``
    tables, the ``node_changed`` cells its ok slots name, ``changed``;
    null where the checkout's ``chip_smoke`` lacks it) beside the parent's
    count (every argument and output whole); kernel 18 the indices and
    each gathered row read and written once.  Kernel 18 also beside its
    library call, a ``torch.index_select`` a table (where the checkout has
    no kernel 18, its gather is that call and is timed per call only)."""
    import chip_smoke as cs
    from openr_tpu_torch.ops import route_select as rs

    def timings(key, launch, call, t_bytes=None, ops=0):
        if t_bytes is not None:
            out[f"{key} bound ms"] = bound_ms(t_bytes, ops)
        if launch is not None:
            out[key] = launch_ms(launch)
            out[f"{key}, queued"] = cs.queued_ms(launch)
        out[f"{key}, per call"] = launch_ms(call)

    def kernel7(label, args):
        key = f"multi_area_select_delta_from_tables {label}"
        launch, outs = rs.multi_area_select_delta_from_tables_launcher(*args)
        launch()
        P, C = args[4].shape
        A, V, D = args[1].shape
        out[f"{key} P,C,A,V,D"] = [P, C, A, V, D]
        out[f"{key} rows flagged"] = int(outs[4].sum())
        ops = cs.select_ops(P, C, A, D) + P * (2 * C + A * (4 + D) + C * A)
        out[f"{key} parent's count: bound ms"] = bound_ms(cs.nbytes(*args, *outs), ops)
        t_bytes = cs.delta_bytes(args, outs) if hasattr(cs, "delta_bytes") else None
        timings(key, launch, lambda: rs.multi_area_select_delta_from_tables(*args), t_bytes, ops)

    out = {}
    selects, deltas, gathers = recorded_deltas()
    for label, args in deltas.items():
        kernel7(label, args)
    for label, args in selects.items():
        key = f"multi_area_select_from_tables {label}"
        launch, outs = rs.multi_area_select_from_tables_launcher(*args)
        launch()
        P, C = args[4].shape
        A, V, D = args[1].shape
        view = (args[0][None], args[1][None], *args[2:12])
        timings(key, launch, lambda: rs.multi_area_select_from_tables(*args),
                cs.select_bytes(view, {}, tuple(o[None] for o in outs), ok_only=True),
                cs.select_ops(P, C, A, D))
        prev = tuple(o.clone() for o in outs)
        kernel7(f"on kernel 3's {label}", (*args[:12], *prev, drained_cell(args), args[12]))
    for label, args in gathers.items():
        key = f"gather_selection_rows {label}"
        G = args[4].numel()
        out[f"{key} G,row bytes"] = [G, *(t[0].numel() * t.element_size() for t in args[:4])]
        if hasattr(rs, "gather_selection_rows_launcher"):
            launch, outs = rs.gather_selection_rows_launcher(*args)
            launch()
        else:
            launch, outs = None, rs.gather_selection_rows(*args)
        timings(key, launch, lambda: rs.gather_selection_rows(*args),
                cs.nbytes(args[4]) + 2 * cs.nbytes(*outs))
        out[f"{key}, library"] = launch_ms(
            lambda: [torch.index_select(t, 0, args[4]) for t in args[:4]])
    for label, (args, kw) in recorded_selects(dev).items():
        key = f"fleet_select {label}"
        B, A, _V = args[0].shape
        P, C = args[4].shape
        launch, outs = rs.fleet_select_launcher(*args, **kw)
        launch()
        timings(key, launch, lambda: rs.fleet_select(*args, **kw), cs.select_bytes(args, kw, outs),
                B * cs.select_ops(P, C, A, args[1].shape[-1]))
    return out



def repair_inputs(dev) -> dict:
    """label -> the arguments of ``CudaBackend._subgraph_tables`` where the
    main path runs kernel 6: the grid's weakening tick
    (:func:`grid_warm_ticks`) and, where one exists among the first 16 of
    :func:`backbone_weakenings`, the first that the planner sends to the
    bounded repair."""
    out = {}
    for tick, be in grid_warm_ticks():
        if tick == "grid weakening":
            out[tick] = be.io["sub"][0]
            break
    for _, be in zip(range(16), backbone_weakenings()):
        if "sub" in be.io:
            out["(g) weakening"] = be.io["sub"][0]
            break
    return out


def recorded_compacts(dev) -> dict:
    """label -> [(args, kwargs, count)] of kernel 11's calls
    (``compact_deltas``) in each what-if phase of ``chip_smoke.py``, run
    through its own helpers as :func:`recorded_chunks` runs them."""
    import chip_smoke as cs
    from openr_tpu_torch.decision import whatif_api
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.ops import sweep_select
    from openr_tpu_torch.ops import whatif as whatif_ops

    calls = []
    real = sweep_select.compact_deltas

    def record(*args, **kwargs):
        outs = real(*args, **kwargs)
        calls.append((args, kwargs, outs))
        return outs

    def take(run):
        calls.clear()
        run()
        torch.cuda.synchronize()
        return [(args, kw, int(outs[0][0])) for args, kw, outs in calls]

    sweep_select.compact_deltas = record
    out = {}
    try:
        ls, ps, topo = cs.headline_world()
        fails = cs.headline_failures(topo)
        out["(a)"] = take(lambda: cs.headline_sweep(
            topo, whatif_ops.LinkFailureSweep(topo, "node0", device=dev), fails, device=dev))
        engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
        out["(b)"] = take(lambda: cs.criticality(engine, ls, ps))
        _dbs, areas, gps = cs.grid_world()
        query, sim = cs.grid_queries(areas, np.random.default_rng(0))
        grid_engine = whatif_api.WhatIfApiEngine(SpfSolver("node0"))
        out["(c)"] = take(lambda: grid_engine.run(query, areas, gps, 1))
        out["(c) set of 3"] = take(
            lambda: grid_engine.run(sim, areas, gps, 1, simultaneous=True))
    finally:
        sweep_select.compact_deltas = real
    return out


def repair_compact_kernels(dev) -> dict:
    """Kernels 6 and 11 at every shape ``chip_smoke.py`` gives them
    (:func:`repair_inputs`, :func:`recorded_compacts`): per launch back to
    back and queued, per call of the entry point (kernel 6 also per bind),
    with each shape's bound (``chip_smoke``'s counts: kernel 6 its inputs
    and tables once and one relaxation per usable sub-edge; kernel 11 the
    changed words and row ids, the min(count, cap) rows it copies and its
    outputs once)."""
    import chip_smoke as cs
    from openr_tpu_torch.ops import sweep_select

    def timings(key, launch, call, t_bytes, ops):
        out[f"{key} bound ms"] = bound_ms(t_bytes, ops)
        out[key] = launch_ms(launch)
        out[f"{key}, queued"] = cs.queued_ms(launch)
        out[f"{key}, per call"] = launch_ms(call)

    out = {}
    shapes = repair_inputs(dev)
    out["warm_subgraph_repair ((g) weakening) found"] = "(g) weakening" in shapes
    for label, args in shapes.items():
        key = f"warm_subgraph_repair ({label})"
        src_sub, _dst, _w, ok_sub, rank_sub, prev_dist, _nh, reset, D = args
        launch, outs = spf.warm_subgraph_repair_launcher(*args)
        launch()
        _d, _n, r_d, r_l = spf.warm_subgraph_repair_plain(*args, unroll=1)
        out[f"{key} A,V,Es,D,reset"] = [*reset.shape, src_sub.shape[1], D, int(reset.sum())]
        out[f"{key} rounds d,l (synchronous)"] = [int(r_d.max()), int(r_l.max())]
        out[f"{key} kernel rounds d,l"] = [int(outs[2].max()), int(outs[3].max())]
        usable = ok_sub.sum(dim=1)
        lanes = (rank_sub >= 0).sum(dim=1).clamp(max=D)
        timings(key, launch, lambda: spf.warm_subgraph_repair(*args),
                cs.nbytes(*args[:-1], outs[0], outs[1]),
                int((2 * usable + usable * lanes).sum()))
        out[f"{key}, bind (host)"] = bind_ms(lambda: spf.warm_subgraph_repair_launcher(*args))
    for label, calls in recorded_compacts(dev).items():
        for i, (args, kw, count) in enumerate(calls):
            changed, valid, _metric, lanes, row_id, cap = args
            R, P = valid.shape
            Dw = lanes.shape[2]
            key = f"compact_deltas {label} call {i + 1}"
            launch, outs = sweep_select.compact_deltas_launcher(*args)
            launch()
            out[f"{key} R,P,Dw,cap,count"] = [R, P, Dw, cap, count]
            t_bytes = cs.nbytes(changed, row_id) + min(count, cap) * (1 + 4 + 4 * Dw) + cs.nbytes(*outs)
            timings(key, launch, lambda: sweep_select.compact_deltas(*args, **kw), t_bytes,
                    3 * changed.numel())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_batch_kernels: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    groups = sys.argv[1:] or ["fleet", "hub", "rows", "cold", "masked", "fattree", "flagship",
                              "repair", "dense", "select", "sweep", "reset", "chunkwarm",
                              "selection", "repaircompact", "delta"]
    out = {"card": card}
    if "fleet" in groups:
        out.update(fleet_kernels(dev))
    if "hub" in groups:
        out.update(hub_kernel(dev))
    if "rows" in groups:
        out.update(rows_kernel(dev))
    if "cold" in groups:
        out.update(cold_kernel(dev))
    if "masked" in groups and hasattr(spf, "spf_distances_masked_launcher"):
        out.update(masked_kernel(dev))
    if "fattree" in groups:
        out.update(fattree_kernel(dev))
    if "flagship" in groups:
        out.update(flagship_kernel(dev))
    if "repair" in groups:
        out.update(repair_kernel(dev))
    if "dense" in groups:
        out.update(dense_kernel(dev))
    if "select" in groups:
        out.update(select_kernel(dev))
    if "sweep" in groups:
        out.update(sweep_kernel(dev))
    if "reset" in groups:
        out.update(reset_kernel(dev))
    if "chunkwarm" in groups:
        out.update(chunk_warm_kernels(dev))
    if "selection" in groups:
        out.update(selection_kernels(dev))
    if "repaircompact" in groups:
        out.update(repair_compact_kernels(dev))
    if "delta" in groups:
        out.update(delta_kernels(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
