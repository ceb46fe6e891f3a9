#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openr_tpu_torch``) on one card.

Drives the port's main path — the Decision cold route build,
``CudaBackend.build_route_db`` — through a few requests on a 4096-node
grid with 100 prefixes per node (409,600 prefixes), then on a small
3-area world once per selection algorithm:

  1. a cold build
  2. a rebuild after a link metric change
  3. a rebuild after a node is hard-drained (overloaded)
  4. the 3-area world, SHORTEST_DISTANCE and PER_AREA_SHORTEST_DISTANCE

The CUDA kernels are built from ``openr_tpu_torch/kernels/csrc`` at first
use.  Every build checks, with exact equality:
  * each kernel against its plain PyTorch version on the card, on the
    inputs the build gave it (dist/nh bit-equal, all four selection
    outputs bit-equal)
  * the RouteDb (``route_db_summary``) against a backend that runs the
    plain versions on the card
  * ~200 sampled prefixes (all of them on the small world) against the
    scalar ``SpfSolver.create_route_for_prefix`` oracle
and that the build launched every kernel (launch counts are reset just
before each build and read just after).  Any mismatch or exception exits
non-zero.

Prints the kernel and phase times with the card's name and power limit,
a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb, route_db_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.emulation.topology import (
    build_adj_dbs,
    grid_edges,
    random_connected_edges,
)
from openr_tpu_torch.kernels import KERNEL_NAMES, LAUNCHES, build, reset_launch_counts
from openr_tpu_torch.ops import route_select as rs
from openr_tpu_torch.ops import spf
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.types import PrefixEntry, PrefixMetrics, RouteComputationRules

#: the main path's world: grid_edges(64), 4096 nodes, 100 prefixes each
GRID_SIDE = 64
PREFIXES_PER_NODE = 100

#: back-to-back launches per timed span, and timed spans per figure
TIMED_LAUNCHES = 50
TIMED_SPANS = 5

#: NVIDIA H100 SXM data-sheet peaks (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores; used for int ALU work too

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
}


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


class KernelPath(CudaBackend):
    """The port's backend, recording the inputs and outputs its kernels
    saw so they can be held against the plain versions afterwards."""

    def _spf_tables(self, *args):
        out = super()._spf_tables(*args)
        self.spf_io = (args, out)
        return out

    def _select(self, *args):
        out = super()._select(*args)
        self.select_io = (args, out)
        return out


class PlainPath(CudaBackend):
    """The same build with the kernels' plain PyTorch versions, on the card."""

    def _spf_tables(self, in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D):
        dist = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
        nh = spf.dense_spf_nexthop_lanes_plain(
            in_src, in_w, in_ok, in_rank, in_has, ovl, roots, dist, D
        )
        return dist, nh

    def _select(self, *args):
        return rs.multi_area_select_from_tables_plain(*args)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def per_launch_ms(fn):
    """Median over TIMED_SPANS of (device ms, host-issue ms) per call of
    ``fn``: CUDA events around TIMED_LAUNCHES back-to-back calls, divided
    by the count.  Given a pre-bound kernel launch (no checks, allocation
    or binding between launches) the device figure is the kernel's own
    time unless the host issue time per launch reaches it."""
    fn()  # warm-up
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(TIMED_SPANS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(TIMED_LAUNCHES):
            fn()
        issued = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / TIMED_LAUNCHES)
        host.append(issued * 1e3 / TIMED_LAUNCHES)
    return statistics.median(dev), statistics.median(host)


def plain_ms(fn):
    """Median CUDA-event ms of one call of a plain version (its host
    work and synchronizes included: that is what the plain version
    costs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_SPANS):
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
    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    if a.dtype == torch.float32:
        same = (a == b) | (torch.isinf(a) & torch.isinf(b) & (a.sign() == b.sign()))
        if bool(same.all()):
            return 0.0
        return float((a.double() - b.double()).abs().max().item())
    return float((a.int() - b.int()).abs().max().item())


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class KernelReport:
    def __init__(self):
        self.launches = {n: 0 for n in KERNEL_NAMES}
        self.err = {n: 0.0 for n in KERNEL_NAMES}
        self.timing = {}

    def kernel_checks(self, backend, timed):
        """Hold each kernel against its plain version on the inputs the
        build gave it; time both on the first (main-shape) build."""
        spf_args, (dist_main, nh_main) = backend.spf_io
        in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D = spf_args
        planes = (in_src, in_w, in_ok, in_rank, in_has, ovl, roots)

        def k_dist():
            return spf.dense_spf_distances_cuda(in_src, in_w, in_ok, ovl, roots)

        def p_dist():
            return spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)

        dist_k, dist_p = k_dist(), p_dist()
        e = max(max_abs_err(dist_k, dist_p), max_abs_err(dist_main, dist_p))
        check(e == 0.0, f"dense_spf_distances kernel != plain (err {e})")
        self.err["dense_spf_distances"] = max(self.err["dense_spf_distances"], e)

        def k_nh():
            return spf.dense_spf_nexthop_lanes_cuda(*planes, dist_p, D)

        def p_nh():
            return spf.dense_spf_nexthop_lanes_plain(*planes, dist_p, D)

        nh_k, nh_p = k_nh(), p_nh()
        e = max(max_abs_err(nh_k, nh_p), max_abs_err(nh_main, nh_p))
        check(e == 0.0, f"dense_spf_nexthop_lanes kernel != plain (err {e})")
        self.err["dense_spf_nexthop_lanes"] = max(self.err["dense_spf_nexthop_lanes"], e)

        sel_args, sel_main = backend.select_io

        def k_sel():
            return rs.multi_area_select_from_tables_cuda(*sel_args)

        def p_sel():
            return rs.multi_area_select_from_tables_plain(*sel_args)

        e = 0.0
        for k, p, m in zip(k_sel(), p_sel(), sel_main):
            e = max(e, max_abs_err(k, p), max_abs_err(m, p))
        check(e == 0.0, f"multi_area_select_from_tables kernel != plain (err {e})")
        self.err["multi_area_select_from_tables"] = max(
            self.err["multi_area_select_from_tables"], e
        )
        if not timed:
            return
        A, V, K = in_src.shape
        r_d = relax_rounds(in_src, in_w, in_ok, ovl, roots)
        r_l = lane_rounds(planes, dist_p)
        sel_in = nbytes(*(t for t in sel_args if isinstance(t, torch.Tensor)))
        sel_out = nbytes(*sel_main)
        P, C = sel_args[4].shape
        launch_d, _ = spf.dense_spf_distances_launcher(in_src, in_w, in_ok, ovl, roots)
        launch_n, _ = spf.dense_spf_nexthop_lanes_launcher(*planes, dist_p, D)
        launch_s, _ = rs.multi_area_select_from_tables_launcher(*sel_args)
        ms = {
            "dense_spf_distances": per_launch_ms(launch_d),
            "dense_spf_nexthop_lanes": per_launch_ms(launch_n),
            "multi_area_select_from_tables": per_launch_ms(launch_s),
        }
        self.timing = {
            "dense_spf_distances": dict(
                ms=ms["dense_spf_distances"][0],
                host_issue_ms=ms["dense_spf_distances"][1],
                plain_ms=plain_ms(p_dist),
                bytes=nbytes(in_src, in_w, in_ok, ovl, roots, dist_p),
                ops=2 * r_d * A * V * K,
                per_round_bytes=nbytes(in_src, in_w, in_ok) + 2 * nbytes(dist_p),
                rounds=r_d,
            ),
            "dense_spf_nexthop_lanes": dict(
                ms=ms["dense_spf_nexthop_lanes"][0],
                host_issue_ms=ms["dense_spf_nexthop_lanes"][1],
                plain_ms=plain_ms(p_nh),
                bytes=nbytes(*planes, dist_p, nh_p),
                ops=2 * r_l * A * V * K * D,
                per_round_bytes=A * V * K * 5 + 2 * nbytes(nh_p),
                rounds=r_l,
            ),
            "multi_area_select_from_tables": dict(
                ms=ms["multi_area_select_from_tables"][0],
                host_issue_ms=ms["multi_area_select_from_tables"][1],
                plain_ms=plain_ms(p_sel),
                bytes=sel_in + sel_out,
                # ~8 compare/select ops per candidate per chain stage,
                # plus the per-area lane sums
                ops=P * C * (48 + A * (4 + D)),
                per_round_bytes=sel_in + sel_out,
                rounds=1,
            ),
        }

    def json_line(self):
        rows = []
        for name in KERNEL_NAMES:
            t = self.timing[name]
            t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = t["ops"] / F32_OPS_PER_S * 1e3
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
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None,
                }
            )
        return json.dumps({"kernels": rows})


def drive(report, kernel_be, plain_be, oracle, areas, ps, label, rng, sample, timed=False):
    """One request through the port's main path plus its checks."""
    reset_launch_counts()
    t0 = time.perf_counter()
    db = kernel_be.build_route_db(areas, ps)
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(LAUNCHES)
    for name in KERNEL_NAMES:
        check(counts[name] >= 1, f"{label}: kernel {name} was not launched")
        report.launches[name] += counts[name]
    phases = " ".join(f"{k}={v:.1f}ms" for k, v in kernel_be.last_phase_ms.items())
    print(f"[{label}] build wall={wall:.1f}ms {phases} launches={counts} "
          f"routes={len(db.unicast_routes)}", flush=True)

    report.kernel_checks(kernel_be, timed)
    plain_db = plain_be.build_route_db(areas, ps)
    want = route_db_summary(db)
    check(route_db_summary(plain_db) == want, f"{label}: RouteDb != plain-path RouteDb")

    prefixes = sorted(ps.prefixes())
    picks = prefixes if sample is None else [
        prefixes[i] for i in rng.choice(len(prefixes), sample, replace=False)
    ]
    got, ref = DecisionRouteDb(), DecisionRouteDb()
    for p in picks:
        if p in db.unicast_routes:
            got.add_unicast_route(db.unicast_routes[p])
        entry = oracle.create_route_for_prefix(p, areas, ps)
        if entry is not None:
            ref.add_unicast_route(entry)
    check(route_db_summary(got) == route_db_summary(ref), f"{label}: scalar oracle mismatch")
    check(len(got.unicast_routes) > 0, f"{label}: sampled prefixes produced no routes")
    print(f"[{label}] kernels == plain, RouteDb == plain path, "
          f"{len(picks)} prefixes == scalar oracle", flush=True)
    return db


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
    kernel_be = KernelPath(SpfSolver("node0"))
    plain_be = PlainPath(SpfSolver("node0"))
    oracle = SpfSolver("node0")
    common = dict(rng=rng, sample=200)
    drive(report, kernel_be, plain_be, oracle, areas, ps, "cold", timed=True, **common)

    # 2. a link metric change in the middle of the grid
    mid = f"node{n // 2 + GRID_SIDE // 2}"
    db = dbs[mid]
    adj = db.adjacencies[0]
    new_adj = dataclasses.replace(adj, metric=adj.metric + 4)
    new_db = dataclasses.replace(db, adjacencies=[new_adj] + db.adjacencies[1:])
    areas["0"].update_adjacency_database(new_db)
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"metric:{mid}->{adj.other_node_name}", **common)

    # 3. a hard-drained node next to me
    drained = "node1"
    areas["0"].update_adjacency_database(dataclasses.replace(dbs[drained], is_overloaded=True))
    drive(report, kernel_be, plain_be, oracle, areas, ps, f"overload:{drained}", **common)

    # 4. a 3-area world, once per selection algorithm
    for algo in (
        RouteComputationRules.SHORTEST_DISTANCE,
        RouteComputationRules.PER_AREA_SHORTEST_DISTANCE,
    ):
        a3, ps3, me = three_area_world()
        kb = KernelPath(SpfSolver(me, route_selection_algorithm=algo))
        pb = PlainPath(SpfSolver(me, route_selection_algorithm=algo))
        oracle3 = SpfSolver(me, route_selection_algorithm=algo)
        drive(report, kb, pb, oracle3, a3, ps3, f"3-area:{algo.name}", rng=rng, sample=None)

    for name in KERNEL_NAMES:
        t = report.timing[name]
        bound_rounds_ms = t["per_round_bytes"] * t["rounds"] / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name}: {t['ms']:.4f} ms per launch over {TIMED_LAUNCHES} "
              f"back-to-back launches (host issue {t['host_issue_ms']:.4f} ms per launch), "
              f"plain {t['plain_ms']:.4f} ms, "
              f"rounds {t['rounds']}, bytes-per-round x rounds bound {bound_rounds_ms:.5f} ms "
              f"({smi})", flush=True)
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
