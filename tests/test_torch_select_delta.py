"""The port's fused selection + generation delta and its row gather
against the JAX package's ``multi_area_select_delta_from_tables`` and
``gather_selection_rows``, bit for bit, on seeded numpy inputs; then the
delta branch of ``CudaBackend`` (CPU) against ``TpuBackend`` and the
scalar ``SpfSolver`` on a 3-area world through unhinted drain ticks.

The previous generation's outputs come from the reference's selection on
perturbed tables, so some rows differ and some do not; ``node_changed``
flips drain state on a few nodes, own-area and cross-area.  Tolerance:
exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from openr_tpu.config import ResilienceConfig
from openr_tpu.decision.backend import TpuBackend
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.ops import route_select as jrs
from openr_tpu.types import PrefixEntry, PrefixMetrics, RouteComputationRules
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import route_select as trs
from openr_tpu_torch.ops.consts import BIG
from test_torch_warm import Prefixes, multiarea_world


def _inputs(seed, A=3, V=32, D=4, P=512, C=6):
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 12, (A, V)).astype(np.float32)
    dist[rng.random((A, V)) < 0.2] = BIG
    nh = (rng.random((A, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((A, V)) < 0.1] = -128
    overloaded = rng.random((A, V)) < 0.2
    soft = np.where(rng.random((A, V)) < 0.2, 5, 0).astype(np.int32)
    cand_area = rng.integers(0, A, (P, C)).astype(np.int32)
    cand_node = rng.integers(0, V, (P, C)).astype(np.int32)
    cand_ok = rng.random((P, C)) < 0.85
    cand_ok[-8:] = False
    cnia = rng.integers(-1, V, (P, C, A)).astype(np.int32)
    cnia[np.arange(P)[:, None], np.arange(C)[None, :], cand_area] = cand_node
    ints = [
        rng.choice(vals, (P, C)).astype(np.int32)
        for vals in ([0, 0, 0, 1], [100, 200], [1, 2], [1, 2, 3])
    ]
    tables = (dist, nh, overloaded, soft)
    cand = (cand_area, cand_node, cand_ok, *ints, cnia)
    # the previous generation: the same candidates on perturbed tables
    prev_dist = np.where(rng.random((A, V)) < 0.1, dist + 1, dist).astype(np.float32)
    prev_nh = np.where(rng.random((A, V, D)) < 0.05, 1 - np.abs(nh), nh).astype(np.int8)
    node_changed = rng.random((A, V)) < 0.03
    return tables, cand, (prev_dist, prev_nh), node_changed


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_delta_matches_reference(seed, per_area):
    tables, cand, (prev_dist, prev_nh), node_changed = _inputs(seed)
    ovl, soft = tables[2], tables[3]
    prev = jrs.multi_area_select_from_tables(
        *(jnp.asarray(a) for a in (prev_dist, prev_nh, ovl, soft, *cand)),
        per_area_distance=per_area,
    )
    prev = [np.array(p) for p in prev]
    args = (*tables, *cand, *prev, node_changed)
    want = jrs.multi_area_select_delta_from_tables(
        *(jnp.asarray(a) for a in args), per_area_distance=per_area
    )
    reset_launch_counts()
    got = trs.multi_area_select_delta_from_tables(*tables_from_numpy(args), per_area)
    assert all(v == 0 for v in LAUNCHES.values())  # the CPU runs the plain version
    assert len(got) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    changed = got[4].numpy()
    # some rows moved, some did not, and drain touches alone flag rows
    assert 0 < changed.sum() < len(changed)
    same = trs.multi_area_select_delta_from_tables(
        *tables_from_numpy((*tables, *cand, *(np.array(w) for w in want[:4]),
                            np.zeros_like(node_changed))),
        per_area,
    )
    assert not same[4].any()
    touched = trs.multi_area_select_delta_from_tables(
        *tables_from_numpy((*tables, *cand, *(np.array(w) for w in want[:4]),
                            node_changed)),
        per_area,
    )
    assert touched[4].any()


def test_gather_selection_rows_matches_reference():
    tables, cand, _prev, _nc = _inputs(3)
    outs = jrs.multi_area_select_from_tables(
        *(jnp.asarray(a) for a in (*tables, *cand)), per_area_distance=False
    )
    idx = np.array([5, 0, 511, 17, 17, 0, 0, 0], np.int64)
    want = jrs.gather_selection_rows(*outs, jnp.asarray(idx))
    got = trs.gather_selection_rows(
        *tables_from_numpy([np.array(o) for o in outs]), *tables_from_numpy([idx])
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("algo", ["SHORTEST_DISTANCE", "PER_AREA_SHORTEST_DISTANCE"])
def test_backend_delta_branch_on_drain_ticks(algo):
    """Unhinted drain ticks with exact (empty or withdrawal) churn: the
    first full build keeps its outputs, every later one diffs against
    them; a drained advertiser's own route re-decodes as a drained entry."""
    wd = multiarea_world()
    ps = Prefixes()
    for area in ("1", "2", "3"):
        for node in sorted(wd.adj[area]):
            if node != "me":
                ps.add(node, area, PrefixEntry(f"10.{area}.{node[1:]}.0/24"))
    for node, area, d in (("a9", "1", 2), ("b3", "2", 1), ("w2", "3", 2)):
        ps.add(node, area, PrefixEntry("10.9.0.0/16", metrics=PrefixMetrics(distance=d)))
    rule = getattr(RouteComputationRules, algo)
    me = wd.me
    tpu = TpuBackend(
        SpfSolver(me, route_selection_algorithm=rule),
        resilience=ResilienceConfig(enabled=False),
    )
    port = CudaBackend(
        PortSolver(me, route_selection_algorithm=ttypes.RouteComputationRules(int(rule))),
        device="cpu",
    )
    ticks = [
        ("1", "a9", None),  # drain an advertiser of the anycast prefix
        ("2", "b5", None),  # its own route re-decodes as a drained entry
        ("2", "b4", "10.2.4.0/24"),  # a drain and a withdrawal together
        ("1", "a9", None),  # undrain
    ]
    hints = dict(force_full=True)
    for i, tick in enumerate([None] + ticks):
        changed = set()
        if tick is not None:
            area, node, withdraw = tick
            wd.flip_overload(area, node)
            if withdraw:
                changed |= ps.withdraw(node, area, withdraw)
            hints = dict(changed_prefixes=changed, force_full=True)
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        want = ref_summary(SpfSolver(me, route_selection_algorithm=rule).build_route_db(wd.ref, ps.ref))
        assert ref_summary(db_t) == want and port_summary(db_p) == want, i
        got_changed = port.take_last_changed_prefixes()
        assert got_changed == tpu.take_last_changed_prefixes(), i
        assert port.num_delta_builds == tpu.num_delta_builds, i
        if i == 2:
            route = db_p.unicast_routes["10.2.5.0/24"]
            assert "10.2.5.0/24" in got_changed
            assert route.best_prefix_entry.metrics.drain_metric == 1
    assert port.num_delta_builds == len(ticks)
