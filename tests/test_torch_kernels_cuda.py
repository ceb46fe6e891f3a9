"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (the kernels have no CPU mode, so every test here skips without
one).  The plain versions are held against the JAX reference by the CPU
tests (``test_torch_spf.py``, ``test_torch_select.py``,
``test_torch_backend.py``); this file imports no JAX, so it runs on a
machine that has none:

    OPENR_TPU_TEST_PLATFORM=gpu python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerance: exact equality on every output.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS, CudaBackend
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import route_db_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.emulation.topology import (
    build_adj_dbs,
    grid_edges,
    random_connected_edges,
)
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops import route_select as rs
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.types import PrefixEntry, RouteComputationRules

pytestmark = pytest.mark.cuda

FIELDS = ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _areas(world):
    me = "me"
    if world == "grid":
        edges = {"0": grid_edges(12) + [("node0", me, 1)]}
        drains = {"0": dict(overloaded=["node13"], soft_drained={"node40": 9})}
    else:  # multi-area with an area where me has no adjacencies
        edges = {
            "1": random_connected_edges(30, 20, seed=3, prefix="a") + [("a0", me, 2)],
            "2": random_connected_edges(20, 10, seed=4, prefix="b"),
        }
        drains = {"1": dict(overloaded=["a7"]), "2": {}}
    areas = {}
    for a, e in edges.items():
        ls = LinkState(a, me)
        for db in build_adj_dbs(e, area=a, **drains[a]).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    return areas, me


@pytest.mark.parametrize("world", ["grid", "multiarea_isolated"])
def test_spf_kernels_equal_plain(card, world):
    areas, me = _areas(world)
    enc = csr.encode_multi_area(areas, me)
    planes = tables_from_numpy([getattr(enc, f) for f in FIELDS], card)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    reset_launch_counts()
    dist, nh = spf.dense_spf_one(*planes, max_degree=D)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_spf_distances"] == 1
    assert LAUNCHES["dense_spf_nexthop_lanes"] == 1
    in_src, in_w, in_ok, in_rank, in_has, ovl, roots = planes
    want_d = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    want_n = spf.dense_spf_nexthop_lanes_plain(*planes, want_d, D)
    assert torch.equal(dist, want_d)
    assert torch.equal(nh, want_n)
    if world == "multiarea_isolated":
        assert bool((nh == -128).any())


def _select_inputs(seed, A=3, V=64, D=4, P=4096, C=8):
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 40, (A, V)).astype(np.float32)
    dist[rng.random((A, V)) < 0.2] = BIG
    nh = (rng.random((A, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((A, V)) < 0.1] = -128
    overloaded = rng.random((A, V)) < 0.2
    soft = np.where(rng.random((A, V)) < 0.2, 3, 0).astype(np.int32)
    cand_area = rng.integers(0, A, (P, C)).astype(np.int32)
    cand_node = rng.integers(0, V, (P, C)).astype(np.int32)
    cand_ok = rng.random((P, C)) < 0.8
    cand_ok[-64:] = False
    overloaded[cand_area[:64], cand_node[:64]] = True
    cnia = rng.integers(-1, V, (P, C, A)).astype(np.int32)
    cnia[np.arange(P)[:, None], np.arange(C)[None, :], cand_area] = cand_node
    ints = [rng.choice(vals, (P, C)).astype(np.int32)
            for vals in ([0, 0, 0, 1], [100, 200], [1, 2], [1, 2, 3])]
    return (dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, *ints, cnia)


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_kernel_equals_plain(card, seed, per_area):
    args = tables_from_numpy(_select_inputs(seed), card)
    reset_launch_counts()
    got = rs.multi_area_select_from_tables(*args, per_area)
    torch.cuda.synchronize()
    assert LAUNCHES["multi_area_select_from_tables"] == 1
    want = rs.multi_area_select_from_tables_plain(*args, per_area)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("algo", list(RouteComputationRules))
def test_backend_on_card_equals_scalar(card, algo):
    areas, me = _areas("multiarea_isolated")
    ps = PrefixState()
    for i in range(30):
        ps.update_prefix(f"a{i}", "1", PrefixEntry(f"10.1.{i}.0/24"))
    for i in range(20):
        ps.update_prefix(f"b{i}", "2", PrefixEntry(f"10.2.{i}.0/24"))
    ps.update_prefix(me, "2", PrefixEntry("10.1.3.0/24"))  # self in isolated area
    solver = SpfSolver(me, route_selection_algorithm=algo)
    backend = CudaBackend(SpfSolver(me, route_selection_algorithm=algo), device=card)
    got = backend.build_route_db(areas, ps)
    assert route_db_summary(got) == route_db_summary(solver.build_route_db(areas, ps))
