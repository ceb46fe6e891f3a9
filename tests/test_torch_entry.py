"""The port's flagship entry (``openr_tpu_torch/graft_entry.py``) against
the repository root's ``__graft_entry__.py`` (imported, not edited), on the
CPU: the problem's arrays, the forward step's five outputs, and every row
of an 8x8-grid problem against the scalar route oracle (the port's and the
reference's).  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from openr_tpu_torch import graft_entry
from openr_tpu_torch.ops.consts import BIG


@pytest.mark.parametrize("batch,grid", [(4, 4), (7, 5)])
def test_build_problem_equals_reference_problem(batch, grid):
    want, want_d, _ls, want_topo, _c = ref_entry._build_problem(batch=batch, grid=grid)
    got, got_d, _ls2, got_topo, _c2 = graft_entry.build_problem(batch, grid, device="cpu")
    assert got_d == want_d
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    assert [l.key for l in got_topo.links] == [l.key for l in want_topo.links]


def test_entry_forward_equals_reference_forward():
    ref_forward, ref_args = ref_entry.entry()
    want = ref_forward(*ref_args)
    forward, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = forward(*args)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_every_row_of_the_8x8_grid_problem_equals_scalar_oracle():
    """One snapshot per link of the 8x8 grid (the reference dry run's
    world): every row and prefix against the scalar oracle, the port's and
    the reference's (on the reference's LinkState)."""
    _a, _d, ref_ls, ref_topo, _c = ref_entry._build_problem(batch=1, grid=8)
    L = len(ref_topo.links)
    args, D, ls, topo, cands = graft_entry.build_problem(L, grid=8, device="cpu")
    valid, metric, lanes, num, _use = graft_entry.spf_and_select(*args, max_degree=D)
    out_edges = topo.root_out_edges("node0")
    cache, ref_cache = {}, {}
    checked = 0
    for b in range(L):
        link = topo.links[b]
        for p in range(cands.num_prefixes):
            node = topo.id_to_node[int(cands.cand_node[p, 0])]
            want_metric, want_hops = graft_entry.scalar_route_oracle(
                ls, topo, "node0", link, node, cache
            )
            ref_metric, ref_hops = ref_entry._scalar_route_oracle(
                ref_ls, ref_topo, "node0", ref_topo.links[b], node, ref_cache
            )
            assert (want_metric, want_hops) == (ref_metric, ref_hops)
            if want_metric is None:
                assert not valid[b, p] and metric[b, p] >= BIG
                continue
            assert valid[b, p] and metric[b, p] == want_metric
            hops = {out_edges[r][1] for r in torch.nonzero(lanes[b, p] > 0).flatten().tolist()}
            assert hops == want_hops and int(num[b, p]) == len(hops)
            checked += 1
    assert checked == 2 * L


def test_scalar_oracle_takes_no_first_hop_through_a_drained_neighbour():
    """A hard-drained neighbour of the root is a first hop to itself only."""
    from openr_tpu_torch.decision.link_state import LinkState
    from openr_tpu_torch.emulation.topology import build_adj_dbs
    from openr_tpu_torch.ops.csr import encode_link_state

    edges = [("a", "b", 1), ("b", "d", 1), ("a", "c", 1), ("c", "d", 1)]
    ls = LinkState("0")
    for db in build_adj_dbs(edges, overloaded=["b"]).values():
        ls.update_adjacency_database(db)
    topo = encode_link_state(ls)
    assert graft_entry.scalar_route_oracle(ls, topo, "a", None, "d") == (2, {"c"})
    assert graft_entry.scalar_route_oracle(ls, topo, "a", None, "b") == (1, {"b"})
    res = ls.run_spf("a")
    assert res["d"].metric == 2 and res["d"].next_hops == {"c"}
