"""Kernel 5 (``spf_nexthop_lanes_reset``) as redesigned for the card: a
torch model of its packed layout and its OR rounds, held against the
port's plain version and the JAX package's ``spf_nexthop_lanes_reset``
(``openr_tpu/ops/spf.py:493``), area by area.

* The layout, per area: every in-edge classified once against the
  distances; a shortest-path-DAG edge out of the root sets the seed bit of
  its rank in its head's lane words (ceil(D / 32) uint32 a vertex), any
  other DAG edge counts a propagating source of its head; the moving
  vertices (a propagating source at least) are listed with the offsets of
  their packed sources.
* The rounds OR the sources' words into the moving vertices' words, over
  the words a seed can reach only (lanes below 1 + the highest seeded
  rank), until nothing changes; the int8 table is written once, -128 where
  the vertex's run is empty.  The seed ``nh0`` is never read: on the
  shortest-path DAG (every usable edge has w >= 1) the reset iteration has
  one fixed point, the least one above the seeds.
* Cases: the grid, an overloaded root, the 3-area world of
  ``tests/test_torch_warm.py`` (A > 1, an area whose root has no in-edge,
  a drained node), a WAN, a hub whose root has 40 lanes (D > 32), padded
  vertices with empty runs (-128); seeds all zero, random int8 (-128, 0,
  1) and the answer itself.

The ``cuda`` cases run kernel 5 against its plain version over the same
worlds and seeds on clusters of 1, 2, 4 and 8 blocks an area, with its
state and lists in shared memory, its lists in the global scratch, and
its whole state there (a budget of 0).  Tolerance: exact equality.  This module
imports no JAX at import time, so that its ``cuda`` cases run where JAX is
absent.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.emulation import topology as ttopo
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops.consts import BIG

SEG_FIELDS = ("src", "dst", "w", "edge_ok", "overloaded", "roots")


def _hub(leaves):
    """me joined to every leaf, the leaves on a ring: 40 root lanes."""
    return [("me", f"h{i}", 1 + i % 3) for i in range(leaves)] + [
        (f"h{i}", f"h{(i + 1) % leaves}", 2) for i in range(leaves)
    ]


WORLDS = {
    "grid": ({"0": ttopo.grid_edges(6, prefix="n") + [("n0", "me", 1), ("n5", "me", 1)]}, {}),
    "root_overloaded": ({"0": ttopo.grid_edges(5, prefix="n") + [("n0", "me", 1), ("n4", "me", 2)]},
                        {"0": {"overloaded": ["me", "n12"]}}),
    "multiarea": (
        {
            "1": ttopo.random_connected_edges(12, 8, seed=5, prefix="a") + [("a0", "me", 1)],
            "2": [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
            + [("b0", "me", 2), ("b3", "me", 3)],
            "3": [("w0", "w1", 1), ("w1", "w2", 2)],
        },
        {"1": {"overloaded": ["a4"]}, "2": {"soft_drained": {"b2": 5}}},
    ),
    "wan": ({"0": ttopo.random_connected_edges(40, 60, seed=11, prefix="n")
             + [("n0", "me", 1), ("n17", "me", 3)]}, {}),
    "hub40": ({"0": _hub(40)}, {}),
}


def encode(world):
    edges, drains = WORLDS[world]
    areas = {}
    for a, e in edges.items():
        ls = LinkState(a, "me")
        for db in ttopo.build_adj_dbs(e, area=a, **drains.get(a, {})).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    enc = csr.encode_multi_area(areas, "me")
    D = 40 if world == "hub40" else csr.bucket_for(max(enc.max_out_degree(), 1), (4, 8, 16, 32))
    return enc, D


def inputs(world):
    """(segment tensors, cold distances, D) of a world."""
    enc, D = encode(world)
    seg = tables_from_numpy([getattr(enc, f) for f in SEG_FIELDS])
    dist = spf.spf_distances_plain(*seg)
    return seg, dist, D


def seeds(shape, answer):
    rng = np.random.default_rng(5)
    return {
        "zero": torch.zeros(shape, dtype=torch.int8),
        "random": torch.from_numpy(rng.choice(np.array([-128, 0, 1], np.int8), size=shape)),
        "answer": answer.clone(),
    }


def packed_model(src, dst, w, edge_ok, overloaded, roots, dist, D):
    """Kernel 5, area by area: (nh [A, V, D] int8, the moving vertices of
    each area, the lanes its seeds reach)."""
    A, V = overloaded.shape
    W = -(-D // 32)
    big = torch.tensor(BIG, dtype=torch.float32)
    rank = spf.root_lane_rank(src, roots).long()
    out = torch.empty((A, V, D), dtype=torch.int8)
    movers, reach = [], []
    for a in range(A):
        root = int(roots[a])
        s, t, d = src[a].long(), dst[a].long(), dist[a]
        dv = d[t]
        # each in-edge classified once
        on = edge_ok[a] & (dv < big) & (~overloaded[a][s] | (s == root)) & (d[s] + w[a] == dv)
        seed = on & (s == root) & (rank[a] < D)
        prop = on & (s != root)
        bits = torch.zeros((V, 32 * W), dtype=torch.bool)
        bits[t[seed], rank[a][seed]] = True
        L = int(rank[a][seed].max()) + 1 if bool(seed.any()) else 0
        # the moving vertices and their packed sources
        count = torch.bincount(t[prop], minlength=V)
        moving = torch.nonzero(count).flatten()
        poff = torch.zeros(len(moving) + 1, dtype=torch.int64)
        poff[1:] = torch.cumsum(count[moving], 0)
        order = torch.argsort(t[prop], stable=True)
        psrc = s[prop][order]
        Wl = -(-L // 32)
        # OR rounds over the moving vertices' reachable words
        while True:
            new = bits.clone()
            for k, v in enumerate(moving.tolist()):
                srcs = psrc[poff[k]:poff[k + 1]]
                new[v, : 32 * Wl] |= bits[srcs, : 32 * Wl].any(0)
            if torch.equal(new, bits):
                break
            bits = new
        assert not bits[:, L:].any()  # no lane past the seeds' reach
        has = torch.bincount(t, minlength=V) > 0
        out[a] = torch.where(has[:, None], bits[:, :D].to(torch.int8),
                             torch.full((V, D), spf.INT8_MIN, dtype=torch.int8))
        movers.append(moving)
        reach.append(L)
    return out, movers, reach


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_packed_model_equals_plain_and_reference_from_any_seed(world):
    from openr_tpu.ops import spf as jspf  # the reference, on the CPU only
    import jax.numpy as jnp

    seg, dist, D = inputs(world)
    got, movers, reach = packed_model(*seg, dist, D)
    src, dst, w, ok, ovl, roots = seg
    A = roots.shape[0]
    for name, nh0 in seeds(got.shape, got).items():
        want, _r = spf.spf_nexthop_lanes_reset_plain(*seg, dist, nh0, D)
        assert torch.equal(got, want), name
        for a in range(A):
            ref, _rounds = jspf.spf_nexthop_lanes_reset(
                jnp.asarray(src[a].numpy()), jnp.asarray(dst[a].numpy()), jnp.asarray(w[a].numpy()),
                jnp.asarray(ok[a].numpy()), jnp.asarray(ovl[a].numpy()), jnp.int32(int(roots[a])),
                jnp.asarray(dist[a].numpy()), jnp.asarray(nh0[a].numpy()), max_degree=D)
            assert np.array_equal(got[a].numpy(), np.asarray(ref)), (name, a)
    assert any(len(m) for m in movers) and max(reach) >= 1


def test_packed_model_keeps_the_fill_and_the_lanes_past_32():
    """The hub's root has 40 lanes (two words a vertex); padded vertices
    keep -128; the 3-area world's isolated area has no lane at all."""
    seg, dist, D = inputs("hub40")
    got, _m, reach = packed_model(*seg, dist, D)
    assert reach == [40] and bool((got[0, :, 32:] == 1).any())
    assert bool((got == spf.INT8_MIN).any())
    seg, dist, D = inputs("multiarea")
    got, movers, reach = packed_model(*seg, dist, D)
    assert seg[5].shape[0] == 3 and 0 in reach
    iso = reach.index(0)
    assert len(movers[iso]) == 0 and not bool((got[iso] == 1).any())


def test_cluster_rule_spreads_large_areas():
    assert [spf.reset_lanes_cluster_size(V) for V in (64, 512, 1024, 4096, 16384)] == [1, 1, 2, 8, 8]


def test_packed_model_overloaded_root_still_seeds():
    seg, dist, D = inputs("root_overloaded")
    enc, _D = encode("root_overloaded")
    root = int(seg[5][0])
    assert bool(seg[4][0, root])
    got, movers, reach = packed_model(*seg, dist, D)
    assert reach[0] == 2 and len(movers[0]) > 0
    n12 = enc.topos[0].node_id("n12")
    # the drained node is reached but passes no lane on
    assert bool((got[0, n12] == 1).any())
    want, _r = spf.spf_nexthop_lanes_reset_plain(*seg, dist, torch.zeros_like(got), D)
    assert torch.equal(got, want)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["shared", "lists_global", "global"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_reset_lanes_kernel_equals_plain(card, world, layout, cluster, monkeypatch):
    """Kernel 5 (a cluster of 1-8 blocks per area, each with a copy of the
    lane words) against its plain version from a zero, a random and the
    answer's seed, its state and lists in shared memory, its lists in the
    global scratch, or all of it there."""
    monkeypatch.setattr(spf, "RESET_LANES_CLUSTER", cluster)
    seg, dist, D = inputs(world)
    seg = [t.to(card) for t in seg]
    dist = dist.to(card)
    V, E = seg[4].shape[1], seg[0].shape[1]
    state = 4 * spf._words16(spf.dense_lanes_state_bytes(V, D, spf.RESET_LANES_THREADS))
    budget = {"shared": spf.MAX_SHARED_BYTES, "lists_global": state, "global": 0}[layout]
    monkeypatch.setattr(spf, "MAX_SHARED_BYTES", budget)
    assert spf.reset_lanes_layout(V, E, D)[0] == ["shared", "lists_global", "global"].index(layout)
    answer = spf.spf_nexthop_lanes_reset_plain(*seg, dist, torch.zeros(
        (seg[5].shape[0], V, D), dtype=torch.int8, device=card), D)[0]
    for name, nh0 in seeds(answer.shape, answer.cpu()).items():
        nh0 = nh0.to(card)
        reset_launch_counts()
        got, rounds = spf.spf_nexthop_lanes_reset(*seg, dist, nh0, D)
        torch.cuda.synchronize()
        assert LAUNCHES["spf_nexthop_lanes_reset"] == 1
        want, _r = spf.spf_nexthop_lanes_reset_plain(*seg, dist, nh0, D)
        assert torch.equal(got, want), name
        assert int(rounds.min()) >= 1

