"""Kernel 4 (``warm_spf_distances``) as redesigned for the card: a numpy
model of its packed records and its seeded rounds over a thread block
cluster, held against the port's plain version and the JAX package's
``warm_spf_distances`` (``openr_tpu/ops/spf.py:449``), area by area.

* The layout, per block of an area's cluster of C (1, 2, 4 or 8): the
  block owns the slice [r S, r S + n) of S = ceil(V / C) vertices, whose
  in-edges are one range of the dst-sorted list, found by two binary
  searches over dst.  Each usable in-edge of the range (edge_ok, its source
  not overloaded or the root: the transit rule folded in) becomes a record
  {source, w} at its vertex's cursor, either in rows of 32 per 32-vertex
  group (a vertex's u-th record at its group's run + 32 u + its lane; runs
  of 32 x the group's largest usable in-degree) where the block's count
  fits the shared room, or as one run per vertex at its place in the
  block's range of the global record list.  The model checks that every
  usable in-edge lands once, in its own vertex's records, at a distinct
  slot, and that no padding or down edge does.
* The rounds: every block holds a copy of the area's distances, seeded
  from d0 with the root at 0, relaxes its own slice from its own copy and
  stores each improvement into its copy; the stores into the other blocks'
  copies are seen only at the vote (the latest the card allows: the
  cluster barrier), one round before the first vote and ``sweeps`` rounds
  (16 on the card, ``kWarmSweeps``) between later votes, until a vote's
  rounds change nothing anywhere.  The fixed point min_u (d0[u] + path(u -> v))
  is unique, so this order reaches the reference's table bit for bit.
* Worlds: a grid, a 24 x 24 grid (several rows of records a group), the
  3-area world of ``tests/test_torch_warm.py`` (A = 3, an overloaded node,
  a soft drain, an isolated area), an overloaded root, a drained transit
  node on a WAN and a hub; seeds: a reset region at BIG over the answer,
  all BIG but the root, and the answer itself.

The ``cuda`` cases run kernel 4 against its plain version over the same
worlds and seeds on clusters of 1, 2, 4 and 8 blocks an area, with its
records in shared memory, in the global list (its fixed state in shared
memory) and its whole state global (a budget of 0).  Tolerance: exact
equality.  This module imports no JAX at import time, so that its ``cuda``
cases run where JAX is absent.
"""

import inspect
import re
from pathlib import Path

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
    return [("me", f"h{i}", 1 + i % 3) for i in range(leaves)] + [
        (f"h{i}", f"h{(i + 1) % leaves}", 2) for i in range(leaves)
    ]


WORLDS = {
    "grid": ({"0": ttopo.grid_edges(6, prefix="n") + [("n0", "me", 1), ("n5", "me", 1)]}, {}),
    "grid24": ({"0": ttopo.grid_edges(24, prefix="n") + [("n0", "me", 1)]}, {}),
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
    "drained": ({"0": ttopo.random_connected_edges(40, 60, seed=11, prefix="n")
                 + [("n0", "me", 1), ("n17", "me", 3)]}, {"0": {"overloaded": ["n3", "n9"]}}),
    "hub": ({"0": _hub(40)}, {}),
}
SEEDS = ("reset", "all_big", "answer")


def inputs(world):
    """(segment tensors, the cold distances) of a world."""
    edges, drains = WORLDS[world]
    areas = {}
    for a, e in edges.items():
        ls = LinkState(a, "me")
        for db in ttopo.build_adj_dbs(e, area=a, **drains.get(a, {})).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    enc = csr.encode_multi_area(areas, "me")
    seg = tables_from_numpy([getattr(enc, f) for f in SEG_FIELDS])
    return seg, spf.spf_distances_plain(*seg)


def seed_of(name, answer, roots):
    """[A, V] f32: a reset region (every third vertex and its ring) at BIG
    over the answer, all BIG, or the answer; the root is pinned at 0 by
    the kernels either way."""
    A, V = answer.shape
    if name == "answer":
        return answer.clone()
    if name == "all_big":
        return torch.full((A, V), BIG, dtype=torch.float32)
    rng = np.random.default_rng(7)
    region = torch.from_numpy(rng.random((A, V)) < 0.4)
    return torch.where(region, torch.tensor(BIG, dtype=torch.float32), answer)


def block_records(src, dst, w, ok, ovl, root, V, C, r, cap):
    """Block r's packing: (lo, n, heads [n, 2], records {slot: (src, w)},
    rows).  Edges are taken in list order (the card's atomics take them
    in any order; a min does not care)."""
    S = -(-V // C)
    lo = r * S
    n = max(0, min(S, V - lo))
    e_lo, e_hi = np.searchsorted(dst, lo, "left"), np.searchsorted(dst, lo + n, "left")
    e = np.arange(e_lo, e_hi)
    usable = ok[e] & (~ovl[src[e]] | (src[e] == root))
    deg = np.bincount(dst[e][usable] - lo, minlength=n) if n else np.zeros(0, int)
    G = -(-n // 32)
    runs = [32 * int(deg[g * 32:(g + 1) * 32].max(initial=0)) for g in range(G)]
    gbase = np.concatenate([[0], np.cumsum(runs)]).astype(int)
    M = int(gbase[-1]) if G else 0
    rows = M <= cap
    if rows:
        first = gbase[np.arange(n) // 32] + np.arange(n) % 32
    else:
        first = e_lo + np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(int) if n else deg
    cursor = np.zeros(n, int)
    recs = {}
    for k in e[usable]:
        j = int(dst[k]) - lo
        slot = int(first[j]) + (32 if rows else 1) * int(cursor[j])
        cursor[j] += 1
        assert slot not in recs and (slot < M if rows else e_lo <= slot < e_hi)
        recs[slot] = (j, int(src[k]), np.float32(w[k]))
    assert np.array_equal(cursor, deg)
    return lo, n, first, deg, recs, rows


def records_model(src, dst, w, ok, ovl, roots, d0, cluster, cap=1 << 30, sweeps=16):
    """Kernel 4, area by area, block by block: dist [A, V] f32."""
    A, V = ovl.shape
    out = np.empty((A, V), np.float32)
    for a in range(A):
        root = int(roots[a])
        s_, d_, w_, ok_, ovl_ = (x[a].numpy() for x in (src, dst, w, ok, ovl))
        blocks = [block_records(s_, d_, w_, ok_, ovl_, root, V, cluster, r, cap)
                  for r in range(cluster)]
        # every usable in-edge lands once, in its own vertex's records
        usable = ok_ & (~ovl_[s_] | (s_ == root))
        got = sorted((lo + j, s, float(x)) for lo, _n, _f, _d, recs, _r in blocks
                     for j, s, x in recs.values())
        want = sorted(zip(d_[usable].tolist(), s_[usable].tolist(), w_[usable].astype(float).tolist()))
        assert got == want
        seed = d0[a].numpy().copy()
        seed[root] = 0.0
        copies = [seed.copy() for _ in range(cluster)]
        for vote in range(V):
            pending, any_change = [], False
            for _sweep in range(1 if vote == 0 else sweeps):
                for r, (lo, n, _f, _deg, recs, _rows) in enumerate(blocks):
                    if not recs:
                        continue
                    j, s, x = (np.array(t) for t in zip(*recs.values()))
                    best = copies[r][lo:lo + n].copy()
                    np.minimum.at(best, j, (copies[r][s] + x.astype(np.float32)).astype(np.float32))
                    moved = np.nonzero(best < copies[r][lo:lo + n])[0]
                    if len(moved):
                        any_change = True
                        copies[r][lo + moved] = best[moved]
                        pending.append((r, lo + moved, best[moved]))
            # the other blocks' copies see the stores at the vote
            for r, v, x in pending:
                for o in range(cluster):
                    if o != r:
                        copies[o][v] = x
            if not any_change:
                break
        for r, (lo, n, *_rest) in enumerate(blocks):
            out[a, lo:lo + n] = copies[r][lo:lo + n]
            assert all(np.array_equal(c[lo:lo + n], copies[r][lo:lo + n]) for c in copies)
    return torch.from_numpy(out)


def _jax_warm(seg, d0):
    import jax.numpy as jnp
    from openr_tpu.ops import spf as jspf

    src, dst, w, ok, ovl, roots = seg
    return np.stack([
        np.asarray(jspf.warm_spf_distances(
            jnp.asarray(src[a].numpy()), jnp.asarray(dst[a].numpy()), jnp.asarray(w[a].numpy()),
            jnp.asarray(ok[a].numpy()), jnp.asarray(ovl[a].numpy()), jnp.int32(int(roots[a])),
            jnp.asarray(d0[a].numpy()))[0])
        for a in range(roots.shape[0])])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_records_model_equals_plain_and_reference(world, seed):
    seg, answer = inputs(world)
    d0 = seed_of(seed, answer, seg[5])
    want, _r = spf.warm_spf_distances_plain(*seg, d0)
    assert torch.equal(want, answer)
    ref = _jax_warm(seg, d0)
    assert np.array_equal(ref, want.numpy())
    V, E = seg[4].shape[1], seg[0].shape[1]
    for cluster in (1, 2, 4, 8):
        if cluster > V:
            continue
        for cap in (1 << 30, 0):  # records in rows of 32, or as runs
            got = records_model(*seg, d0, cluster, cap=cap)
            assert torch.equal(got, want), (cluster, cap)


def test_records_model_with_one_round_a_vote():
    seg, answer = inputs("grid24")
    d0 = seed_of("all_big", answer, seg[5])
    assert torch.equal(records_model(*seg, d0, 8, sweeps=1), answer)


def test_transit_rule_is_folded_into_the_records():
    """An overloaded root still relaxes its out-edges; an overloaded
    transit node's out-edges are never packed; padding edges (edge_ok
    false, in the run of V - 1) never are."""
    seg, _answer = inputs("root_overloaded")
    src, dst, w, ok, ovl, roots = (x[0].numpy() for x in seg)
    root = int(roots)
    V = ovl.shape[0]
    assert ovl[root]
    recs = {}
    for r in range(4):
        recs.update({(r, k): v for k, v in block_records(src, dst, w, ok, ovl, root, V, 4, r,
                                                          1 << 30)[4].items()})
    sources = {s for _j, s, _x in recs.values()}
    assert root in sources
    drained = [v for v in range(V) if ovl[v] and v != root]
    assert drained and not sources & set(drained)
    assert len(recs) == int((ok & (~ovl[src] | (src == root))).sum()) < int(ok.sum())
    assert not ok[dst == V - 1].all()


def test_cluster_rule_and_layout_at_the_main_path_shapes():
    """Eight blocks at the grid's and (g)'s [V, E] (32,768 padded edges),
    one for the 3-area world; the distances in shared memory up to about
    45,000 vertices at a cluster of 8, past them the global layout; no
    shape up to the node bound is refused."""
    assert spf.warm_dist_cluster_size(4096, 32768) == 8
    assert spf.warm_dist_cluster_size(16384, 32768) == 8
    assert spf.warm_dist_cluster_size(16, 128) == 1
    assert spf.warm_dist_cluster_size(2, 65536) == 2
    S, cap, global_state = spf.warm_distances_layout(4096, 32768, 8)
    assert (S, global_state) == (512, False) and cap > 4 * 4096
    assert spf.warm_distances_layout(45000, 1 << 17, 8)[2] is False
    assert spf.warm_distances_layout(spf.MAX_KERNEL_NODES, 1 << 17, 8)[2] is True
    assert spf.warm_distances_layout(4096, 32768, 1)[1] > 0


def test_constants_are_the_kernels():
    """The launcher's shared-memory budget is the dynamic shared memory the
    C entry allows a block (``kWarmDynamicSmem``), and the model's rounds
    between votes are the kernel's (``kWarmSweeps``)."""
    cu = (Path(spf.__file__).parents[1] / "kernels" / "csrc" / "spf_warm.cu").read_text()
    smem = re.search(r"constexpr size_t kWarmDynamicSmem = (\d+) - (\d+);", cu)
    assert int(smem[1]) - int(smem[2]) == spf.WARM_DIST_SHARED_BYTES
    sweeps = re.search(r"constexpr int kWarmSweeps = (\d+);", cu)
    assert int(sweeps[1]) == inspect.signature(records_model).parameters["sweeps"].default


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["shared", "records_global", "global"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_warm_dist_records_kernel_equals_plain(card, world, layout, cluster, monkeypatch):
    """Kernel 4 (a cluster of 1-8 blocks an area, each with a copy of the
    distances) against its plain version from each seed, its records in
    shared memory, in the global list, or its whole state global."""
    monkeypatch.setattr(spf, "WARM_DIST_CLUSTER", cluster)
    seg, answer = inputs(world)
    V = seg[4].shape[1]
    fixed = spf.warm_dist_fixed_bytes(V, -(-V // cluster))
    budget = {"shared": spf.MAX_SHARED_BYTES, "records_global": fixed, "global": 0}[layout]
    monkeypatch.setattr(spf, "MAX_SHARED_BYTES", budget)
    S, cap, global_state = spf.warm_distances_layout(V, seg[0].shape[1], cluster)
    assert global_state == (layout == "global") and (cap > 0) == (layout == "shared")
    seg = [t.to(card) for t in seg]
    for name in SEEDS:
        d0 = seed_of(name, answer, seg[5]).to(card)
        reset_launch_counts()
        got, rounds = spf.warm_spf_distances(*seg, d0)
        torch.cuda.synchronize()
        assert LAUNCHES["warm_spf_distances"] == 1
        want, _r = spf.warm_spf_distances_plain(*seg, d0)
        assert torch.equal(got, want), name
        assert torch.equal(got.cpu(), answer), name
        assert int(rounds.min()) >= 1
