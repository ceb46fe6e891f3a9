"""Kernel 1 (``dense_spf_distances``) as redesigned for the card, on the
CPU: a torch model of its packed in-edge records and of its in-place
rounds over the slices a thread block cluster splits an area into, held
against the reference's ``dense_spf_distances`` (``openr_tpu/ops/spf.py``)
vmapped over areas as ``multi_area_spf_tables_dense`` does, jitted on the
CPU.

* The packing: block r of an area's cluster owns the vertices
  [r * S, (r + 1) * S) (S = ceil(V / C)) and packs their usable in-slots
  (in_ok, and the source not overloaded or the root) into one record
  {source, w} each, stored by group
  of 32 vertices as rows of 32, as many as the group's largest usable
  in-degree: a vertex's u-th usable slot at its group's run + 32 u + its
  lane.  The model lists exactly the usable slots, each once, in slot
  order per vertex; nothing else of the run is read.
* The rounds: every block holds a copy of the whole area's distances;
  blocks in turn relax their own slice, each group of 32 vertices at
  once from the block's copy, and write each improvement to every copy
  (in place), 1 or 4 rounds between two votes, until a vote's rounds
  change nothing in any block.

Worlds: the 12 x 12 grid, a 300-node WAN, a three-area world, a grid
whose root is overloaded (it still transits), an overloaded transit node,
and a vertex whose only neighbour is overloaded (no usable in-slot: it
stays unreachable); clusters of 1, 2, 4 and 8.  The launcher's rule and
layout are checked on the shapes the main path gives them.  The kernel
itself is held against its plain version by the ``cuda`` tests of
``tests/test_torch_kernels_cuda.py``.  Tolerance: exact equality (a
unique fixed point; integral metrics keep every f32 sum exact).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from openr_tpu.decision.link_state import LinkState
from openr_tpu.emulation.topology import build_adj_dbs, grid_edges, random_connected_edges
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops.spf import dense_spf_distances as jax_dense_distances
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.consts import BIG

PLANES = ("in_src", "in_w", "in_ok", "overloaded", "roots")


def _ls(edges, area="0", **drains):
    ls = LinkState(area)
    for db in build_adj_dbs(edges, area=area, **drains).values():
        ls.update_adjacency_database(db)
    return ls


def _worlds():
    ring = [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
    return {
        "grid": ({"0": _ls(grid_edges(12))}, "node0"),
        "wan": ({"0": _ls(random_connected_edges(300, 600, seed=7))}, "node0"),
        "three_area": ({
            "1": _ls(grid_edges(4, prefix="a") + [("a0", "me", 1)], "1", overloaded=["a5"]),
            "2": _ls(ring + [("b0", "me", 2), ("b3", "me", 5)], "2"),
            "3": _ls(random_connected_edges(10, 6, seed=7, prefix="c") + [("c0", "me", 1)], "3"),
        }, "me"),
        "overloaded_root": ({"0": _ls(grid_edges(6), overloaded=["node0"])}, "node0"),
        "overloaded_transit": ({"0": _ls(grid_edges(6), overloaded=["node7", "node14"])}, "node0"),
        "no_usable_slot": ({"0": _ls(grid_edges(5) + [("node12", "leaf", 2)],
                                     overloaded=["node12"])}, "node0"),
    }


WORLDS = sorted(_worlds())


@functools.lru_cache(maxsize=None)
def planes(world):
    areas, me = _worlds()[world]
    enc = jcsr.encode_multi_area(areas, me)
    return tuple(np.asarray(getattr(enc, f)) for f in PLANES)


@functools.lru_cache(maxsize=None)
def reference(world):
    """The reference's distances, [A, V] f32."""
    return np.asarray(jax.jit(jax.vmap(jax_dense_distances))(*planes(world)))


def pack_block(in_src, in_w, in_ok, ovl, root, lo, n, S):
    """Kernel 1's packing of one block's slice [lo, lo + n) of one area:
    (deg [n], group runs [G], records [M, 2] int64 {source, w as f32 bits},
    -1 where a row of a group's run is past a vertex's in-degree), each
    record where the kernel puts it."""
    rows = slice(lo, lo + n)
    src = in_src[rows].long()
    usable = in_ok[rows] & (~ovl[src] | (src == root))
    deg = usable.sum(dim=1)
    G = (n + 31) // 32
    run = torch.tensor([32 * int(deg[g * 32:(g + 1) * 32].max()) for g in range(G)],
                       dtype=torch.int64)
    gbase = torch.cumsum(run, 0) - run
    rec = torch.full((int(run.sum()), 2), -1, dtype=torch.int64)
    for j in range(n):
        g, lane = divmod(j, 32)
        for u, k in enumerate(torch.nonzero(usable[j]).squeeze(1).tolist()):
            bits = int(torch.tensor(float(in_w[lo + j, k])).view(torch.int32))
            rec[int(gbase[g]) + 32 * u + lane] = torch.tensor([int(src[j, k]), bits])
    return deg, gbase, rec


def packed_rounds_model(in_src, in_w, in_ok, ovl, roots, C, sweeps=1):
    """Kernel 1 on clusters of C blocks an area, ``sweeps`` rounds between
    two votes: [A, V] f32 distances and the votes each area ran."""
    A, V, _K = in_src.shape
    S = -(-V // C)
    out = torch.empty((A, V), dtype=torch.float32)
    rounds = []
    for a in range(A):
        root = int(roots[a])
        blocks = []
        for r in range(C):
            lo = r * S
            n = max(0, min(S, V - lo))
            blocks.append((lo, n, *pack_block(in_src[a], in_w[a], in_ok[a], ovl[a], root, lo, n, S)))
        # every block's copy of the area's distances
        copies = [torch.where(torch.arange(V) == root, 0.0, BIG).float() for _ in range(C)]
        for vote in range(V):
            changed = False
            for r, (lo, n, deg, gbase, rec) in [b for _ in range(sweeps) for b in enumerate(blocks)]:
                d = copies[r]
                for g in range((n + 31) // 32):
                    dg = deg[g * 32:(g + 1) * 32]
                    vs = slice(lo + g * 32, lo + g * 32 + len(dg))
                    cur = d[vs].clone()
                    best = cur.clone()
                    for u in range(int(dg.max()) if len(dg) else 0):
                        lanes = torch.nonzero(dg > u).squeeze(1)
                        srcs, bits = rec[int(gbase[g]) + 32 * u + lanes].unbind(1)
                        w = bits.to(torch.int32).view(torch.float32)
                        best[lanes] = torch.minimum(best[lanes], d[srcs] + w)
                    lower = best < cur
                    if bool(lower.any()):
                        for copy in copies:  # the block's own, and the others' by remote stores
                            copy[vs] = torch.where(lower, best, cur)
                        changed = True
            if not changed:
                rounds.append(vote + 1)
                break
        assert all(torch.equal(c, copies[0]) for c in copies)
        d = [copies[0]]
        out[a] = torch.cat(d)
    return out, rounds


def _torch_planes(world):
    return [torch.from_numpy(x) for x in planes(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_packing_lists_every_usable_slot_once(world):
    """Per block: every usable slot (transit rule folded in) is one record,
    in slot order per vertex, none from padding."""
    in_src, in_w, in_ok, ovl, roots = _torch_planes(world)
    A, V, K = in_src.shape
    for C in (1, 4):
        S = -(-V // C)
        for a in range(A):
            root = int(roots[a])
            for r in range(C):
                lo, n = r * S, max(0, min(S, V - r * S))
                deg, gbase, rec = pack_block(in_src[a], in_w[a], in_ok[a], ovl[a], root, lo, n, S)
                assert int((rec[:, 0] >= 0).sum()) == int(deg.sum())
                for j in range(n):
                    v = lo + j
                    want = [(int(in_src[a, v, k]), float(in_w[a, v, k])) for k in range(K)
                            if in_ok[a, v, k] and (not ovl[a, in_src[a, v, k]] or in_src[a, v, k] == root)]
                    g, lane = divmod(j, 32)
                    got = []
                    for u in range(int(deg[j])):
                        s, bits = (int(x) for x in rec[int(gbase[g]) + 32 * u + lane])
                        got.append((s, float(torch.tensor(bits, dtype=torch.int32).view(torch.float32))))
                    assert got == want, (world, a, v)


@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("world", WORLDS)
def test_packed_rounds_model_equals_jax_dense_distances(world, cluster, sweeps):
    in_src, in_w, in_ok, ovl, roots = _torch_planes(world)
    got, rounds = packed_rounds_model(in_src, in_w, in_ok, ovl, roots, cluster, sweeps)
    want = reference(world)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert len(rounds) == in_src.shape[0] and max(rounds) <= in_src.shape[1]
    assert torch.equal(got, tspf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots))
    if world == "no_usable_slot":
        areas, me = _worlds()[world]
        leaf = jcsr.encode_multi_area(areas, me).topos[0].node_id("leaf")
        assert float(got[0, leaf]) == BIG
    if world == "overloaded_root":
        assert bool((got[0, :36] < BIG).all())


def test_cluster_rule_and_layout_at_the_main_path_shapes(monkeypatch):
    """The rule spreads the grid's route build (V = 4,096, K = 4) and the
    KSP2 backbone's planes (V = 16,384, K = 32) over 8 blocks, each with
    its records in shared memory where its count fits (the scratch held
    for the rest), and keeps the 3-area world's small areas on one
    block; every node count up to ``DENSE_MAX_NODES`` fits the rule's
    cluster, and one more node does not fit a cluster of 8."""
    assert tspf.dense_cluster_size(64, 8) == 1
    assert tspf.dense_cluster_size(4096, 4) == 8
    assert tspf.dense_distances_layout(1, 4096, 4, 8) == (512, 2048, 0)
    assert tspf.dense_distances_layout(1, 4096, 4, 1) == (4096, 16384, 0)
    assert tspf.dense_cluster_size(16384, 32) == 8
    S, cap, scratch = tspf.dense_distances_layout(1, 16384, 32, 8)
    assert S == 2048 and 9088 < cap < S * 32 and scratch == 8 * S * 32
    top = tspf.DENSE_MAX_NODES
    for V in (1, 31, 4097, 30000, top):
        for K in (1, 4, 32):
            c = tspf.dense_cluster_size(V, K)
            S, cap, _ = tspf.dense_distances_layout(1, V, K, c)
            assert tspf.dense_dist_fixed_bytes(V, S) + 8 * cap <= tspf.BLOCK_SHARED_BYTES
    assert tspf.dense_dist_fixed_bytes(top + 1, -(-(top + 1) // 8)) > tspf.BLOCK_SHARED_BYTES
    # a forced cluster too small for the area leaves no room for records
    # (the C entry then refuses the fixed state)
    assert tspf.dense_distances_layout(1, 30000, 4, 1)[1] == 0
    assert tspf.dense_dist_fixed_bytes(30000, 30000) > tspf.BLOCK_SHARED_BYTES
    with pytest.raises(ValueError):
        tspf.dense_distances_layout(1, 64, 4, 3)
    monkeypatch.setattr(tspf, "DENSE_CLUSTER", 4)
    assert tspf.dense_cluster_size(4096, 4) == 4
    monkeypatch.setattr(tspf, "MAX_SHARED_BYTES", 0)
    assert tspf.dense_distances_layout(2, 4096, 4, 4)[1:] == (0, 2 * 4 * 1024 * 4)
