"""Kernel 6 (``warm_subgraph_repair``) as redesigned for the card: the
bounded repair over each area's reset list, held against the port's plain
version and the JAX package's ``warm_subgraph_repair_one``
(``openr_tpu/ops/spf.py:548``), area by area.

* The design, as the numpy model here runs it: an area's reset vertices
  are listed in ascending order; the sub-edge list is read once, an edge
  whose dst is listed marking its vertex as having a run (a padding or
  unusable edge too: only an empty run gets the -128 fill), a usable one
  becoming a record in edge order, grouped by vertex: INNER where its
  source is listed too (kept as the source's list index), OUTER where the
  source keeps its previous distance, whose constant candidate lowers the
  vertex's distance before any round.  The inner records are indexed by
  source; the first K threads run the rounds (K = 32 up to 256 listed
  vertices, then a warp per 256 up to 256): a round relaxes the
  out-records of its frontier (first, every vertex below BIG) and lists
  each vertex it lowers once for the next; the model runs each round's
  list in order (one legal order of the card's).  Lanes are bit words
  (ceil(D / 32) a vertex): seeds and outer sources' previous lanes (bit l
  where the lane is 1) OR'd in once, inner records off the DAG or out of
  the root dropped, then frontier rounds OR each propagating source's
  words into its vertex's.  The listed rows come out of the
  state (-128 without a run), every other row is the previous table's.
* Inputs: the port's planner on a weakened link (the main path's form,
  prev = the old cold tables) on a grid, the 3-area world and a grid of
  2,304 vertices; and synthetic reset sets over a world's own cold tables
  (no vertex, a ball, a random 40 %, every vertex but the root) on those
  and a hub whose root has 40 lanes (D = 64 > 32), where the repair must
  reach the cold tables again.

The ``cuda`` cases run kernel 6 against its plain version on the same
inputs, rounds of one warp (warp votes), of several and of the whole
block (named-barrier votes), a reset vertex without a sub-edge, a grid
padded to ``MAX_KERNEL_NODES`` vertices (a list in shared memory, and one
past it: the global scratch), and three areas at D = 40 whose lists all
live in the global scratch.
Tolerance: exact equality.  This module imports no JAX at import time, so
that its ``cuda`` cases run where JAX is absent.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS, CudaBackend
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.emulation import topology as ttopo
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.repair import plan_generation_delta

SEG_FIELDS = ("src", "dst", "w", "edge_ok", "overloaded", "roots")


def _hub(leaves):
    return [("me", f"h{i}", 1 + i % 3) for i in range(leaves)] + [
        (f"h{i}", f"h{(i + 1) % leaves}", 2) for i in range(leaves)
    ]


#: name -> (edges by area, drains by area, the link (area, a, b) a
#: weakening raises by 5 both ways)
WORLDS = {
    "grid": ({"0": ttopo.grid_edges(8, prefix="n") + [("n0", "me", 1), ("n7", "me", 1)]}, {},
             ("0", "n24", "n32")),
    "multiarea": (
        {
            "1": ttopo.random_connected_edges(12, 8, seed=5, prefix="a") + [("a0", "me", 1)],
            "2": [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
            + [("b0", "me", 2), ("b3", "me", 3)],
            "3": [("w0", "w1", 1), ("w1", "w2", 2)],
        },
        {"1": {"overloaded": ["a4"]}, "2": {"soft_drained": {"b2": 5}}},
        ("2", "b0", "b1"),
    ),
    "hub40": ({"0": _hub(40)}, {}, ("0", "h3", "h4")),
    "grid48": ({"0": ttopo.grid_edges(48, prefix="n") + [("n0", "me", 1)]}, {},
               ("0", "n1152", "n1200")),
}
RULES = ("plan", "none", "ball", "random", "all")


def encode(world, weaken=False):
    edges, drains, (area, a, b) = WORLDS[world]
    areas = {}
    for ar, es in edges.items():
        if weaken and ar == area:
            es = [(u, v, m + 5) if {u, v} == {a, b} else (u, v, m) for u, v, m in es]
        ls = LinkState(ar, "me")
        for db in ttopo.build_adj_dbs(es, area=ar, **drains.get(ar, {})).values():
            ls.update_adjacency_database(db)
        areas[ar] = ls
    return csr.encode_multi_area(areas, "me")


def cold_tables(seg, D):
    dist = spf.spf_distances_plain(*seg)
    return dist, spf.spf_nexthop_lanes_plain(*seg, dist, D)


def pack(enc, reset):
    """The sub-edge arrays of ``reset`` [A, V] as the backend packs a
    plan's (every in-edge of a reset vertex, dst ascending, pads after)."""
    plans = [types.SimpleNamespace(sub_edges=np.nonzero(reset[a][t.dst])[0])
             for a, t in enumerate(enc.topos)]
    return CudaBackend._pack_sub_edges(None, enc, plans)


def reset_rule(rule, dist, roots):
    """[A, V] bool: no vertex, a ball (the vertices 2-4 hops of distance
    past the nearest), a seeded 40 %, or every vertex; never the root."""
    A, V = dist.shape
    if rule == "none":
        reset = np.zeros((A, V), bool)
    elif rule == "all":
        reset = np.ones((A, V), bool)
    elif rule == "ball":
        d = dist.numpy()
        reset = (d >= 2) & (d <= 4)
    else:
        reset = np.random.default_rng(3).random((A, V)) < 0.4
    reset[np.arange(A), roots.numpy()] = False
    return reset


def inputs(world, rule):
    """(sub-edge tensors, prev_dist, prev_nh, reset, D, cold_dist,
    cold_nh): the planner's on the weakened link for ``plan``, else the
    rule's reset set over the world's own cold tables."""
    enc = encode(world, weaken=rule == "plan")
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    seg = tables_from_numpy([getattr(enc, f) for f in SEG_FIELDS])
    cold_d, cold_n = cold_tables(seg, D)
    if rule == "plan":
        old = encode(world)
        prev_d, prev_n = cold_tables(tables_from_numpy([getattr(old, f) for f in SEG_FIELDS]), D)
        plans = [plan_generation_delta(ot, int(enc.roots[i]), prev_d[i].numpy(), nt)
                 for i, (ot, nt) in enumerate(zip(old.topos, enc.topos))]
        assert all(not p.has_improvements and p.lanes_compatible for p in plans)
        reset = np.stack([p.reset for p in plans])
        sub = CudaBackend._pack_sub_edges(None, enc, plans)
    else:
        prev_d, prev_n = cold_d, cold_n
        reset = reset_rule(rule, cold_d, seg[5])
        sub = pack(enc, reset)
    return (list(tables_from_numpy(sub)), prev_d, prev_n, torch.from_numpy(reset), D,
            cold_d, cold_n)


def round_threads(n):
    """The threads that run the rounds (K) for a list of ``n`` vertices: one
    warp up to 256, a warp per 256 after, 256 at most."""
    return 32 * min(8, max(1, -(-n // 256)))


def frontier_rounds(n, first, out, move):
    """Frontier rounds in one legal order of the card's: each round takes
    the vertices its list holds in order, calls ``move(u, rec)`` on each of
    their out-records (``out[u]``), and lists each vertex moved once for
    the next round; the first round runs even on an empty list, and the
    last moved nothing.  Returns the rounds run."""
    count, cur = 0, first
    while n:
        nxt, changed = [], False
        for u in cur:
            for rec in out[u]:
                if move(u, rec):
                    changed = True
                    if rec[0] not in nxt:
                        nxt.append(rec[0])
        count += 1
        if not changed:
            break
        cur = nxt
        assert count <= n
    return count


def repair_model(src, dst, w, ok, rank, prev_dist, prev_nh, reset, D):
    """Kernel 6 in numpy (see the module docstring); returns (dist, nh,
    rounds_d, rounds_l, listed) with the model's round counts."""
    src, dst, w, ok, rank = (x.numpy() for x in (src, dst, w, ok, rank))
    prev_dist, prev_nh, reset = prev_dist.numpy(), prev_nh.numpy(), reset.numpy()
    A, V = prev_dist.shape
    Es = src.shape[1]
    W = -(-D // 32)
    big = np.float32(BIG)
    dist, nh = prev_dist.copy(), prev_nh.copy()
    rounds_d, rounds_l, listed = [], [], []
    for a in range(A):
        lst = np.nonzero(reset[a])[0]
        n = lst.size
        index = np.full(V, -1)
        index[lst] = np.arange(n)
        d = np.full(n, big, np.float32)
        has = np.zeros(n, bool)
        out = [[] for _ in range(n)]  # inner records (vertex, source, w, rank) by source
        outer = [[] for _ in range(n)]
        last = -1
        for e in range(Es):
            i = index[dst[a, e]]
            if i < 0:
                continue
            assert i >= last  # dst ascending: a vertex's records are one run
            last = i
            has[i] = True
            if not ok[a, e]:
                continue
            s, j = int(src[a, e]), int(index[src[a, e]])
            if j >= 0:
                out[j].append((i, j, w[a, e], int(rank[a, e])))
            else:
                outer[i].append((s, w[a, e], int(rank[a, e])))
                d[i] = min(d[i], np.float32(prev_dist[a, s] + w[a, e]))

        def relax(u, rec):
            c = np.float32(d[u] + rec[2])
            if c < d[rec[0]]:
                d[rec[0]] = c
                return True
            return False

        rounds_d.append(frontier_rounds(n, [u for u in range(n) if d[u] < big], out, relax))
        bits = np.zeros((n, W), np.uint32)

        def set_bit(i, r):
            bits[i, r // 32] |= np.uint32(1 << (r % 32))

        for i in range(n):
            for s, x, r in outer[i]:
                if not (d[i] < big and np.float32(prev_dist[a, s] + x) == d[i]):
                    continue
                if r >= 0:
                    if r < D:
                        set_bit(i, r)
                else:
                    for l in np.nonzero(prev_nh[a, s] > 0)[0]:
                        set_bit(i, l)
        # inner records: a seed sets its bit; only records on the DAG out of
        # a vertex other than the root stay for the lane rounds
        prop = [[] for _ in range(n)]
        for u in range(n):
            for i, j, x, r in out[u]:
                on = d[i] < big and np.float32(d[j] + x) == d[i]
                if on and 0 <= r < D:
                    set_bit(i, r)
                if on and r < 0:
                    prop[u].append((i, j, x, r))

        def spread(u, rec):
            i = rec[0]
            if not (bits[u] & ~bits[i]).any():
                return False
            bits[i] |= bits[u]
            return True

        rounds_l.append(frontier_rounds(n, [u for u in range(n) if bits[u].any()], prop, spread))
        for i, v in enumerate(lst):
            dist[a, v] = d[i]
            lanes = ((bits[i][np.arange(D) // 32] >> (np.arange(D) % 32)) & 1).astype(np.int8)
            nh[a, v] = lanes if has[i] else np.int8(-128)
        listed.append(n)
    return (torch.from_numpy(dist), torch.from_numpy(nh), rounds_d, rounds_l, listed)


def _jax_repair(sub, prev_d, prev_n, reset, D):
    import jax.numpy as jnp
    from openr_tpu.ops import route_select as jrs

    out = jrs.warm_multi_area_subgraph_tables(
        *(jnp.asarray(t.numpy()) for t in (*sub, prev_d, prev_n, reset)), max_degree=D)
    return np.asarray(out[0]), np.asarray(out[1])


CPU_CASES = [(w, r) for w in ("grid", "multiarea", "hub40") for r in RULES] + [
    ("grid48", "plan"), ("grid48", "ball")]


@pytest.mark.parametrize("world, rule", CPU_CASES)
def test_list_model_equals_plain_and_reference(world, rule):
    sub, prev_d, prev_n, reset, D, cold_d, cold_n = inputs(world, rule)
    want = spf.warm_subgraph_repair_plain(*sub, prev_d, prev_n, reset, D)
    got = repair_model(*sub, prev_d, prev_n, reset, D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ref_d, ref_n = _jax_repair(sub, prev_d, prev_n, reset, D)
    assert np.array_equal(ref_d, want[0].numpy()) and np.array_equal(ref_n, want[1].numpy())
    # a weakening repaired, or a consistent table re-solved, is the cold one
    assert torch.equal(got[0], cold_d) and torch.equal(got[1], cold_n)
    for n, rd, rl in zip(got[4], got[2], got[3]):
        assert (rd, rl) == (0, 0) if n == 0 else (1 <= rd <= n and 1 <= rl <= n)
    if rule == "none":
        assert sum(got[4]) == 0
    if world == "hub40":
        assert D > 32 and bool((cold_n[..., 32:] == 1).any())


def test_the_inputs_reach_every_form():
    """Rounds of one warp (at most 256 listed vertices), of several warps and
    of the most, 256 threads; a reset vertex whose run is empty."""
    def listed(world, rule):
        return int(inputs(world, rule)[3].sum(dim=1).max())

    assert round_threads(listed("grid", "all")) == 32
    assert 32 < round_threads(listed("grid48", "plan")) < 256
    assert round_threads(listed("grid48", "all")) == 256
    sub, _pd, _pn, reset, _D, _cd, cold_n = inputs("multiarea", "all")
    empty = [(a, v) for a, v in zip(*np.nonzero(reset.numpy()))
             if not (sub[1][a] == int(v)).any()]
    assert empty and all((cold_n[a, v] == -128).all() for a, v in empty)


def test_reset_vertex_without_sub_edges_holds_int8_min():
    """A reset vertex with no sub-edge ends at -128 lanes; pads ride the
    last dst's run, so that vertex's run is not empty."""
    V, D = 6, 4
    sub = [torch.tensor(x) for x in (
        [[0, 1, 0, 0]], [[1, 2, 2, 2]], np.array([[1, 1, np.inf, np.inf]], np.float32),
        [[True, True, False, False]], [[0, -1, -1, -1]])]
    sub[0], sub[1], sub[4] = (x.to(torch.int32) for x in (sub[0], sub[1], sub[4]))
    prev_d = torch.tensor([[0, 1, 2, 9, 3e38, 3e38]], dtype=torch.float32)
    prev_n = torch.zeros((1, V, D), dtype=torch.int8)
    prev_n[0, 1:4, 0] = 1
    reset = torch.tensor([[False, True, True, True, False, False]])
    want = spf.warm_subgraph_repair_plain(*sub, prev_d, prev_n, reset, D)
    got = repair_model(*sub, prev_d, prev_n, reset, D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1][0, 3] == -128).all() and (got[1][0, 2] >= 0).all()


def test_layout_rule_and_constants_are_the_kernels():
    """No scratch where a list of every vertex fits the block's shared
    memory, else a whole list's state an area; the launcher's budget and
    state formula are the kernel's, whose C entry grants a list of every
    vertex and the map up to that budget."""
    assert spf.sub_repair_scratch_ints(4096, 124, 4) == 0
    n = spf.MAX_KERNEL_NODES
    assert spf.sub_repair_scratch_ints(n, 4 * n, 4) == spf.sub_repair_state_ints(n, 4 * n, 4)
    assert spf.sub_repair_state_ints(10, 7, 33) == (8 + 2) * 10 + 1 + 3 * 7
    cu = (Path(spf.__file__).parents[1] / "kernels" / "csrc" / "spf_warm.cu").read_text()
    m = re.search(r"constexpr int kRepairSmemMax = (\d+) - (\d+);", cu)
    assert int(m[1]) - int(m[2]) == spf.SUB_REPAIR_SHARED_BYTES
    assert "return (size_t)(8 + W) * n + 1 + 3 * (size_t)Es;" in cu
    assert "const size_t want = need + 4 * (size_t)V;" in cu


def test_launcher_refuses_cpu_tensors():
    sub, prev_d, prev_n, reset, D, _cd, _cn = inputs("grid", "ball")
    with pytest.raises(ValueError):
        spf.warm_subgraph_repair_launcher(*sub, prev_d, prev_n, reset, D)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _run(card, sub, prev_d, prev_n, reset, D):
    args = [t.to(card) for t in (*sub, prev_d, prev_n, reset)]
    reset_launch_counts()
    got = spf.warm_subgraph_repair(*args, D)
    torch.cuda.synchronize()
    assert LAUNCHES["warm_subgraph_repair"] == 1
    want = spf.warm_subgraph_repair_plain(*args, D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


CUDA_CASES = [(w, r) for w in sorted(WORLDS) for r in RULES]


@pytest.mark.cuda
@pytest.mark.parametrize("world, rule", CUDA_CASES)
def test_bounded_repair_list_kernel_equals_plain(card, world, rule):
    """Kernel 6 against its plain version (and the cold tables)."""
    sub, prev_d, prev_n, reset, D, cold_d, cold_n = inputs(world, rule)
    dist, nh, rounds_d, rounds_l = _run(card, sub, prev_d, prev_n, reset, D)
    assert torch.equal(dist.cpu(), cold_d) and torch.equal(nh.cpu(), cold_n)
    n = reset.sum(dim=1)
    for a in range(n.shape[0]):
        if int(n[a]) == 0:
            assert int(rounds_d[a]) == int(rounds_l[a]) == 0
        else:
            assert 1 <= int(rounds_d[a]) <= int(n[a]) + 1
            assert 1 <= int(rounds_l[a]) <= int(n[a]) + 1


@pytest.mark.cuda
def test_bounded_repair_kernel_reset_vertex_without_sub_edges(card):
    V, D = 6, 4
    sub = [torch.tensor([[0, 1, 0, 0]], dtype=torch.int32),
           torch.tensor([[1, 2, 2, 2]], dtype=torch.int32),
           torch.tensor([[1, 1, np.inf, np.inf]], dtype=torch.float32),
           torch.tensor([[True, True, False, False]]),
           torch.tensor([[0, -1, -1, -1]], dtype=torch.int32)]
    prev_d = torch.tensor([[0, 1, 2, 9, 3e38, 3e38]], dtype=torch.float32)
    prev_n = torch.zeros((1, V, D), dtype=torch.int8)
    prev_n[0, 1:4, 0] = 1
    reset = torch.tensor([[False, True, True, True, False, False]])
    _d, nh, _rd, _rl = _run(card, sub, prev_d, prev_n, reset, D)
    assert (nh[0, 3] == -128).all()


def big_grid(side, V, seed=0):
    """Segment tensors of a side x side grid (both directions, metrics
    1-4, root 0) padded to V vertices (the rest without an edge)."""
    rng = np.random.default_rng(seed)
    ids = np.arange(side * side).reshape(side, side)
    a = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    b = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    m = rng.integers(1, 5, a.size)
    src, dst, w = np.concatenate([a, b]), np.concatenate([b, a]), np.concatenate([m, m])
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order].astype(np.float32)
    E = src.size
    return [torch.from_numpy(x) for x in (
        src[None].astype(np.int32), dst[None].astype(np.int32), w[None],
        np.ones((1, E), bool), np.zeros((1, V), bool), np.zeros(1, np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["band", "half"])
def test_bounded_repair_kernel_near_the_node_bound(card, rule):
    """A 241 x 241 grid padded to MAX_KERNEL_NODES vertices: a band of a few
    thousand reset vertices (its list in shared memory) and half of every
    vertex (past shared memory: the global scratch)."""
    V = spf.MAX_KERNEL_NODES
    seg = [t.to(card) for t in big_grid(241, V)]
    D = 4
    cold_d, cold_n = cold_tables(seg, D)
    d = cold_d.cpu().numpy()
    if rule == "band":
        reset = (d >= 100) & (d < 135)
    else:
        reset = np.random.default_rng(1).random(d.shape) < 0.5
        reset[:, -20:] = True  # vertices without an edge: -128
    reset[0, 0] = False
    src, dst = seg[0].cpu().numpy(), seg[1].cpu().numpy()
    pos = np.nonzero(reset[0][dst[0]])[0]
    rank = np.where(src[0] == 0, np.cumsum(src[0] == 0) - 1, -1).astype(np.int32)
    sub = [torch.from_numpy(x[:, pos].copy()) for x in (
        src, dst, seg[2].cpu().numpy(), seg[3].cpu().numpy(), rank[None])]
    n = int(reset.sum())
    need = 4 * spf.sub_repair_state_ints(n, pos.size, D)
    assert (need <= spf.SUB_REPAIR_SHARED_BYTES) == (rule == "band") and n > 1024
    dist, nh, _rd, _rl = _run(card, sub, cold_d.cpu(), cold_n.cpu(), torch.from_numpy(reset), D)
    assert torch.equal(dist, cold_d) and torch.equal(nh, cold_n)


@pytest.mark.cuda
def test_bounded_repair_kernel_three_areas_past_shared_memory(card):
    """Three 90 x 90 grids (metrics of their own) in one launch at D = 40,
    the root's two lanes moved to 33 and 38 (the second lane word): every
    vertex but the root reset in area 0, a band in area 1 and none in area
    2.  Area 0's list is past shared memory, and the records of the
    launch's Es put every area's state in the global scratch."""
    side, D = 90, 40
    V = side * side
    seg = [torch.cat(parts).to(card) for parts in zip(*(big_grid(side, V, s) for s in range(3)))]
    cold_d, cold_n = cold_tables(seg, D)
    perm = torch.arange(D)
    perm[[0, 1, 33, 38]] = torch.tensor([33, 38, 0, 1])
    cold_n = cold_n[..., perm.to(card)]
    d = cold_d.cpu().numpy()
    reset = np.zeros((3, V), bool)
    reset[0] = True
    reset[1] = (d[1] >= 60) & (d[1] < 80)
    reset[:, 0] = False
    src, dst, w, ok = (t.cpu().numpy() for t in seg[:4])
    lane = np.full(src.shape[1], -1, np.int32)
    lane[np.nonzero(src[0] == 0)[0]] = (33, 38)
    pos = [np.nonzero(reset[a][dst[a]])[0] for a in range(3)]
    Es = max(p.size for p in pos)
    sub = [np.zeros((3, Es), np.int32), np.full((3, Es), V - 1, np.int32),
           np.full((3, Es), np.inf, np.float32), np.zeros((3, Es), bool),
           np.full((3, Es), -1, np.int32)]
    for a, p in enumerate(pos):
        for out, x in zip(sub, (src[a], dst[a], w[a], ok[a], lane)):
            out[a, :p.size] = x[p]
        if p.size:
            sub[1][a, p.size:] = dst[a, p[-1]]
    n = reset.sum(axis=1)
    assert 4 * spf.sub_repair_state_ints(int(n[0]), Es, D) > spf.SUB_REPAIR_SHARED_BYTES
    assert spf.sub_repair_scratch_ints(V, Es, D) > 0 and n[1] > 32 and n[2] == 0
    dist, nh, rounds_d, _rl = _run(card, [torch.from_numpy(x) for x in sub], cold_d.cpu(),
                                   cold_n.cpu(), torch.from_numpy(reset), D)
    assert torch.equal(dist, cold_d) and torch.equal(nh, cold_n)
    assert int(rounds_d[2]) == 0 and int(rounds_d[0]) > 1
