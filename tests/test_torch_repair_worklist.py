"""Kernel 9 (``repair_sweep``) as redesigned for the card, on the CPU: a
torch model of its list-restricted repair, held against the port's plain
version and the reference's jitted ``_repair_sweep_impl`` (through
``openr_tpu.ops.repair.RepairSweep``).

* The model works one 32-snapshot word at a time, as a cluster of the
  kernel does: its LIST is the union of its snapshots' affected vertices
  (every vertex when the base is a warm seed); the distance rounds relax
  the listed vertices only (an unlisted one keeps its base distance), the
  DAG membership words cover the listed vertices' pull slots only, the
  seeds are set on listed vertices, and the synchronous lane rounds
  replace the listed vertices' words only, an unlisted neighbour holding
  its base lanes in every snapshot.  With an exact base (the plan's own
  solve) that equals the full repair on the worlds of
  ``tests/test_torch_repair_sweep.py``: ``wan11``, ``grid6``,
  ``overloaded`` and ``line``, with single failures (the root's links,
  every link, off-DAG ones included, and -1 pads, a whole word of them
  too) and sets of 2 and 3 links with -1 pads.
* The warm-base mode: ``LinkFailureSweep``'s warm base solve of a second
  generation with an added link, a cheapened one and a raised one, its
  lanes seeded from zero.  The engine passes ``exact_base=False`` there
  (and True for its plan's chunks); the model in that mode lists every
  vertex and equals the plain version and the cold base, while the
  union-only work set (empty: the warm plan marks no link) leaves the
  over-estimate in place and gives a wrong table.

The kernel itself is held against its plain version by the ``cuda`` tests
of ``tests/test_torch_kernels_cuda.py``.  Tolerance: exact equality
(unique fixed points, integral metrics).
"""

import numpy as np
import pytest
import torch

from openr_tpu.emulation import topology as jtopo
from openr_tpu.ops import repair as jrepair
from openr_tpu_torch.interop import repair_plan_from_fields
from openr_tpu_torch.ops import repair as trepair
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.whatif import LinkFailureSweep
from tests.test_torch_repair_sweep import encode_both, engines, failure_sets, link_failures

WORDS = 32
ALL_ONES = (1 << 32) - 1


def pack32(bits):
    """[..., 32] bool -> [...] int64 word, bit k from column k."""
    return (bits.to(torch.int64) << torch.arange(WORDS)).sum(-1)


def worklist_model(src, dst, w, lid, tsok, fails, aff_table, base_dist, base_nh, nbr_flat,
                   pull_perm, pull_valid, nbr_is_root, seed_v, seed_r, seed_slot, d_lanes: int,
                   din: int, exact_base: bool):
    """Kernel 9's repair (the arguments of ``repair_sweep_plain``), word by
    word over each word's list.  Returns (dist [V, B] f32, nh [V, D, B/32]
    int32 words, the listed vertices of each word)."""
    V = base_dist.shape[0]
    B = fails.shape[0]
    D = d_lanes
    aff, d0, en = trepair.repair_sweep_init(lid, fails, aff_table, base_dist, V)
    ok = en & tsok[:, None]
    src_l, dst_l = src.long(), dst.long()
    big = torch.tensor(BIG, dtype=torch.float32)
    # the base lanes as words: all ones where the base lane is set
    base_word = (0 - base_nh.to(torch.int64)) & ALL_ONES
    slot_v = torch.arange(V * din) // din
    e_slot = pull_perm.long()
    nbr = nbr_flat.long()
    dist = torch.empty((V, B), dtype=torch.float32)
    nh = torch.empty((V, D, B // WORDS), dtype=torch.int32)
    lists = []
    for word in range(B // WORDS):
        cols = slice(WORDS * word, WORDS * word + WORDS)
        listed = aff[:, cols].any(1) if exact_base else torch.ones(V, dtype=torch.bool)
        lists.append(torch.nonzero(listed).flatten())
        # distances: only the in-edges of listed vertices relax
        okw = ok[:, cols] & listed[dst_l][:, None]
        d = d0[:, cols].clone()
        while True:
            cand = torch.where(okw, d[src_l] + w[:, None], big)
            nd = torch.minimum(d, tspf.segment_reduce(cand[None], dst[None], V, "amin",
                                                      float("inf"))[0])
            if torch.equal(nd, d):
                break
            d = nd
        assert torch.equal(d[~listed], d0[:, cols][~listed])
        # DAG membership of the listed vertices' pull slots
        dv = d[slot_v]
        on = ((pull_valid & listed[slot_v])[:, None] & ok[e_slot][:, cols] & (dv < big)
              & (d[src_l[e_slot]] + w[e_slot][:, None] == dv))
        member = pack32(on)
        seed = torch.zeros((V, D), dtype=torch.int64)
        for v, r, sl in zip(seed_v.tolist(), seed_r.tolist(), seed_slot.tolist()):
            if listed[v] and 0 <= r < D:
                seed[v, r] = max(int(seed[v, r]), int(member[sl]))
        naff = pack32(~aff[:, cols])
        cur = torch.where(listed[:, None], (base_word & naff[:, None]) | seed, base_word)
        prop = torch.where(nbr_is_root, torch.zeros_like(member), member)
        # synchronous lane rounds over the listed vertices
        while True:
            g = (cur[nbr] & prop[:, None]).reshape(V, din, D)
            acc = seed.clone()
            for k in range(din):
                acc |= g[:, k]
            new = torch.where(listed[:, None], acc, cur)
            if torch.equal(new, cur):
                break
            cur = new
        dist[:, cols] = d
        nh[:, :, word] = torch.where(cur > ALL_ONES >> 1, cur - (1 << 32), cur).to(torch.int32)
    return dist, nh, lists


def port_args(plan, topo, fails):
    """The arguments of ``repair_sweep_plain`` for a port plan."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    if fails.ndim == 1:
        fails = fails[:, None]
    return (
        t(topo.src), t(topo.dst), t(topo.w), t(topo.link_index), t(plan.transit_src_ok),
        t(fails), t(plan.aff_link_words.view(np.int32)), t(plan.base_dist), t(plan.base_nh),
        t(plan.nbr_flat), t(plan.pull_perm), t(plan.pull_valid), t(plan.nbr_is_root),
        t(plan.seed_v), t(plan.seed_r), t(plan.seed_slot),
    ), dict(d_lanes=plan.lanes, din=plan.din)


def held(world, fails):
    """The model (exact base) against the plain version and the reference
    on the reference planner's own plan; returns the words' lists."""
    rt, pt, ref, _ = engines(world)
    rplan = ref.plan()
    plan = repair_plan_from_fields(vars(rplan))
    args, kw = port_args(plan, pt, fails)
    dist, nh, lists = worklist_model(*args, **kw, exact_base=True)
    pd, pn, _, _ = trepair.repair_sweep_plain(*args, **kw)
    assert torch.equal(dist, pd) and torch.equal(nh, pn)
    want_d, want_n, _, _ = jrepair.RepairSweep(rt, rplan).solve(fails)
    assert np.array_equal(dist.numpy(), np.asarray(want_d))
    assert np.array_equal(nh.numpy().view(np.uint32), np.asarray(want_n))
    return plan, pt, lists


@pytest.mark.parametrize("world", ["wan11", "grid6", "overloaded", "line"])
def test_worklist_model_equals_plain_and_reference_on_single_failures(world):
    rt, _pt, _ref, _ = engines(world)
    fails = np.concatenate([link_failures(rt, world), np.full(WORDS, -1, np.int32)])
    plan, pt, lists = held(world, fails)
    V = pt.padded_nodes
    # -1 pads are in the batch, off-DAG links on the WANs; the last word
    # is all pads
    assert (fails < 0).any() and len(lists[-1]) == 0
    if world in ("wan11", "overloaded"):
        assert not plan.on_dag_link[fails[fails >= 0]].all()
    sizes = [len(x) for x in lists]
    assert max(sizes) > 0
    if world != "line":  # a word's list is a part of the graph
        assert min(sizes[:-1]) < V


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("world", ["wan11", "grid6", "overloaded", "line"])
def test_worklist_model_equals_plain_and_reference_on_sets(world, k):
    rt, _pt, _ref, _ = engines(world)
    sets = failure_sets(rt, k, seed=10 + k)
    assert (sets < 0).any()  # -1 pads
    _plan, _pt, lists = held(world, sets)
    assert all(len(x) > 0 for x in lists)


def second_generation(edges):
    """The same LSDB with a link added between two nodes that had none,
    one link cheapened and one raised (the warm seed resets below it)."""
    linked = {frozenset(e[:2]) for e in edges}
    names = sorted({n for e in edges for n in e[:2]})
    added = next((a, b) for a in names for b in names
                 if a < b and frozenset((a, b)) not in linked and "node0" not in (a, b))
    changed = [(u, v, (m + 7 if i == 3 else max(1, m - 2) if i == 20 else m))
               for i, (u, v, m) in enumerate(edges)]
    return changed + [(added[0], added[1], 1)]


def test_warm_base_mode_lists_every_vertex_and_the_union_alone_is_wrong(monkeypatch):
    edges = jtopo.random_connected_edges(48, 64, seed=21)
    _rt, pt = encode_both(edges)
    _rt2, pt2 = encode_both(second_generation(edges))
    old = LinkFailureSweep(pt, "node0", device="cpu")
    old.plan()
    eng = LinkFailureSweep(pt2, "node0", device="cpu")
    assert eng.seed_base_from(old)
    calls = []
    real = trepair.repair_sweep

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(trepair, "repair_sweep", record)
    base = eng.base_solve()
    assert eng.base_source == "warm" and len(calls) == 1
    args, kw = calls[0]
    # the engine says where its plan came from: a warm seed
    assert kw.pop("exact_base") is False
    V = pt2.padded_nodes
    cold = LinkFailureSweep(pt2, "node0", device="cpu").base_solve()
    assert np.array_equal(base[0], cold[0]) and np.array_equal(base[1], cold[1])
    # the seed really is an over-estimate that an improvement lowers
    assert (args[7].numpy() > cold[0]).any()
    for lanes in ("seed", "zero"):
        a = list(args)
        if lanes == "zero":
            a[8] = torch.zeros_like(a[8])
        pd, pn, _, _ = trepair.repair_sweep_plain(*a, **kw)
        dist, nh, lists = worklist_model(*a, **kw, exact_base=False)
        assert all(len(x) == V for x in lists)  # every vertex listed
        assert torch.equal(dist, pd) and torch.equal(nh, pn)
        assert np.array_equal(dist[:, 0].numpy(), cold[0])
        assert np.array_equal((nh[:, :, 0] & 1).to(torch.int8).numpy(), cold[1])
        # the union-only work set: nothing listed, the seed left in place
        wrong, _nh, empty = worklist_model(*a, **kw, exact_base=True)
        assert all(len(x) == 0 for x in empty)
        assert not torch.equal(wrong, pd)
    # the plan's chunks run over each word's union: the base is exact now
    fails = link_failures(pt2, "warm")
    calls.clear()
    eng.run(fails)
    assert calls and all(kwargs["exact_base"] is True for _a, kwargs in calls)
    assert eng.repair_sweep().exact_base is True
