"""The port's batched multi-area tables (``ops/fleet_tables.py``) and the
segment-form cold SPF twins against the JAX package's, bit for bit.

Each world is built with the reference's types and carried across as
wire dicts; each package encodes its topology, and the same vantage roots, failure sets and candidate table (the
reference's) go through the reference's jitted functions (on the CPU) and
the port's plain PyTorch versions.  Worlds:
the 4x4 grid of ``tests/test_fleet.py`` (soft drain, overloaded node,
anycast), its two-area world (roots absent from one area), the two-area
what-if world of ``tests/test_whatif_multiarea.py`` and a world where the
vantage is isolated in one area (its root row there holds the int8 -128
fill).  Tolerance: exact equality of every output (f32 distances, int8
lanes with the -128 fill and the absent-area zeros, use, shortest, lanes,
valid, changed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.backend import DEGREE_BUCKETS
from openr_tpu.decision.cand_table import CandidateTable as RefTable
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.emulation.topology import build_adj_dbs, grid_edges, ring_edges
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops import fleet_tables as jft
from openr_tpu.ops.route_select import multi_area_spf_tables as jax_segment_tables
from openr_tpu.ops.route_select import multi_area_spf_tables_dense as jax_dense_tables
from openr_tpu.types import PrefixEntry, PrefixMetrics
from openr_tpu_torch.interop import lsdb_from_wire, tables_from_numpy
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import fleet_tables as tft
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.route_select import multi_area_spf_tables
from tests.test_torch_spf import lsdb_to_wire

SEGMENT = ("src", "dst", "w", "edge_ok", "overloaded")
DENSE = ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded")
CAND = ("cand_area", "cand_node", "cand_ok", "drain_metric", "path_pref",
        "source_pref", "distance", "cand_node_in_area")


def _ls(edges, area, **kw):
    ls = LinkState(area)
    for db in build_adj_dbs(edges, area=area, **kw).values():
        ls.update_adjacency_database(db)
    return ls


def grid_world():
    """tests/test_fleet.py:29 with a soft drain and an overloaded node."""
    areas = {"0": _ls(grid_edges(4), "0", soft_drained={"node10": 60}, overloaded=["node5"])}
    ps = PrefixState()
    for i in range(16):
        ps.update_prefix(f"node{i}", "0", PrefixEntry(f"10.{i}.0.0/24"))
    for node in ("node3", "node12"):
        ps.update_prefix(node, "0", PrefixEntry(
            "10.100.0.0/24", metrics=PrefixMetrics(path_preference=1000)))
    ps.update_prefix("node7", "0", PrefixEntry("2001:db8::/64"))
    return areas, ps, "node0"


def two_area_fleet_world():
    """tests/test_fleet.py:164: most roots are absent from one area."""
    areas = {
        "1": _ls(grid_edges(3), "1"),
        "2": _ls(ring_edges(6, prefix="b") + [("b0", "node0", 1)], "2"),
    }
    ps = PrefixState()
    for node, area, p in (("node8", "1", "10.0.0.0/24"), ("b3", "2", "10.1.0.0/24"),
                          ("b4", "2", "10.2.0.0/24"), ("node2", "1", "10.77.0.0/24"),
                          ("b2", "2", "10.77.0.0/24")):
        ps.update_prefix(node, area, PrefixEntry(p))
    return areas, ps, "node0"


def whatif_world():
    """tests/test_whatif_multiarea.py:29, vantage b0 on the border."""
    areas = {
        "1": _ls([("a0", "a1", 1), ("a1", "b0", 1), ("a0", "b0", 3)], "1"),
        "2": _ls(ring_edges(4, prefix="b"), "2"),
    }
    ps = PrefixState()
    ps.update_prefix("a0", "1", PrefixEntry("10.0.0.0/24"))
    ps.update_prefix("b2", "2", PrefixEntry("10.1.0.0/24"))
    ps.update_prefix("b1", "2", PrefixEntry("2001:db8::/64"))
    for node, area in (("a1", "1"), ("b3", "2")):
        ps.update_prefix(node, area, PrefixEntry(
            "10.9.0.0/24", metrics=PrefixMetrics(path_preference=700)))
    return areas, ps, "b0"


def isolated_world():
    """The vantage node0 has no adjacency in area 2: interned there, its
    root has no in-edges and its lane row is the -128 fill."""
    areas = {"1": _ls(grid_edges(3), "1"), "2": _ls([("w0", "w1", 2), ("w1", "w2", 1)], "2")}
    ps = PrefixState()
    for node, area, p in (("node8", "1", "10.0.0.0/24"), ("w2", "2", "10.2.0.0/24"),
                          ("w0", "2", "10.3.0.0/24")):
        ps.update_prefix(node, area, PrefixEntry(p))
    return areas, ps, "node0"


WORLDS = {
    "grid": grid_world,
    "two_area_fleet": two_area_fleet_world,
    "whatif": whatif_world,
    "isolated": isolated_world,
}


class Pair:
    """One world encoded by both packages, with its candidate tables."""

    def __init__(self, world):
        areas, ps, me = WORLDS[world]()
        self.me = me
        self.ref = jcsr.encode_multi_area(areas, me)
        adj_wire, _ = lsdb_to_wire(areas, PrefixState())
        port_areas, _ = lsdb_from_wire(adj_wire, {}, my_node_name=me)
        self.port = tcsr.encode_multi_area(port_areas, me)
        # one candidate table for both (its row order follows the order
        # prefixes arrive in, which the wire round trip changes)
        table = RefTable()
        table.full_sync(ps)
        self.dv = table.derived(self.ref)
        self.D = jcsr.bucket_for(max(self.ref.max_out_degree(), 1), DEGREE_BUCKETS)
        names = sorted(set().union(*[set(t.node_ids) for t in self.ref.topos]))
        self.roots = np.asarray(
            [[t.node_ids.get(n, -1) for t in self.ref.topos] for n in names], np.int32
        )

    def jax(self, enc_or_dv, fields):
        return {k: jnp.asarray(getattr(enc_or_dv, k)) for k in fields}

    def torch(self, enc_or_dv, fields):
        return dict(zip(fields, tables_from_numpy([getattr(enc_or_dv, k) for k in fields])))

    def jax_cand(self):
        return self.jax(self.dv, CAND)

    def port_cand(self):
        return self.torch(self.dv, CAND)


def assert_same(port_outs, ref_outs):
    assert len(port_outs) == len(ref_outs)
    for got, want in zip(port_outs, ref_outs):
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_segment_twins_match_reference(world):
    """``spf_one`` / ``multi_area_spf_tables`` (segment form) from every
    node of each area, against ``spf_distances`` + ``spf_nexthop_lanes``."""
    pair = Pair(world)
    seg_j = pair.jax(pair.ref, SEGMENT)
    seg_t = pair.torch(pair.port, SEGMENT)
    root_sets = [pair.ref.roots] + [np.clip(pair.roots[i], 0, None) for i in range(len(pair.roots))]
    for roots in root_sets:
        want = jax_segment_tables(**seg_j, roots=jnp.asarray(roots), max_degree=pair.D)
        got = multi_area_spf_tables(*seg_t.values(), torch.from_numpy(roots), pair.D)
        assert_same(got, want)


def test_isolated_root_row_is_the_fill():
    pair = Pair("isolated")
    seg_t = pair.torch(pair.port, SEGMENT)
    dist, nh = multi_area_spf_tables(*seg_t.values(), torch.from_numpy(pair.port.roots), pair.D)
    root2 = int(pair.port.roots[1])
    assert float(dist[1, root2]) == 0.0
    assert bool((nh[1, root2] == -128).all())


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fleet_tables_match_reference(world, per_area):
    """Both forms of the fleet tables, every vantage root of the world."""
    pair = Pair(world)
    roots_j, roots_t = jnp.asarray(pair.roots), torch.from_numpy(pair.roots)
    kw = dict(max_degree=pair.D, per_area_distance=per_area)
    want = jft.fleet_multi_area_tables(
        **pair.jax(pair.ref, SEGMENT), soft=jnp.asarray(pair.ref.soft), roots=roots_j,
        **pair.jax_cand(), **kw,
    )
    seg = pair.torch(pair.port, SEGMENT)
    soft = torch.from_numpy(pair.port.soft)
    got = tft.fleet_multi_area_tables(
        **seg, soft=soft, roots=roots_t, **pair.port_cand(), **kw
    )
    assert_same(got, want)
    if pair.ref.has_dense:
        want_d = jft.fleet_multi_area_tables_dense(
            **pair.jax(pair.ref, DENSE), soft=jnp.asarray(pair.ref.soft), roots=roots_j,
            **pair.jax_cand(), **kw,
        )
        got_d = tft.fleet_multi_area_tables_dense(
            **pair.torch(pair.port, DENSE), soft=soft, roots=roots_t, **pair.port_cand(), **kw
        )
        assert_same(got_d, want_d)
        assert_same(got_d, [np.asarray(w) for w in want])


@pytest.mark.parametrize("world", ["two_area_fleet", "isolated"])
def test_absent_areas_read_unreachable(world):
    """A root of -1 gives dist BIG and lanes 0 (not -128) over its slice,
    in both batch SPF forms."""
    pair = Pair(world)
    roots = torch.from_numpy(pair.roots)
    absent = roots < 0
    assert bool(absent.any())
    outs = [tspf.spf_segment_batch(*pair.torch(pair.port, SEGMENT).values(), roots, pair.D)]
    if pair.port.has_dense:
        outs.append(tspf.fleet_spf_dense(*pair.torch(pair.port, DENSE).values(), roots, pair.D))
    for dist, nh in outs:
        assert bool((dist[absent] == tspf.BIG).all())
        assert bool((nh[absent] == 0).all())
    if len(outs) == 2:
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("world", ["grid", "two_area_fleet"])
def test_fleet_delta_matches_reference(world):
    """The delta against a perturbed previous generation: rows the
    perturbation touched report changed, the rest do not."""
    pair = Pair(world)
    roots_j, roots_t = jnp.asarray(pair.roots), torch.from_numpy(pair.roots)
    kw = dict(max_degree=pair.D, per_area_distance=False)
    base = [np.asarray(a) for a in jft.fleet_multi_area_tables_dense(
        **pair.jax(pair.ref, DENSE), soft=jnp.asarray(pair.ref.soft), roots=roots_j,
        **pair.jax_cand(), **kw,
    )]
    B = len(pair.roots)
    prev = [a.copy() for a in base]
    prev[0][1] = ~prev[0][1]  # use of root 1
    prev[1][B // 2, 0, 0] += 1.0  # shortest of the middle root
    prev[2][B - 1] = ~prev[2][B - 1]  # lanes of the last root
    want = jft.fleet_multi_area_tables_dense_delta(
        **pair.jax(pair.ref, DENSE), soft=jnp.asarray(pair.ref.soft), roots=roots_j,
        **pair.jax_cand(), prev_use=prev[0], prev_shortest=prev[1], prev_lanes=prev[2],
        prev_valid=prev[3], **kw,
    )
    got = tft.fleet_multi_area_tables_dense_delta(
        **pair.torch(pair.port, DENSE), soft=torch.from_numpy(pair.port.soft), roots=roots_t,
        **pair.port_cand(), **dict(zip(
            ("prev_use", "prev_shortest", "prev_lanes", "prev_valid"), tables_from_numpy(prev)
        )), **kw,
    )
    assert_same(got, want)
    changed = got[4].numpy()
    assert changed[[1, B // 2, B - 1]].all() and changed.sum() == 3


def _fail_sets(pair, S):
    """Every link of every area alone, then sets of S links across areas,
    -1 padded (one row only pads), plus the all-pad base row."""
    links = [(ai, li) for ai, t in enumerate(pair.ref.topos) for li in range(len(t.links))]
    rows = [[lk] for lk in links]
    rng = np.random.default_rng(S)
    for _ in range(6):
        pick = rng.choice(len(links), size=min(S, len(links)), replace=False)
        rows.append([links[i] for i in pick])
    rows.append([links[0]] + [(-1, -1)] * (S - 1))
    rows.append([])
    fa = np.full((len(rows), S), -1, np.int32)
    fl = np.full((len(rows), S), -1, np.int32)
    for i, r in enumerate(rows):
        for s, (ai, li) in enumerate(r):
            fa[i, s], fl[i, s] = ai, li
    return fa, fl


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("world", ["whatif", "isolated", "grid"])
def test_whatif_tables_match_reference(world, S):
    pair = Pair(world)
    fa, fl = _fail_sets(pair, S)
    link_index = np.stack([t.link_index for t in pair.ref.topos])
    kw = dict(max_degree=pair.D, per_area_distance=False)
    want = jft.whatif_multi_area_tables(
        **pair.jax(pair.ref, SEGMENT[:4]), link_index=jnp.asarray(link_index),
        overloaded=jnp.asarray(pair.ref.overloaded), soft=jnp.asarray(pair.ref.soft),
        roots=jnp.asarray(pair.ref.roots), fail_area=jnp.asarray(fa),
        fail_link=jnp.asarray(fl), **pair.jax_cand(), **kw,
    )
    seg = pair.torch(pair.port, SEGMENT)
    got = tft.whatif_multi_area_tables(
        *(seg[k] for k in SEGMENT[:4]), torch.from_numpy(link_index), seg["overloaded"],
        torch.from_numpy(pair.port.soft), torch.from_numpy(pair.port.roots),
        torch.from_numpy(fa), torch.from_numpy(fl), *pair.port_cand().values(), **kw,
    )
    assert_same(got, want)


def test_failed_edge_mask_pads_mask_nothing():
    """A -1 pad in a set masks no edge, not even a padding edge (whose
    link id is also -1); a member masks its link in its own area only."""
    link_index = torch.tensor([[0, 0, 1, 1, -1, -1], [0, 0, -1, -1, -1, -1]], dtype=torch.int32)
    fa = torch.tensor([[-1, -1], [0, -1], [1, 0]], dtype=torch.int32)
    fl = torch.tensor([[-1, -1], [1, -1], [0, -1]], dtype=torch.int32)
    mask = tspf.failed_edge_mask(link_index, fa, fl)
    assert not bool(mask[0].any())
    assert mask[1].tolist() == [[False, False, True, True, False, False], [False] * 6]
    assert mask[2].tolist() == [[False] * 6, [True, True, False, False, False, False]]


def test_segment_equals_dense_on_the_grid():
    """tests/test_stream_delta.py:96's bar: the segment tables equal the
    dense ones bit for bit, here for every vantage root of the grid."""
    pair = Pair("grid")
    roots = torch.from_numpy(pair.roots)
    seg = tspf.spf_segment_batch(*pair.torch(pair.port, SEGMENT).values(), roots, pair.D)
    dense = tspf.fleet_spf_dense(*pair.torch(pair.port, DENSE).values(), roots, pair.D)
    assert torch.equal(seg[0], dense[0]) and torch.equal(seg[1], dense[1])
    want = jax_dense_tables(**pair.jax(pair.ref, DENSE), roots=jnp.asarray(pair.ref.roots),
                            max_degree=pair.D)
    assert_same(tspf.spf_one(*pair.torch(pair.port, SEGMENT).values(),
                             torch.from_numpy(pair.port.roots), pair.D), want)
