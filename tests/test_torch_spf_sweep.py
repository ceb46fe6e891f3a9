"""The port's cold batch-minor link-failure sweep (``ops/spf.py``
``sweep_spf_link_failures``, the plain version of kernel 8) against the
JAX package's ``sweep_spf_link_failures``, exactly.

The same LSDB is encoded by both packages (array for array), then the
same failure batch — the unperturbed snapshot, every link, and seeded
random draws — goes through both.  The port keeps the int8 lane form; the
reference's packed-channel form (``packed=True``) must decode
(``unpack_lanes``) to the port's lanes above zero.  Tolerance: exact
equality (integral metrics keep every f32 sum exact; the fixed points are
unique).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.link_state import LinkState
from openr_tpu.emulation import topology as jtopo
from openr_tpu.ops import spf as jspf
from openr_tpu.ops.csr import encode_link_state
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision.link_state import LinkState as PortLinkState
from openr_tpu_torch.emulation import topology as ttopo
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.whatif import root_lane_count

EDGE_FIELDS = ("src", "dst", "w", "edge_ok", "link_index", "overloaded")


def encode_both(edges, **drains):
    ref, port = LinkState("0"), PortLinkState("0")
    for db in jtopo.build_adj_dbs(edges, **drains).values():
        ref.update_adjacency_database(db)
        port.update_adjacency_database(ttypes.AdjacencyDatabase.from_wire(db.to_wire()))
    rt, pt = encode_link_state(ref), tcsr.encode_link_state(port)
    for f in EDGE_FIELDS:
        assert np.array_equal(getattr(rt, f), getattr(pt, f)), f
    return rt, pt


WORLDS = {
    "wan48": lambda: encode_both(jtopo.random_connected_edges(48, 64, seed=11)),
    "grid6": lambda: encode_both(jtopo.grid_edges(6)),
    "overloaded": lambda: encode_both(
        jtopo.random_connected_edges(48, 64, seed=5), overloaded=["node7", "node9"]
    ),
    "line": lambda: encode_both(jtopo.line_edges(8)),
}


def failure_batch(topo, seed):
    L = len(topo.links)
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[-1], np.arange(L), rng.integers(-1, L, size=40)]
    ).astype(np.int32)


def port_sweep(topo, fails, D, root=0):
    t = [torch.from_numpy(np.ascontiguousarray(getattr(topo, f))) for f in EDGE_FIELDS]
    src, dst, w, ok, li, ovl = t
    return tspf.sweep_spf_link_failures(
        src, dst, w, ok, li, torch.from_numpy(fails), ovl, root, D
    )


def jax_sweep(topo, fails, D, packed, root=0):
    d, nh = jspf.sweep_spf_link_failures(
        *(jnp.asarray(getattr(topo, f)) for f in ("src", "dst", "w", "edge_ok", "link_index")),
        jnp.asarray(fails),
        jnp.asarray(topo.overloaded),
        jnp.int32(root),
        max_degree=D,
        packed=packed,
    )
    return np.asarray(d), np.asarray(nh)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_cold_sweep_matches_reference_int8(world):
    rt, pt = WORLDS[world]()
    fails = failure_batch(rt, seed=3)
    D = rt.max_out_degree()
    want_d, want_n = jax_sweep(rt, fails, D, packed=False)
    dist, nh, rounds_d, rounds_l = port_sweep(pt, fails, D)
    assert dist.dtype == torch.float32 and nh.dtype == torch.int8
    assert np.array_equal(dist.numpy(), want_d)
    assert np.array_equal(nh.numpy(), want_n)
    assert rounds_d >= 1 and rounds_l >= 1


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_cold_sweep_matches_reference_packed(world):
    rt, pt = WORLDS[world]()
    fails = failure_batch(rt, seed=4)
    D = rt.max_out_degree()
    assert rt.max_out_degree() <= jspf.PACKED_MAX_IN_DEGREE
    want_d, packed = jax_sweep(rt, fails, D, packed=True)
    assert packed.shape[-1] == tspf.lane_channels(D) == jspf.lane_channels(D)
    dist, nh, _, _ = port_sweep(pt, fails, D)
    assert np.array_equal(dist.numpy(), want_d)
    unpacked = tspf.unpack_lanes(packed, D)
    assert np.array_equal(unpacked, np.asarray(jspf.unpack_lanes(packed, D)))
    assert np.array_equal((nh.numpy() > 0).astype(np.int8), unpacked)


def test_cold_sweep_disconnects_and_fills():
    """Failing a bridge of a line leaves the tail at BIG with no lanes; the
    padded vertices absent from the edge list keep the -128 fill."""
    rt, pt = WORLDS["line"]()
    fails = np.full(32, -1, np.int32)
    fails[:7] = np.arange(7)
    dist, nh, _, _ = port_sweep(pt, fails, root_lane_count(pt, 0))
    node = {n: pt.node_id(f"node{n}") for n in range(8)}
    for v in range(3, 8):
        assert dist[node[v], 2] >= 3.0e38 and not (nh[node[v], 2] > 0).any()
    absent = [v for v in range(pt.padded_nodes) if v not in set(pt.dst.tolist())]
    assert absent and (nh[absent] == tspf.INT8_MIN).all()


def test_unpack_lanes_matches_reference():
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 2**30, size=(5, 7, 3), dtype=np.uint32)
    assert np.array_equal(tspf.unpack_lanes(packed, 17), np.asarray(jspf.unpack_lanes(packed, 17)))


def test_headline_world_generator_matches_reference():
    """The port's ``random_connected_edges`` draws the JAX package's edges
    for the headline what-if world (1024 nodes, 2048 chords, seed 7)."""
    assert ttopo.random_connected_edges(1024, 2048, seed=7) == jtopo.random_connected_edges(
        1024, 2048, seed=7
    )
