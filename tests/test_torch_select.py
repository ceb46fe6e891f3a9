"""The port's multi-area best-route selection against the JAX reference's
``multi_area_select_from_tables``, bit for bit, on seeded numpy inputs.

Rows cover: every candidate hard-drained (the all-drained fallback),
soft-drained and drain-metric candidates (the not-drained tie-break),
padded rows (no valid candidate), candidates absent from other areas,
and lane rows holding the int8 -128 fill, under both SHORTEST_DISTANCE
and PER_AREA_SHORTEST_DISTANCE.  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from openr_tpu.ops.route_select import (
    multi_area_select_from_tables as jax_select,
)
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.route_select import (
    multi_area_select_from_tables,
    multi_area_select_from_tables_plain,
)


def _random_tables(rng, A, V, D):
    dist = rng.integers(0, 12, (A, V)).astype(np.float32)
    dist[rng.random((A, V)) < 0.2] = BIG
    nh = (rng.random((A, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((A, V)) < 0.15] = -128  # vertices absent from the edge list
    overloaded = rng.random((A, V)) < 0.2
    soft = np.where(rng.random((A, V)) < 0.2, 5, 0).astype(np.int32)
    return dist, nh, overloaded, soft


def _world_tables():
    """SPF tables of a real multi-area world, from the port's plain SPF."""
    from test_torch_spf import DENSE_FIELDS, _encodings
    from openr_tpu_torch.ops.route_select import multi_area_spf_tables_dense

    _ref, enc = _encodings("isolated_area")
    arrays = tables_from_numpy([getattr(enc, f) for f in DENSE_FIELDS])
    dist, nh = multi_area_spf_tables_dense(*arrays, max_degree=4)
    return dist.numpy(), nh.numpy(), enc.overloaded.copy(), enc.soft.copy()


def _candidates(rng, A, V, P, C, overloaded, soft):
    cand_area = rng.integers(0, A, (P, C)).astype(np.int32)
    cand_node = rng.integers(0, V, (P, C)).astype(np.int32)
    cand_ok = rng.random((P, C)) < 0.85
    # rows 0-7: every candidate hard-drained (all-drained fallback)
    overloaded[cand_area[:8], cand_node[:8]] = True
    # rows 8-15: every candidate soft-drained, one by drain metric
    soft[cand_area[8:16], cand_node[8:16]] = 9
    drain_metric = np.where(rng.random((P, C)) < 0.2, 1, 0).astype(np.int32)
    path_pref = rng.choice([100, 200], (P, C)).astype(np.int32)
    source_pref = rng.choice([1, 2], (P, C)).astype(np.int32)
    distance = rng.choice([1, 2, 3], (P, C)).astype(np.int32)
    # rows P-8..P-1: padded (no valid candidate)
    cand_ok[-8:] = False
    cand_area[-8:] = 0
    cand_node[-8:] = 0
    cnia = rng.integers(-1, V, (P, C, A)).astype(np.int32)
    cnia[np.arange(P)[:, None], np.arange(C)[None, :], cand_area] = cand_node
    cnia[-8:] = -1
    return (
        cand_area, cand_node, cand_ok, drain_metric, path_pref, source_pref,
        distance, cnia,
    )


def _inputs(source, seed):
    rng = np.random.default_rng(seed)
    if source == "world":
        dist, nh, overloaded, soft = _world_tables()
    else:
        dist, nh, overloaded, soft = _random_tables(rng, 3, 16, 4)
    A, V = dist.shape
    cands = _candidates(rng, A, V, 64, 4, overloaded, soft)
    return (dist, nh, overloaded, soft) + cands


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("source,seed", [("random", 0), ("random", 1), ("random", 2), ("world", 3)])
def test_select_matches_reference(source, seed, per_area):
    arrays = _inputs(source, seed)
    want = jax_select(
        *(jnp.asarray(a) for a in arrays), per_area_distance=per_area
    )
    got = multi_area_select_from_tables(*tables_from_numpy(arrays), per_area)
    names = ("use", "shortest", "lanes", "valid")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    use, _shortest, lanes, valid = (np.asarray(w) for w in want)
    assert use[:8].any()  # the all-hard-drained rows fall back, not vanish
    assert not use[-8:].any() and not valid[-8:].any()


def test_lane_union_is_a_sum_not_an_or():
    """A min-cost winner whose lane row is the int8 -128 fill cancels a
    neighbour's lane exactly as the reference's einsum does."""
    dist = np.zeros((1, 4), np.float32)
    nh = np.array([[[1, 0], [-128, -128], [1, 1], [0, 0]]], np.int8)
    overloaded = np.zeros((1, 4), bool)
    soft = np.zeros((1, 4), np.int32)
    cand_node = np.array([[0, 1], [2, 3]], np.int32)
    P, C = cand_node.shape
    z = np.zeros((P, C), np.int32)
    args = (
        dist, nh, overloaded, soft, z, cand_node, np.ones((P, C), bool), z,
        z, z, z, cand_node[:, :, None].copy(),
    )
    want = jax_select(*(jnp.asarray(a) for a in args), per_area_distance=False)
    got = multi_area_select_from_tables_plain(*tables_from_numpy(args), False)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not got[2][0].any() and not got[3][0].any()  # 1 + -128 <= 0
    assert got[2][1, 0].tolist() == [True, True]
