"""Kernel 18 (``gather_selection_rows``): the gather of the changed
selection rows, held against the JAX package's ``gather_selection_rows``
(``openr_tpu/ops/route_select.py:439``, ``jnp.take`` of each table) and
its plain version (``ops/route_select.py`` ``gather_selection_rows_plain``,
a ``torch.index_select`` each).

* CPU: the plain version against the reference on the delta build's
  tables ([N, C] use, [N, A] shortest, [N, A, D] lanes, [N, A] valid) and
  on the fleet's ([B, P, ...] per root): G = 0, repeated and unsorted
  indices.  A model of the kernel's launch plan (``launch_gather`` in
  ``kernels/csrc/route_select.cu``): the word of each table (the widest of
  16, 8, 4 and 1 bytes dividing its row and both pointers), a thread a
  row up to 4 words, else ceil(words / 256) blocks a row, each table's
  blocks after the last's; every output byte written once, from its
  source row, and an index out of range writing a zero row.
* On the card (``cuda``): the kernel against its plain version on the
  delta build's 1-4-byte rows, fleet rows whose bytes are and are not
  multiples of 16, a table that starts off a 16-byte boundary, G = 0, 1
  and 10,000, an index out of range, and one ``LAUNCHES`` count a call.

Tolerance: exact equality.  This module imports no JAX at import time, so
that its ``cuda`` cases run where JAX is absent.
"""

import math

import numpy as np
import pytest
import torch

from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import route_select as rs

THREADS = 256  # kGatherThreads
THREAD_ROW_WORDS = 4  # kThreadRowWords


def delta_tables(rng, N, C=1, A=1, D=4):
    """The delta build's selection outputs: use [N, C], shortest [N, A] f32,
    lanes [N, A, D], valid [N, A]."""
    return [
        rng.random((N, C)) < 0.5,
        rng.integers(0, 50, (N, A)).astype(np.float32),
        rng.random((N, A, D)) < 0.5,
        rng.random((N, A)) < 0.5,
    ]


def fleet_tables(rng, B, P, C=1, A=1, D=32):
    """The fleet's selection outputs of a chunk of B roots: [B, P, C], [B, P,
    A], [B, P, A, D], [B, P, A]."""
    return [
        rng.random((B, P, C)) < 0.5,
        rng.integers(0, 50, (B, P, A)).astype(np.float32),
        rng.random((B, P, A, D)) < 0.5,
        rng.random((B, P, A)) < 0.5,
    ]


def _jax(tables, idx):
    import jax.numpy as jnp
    from openr_tpu.ops.route_select import gather_selection_rows as jax_gather

    return [np.asarray(x) for x in jax_gather(*(jnp.asarray(t) for t in tables),
                                              jnp.asarray(idx))]


def _plain(tables, idx):
    return [t.numpy() for t in rs.gather_selection_rows(*tables_from_numpy([*tables, idx]))]


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


#: label -> (tables, idx): G 0, unsorted with repeats, one row, every row
#: backwards, the fleet's chunks
def _cases():
    rng = np.random.default_rng(18)
    d = delta_tables(rng, 500)
    d3 = delta_tables(rng, 64, C=4, A=3, D=8)
    f = fleet_tables(rng, 12, 1024)
    f3 = fleet_tables(rng, 9, 64, C=4, A=3, D=8)
    return {
        "delta G0": (d, np.zeros(0, np.int64)),
        "delta repeated unsorted": (d, np.array([5, 0, 499, 17, 17, 0, 0, 0, 3], np.int64)),
        "delta one row": (d, np.array([250], np.int64)),
        "3-area all backwards": (d3, np.arange(63, -1, -1, dtype=np.int64)),
        "fleet repeated unsorted": (f, np.array([11, 2, 2, 7, 0, 11], np.int64)),
        "fleet G0": (f, np.zeros(0, np.int64)),
        "3-area fleet": (f3, np.array([8, 1, 4, 1], np.int64)),
    }


CASES = _cases()


@pytest.mark.parametrize("label", list(CASES))
def test_gather_plain_equals_reference(label):
    tables, idx = CASES[label]
    reset_launch_counts()
    got = _plain(tables, idx)
    assert not any(LAUNCHES.values())  # the CPU runs the plain version
    _assert_same(got, _jax(tables, idx))
    assert all(g.shape[0] == len(idx) for g in got)


def test_gather_launcher_refuses_cpu_tensors():
    tables, idx = CASES["delta one row"]
    with pytest.raises(ValueError):
        rs.gather_selection_rows_launcher(*tables_from_numpy([*tables, idx]))


# -- a model of the kernel's launch plan ---------------------------------------------


def word_bytes(row_bytes, src_addr, dst_addr):
    """The widest word of 16, 8, 4 or 1 bytes dividing a row and both tables'
    addresses (``launch_gather``)."""
    w = 16
    while w > 1 and (row_bytes % w or src_addr % w or dst_addr % w):
        w = w // 2 if w > 4 else 1
    return w


def plan(row_bytes, addrs, G):
    """Each table's (word, blocks a row or 0 for a thread a row, first
    block), and the launch's blocks."""
    out, blocks = [], 0
    for rb, (sa, da) in zip(row_bytes, addrs):
        w = word_bytes(rb, sa, da)
        words = rb // w
        segs = -(-words // THREADS) if words > THREAD_ROW_WORDS else 0
        n = G * segs if segs else (-(-G // THREADS) if words else 0)
        out.append((w, segs, blocks))
        blocks += n
    return out, blocks


def gather_model(tables, idx, addrs):
    """The kernel block by block, thread by thread, over the tables' bytes:
    returns the outputs and checks every output word is written once."""
    src = [np.ascontiguousarray(t).reshape(len(t), -1).view(np.uint8) for t in tables]
    N, G = len(tables[0]), len(idx)
    row_bytes = [s.shape[1] for s in src]
    tabs, blocks = plan(row_bytes, addrs, G)
    dst = [np.full((G, rb), 0xAA, np.uint8) for rb in row_bytes]
    writes = [np.zeros((G, rb), int) for rb in row_bytes]

    def copy(j, g, k, w):
        i = int(idx[g])
        word = src[j][i, k * w:(k + 1) * w] if 0 <= i < N else 0
        dst[j][g, k * w:(k + 1) * w] = word
        writes[j][g, k * w:(k + 1) * w] += 1

    for b in range(blocks):
        j = [t for t in range(4) if tabs[t][2] <= b][-1]  # the last table begun by block b
        w, segs, first = tabs[j]
        words = row_bytes[j] // w
        for tid in range(THREADS):
            if segs == 0:
                g = (b - first) * THREADS + tid
                if g < G:
                    for k in range(words):
                        copy(j, g, k, w)
            else:
                g, seg = divmod(b - first, segs)
                k = seg * THREADS + tid
                if k < words:
                    copy(j, g, k, w)
    assert all((wr == 1).all() for wr in writes)
    return [d.view(t.dtype).reshape((G, *t.shape[1:])) for d, t in zip(dst, tables)]


@pytest.mark.parametrize("label", list(CASES))
def test_gather_plan_model_equals_reference(label):
    tables, idx = CASES[label]
    _assert_same(gather_model(tables, idx, [(256, 512)] * 4), _jax(tables, idx))


@pytest.mark.parametrize("shift", [1, 2, 4, 8])
def test_gather_plan_model_off_a_word_boundary(shift):
    """A table that starts ``shift`` bytes past a 16-byte boundary takes the
    word its address allows, and the copy is the same."""
    tables, idx = CASES["fleet repeated unsorted"]
    addrs = [(256 + shift, 512), (256, 512 + shift), (256 + shift, 512), (256, 512)]
    tabs, _ = plan([t[0].nbytes for t in tables], addrs, len(idx))
    word = {1: 1, 2: 1, 4: 4, 8: 8}[shift]  # 16, 8, 4, then a byte
    assert [w for w, _s, _f in tabs] == [word, word, word, 16]
    _assert_same(gather_model(tables, idx, addrs), _jax(tables, idx))


def test_gather_plan_model_out_of_range_rows_are_zero():
    tables, _ = CASES["3-area all backwards"]
    idx = np.array([3, -1, 64, 10**6, 0], np.int64)
    got = gather_model(tables, idx, [(0, 0)] * 4)
    for g, t in zip(got, tables):
        assert np.array_equal(g[[0, 4]], t[[3, 0]]) and not g[1:4].any()


def test_gather_plan_shapes():
    """The delta build's rows (1-4 bytes) are a thread's; the fleet's (KB)
    spread over blocks of 256 words; a row of 0 bytes takes no block."""
    tabs, blocks = plan([1, 4, 4, 1], [(0, 0)] * 4, 10_000)
    assert [s for _w, s, _f in tabs] == [0] * 4 and blocks == 4 * math.ceil(10_000 / THREADS)
    tabs, blocks = plan([1024, 4096, 32768, 1024], [(0, 0)] * 4, 3)
    assert [(w, s) for w, s, _f in tabs] == [(16, 1), (16, 1), (16, 8), (16, 1)]
    assert blocks == 3 * (1 + 1 + 8 + 1)
    tabs, blocks = plan([0, 68, 0, 3], [(0, 0)] * 4, 7)
    assert [(w, s) for w, s, _f in tabs] == [(16, 0), (4, 1), (16, 0), (1, 0)] and blocks == 8


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _held(tables, idx):
    reset_launch_counts()
    got = rs.gather_selection_rows(*tables, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_selection_rows"] == (1 if idx.numel() else 0)
    assert sum(LAUNCHES.values()) == LAUNCHES["gather_selection_rows"]
    want = rs.gather_selection_rows_plain(*tables, idx)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [0, 1, 10_000])
@pytest.mark.parametrize("shape", [(1, 1, 4), (4, 3, 1), (2, 1, 2)], ids=["C1-A1-D4", "C4-A3-D1", "C2-A1-D2"])
def test_gather_kernel_delta_rows_equal_plain(card, shape, G):
    """The delta build's rows of 1-4 bytes a table (a thread a row), G 0, 1
    and 10,000 of 50,000 rows, unsorted with repeats."""
    rng = np.random.default_rng(G)
    C, A, D = shape
    tables = tables_from_numpy(delta_tables(rng, 50_000, C, A, D), card)
    idx = torch.from_numpy(rng.integers(0, 50_000, G).astype(np.int64)).to(card)
    _held(tables, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1024, 1003, 4096])
def test_gather_kernel_fleet_rows_equal_plain(card, P):
    """The fleet's whole-root rows, KB each: P 1,024 and 4,096 (every row a
    multiple of 16 bytes) and 1,003 (none is)."""
    rng = np.random.default_rng(P)
    tables = tables_from_numpy(fleet_tables(rng, 40, P), card)
    idx = torch.tensor([39, 0, 7, 7, 21, 0], dtype=torch.int64, device=card)
    _held(tables, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_gather_kernel_unaligned_view_equals_plain(card, which):
    """One table a view 1 byte (4 for shortest) past a 16-byte boundary: the
    kernel drops that table's word."""
    rng = np.random.default_rng(which)
    tables = list(tables_from_numpy(fleet_tables(rng, 16, 1024), card))
    t = tables[which]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    shifted = flat[1:].view(t.shape)
    shifted.copy_(t)
    tables[which] = shifted
    idx = torch.tensor([15, 3, 3, 0], dtype=torch.int64, device=card)
    _held(tables, idx)


@pytest.mark.cuda
def test_gather_kernel_out_of_range_rows_are_zero(card):
    rng = np.random.default_rng(5)
    tables = tables_from_numpy(delta_tables(rng, 100, 4, 3, 8), card)
    idx = torch.tensor([3, -1, 100, 0], dtype=torch.int64, device=card)
    reset_launch_counts()
    got = rs.gather_selection_rows(*tables, idx)
    assert LAUNCHES["gather_selection_rows"] == 1
    for g, t in zip(got, tables):
        assert torch.equal(g[[0, 3]], t[[3, 0]]) and not g[1:3].any()


@pytest.mark.cuda
def test_gather_kernel_counts_one_launch_a_call(card):
    rng = np.random.default_rng(6)
    tables = tables_from_numpy(fleet_tables(rng, 8, 256), card)
    idx = torch.tensor([1, 5], dtype=torch.int64, device=card)
    reset_launch_counts()
    for _ in range(3):
        rs.gather_selection_rows(*tables, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_selection_rows"] == 3
