"""Kernel 11 (``compact_deltas``) as redesigned for the card: one launch a
call, a single-pass scan with decoupled look-back, held against the port's
plain version and the JAX package's ``_compact_deltas``
(``openr_tpu/ops/sweep_select.py:274``).

* The design, as the numpy model here runs it: the sweep-wide changed
  words are cut into tiles of ``COMPACT_TILE_WORDS`` (a thread takes 4
  words, one 16-byte load); a tile counts its live bits (padding rows and
  the bits past P masked), publishes its aggregate, then looks back over
  its predecessors' status words 32 at a time, adding aggregates until the
  nearest inclusive prefix.  The tiles finish in any order (the model
  draws it), so the look-back meets every mix of aggregates and prefixes.
  A status word packs the call's epoch, a flag and a 36-bit sum; words
  left by an earlier call carry another epoch and are never read as this
  call's.  The ticket word holds the epoch over the ticket count; the
  block taking the last ticket moves it to the next epoch at count 0, so
  the scratch is never reset and a CUDA graph may replay the launch.  The
  call whose epoch ends the 26-bit cycle clears every status word as its
  last block finishes, so no word reads as a call's before the call
  writes it, even one that a large call left 2^26 calls earlier.  A
  tile's set bits, spread over its threads (bit k to thread k % 256), go to
  their global ranks below ``cap``; the last tile writes the count, and
  the filler blocks (their tickets after every tile's) write the -1 / 0
  fills past it once the last tile's inclusive prefix is out.
* Worlds: the reference repair sweep's chunk tables of
  ``tests/test_torch_sweep_select.py`` (three chunks, padding snapshots,
  the real global row offsets), and seeded buffers of up to hundreds of
  tiles.

The ``cuda`` cases run the kernel against its plain version: a count of 0,
below ``cap``, above it, ``cap`` 1, padding rows, a word count that is not
a multiple of the tile, a (c)-like P of 409,600 over hundreds of tiles,
fills over 256 filler blocks,
calls back to back on one scratch, the end of an epoch cycle over
planted words of the next call's epoch, an unaligned changed buffer, and
a call captured in a CUDA graph: one kernel node and no memset node, its
replays equal to the plain version with no reset between them.  Tolerance:
exact equality.  This module imports no JAX at import time, so that its
``cuda`` cases run where JAX is absent.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import sweep_select as tss

TILE = tss.COMPACT_TILE_WORDS
THREAD_WORDS = 4
SUM_BITS = 36
EPOCH_BITS = 64 - SUM_BITS - 2
EPOCH_MASK = (1 << EPOCH_BITS) - 1


def buffers(seed, R, P, Dw=1, density=0.05, pad_rows=0):
    """Seeded sweep-wide buffers (changed words with ``density`` of their
    bits set, also past P in a row's last word, which the compaction must
    mask), and a row id per row, -1 on ``pad_rows`` rows."""
    rng = np.random.default_rng(seed)
    Pw = (P + 31) // 32
    bits = rng.random((R, Pw * 32)) < density
    changed = np.packbits(bits, axis=-1, bitorder="little").view("<u4").view(np.int32)
    valid = rng.random((R, P)) < 0.7
    metric = rng.integers(0, 50, (R, P)).astype(np.float32)
    lanes = rng.integers(-(2 ** 31), 2 ** 31, (R, P, Dw), dtype=np.int64).astype(np.int32)
    row_id = np.arange(R, dtype=np.int32) + 100
    if pad_rows:
        row_id[rng.choice(R, pad_rows, replace=False)] = -1
    return [torch.from_numpy(x) for x in (changed, valid, metric, lanes, row_id)]


def live_words(changed, row_id, P):
    m = changed.numpy().view(np.uint32).copy()
    m[row_id.numpy() < 0] = 0
    tail = P - 32 * (m.shape[1] - 1)
    if tail < 32:
        m[:, -1] &= np.uint32((1 << tail) - 1)
    return m.reshape(-1)


def unpack(words):
    """[n] uint32 -> [32 n] bool, bit j of word g at 32 g + j."""
    return np.unpackbits(words.astype("<u4").view(np.uint8), bitorder="little").astype(bool)


def take_ticket(word, blocks):
    """(the new ticket word, this block's ticket, its epoch): the kernel's
    64-bit atomicAdd, and the last ticket's move to the next epoch."""
    t, epoch = word & 0xFFFFFFFF, word >> 32
    word += 1
    if t == blocks - 1:
        word = (epoch + 1) << 32
    return word, t, epoch & EPOCH_MASK


def status_word(epoch, flag, total):
    return (epoch << (SUM_BITS + 2)) | (flag << SUM_BITS) | total


def read_status(word, epoch):
    """(flag, sum) of a status word, or None where it is not this call's or
    not yet published (the kernel spins on it)."""
    if word >> (SUM_BITS + 2) != epoch or (word >> SUM_BITS) & 3 == 0:
        return None
    return (word >> SUM_BITS) & 3, word & ((1 << SUM_BITS) - 1)


def early_words(status, tiles, epoch):
    """The tiles whose status word reads as this call's before the call
    writes it: a look-back that reached one would take its sum."""
    return [t for t in range(tiles) if read_status(status[t], epoch) is not None]


def one_pass_model(changed, valid, metric, lanes, row_id, cap, rng, status, ticket):
    """The kernel's single pass in numpy, on the scratch ``ticket`` (a
    two-element list: the ticket word and the done count) and ``status``
    left by earlier calls: tickets taken in an order drawn by ``rng``,
    aggregates published, then each tile's look-back in an order drawn by
    ``rng`` over the status words ``status`` (left by earlier calls), its
    scatter, the last tile's count and the fillers' fills, read from the
    last tile's status word; where the call's epoch ends the cycle, its
    blocks count themselves done and the last clears the status words."""
    R, P = valid.shape
    Dw = lanes.shape[2]
    m = live_words(changed, row_id, P)
    tiles = max(1, -(-m.size // TILE))
    blocks = tiles + tss.compact_fillers(cap)
    epochs = set()
    for _ in range(blocks):
        ticket[0], _t, epoch = take_ticket(ticket[0], blocks)
        epochs.add(epoch)
    assert len(epochs) == 1 and ticket[0] & 0xFFFFFFFF == 0
    assert early_words(status, tiles, epoch) == []
    live = unpack(m)  # [words * 32] bool, bit j of word g at 32 g + j
    counts = np.bincount(np.nonzero(live)[0] // 32 // TILE, minlength=tiles).astype(np.int64)
    for t in range(tiles):
        status[t] = status_word(epoch, 2 if t == 0 else 1, int(counts[t]))
    before = np.zeros(tiles, np.int64)
    for t in rng.permutation(tiles):
        acc, base = 0, t - 1
        while t > 0:
            window = [read_status(status[i], epoch) if i >= 0 else (2, 0)
                      for i in range(base, base - 32, -1)]
            assert None not in window  # every predecessor published
            prefixes = [k for k, (flag, _s) in enumerate(window) if flag == 2]
            if prefixes:
                acc += sum(s for _f, s in window[:prefixes[0] + 1])
                break
            acc += sum(s for _f, s in window)
            base -= 32
        before[t] = acc
        status[t] = status_word(epoch, 2, int(acc + counts[t]))
    assert np.array_equal(before, np.concatenate([[0], np.cumsum(counts)[:-1]]))
    total = int(counts.sum())
    # each set bit at its tile's base plus its rank within the tile (the
    # thread's scan offset plus its rank among the thread's bits)
    at = np.nonzero(live)[0]
    tile = at // 32 // TILE
    first = np.searchsorted(tile, np.arange(tiles))
    pos = before[tile] + np.arange(at.size) - first[tile]
    keep = pos < cap
    at, pos = at[keep], pos[keep]
    Pw = (P + 31) // 32
    r, p = at // 32 // Pw, (at // 32 % Pw) * 32 + at % 32
    row = np.full(cap, -1, np.int32)
    pref = np.full(cap, -1, np.int32)
    val = np.zeros(cap, bool)
    met = np.zeros(cap, np.float32)
    lan = np.zeros((cap, Dw), np.int32)
    row[pos], pref[pos] = row_id.numpy()[r], p
    val[pos], met[pos] = valid.numpy()[r, p], metric.numpy()[r, p]
    lan[pos] = lanes.numpy()[r, p]
    # the scatter covers [0, min(count, cap)) once, the fillers the rest,
    # from the count in the last tile's status word
    assert np.array_equal(np.sort(pos), np.arange(min(total, cap)))
    assert read_status(status[tiles - 1], epoch) == (2, total)
    if epoch == EPOCH_MASK:
        for _ in range(blocks):
            ticket[1] += 1
            if ticket[1] == blocks:
                status[:] = [0] * len(status)
                ticket[1] = 0
    return (torch.tensor([total], dtype=torch.int64), *(torch.from_numpy(x) for x in
                                                        (row, pref, val, met, lan)))


def assert_outputs_equal(got, want):
    assert int(got[0].reshape(-1)[0]) == int(want[0].reshape(-1)[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("cap", [4096, 37, 1])
def test_one_pass_model_matches_reference_chunks(cap):
    """The model on the reference sweep's three chunks (64, 32 and 64
    snapshots, the last two padded) equals the plain version and the JAX
    ``_compact_deltas``."""
    import jax.numpy as jnp
    from openr_tpu.ops import sweep_select as jss
    from test_torch_sweep_select import CAND, ref_chunk_inputs

    rt, _pt, eng, dist, nh, cands, sel = ref_chunk_inputs()
    bv, bm, bl = sel._base_dev

    def chunk(cols):
        return jss._select_chunk(
            jnp.asarray(dist[:, cols]), jnp.asarray(nh[:, :, cols[0] // 32: cols[-1] // 32 + 1]),
            jnp.asarray(rt.overloaded), jnp.zeros(rt.padded_nodes, jnp.int32), jnp.int32(0),
            *(jnp.asarray(getattr(cands, f)) for f in CAND), bv, bm, bl, max_degree=eng.D,
        )

    chunks = (chunk(np.arange(64)), chunk(np.arange(32)), chunk(np.arange(64)))
    ns, goffs = (64, 20, 51), (0, 64, 84)
    want = jss._compact_deltas(
        chunks, tuple(jnp.int32(n) for n in ns), tuple(jnp.int32(g) for g in goffs), cap=cap)
    bufs = [np.concatenate([np.asarray(c[i]) for c in chunks]) for i in range(4)]
    row_id = np.concatenate(
        [np.where(np.arange(c[1].shape[0]) < n, g + np.arange(c[1].shape[0]), -1)
         for c, n, g in zip(chunks, ns, goffs)]).astype(np.int32)
    args = [torch.from_numpy(np.array(b).view(np.int32) if b.dtype == np.uint32 else np.array(b))
            for b in bufs] + [torch.from_numpy(row_id)]
    got = one_pass_model(*args, cap, np.random.default_rng(cap), [0] * 64, [0, 0])
    plain = tss.compact_deltas(*args, cap)
    assert_outputs_equal(got, plain)
    assert int(got[0][0]) == int(want[0]) and (int(want[0]) > cap) == (cap < 4096)
    for w, g in zip(want[1:], got[1:]):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g)


@pytest.mark.parametrize("R, P, pad_rows, cap", [
    (3, 100, 0, 8192),      # one tile, a tail past P in each row's last word
    (40, 4000, 5, 256),     # 5,000 words: a partial last tile, overflow
    (64, 8192, 0, 50000),   # 16 tiles, every change kept
    (9, 1000, 9, 16),       # only padding rows: a count of 0
])
def test_one_pass_model_equals_plain_in_any_finishing_order(R, P, pad_rows, cap):
    args = buffers(R * P, R, P, Dw=2, pad_rows=pad_rows)
    want = tss.compact_deltas_plain(*args, cap)
    status, ticket = [0] * 64, [0, 0]
    for order in range(3):
        # later calls on the same scratch: no reset between them
        got = one_pass_model(*args, cap, np.random.default_rng(order), status, ticket)
        assert_outputs_equal(got, want)
        assert ticket == [(order + 1) << 32, 0]
    assert (int(want[0]) == 0) == (pad_rows == R)


def test_stale_status_words_are_never_read_as_this_calls():
    """A word left by an earlier call, whatever its flag, reads as not
    published; a zeroed word never does (its flag is 0); the largest count
    (16k snapshots x 409,600 prefixes) fits the sum's bits; the epoch
    wraps within its bits."""
    big = 16384 * 409600
    assert big < 1 << SUM_BITS
    word = status_word(7, 2, big)
    assert read_status(word, 7) == (2, big)
    assert read_status(word, 8) is None
    assert read_status(0, 0) is None
    assert read_status(status_word(5, 0, 3), 5) is None
    word, t, epoch = take_ticket(((1 << EPOCH_BITS) + 3) << 32, 1)
    assert (t, epoch) == (0, 3) and word == ((1 << EPOCH_BITS) + 4) << 32


def test_epoch_cycle_end_clears_words_a_later_call_would_read():
    """A call of 16 tiles at epoch 0, then (a jump of the ticket word)
    the 2^26 - 2 calls of one tile after it: the next call of 16 tiles,
    at epoch 0 again, would find words 1-15 of the first reading as its
    own.  The call at the cycle's last epoch clears them, and the
    later large call equals the plain version."""
    small = buffers(1, 2, 64)
    large = buffers(2, 64, 8192, Dw=2)
    status, ticket = [0] * 64, [0, 0]
    one_pass_model(*large, 4096, np.random.default_rng(0), status, ticket)
    # the calls of epochs 1 .. 2^26 - 2 ran, each writing word 0 alone
    ticket[0] = EPOCH_MASK << 32
    status[0] = status_word(EPOCH_MASK - 1, 2, 3)
    assert early_words(status, 16, 0) == list(range(1, 16))
    one_pass_model(*small, 16, np.random.default_rng(1), status, ticket)
    assert ticket == [(EPOCH_MASK + 1) << 32, 0] and status == [0] * 64
    got = one_pass_model(*large, 4096, np.random.default_rng(2), status, ticket)
    assert_outputs_equal(got, tss.compact_deltas_plain(*large, 4096))


def test_constants_are_the_kernels():
    """The launcher's tile is the kernel's (``kCompactTileWords`` =
    ``kCompactThreads`` x ``kCompactWords``), and the model's status word
    layout and thread words are the kernel's."""
    cu = (Path(tss.__file__).parents[1] / "kernels" / "csrc" / "sweep_select.cu").read_text()
    threads = int(re.search(r"constexpr int kCompactThreads = (\d+);", cu)[1])
    words = int(re.search(r"constexpr int kCompactWords = (\d+);", cu)[1])
    assert words == THREAD_WORDS and threads * words == TILE
    assert int(re.search(r"constexpr int kStatusSumBits = (\d+);", cu)[1]) == SUM_BITS
    assert "if (epoch == kEpochMask) end_epoch_cycle(" in cu
    assert tss.compact_fillers(1) == tss.compact_fillers(8192) == 1
    assert tss.compact_fillers(8193) == 2 and tss.compact_fillers(1 << 24) == 264


def test_launcher_refuses_a_cap_below_one():
    args = buffers(0, 2, 64)
    with pytest.raises(ValueError):
        tss.compact_deltas_launcher(*args, 0)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _on_card(args, card):
    return [t.to(card) for t in args]


CASES = {
    # name: (R, P, Dw, density, pad_rows, cap)
    "count_0": (8, 300, 1, 0.0, 0, 64),
    "below_cap": (16, 1000, 1, 0.01, 0, 8192),
    "above_cap": (64, 1024, 1, 0.05, 0, 256),
    "cap_1": (32, 1000, 2, 0.02, 0, 1),
    "padding_rows": (50, 700, 1, 0.05, 17, 4096),
    "ragged_tiles": (7, 9999, 3, 0.03, 1, 2048),
    "c_like_p409600": (32, 409600, 1, 0.002, 3, 8192),
    "fills_over_many_blocks": (64, 1024, 2, 0.001, 0, 1 << 21),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_one_pass_kernel_equals_plain(card, case):
    R, P, Dw, density, pad_rows, cap = CASES[case]
    args = _on_card(buffers(len(case), R, P, Dw, density, pad_rows), card)
    reset_launch_counts()
    got = tss.compact_deltas(*args, cap)
    torch.cuda.synchronize()
    assert LAUNCHES["compact_deltas"] == 1
    want = tss.compact_deltas_plain(*args, cap)
    assert_outputs_equal(got, want)
    count = int(want[0])
    words = R * ((P + 31) // 32)
    if case == "count_0":
        assert count == 0
    if case == "above_cap":
        assert count > cap
    if case == "below_cap":
        assert 0 < count < cap
    if case == "ragged_tiles":
        assert words % tss.COMPACT_TILE_WORDS
    if case == "c_like_p409600":
        assert -(-words // tss.COMPACT_TILE_WORDS) >= 200
    if case == "fills_over_many_blocks":
        assert count < cap // 1000 and tss.compact_fillers(cap) == 256


@pytest.mark.cuda
def test_compact_calls_back_to_back_share_their_scratch(card):
    """Calls of several shapes on one stream, no reset between them: each
    equals its plain version (stale status words and the ticket left by
    the call before never leak into the next)."""
    shapes = [(32, 409600, 1, 0.002, 0, 8192), (4, 64, 1, 0.3, 0, 16),
              (32, 409600, 1, 0.004, 2, 65536), (40, 4000, 2, 0.05, 5, 256)]
    outs = []
    for k, (R, P, Dw, density, pad_rows, cap) in enumerate(shapes * 2):
        args = _on_card(buffers(k, R, P, Dw, density, pad_rows), card)
        outs.append((args, cap, tss.compact_deltas(*args, cap)))
    torch.cuda.synchronize()
    for args, cap, got in outs:
        assert_outputs_equal(got, tss.compact_deltas_plain(*args, cap))


@pytest.mark.cuda
def test_compact_epoch_cycle_end_clears_planted_words(card):
    """The scratch at the cycle's last epoch, every status word planted as
    an inclusive prefix of epoch 0 (what a large call 2^26 calls earlier
    may leave): a call of one tile ends the cycle and clears them, and the
    next call, hundreds of tiles at epoch 0, equals its plain version."""
    small = _on_card(buffers(1, 4, 64, 1, 0.3), card)
    large = _on_card(buffers(2, 32, 409600, 1, 0.002, 3), card)
    tiles = -(-32 * 12800 // tss.COMPACT_TILE_WORDS)
    scratch = tss.compact_scratch(card, tiles)
    scratch[0] = EPOCH_MASK << 32
    scratch[1:-1] = status_word(0, 2, 12345)
    got = tss.compact_deltas(*small, 16)
    torch.cuda.synchronize()
    assert_outputs_equal(got, tss.compact_deltas_plain(*small, 16))
    assert int(scratch[0]) == (EPOCH_MASK + 1) << 32 and not scratch[1:].any()
    got = tss.compact_deltas(*large, 8192)
    assert tss.compact_scratch(card, tiles) is scratch
    assert_outputs_equal(got, tss.compact_deltas_plain(*large, 8192))


@pytest.mark.cuda
def test_compact_kernel_reads_an_unaligned_changed_buffer(card):
    R, P, cap = 12, 3000, 512
    args = _on_card(buffers(3, R, P + 32, 1, 0.05), card)
    Pw = (P + 31) // 32
    flat = torch.zeros(R * Pw + 1, dtype=torch.int32, device=card)
    flat[1:] = args[0][:, :Pw].reshape(-1)
    changed = flat[1:].view(R, Pw)  # 4 bytes past a 16-byte boundary
    assert changed.data_ptr() % 16
    rest = [args[1][:, :P].contiguous(), args[2][:, :P].contiguous(),
            args[3][:, :P].contiguous(), args[4]]
    got = tss.compact_deltas(changed, *rest, cap)
    assert_outputs_equal(got, tss.compact_deltas_plain(changed, *rest, cap))


def _graph_node_types(graph):
    """The node types of a captured cudaGraph_t, by the driver API (0: a
    kernel, 1: a memcpy, 2: a memset)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(int(graph))
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.cuda
def test_compact_call_is_one_kernel_and_no_memset(card):
    """One call captured in a CUDA graph (after a first on the same stream,
    which allocates its zeroed scratch) is one kernel node and no memset
    node; replays of the graph, with no reset of the scratch between them,
    each equal the plain version."""
    args = _on_card(buffers(5, 32, 409600, 1, 0.002, 3), card)
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        tss.compact_deltas(*args, 8192)
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    reset_launch_counts()
    with torch.cuda.graph(graph, stream=side):
        got = tss.compact_deltas(*args, 8192)
    assert LAUNCHES["compact_deltas"] == 1
    assert _graph_node_types(graph.raw_cuda_graph()) == [0]
    want = tss.compact_deltas_plain(*args, 8192)
    graph.instantiate()
    for _ in range(3):
        for out in got:
            out.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert_outputs_equal(got, want)
