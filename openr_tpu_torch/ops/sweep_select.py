"""Sweep → routes: best-route selection over what-if solves on the card —
the counterpart of ``openr_tpu/ops/sweep_select.py``.

The repair sweep (``ops/repair.py``) leaves each chunk's tables on the
device: dist [V, b] f32 and first-hop lanes bit-packed over the
snapshots, [V, D, b/32] words.  Per chunk, the selection kernel
(``select_chunk``, kernel 10) runs the single-area chain
(``ops/route_select.py`` ``select_routes_one``) for every (snapshot,
prefix) and diffs the route against the base solve's; then ONE
compaction (``compact_deltas``, kernel 11) gathers every changed
(snapshot, prefix) row of the whole sweep into one dense buffer, in
global flat order, so a sweep costs a single device→host fetch whose size
follows the number of routes that changed (one more, exact, only when the
buffer overflowed).

Both kernels live in ``kernels/csrc/sweep_select.cu``; each dispatch
function runs its kernel for CUDA tensors and its plain PyTorch version
for CPU tensors, never a fallback.  Packed words are int32 bit patterns
(``ops/bits.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import resolve_device
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.kernels.build import (
    check_launch,
    check_tensor,
    function,
    ptr,
    stream,
)
from openr_tpu_torch.ops.bits import pack_bits_last, unpack_bits_last
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.csr import EncodedTopology, bucket_for
from openr_tpu_torch.ops.route_select import MAX_KERNEL_CANDIDATES, select_routes_one

#: compaction buffer sizes: a sweep's first buffer holds ``cap`` rows; on
#: overflow it is re-run once at the bucket that fits (or every row)
DELTA_BUCKETS = (256, 1024, 4096, 8192, 16384, 65536, 262144, 1048576)


@dataclasses.dataclass
class SweepCandidates:
    """Single-area [P, C] candidate table for the sweep's vantage root."""

    cand_node: np.ndarray  # [P, C] int32
    cand_ok: np.ndarray  # [P, C] bool
    drain_metric: np.ndarray  # [P, C] int32
    path_pref: np.ndarray  # [P, C] int32
    source_pref: np.ndarray  # [P, C] int32
    distance: np.ndarray  # [P, C] int32
    min_nexthop: np.ndarray  # [P, C] int32 (0 = unset)

    @classmethod
    def single_advertiser(cls, advertisers):
        """P prefixes each advertised by one node id (one loopback per
        node)."""
        nodes = np.asarray(advertisers, np.int32).reshape(-1, 1)
        P = nodes.shape[0]
        zeros = np.zeros((P, 1), np.int32)
        return cls(
            cand_node=nodes,
            cand_ok=np.ones((P, 1), bool),
            drain_metric=zeros,
            path_pref=zeros.copy(),
            source_pref=zeros.copy(),
            distance=zeros.copy(),
            min_nexthop=zeros.copy(),
        )


#: the candidate fields, in the selection's argument order
CAND_FIELDS = (
    "cand_node", "cand_ok", "drain_metric", "path_pref", "source_pref",
    "distance", "min_nexthop",
)


@dataclasses.dataclass
class SweepRouteDeltas:
    """Base route table + per-unique-solve route deltas.

    ``snap_row[s]`` maps snapshot s to its unique-solve row (0 = base: no
    deltas); ``routes_of(s)`` rebuilds any snapshot's [P] table by
    patching the base."""

    snap_row: np.ndarray  # [B]
    num_prefixes: int
    max_degree: int
    base_valid: np.ndarray  # [P] bool
    base_metric: np.ndarray  # [P] f32
    base_lanes: np.ndarray  # [P, D] int8
    delta_row: np.ndarray  # [K] int32 unique-solve row (>= 1)
    delta_prefix: np.ndarray  # [K] int32
    delta_valid: np.ndarray  # [K] bool
    delta_metric: np.ndarray  # [K] f32
    delta_lanes: np.ndarray  # [K, D] int8
    #: bytes moved device→host for the compaction buffers
    fetch_bytes: int = 0
    #: blocking device→host fetch rounds (1 unless the buffer overflowed)
    fetch_groups: int = 0

    def __post_init__(self):
        order = np.argsort(self.delta_row, kind="stable")
        for f in ("delta_row", "delta_prefix", "delta_valid", "delta_metric", "delta_lanes"):
            setattr(self, f, getattr(self, f)[order])
        self._row_slices: Dict[int, Tuple[int, int]] = {}
        rows, counts = np.unique(self.delta_row, return_counts=True)
        off = 0
        for r, c in zip(rows, counts):
            self._row_slices[int(r)] = (off, off + int(c))
            off += int(c)

    @property
    def num_deltas(self) -> int:
        return int(self.delta_row.shape[0])

    def deltas_of_row(self, row: int):
        s, e = self._row_slices.get(int(row), (0, 0))
        return (
            self.delta_prefix[s:e],
            self.delta_valid[s:e],
            self.delta_metric[s:e],
            self.delta_lanes[s:e],
        )

    def routes_of(self, snapshot: int):
        """(valid [P], metric [P], lanes [P, D]) for one snapshot."""
        valid = self.base_valid.copy()
        metric = self.base_metric.copy()
        lanes = self.base_lanes.copy()
        row = int(self.snap_row[snapshot])
        if row != 0:
            p, v, m, ln = self.deltas_of_row(row)
            valid[p] = v
            metric[p] = m
            lanes[p] = ln
        return valid, metric, lanes


# ---------------------------------------------------------------------------
# kernel 10: per-chunk selection + diff against the base
# ---------------------------------------------------------------------------


def select_chunk_plain(
    dist,  # [V, b] f32
    nh,  # [V, D, ceil(b/32)] int32 words (bit s % 32 of word s // 32)
    overloaded,  # [V] bool
    soft,  # [V] int32
    root: int,
    cand_node, cand_ok, drain_metric, path_pref, source_pref, distance,
    min_nexthop,  # [P, C]
    base_valid,  # [P] bool
    base_metric,  # [P] f32
    base_lanes,  # [P, Dw] int32 words
    max_degree: int,
    out=None,
):
    """The reference's ``_select_chunk``: the selection chain for every
    snapshot, lanes packed 32 to a word, and the changed mask — a route
    changed iff its validity differs from the base's, or both are valid
    and the metric or any lane word differs — packed over the prefixes.
    Returns (changed [b, Pw] int32, valid [b, P] bool, metric [b, P] f32,
    lanes [b, P, Dw] int32), written into ``out`` when given."""
    b = dist.shape[1]
    P = cand_node.shape[0]
    bits = unpack_bits_last(nh, b)  # [V, D, b]
    nh_b = bits.permute(2, 0, 1).to(torch.int8)  # [b, V, D]
    valid, metric, nh_out, _num, _use = select_routes_one(
        cand_node, cand_ok, drain_metric, path_pref, source_pref, distance,
        min_nexthop, dist.t(), nh_b, overloaded, soft, root,
    )
    lanes = pack_bits_last(nh_out, max_degree)
    changed = (valid != base_valid[None, :]) | (
        valid
        & base_valid[None, :]
        & ((metric != base_metric[None, :]) | (lanes != base_lanes[None]).any(dim=-1))
    )
    outs = (pack_bits_last(changed, P), valid, metric, lanes)
    if out is None:
        return outs
    for o, v in zip(out, outs):
        o.copy_(v)
    return out


#: the most snapshots kernel 10 takes in a chunk (its grid runs a row per
#: 32-snapshot word, well within CUDA's grid y limit of 65,535)
MAX_CHUNK_SNAPSHOTS = 65535

#: the ctypes argument types of the C entry points of this module's
#: kernels (``openr_<name>``), in order: pointers (and the stream) as
#: c_void_p, then the ints and BIG
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SELECT_CHUNK_ARGTYPES = [_P] * 18 + [_I] * 6 + [_F, _P]
COMPACT_DELTAS_ARGTYPES = [_P] * 13 + [_I] * 7 + [_P]


def select_chunk_launcher(
    dist, nh, overloaded, soft, root: int, cand_node, cand_ok, drain_metric,
    path_pref, source_pref, distance, min_nexthop, base_valid, base_metric,
    base_lanes, max_degree: int, out=None,
):
    """Check the inputs, allocate the outputs (or take ``out``: views of
    the sweep-wide buffers) and bind kernel 10 once.  Returns ``(launch,
    (changed, valid, metric, lanes))``; each ``launch()`` enqueues the
    kernel (no synchronize) and counts one launch."""
    dev = dist.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    V, b = dist.shape
    D = int(max_degree)
    Bw = (b + 31) // 32
    Dw = (D + 31) // 32
    P, C = cand_node.shape
    Pw = (P + 31) // 32
    if C > MAX_KERNEL_CANDIDATES:
        raise ValueError(f"{C} candidates exceed the kernel's {MAX_KERNEL_CANDIDATES}")
    if not 0 <= root < V or D < 1 or b > MAX_CHUNK_SNAPSHOTS:
        raise ValueError(f"bad root {root}, max_degree {D} or {b} snapshots")
    check_tensor("dist", dist, torch.float32, (V, b), dev)
    check_tensor("nh", nh, torch.int32, (V, D, Bw), dev)
    check_tensor("overloaded", overloaded, torch.bool, (V,), dev)
    check_tensor("soft", soft, torch.int32, (V,), dev)
    for name, t in (("cand_node", cand_node), ("drain_metric", drain_metric),
                    ("path_pref", path_pref), ("source_pref", source_pref),
                    ("distance", distance), ("min_nexthop", min_nexthop)):
        check_tensor(name, t, torch.int32, (P, C), dev)
    check_tensor("cand_ok", cand_ok, torch.bool, (P, C), dev)
    check_tensor("base_valid", base_valid, torch.bool, (P,), dev)
    check_tensor("base_metric", base_metric, torch.float32, (P,), dev)
    check_tensor("base_lanes", base_lanes, torch.int32, (P, Dw), dev)
    if out is None:
        out = (
            torch.empty((b, Pw), dtype=torch.int32, device=dev),
            torch.empty((b, P), dtype=torch.bool, device=dev),
            torch.empty((b, P), dtype=torch.float32, device=dev),
            torch.empty((b, P, Dw), dtype=torch.int32, device=dev),
        )
    for name, t, dt, shape in zip(
        ("changed", "valid", "metric", "lanes"), out,
        (torch.int32, torch.bool, torch.float32, torch.int32),
        ((b, Pw), (b, P), (b, P), (b, P, Dw)),
    ):
        check_tensor(name, t, dt, shape, dev)
    fn = function("sweep_select", "openr_select_chunk", SELECT_CHUNK_ARGTYPES)
    ins = (dist, nh, overloaded, soft, cand_node, cand_ok, drain_metric,
           path_pref, source_pref, distance, min_nexthop, base_valid,
           base_metric, base_lanes)
    args = (*(ptr(t) for t in ins), *(ptr(o) for o in out), V, b, P, C, D,
            root, BIG, stream(dev))

    def launch() -> None:
        if b == 0 or P == 0:
            return
        check_launch("select_chunk", fn(*args))
        LAUNCHES["select_chunk"] += 1

    return launch, tuple(out)


def select_chunk(*args, **kwargs):
    """Per-chunk selection + diff (arguments of :func:`select_chunk_plain`):
    kernel 10 for CUDA tensors, the plain version for CPU tensors."""
    if args[0].device.type == "cpu":
        return select_chunk_plain(*args, **kwargs)
    launch, outs = select_chunk_launcher(*args, **kwargs)
    launch()
    return outs


# ---------------------------------------------------------------------------
# kernel 11: compaction of every changed row of a sweep
# ---------------------------------------------------------------------------


def compact_deltas_plain(changed, valid, metric, lanes, row_id, cap: int):
    """The reference's ``_compact_deltas`` over the sweep-wide buffers
    (chunks stacked along the rows; ``row_id`` [R] int32 maps each buffer
    row to its global unique-solve row, -1 on padding snapshots): every
    changed (row, prefix) in global flat order — rows in order, then
    prefixes — into [cap] buffers, rows beyond ``cap`` dropped, with the
    exact count.  Fills are -1 for the coordinates and 0 elsewhere.
    Returns (count int64 scalar, row [cap] int32, prefix [cap] int32,
    valid [cap] bool, metric [cap] f32, lanes [cap, Dw] int32)."""
    R, P = valid.shape
    dev = valid.device
    mask = unpack_bits_last(changed, P) & (row_id >= 0)[:, None]
    flat = mask.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int64), dim=0) - 1
    count = flat.to(torch.int64).sum()
    keep = torch.nonzero(flat & (pos < cap)).squeeze(1)
    at = pos[keep]
    Dw = lanes.shape[2]
    comp_row = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    comp_pref = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    comp_valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    comp_metric = torch.zeros((cap,), dtype=torch.float32, device=dev)
    comp_lanes = torch.zeros((cap, Dw), dtype=torch.int32, device=dev)
    comp_row[at] = row_id[keep // P]
    comp_pref[at] = (keep % P).to(torch.int32)
    comp_valid[at] = valid.reshape(-1)[keep]
    comp_metric[at] = metric.reshape(-1)[keep]
    comp_lanes[at] = lanes.reshape(R * P, Dw)[keep]
    return count, comp_row, comp_pref, comp_valid, comp_metric, comp_lanes


#: changed words a tile (one block) of kernel 11 takes: ``kCompactTileWords``
#: of ``sweep_select.cu`` (a test holds the two equal)
COMPACT_TILE_WORDS = 1024

#: slots of ``cap`` one filler block of kernel 11 takes, and the most
#: filler blocks a call launches
COMPACT_FILL_SLOTS = 8192
COMPACT_MAX_FILLERS = 264


def compact_fillers(cap: int) -> int:
    """Kernel 11's filler blocks for a buffer of ``cap`` rows: they write
    the -1 / 0 fills past the count once the scan has found it."""
    return min(COMPACT_MAX_FILLERS, max(1, -(-cap // COMPACT_FILL_SLOTS)))


#: kernel 11's scratch per (device, stream): int64 word 0 holds the call's
#: epoch and the ticket count, then one status word per tile, then the
#: count of finished blocks in the call that ends an epoch cycle.  Zeroed
#: once, where it is allocated or grown; never reset between calls (each
#: call tags its status words with its epoch, the block taking the last
#: ticket moves word 0 to the next epoch at count 0, and the call whose
#: epoch is the cycle's last clears the status words as it ends).
_COMPACT_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def compact_scratch(dev, tiles: int) -> torch.Tensor:
    """Kernel 11's scratch on ``dev``'s current stream, with room for
    ``tiles`` status words (grown to at least twice its room when short)."""
    key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    held = _COMPACT_SCRATCH.get(key)
    if held is None or held.numel() - 2 < tiles:
        room = max(tiles, 0 if held is None else 2 * (held.numel() - 2))
        held = torch.zeros((2 + room,), dtype=torch.int64, device=dev)
        _COMPACT_SCRATCH[key] = held
    return held


def compact_deltas_launcher(changed, valid, metric, lanes, row_id, cap: int):
    """Check the inputs, allocate the outputs and bind kernel 11 once.
    Returns ``(launch, (count [1] int64, row, prefix, valid, metric,
    lanes))``; each ``launch()`` enqueues the kernel once (a single-pass
    scan whose last blocks write the fills: no memset, no second kernel)
    and counts one launch."""
    dev = valid.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on {dev}")
    R, P = valid.shape
    Pw = (P + 31) // 32
    Dw = lanes.shape[2]
    check_tensor("changed", changed, torch.int32, (R, Pw), dev)
    check_tensor("valid", valid, torch.bool, (R, P), dev)
    check_tensor("metric", metric, torch.float32, (R, P), dev)
    check_tensor("lanes", lanes, torch.int32, (R, P, Dw), dev)
    check_tensor("row_id", row_id, torch.int32, (R,), dev)
    cap = int(cap)
    if cap < 1:
        raise ValueError(f"cap {cap} must be >= 1")
    tiles = max(1, -(-R * Pw // COMPACT_TILE_WORDS))
    scratch = compact_scratch(dev, tiles)
    outs = (
        torch.empty((1,), dtype=torch.int64, device=dev),
        torch.empty((cap,), dtype=torch.int32, device=dev),
        torch.empty((cap,), dtype=torch.int32, device=dev),
        torch.empty((cap,), dtype=torch.bool, device=dev),
        torch.empty((cap,), dtype=torch.float32, device=dev),
        torch.empty((cap, Dw), dtype=torch.int32, device=dev),
    )
    fn = function("sweep_select", "openr_compact_deltas", COMPACT_DELTAS_ARGTYPES)
    base = scratch.data_ptr()
    args = (ptr(changed), ptr(valid), ptr(metric), ptr(lanes), ptr(row_id),
            ctypes.c_void_p(base + 8), ctypes.c_void_p(base), *(ptr(o) for o in outs),
            R, P, Dw, cap, tiles, compact_fillers(cap), scratch.numel() - 2, stream(dev))

    # the default argument keeps the scratch alive
    def launch(_held=scratch) -> None:
        check_launch("compact_deltas", fn(*args))
        LAUNCHES["compact_deltas"] += 1

    return launch, outs


def compact_deltas(changed, valid, metric, lanes, row_id, cap: int):
    """Kernel 11 for CUDA tensors, :func:`compact_deltas_plain` for CPU
    tensors (the count is an int64 tensor of one element either way)."""
    if valid.device.type == "cpu":
        count, *rest = compact_deltas_plain(changed, valid, metric, lanes, row_id, cap)
        return (count.reshape(1), *rest)
    launch, outs = compact_deltas_launcher(changed, valid, metric, lanes, row_id, cap)
    launch()
    return outs


# ---------------------------------------------------------------------------
# the sweep → routes pipeline
# ---------------------------------------------------------------------------


class SweepRouteSelector:
    """sweep → routes pipeline over one (topology, root, candidates)."""

    def __init__(
        self,
        topo: EncodedTopology,
        root: str,
        cands,
        max_degree: int,
        device=None,
    ) -> None:
        """``cands``: a :class:`SweepCandidates` or any object with its
        [P, C] fields (``ops/csr.py`` ``EncodedPrefixCandidates``).
        ``device`` defaults to the first CUDA card."""
        self.device = resolve_device(device)
        self.topo = topo
        self.root_id = topo.node_id(root)
        self.D = max_degree
        self.Dw = (max_degree + 31) // 32
        self.cands = cands
        (self._overloaded,) = tables_from_numpy((topo.overloaded,), self.device)
        self._soft = torch.zeros(topo.padded_nodes, dtype=torch.int32, device=self.device)
        self._cand = tables_from_numpy([getattr(cands, f) for f in CAND_FIELDS], self.device)
        #: compaction rows per sweep fetch; grows when a sweep changes
        #: more routes than fit (the re-run is exact)
        self._cap = 8192
        assert self._cap in DELTA_BUCKETS
        self._base = None  # (valid [P], metric [P], lanes [P, D] int8) host
        self._base_dev = None  # (valid, metric, lanes words) on the device
        #: the base arrays the cache was built from (identity by reference)
        self._base_key = None

    @property
    def num_prefixes(self) -> int:
        return int(self.cands.cand_node.shape[0])

    def _select(self, dist, nh, base_dev, out=None):
        return select_chunk(
            dist, nh, self._overloaded, self._soft, self.root_id, *self._cand,
            *base_dev, self.D, out=out,
        )

    def base_routes(self, base_dist: np.ndarray, base_nh: np.ndarray):
        """Select routes for the unperturbed solve — kernel 10 over a
        one-snapshot batch — and cache host and device copies, keyed by
        the base arrays' identities (a sweep from a rebuilt engine must
        not be diffed against a stale base)."""
        key = self._base_key
        if self._base is not None and key[0] is base_dist and key[1] is base_nh:
            return self._base
        P = self.num_prefixes
        dist, nh = tables_from_numpy((base_dist, base_nh), self.device)
        dist = dist[:, None].contiguous()
        nh = (nh.to(torch.int32) & 1)[:, :, None].contiguous()
        unused = (
            torch.zeros((P,), dtype=torch.bool, device=self.device),
            torch.zeros((P,), dtype=torch.float32, device=self.device),
            torch.zeros((P, self.Dw), dtype=torch.int32, device=self.device),
        )
        _changed, valid, metric, lanes = self._select(dist, nh, unused)
        self._base_dev = (valid[0], metric[0], lanes[0])
        bits = unpack_bits_last(lanes[0], self.D)
        self._base = (
            valid[0].cpu().numpy(),
            metric[0].cpu().numpy(),
            bits.to(torch.int8).cpu().numpy(),
        )
        self._base_key = (base_dist, base_nh)
        return self._base

    def start(self, sweep_result) -> "PendingDeltas":
        """Dispatch phase, non-blocking: every chunk's selection kernel
        into one sweep-wide buffer, then ONE compaction, then the start of
        the device→host copy; returns a handle at once (``finish()``
        blocks and decodes), so work queued before ``finish()`` overlaps
        the copy."""
        base_dist, base_nh = sweep_result.base
        self.base_routes(base_dist, base_nh)
        P = self.num_prefixes
        chunks = sweep_result.chunks or []
        comp_args = comp = None
        cap = 0
        if chunks:
            R = sum(c[2].shape[1] for c in chunks)
            dev = self.device
            bufs = (
                torch.empty((R, (P + 31) // 32), dtype=torch.int32, device=dev),
                torch.empty((R, P), dtype=torch.bool, device=dev),
                torch.empty((R, P), dtype=torch.float32, device=dev),
                torch.empty((R, P, self.Dw), dtype=torch.int32, device=dev),
            )
            row_id = np.full(R, -1, np.int32)
            r0 = 0
            for off, n, dist_d, nh_d in chunks:
                b = dist_d.shape[1]
                row_id[r0 : r0 + n] = off + np.arange(n, dtype=np.int32)
                self._select(dist_d, nh_d, self._base_dev,
                             out=tuple(t[r0 : r0 + b] for t in bufs))
                r0 += b
            comp_args = (*bufs, *tables_from_numpy((row_id,), dev))
            cap = min(self._cap, R * P)
            comp = HostFetch(compact_deltas(*comp_args, cap))
        # the base tuple is captured NOW: a later start() against a
        # rebuilt engine replaces self._base, and these deltas were diffed
        # against this one
        return PendingDeltas(self, sweep_result.snap_row, self._base, comp_args, comp, cap, P)

    def run(self, sweep_result) -> SweepRouteDeltas:
        """Consume a device-resident SweepResult (``fetch=False``) and
        return the route deltas with one delta-only host fetch."""
        return self.start(sweep_result).finish()


class HostFetch:
    """Device tensors on their way to the host (the sweep's compaction
    buffers, the fleet's and the multi-area what-if's tables): non-blocking
    copies into pinned host tensors and an event recorded after them, so
    ``wait()`` is one blocking wait for all of them (on the CPU the tensors
    are already the host copies)."""

    def __init__(self, tensors) -> None:
        dev = tensors[0].device
        self._event = None
        if dev.type == "cuda":
            self.host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors
            )
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self.host = tuple(tensors)

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return tuple(h.numpy() for h in self.host)


class PendingDeltas:
    """In-flight sweep→routes fetch (see :meth:`SweepRouteSelector.start`)."""

    def __init__(self, sel, snap_row, base, comp_args, comp, cap, P):
        self._sel = sel
        self._snap_row = snap_row
        self._base = base  # (valid, metric, lanes) captured at start()
        self._comp_args = comp_args
        self._comp: Optional[HostFetch] = comp
        self._cap = cap
        self._P = P
        self._done = False

    def is_ready(self) -> bool:
        """True once the compaction buffers are on the host: ``finish()``
        would not block (unless the buffer overflowed)."""
        return self._comp is None or self._comp.is_ready()

    def finish(self) -> SweepRouteDeltas:
        if self._done:
            # a silent second finish would read as "no routes changed"
            raise RuntimeError("PendingDeltas.finish() called twice")
        self._done = True
        sel = self._sel
        P = self._P
        D = sel.D
        fetch_bytes = fetch_groups = 0
        count = 0
        crow = cpref = cvalid = cmetric = clanes = None
        if self._comp is not None:
            cap = self._cap
            total_rows = self._comp_args[1].shape[0] * P
            fetch_groups = 1
            cnt, crow, cpref, cvalid, cmetric, clanes = self._comp.wait()
            count = int(cnt[0])
            while count > cap:
                # overflow: re-compact at the bucket that fits (the grown
                # cap persists for later sweeps); every row always fits
                if count > DELTA_BUCKETS[-1]:
                    cap = total_rows
                else:
                    cap = min(bucket_for(count, DELTA_BUCKETS), total_rows)
                sel._cap = max(sel._cap, cap)
                fetch_groups += 1
                cnt, crow, cpref, cvalid, cmetric, clanes = HostFetch(
                    compact_deltas(*self._comp_args, cap)
                ).wait()
                count = int(cnt[0])
            fetch_bytes = sum(a.nbytes for a in (crow, cpref, cvalid, cmetric, clanes))
        self._comp = None
        self._comp_args = None
        if count:
            delta_row = (1 + crow[:count]).astype(np.int32)
            delta_prefix = cpref[:count].astype(np.int32)
            delta_valid = cvalid[:count].copy()
            delta_metric = cmetric[:count].copy()
            lanes_bits = np.unpackbits(
                np.ascontiguousarray(clanes[:count]).view(np.uint8).reshape(count, -1),
                axis=-1, bitorder="little",
            )[:, :D]
            delta_lanes = lanes_bits.astype(np.int8)
        else:
            delta_row = np.zeros(0, np.int32)
            delta_prefix = np.zeros(0, np.int32)
            delta_valid = np.zeros(0, bool)
            delta_metric = np.zeros(0, np.float32)
            delta_lanes = np.zeros((0, D), np.int8)
        bv, bm, bl = self._base
        return SweepRouteDeltas(
            snap_row=self._snap_row,
            num_prefixes=P,
            max_degree=D,
            base_valid=bv,
            base_metric=bm,
            base_lanes=bl,
            delta_row=delta_row,
            delta_prefix=delta_prefix,
            delta_valid=delta_valid,
            delta_metric=delta_metric,
            delta_lanes=delta_lanes,
            fetch_bytes=fetch_bytes,
            fetch_groups=fetch_groups,
        )
