"""Dense SPF tables: masked Bellman-Ford distances and all-shortest-path
first-hop lane sets over the dense in-edge matrix — the counterpart of
``openr_tpu/ops/spf.py``'s ``dense_spf_distances`` /
``dense_spf_nexthop_lanes`` / ``dense_spf_one``.

Every function takes a leading area axis (the reference vmaps its
single-area kernels over areas): ``in_src/in_w/in_ok/in_rank [A, V, K]``,
``in_has/overloaded [A, V]``, ``roots [A]``.

Reference-parity rules:
  * node hard-drain: an overloaded node receives traffic but never relaxes
    its out-edges, except when it is the SPF root (LinkState.cpp:739-752)
  * down links and padding slots are excluded via ``in_ok`` (their ``in_w``
    is +inf)
  * lane r is the r-th out-edge of the root (``in_rank``); lane sets
    propagate along shortest-path-DAG edges, seeded at the root's direct
    successors; vertices absent from the padded edge list keep int8 -128

Each function dispatches on the device of its inputs: a CUDA tensor goes
to the hand-written kernel (``kernels/csrc/spf_dense.cu``), a CPU tensor
to the plain PyTorch version beside it.  The CUDA path never falls back:
a build failure, a refused launch or an unsupported shape raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.kernels.build import (
    check_launch,
    check_tensor,
    function,
    ptr,
    stream,
)
from openr_tpu_torch.ops.consts import BIG

#: relaxation rounds per convergence check in the plain versions (the
#: reference's DENSE_UNROLL); extra rounds past the fixed point are no-ops
DENSE_UNROLL = 8

INT8_MIN = -128


def transit_ok(in_src, in_ok, overloaded, roots):
    """[A, V, K] bool: in-edge usable (ok and its src may transit)."""
    A, V, _K = in_src.shape
    src = in_src.long()
    ids = torch.arange(V, device=in_src.device)
    transit = (~overloaded) | (ids[None, :] == roots.long()[:, None])
    return in_ok & torch.gather(transit, 1, src.reshape(A, -1)).reshape(src.shape)


def gather_rows(table, in_src):
    """table [A, V, ...] gathered at in_src [A, V, K] → [A, V, K, ...]."""
    A = table.shape[0]
    areas = torch.arange(A, device=table.device)[:, None, None]
    return table[areas, in_src.long()]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def dense_spf_distances_plain(in_src, in_w, in_ok, overloaded, roots) -> torch.Tensor:
    """[A, V] f32 distances from each area's root, BIG where unreachable."""
    A, V, _K = in_src.shape
    ok = transit_ok(in_src, in_ok, overloaded, roots)
    ww = torch.where(ok, in_w, torch.tensor(BIG, dtype=torch.float32, device=in_w.device))
    dist = torch.full((A, V), BIG, dtype=torch.float32, device=in_w.device)
    dist[torch.arange(A, device=dist.device), roots.long()] = 0.0
    i = 0
    while True:
        nd = dist
        for _ in range(DENSE_UNROLL):
            nd = torch.minimum(nd, (gather_rows(nd, in_src) + ww).amin(dim=2))
        changed = bool((nd < dist).any())
        dist = nd
        i += DENSE_UNROLL
        if not changed or i >= V:
            return dist


def dense_spf_nexthop_lanes_plain(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> torch.Tensor:
    """[A, V, D] int8 first-hop lane sets (1 = lane on a shortest path,
    -128 on vertices absent from the padded edge list)."""
    A, V, _K = in_src.shape
    D = max_degree
    ok = transit_ok(in_src, in_ok, overloaded, roots)
    big = torch.tensor(BIG, dtype=torch.float32, device=in_w.device)
    ww = torch.where(ok, in_w, big)
    dv = dist[:, :, None]
    # on-DAG in-edges: reached dst whose distance equals src dist + w
    sp = ok & (gather_rows(dist, in_src) + ww == dv) & (dv < big)
    is_root = in_src.long() == roots.long()[:, None, None]
    lanes = torch.arange(D, device=in_src.device)
    seed = ((sp & is_root)[..., None] & (in_rank[..., None] == lanes)).to(torch.int8)
    empty = torch.full((A, V, D), INT8_MIN, dtype=torch.int8, device=in_src.device)
    has = in_has[:, :, None]
    nh = torch.where(has, seed.amax(dim=2), empty)
    prop = (sp & ~is_root)[..., None].to(torch.int8)  # [A, V, K, 1]
    i = 0
    while True:
        new = nh
        for _ in range(DENSE_UNROLL):
            contrib = (gather_rows(new, in_src) * prop).amax(dim=2)
            new = torch.where(has, torch.maximum(new, contrib), new)
        changed = bool((new != nh).any())
        nh = new
        i += DENSE_UNROLL
        if not changed or i >= V:
            return nh


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


#: the kernels keep one area's f32 distances in shared memory
MAX_KERNEL_NODES = 232448 // 4


def _check_planes(in_src, in_w, in_ok, overloaded, roots):
    if in_src.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on {in_src.device}")
    A, V, K = in_src.shape
    if V > MAX_KERNEL_NODES:
        raise ValueError(f"{V} nodes exceed the kernel's shared-memory bound")
    dev = in_src.device
    check_tensor("in_src", in_src, torch.int32, (A, V, K), dev)
    check_tensor("in_w", in_w, torch.float32, (A, V, K), dev)
    check_tensor("in_ok", in_ok, torch.bool, (A, V, K), dev)
    check_tensor("overloaded", overloaded, torch.bool, (A, V), dev)
    check_tensor("roots", roots, torch.int32, (A,), dev)
    return A, V, K, dev


def dense_spf_distances_launcher(
    in_src, in_w, in_ok, overloaded, roots
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Check the inputs, allocate the output and bind the kernel once.

    Returns ``(launch, dist)``: each ``launch()`` enqueues the kernel on
    the current stream (no synchronize), writes ``dist`` [A, V] and counts
    one launch."""
    A, V, K, dev = _check_planes(in_src, in_w, in_ok, overloaded, roots)
    dist = torch.empty((A, V), dtype=torch.float32, device=dev)
    fn = function(
        "spf_dense",
        "openr_dense_spf_distances",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    )
    args = (
        ptr(in_src), ptr(in_w), ptr(in_ok), ptr(overloaded), ptr(roots),
        ptr(dist), A, V, K, BIG, stream(dev),
    )

    def launch() -> None:
        if A == 0:
            return
        check_launch("dense_spf_distances", fn(*args))
        LAUNCHES["dense_spf_distances"] += 1

    return launch, dist


def dense_spf_distances_cuda(in_src, in_w, in_ok, overloaded, roots) -> torch.Tensor:
    launch, dist = dense_spf_distances_launcher(in_src, in_w, in_ok, overloaded, roots)
    launch()
    return dist


def dense_spf_nexthop_lanes_launcher(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Like :func:`dense_spf_distances_launcher`: ``(launch, nh)`` with
    ``nh`` [A, V, D] int8 written by each ``launch()``."""
    A, V, K, dev = _check_planes(in_src, in_w, in_ok, overloaded, roots)
    check_tensor("in_rank", in_rank, torch.int32, (A, V, K), dev)
    check_tensor("in_has", in_has, torch.bool, (A, V), dev)
    check_tensor("dist", dist, torch.float32, (A, V), dev)
    D = int(max_degree)
    if D < 1:
        raise ValueError(f"max_degree {D} must be >= 1")
    nh = torch.empty((A, V, D), dtype=torch.int8, device=dev)
    edge_class = torch.empty((A, V, K), dtype=torch.uint8, device=dev)
    fn = function(
        "spf_dense",
        "openr_dense_spf_nexthop_lanes",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )
    args = (
        ptr(in_src), ptr(in_w), ptr(in_ok), ptr(in_rank), ptr(in_has),
        ptr(overloaded), ptr(roots), ptr(dist), ptr(edge_class), ptr(nh),
        A, V, K, D, BIG, stream(dev),
    )

    def launch() -> None:
        if A == 0:
            return
        check_launch("dense_spf_nexthop_lanes", fn(*args))
        LAUNCHES["dense_spf_nexthop_lanes"] += 1

    return launch, nh


def dense_spf_nexthop_lanes_cuda(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> torch.Tensor:
    launch, nh = dense_spf_nexthop_lanes_launcher(
        in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree
    )
    launch()
    return nh


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------


def dense_spf_distances(in_src, in_w, in_ok, overloaded, roots) -> torch.Tensor:
    """[A, V] f32 distances; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if in_src.device.type == "cpu":
        return dense_spf_distances_plain(in_src, in_w, in_ok, overloaded, roots)
    return dense_spf_distances_cuda(in_src, in_w, in_ok, overloaded, roots)


def dense_spf_nexthop_lanes(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree: int
) -> torch.Tensor:
    """[A, V, D] int8 lane sets; the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    args = (in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree)
    if in_src.device.type == "cpu":
        return dense_spf_nexthop_lanes_plain(*args)
    return dense_spf_nexthop_lanes_cuda(*args)


def dense_spf_one(
    in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, max_degree: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist [A, V], nexthop lanes [A, V, D]) over the dense in-edge
    matrix."""
    dist = dense_spf_distances(in_src, in_w, in_ok, overloaded, roots)
    nh = dense_spf_nexthop_lanes(
        in_src, in_w, in_ok, in_rank, in_has, overloaded, roots, dist, max_degree
    )
    return dist, nh
