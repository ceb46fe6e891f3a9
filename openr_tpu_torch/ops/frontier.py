"""The compact out-edge lists that kernels 12 and 15 relax by frontier
(``kernels/csrc/frontier.cuh``), derived once per launch from the layouts
the rest of the port keeps: the dst-sorted edge list (kernel 15) and the
dense in-edge planes (kernel 12).

Each is a CSR by SOURCE of the usable edges only: an edge with
``edge_ok`` (``in_ok``) false, padding included, is dropped, so a
frontier vertex's out-degree is exactly what it may relax.  Vertex u's
out-edges are the slots ``[off[u], off[u + 1])`` of ``edge`` [M, 2] int32,
``(dst, the bits of w)``, so the kernel reads both with one 8-byte load.
A slot also carries, in a parallel array, what the kernel needs besides:
the edge's position in the edge list (kernel 15's row mask bit) or its
``in_rank`` (kernel 12's seed lane).  Within a source, slots keep the
order of the layout they came from (edge order; slot order within the
planes).  Plain torch ops on the caller's device: the CPU tests hold them
edge by edge.
"""

from __future__ import annotations

import torch


def _csr_by_source(key, num_keys: int, dst, w, extra):
    """(off [num_keys + 1], edge [M, 2], extra [M]) int32 of edges listed
    under ``key`` (a stable sort, so each key keeps its input order)."""
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=num_keys)
    off = torch.zeros(num_keys + 1, dtype=torch.int64, device=key.device)
    off[1:] = torch.cumsum(counts, 0)
    edge = torch.stack((dst[order].to(torch.int32), w[order].contiguous().view(torch.int32)), dim=1)
    return off.to(torch.int32), edge.contiguous(), extra[order].to(torch.int32).contiguous()


def out_edge_csr(src, dst, w, edge_ok, num_nodes: int):
    """Kernel 15's list from one edge list ``src/dst/w/edge_ok [E]``:
    ``(off [V + 1], edge [M, 2], edge_id [M])`` int32, ``edge_id`` the
    slot's position in the edge list."""
    usable = torch.nonzero(edge_ok).squeeze(1)
    return _csr_by_source(src[usable].long(), num_nodes, dst[usable], w[usable], usable)


def dense_out_edge_csr(in_src, in_w, in_ok, in_rank):
    """Kernel 12's lists from the dense planes ``in_src/in_w/in_ok/in_rank
    [A, V, K]``, one per area in one array: ``(off [A, V + 1], edge [M, 2],
    rank [M])`` int32, ``off`` absolute slots (area a's vertex v at
    ``off[a, v]``), ``edge`` the slot's (dst = its plane row, w) and
    ``rank`` its ``in_rank``."""
    A, V, K = in_src.shape
    flat = torch.nonzero(in_ok.reshape(-1)).squeeze(1)
    area = flat // (V * K)
    dst = (flat // K) % V
    key = area * V + in_src.reshape(-1)[flat].long()
    off, edge, rank = _csr_by_source(key, A * V, dst, in_w.reshape(-1)[flat], in_rank.reshape(-1)[flat])
    at = torch.arange(A, device=off.device)[:, None] * V + torch.arange(V + 1, device=off.device)
    return off[at].contiguous(), edge, rank


def live_nodes(off, edge, roots) -> int:
    """1 + the largest vertex id that is an endpoint of a listed edge or a
    root (0 if none): the vertices a solve over the list can touch.  Past
    it lies a node bucket's padding, whose distances stay BIG."""
    ids = [
        torch.full((1,), -1, dtype=torch.int64, device=off.device),
        torch.nonzero(off[1:] > off[:-1]).flatten(),
        edge[:, 0].long(),
        roots.reshape(-1).long(),
    ]
    return int(torch.cat(ids).max()) + 1


def frontier_state_bytes(num_nodes: int, cap: int, threads: int) -> int:
    """The frontier state of one block (``frontier_state_ints`` in
    ``frontier.cuh``): distances, the two frontier bitmaps and the word
    ranks, the scan counts and the listed chunk of ``cap`` vertices."""
    words = (num_nodes + 31) // 32
    return 4 * (num_nodes + 3 * words + threads + 1 + 3 * cap + 1)
