"""Bit-packed words for the what-if path.

The reference packs booleans 32 to a ``uint32`` word (bit i of word
i // 32): the repair sweep's lanes over the snapshot axis, the selection's
lane sets and changed masks over the lane and prefix axes.  The port holds
those words as ``int32`` tensors with the same bit patterns (PyTorch's
uint32 lacks most operators); numpy callers reinterpret them with
``.view(np.uint32)``.
"""

from __future__ import annotations

import torch


def pack_bits_last(x, width: int):
    """[..., width] bool/0-1 → [..., ceil(width / 32)] int32 words, bit k
    of word j holding element 32 j + k (the reference's
    ``_pack_bits_last``)."""
    words = (width + 31) // 32
    pad = words * 32 - width
    xi = x.to(torch.int64)
    if pad:
        xi = torch.nn.functional.pad(xi, (0, pad))
    xi = xi.reshape(*x.shape[:-1], words, 32)
    weights = torch.ones(32, dtype=torch.int64, device=x.device) << torch.arange(
        32, device=x.device
    )
    packed = (xi * weights).sum(dim=-1)
    # the uint32 bit pattern as int32
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def unpack_bits_last(words, width: int):
    """Inverse of :func:`pack_bits_last`: [..., W] int32 → [..., width]
    bool."""
    idx = torch.arange(width, device=words.device)
    sel = words[..., idx // 32]
    return ((sel >> (idx % 32).to(torch.int32)) & 1).to(torch.bool)
