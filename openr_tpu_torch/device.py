"""Device resolution for the port's entry points — the counterpart of
``openr_tpu/ops/platform_env.py``.

Entry points run on the first CUDA card unless the caller names another
device; a request for CUDA on a machine without a card raises instead of
silently running on the CPU.  The tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda:0``; anything else as given.  Raises RuntimeError
    when the resolved device is CUDA and no card is present."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
