"""Explicit device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises: nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def host_tensor(a, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device``. To the card it goes through
    a pinned staging buffer, queued without waiting for the device (a copy
    from pageable memory would wait for it)."""
    t = torch.from_numpy(np.array(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload(dst: torch.Tensor, a) -> torch.Tensor:
    """Copy host array ``a`` into the device tensor ``dst`` in place, queued
    as ``host_tensor`` is (``dst`` keeps its address: a captured step may
    read it). A tensor ``a`` is copied as it is, on the stream."""
    if isinstance(a, torch.Tensor):
        return dst.copy_(a.reshape(dst.shape))
    t = torch.from_numpy(np.array(a)).reshape(dst.shape)
    if dst.device.type == "cuda":
        t = t.pin_memory()
    return dst.copy_(t, non_blocking=dst.device.type == "cuda")
