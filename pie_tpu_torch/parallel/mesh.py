"""Device mesh construction (port of ``pie_tpu/parallel/mesh.py``)."""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pie_tpu_torch.utils.device import resolve_device


def make_mesh(tp: int = 1, dp: int = 1, device="cuda") -> DeviceMesh:
    """A ``("dp", "tp")`` mesh over the first ``dp * tp`` processes of the
    initialized process group (``parallel.distributed.initialize``). tp is
    the inner dimension: a tp group is ``tp`` adjacent ranks, as JAX puts tp
    on the fastest links. Every process of the group calls it. Raises when
    the world is smaller than ``dp * tp``; ``device="cpu"`` only when the
    caller asks for it."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    world = dist.get_world_size()
    if dp * tp > world:
        raise ValueError(f"need {dp * tp} processes, have {world}")
    ranks = torch.arange(dp * tp).reshape(dp, tp)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("dp", "tp"))
