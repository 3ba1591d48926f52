"""Multi-host runtime: process-group bring-up, liveness, graceful drain.

Port of the JAX package's ``pie_tpu/parallel/distributed.py`` with
``torch.distributed.init_process_group`` in place of
``jax.distributed.initialize``: NCCL on the card, gloo when the caller asks
for the CPU (or names the backend). A heartbeat file per host in a shared
directory reports a host that stops beating, so its requests can be
re-routed (``parallel.router``), and ``drain`` lets a host finish its
in-flight sequences before it leaves.

Single-process callers can ignore this module.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from pie_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; False (nothing done) without a coordinator.

    Env fallbacks: PIE_COORDINATOR (``host:port`` or a ``tcp://`` URL),
    PIE_NUM_PROCESSES, PIE_PROCESS_ID. The backend is NCCL for ``cuda``
    (each process takes card ``process_id % device_count``) and gloo for
    ``cpu``; ``backend`` names another (gloo over CUDA tensors: several
    processes on one card)."""
    coordinator_address = coordinator_address or os.environ.get("PIE_COORDINATOR")
    if coordinator_address is None:
        return False
    dev = resolve_device(device)
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("PIE_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("PIE_PROCESS_ID", "0"))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    logger.info("process group up: process %d/%d via %s (%s)", process_id,
                num_processes, url, backend)
    return True


class Heartbeat:
    """File-based liveness beacon and peer monitor over a shared directory:
    a host that misses ``timeout`` seconds of beats is reported dead once,
    through ``on_peer_death`` (wire it to ``RequestRouter.mark_host_dead``
    to re-queue the host's requests)."""

    def __init__(self, directory: str | Path, host_id: str, interval: float = 5.0,
                 timeout: float = 30.0,
                 on_peer_death: Optional[Callable[[str], None]] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.interval = interval
        self.timeout = timeout
        self.on_peer_death = on_peer_death
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead: set[str] = set()

    def _path(self, host: str) -> Path:
        return self.dir / f"{host}.heartbeat"

    def beat(self) -> None:
        self._path(self.host_id).write_text(
            json.dumps({"ts": time.time(), "host": self.host_id}))

    def peers(self) -> dict[str, float]:
        out = {}
        for p in self.dir.glob("*.heartbeat"):
            if p.stem == self.host_id:
                continue
            try:
                out[p.stem] = json.loads(p.read_text())["ts"]
            except (OSError, ValueError, KeyError):
                continue
        return out

    def dead_peers(self) -> list[str]:
        now = time.time()
        return [h for h, ts in self.peers().items() if now - ts > self.timeout]

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat()
            for host in self.dead_peers():
                if host not in self._dead:
                    self._dead.add(host)
                    logger.warning("peer %s missed heartbeats", host)
                    if self.on_peer_death:
                        try:
                            self.on_peer_death(host)
                        except Exception:
                            logger.exception("on_peer_death failed")
            self._stop.wait(self.interval)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="pie-heartbeat",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        try:
            self._path(self.host_id).unlink(missing_ok=True)
        except OSError:
            pass


def drain(scheduler, timeout: float = 120.0) -> bool:
    """Stop admitting work and step the scheduler until its in-flight
    sequences (running lanes and chunks still in flight) finish; the
    waiting ones leave its queue, marked WAITING, for another host to take.
    Returns False on timeout."""
    deadline = time.time() + timeout
    requeued = list(scheduler.waiting)
    scheduler.waiting.clear()
    while scheduler.has_work and time.time() < deadline:
        scheduler.step()
    for seq in requeued:
        seq.status = type(seq.status).WAITING
    return not scheduler.has_work
