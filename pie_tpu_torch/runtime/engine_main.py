"""The standalone engine process: requests arrive over the POSIX shm ring
(a C++ reader thread, a futex doorbell), the C++ scheduler drives the
``PagedEngine``'s native programs, and tokens stream back through the
response ring. Frontends attach with
:class:`pie_tpu_torch.runtime.ipc.IpcFrontend`.

Port of the JAX package's ``pie_tpu/runtime/engine_main.py``; the model
loads through the port's loader, onto the card unless ``--device cpu``.

Run:  python -m pie_tpu_torch.runtime.engine_main \\
          --model-path /path/to/snapshot --channel /pie_engine

On SIGINT or SIGTERM it finishes the step in flight, stops the reader
thread, unlinks the shm segment, logs its decode steps and kernel launch
counts, and exits 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--channel", default="/pie_engine",
                    help="shm channel name (frontends attach to this)")
    ap.add_argument("--num-lanes", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--max-pages-per-seq", type=int, default=64)
    ap.add_argument("--kv-quantized", action="store_true")
    ap.add_argument("--request-slots", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level)
    t0 = time.perf_counter()

    from pie_tpu_torch.engine.scheduler import PagedEngine
    from pie_tpu_torch.models.loader import load_model
    from pie_tpu_torch.runtime.ipc import IpcEngineService
    from pie_tpu_torch.runtime.native_scheduler import NativeScheduler
    from pie_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    logger.info("loading model from %s", args.model_path)
    model, params = load_model(args.model_path, device=device)
    engine = PagedEngine(
        model, params, num_lanes=args.num_lanes, num_pages=args.num_pages,
        max_pages_per_seq=args.max_pages_per_seq, kv_quantized=args.kv_quantized,
        device=device,
    )
    service = IpcEngineService(NativeScheduler(engine), args.channel,
                               request_slots=args.request_slots)
    stop = threading.Event()

    def _graceful(signum, frame):
        logger.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, _graceful)
    signal.signal(signal.SIGTERM, _graceful)
    logger.info("engine up in %.1f s: channel=%s lanes=%d pages=%d device=%s",
                time.perf_counter() - t0, args.channel, args.num_lanes,
                args.num_pages, device)
    try:
        service.serve_forever(should_stop=stop.is_set)
    finally:
        service.shutdown()
        from pie_tpu_torch.ops import quant_matmul_cuda as qmc

        logger.info("engine down after %d decode steps; launches %s",
                    engine.device_steps, json.dumps(qmc.launch_counts))


if __name__ == "__main__":
    main()
