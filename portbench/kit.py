"""A configuration's kit: every model-specific piece of the benchmark, in a
module of its own that the configuration names by path.

A configuration file names its kit under ``assumed.kit`` (a path from the
checkout's root; ``DEFAULT`` where the key is absent). The harness, the
check, the traffic generator and the readers reach the model only through
this module, so a new architecture comes as new files: a configuration,
its kit, a traffic file, a check and metric readers.

A kit module gives:

- ``state_dict(cfg, seed, device)``: the whole Hugging Face state dict the
  program loads, made from the seed;
- ``reference(cfg, seed, device, precision)``: an object whose
  ``logits(requests, rows)`` takes each judged request as ``(ids, extras)``
  (the 1-D int64 token ids of its prompt and served tokens, and the
  keyword inputs it was sent with) and returns f32 logits at ``rows``,
  worked out again from the seed; ``precision="fp8"`` is the control;
  where requests carry inputs, also ``features(requests)``: for each
  ``(prompt ids, extras)``, the placeholder rows and the f32 features the
  inputs put there (what a check's ``features_gap_limit`` compares with
  the prompt embeddings the program served);
- model FLOPs for ``mfu_pct``: ``decode_token_flops(cfg, ctx)``,
  ``prefill_flops(cfg, positions)``, ``rider_flops(cfg, tokens)`` (a mixed
  step's rider slice) and ``call_flops(cfg, call)`` (work the traced slice
  records beside the steps, such as a vision tower call);
- where a traffic file carries ``inputs``: ``draw_inputs(spec, cfg, reqs,
  streams, seed, device)``, which gives requests their ``extras``
  (``generate_stream``'s keyword arguments) from the schedule's streams and
  the seed, and ``warm_requests(spec, cfg, seed, device)``, the ``(prompt,
  extras)`` pairs that set-up sends so that no shape the inputs need is
  first met in the window.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Optional

#: the kit of a configuration that names none
DEFAULT = "portbench/kits/dense_decoder.py"
#: the checkout this file lies in
ROOT = Path(__file__).resolve().parents[1]

_loaded: dict = {}


def load(rel: str, root: Optional[Path] = None):
    """The module at ``rel`` under ``root`` (this checkout by default),
    loaded once per path."""
    path = (Path(root or ROOT) / rel).resolve()
    if path not in _loaded:
        name = "portbench_file_" + "_".join(path.relative_to(path.anchor).with_suffix("").parts)
        spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def of(cfg: dict, root: Optional[Path] = None):
    """The kit a configuration names."""
    return load(cfg.get("assumed", {}).get("kit", DEFAULT), root)
