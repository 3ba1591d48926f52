"""The one traffic generator: a traffic file of parameters -> requests.

A traffic file (``traffic/<name>.json``) holds:

- ``loop``: ``"open"`` (requests sent on a schedule, whether or not earlier
  ones finished) with ``rate_per_s``, or ``"closed"`` with ``clients``,
  each sending its next request when its last one ends;
- ``prompt_tokens`` and ``output_tokens``: ``{"dist": "lognormal",
  "median", "sigma", "min", "max"}`` or ``{"dist": "uniform", "min",
  "max"}``;
- optionally ``inputs``: what requests carry beside their token ids, drawn
  from it by the configuration's kit (``kit.py``, ``draw_inputs``); it
  gives requests their ``extras`` (keyword arguments of
  ``generate_stream``) and may put placeholder tokens into their prompts.

Every seed gets the same schedule, one draw from ``SCHEDULE_SEED``: each
request's prompt and output size independent draws from their
distributions (clipped, whole tokens), and open-loop arrivals a Poisson
process at the rate (independent exponential gaps, the first request at the
window's opening). Each quantity has a stream of its own, so the first
requests of a schedule are the same whatever its length, and a sweep's
rates share one pattern of gaps scaled by the rate. The seed draws the
token ids (and, elsewhere, the weights and the check's sample), not the
work: with the order of sizes and gaps drawn from the seed too, two seeds'
95th percentiles of TTFT differed by 46 % while one seed repeated read
within 0.4 %. Token ids are uniform over the configuration's ordinary ids
(``assumed.ordinary_token_ids``, [lo, hi)), so no special, image or video
id is drawn. Every request asks for exactly its
output size: the run sends no stop tokens. The schedule's streams are the
children of one ``SeedSequence``: 0-2 the prompt sizes, output sizes and
gaps, and 3 onwards the kit's inputs, so a traffic without inputs
draws what it drew before any traffic had them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

#: requests made for each closed-loop client (more than a window can use)
CLOSED_PER_CLIENT = 64
#: the one draw of every schedule
SCHEDULE_SEED = 20
#: the schedule's streams: 0-2 sizes and gaps, the rest the kit's inputs
STREAMS = 16


@dataclasses.dataclass
class Request:
    index: int
    prompt: list
    max_tokens: int
    due_s: float = 0.0  # open loop: send time after the window opens
    client: int = -1  # closed loop: the client that sends it, in order
    extras: dict = dataclasses.field(default_factory=dict)  # generate_stream's inputs


def sizes(spec: dict, n: int, rng) -> np.ndarray:
    """n independent draws of a size distribution, clipped and rounded to
    whole tokens."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n).astype(np.int64)
    if spec["dist"] == "lognormal":
        x = float(spec["median"]) * np.exp(float(spec["sigma"]) * rng.standard_normal(n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown size distribution {spec['dist']!r}")


def count(traffic: dict, seconds: float) -> int:
    """Requests made for a run: more than an open loop's Poisson arrivals
    can reach in the window (the sender stops at its close), or a fixed
    list per client (closed)."""
    if traffic["loop"] == "open":
        mean = float(traffic["rate_per_s"]) * seconds
        return int(mean + 6 * np.sqrt(mean) + 10)
    return int(traffic["clients"]) * CLOSED_PER_CLIENT


def requests(traffic: dict, cfg: dict, seed: int, seconds: float, device="cpu",
             root: Optional[Path] = None) -> list:
    """The run's requests, in sending order (open: by due time; closed:
    client c sends ``[r for r in out if r.client == c]`` in order); request
    inputs, where the traffic has them, are made on ``device`` by the
    configuration's kit (read under ``root``, this checkout by default)."""
    n = count(traffic, seconds)
    streams = np.random.SeedSequence(SCHEDULE_SEED).spawn(STREAMS)
    prompt_rng, output_rng, gap_rng = (np.random.default_rng(s) for s in streams[:3])
    plen = sizes(traffic["prompt_tokens"], n, prompt_rng)
    olen = sizes(traffic["output_tokens"], n, output_rng)
    lo, hi = cfg["assumed"]["ordinary_token_ids"]
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    ids = rng.integers(lo, hi, size=int(plen.sum()), dtype=np.int64)
    cuts = np.concatenate([[0], np.cumsum(plen)])
    out = [Request(i, ids[cuts[i]:cuts[i + 1]].tolist(), int(olen[i]))
           for i in range(n)]
    if traffic["loop"] == "open":
        gaps = gap_rng.standard_exponential(n) / float(traffic["rate_per_s"])
        due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        for r, t in zip(out, due):
            r.due_s = float(t)
    elif traffic["loop"] == "closed":
        for r in out:
            r.client = r.index % int(traffic["clients"])
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    if "inputs" in traffic:
        from portbench import kit

        kit.of(cfg, root).draw_inputs(traffic["inputs"], cfg, out, streams[3:], seed,
                                      device)
    return out
