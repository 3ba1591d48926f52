"""The traffic generator: deterministic per seed, the same work for every
seed, and true to its parameters."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

BENCH = Path(__file__).resolve().parents[1]
CELLS = [("chat-qwen7b", "qwen2.5-vl-7b"), ("decode-c32", "mistral-7b-v0.3"),
         ("longprompt-qwen7b", "qwen2.5-vl-7b")]
BIG_SEED = 2**31 + 12345


def _load(t, c):
    return (json.loads((BENCH / "traffic" / f"{t}.json").read_text()),
            json.loads((BENCH / "configs" / f"{c}.json").read_text()))


@pytest.mark.parametrize("t,c", CELLS)
def test_same_seed_same_requests(t, c):
    tr, cfg = _load(t, c)
    a = traffic.requests(tr, cfg, BIG_SEED, 30)
    b = traffic.requests(tr, cfg, BIG_SEED, 30)
    assert [(r.prompt, r.max_tokens, r.due_s, r.client) for r in a] == \
        [(r.prompt, r.max_tokens, r.due_s, r.client) for r in b]
    other = traffic.requests(tr, cfg, BIG_SEED + 1, 30)
    assert [r.prompt for r in a] != [r.prompt for r in other]


@pytest.mark.parametrize("t,c", CELLS)
def test_every_seed_gets_the_same_schedule(t, c):
    tr, cfg = _load(t, c)
    a, b = (traffic.requests(tr, cfg, s, 30) for s in (1, 2**40 + 7))
    assert [(len(r.prompt), r.max_tokens, r.due_s, r.client) for r in a] == \
        [(len(r.prompt), r.max_tokens, r.due_s, r.client) for r in b]


@pytest.mark.parametrize("t,c", CELLS)
def test_sizes_and_ids_follow_the_parameters(t, c):
    tr, cfg = _load(t, c)
    reqs = traffic.requests(tr, cfg, 7, 51)
    for key, get in (("prompt_tokens", lambda r: len(r.prompt)),
                     ("output_tokens", lambda r: r.max_tokens)):
        spec, vals = tr[key], np.array([get(r) for r in reqs])
        assert vals.min() >= spec["min"] and vals.max() <= spec["max"]
        many = traffic.sizes(spec, 20000, np.random.default_rng(1))
        assert many.min() == spec["min"] and many.max() == spec["max"]
        if spec["dist"] == "lognormal":
            assert abs(np.median(many) - spec["median"]) <= 0.02 * spec["median"] + 1
        else:
            assert abs(many.mean() - (spec["min"] + spec["max"]) / 2) < 0.01 * spec["max"]
    lo, hi = cfg["assumed"]["ordinary_token_ids"]
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= lo and ids.max() < hi


def test_open_loop_is_poisson_and_closed_loop_has_its_clients():
    tr, cfg = _load("chat-qwen7b", "qwen2.5-vl-7b")
    reqs = traffic.requests(tr, cfg, 3, 51)
    due = np.array([r.due_s for r in reqs])
    assert list(due) == sorted(due) and due[0] == 0.0 and due[-1] > 51
    gaps = np.diff([r.due_s for r in traffic.requests(dict(tr, rate_per_s=2.0), cfg, 3, 2000)])
    # exponential gaps: mean 1 / rate, coefficient of variation 1, no floor
    assert abs(gaps.mean() - 0.5) < 0.03 and abs(gaps.std() / gaps.mean() - 1) < 0.06
    assert (gaps < 0.05).mean() > 0.07
    tr, cfg = _load("decode-c32", "mistral-7b-v0.3")
    reqs = traffic.requests(tr, cfg, 3, 51)
    assert Counter(r.client for r in reqs) == {c: traffic.CLOSED_PER_CLIENT
                                               for c in range(tr["clients"])}


def test_a_longer_schedule_begins_as_a_shorter_one():
    tr, cfg = _load("chat-qwen7b", "qwen2.5-vl-7b")
    short, long = (traffic.requests(tr, cfg, 9, s) for s in (20, 51))
    assert [(r.prompt, r.max_tokens, r.due_s) for r in short] == \
        [(r.prompt, r.max_tokens, r.due_s) for r in long[:len(short)]]
