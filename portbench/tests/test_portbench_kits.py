"""Kits and request inputs: the dense kit gives what the benchmark gave
before kits (digests pinned from that tree at a tiny size), the schedule's
first streams do not move when more are drawn, the image generator's
draws, and a configuration, kit, traffic with inputs and check added as
files alone, found and run with no other edit."""

from __future__ import annotations

import hashlib
import json
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_config
from portbench import check, harness, kit, traffic

#: digests of the benchmark's outputs before kits (tiny configurations, 1
#: thread): the seeded state dicts and the decoder reference's logits, the
#: three traffics' schedules at their real configurations, a sample
BEFORE = {
    "weights/qwen2.5-vl-7b": "61c9ebe593d7711c", "logits/qwen2.5-vl-7b": "55a4f8b55833f36f",
    "weights/mistral-7b-v0.3": "5019f99065eb5377", "logits/mistral-7b-v0.3": "33ccecf94de42df3",
    "traffic/chat-qwen7b": "0f22110a41839273", "traffic/decode-c32": "d5548360e3875467",
    "traffic/longprompt-qwen7b": "770fc29f9b3c7d38", "sample": "fd8e0195db935f09",
}
REAL = {"chat-qwen7b": "qwen2.5-vl-7b", "decode-c32": "mistral-7b-v0.3",
        "longprompt-qwen7b": "qwen2.5-vl-7b"}


def _digest(*parts) -> str:
    d = hashlib.sha256()
    for p in parts:
        d.update(p if isinstance(p, bytes) else repr(p).encode())
    return d.hexdigest()[:16]


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32).numpy().tobytes()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("real", ["qwen2.5-vl-7b", "mistral-7b-v0.3"])
def test_the_dense_kit_gives_what_the_benchmark_gave(real, one_thread):
    cfg = tiny_config(real)
    dense = kit.of(cfg)
    assert dense is kit.load(kit.DEFAULT)
    sd = dense.state_dict(cfg, 11, "cpu")
    assert _digest(*[(k, _bytes(sd[k])) for k in sorted(sd)]) == BEFORE[f"weights/{real}"]
    ids = [torch.randint(0, 600, (150,), generator=torch.Generator().manual_seed(3)),
           torch.randint(0, 600, (77,), generator=torch.Generator().manual_seed(4))]
    rows = [torch.arange(150), torch.arange(10, 77)]
    logits = dense.reference(cfg, 11, "cpu").logits([(i, {}) for i in ids], rows)
    assert _digest(*[_bytes(x) for x in logits]) == BEFORE[f"logits/{real}"]


@pytest.mark.parametrize("name", sorted(REAL))
def test_every_schedule_is_what_it_was(name):
    tr = json.loads((ROOT / "portbench/traffic" / f"{name}.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs" / f"{REAL[name]}.json").read_text())
    reqs = traffic.requests(tr, cfg, 2**40 + 7, 51)
    assert not any(r.extras for r in reqs)
    assert _digest(*[(r.index, r.prompt, r.max_tokens, r.due_s, r.client)
                     for r in reqs]) == BEFORE[f"traffic/{name}"]


def test_the_sample_is_what_it_was():
    rng = np.random.default_rng(5)
    recs = [SimpleNamespace(index=i, prompt=[0] * int(rng.integers(10, 300)),
                            tokens=[1] * int(rng.integers(5, 60)), due=0.1 * i,
                            finished=5.0 if i % 7 else None, error=None, extras={})
            for i in range(40)]
    run = SimpleNamespace(sent=recs, t_close=10.0)
    assert _digest([r.index for r in check.sample(run, 2**33 + 9, 512)]) == BEFORE["sample"]


@pytest.mark.parametrize("n", [3, 4, traffic.STREAMS, 64])
def test_more_streams_leave_the_first_three_alone(n):
    first = [np.random.default_rng(s).random(8)
             for s in np.random.SeedSequence(traffic.SCHEDULE_SEED).spawn(3)]
    more = np.random.SeedSequence(traffic.SCHEDULE_SEED).spawn(n)
    assert all(np.array_equal(a, np.random.default_rng(s).random(8))
               for a, s in zip(first, more[:3]))


def test_the_sample_always_holds_the_longest_image_request():
    recs = [SimpleNamespace(index=i, prompt=[0] * (300 if i == 3 else 100 + i),
                            tokens=[1] * 20, due=0.1 * i, finished=5.0, error=None,
                            extras={"pixel_values": 1} if i in (5, 9, 12) else {})
            for i in range(30)]
    run = SimpleNamespace(sent=recs, t_close=10.0)
    for seed in range(20):
        picked = check.sample(run, seed, 60)
        assert picked[0].index == 3 and picked[1].index == 12


def test_image_requests_follow_the_traffic():
    tr = json.loads((ROOT / "portbench/traffic/chat-image-qwen7b.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/qwen2.5-vl-7b-vision.json").read_text())
    plain = dict(tr)
    plain.pop("inputs")
    text = traffic.requests(plain, cfg, 5, 51)
    reqs = traffic.requests(tr, cfg, 5, 51)
    again = traffic.requests(tr, cfg, 2**40 + 1, 51)
    images = [r for r in reqs if r.extras]
    assert 0.2 < len(images) / len(reqs) < 0.4
    sides = set()
    for r, t, o in zip(reqs, text, again):
        # the schedule's sizes, gaps and images are every seed's
        assert (r.max_tokens, r.due_s, len(r.prompt)) == (t.max_tokens, t.due_s, len(o.prompt))
        if not r.extras:
            assert r.prompt == t.prompt
            continue
        (_, h, w), = r.extras["image_kwargs"]["grid_thw"]
        sides |= {h, w}
        assert r.extras["pixel_values"].shape == (h * w, 1176)
        n = h * w // 4
        k = r.prompt.index(cfg["vision_start_token_id"])
        assert 1 <= k < len(t.prompt)
        assert r.prompt == (t.prompt[:k] + [cfg["vision_start_token_id"]]
                            + [cfg["image_token_id"]] * n + [cfg["vision_end_token_id"]]
                            + t.prompt[k:])
        assert len(r.prompt) + r.max_tokens <= 66 * 64
    assert sides <= set(range(16, 73, 2)) and min(sides) < 24 and max(sides) > 64


# -- a new configuration as files alone --------------------------------------------


#: a throwaway kit: the dense one, its requests carrying a "shift" that the
#: program reads as a logit bias on one id and the reference adds too
SHIFT_KIT = '''
    import torch

    from portbench.kits import dense_decoder as dense

    state_dict = dense.state_dict
    decode_token_flops = dense.decode_token_flops
    prefill_flops = dense.prefill_flops
    rider_flops = dense.rider_flops


    def call_flops(cfg, call):
        return 0.0


    class Reference:
        def __init__(self, cfg, seed, device, precision="f32"):
            self.decoder = dense.decoder(cfg, seed, device, precision)

        def logits(self, requests, rows):
            out = self.decoder.logits([ids for ids, _ in requests], rows)
            for lg, (_, ex) in zip(out, requests):
                for tid, b in ex.get("logit_bias", {}).items():
                    lg[:, tid] += b
            return out


    def reference(cfg, seed, device, precision="f32"):
        return Reference(cfg, seed, device, precision)


    def draw_inputs(spec, cfg, reqs, streams, seed, device):
        every = np.random.default_rng(streams[0]).random(len(reqs)) < spec["share"]
        for r in reqs:
            if every[r.index]:
                r.extras = {"logit_bias": {int(spec["id"]): 50.0}}


    def warm_requests(spec, cfg, seed, device):
        return [([cfg["assumed"]["ordinary_token_ids"][0]] * 40,
                 {"logit_bias": {int(spec["id"]): 50.0}})]
'''


def test_a_configuration_with_inputs_comes_as_files_alone(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*") if p.is_file()}
    (tiny_root / "portbench/kits/shift.py").write_text(
        "import numpy as np\n" + textwrap.dedent(SHIFT_KIT))
    cfg = tiny_config("mistral-7b-v0.3")
    cfg["assumed"]["kit"] = "portbench/kits/shift.py"
    (tiny_root / "portbench/configs/tiny-shift.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-shift", "source": "tiny",
                             "file": "portbench/configs/tiny-shift.json",
                             "reduced": [], "why": "added"})
    (tiny_root / "portbench/traffic/tiny-shifted.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 3.0,
         "prompt_tokens": {"dist": "uniform", "min": 40, "max": 48},
         "output_tokens": {"dist": "uniform", "min": 3, "max": 5},
         "inputs": {"share": 0.5, "id": 7}}))
    bench["workloads"].append({"name": "tiny-shifted", "config": "tiny-shift",
                               "traffic": "tiny-shifted", "chips": 1, "why": "added"})
    (tiny_root / "portbench/checks/tiny-shifted.json").write_text(json.dumps(
        {"widest_gap_limit": 0.2, "min_tokens_compared": 3, "sample_tokens": 10**6}))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    _, run, _ = harness.serve(tiny_root, "tiny-shifted", 77, 8.0, False, device="cpu")
    shifted = [r for r in run.sent if r.extras and r.finished]
    assert shifted and all(set(r.tokens) == {7} for r in shifted)
    res = harness.run_cell(tiny_root, "tiny-shifted", 77, 8.0, False, device="cpu")
    assert res["correct"], res["compared"]
    assert res["diagnostics"]["judged_with_inputs"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())
