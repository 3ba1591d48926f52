"""The port's continuous-batching scheduler (pie_tpu_torch.engine.scheduler)
on the CPU: batched greedy streams equal to the port's single-stream engine
and to the JAX package's Scheduler on the same weights, page exhaustion
queues then completes, cancellation, a stop token mid-chunk, lane reuse,
direct prefill while other lanes decode, a prefix-cache hit that prefills
only the suffix, the INT8 pool, steady decode on chained device state at
pipeline depths 1 and 2, the XTC and DRY values admission writes into the
lane arrays, and greedy streams with DRY on against the JAX Scheduler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.engine.scheduler import PagedEngine as JPagedEngine
from pie_tpu.engine.scheduler import Scheduler as JScheduler
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu_torch.cache.paged import PAGE_SIZE
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params

from test_torch_llama import jax_to_np, small_config

PROMPTS = {
    "a": [5, 17, 42, 7],
    "b": [9, 3, 3, 7, 1],
    "c": list(range(10, 40)),  # 29-token body: rides mixed steps
    "mid": list(range(3, 20)),
    "one": [5],
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """JAX and port models on the same INT4 g64 weights, embedding and head
    at unit scale so greedy choices are decisive (as test_torch_engine)."""
    cfg = small_config(256, 4, 2)
    jm = JModel(JConfig.from_dict(cfg))
    jp = jm.init_params(jax.random.PRNGKey(3), dtype=jnp.float32)
    jp["embed"] = jp["embed"] * 50.0
    jp["lm_head"] = jp["lm_head"] * 50.0
    jp = jm.quantize_params(jp, group_size=64, bits=4)
    return jm, jp, LlamaModel(LlamaConfig.from_dict(cfg)), from_jax_params(
        jax_to_np(jp), "cpu")


@pytest.fixture(scope="module")
def single(models):
    """Greedy streams of the port's single-stream engine."""
    _, _, tm, tp = models
    eng = InferenceEngine(model=tm, params=tp, max_seq_len=256,
                          kv_dtype=torch.float32, decode_chunk=8,
                          prompt_cache=False, device="cpu")
    cache = {}

    def run(prompt, n=10):
        key = (tuple(prompt), n)
        if key not in cache:
            cache[key] = eng.generate(prompt, max_completion_tokens=n,
                                      temperature=0.0).token_ids
        return cache[key]

    return run


def _sched(models, num_lanes=4, num_pages=32, **kw):
    _, _, tm, tp = models
    sched_kw = {k: kw.pop(k) for k in ("decode_steps", "prefix_cache") if k in kw}
    eng = PagedEngine(tm, tp, num_lanes=num_lanes, num_pages=num_pages,
                      max_pages_per_seq=8, prefill_chunk=kw.pop("prefill_chunk", 16),
                      kv_dtype=torch.float32, device="cpu", **kw)
    return Scheduler(eng, **sched_kw)


def test_batched_greedy_matches_single_stream_and_jax(models, single):
    jm, jp, _, _ = models
    names = ("a", "b", "c")
    sched = _sched(models)
    seqs = {k: sched.add_request(PROMPTS[k], max_new_tokens=10, temperature=0.0)
            for k in names}
    sched.run_to_completion(max_steps=200)
    jsched = JScheduler(JPagedEngine(jm, jp, num_lanes=4, num_pages=32,
                                     max_pages_per_seq=8, prefill_chunk=16,
                                     kv_dtype=jnp.float32))
    jseqs = {k: jsched.add_request(PROMPTS[k], max_new_tokens=10, temperature=0.0)
             for k in names}
    jsched.run_to_completion(max_steps=200)
    for k, seq in seqs.items():
        assert seq.status == SeqStatus.COMPLETED and seq.finish_reason == "length"
        assert seq.output_ids == single(PROMPTS[k]) == jseqs[k].output_ids, k


def test_page_exhaustion_queues_then_completes(models, single):
    sched = _sched(models, num_lanes=4, num_pages=2)
    seqs = [sched.add_request([7, i], max_new_tokens=8, temperature=0.0)
            for i in range(4)]
    sched.step()
    assert len(sched.waiting) == 2  # one page each: two requests wait
    sched.run_to_completion(max_steps=500)
    assert all(s.status == SeqStatus.COMPLETED for s in seqs)
    assert [s.output_ids for s in seqs] == [single([7, i], 8) for i in range(4)]
    assert sched.manager.num_free_pages() == 2


def test_cancellation(models):
    sched = _sched(models)
    seq = sched.add_request([5, 6, 7], max_new_tokens=50, temperature=0.0)

    def cancel_after(s, t):
        if len(s.output_ids) >= 3:
            s.cancelled = True

    seq.on_token = cancel_after
    sched.run_to_completion(max_steps=200)
    assert seq.status == SeqStatus.CANCELLED
    assert 3 <= len(seq.output_ids) <= 5
    assert sched.manager.num_free_pages() == sched.engine.pool.num_pages


def test_stop_token_mid_chunk(models, single):
    want = single(PROMPTS["mid"], 12)
    streamed = []
    sched = _sched(models, decode_steps=4)
    seq = sched.add_request(PROMPTS["mid"], max_new_tokens=12, temperature=0.0,
                            stop_token_ids=(want[2],))
    seq.on_token = lambda s, t: streamed.append(t)
    sched.run_to_completion(max_steps=100)
    assert seq.finish_reason == "stop"
    assert seq.output_ids == streamed == want[:3]


def test_lane_reuse_and_single_token_prompt(models, single):
    sched = _sched(models, num_lanes=2)
    seqs = [sched.add_request(PROMPTS["a"], max_new_tokens=10, temperature=0.0)
            for _ in range(4)]
    one = sched.add_request(PROMPTS["one"], max_new_tokens=10, temperature=0.0)
    sched.run_to_completion(max_steps=1000)
    for s in seqs:
        assert s.output_ids == single(PROMPTS["a"])
    assert one.output_ids == single(PROMPTS["one"])
    assert len(sched.free_lanes) == 2


@pytest.mark.parametrize("depth", [1, 2])
def test_direct_prefill_while_decoding(models, single, depth):
    """An 80-token prompt admitted while a lane decodes prefills through
    dedicated programs (32-token chunks); at pipeline depth 2 it wakes in a
    chunk dispatched before the one in flight drains. Neither stream
    changes."""
    long_prompt = list(range(10, 90))
    sched = _sched(models, prefill_chunk=32, rider_width=8)
    sched.pipeline_depth = depth
    short = sched.add_request(PROMPTS["a"], max_new_tokens=40, temperature=0.0)
    sched.step()
    sched.step()  # steady decode
    assert short.status == SeqStatus.DECODING
    late = sched.add_request(long_prompt, max_new_tokens=10, temperature=0.0)
    sched.step()
    assert late.status == SeqStatus.DECODING and late.prefill_pos == 79
    assert len(sched._inflight) == depth - 1
    sched.run_to_completion(max_steps=200)
    assert late.output_ids == single(long_prompt)
    assert short.output_ids == single(PROMPTS["a"], 40)


def test_prefix_cache_hit_prefills_only_suffix(models, single):
    prefix = [7 + (i * 13) % 200 for i in range(150)]
    p1, p2 = prefix + [3, 5], prefix + [9, 11, 4]
    outs = {}
    for cached in (True, False):
        sched = _sched(models, num_pages=48, prefix_cache=cached)
        s1 = sched.add_request(p1, max_new_tokens=8, temperature=0.0)
        sched.run_to_completion()
        s2 = sched.add_request(p2, max_new_tokens=8, temperature=0.0)
        sched.run_to_completion()
        outs[cached] = [s1.output_ids, s2.output_ids]
        if cached:
            # the two full pages of the shared prefix are spliced in
            assert s2.pending_base == 2 * PAGE_SIZE
            assert sched.prefix_store.hits >= 1 and len(sched.prefix_store) >= 2
    assert outs[True] == outs[False] == [single(p1, 8), single(p2, 8)]


def test_int8_pool(models):
    ref = _sched(models)
    q8 = _sched(models, kv_quantized=True)
    p = list(range(1, 30))
    a = ref.add_request(p, max_new_tokens=8, temperature=0.0)
    b = q8.add_request(p, max_new_tokens=8, temperature=0.0)
    ref.run_to_completion(max_steps=50)
    q8.run_to_completion(max_steps=50)
    assert q8.engine.pool.k.dtype == torch.int8
    assert a.status == b.status == SeqStatus.COMPLETED and len(b.output_ids) == 8
    assert a.output_ids[:2] == b.output_ids[:2]  # INT8 KV is lossy


def test_paged_attention_runs_once_per_layer_per_device_step(models, single,
                                                            monkeypatch):
    """The count chip_smoke.py holds K3's launches to on the card: the paged
    decode attention runs once per layer in every decode or mixed device
    step, and a direct prefill does not run it."""
    import pie_tpu_torch.models.llama as tl

    calls = []
    real = tl.paged_attention_decode

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tl, "paged_attention_decode", counted)
    sched = _sched(models, prefill_chunk=32, rider_width=8)
    direct = sched.add_request(list(range(10, 90)), max_new_tokens=6, temperature=0.0)
    rider = sched.add_request(PROMPTS["c"][:9], max_new_tokens=6, temperature=0.0)
    sched.step()  # admits both: the 79-token body prefills directly
    assert direct.prefill_pos == 79 and sched.engine.device_steps > 0
    sched.run_to_completion(max_steps=100)
    layers = models[2].config.num_hidden_layers
    assert len(calls) == layers * sched.engine.device_steps
    assert direct.output_ids == single(list(range(10, 90)), 6)
    assert rider.output_ids == single(PROMPTS["c"][:9], 6)


@pytest.mark.parametrize("depth", [1, 2])
def test_steady_decode_chains_device_state(models, single, depth):
    """Steady decode chunks start from the previous chunk's device state,
    not from host mirrors; at pipeline depth 2 the next chunk is dispatched
    before the previous one drains, so one stays in flight between steps.
    The streams do not change."""
    sched = _sched(models, decode_steps=4)
    sched.pipeline_depth = depth
    seqs = [sched.add_request(PROMPTS[k], max_new_tokens=20, temperature=0.0)
            for k in ("a", "b")]
    sched.step()  # admission and the first (flushed) chunk
    depths, chained = [], []
    while sched.has_work:
        sched.step()
        depths.append(len(sched._inflight))
        chained.append(sched._chained)
    assert max(depths) == depth - 1 and any(chained)
    for k, s in zip(("a", "b"), seqs):
        assert s.output_ids == single(PROMPTS[k], 20)


# request: (xtc_probability, xtc_threshold, dry_multiplier, dry_base,
# dry_allowed_length); distinct per lane, none of them the defaults
XTC_DRY = [(0.25, 0.05, 0.8, 1.5, 3), (0.0, 0.3, 0.0, 2.25, 1),
           (1.0, 0.125, 1.2, 1.75, 4), (0.5, 0.2, 0.3, 3.0, 2)]


def test_admission_writes_xtc_and_dry_into_the_lane_arrays(models):
    """Scheduler._admit copies each request's XTC and DRY values into the
    lane arrays that the sampler and the penalties read: exactly the
    request's values (as float32 / int32), in the request's lane."""
    sched = _sched(models)
    seqs = [sched.add_request([3 + i, 5, 7], max_new_tokens=4, temperature=0.0,
                              xtc_probability=p, xtc_threshold=t, dry_multiplier=dm,
                              dry_base=db, dry_allowed_length=da)
            for i, (p, t, dm, db, da) in enumerate(XTC_DRY)]
    sched._admit()
    lanes = [s.lane for s in seqs]
    assert sorted(lanes) == list(range(4))
    for s, (p, t, dm, db, da) in zip(seqs, XTC_DRY):
        assert sched.samp["xtc_probability"][s.lane] == np.float32(p)
        assert sched.samp["xtc_threshold"][s.lane] == np.float32(t)
        assert sched.pen["dry_multiplier"][s.lane] == np.float32(dm)
        assert sched.pen["dry_base"][s.lane] == np.float32(db)
        assert sched.pen["dry_allowed"][s.lane] == da
    assert sched.samp["xtc_probability"].dtype == np.float32
    assert sched.pen["dry_allowed"].dtype == np.int32
    sched.run_to_completion(max_steps=200)
    assert all(s.status == SeqStatus.COMPLETED for s in seqs)


def test_batched_greedy_with_dry_matches_jax(models):
    """Greedy streams with DRY on, through the port's Scheduler and the JAX
    package's on the same weights: equal token for token, and different
    from the port's streams with DRY off (so the penalty took effect).

    Each prompt is a base prompt, the first k + 1 tokens of its greedy
    continuation, the base again and the first k tokens: the next token
    would extend a repeat of length len(base) + k, which DRY penalises by
    2 * 1.75 ** (len(base) + k - 2). The (base, k) pairs are ones whose
    greedy choices stay clear of ties: the two packages' logits differ by
    2-5e-3 of their size (tests/test_torch_llama.py), and some other pairs
    of this tiny model meet top-2 gaps of 0.01-0.1 on logits of ~45, where
    either package's pick is as right as the other's."""
    jm, jp, _, _ = models
    dry = dict(dry_multiplier=2.0, dry_base=1.75, dry_allowed_length=2)

    def port(prompts, **kw):
        sched = _sched(models)
        seqs = [sched.add_request(p, max_new_tokens=10, temperature=0.0, **kw)
                for p in prompts]
        sched.run_to_completion(max_steps=300)
        return [s.output_ids for s in seqs]

    cases = [(PROMPTS["a"], 4), (PROMPTS["b"], 3), (PROMPTS["mid"], 3), ([7, 1], 2)]
    bases = [b for b, _ in cases]
    prompts = [b + o[:k + 1] + b + o[:k]
               for (b, k), o in zip(cases, port(bases))]
    jsched = JScheduler(JPagedEngine(jm, jp, num_lanes=4, num_pages=32,
                                     max_pages_per_seq=8, prefill_chunk=16,
                                     kv_dtype=jnp.float32))
    jseqs = [jsched.add_request(p, max_new_tokens=10, temperature=0.0, **dry)
             for p in prompts]
    jsched.run_to_completion(max_steps=300)
    got = port(prompts, **dry)
    assert got == [s.output_ids for s in jseqs]
    off = port(prompts)
    assert all(g != o for g, o in zip(got, off)), (got, off)
