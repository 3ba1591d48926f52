"""The port's compiled decode steps (pie_tpu_torch.engine.graphs) on the CPU,
where StepGraphs calls the static-buffer step functions directly: the
single-stream decode step against the JAX package's EngineCore._decode (two
lanes, a stop token in the middle of a chunk, a KV-bucket change between
chunks, chunks read after the next one is queued, logprobs), the paged
rider-free and mixed steps against the JAX Scheduler's PagedEngine._chunk
(a rider with a lane waking mid-chunk, a stop token mid-chunk, two
pipelined chunks), chunks with a constrained lane (the masked steps)
against the JAX Scheduler, no host read inside any step, and a bounded set
of graph keys over a long mixed run."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.engine.core import EngineCore as JCore
from pie_tpu.engine.core import PenaltyParams as JPen
from pie_tpu.engine.scheduler import PagedEngine as JPagedEngine
from pie_tpu.engine.scheduler import Scheduler as JScheduler
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.ops.sampling import SamplingParams as JSamp
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.core import EngineCore, PenaltyParams
from pie_tpu_torch.engine.graphs import StepGraphs
from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.ops.sampling import SamplingParams

from test_torch_llama import jax_to_np, small_config

PAD = -1
PROMPTS = ([5, 17, 42, 7, 9, 3, 3, 7, 1, 11, 30, 2],
           list(range(10, 40)),  # a 29-token body: rides mixed steps
           [9, 3, 3, 7, 1],
           [5])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(weights):
    """JAX and port models on the same weights, embedding and head at unit
    scale so greedy choices are decisive (as test_torch_engine)."""
    cfg = small_config(256, 4, 2)
    jm = JModel(JConfig.from_dict(cfg))
    jp = jm.init_params(jax.random.PRNGKey(3), dtype=jnp.float32)
    jp["embed"] = jp["embed"] * 50.0
    jp["lm_head"] = jp["lm_head"] * 50.0
    if weights == "int4":
        jp = jm.quantize_params(jp, group_size=64, bits=4)
    return jm, jp, LlamaModel(LlamaConfig.from_dict(cfg)), from_jax_params(
        jax_to_np(jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _models("int4")


# -- the single-stream decode step -------------------------------------------------


def _run_cores(models, prompts, chunks, stop=(), logprobs=False):
    """Prefill ``prompts`` (one lane each) in a JAX and a port EngineCore,
    then decode ``chunks`` [(steps, kv_bucket), ...] greedily in both. The
    port's chunk outputs are read only after every chunk was queued.
    Returns the JAX and the port outputs per chunk, as numpy."""
    jm, jp, tm, tp = models
    b = len(prompts)
    jc = JCore(jm, jp, batch_size=b, max_seq_len=128, kv_dtype=jnp.float32)
    tc = EngineCore(tm, tp, batch_size=b, max_seq_len=128, kv_dtype=torch.float32,
                    device="cpu")
    ids = np.zeros((b, 32), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    stop_ids = np.full((8,), PAD, np.int32)
    stop_ids[:len(stop)] = stop
    j_in = (JSamp.make(b, temperature=0.0), JPen.make(b),
            jnp.full((b, 0), PAD, jnp.int32), jnp.zeros((b, 0), jnp.float32))
    t_in = (SamplingParams.make(b, temperature=0.0, device="cpu"),
            PenaltyParams.make(b, device="cpu"),
            torch.full((b, 0), PAD, dtype=torch.int32), torch.zeros((b, 0)))
    js, jtok, _ = jc._prefill(jp, jc.new_state(0), jnp.asarray(ids), jnp.asarray(lens),
                              jnp.zeros((b,), jnp.int32), *j_in, sampler_kind="greedy")
    ts, ttok, _ = tc._prefill(tp, tc.new_state(0), torch.from_numpy(ids),
                              torch.from_numpy(lens), torch.zeros((b,), dtype=torch.int32),
                              *t_in, sampler_kind="greedy")
    assert np.asarray(jtok).tolist() == ttok.tolist()
    jouts, touts = [], []
    for steps, kvb in chunks:
        js, jo = jc._decode(jp, js, *j_in, jnp.asarray(stop_ids), num_steps=steps,
                            return_logprobs=logprobs, sampler_kind="greedy", kv_bucket=kvb)
        ts, to = tc._decode(tp, ts, *t_in, torch.from_numpy(stop_ids), num_steps=steps,
                            return_logprobs=logprobs, sampler_kind="greedy", kv_bucket=kvb,
                            use_penalties=False, use_bias=False)
        jouts.append([np.asarray(o) for o in jo])
        touts.append(to)
    touts = [[o.numpy() for o in to] for to in touts]
    assert np.asarray(js.lengths).tolist() == ts.lengths.tolist()
    assert np.asarray(js.done).tolist() == ts.done.tolist()
    return jouts, touts, tc


@pytest.mark.parametrize("case", ["stop_mid_chunk", "bucket_change"])
def test_decode_steps_match_jax_core(models, case):
    """Two lanes, greedy: the emitted tokens of every chunk equal the JAX
    core's, token for token, with one lane stopping at step 3 of a chunk
    (it emits PAD after and the other lane goes on), or with the KV bucket
    growing from 32 to 64 between chunks; each chunk's tokens are read
    after the next chunk was queued."""
    prompts = (PROMPTS[0], PROMPTS[2])
    chunks = [(8, 32), (8, 64)]
    stop = ()
    if case == "stop_mid_chunk":
        _, free, _ = _run_cores(models, prompts, chunks)
        stop = (int(free[1][0][3, 0]),)
        chunks = [(8, 64), (8, 64)]
    jouts, touts, tc = _run_cores(models, prompts, chunks, stop=stop)
    for jo, to in zip(jouts, touts):
        np.testing.assert_array_equal(to[0], jo[0])
    if stop:
        lane0 = touts[1][0][:, 0]
        assert lane0[3] == stop[0] and (lane0[4:] == PAD).all()
        assert (touts[1][0][:, 1] != PAD).all()
    decode = {k for k in tc.graphs.keys if k[0] == "decode"}
    assert len(decode) == len({k[1] for k in decode})


def test_decode_step_logprobs_match_jax():
    """Logprobs on dense f32 weights (test_logprobs_match_jax's case):
    chosen and top-k values within 1e-4, the same top ids."""
    jouts, touts, _ = _run_cores(_models("dense"), (PROMPTS[0],), [(8, 32), (4, 32)],
                                 logprobs=True)
    for jo, to in zip(jouts, touts):
        np.testing.assert_array_equal(to[0], jo[0])
        np.testing.assert_allclose(to[1], jo[1], rtol=0, atol=1e-4)
        np.testing.assert_allclose(to[2], jo[2], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(to[3], jo[3])


class _Replaying(StepGraphs):
    """Replays as the card does: the first function run under a key is the
    one every later call of the key runs, as a graph's kernels read the
    buffers they were captured over."""

    def __init__(self, *args):
        super().__init__(*args)
        self._first = {}

    def __call__(self, key, fn, samples=False):
        return super().__call__(key, self._first.setdefault(key, fn), samples)


def test_decode_graph_key_fixes_its_buffers(models):
    """With use_bias False, chunks of one stop width and two bias widths run
    under two keys, so the second chunk never replays a step captured over
    the first chunk's input buffers: a stop token that only the second chunk
    carries ends its lane there, as when every step runs anew."""
    _, _, tm, tp = models
    ids = np.zeros((1, 32), np.int32)
    ids[0, :len(PROMPTS[0])] = PROMPTS[0]

    def run(graphs, stop2):
        tc = EngineCore(tm, tp, batch_size=1, max_seq_len=128, kv_dtype=torch.float32,
                        device="cpu")
        if graphs is not None:
            tc.graphs = graphs(tc.graphs.device, tc.graphs.generator)
        samp = SamplingParams.make(1, temperature=0.0, device="cpu")
        pen = PenaltyParams.make(1, device="cpu")
        bias = lambda w: (torch.full((1, w), PAD, dtype=torch.int32), torch.zeros((1, w)))
        st, _, _ = tc._prefill(tp, tc.new_state(0), torch.from_numpy(ids),
                               torch.tensor([len(PROMPTS[0])], dtype=torch.int32),
                               torch.zeros((1,), dtype=torch.int32), samp, pen, *bias(0),
                               sampler_kind="greedy")
        outs = []
        for width, stop in ((0, ()), (2, stop2)):
            stop_ids = torch.full((8,), PAD, dtype=torch.int32)
            stop_ids[:len(stop)] = torch.tensor(stop, dtype=torch.int32)
            st, o = tc._decode(tp, st, samp, pen, *bias(width), stop_ids, num_steps=6,
                               sampler_kind="greedy", kv_bucket=64, use_penalties=False,
                               use_bias=False)
            outs.append(o[0][:, 0].tolist())
        return outs, tc.graphs.keys

    free, _ = run(None, ())
    want, _ = run(None, (free[1][2],))
    got, keys = run(_Replaying, (free[1][2],))
    assert want[1][2] == free[1][2] and want[1][-1] == PAD
    assert got == want and len([k for k in keys if k[0] == "decode"]) == 2


# -- the paged rider-free and mixed steps ----------------------------------------------


def _schedulers(models, **kw):
    jm, jp, tm, tp = models
    geo = dict(num_lanes=4, num_pages=32, max_pages_per_seq=8, prefill_chunk=16,
               rider_width=8)
    j = JScheduler(JPagedEngine(jm, jp, kv_dtype=jnp.float32, **geo), **kw)
    t = Scheduler(PagedEngine(tm, tp, kv_dtype=torch.float32, device="cpu", **geo), **kw)
    return j, t


@pytest.mark.parametrize("case", ["rider_and_wake", "stop_mid_chunk", "pipelined"])
def test_paged_steps_match_jax_chunk(models, case):
    """Greedy streams of the port's Scheduler, whose chunks run the
    rider-free and mixed steps, equal the JAX Scheduler's: prompts that
    ride mixed steps and wake their lane in the middle of a chunk; a stop
    token in the middle of a chunk; steady chunks at pipeline depth 2,
    whose tokens are read after the next chunk is queued."""
    j, t = _schedulers(models, decode_steps=4)
    kw = [dict(max_new_tokens=10, temperature=0.0) for _ in PROMPTS]
    if case == "stop_mid_chunk":
        free, _ = _schedulers(models, decode_steps=4)
        probe = free.add_request(PROMPTS[0], max_new_tokens=10, temperature=0.0)
        free.run_to_completion(max_steps=200)
        kw[0]["stop_token_ids"] = (probe.output_ids[5],)
    if case == "pipelined":
        t.pipeline_depth = 2
        kw = [dict(max_new_tokens=20, temperature=0.0) for _ in PROMPTS]
    jseqs = [j.add_request(p, **k) for p, k in zip(PROMPTS, kw)]
    tseqs = [t.add_request(p, **k) for p, k in zip(PROMPTS, kw)]
    depths = []
    while t.has_work:
        t.step()
        depths.append(len(t._inflight))
    j.run_to_completion(max_steps=400)
    for js, ts in zip(jseqs, tseqs):
        assert ts.status == SeqStatus.COMPLETED
        assert (ts.output_ids, ts.finish_reason) == (js.output_ids, js.finish_reason)
    keys = {k[0] for k in t.engine.graphs.keys}
    assert keys == {"decode", "mixed"}
    if case == "stop_mid_chunk":
        assert tseqs[0].finish_reason == "stop" and len(tseqs[0].output_ids) == 6
    if case == "pipelined":
        assert max(depths) == 1  # a chunk in flight between steps


# -- masked steps: a chunk with a constrained lane --------------------------------------

SCHEMA = {
    "type": "object",
    "properties": {"name": {"enum": ["alpha", "beta"]}, "count": {"type": "integer"}},
    "required": ["name", "count"],
    "additionalProperties": False,
}


@pytest.mark.parametrize("decode_steps", [4, 8])
def test_masked_steps_match_jax_chunk(models, decode_steps):
    """Chunks that carry a constrained lane run the masked steps (use_mask
    in the key), rider-free and mixed: a json_schema lane decoding beside
    prompts that ride mixed steps, greedy, gives the JAX Scheduler's tokens
    and finish reasons on every lane, with no host read inside any step.
    The lane's masked greedy choices have top-2 logprob margins of 7.5 and
    more on this model (the JAX single-stream engine's logprobs), far
    above the packages' INT4 logit noise."""
    from pie_tpu.structured.json_machine import JsonMachine as JJson
    from pie_tpu.structured.token_masks import TokenMasker as JMasker
    from pie_tpu_torch.structured.json_machine import JsonMachine
    from pie_tpu_torch.structured.token_masks import TokenMasker

    from test_torch_constrained_engine import _jax_tokenizer, port_tokenizer

    j, t = _schedulers(models, decode_steps=decode_steps)
    t.engine.graphs = _Strict(t.engine.graphs.device, t.engine.key)
    jtok, ttok = _jax_tokenizer(), port_tokenizer()
    kw = dict(max_new_tokens=24, temperature=0.0, stop_token_ids=tuple(ttok.stop_tokens))
    jseqs = [j.add_request([1, 2, 3], machine=JJson(SCHEMA), masker=JMasker(jtok), **kw)]
    tseqs = [t.add_request([1, 2, 3], machine=JsonMachine(SCHEMA),
                           masker=TokenMasker(ttok), **kw)]
    for p in PROMPTS:
        jseqs.append(j.add_request(p, max_new_tokens=12, temperature=0.0))
        tseqs.append(t.add_request(p, max_new_tokens=12, temperature=0.0))
    t.run_to_completion(max_steps=400)
    j.run_to_completion(max_steps=400)
    for js, ts in zip(jseqs, tseqs):
        assert (ts.output_ids, ts.finish_reason) == (js.output_ids, js.finish_reason)
    assert len(tseqs[0].output_ids) > 4
    keys = {(k[0], k[4]) for k in t.engine.graphs.keys}
    assert {("decode", True), ("mixed", True)} <= keys


# -- no host read inside a step ------------------------------------------------------

_HOST_READS = ("__bool__", "__int__", "__index__", "__float__", "item", "tolist",
               "cpu", "numpy")


@contextlib.contextmanager
def _no_host_reads():
    saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"Tensor.{name} inside a step")
        return read

    try:
        for name in _HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


class _Strict(StepGraphs):
    """Runs each step with every host read of a tensor refused."""

    def __call__(self, key, fn, samples=False):
        def strict():
            with _no_host_reads():
                return fn()
        return super().__call__(key, strict, samples)


def test_steps_read_nothing_back(models):
    """Tensor.__bool__ / __int__ / __index__ / __float__ / item / tolist /
    cpu / numpy raise while any step runs: the single-stream step (greedy,
    and categorical with penalties, bias and logprobs on) and the paged
    steps (riders, wakes, a stop token, filtered sampling with penalties
    and bias, the INT8 pool) run to completion all the same."""
    _, _, tm, tp = models
    eng = InferenceEngine(model=tm, params=tp, max_seq_len=128, kv_dtype=torch.float32,
                          decode_chunk=8, prompt_cache=False, device="cpu")
    eng.core.graphs = _Strict(eng.core.graphs.device, eng.core.graphs.generator)
    assert len(eng.generate(PROMPTS[0], max_completion_tokens=12,
                            temperature=0.0).token_ids) == 12
    got = eng.generate(PROMPTS[1], max_completion_tokens=12, temperature=0.8,
                       repetition_penalty=1.3, logit_bias={7: 2.0}, logprobs=True)
    assert len(got.token_ids) == 12 and len(got.logprobs) == 12
    quant = InferenceEngine(model=tm, params=tp, max_seq_len=128, decode_chunk=8,
                            prompt_cache=False, kv_quantized=True, device="cpu")
    quant.core.graphs = _Strict(quant.core.graphs.device, quant.core.graphs.generator)
    assert len(quant.generate(PROMPTS[0], max_completion_tokens=10,
                              temperature=0.0).token_ids) == 10
    for quantized in (False, True):
        sched = Scheduler(PagedEngine(tm, tp, num_lanes=4, num_pages=32,
                                      max_pages_per_seq=8, prefill_chunk=16,
                                      rider_width=8, kv_quantized=quantized,
                                      kv_dtype=torch.float32, device="cpu"),
                          decode_steps=4)
        sched.engine.graphs = _Strict(sched.engine.graphs.device, sched.engine.key)
        seqs = [sched.add_request(PROMPTS[0], max_new_tokens=10, temperature=0.0,
                                  stop_token_ids=(3,)),
                sched.add_request(PROMPTS[1], max_new_tokens=10, temperature=0.7,
                                  top_p=0.9, presence_penalty=0.5, logit_bias={4: 1.0}),
                sched.add_request(PROMPTS[3], max_new_tokens=10, temperature=0.0)]
        sched.run_to_completion(max_steps=400)
        assert all(s.status == SeqStatus.COMPLETED for s in seqs)
        assert {k[0] for k in sched.engine.graphs.keys} == {"decode", "mixed"}


# -- bounded graph keys ------------------------------------------------------------------


def test_graph_keys_stay_bounded(models):
    """Over a long mixed run (requests of every sampler kind, with and
    without penalties and bias, riders and steady decode, contexts that
    cross KV buckets, prompts of every bucket up to 512 tokens, direct
    prefills) each engine holds at most one decode key per (step, bucket,
    sampler kind, logprobs, penalties, bias) and one prefill key per
    (prompt bucket, sampler kind, logprobs, bias width, mask), and no more
    than those settings make: the paged direct prefill one per chunk
    bucket."""
    _, _, tm, tp = models
    rng = np.random.default_rng(0)
    settings = [dict(temperature=0.0), dict(temperature=0.9),
                dict(temperature=0.9, top_k=5),
                dict(temperature=0.0, repetition_penalty=1.2),
                dict(temperature=0.0, logit_bias={9: 0.5})]
    eng = InferenceEngine(model=tm, params=tp, max_seq_len=512, kv_dtype=torch.float32,
                          decode_chunk=8, prompt_cache=False, device="cpu")
    for i in range(12):
        plen = int(rng.integers(4, 300))
        eng.generate(rng.integers(0, 512, plen).tolist(), max_completion_tokens=9,
                     logprobs=bool(i % 2), **settings[i % len(settings)])
    keys = eng.core.graphs.keys
    assert {k[0] for k in keys} == {"decode", "prefill"}
    decode = {k for k in keys if k[0] == "decode"}
    project = {(k[1], k[2], k[3], k[4], k[5]) for k in decode}
    assert len(decode) == len(project) <= 3 * 3 * 2 * 2 * 2  # buckets 256 / 512
    assert {k[1] for k in decode} == {256, 512}
    prefill = keys - decode
    project = {(k[1], k[2], k[3], k[4], k[5]) for k in prefill}
    # prompt buckets 16-512, 3 sampler kinds, logprobs, bias widths 0 / 8, no mask
    assert len(prefill) == len(project) <= 6 * 3 * 2 * 2
    assert {k[1] for k in prefill} <= {16, 32, 64, 128, 256, 512}
    assert {k[4] for k in prefill} == {0, 8} and not any(k[5] for k in prefill)

    sched = Scheduler(PagedEngine(tm, tp, num_lanes=4, num_pages=64, max_pages_per_seq=8,
                                  prefill_chunk=16, rider_width=8,
                                  kv_dtype=torch.float32, device="cpu"),
                      decode_steps=4)
    for i in range(24):
        plen = int(rng.integers(1, 60))
        sched.add_request(rng.integers(0, 512, plen).tolist(),
                          max_new_tokens=int(rng.integers(2, 12)),
                          **settings[i % len(settings)])
        if i % 3 == 2:
            for _ in range(3):
                sched.step()
    sched.run_to_completion(max_steps=2000)
    keys = sched.engine.graphs.keys
    assert {k[0] for k in keys} == {"decode", "mixed", "prefill"}
    steps = {k for k in keys if k[0] != "prefill"}
    project = {k[:4] for k in steps}
    assert len(steps) == len(project) <= 2 * 3 * 2 * 2
    assert keys - steps == {("prefill", 16, id(tp))}  # prefill_chunk 16
