"""The port's Gemma-3 text decoder (pie_tpu_torch.models.gemma3) on the CPU:
the text cases of tests/test_gemma3_parity.py and tests/test_gemma3_dual.py
(HF logits parity, incremental equal to full, the bounded dual cache equal
to the legacy full-length cache past the window, the sliding store bounded
by the window, INT8 dual cache close to f32, the engine's chunked prefill),
and the port against the JAX package on the same weights: the logits of
``__call__``, ``_dual_forward``, ``paged_forward`` and ``mixed_forward`` in
bf16 and with INT4 g64 weights, with the JAX decode lanes through its
Pallas kernel in interpret mode; and the greedy streams of the single-stream
and batched engines against the JAX engines', past the window, with
prompts longer than ``prefill_chunk_bound``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("transformers.models.gemma3")

import pie_tpu.models.gemma3 as jg3
import pie_tpu.ops.paged_attention as jpa
from pie_tpu.cache import paged as jpaged
from pie_tpu.cache.kv_cache import KVCache as JKVCache
from pie_tpu_torch.cache import paged as tpaged
from pie_tpu_torch.cache.kv_cache import (
    DualKVCache,
    QuantizedKVCache,
    make_kv_cache,
)
from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
from pie_tpu_torch.models.llama import from_jax_params

from test_torch_llama import jax_to_np

# tests/test_gemma3_parity.py's TINY: 6 sliding layers and 1 global
TINY = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=7,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=256,
    rms_norm_eps=1e-6, rope_theta=1000000.0, rope_local_base_freq=10000.0,
    sliding_window=8, sliding_window_pattern=6, query_pre_attn_scalar=16,
    max_position_embeddings=128,
)
# two layers, one sliding and one global, linear rope scaling on the global
PAIR = dict(TINY, num_hidden_layers=2, sliding_window_pattern=2,
            rope_scaling={"rope_type": "linear", "factor": 8.0})
MAX_LEN = 48  # 6x the window: the rotating store wraps many times


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _model(cfg=TINY):
    return Gemma3Model(Gemma3Config.from_dict(dict(cfg, model_type="gemma3_text")))


@pytest.fixture(scope="module")
def hf_setup():
    torch.manual_seed(0)
    hf = transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(**TINY))
    hf.eval()
    model = _model()
    params = model.from_hf_state_dict(
        {k: v.detach() for k, v in hf.state_dict().items()}, dtype=torch.float32)
    return hf, model, params


def _forward(model, params, ids, cache, first):
    b, t = ids.shape
    first = torch.full((b,), first, dtype=torch.int32)
    pos = first[:, None] + torch.arange(t, dtype=torch.int32)[None, :]
    cache = cache.advance(first, t)
    with torch.no_grad():
        return model(params, torch.as_tensor(ids), cache, pos)


def _legacy(model, b=1, dtype=torch.float32):
    cfg = model.config
    return make_kv_cache(cfg.num_hidden_layers, b, MAX_LEN, cfg.num_key_value_heads,
                         cfg.head_dim, dtype, device="cpu")


def test_logits_match_hf(hf_setup):
    """12 tokens, past the sliding window of 8."""
    hf, model, params = hf_setup
    ids = np.random.default_rng(0).integers(0, 256, (2, 12))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
    got, _ = _forward(model, params, ids, _legacy(model, 2), 0)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)


def test_incremental_matches_full(hf_setup):
    _, model, params = hf_setup
    ids = np.random.default_rng(1).integers(0, 256, (1, 14))
    full, _ = _forward(model, params, ids, _legacy(model), 0)
    cache = _legacy(model)
    part, cache = _forward(model, params, ids[:, :6], cache, 0)
    np.testing.assert_allclose(part.numpy(), full[:, :6].numpy(), atol=3e-4, rtol=3e-4)
    for i in range(6, 14):
        step, cache = _forward(model, params, ids[:, i:i + 1], cache, i)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(),
                                   atol=3e-4, rtol=3e-4)


@pytest.fixture(scope="module")
def dual_setup():
    model = _model()
    return model, model.init_params(seed=7, dtype=torch.float32, device="cpu")


def _run(model, params, cache, prompt, steps):
    """Prefill ``prompt`` (in window-sized chunks for a dual cache), then
    greedy-decode ``steps`` tokens; every row of logits that chose one."""
    ids = np.asarray(prompt, np.int64)[None]
    bound = (model.config.sliding_window if isinstance(cache, DualKVCache)
             else ids.shape[1])
    off = 0
    while off < ids.shape[1]:
        logits, cache = _forward(model, params, ids[:, off:off + bound], cache, off)
        off += bound
    outs = [logits[:, -1]]
    for pos in range(ids.shape[1], ids.shape[1] + steps):
        tok = outs[-1].argmax(-1)[:, None]
        logits, cache = _forward(model, params, tok, cache, pos)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1).numpy()


def test_dual_matches_legacy_past_window(dual_setup):
    """Decoding far past the window: the bounded dual cache equals the
    legacy full-length cache, which masks instead of evicting."""
    model, params = dual_setup
    prompt = list(range(1, 13))  # longer than the window: chunked prefill
    legacy = _run(model, params, _legacy(model), prompt, 24)
    dual = _run(model, params, model.make_cache(1, MAX_LEN, torch.float32, device="cpu"),
                prompt, 24)
    np.testing.assert_allclose(legacy, dual, rtol=2e-4, atol=2e-4)


def test_sliding_store_is_window_bounded(dual_setup):
    model, _ = dual_setup
    cache = model.make_cache(1, MAX_LEN, torch.float32, device="cpu")
    ns = int(model.is_sliding.sum())
    assert tuple(cache.sliding.k.shape) == (ns, 1, 8, 2, 16)
    assert tuple(cache.full.k.shape) == (7 - ns, 1, MAX_LEN, 2, 16)
    assert cache.sliding.window == 8 and cache.full.window is None


def test_dual_quantized_close_to_f32(dual_setup):
    """The INT8 dual cache attends on its int8 store and stays close to the
    f32 cache (the JAX test's gates)."""
    model, params = dual_setup
    prompt = list(range(1, 10))
    ref = _run(model, params, model.make_cache(1, MAX_LEN, torch.float32, device="cpu"),
               prompt, 8)
    qc = model.make_cache(1, MAX_LEN, quantized=True, device="cpu")
    assert isinstance(qc.sliding, QuantizedKVCache)
    q = _run(model, params, qc, prompt, 8)
    assert np.max(np.abs(ref - q)) < 0.35
    assert np.mean(np.abs(ref - q)) < 0.05


def test_dual_forward_refuses_an_aliasing_chunk(dual_setup):
    model, params = dual_setup
    cache = model.make_cache(1, MAX_LEN, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk_bound"):
        _forward(model, params, np.arange(9)[None], cache, 0)


def test_gemma_entry_points_default_to_cuda(dual_setup):
    """Gemma-3's random initializers and the engines over it ask for CUDA
    without a device argument, and raise where there is none; its cache
    takes no default device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.scheduler import PagedEngine

    model, params = dual_setup
    for init in (model.init_params, model.init_quantized_params):
        with pytest.raises(RuntimeError, match="CUDA"):
            init()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model=model, params=params)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(model, params, num_pages=4)
    with pytest.raises(TypeError):
        model.make_cache(1, 16)


def test_engine_chunked_prefill_gemma3(dual_setup):
    """The engine splits a prompt longer than the window into head chunks
    over its DualKVCache and matches the legacy single-shot stream; the
    prompt cache saves and restores both groups."""
    from pie_tpu_torch.engine import InferenceEngine

    model, params = dual_setup
    engine = InferenceEngine(model=model, params=params, max_seq_len=MAX_LEN,
                             kv_dtype=torch.float32, decode_chunk=4,
                             prompt_cache=False, device="cpu")
    assert isinstance(engine.state.cache, DualKVCache)
    prompt = list(range(1, 21))  # more than twice the window
    res = engine.generate(prompt, max_completion_tokens=10, temperature=0.0)
    want = np.argmax(_run(model, params, _legacy(model), prompt, 9), -1)[0].tolist()
    assert res.token_ids == want


def test_prompt_cache_restores_both_groups(dual_setup, tmp_path):
    """A prompt cached to disk by one engine and loaded by a fresh one
    decodes the same tokens as the fresh engine prefilling it."""
    from pie_tpu_torch.engine import InferenceEngine

    model, params = dual_setup
    kw = dict(model=model, params=params, max_seq_len=MAX_LEN, kv_dtype=torch.float32,
              decode_chunk=4, device="cpu")
    prompt = list(range(3, 23))
    first = InferenceEngine(prompt_cache_dir=tmp_path, **kw)
    path = first.cache_prompt(prompt)
    assert path is not None and path.exists()
    fresh = InferenceEngine(prompt_cache=False, **kw)
    want = fresh.generate(prompt, max_completion_tokens=8, temperature=0.0).token_ids
    loaded = InferenceEngine(prompt_cache_dir=tmp_path, **kw)
    got = loaded.generate(prompt, max_completion_tokens=8, temperature=0.0).token_ids
    assert got == want
    assert loaded.prompt_cache.computed_ids[:len(prompt)] == prompt


def test_prompt_cache_reuse_past_the_window():
    """A prompt that shares a prefix with a cached sequence written past
    the window and past that prefix: the rotating store has evicted tokens
    the prefix's next query needs, so the port prefills from the start and
    decodes a fresh engine's tokens. The JAX engine reuses the prefix all
    the same and decodes other logprobs (ROADMAP C)."""
    from pie_tpu.engine import InferenceEngine as JEngine
    from pie_tpu_torch.engine import InferenceEngine

    jm = jg3.Gemma3Model(jg3.Gemma3Config.from_dict(dict(TINY, model_type="gemma3_text")))
    jp = jm.init_params(jax.random.PRNGKey(7), dtype=jnp.float32)
    jp["embed"] = jp["embed"] * 3
    tp = from_jax_params(jax_to_np(jp), "cpu")
    kw = dict(max_seq_len=64, decode_chunk=4)
    first = list(range(1, 13))
    runs = {}
    for name, make in (
            ("port", lambda cache: InferenceEngine(
                model=_model(), params=tp, kv_dtype=torch.float32, device="cpu",
                prompt_cache=cache, **kw)),
            ("jax", lambda cache: JEngine(model=jm, params=jp, kv_dtype=jnp.float32,
                                          prompt_cache=cache, **kw))):
        cached = make(True)
        out = cached.generate(first, max_completion_tokens=12, temperature=0.0)
        second = (first + out.token_ids)[:14] + [200, 201, 202]  # 14 < 24 written
        gen = lambda e: e.generate(second, max_completion_tokens=6, temperature=0.0,
                                   logprobs=True)
        runs[name] = (gen(cached), gen(make(False)))
    got, fresh = runs["port"]
    assert got.token_ids == fresh.token_ids
    assert [a.logprob for a in got.logprobs] == [a.logprob for a in fresh.logprobs]
    jgot, jfresh = runs["jax"]
    assert jfresh.token_ids == fresh.token_ids
    assert max(abs(a.logprob - b.logprob)
               for a, b in zip(jgot.logprobs, jfresh.logprobs)) > 0.01


# -- the port against the JAX package on the same weights ----------------------

WEIGHTS = ("bf16", "int4_g64")
# bf16 weights keep activations in bf16, and INT4 weights round each matmul
# input to bf16, at the JAX cast points in both packages: values an f32 ulp
# apart may round to neighbouring bf16 values (tests/test_torch_llama.py
# states and witnesses this), so these cases are held to its 1e-2.
TOL = 1e-2


def build_pair(cfg, weights, seed=3):
    """(JAX model, JAX params, port model, port params): JAX's init, bf16 or
    f32 then JAX's INT4 g64 quantizer, carried across by from_jax_params."""
    jm = jg3.Gemma3Model(jg3.Gemma3Config.from_dict(dict(cfg, model_type="gemma3_text")))
    dtype = jnp.bfloat16 if weights == "bf16" else jnp.float32
    jp = jm.init_params(jax.random.PRNGKey(seed), dtype=dtype)
    # norms away from zero and a larger embedding: every path matters
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2", "ln3", "ln4", "q_norm", "k_norm"):
        jp["layers"][k] = jnp.asarray(
            rng.normal(0, 0.3, jp["layers"][k].shape), dtype)
    jp["embed"] = jp["embed"] * 10
    if weights == "int4_g64":
        jp = jm.quantize_params(jp, group_size=64, bits=4)
    return jm, jp, _model(cfg), from_jax_params(jax_to_np(jp), "cpu")


@pytest.fixture
def jax_pallas_decode(monkeypatch):
    """The JAX Gemma-3 paged forwards as on the TPU: their decode lanes run
    the Pallas decode kernel, here in interpret mode. Returns the count of
    its calls."""
    calls = []
    kernel = jpa.paged_attention_decode

    def interpreted(*args, **kw):
        calls.append(1)
        return kernel(*args, interpret=True, **kw)

    class TpuJax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def default_backend():
            return "tpu"

    monkeypatch.setattr(jg3, "jax", TpuJax())
    monkeypatch.setattr(jpa, "paged_attention_decode", interpreted)
    return calls


@pytest.mark.parametrize("weights", WEIGHTS)
def test_call_matches_jax(weights):
    """``__call__`` over a contiguous cache: a 12-token prefill (past the
    window), then three decode steps."""
    jm, jp, tm, tp = build_pair(PAIR, weights)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if weights == "bf16"
                else (jnp.float32, torch.float32))
    jc = JKVCache.create(2, 1, 32, 2, 16, jdt)
    tc = make_kv_cache(2, 1, 32, 2, 16, tdt, device="cpu")
    ids = np.random.default_rng(0).integers(0, 256, (1, 15)).astype(np.int32)
    for first, t in ((0, 12), (12, 1), (13, 1), (14, 1)):
        chunk = ids[:, first:first + t]
        f = jnp.full((1,), first, jnp.int32)
        jc = jc.advance(f, t)
        lj, jc = jm(jp, jnp.asarray(chunk), jc, f[:, None] + jnp.arange(t)[None])
        lt, tc = _forward(tm, tp, chunk.astype(np.int64), tc, first)
        assert _norm_err(lt.numpy(), np.asarray(lj)) < TOL, first


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_dual_forward_matches_jax(weights, quantized):
    """``_dual_forward`` over the bounded cache (bf16 / f32 or INT8): an
    8-token chunk, a 6-token chunk padded to 8 (valid_lens), then decode
    steps until positions pass twice the window."""
    jm, jp, tm, tp = build_pair(PAIR, weights)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if weights == "bf16"
                else (jnp.float32, torch.float32))
    jc = jm.make_cache(1, 32, dtype=jdt, quantized=quantized)
    tc = tm.make_cache(1, 32, tdt, quantized=quantized, device="cpu")
    ids = np.random.default_rng(1).integers(0, 256, 24).astype(np.int32)
    chunks = [(0, 8, 8), (8, 8, 6)] + [(p, 1, 1) for p in range(14, 24)]
    for first, t, n in chunks:
        chunk = np.zeros((1, t), np.int32)
        chunk[0, :n] = ids[first:first + n]
        f = jnp.full((1,), first, jnp.int32)
        vl = jnp.full((1,), n, jnp.int32)
        jc = jc.advance(f, t, valid_lens=vl)
        lj, jc = jm(jp, jnp.asarray(chunk), jc, f[:, None] + jnp.arange(t)[None],
                    valid_lens=vl)
        tf = torch.full((1,), first, dtype=torch.int32)
        tvl = torch.full((1,), n, dtype=torch.int32)
        tc = tc.advance(tf, t, valid_lens=tvl)
        with torch.no_grad():
            lt, tc = tm(tp, torch.from_numpy(chunk).long(), tc,
                        tf[:, None] + torch.arange(t, dtype=torch.int32)[None],
                        valid_lens=tvl)
        assert _norm_err(lt[0, :n].numpy(), np.asarray(lj)[0, :n]) < TOL, first
    assert np.array_equal(tc.sliding.slot_positions.numpy(),
                          np.asarray(jc.sliding.slot_positions))


PAGES, MAXP = 16, 3
PROMPTS = np.random.default_rng(0).integers(0, 256, (3, 40)).astype(np.int32)
LENS = (40, 20, 33)  # each past the window of 8


class PagedPair:
    """The JAX and port Gemma-3 models on the same weights, with pools of
    both, fed the same numpy inputs."""

    def __init__(self, weights, quantized):
        self.jm, self.jp, self.tm, self.tp = build_pair(PAIR, weights)
        self.jpool = jpaged.PagedKVPool.create(2, PAGES, 2, 16, jnp.bfloat16, quantized)
        self.tpool = tpaged.PagedKVPool.create(2, PAGES, 2, 16, torch.bfloat16,
                                               quantized, device="cpu")
        self.tables = np.array([[3, 7, -1], [12, 0, 5], [9, -1, -1]], np.int32)

    def paged(self, ids, pos, ctx, rows=None):
        bt = self.tables[list(range(3)) if rows is None else rows]
        lj, self.jpool = self.jm.paged_forward(
            self.jp, jnp.asarray(ids), self.jpool, jnp.asarray(bt), jnp.asarray(pos),
            jnp.asarray(ctx))
        with torch.no_grad():
            lt, _ = self.tm.paged_forward(
                self.tp, torch.from_numpy(ids), self.tpool, torch.from_numpy(bt),
                torch.from_numpy(pos), torch.from_numpy(ctx))
        return np.asarray(lj), lt.numpy()

    def mixed(self, dec_tok, dec_pos, dec_ctx, pf_ids, pf_pos, pf_lane, pf_ctx):
        a = lambda x: np.asarray(x, np.int32)
        lj, self.jpool = self.jm.mixed_forward(
            self.jp, self.jpool, jnp.asarray(a(dec_tok)), jnp.asarray(a(dec_pos)),
            jnp.asarray(a(dec_ctx)), jnp.asarray(self.tables), jnp.asarray(a(pf_ids)),
            jnp.asarray(a(pf_pos)), jnp.int32(pf_lane), jnp.int32(pf_ctx))
        t = lambda x: torch.from_numpy(a(x))
        with torch.no_grad():
            lt, _ = self.tm.mixed_forward(
                self.tp, self.tpool, t(dec_tok), t(dec_pos), t(dec_ctx),
                torch.from_numpy(self.tables), t(pf_ids), t(pf_pos), t([pf_lane]),
                t([pf_ctx]), pf_any=bool((a(pf_ids) >= 0).any()))
        return np.asarray(lj), lt.numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_paged_forward_matches_jax(jax_pallas_decode, weights, quantized):
    """A padded prefill chunk of three lanes past the window, then three
    decode steps (the JAX lanes through its Pallas kernel, windowed on the
    sliding layer), the second with lane 1 frozen."""
    pr = PagedPair(weights, quantized)
    pos = np.where(np.arange(40)[None] < np.array(LENS)[:, None],
                   np.arange(40)[None], -1).astype(np.int32)
    ids = np.where(pos >= 0, PROMPTS, 0).astype(np.int32)
    lj, lt = pr.paged(ids, pos, np.array(LENS, np.int32))
    assert _norm_err(lt[pos >= 0], lj[pos >= 0]) < TOL
    ctx = np.array(LENS, np.int32)
    tok = ids[np.arange(3), ctx - 1]
    for step in range(3):
        frozen = np.array([False, step == 1, False])
        dpos = np.where(frozen, -1, ctx).astype(np.int32)
        dctx = np.where(frozen, 1, ctx + 1).astype(np.int32)
        lj, lt = pr.paged(tok[:, None], dpos[:, None], dctx)
        assert _norm_err(lt[~frozen], lj[~frozen]) < TOL, step
        tok = lj[:, 0].argmax(-1).astype(np.int32)
        ctx = np.where(frozen, ctx, ctx + 1).astype(np.int32)
    # every JAX decode step traced its Pallas kernel (once, in its layer scan)
    assert len(jax_pallas_decode) == 3


@pytest.mark.parametrize("weights", WEIGHTS)
def test_mixed_forward_matches_jax(jax_pallas_decode, weights):
    """Lanes 0 and 1 prefilled past the window, lane 2's prompt arriving as
    a rider while it is frozen, then an empty rider."""
    pr = PagedPair(weights, True)
    pos = np.where(np.arange(40)[None] < np.array([40, 20])[:, None],
                   np.arange(40)[None], -1).astype(np.int32)
    ids = np.where(pos >= 0, PROMPTS[:2], 0).astype(np.int32)
    pr.paged(ids, pos, np.array([40, 20], np.int32), rows=[0, 1])
    cs = 24
    rider = np.full(cs, -1, np.int32)
    rider_pos = np.full(cs, -1, np.int32)
    rider[:20] = PROMPTS[2, :20]
    rider_pos[:20] = np.arange(20)
    steps = [
        ([PROMPTS[0, 39], PROMPTS[1, 19], 0], [39, 19, -1], [40, 20, 1],
         rider, rider_pos, 2, 20),
        ([11, 12, PROMPTS[2, 20]], [40, 20, 20], [41, 21, 21],
         np.full(cs, -1), np.full(cs, -1), 0, 0),
    ]
    for i, step in enumerate(steps):
        lj, lt = pr.mixed(*step)
        live = np.asarray(step[1]) >= 0
        assert _norm_err(lt[live], lj[live]) < TOL, i
    assert len(jax_pallas_decode) == 2


# -- engines: greedy streams against the JAX engines ---------------------------


@pytest.fixture(scope="module")
def engine_pair():
    """JAX and port single-stream and batched engines on the same f32
    weights of the 7-layer TINY geometry (window 8, bound 8)."""
    from pie_tpu.engine import InferenceEngine as JEngine
    from pie_tpu.engine.async_engine import BatchedInferenceEngine as JBatched
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine

    jm = jg3.Gemma3Model(jg3.Gemma3Config.from_dict(dict(TINY, model_type="gemma3_text")))
    jp = jm.init_params(jax.random.PRNGKey(7), dtype=jnp.float32)
    jp["embed"] = jp["embed"] * 50  # decisive greedy choices
    tm, tp = _model(), from_jax_params(jax_to_np(jp), "cpu")
    # 64: the JAX engine buckets a prompt before it splits it into chunks
    kw = dict(max_seq_len=64, decode_chunk=4, prompt_cache=False)
    bkw = dict(num_lanes=4, num_pages=32, max_pages_per_seq=8, prefill_chunk=16)
    engines = dict(
        jax=JEngine(model=jm, params=jp, kv_dtype=jnp.float32, **kw),
        port=InferenceEngine(model=tm, params=tp, kv_dtype=torch.float32,
                             device="cpu", **kw),
        jax_batched=JBatched(model=jm, params=jp, **bkw),
        port_batched=BatchedInferenceEngine(model=tm, params=tp, device="cpu", **bkw),
    )
    yield engines
    engines["jax_batched"].shutdown()
    engines["port_batched"].shutdown()


@pytest.mark.parametrize("plen", [14, 40])
def test_engine_streams_match_jax(engine_pair, plen):
    """Greedy streams past the window: 14 tokens (riders in the batched
    engine) and 40 (more than the prefill chunk bound of 8 in the single
    stream, a direct prefill in the batched engine); each port engine
    equals its JAX twin, and the batched ones equal the single streams."""
    prompt = list(np.random.default_rng(plen).integers(1, 256, plen))
    out = {name: e.generate(prompt, max_completion_tokens=12, temperature=0.0).token_ids
           for name, e in engine_pair.items()}
    assert len(out["jax"]) == 12, out
    assert out["port"] == out["jax"], out
    assert out["port_batched"] == out["jax_batched"] == out["jax"], out
