"""The port's single-stream engine (pie_tpu_torch.engine) against the JAX
package's InferenceEngine on the same tiny INT4 model: greedy token
streams, stop tokens, logit bias, penalties, prompt-cache prefix hits and
logprobs; and the port's sampler and logits processors against the JAX
ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.engine import InferenceEngine as JEngine
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.ops import sampling as js
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.ops import sampling as ts

from test_torch_llama import jax_to_np, small_config

PROMPT = np.random.default_rng(0).integers(0, 512, 10).tolist()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(weights: str):
    """A JAX engine and a port engine (CPU) on the same tiny weights.

    Embedding and head are at unit scale (50x the init's 0.02), which makes
    the greedy choices decisive: with INT4 weights the two engines' logits
    differ by a few 1e-3 of their range (bf16 casts of activations round
    differently once an f32 ulp differs), and test_greedy_stream_matches_jax
    checks that the JAX stream's top-2 margins stay far above that."""
    cfg = small_config(256, 4, 2)
    jm = JModel(JConfig.from_dict(cfg))
    jp = jm.init_params(jax.random.PRNGKey(3), dtype=jnp.float32)
    jp["embed"] = jp["embed"] * 50.0
    jp["lm_head"] = jp["lm_head"] * 50.0
    if weights == "int4":
        jp = jm.quantize_params(jp, group_size=64, bits=4)
    kw = dict(max_seq_len=128, decode_chunk=8)
    je = JEngine(model=jm, params=jp, kv_dtype=jnp.float32, **kw)
    te = InferenceEngine(model=LlamaModel(LlamaConfig.from_dict(cfg)),
                         params=from_jax_params(jax_to_np(jp), "cpu"),
                         kv_dtype=torch.float32, device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def engines():
    return _pair("int4")


def both(engines, prompt, **kw):
    je, te = engines
    kw.setdefault("temperature", 0.0)
    return je.generate(prompt, **kw), te.generate(prompt, **kw)


def test_greedy_stream_matches_jax(engines):
    j, t = both(engines, PROMPT, max_completion_tokens=24, logprobs=True)
    assert len(t.token_ids) == 24
    assert t.token_ids == j.token_ids
    assert (t.finish_reason, t.prompt_tokens) == (j.finish_reason, j.prompt_tokens)
    # decisive choices: every top-2 logprob margin is far above the ~0.03
    # the two engines' logprobs differ by on this model
    assert min(a.top[0][1] - a.top[1][1] for a in j.logprobs) > 0.1
    assert max(abs(a.logprob - b.logprob) for a, b in zip(t.logprobs, j.logprobs)) < 0.05


def test_streaming_yields_the_result(engines):
    _, te = engines
    gen = te.generate_stream(PROMPT, max_completion_tokens=6, temperature=0.0)
    toks = []
    try:
        while True:
            toks.append(next(gen).token_id)
    except StopIteration as e:
        result = e.value
    assert toks == result.token_ids and len(toks) == 6


def test_stop_token_matches_jax(engines):
    full = engines[1].generate(PROMPT, max_completion_tokens=16, temperature=0.0)
    j, t = both(engines, PROMPT, max_completion_tokens=16,
                stop_token_ids=[full.token_ids[3]])
    assert t.finish_reason == j.finish_reason == "stop"
    assert t.token_ids == j.token_ids == full.token_ids[:4]


def test_logit_bias_forces_token(engines):
    j, t = both(engines, PROMPT, max_completion_tokens=5, logit_bias={99: 1000.0})
    assert t.token_ids == j.token_ids == [99] * 5


def test_repetition_penalty_matches_jax(engines):
    j, t = both(engines, PROMPT, max_completion_tokens=8,
                logit_bias={99: 300.0}, repetition_penalty=1000.0)
    assert t.token_ids == j.token_ids
    assert t.token_ids[0] == 99 and t.token_ids != [99] * 8


def test_prompt_cache_prefix_hit_matches_jax(engines):
    """The second request shares the first one's prompt as a prefix, so
    only its suffix is prefilled; it must match JAX and a cold engine."""
    je, te = engines
    first, _ = both(engines, PROMPT, max_completion_tokens=6)
    longer = PROMPT + first.token_ids[:3] + [7, 11]
    j, t = both(engines, longer, max_completion_tokens=12)
    assert te.prompt_cache.reuse_prefix(longer) > 0
    assert t.token_ids == j.token_ids
    cold = InferenceEngine(model=te.model, params=te.params, max_seq_len=128,
                           decode_chunk=8, kv_dtype=torch.float32,
                           prompt_cache=False, device="cpu")
    assert cold.generate(longer, max_completion_tokens=12,
                         temperature=0.0).token_ids == t.token_ids


def test_disk_prompt_cache_restores_kv(engines, tmp_path):
    """cache_prompt persists the prompt's KV; a new engine on the same
    directory restores it, prefills one token, and decodes as a cold
    engine does."""
    te = engines[1]
    kw = dict(model=te.model, params=te.params, max_seq_len=128,
              decode_chunk=8, kv_dtype=torch.float32, device="cpu")
    path = InferenceEngine(prompt_cache_dir=tmp_path, **kw).cache_prompt(PROMPT)
    assert path.exists()
    warm = InferenceEngine(prompt_cache_dir=tmp_path, **kw)
    got = warm.generate(PROMPT, max_completion_tokens=8, temperature=0.0)
    cold = InferenceEngine(prompt_cache=False, **kw).generate(
        PROMPT, max_completion_tokens=8, temperature=0.0)
    assert got.token_ids == cold.token_ids


def test_kv_quantize_threshold_matches_jax():
    """Past the threshold both engines move the KV cache to INT8 and keep
    decoding the same greedy stream."""
    je, te = _pair("int4")
    je.kv_quantize_threshold = te.kv_quantize_threshold = 8
    for prompt in (PROMPT, PROMPT[:6] + [3, 1, 4, 1, 5]):
        j, t = both((je, te), prompt, max_completion_tokens=10)
        assert t.token_ids == j.token_ids
    assert type(te.state.cache).__name__ == "QuantizedKVCache"


def test_logprobs_match_jax():
    """Logprobs on dense f32 weights, where no bf16 cast separates the two
    engines: chosen and top-k values within 1e-4, same ids."""
    j, t = both(_pair("dense"), PROMPT, max_completion_tokens=5, logprobs=True)
    assert t.token_ids == j.token_ids
    for a, b in zip(t.logprobs, j.logprobs):
        assert a.token_id == b.token_id == a.top[0][0]
        assert abs(a.logprob - b.logprob) < 1e-4
        assert [i for i, _ in a.top] == [i for i, _ in b.top]
        np.testing.assert_allclose([v for _, v in a.top], [v for _, v in b.top],
                                   rtol=0, atol=1e-4)


def test_seeded_sampling_reproducible(engines):
    """new_state resets the KV cache, so the prompt cache goes with it: each
    run starts from an empty cache whatever ran on the engine before."""
    from pie_tpu_torch.cache.prompt_cache import PromptCache

    _, te = engines
    runs = []
    for _ in range(2):
        te.state = te.core.new_state(seed=0)
        te.prompt_cache = PromptCache()
        runs.append(te.generate(PROMPT, max_completion_tokens=8,
                                temperature=0.9).token_ids)
    assert runs[0] == runs[1]


# -- sampler and logits processors -------------------------------------------


def _proc_inputs():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    # histories with repeats and a looping n-gram (DRY fires), -1 padded
    hist = np.full((3, 16), -1, np.int32)
    hist[0] = rng.integers(0, 64, 16)
    hist[1, 4:] = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2]
    hist[2, 10:] = [7, 7, 7, 7, 9, 7]
    return logits, hist


@pytest.mark.parametrize("proc", ["repetition", "presence_frequency", "dry", "bias"])
def test_processors_match_jax(proc):
    logits, hist = _proc_inputs()
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jh, th = jnp.asarray(hist), torch.from_numpy(hist)
    a = lambda *v: (jnp.asarray(np.array(v)), torch.from_numpy(np.array(v)))
    if proc == "repetition":
        pj, pt = a(np.float32(1.5), np.float32(1.0), np.float32(3.0))
        want, got = js.repetition_penalty(jl, jh, pj), ts.repetition_penalty(tl, th, pt)
    elif proc == "presence_frequency":
        (pj, pt), (fj, ft) = a(*np.float32([0.5, 0.0, 1.0])), a(*np.float32([0.25, 1.0, 0.0]))
        want = js.presence_frequency_penalty(jl, jh, pj, fj)
        got = ts.presence_frequency_penalty(tl, th, pt, ft)
    elif proc == "dry":
        (mj, mt), (bj, bt) = a(*np.float32([0.8, 0.8, 0.0])), a(*np.float32([1.75] * 3))
        (lj, lt) = a(*np.int32([2, 2, 2]))
        want = js.dry_penalty(jl, jh, mj, bj, lj)
        got = ts.dry_penalty(tl, th, mt, bt, lt)
        assert (np.asarray(want) != logits).any()  # the penalty fired
    else:
        ids = np.array([[3, 9, -1], [0, -1, -1], [63, 3, 5]], np.int32)
        vals = np.array([[2.0, -1.0, 5.0], [1.5, 0.0, 0.0], [-3.0, 1.0, 0.5]], np.float32)
        want = js.apply_logit_bias(jl, jnp.asarray(ids), jnp.asarray(vals))
        got = ts.apply_logit_bias(tl, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _port_draws(logits, n, **params):
    """n draws of the port's filtered sampler (one batched call)."""
    lt = torch.from_numpy(np.repeat(logits, n, axis=0))
    p = ts.SamplingParams.make(n, **params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    return ts.sample(lt, p, gen, kind="filtered").numpy()


def _jax_draws(logits, n, **params):
    p = js.SamplingParams.make(1, **params)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return np.asarray(jax.vmap(lambda k: js.sample(jnp.asarray(logits), p, k,
                                                   kind="filtered"))(keys)).ravel()


@pytest.mark.parametrize("params", [
    dict(top_k=3), dict(top_p=0.75), dict(min_p=0.15),
    dict(top_k=4, top_p=0.9, min_p=0.05),
])
def test_filtered_sampling_distribution(params):
    """Draw frequencies match the filtered softmax (atol 0.05 over 2000
    draws, as the JAX package's own distribution test)."""
    logits = np.log(np.array([[0.4, 0.25, 0.15, 0.1, 0.06, 0.04]], np.float32))
    probs = np.exp(logits[0]) / np.exp(logits[0]).sum()
    keep = np.ones(6, bool)
    keep &= np.arange(6) < params.get("top_k", 6)
    keep &= (np.cumsum(probs) - probs) < params.get("top_p", 1.0)
    keep &= (probs >= probs[0] * params.get("min_p", 0.0)) | (np.arange(6) == 0)
    want = np.where(keep, probs, 0) / probs[keep].sum()
    draws = _port_draws(logits, 2000, temperature=1.0, **params)
    np.testing.assert_allclose(np.bincount(draws, minlength=6) / 2000, want, atol=0.05)


def test_xtc_filter_matches_jax():
    """XTC at probability 1: both samplers drop every token above the
    threshold except the least probable of them, with the same frequencies."""
    logits = np.log(np.array([[0.4, 0.3, 0.15, 0.1, 0.05]], np.float32))
    params = dict(temperature=1.0, xtc_probability=1.0, xtc_threshold=0.12)
    got = np.bincount(_port_draws(logits, 2000, **params), minlength=5) / 2000
    want = np.bincount(_jax_draws(logits, 2000, **params), minlength=5) / 2000
    assert got[0] == got[1] == want[0] == want[1] == 0.0
    np.testing.assert_allclose(got, want, atol=0.05)
