"""The port's tensor and data parallelism on the CPU: ranks of a ("dp",
"tp") mesh as spawned processes over gloo (tests/torch_dist_workers.py),
each running its shard, against the JAX package's UNSHARDED runs on the
same weights (mirrors tests/test_sharding.py and tests/test_sharding_vlm.py):

- EngineCore decode at tp 2 x dp 2 and at tp 8 (8 heads, one each): greedy
  tokens equal JAX's, and a decode step issues 2 all-reduces a layer (wo,
  wd) plus the embedding's, one all-gather of the logits and one dp
  all-gather of the sampled tokens;
- the paged scheduler over a sharded pool at tp 2 x dp 2, on f32 weights
  and on INT4 ones (fused wqkv / wgu split per block, wo / wd row shards
  re-padded to 512);
- sampling at temperature 1 over dp 2: each lane draws what the
  unsharded port engine draws with the same seed (the sampler takes the
  whole batch's numbers on every rank);
- Gemma-3 and Qwen2-VL at tp 4 with replicated towers (and Gemma-3's
  image embeddings through the sharded lookup, against JAX's), and a
  Llama with Hkv = 2 at tp 4 through replicate_kv_heads;
- the collectives themselves, and the graph guard (a capture over gloo
  raises).

Three launches (4, 4 and 8 processes), each under a deadline."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from pie_tpu.engine.core import EngineCore as JEngineCore
from pie_tpu.engine.core import PenaltyParams as JPenaltyParams
from pie_tpu.engine.scheduler import PagedEngine as JPagedEngine
from pie_tpu.engine.scheduler import Scheduler as JScheduler
from pie_tpu.engine.scheduler import Sequence as JSequence
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.ops.sampling import SamplingParams as JSamplingParams

from test_torch_llama import jax_to_np
from torch_dist_workers import core_decode, launch, paged

TINY = dict(
    model_type="llama", hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=8, vocab_size=512,
    rope_theta=10000.0, tie_word_embeddings=False,
)
GQA_TINY = dict(TINY, num_key_value_heads=2)  # tp 4 > Hkv without replication

GEMMA_TINY = dict(
    text_config=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, head_dim=16,
        vocab_size=272, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        sliding_window=8, sliding_window_pattern=2, query_pre_attn_scalar=16,
        max_position_embeddings=128,
    ),
    vision_config=dict(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=56, patch_size=14, num_channels=3,
    ),
    mm_tokens_per_image=4, image_token_index=260, boi_token_index=258,
    eoi_token_index=259,
)
QWEN_TINY = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=4, vocab_size=272, rms_norm_eps=1e-6, rope_theta=1000000.0,
    max_position_embeddings=256, tie_word_embeddings=False,
    rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
    vision_config=dict(
        depth=2, embed_dim=32, hidden_size=64, num_heads=4, in_channels=3,
        patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
        spatial_patch_size=14, mlp_ratio=2,
    ),
    image_token_id=260, vision_start_token_id=258, vision_end_token_id=259,
)

LLAMA_PROMPTS = [list(range(1, 6 + 4 * i)) for i in range(3)]
GQA_PROMPTS = [list(range(1, 7 + 2 * i)) for i in range(3)]
GEMMA_PROMPTS = [list(range(2, 8 + 3 * i)) for i in range(3)]
QWEN_PROMPTS = [list(range(2, 9 + 2 * i)) for i in range(3)]
# <bos> <boi> four image placeholders <eoi> and a text token
GEMMA_IMAGE_IDS = [2, 258] + [GEMMA_TINY["image_token_index"]] * 4 + [259, 7]


# ---------------------------------------------------------------------------
# JAX references (unsharded)
# ---------------------------------------------------------------------------


def _jax_llama(cfg, seed=0):
    model = JModel(JConfig(**cfg))
    return model, model.init_params(jax.random.PRNGKey(seed), dtype=jnp.float32)


def _jax_greedy(model, params, batch, steps):
    """tests/test_sharding.py's greedy prefill + decode, unsharded."""
    core = JEngineCore(model, params, batch_size=batch, max_seq_len=64,
                       kv_dtype=jnp.float32)
    state = core.new_state(seed=0)
    b = batch
    ids = jnp.broadcast_to(jnp.arange(1, 9, dtype=jnp.int32)[None], (b, 8))
    sampling = JSamplingParams.make(b, temperature=0.0)
    penalties = JPenaltyParams.make(b)
    bias_ids = jnp.full((b, 0), -1, jnp.int32)
    bias_vals = jnp.zeros((b, 0), jnp.float32)
    state, tok, _ = core._prefill(
        params, state, ids, jnp.full((b,), 8, jnp.int32), jnp.zeros((b,), jnp.int32),
        sampling, penalties, bias_ids, bias_vals, sampler_kind="greedy")
    state, outs = core._decode(
        params, state, sampling, penalties, bias_ids, bias_vals,
        jnp.asarray([-1], jnp.int32), num_steps=steps, sampler_kind="greedy")
    return np.concatenate([np.asarray(tok)[:, None], np.asarray(outs[0]).T], axis=1)


def _jax_paged(model, params, prompts):
    """tests/test_sharding_vlm.py's paged run, unsharded (f32 pool)."""
    import dataclasses

    engine = JPagedEngine(model, params, num_lanes=4, num_pages=32,
                          max_pages_per_seq=4, rider_width=8)
    engine.pool = dataclasses.replace(engine.pool, k=engine.pool.k.astype(jnp.float32),
                                      v=engine.pool.v.astype(jnp.float32))
    sched = JScheduler(engine, decode_steps=4)
    seqs = [JSequence(seq_id=i, prompt_ids=p, max_new_tokens=5, temperature=0.0)
            for i, p in enumerate(prompts)]
    for s in seqs:
        sched.submit(s)
    sched.run_to_completion(max_steps=64)
    return [s.output_ids for s in seqs]


def _hf_state_dict(family):
    torch.manual_seed(0)
    if family == "gemma":
        pytest.importorskip("transformers.models.gemma3")
        hf = transformers.Gemma3ForConditionalGeneration(
            transformers.Gemma3Config(**GEMMA_TINY))
        # HF initializes the projector's weight at zero: drawn here, else
        # every image row would be zero
        proj = hf.model.multi_modal_projector
        with torch.no_grad():
            proj.mm_input_projection_weight.normal_(0, 32 ** -0.5)
            proj.mm_soft_emb_norm.weight.normal_(0, 0.3)
        cfg = {**GEMMA_TINY, "model_type": "gemma3", "tie_word_embeddings": True}
    else:
        hf = transformers.Qwen2VLForConditionalGeneration(
            transformers.Qwen2VLConfig(**QWEN_TINY))
        cfg = dict(QWEN_TINY, model_type="qwen2_vl")
    return cfg, {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}


def _jax_vlm(family, cfg, sd, prompts):
    if family == "gemma":
        from pie_tpu.models.gemma3 import Gemma3Config, Gemma3Model as M

        model = M(Gemma3Config.from_dict(cfg))
    else:
        from pie_tpu.models.qwen2_vl import Qwen2VLConfig, Qwen2VLModel as M

        model = M(Qwen2VLConfig.from_dict(cfg))
    return _jax_paged(model, model.from_hf_state_dict(sd, dtype=jnp.float32), prompts)


def _jax_image_embeds(cfg, sd, ids, pixels):
    from pie_tpu.models.gemma3 import Gemma3Config, Gemma3Model

    model = Gemma3Model(Gemma3Config.from_dict(cfg))
    params = model.from_hf_state_dict(sd, dtype=jnp.float32)
    return np.asarray(model.embed_with_images(params, jnp.asarray([ids], jnp.int32),
                                              jnp.asarray(pixels)))


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jm, jp = _jax_llama(TINY)
    # INT4 weights with the embedding and head at 50x so greedy choices are
    # decisive against the port's rounding of the quantized products
    jq = dict(jp, embed=jp["embed"] * 50.0, lm_head=jp["lm_head"] * 50.0)
    jq = jm.quantize_params(jq, group_size=64, bits=4)
    gm, gp = _jax_llama(GQA_TINY)
    return {"f32": (jm, jp), "int4": (jm, jq), "gqa": (gm, gp)}


@pytest.fixture(scope="module")
def tp2dp2(weights):
    """One 4-process launch at tp 2 x dp 2: EngineCore decode, the paged
    scheduler on f32 and INT4 weights, the collectives, then EngineCore
    and the paged scheduler sampling at temperature 1."""
    mesh = {"tp": 2, "dp": 2}
    f32 = dict(mesh, cfg=TINY, params=jax_to_np(weights["f32"][1]))
    progs = [
        ("core_decode", dict(f32, batch=2, steps=6)),
        ("paged", dict(f32, prompts=LLAMA_PROMPTS)),
        ("paged", dict(mesh, cfg=TINY, params=jax_to_np(weights["int4"][1]),
                       prompts=LLAMA_PROMPTS)),
        ("collectives", mesh),
        ("core_decode", dict(f32, batch=2, steps=6, temperature=1.0)),
        ("paged", dict(f32, prompts=LLAMA_PROMPTS, temperature=1.0)),
    ]
    return launch("many", 4, progs, timeout=120)


@pytest.fixture(scope="module")
def tp4(weights):
    """One 4-process launch at tp 4: Gemma-3, Qwen2-VL, and the Hkv = 2
    Llama with its KV heads replicated twice."""
    gcfg, gsd = _hf_state_dict("gemma")
    qcfg, qsd = _hf_state_dict("qwen")
    gp = weights["gqa"][1]
    mesh = {"tp": 4, "dp": 1}
    pixels = np.random.default_rng(0).normal(size=(1, 3, 56, 56)).astype(np.float32)
    progs = [
        ("paged", dict(mesh, family="gemma", cfg=gcfg, sd=gsd, prompts=GEMMA_PROMPTS)),
        ("paged", dict(mesh, family="qwen", cfg=qcfg, sd=qsd, prompts=QWEN_PROMPTS)),
        ("paged", dict(mesh, cfg=GQA_TINY, params=jax_to_np(gp), kv_rep=2,
                       prompts=GQA_PROMPTS)),
        ("image_embeds", dict(mesh, family="gemma", cfg=gcfg, sd=gsd, pixels=pixels,
                              ids=GEMMA_IMAGE_IDS)),
    ]
    res = launch("many", 4, progs, timeout=120)
    want = {"gemma": _jax_vlm("gemma", gcfg, gsd, GEMMA_PROMPTS),
            "qwen": _jax_vlm("qwen", qcfg, qsd, QWEN_PROMPTS),
            "image_embeds": _jax_image_embeds(gcfg, gsd, GEMMA_IMAGE_IDS, pixels)}
    return res, want


def test_tp_dp_decode_matches_unsharded(weights, tp2dp2):
    """tp 2 x dp 2 EngineCore decode: every rank returns the whole batch's
    greedy tokens, equal to JAX's unsharded core; each rank's cache holds
    its batch row and half the KV heads."""
    want = _jax_greedy(*weights["f32"], batch=2, steps=6)
    for rank in tp2dp2:
        got = rank[0]
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["cache_rows"] == 1 and got["cache_heads"] == 4


def test_decode_step_collectives(tp2dp2):
    """A decode step of the 2-layer model: all-reduces after wo and wd in
    each layer plus the embedding's, one gather of the vocab-sharded
    logits, one dp gather of the sampled tokens (JAX's test finds the
    collectives in the compiled HLO)."""
    for rank in tp2dp2:
        assert rank[0]["per_step"] == {"tp all_reduce": 2 * 2 + 1,
                                       "tp all_gather": 1, "dp all_gather": 1}


def test_tp8_full_width(weights):
    """tp 8 over 8 heads (one query and one KV head a rank) matches."""
    want = _jax_greedy(*weights["f32"], batch=1, steps=4)
    res = launch("core_decode", 8, dict(tp=8, dp=1, cfg=TINY,
                                        params=jax_to_np(weights["f32"][1]),
                                        batch=1, steps=4), timeout=120)
    for rank in res:
        np.testing.assert_array_equal(rank["tokens"], want)
        assert rank["cache_heads"] == 1
        assert rank["per_step"]["dp all_gather"] == 0


@pytest.mark.parametrize("weights_kind", ["f32", "int4"])
def test_paged_scheduler_over_sharded_pool(weights, tp2dp2, weights_kind):
    """Continuous batching (mixed chunks, rider slices, lanes over dp) on
    the tp 2 x dp 2 mesh gives JAX's unsharded scheduler's outputs; each
    rank's pool holds half the KV heads."""
    jm, jp = weights[weights_kind]
    want = _jax_paged(jm, jp, LLAMA_PROMPTS)
    idx = {"f32": 1, "int4": 2}[weights_kind]
    for rank in tp2dp2:
        got = rank[idx]
        assert got["outputs"] == want
        assert got["pool_heads"] == 4
        assert {"decode", "mixed"} <= set(got["graph_keys"])


def test_collectives_and_graph_guard(tp2dp2):
    """Sum over tp, vocab gather in tp rank order, row gather in dp rank
    order, the masked embedding lookup, and StepGraphs refusing to capture
    a step over a gloo group."""
    for r, rank in enumerate(tp2dp2):
        got = rank[3]
        assert got["backend"] == "gloo"
        assert (got["tp_rank"], got["dp_rank"]) == (r % 2, r // 2)
        tp_peers = [r - r % 2 + 1, r - r % 2 + 2]  # ranks' values are rank + 1
        np.testing.assert_array_equal(got["summed"], np.full((2, 3), float(sum(tp_peers))))
        np.testing.assert_array_equal(got["gathered"], [0, 1, 2, 10, 11, 12])
        np.testing.assert_array_equal(got["rows"], [r % 2, r % 2 + 2])
        np.testing.assert_array_equal(got["embed"], got["embed_want"])
        assert "gloo" in got["capture_refused"] and "eager" in got["capture_refused"]


@pytest.mark.parametrize("idx,family", [(0, "gemma"), (1, "qwen")])
def test_vlm_tp4_paged_parity(tp4, idx, family):
    """Gemma-3 (dual sliding pattern) and Qwen2-VL (M-RoPE, biased q/k/v
    shards) at tp 4, towers replicated: JAX's unsharded paged outputs."""
    res, want = tp4
    for rank in res:
        assert rank[idx]["outputs"] == want[family]
        assert rank[idx]["pool_heads"] == 1


def test_gemma3_vision_tower_replicated(tp4):
    """The SigLIP tower and projector stay whole on every rank (the same
    tensors), and an image prompt's embeddings through the sharded
    embedding lookup equal JAX's unsharded model's on the same weights
    and pixels (2e-5, as JAX's own test allows)."""
    res, want = tp4
    want = want["image_embeds"]
    img = np.asarray(GEMMA_IMAGE_IDS) == GEMMA_TINY["image_token_index"]
    assert want.shape == (1, 8, 64) and np.abs(want[0, img]).max() > 0
    for rank in res:
        assert rank[3]["vision_shared"]
        np.testing.assert_allclose(rank[3]["embeds"], want, rtol=2e-5, atol=2e-5)


def test_dp_sampling_draws_as_unsharded(weights, tp2dp2):
    """Temperature 1 on the tp 2 x dp 2 mesh: every lane samples what the
    unsharded port engine samples from the same seed. EngineCore's two
    rows hold the same prompt, one on each dp rank, yet draw different
    streams (as they do unsharded); the paged scheduler's sampled outputs
    equal the unsharded scheduler's."""
    f32 = dict(cfg=TINY, params=jax_to_np(weights["f32"][1]))
    want_core = core_decode(0, 1, dict(f32, batch=2, steps=6, temperature=1.0))["tokens"]
    want_paged = paged(0, 1, dict(f32, prompts=LLAMA_PROMPTS, temperature=1.0))["outputs"]
    assert not np.array_equal(want_core[0], want_core[1])
    for rank in tp2dp2:
        np.testing.assert_array_equal(rank[4]["tokens"], want_core)
        assert rank[5]["outputs"] == want_paged


def test_kv_replication_tp_beyond_hkv(weights, tp4):
    """Hkv = 2 at tp 4: replicate_kv_heads(factor 2) gives each rank one KV
    head, and the greedy outputs equal JAX's unsharded original."""
    res, _ = tp4
    want = _jax_paged(*weights["gqa"], GQA_PROMPTS)
    for rank in res:
        assert rank[2]["outputs"] == want
        assert rank[2]["pool_heads"] == 1
