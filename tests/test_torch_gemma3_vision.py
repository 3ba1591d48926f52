"""The port's Gemma-3 image inputs (pie_tpu_torch.models.gemma3's SigLIP
tower, projector and ``embed_with_images``) on the CPU, at the tiny VLM of
tests/test_vlm_batching.py (a 2-layer text model with window 8, a 2-block
tower of width 32, 56-px images, 4 tokens an image): the tower, the
projector and the merged embeddings against the JAX package's on the same
weights; the full forward against HF's Gemma3ForConditionalGeneration;
greedy streams of the single-stream engine against the JAX engine's (one
image, two images, a prompt past the window whose head chunks carry
embeddings); the batched service beside text lanes against the single
stream; the cases of tests/test_vlm_serving.py (template expansion,
generate with pixels, a chat with an image, an image on a text model, an
HTTP image chat); the placeholder-count refusal; two recorded reference
facts (HF's bidirectional image mask under ``token_type_ids``, HF's
``<start_of_image>`` frame); and the entry points' default device."""

import asyncio
import base64
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("transformers.models.gemma3")

import pie_tpu.models.gemma3 as jg3
from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.engine.engine import InferenceError
from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model, SigLipVision
from pie_tpu_torch.models.llama import from_jax_params

from test_torch_llama import jax_to_np

# tests/test_vlm_batching.py's tiny Gemma-3 VLM
VLM_TINY = dict(
    text_config=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        vocab_size=270, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        sliding_window=8, sliding_window_pattern=2, query_pre_attn_scalar=16,
        max_position_embeddings=128,
    ),
    vision_config=dict(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=56, patch_size=14, num_channels=3,
    ),
    mm_tokens_per_image=4,
    image_token_index=260,
    boi_token_index=258,
    eoi_token_index=259,
)
IMG = VLM_TINY["image_token_index"]
BOI, EOI = VLM_TINY["boi_token_index"], VLM_TINY["eoi_token_index"]
# tests/test_vlm_batching.py's prompt (10 tokens: past the window of 8)
IMAGE_PROMPT = [2, BOI] + [IMG] * 4 + [EOI, 7, 9, 11]
TWO_IMAGES = [2, BOI] + [IMG] * 4 + [EOI, 7, BOI] + [IMG] * 4 + [EOI, 9, 11]
# 22 tokens: head chunks of 8, the image across the first chunk's end
LONG_PROMPT = [2, 5, 6, 7, 8, BOI] + [IMG] * 4 + [EOI] + list(range(30, 41))
CFG = {**VLM_TINY, "model_type": "gemma3", "tie_word_embeddings": True}
TOL = 2e-5


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


def _pixels(seed, n=1):
    return np.random.default_rng(seed).standard_normal((n, 3, 56, 56)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """HF's tiny VLM (seeded, f32; HF initializes the projector's weight at
    zero, so it and its norm are drawn here, else every image row would be
    zero), the JAX model and params from its weights, and the port's params
    carried across from JAX's."""
    torch.manual_seed(0)
    hf = transformers.Gemma3ForConditionalGeneration(transformers.Gemma3Config(**VLM_TINY))
    hf.eval()
    proj = hf.model.multi_modal_projector
    with torch.no_grad():
        proj.mm_input_projection_weight.normal_(0, 32 ** -0.5)
        proj.mm_soft_emb_norm.weight.normal_(0, 0.3)
    jm = jg3.Gemma3Model(jg3.Gemma3Config.from_dict(CFG))
    jp = jm.from_hf_state_dict({k: v.detach().numpy() for k, v in hf.state_dict().items()},
                               dtype=jnp.float32)
    tm = Gemma3Model(Gemma3Config.from_dict(CFG))
    return hf, jm, jp, tm, from_jax_params(jax_to_np(jp), "cpu")


def test_config_and_hf_params(setup):
    """The VLM config reads the tower, the image token and the tokens per
    image; from_hf_state_dict gives the JAX package's params exactly, the
    tower's included, in the JAX layout."""
    hf, _, _, tm, tp = setup
    cfg = tm.config
    assert (cfg.image_token_id, cfg.mm_tokens_per_image) == (IMG, 4)
    assert isinstance(tm.vision, SigLipVision) and tm.vision.patches == 4
    got = tm.from_hf_state_dict({k: v.detach() for k, v in hf.state_dict().items()},
                                dtype=torch.float32)
    assert set(got["vision"]) == {"patch_w", "patch_b", "pos", "post_ln_w", "post_ln_b",
                                  "encoder", "proj_norm", "proj_w"}
    assert got["vision"]["encoder"]["wq"].shape == (2, 32, 32)
    assert got["vision"]["proj_w"].shape == (32, 64)

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        else:
            assert torch.equal(a, b)

    walk(got, tp)


def test_tower_projector_and_embeds_match_jax(setup):
    """Two images through the tower, the projector and embed_with_images
    (a prompt with both images' placeholders), f32 on both sides."""
    _, jm, jp, tm, tp = setup
    px = _pixels(1, 2)
    want_f = jm.vision.forward(jp["vision"], jnp.asarray(px))
    want_p = jm.vision.project(jp["vision"], want_f, jm.config, jp)
    want_e = jm.embed_with_images(jp, jnp.asarray([TWO_IMAGES]), jnp.asarray(px))
    with torch.no_grad():
        got_f = tm.vision.forward(tp["vision"], torch.from_numpy(px))
        got_p = tm.vision.project(tp["vision"], got_f)
        got_e = tm.embed_with_images(tp, torch.tensor([TWO_IMAGES]), px)
    assert got_f.shape == (2, 16, 32) and got_p.shape == (2, 4, 64)
    assert _norm_err(got_f.numpy(), want_f) < TOL
    assert _norm_err(got_p.numpy(), want_p) < TOL
    assert _norm_err(got_e.numpy(), want_e) < TOL
    # the image rows are the projected features, unscaled, in order
    ids = np.array(TWO_IMAGES)
    np.testing.assert_array_equal(got_e[0, ids == IMG].numpy(),
                                  got_p.reshape(8, 64).numpy())


def test_forward_matches_hf(setup):
    """The full forward with pixels (no token_type_ids: causal masks, as
    in the JAX package) against HF's Gemma3ForConditionalGeneration, over
    a contiguous cache and over the bounded DualKVCache (one chunk within
    the window)."""
    hf, _, _, tm, tp = setup
    ids = np.array([IMAGE_PROMPT[:8]])
    px = _pixels(2)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), pixel_values=torch.tensor(px)).logits.numpy()
    first = torch.zeros((1,), dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None]
    for cache in (make_kv_cache(2, 1, 16, 2, 16, torch.float32, device="cpu"),
                  tm.make_cache(1, 16, torch.float32, device="cpu")):
        with torch.no_grad():
            got, _ = tm(tp, torch.tensor(ids), cache.advance(first, 8), pos,
                        pixel_values=torch.tensor(px))
        np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_hf_image_mask_is_bidirectional_with_token_type_ids(setup):
    """Recorded fact (ROADMAP C.3): HF lets a prefill's image tokens attend
    to each other both ways when token_type_ids mark them, so its logits
    at the image positions move; the JAX package's masks are causal only,
    and the port equals JAX on the image prompt (the tower inside)."""
    hf, jm, jp, tm, tp = setup
    ids = np.array([IMAGE_PROMPT[:8]])
    px = _pixels(3)
    tt = torch.tensor((ids == IMG).astype(np.int64))
    with torch.no_grad():
        causal = hf(input_ids=torch.tensor(ids), pixel_values=torch.tensor(px)).logits.numpy()
        bidir = hf(input_ids=torch.tensor(ids), pixel_values=torch.tensor(px),
                   token_type_ids=tt).logits.numpy()
    assert _norm_err(bidir[0, 2:5], causal[0, 2:5]) > 1e-3
    np.testing.assert_allclose(bidir[0, :2], causal[0, :2], atol=1e-5)  # before the image
    jc = jg3.KVCache.create(2, 1, 16, 2, 16, jnp.float32).advance(
        jnp.zeros((1,), jnp.int32), 8)
    want, _ = jm(jp, jnp.asarray(ids), jc, jnp.arange(8)[None], pixel_values=jnp.asarray(px))
    first = torch.zeros((1,), dtype=torch.int32)
    with torch.no_grad():
        got, _ = tm(tp, torch.tensor(ids), make_kv_cache(2, 1, 16, 2, 16, torch.float32,
                                                         device="cpu").advance(first, 8),
                    torch.arange(8, dtype=torch.int32)[None], pixel_values=torch.tensor(px))
    assert _norm_err(got.numpy(), want) < TOL
    assert _norm_err(got.numpy(), causal) < 5e-3


def test_placeholder_count_refused_where_jax_clips(setup):
    """A placeholder count other than images x mm_tokens_per_image raises
    InferenceError in the port (model and engine), before the tower runs;
    the JAX package clips the row index and repeats the last row."""
    _, jm, jp, tm, tp = setup
    short = [2, BOI] + [IMG] * 3 + [EOI, 7]
    ran = []
    forward = tm.vision.forward
    tm.vision.forward = lambda *a: ran.append(1) or forward(*a)
    try:
        for ids, n in ((short, 1), (IMAGE_PROMPT, 2)):
            with pytest.raises(InferenceError, match="placeholder"):
                tm.embed_with_images(tp, torch.tensor([ids]), _pixels(4, n))
    finally:
        tm.vision.forward = forward
    assert not ran
    extra = [2] + [IMG] * 5 + [7]  # one image, five placeholders
    emb = np.asarray(jm.embed_with_images(jp, jnp.asarray([extra]), jnp.asarray(_pixels(4))))
    np.testing.assert_array_equal(emb[0, 5], emb[0, 4])  # the 5th repeats the 4th
    from pie_tpu_torch.engine import InferenceEngine

    engine = InferenceEngine(model=tm, params=tp, max_seq_len=64, kv_dtype=torch.float32,
                             prompt_cache=False, device="cpu")
    with pytest.raises(InferenceError, match="placeholder"):
        engine.generate(extra, max_completion_tokens=2, pixel_values=_pixels(4))
    with pytest.raises(InferenceError, match="grid_thw"):
        engine.generate(IMAGE_PROMPT, max_completion_tokens=2, pixel_values=_pixels(4),
                        image_kwargs={"grid_thw": np.array([[1, 4, 4]])})


# -- engines ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(setup):
    """The JAX single-stream engine and the port's single-stream and
    batched engines on the same f32 weights (an f32 pool)."""
    from pie_tpu.engine import InferenceEngine as JEngine
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine

    _, jm, jp, tm, tp = setup
    kw = dict(max_seq_len=64, decode_chunk=4, prompt_cache=False)
    out = dict(
        jax=JEngine(model=jm, params=jp, kv_dtype=jnp.float32, **kw),
        port=InferenceEngine(model=tm, params=tp, kv_dtype=torch.float32, device="cpu",
                             **kw),
        batched=BatchedInferenceEngine(model=tm, params=tp, num_lanes=4, num_pages=32,
                                       max_pages_per_seq=8, prefill_chunk=16,
                                       kv_dtype=torch.float32, device="cpu"),
    )
    yield out
    out["batched"].shutdown()


@pytest.mark.parametrize("prompt,images", [(IMAGE_PROMPT, 1), (TWO_IMAGES, 2),
                                           (LONG_PROMPT, 1)],
                         ids=["one image", "two images", "past the window"])
def test_engine_streams_match_jax(engines, prompt, images):
    """Greedy streams of the single-stream engine equal the JAX engine's:
    every prompt is longer than the window of 8, so it prefills in head
    chunks, each carrying its slice of the prompt's embeddings (the long
    prompt's image straddles the first chunk's end); the batched service
    equals the single stream; the image changes the tokens."""
    kw = dict(max_completion_tokens=8, temperature=0.0, pixel_values=_pixels(10 + images,
                                                                              images))
    want = engines["jax"].generate(prompt, **kw).token_ids
    got = engines["port"].generate(prompt, **kw).token_ids
    assert got == want and len(got) == 8
    assert engines["batched"].generate(prompt, **kw).token_ids == got
    other = dict(kw, pixel_values=_pixels(20 + images, images))
    assert engines["port"].generate(prompt, **other).token_ids != got


def test_head_chunks_replay_the_prefill_with_embeddings(engines):
    """The long prompt's head chunks and its tail each run the prefill
    with embeddings (the core's "embeds on" key), never from the ids."""
    engine = engines["port"]
    keys = []
    prefill = engine.core._prefill

    def spy(*a, **kw):
        keys.append(kw.get("inputs_embeds") is not None)
        return prefill(*a, **kw)

    engine.core._prefill = spy
    try:
        engine.generate(LONG_PROMPT, max_completion_tokens=2, temperature=0.0,
                        pixel_values=_pixels(5))
    finally:
        engine.core._prefill = prefill
    assert keys == [True, True, True]  # chunks of 8, 8 and the 6-token tail


def test_image_lane_beside_text_lanes(engines):
    """tests/test_vlm_batching.py: an image request decoding beside two text
    lanes (submitted together) yields the single stream's tokens, and so
    does each text lane."""
    single, batched = engines["port"], engines["batched"]
    img_kw = dict(max_completion_tokens=6, temperature=0.0, pixel_values=_pixels(3))
    want = single.generate(IMAGE_PROMPT, **img_kw).token_ids
    want_text = single.generate([5, 6, 7], max_completion_tokens=6,
                                temperature=0.0).token_ids
    results = {}

    def run(name, prompt, kw):
        results[name] = batched.generate(prompt, **kw).token_ids

    threads = [threading.Thread(target=run, args=("img", IMAGE_PROMPT, img_kw))] + [
        threading.Thread(target=run, args=(f"t{i}", [5, 6, 7],
                                           dict(max_completion_tokens=6, temperature=0.0)))
        for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results == {"img": want, "t0": want_text, "t1": want_text}


def test_image_prompt_leaves_the_prompt_cache_claiming_nothing(setup):
    """An image prompt overwrites the DualKVCache from slot 0: after it, a
    text prompt sharing the previous text request's prefix prefills from
    the start and decodes what a fresh engine decodes."""
    from pie_tpu_torch.engine import InferenceEngine

    _, _, _, tm, tp = setup
    make = lambda cache: InferenceEngine(model=tm, params=tp, kv_dtype=torch.float32,
                                         max_seq_len=64, decode_chunk=4,
                                         prompt_cache=cache, device="cpu")
    engine = make(True)
    text = [5, 9, 17, 23, 4, 8]
    engine.generate(text, max_completion_tokens=4, temperature=0.0)
    engine.generate(IMAGE_PROMPT, max_completion_tokens=4, temperature=0.0,
                    pixel_values=_pixels(6))
    assert engine.prompt_cache.computed_ids == []
    got = engine.generate(text + [40], max_completion_tokens=6, temperature=0.0)
    want = make(False).generate(text + [40], max_completion_tokens=6, temperature=0.0)
    assert got.token_ids == want.token_ids


# -- serving (tests/test_vlm_serving.py) -----------------------------------------


def _tiny_gemma_tokenizer():
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer import Tokenizer
    from pie_tpu_torch.tokenizer.control_tokens import GEMMA

    words = ["hello", "what", "is", "in", "this", "image", "a", "cat", "<unk>"]
    specials = GEMMA.all_control_tokens
    raw = RawTok(models.WordLevel({w: i for i, w in enumerate(specials + words)},
                                  unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    return Tokenizer(transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<bos>", eos_token="<eos>", unk_token="<unk>"),
        GEMMA)


def _png_data_uri(seed=0, size=32):
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                                               dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def vlm_engines(setup):
    """Both port engines with the Gemma word tokenizer."""
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine

    _, _, _, tm, tp = setup
    tok = _tiny_gemma_tokenizer()
    single = InferenceEngine(model=tm, params=tp, tokenizer=tok, max_seq_len=128,
                             kv_dtype=torch.float32, decode_chunk=4, device="cpu")
    batched = BatchedInferenceEngine(model=tm, params=tp, tokenizer=tok, num_lanes=2,
                                     num_pages=32, max_pages_per_seq=8, prefill_chunk=16,
                                     kv_dtype=torch.float32, device="cpu")
    yield single, batched
    batched.shutdown()


def test_template_expands_image_tokens(vlm_engines):
    """The Gemma template puts mm_tokens_per_image bare placeholders before
    the message text, and none for a message without images."""
    tok = vlm_engines[0].tokenizer
    ids = tok.apply_chat_template([{"role": "user", "text": "what is in this image",
                                    "num_images": 1}],
                                  image_token_id=IMG, tokens_per_image=4)
    assert ids.count(IMG) == 4
    assert ids.index(IMG) < ids.index(tok.encode("what", add_bos=False)[0])
    assert IMG not in tok.apply_chat_template(
        [{"role": "user", "text": "what is in this image"}], image_token_id=IMG,
        tokens_per_image=4)


def test_image_frame_is_bare_where_hf_frames_it(vlm_engines):
    """Recorded fact (ROADMAP C.3): the JAX template (and the port's)
    expands an image into a bare run of <image_soft_token>; HF's
    Gemma3Processor frames the run with <start_of_image> / <end_of_image>
    (and blank lines)."""
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu.tokenizer import Tokenizer as JTokenizer
    from pie_tpu.tokenizer.control_tokens import GEMMA as JGEMMA

    tok = vlm_engines[0].tokenizer
    msg = [{"role": "user", "text": "what is in this image", "num_images": 1}]
    ids = tok.apply_chat_template(msg, image_token_id=IMG, tokens_per_image=4)
    start = ids.index(IMG)
    assert ids[start:start + 4] == [IMG] * 4
    assert BOI not in ids and EOI not in ids
    assert ids == JTokenizer(tok._tok, JGEMMA).apply_chat_template(
        msg, image_token_id=IMG, tokens_per_image=4)
    specials = ["<bos>", "<eos>", "<start_of_image>", "<end_of_image>",
                "<image_soft_token>"]
    raw = RawTok(models.WordLevel({w: i for i, w in enumerate(specials + ["what", "<unk>"])},
                                  unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    hf_tok = transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<bos>", eos_token="<eos>", unk_token="<unk>",
        extra_special_tokens={"image_token": "<image_soft_token>",
                              "boi_token": "<start_of_image>",
                              "eoi_token": "<end_of_image>"})
    proc = transformers.Gemma3Processor(
        image_processor=transformers.Gemma3ImageProcessor(size={"height": 56, "width": 56}),
        tokenizer=hf_tok, image_seq_length=4)
    out = proc(text=["what <start_of_image>"], images=[[np.zeros((56, 56, 3), np.uint8)]])
    assert out["input_ids"][0][1:] == [2] + [4] * 4 + [3]  # boi, 4 soft tokens, eoi


def test_generate_with_pixel_values(vlm_engines):
    """A templated image prompt with pixels decodes in-vocabulary tokens on
    both engines, the same tokens; without pixels the placeholders embed
    as text and the tokens change."""
    single, batched = vlm_engines
    ids = single.tokenizer.apply_chat_template(
        [{"role": "user", "text": "what is in this image", "num_images": 1}],
        image_token_id=IMG, tokens_per_image=4)
    kw = dict(max_completion_tokens=5, temperature=0.0, pixel_values=_pixels(7))
    res = single.generate(ids, **kw)
    assert res.completion_tokens == 5 and all(0 <= t < 270 for t in res.token_ids)
    assert batched.generate(ids, **kw).token_ids == res.token_ids
    text_only = single.generate(ids, max_completion_tokens=5, temperature=0.0)
    assert text_only.token_ids != res.token_ids


def test_chat_with_image(vlm_engines):
    """An image attached to a message: the SigLIP processor's square 56-px
    pixels, 4 placeholders; both engines give the same tokens, and another
    image other tokens."""
    single, batched = vlm_engines
    msg = [{"role": "user", "text": "what is in this image", "images": [_png_data_uri(1)]}]
    want = single.chat(msg, max_completion_tokens=4, temperature=0.0)
    assert want.metadata["finish_reason"] in ("stop", "length")
    assert want.metadata["completion_tokens"] >= 1
    got = batched.chat(msg, max_completion_tokens=4, temperature=0.0)
    assert got.metadata["token_ids"] == want.metadata["token_ids"]
    other = [dict(msg[0], images=[_png_data_uri(2)])]
    assert (single.chat(other, max_completion_tokens=4, temperature=0.0)
            .metadata["token_ids"] != want.metadata["token_ids"])


def test_chat_image_on_text_model_raises():
    """A text-only model (a Llama, and a gemma3_text config) refuses an
    image chat."""
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

    llama = LlamaModel(LlamaConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=2, num_key_value_heads=1,
                                   vocab_size=64, tie_word_embeddings=True))
    text = Gemma3Model(Gemma3Config.from_dict(dict(VLM_TINY["text_config"],
                                                   model_type="gemma3_text")))
    assert text.vision is None
    msg = [{"role": "user", "text": "hello", "images": [_png_data_uri()]}]
    for model in (llama, text):
        eng = InferenceEngine(model=model, params=model.init_params(dtype=torch.float32,
                                                                    device="cpu"),
                              tokenizer=_tiny_gemma_tokenizer(), max_seq_len=64,
                              kv_dtype=torch.float32, device="cpu")
        with pytest.raises(InferenceError, match="image"):
            eng.chat(msg, max_completion_tokens=2)


@pytest.mark.parametrize("backend", ["single", "batched"])
def test_server_chat_with_image(vlm_engines, backend):
    """The OpenAI wire shape (a text part and an image_url part with a PNG
    data URI) through create_app: 200, the engine's own tokens, usage."""
    from aiohttp.test_utils import TestClient, TestServer

    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    engine = dict(zip(("single", "batched"), vlm_engines))[backend]
    uri = _png_data_uri(3)
    want = vlm_engines[0].chat(
        [{"role": "user", "text": "what is in this image", "images": [uri]}],
        max_completion_tokens=4, temperature=0.0)
    app = create_app(engine=engine, settings=Settings(batching=backend == "batched"),
                     device="cpu")

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json={
                "model": "tiny-gemma3-vlm",
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "what is in this image"},
                    {"type": "image_url", "image_url": {"url": uri}}]}],
                "max_completion_tokens": 4, "temperature": 0.0})
            return resp.status, await resp.json()
        finally:
            await client.close()

    status, body = asyncio.run(run())
    assert status == 200, body
    assert body["choices"][0]["message"]["content"] == want.text
    assert body["usage"]["completion_tokens"] == want.metadata["completion_tokens"]


def test_entry_points_default_to_cuda(setup):
    """The tower's random initializer and both engines ask for CUDA without
    a device argument and raise where there is none; on the CPU the
    tower's init has the JAX params layout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine

    _, _, _, tm, tp = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.vision.init_params()
    for make in (lambda: InferenceEngine(model=tm, params=tp, max_seq_len=32),
                 lambda: BatchedInferenceEngine(model=tm, params=tp, num_lanes=2,
                                                num_pages=8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    vp = tm.vision.init_params(seed=1, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in vp.items() if k != "encoder"} == {
        k: tuple(v.shape) for k, v in tp["vision"].items() if k != "encoder"}
    assert all(vp["encoder"][k].shape == v.shape for k, v in tp["vision"]["encoder"].items())


@pytest.mark.parametrize("batching", [False, True])
def test_image_chat_from_model_path(setup, tmp_path, batching):
    """create_app on a Gemma-3 VLM snapshot (what ``MODEL_PATH=... python -m
    pie_tpu_torch.server`` builds; bf16, an INT4 g64 quantization block):
    the text loads quantized, the tower dense, and an image chat over HTTP
    answers 200 on both backends, its prompt carrying the image's 4
    placeholders."""
    import copy
    import json

    from aiohttp.test_utils import TestClient, TestServer

    from pie_tpu_torch.ops.quant import QuantizedTensor
    from pie_tpu_torch.server.app import ENGINE_KEY, create_app
    from pie_tpu_torch.server.config import Settings

    snap = tmp_path / "snap"
    copy.deepcopy(setup[0]).to(torch.bfloat16).save_pretrained(snap)
    cfg = json.loads((snap / "config.json").read_text())
    cfg["quantization"] = {"group_size": 64, "bits": 4}
    (snap / "config.json").write_text(json.dumps(cfg))
    _tiny_gemma_tokenizer()._tok.save_pretrained(snap)
    app = create_app(settings=Settings(model_path=str(snap), max_seq_len=64,
                                       batching=batching, num_lanes=2),
                     device="cpu")
    engine = app[ENGINE_KEY]
    assert isinstance(engine.params["layers"]["wq"], QuantizedTensor)
    assert engine.params["vision"]["proj_w"].dtype == torch.bfloat16
    uri = _png_data_uri(4)

    async def run():
        async with TestClient(TestServer(app)) as client:
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "what is in this image"},
                    {"type": "image_url", "image_url": {"url": uri}}]}],
                "max_tokens": 4, "temperature": 0.0})
            return resp.status, await resp.json()

    try:
        status, body = asyncio.run(run())
    finally:
        if batching:
            engine.shutdown()
    assert status == 200, body
    want = engine.tokenizer.apply_chat_template(
        [{"role": "user", "text": "what is in this image", "num_images": 1}],
        add_generation_prompt=True, image_token_id=IMG, tokens_per_image=4)
    assert body["usage"]["prompt_tokens"] == len(want) and want.count(IMG) == 4
    assert body["usage"]["completion_tokens"] >= 1
