"""The port's image preprocessing (pie_tpu_torch.vision) and image chats on
the CPU: the processors against the JAX package's pie_tpu/vision/utils.py
on the same seeded images (arrays equal), ``make_image_processor`` for
each family, the Qwen2-VL patchify on numpy pixels (no Pillow), and, as
tests/test_vlm_serving.py and tests/test_vlm_batching.py do for the JAX
package, image chats on the tiny Qwen2-VL through both engines and through
``create_app`` on both backends (the OpenAI ``image_url`` wire shape with a
PNG data URI), plus a json_schema chat on the same model."""

import asyncio
import base64
import io
import json
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")
PIL = pytest.importorskip("PIL")

from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

import pie_tpu.vision.utils as jv
from pie_tpu_torch.engine.engine import InferenceError
from pie_tpu_torch.vision import utils as tv

from test_batched_constrained import JSON_PIECES
from test_torch_qwen2_vl import VLM_TINY, _port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(seed, size=(40, 28), mode="RGB"):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    return img.convert(mode) if mode != "RGB" else img


def _png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _data_uri(seed=0, size=(32, 32)) -> str:
    return "data:image/png;base64," + base64.b64encode(_png(_image(seed, size))).decode()


def _sources(tmp_path):
    """The same images as a PIL image (RGBA and L too), raw bytes, a
    BytesIO, a data URI and a local path."""
    path = tmp_path / "img.png"
    path.write_bytes(_png(_image(4)))
    return [_image(0), _image(1, (64, 20), "RGBA"), _image(2, (17, 33), "L"),
            _png(_image(3)), io.BytesIO(_png(_image(3))), _data_uri(5), str(path)]


def test_load_and_resize_match_jax(tmp_path):
    for src, again in zip(_sources(tmp_path), _sources(tmp_path)):
        got, want = tv.load_image(src), jv.load_image(again)
        assert got.mode == "RGB" and np.array_equal(np.asarray(got), np.asarray(want))
        assert np.array_equal(np.asarray(tv.resize_image(got, (24, 24))),
                              np.asarray(jv.resize_image(want, (24, 24))))


def test_processors_match_jax(tmp_path):
    """SigLIP and Qwen2-VL processors: arrays equal, element for element,
    the Qwen2-VL patches in merge-block order with their grid."""
    srcs = lambda: [s for s in _sources(tmp_path) if not isinstance(s, io.BytesIO)]
    for size in (56, 224):
        got = tv.SiglipImageProcessor(image_size=size).batch(srcs())
        want = jv.SiglipImageProcessor(image_size=size).batch(srcs())
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for kw in (dict(), dict(image_size=56, patch_size=14), dict(image_size=8, patch_size=4)):
        tp, jp = tv.Qwen2VLImageProcessor(**kw), jv.Qwen2VLImageProcessor(**kw)
        (gp, gg), (wp, wg) = tp.batch(srcs()), jp.batch(srcs())
        assert gp.dtype == wp.dtype and np.array_equal(gp, wp) and np.array_equal(gg, wg)
        assert tp.tokens_per_image == jp.tokens_per_image


def test_patchify_takes_numpy_pixels():
    """``qwen2vl_patchify`` on a normalized numpy image equals the
    processor's output for the same pixels: numpy pixels reach the tower
    without Pillow."""
    proc = tv.Qwen2VLImageProcessor(image_size=56, patch_size=14)
    img = _image(7, (56, 56))
    arr = tv.normalize(np.asarray(img, np.float32) / 255.0, proc.image_mean,
                       proc.image_std)
    got = tv.qwen2vl_patchify(arr, 14, 2, 2)
    assert got.shape == (16, 3 * 2 * 14 * 14)
    assert np.array_equal(got, proc.batch([img])[0])


def test_make_image_processor_per_family():
    """Qwen2-VL (M-RoPE config with a tower) -> the patchifying processor
    with its config's patch sizes; a SigLIP-style tower -> the square
    one; no tower -> None; both packages alike."""
    qwen = _port(dict(VLM_TINY, vision_config=dict(VLM_TINY["vision_config"],
                                                   patch_size=4)))
    got, want = tv.make_image_processor(qwen), jv.make_image_processor(qwen)
    assert isinstance(got, tv.Qwen2VLImageProcessor)
    assert (got.patch_size, got.merge_size, got.temporal_patch_size) == (4, 2, 2)
    assert (want.patch_size, want.merge_size) == (got.patch_size, got.merge_size)
    siglip = types.SimpleNamespace(vision=object(), config=types.SimpleNamespace(
        vision={"image_size": 896}))
    got, want = tv.make_image_processor(siglip), jv.make_image_processor(siglip)
    assert isinstance(got, tv.SiglipImageProcessor) and got.image_size == 896
    assert want.image_size == got.image_size
    for text_only in (_port(dict(VLM_TINY, vision_config=None)),
                      types.SimpleNamespace(config=None)):
        assert tv.make_image_processor(text_only) is None
        assert jv.make_image_processor(text_only) is None


# -- image chats on the tiny Qwen2-VL ------------------------------------------


def _chatml_tokenizer():
    """An offline word-level tokenizer with ChatML's control tokens and the
    JSON pieces of the constrained tests (every id below the tiny model's
    vocabulary of 300)."""
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer import Tokenizer
    from pie_tpu_torch.tokenizer.control_tokens import CHATML

    specials = CHATML.all_control_tokens
    vocab = {w: i for i, w in enumerate(specials + ["what", "is", "this", "<unk>"])}
    for p in JSON_PIECES:
        vocab.setdefault(p, len(vocab))
    raw = RawTok(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    return Tokenizer(transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token=None, eos_token="<|im_end|>",
        unk_token="<unk>"), CHATML)


@pytest.fixture(scope="module")
def engines():
    """Both port engines on the tiny Qwen2-VL's HF weights (f32), with a
    processor whose 8 x 8 images are one merged token each."""
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine

    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    model = _port()
    params = model.from_hf_state_dict({k: v.detach() for k, v in hf.state_dict().items()},
                                      dtype=torch.float32)
    tok = _chatml_tokenizer()
    single = InferenceEngine(model=model, params=params, tokenizer=tok, max_seq_len=64,
                             kv_dtype=torch.float32, decode_chunk=4, prompt_cache=False,
                             device="cpu")
    batched = BatchedInferenceEngine(model=model, params=params, tokenizer=tok,
                                     num_lanes=4, num_pages=32, max_pages_per_seq=8,
                                     prefill_chunk=16, kv_dtype=torch.float32,
                                     device="cpu")
    proc = tv.Qwen2VLImageProcessor(image_size=8, patch_size=4)
    assert proc.tokens_per_image == 1
    for e in (single, batched):
        assert isinstance(e.image_processor, tv.Qwen2VLImageProcessor)
        e.image_processor = proc
    yield single, batched
    batched.shutdown()


MSG = [{"role": "user", "text": "what is this", "images": [_data_uri(3, (8, 8)),
                                                          _data_uri(4, (8, 8))]}]


def test_chat_with_images_on_both_engines(engines):
    """Two images in one message: the template expands one placeholder per
    merged token, the batched engine's tokens equal the single stream's,
    and the images change the output."""
    single, batched = engines
    want = single.chat(MSG, max_completion_tokens=6, temperature=0.0)
    got = batched.chat(MSG, max_completion_tokens=6, temperature=0.0)
    assert want.metadata["token_ids"] == got.metadata["token_ids"]
    assert want.metadata["completion_tokens"] >= 1
    other = [dict(MSG[0], images=[_data_uri(8, (8, 8)), _data_uri(9, (8, 8))])]
    assert single.chat(other, max_completion_tokens=6,
                       temperature=0.0).metadata["token_ids"] != want.metadata["token_ids"]


def test_image_chat_refusals(engines):
    """An unreadable image, and constrained decoding on an image prompt,
    are refused; a text model refuses images."""
    single, _ = engines
    with pytest.raises(InferenceError, match="image"):
        single.chat([{"role": "user", "text": "what", "images": ["data:image/png;base64,AAAA"]}],
                    max_completion_tokens=2)
    with pytest.raises(InferenceError, match="image"):
        single.chat(MSG, response_format={"type": "json_object"}, max_completion_tokens=4)
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

    llama = LlamaModel(LlamaConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=2, num_key_value_heads=1,
                                   vocab_size=300))
    text = InferenceEngine(model=llama, params=llama.init_params(dtype=torch.float32,
                                                                 device="cpu"),
                           tokenizer=single.tokenizer, max_seq_len=32, device="cpu")
    with pytest.raises(InferenceError, match="image"):
        text.chat(MSG, max_completion_tokens=2)


@pytest.mark.parametrize("backend", ["single", "batched"])
def test_server_chat_with_image(engines, backend):
    """The OpenAI wire shape (a text part and an image_url part with a PNG
    data URI) through create_app: 200, the engine's own tokens, usage."""
    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    engine = dict(zip(("single", "batched"), engines))[backend]
    want = engines[0].chat([dict(MSG[0], images=MSG[0]["images"][:1])],
                           max_completion_tokens=4, temperature=0.0)
    app = create_app(engine=engine, settings=Settings(batching=backend == "batched"),
                     device="cpu")

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "what is this"},
                    {"type": "image_url", "image_url": {"url": MSG[0]["images"][0]}}]}],
                "max_completion_tokens": 4, "temperature": 0.0})
            return resp.status, await resp.json()
        finally:
            await client.close()

    status, body = asyncio.run(run())
    assert status == 200, body
    assert body["choices"][0]["message"]["content"] == want.text
    assert body["usage"]["completion_tokens"] == want.metadata["completion_tokens"]


# enums and a boolean: a greedy random model closes every value
SCHEMA = {"type": "object", "properties": {"name": {"enum": ["alpha", "beta"]},
                                           "ok": {"type": "boolean"}},
          "required": ["name", "ok"], "additionalProperties": False}


def test_json_schema_chat_on_qwen(engines):
    """A json_schema chat on the tiny Qwen2-VL (M-RoPE text decoding
    through the constrained path) on both engines: valid JSON of the
    schema (a logit bias against the space token keeps the greedy random
    model from padding a value with whitespace to the budget)."""
    space = engines[0].tokenizer.token_to_id(" ")
    for engine in engines:
        inter = engine.chat([{"role": "user", "text": "what is this"}],
                            response_format={"type": "json_schema",
                                             "json_schema": {"name": "t", "schema": SCHEMA}},
                            max_completion_tokens=64, temperature=0.0,
                            logit_bias={space: -100.0})
        data = json.loads(inter.text)
        assert data["name"] in ("alpha", "beta") and isinstance(data["ok"], bool)
