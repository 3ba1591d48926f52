"""Checkpoints into the port: the HF mapping (from_hf_state_dict) against
transformers' LlamaForCausalLM, load_model on snapshots written here
against the JAX package's load_model, a bf16 snapshot, the port's GGUF
reader, the hub
resolution, params persistence, and the engines and the server started
from a snapshot directory as `MODEL_PATH=... python -m pie_tpu_torch.server`
does."""

import asyncio
import json
import struct

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")

from pie_tpu.engine import InferenceEngine as JEngine
from pie_tpu.models import gguf as jgguf
from pie_tpu.models.loader import load_model as jload_model
from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
from pie_tpu_torch.models import gguf as tgguf
from pie_tpu_torch.models import loader
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.ops.quant import QuantizedTensor, unpack_codes
from pie_tpu_torch.tokenizer import load_tokenizer
from pie_tpu_torch.tokenizer.control_tokens import LLAMA3

from test_torch_llama import jax_to_np

TINY = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
    rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=128,
    tie_word_embeddings=False,
)
LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 32}
QUANT = {"group_size": 64, "bits": 4}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hf_model(**extra):
    cfg = dict(TINY, **extra)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**cfg, attention_bias=False))
    return model.eval(), cfg


def save_snapshot(path, model, quant=None, shard=False, dtype=torch.float32):
    """save_pretrained (one file, or shards with an index), plus a
    "quantization" block in config.json when ``quant``."""
    model.to(dtype).save_pretrained(path, max_shard_size="100KB" if shard else "5GB")
    if quant:
        cfg = json.loads((path / "config.json").read_text())
        cfg["quantization"] = quant
        (path / "config.json").write_text(json.dumps(cfg))
    return path


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# -- the HF mapping --------------------------------------------------------------


@pytest.mark.parametrize("rope_scaling", [None, LLAMA3_ROPE])
def test_logits_match_hf(rope_scaling):
    """from_hf_state_dict + the port's forward against transformers on the
    same weights, f32 throughout: a 10-token prefill of two sequences."""
    extra = {"rope_scaling": rope_scaling} if rope_scaling else {}
    hf, cfg = hf_model(**extra)
    model = LlamaModel(LlamaConfig.from_dict(dict(cfg, model_type="llama")))
    params = model.from_hf_state_dict(
        {k: v.detach() for k, v in hf.state_dict().items()}, dtype=torch.float32)
    ids = np.random.default_rng(0).integers(0, cfg["vocab_size"], (2, 10))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        cache = make_kv_cache(2, 2, 16, 2, 16, dtype=torch.float32, device="cpu")
        first = torch.zeros(2, dtype=torch.int32)
        pos = torch.arange(10, dtype=torch.int32)[None].repeat(2, 1)
        got, _ = model(params, torch.from_numpy(ids), cache.advance(first, 10), pos)
    assert _norm_err(got.numpy(), want) < 2e-3


# -- load_model against the JAX package's ----------------------------------------


def _assert_params_equal(got, want, path="", code_slack=0.0):
    """Dense tensors exactly; quantized tensors with equal scales and
    biases and equal codes, or codes one step apart in at most a
    ``code_slack`` share of the entries."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _assert_params_equal(g, w, f"{path}.{k}", code_slack)
        elif isinstance(w, QuantizedTensor):
            assert isinstance(g, QuantizedTensor), k
            assert (g.bits, g.group_size, g.shape) == (w.bits, w.group_size, w.shape)
            assert torch.equal(g.scales, w.scales) and torch.equal(g.biases, w.biases), k
            off = (unpack_codes(g.packed, g.bits) - unpack_codes(w.packed, w.bits)).abs()
            assert off.max() <= (1 if code_slack else 0), k
            assert (off > 0).float().mean() <= code_slack, k
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), f"{path}.{k}"


@pytest.mark.parametrize("layout", ["single", "sharded", "single_quantized",
                                    "sharded_quantized_tied"])
def test_load_model_matches_jax(tmp_path, layout):
    """The port's params equal the JAX package's load_model's, carried
    across with from_jax_params. Quantized on load, the port's codes equal
    the JAX quantizer's run eagerly; the JAX loader runs it under jit, where
    XLA's fused arithmetic moves about 0.1 % of codes by one step (the
    port's quantizer, tests/test_torch_quant.py, equals the eager one)."""
    hf, _ = hf_model(tie_word_embeddings="tied" in layout)
    quantized = "quantized" in layout
    snap = save_snapshot(tmp_path / "snap", hf, quant=QUANT if quantized else None,
                         shard="sharded" in layout)
    if "sharded" in layout:
        assert (snap / "model.safetensors.index.json").exists()
    tm, tp = loader.load_model(snap, device="cpu")
    assert tm.config == LlamaConfig.from_dict(
        json.loads((snap / "config.json").read_text()))
    assert ("lm_head" in tp) == (quantized or "tied" not in layout)
    _, jp = jload_model(snap)
    _assert_params_equal(tp, from_jax_params(jax_to_np(jp), "cpu"),
                         code_slack=0.005 if quantized else 0.0)
    if quantized:
        with jax.disable_jit():
            _, jp_eager = jload_model(snap)
        _assert_params_equal(tp, from_jax_params(jax_to_np(jp_eager), "cpu"))


def test_bf16_snapshot_loads_exactly(tmp_path):
    """Published Llama checkpoints are bf16. The port reads them with
    safetensors' torch framework and keeps every value, as the JAX package
    does (its numpy reader holds bf16 only because importing JAX registers
    ml_dtypes' bfloat16 with numpy)."""
    hf, _ = hf_model()
    snap = save_snapshot(tmp_path / "snap", hf, dtype=torch.bfloat16)
    _, tp = loader.load_model(snap, device="cpu")
    sd = hf.state_dict()
    assert tp["embed"].dtype == torch.bfloat16
    assert torch.equal(tp["embed"], sd["model.embed_tokens.weight"])
    assert torch.equal(tp["layers"]["wd"][1], sd["model.layers.1.mlp.down_proj.weight"].T)
    _, jp = jload_model(snap)
    _assert_params_equal(tp, from_jax_params(jax_to_np(jp), "cpu"))


def test_other_families_name_the_roadmap(tmp_path):
    """A Gemma-3 snapshot with a vision tower (HF
    Gemma3ForConditionalGeneration names, bf16, an INT4 g64 quantization
    block) loads: the text decoder's projections INT4 g64, the SigLIP tower
    and its projector bf16 and dense, bit for bit the snapshot's, the image
    token and tokens per image read; Qwen2-VL and Qwen2.5-VL configs build
    their model."""
    from pie_tpu_torch.models.gemma3 import Gemma3Model, SigLipVision
    from pie_tpu_torch.models.qwen2_vl import Qwen2VLModel

    from test_torch_gemma3_vision import VLM_TINY

    torch.manual_seed(0)
    hf = transformers.Gemma3ForConditionalGeneration(transformers.Gemma3Config(**VLM_TINY))
    snap = save_snapshot(tmp_path / "snap", hf, quant=QUANT, dtype=torch.bfloat16)
    model, params = loader.load_model(snap, device="cpu")
    assert isinstance(model, Gemma3Model) and isinstance(model.vision, SigLipVision)
    assert (model.config.image_token_id, model.config.mm_tokens_per_image) == (260, 4)
    for name in Gemma3Model.LINEAR_KEYS:
        q = params["layers"][name]
        assert isinstance(q, QuantizedTensor) and (q.bits, q.group_size) == (4, 64)
    sd = hf.state_dict()
    tower = "model.vision_tower.vision_model."
    vp = params["vision"]
    for got, key in ((vp["patch_w"], "embeddings.patch_embedding.weight"),
                     (vp["pos"], "embeddings.position_embedding.weight"),
                     (vp["encoder"]["wq"][1].T, "encoder.layers.1.self_attn.q_proj.weight"),
                     (vp["encoder"]["fc2_b"][0], "encoder.layers.0.mlp.fc2.bias")):
        assert got.dtype == torch.bfloat16 and torch.equal(got, sd[tower + key])
    assert torch.equal(vp["proj_w"],
                       sd["model.multi_modal_projector.mm_input_projection_weight"])
    for model_type in ("qwen2_vl", "qwen2_5_vl"):
        model = loader.build_model({"model_type": model_type, "hidden_size": 64,
                                    "num_attention_heads": 4})
        assert isinstance(model, Qwen2VLModel) and model.vision is None


def test_qwen2_vl_snapshot_matches_jax(tmp_path):
    """A Qwen2-VL snapshot (bf16, an INT4 g64 quantization block): the
    port's params equal the JAX load_model's carried across, the text
    decoder's projections and head quantized (codes as in
    test_load_model_matches_jax), the tower bf16 and dense, bit for bit; its
    vision_config read. A Qwen2.5-VL snapshot, which the JAX registry
    cannot resolve (ROADMAP C3.8), loads its windowed tower."""
    from pie_tpu_torch.models.qwen2_vl import Qwen2VLModel

    from test_torch_qwen2_vl import VCFG25, VLM_TINY

    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    snap = save_snapshot(tmp_path / "qwen2", hf, quant=QUANT, dtype=torch.bfloat16)
    tm, tp = loader.load_model(snap, device="cpu")
    assert isinstance(tm, Qwen2VLModel) and tm.vision is not None
    assert tm.config.vision["patch_size"] == 4 and tm.config.mrope_section == (2, 3, 3)
    assert isinstance(tp["layers"]["wq"], QuantizedTensor)
    assert isinstance(tp["lm_head"], QuantizedTensor)
    assert tp["layers"]["bq"].dtype == torch.bfloat16
    for name, t in tp["vision"]["blocks"].items():
        assert t.dtype == torch.bfloat16 and not isinstance(t, QuantizedTensor), name
    with jax.disable_jit():
        _, jp = jload_model(snap)
    _assert_params_equal(tp, from_jax_params(jax_to_np(jp), "cpu"))

    torch.manual_seed(1)
    cfg25 = dict(VLM_TINY, vision_config=dict(VCFG25, out_hidden_size=64))
    hf25 = transformers.Qwen2_5_VLForConditionalGeneration(
        transformers.Qwen2_5_VLConfig(**cfg25))
    snap25 = save_snapshot(tmp_path / "qwen25", hf25, dtype=torch.bfloat16)
    tm25, tp25 = loader.load_model(snap25, device="cpu")
    assert tm25.vision.windowed and "gate_w" in tp25["vision"]["blocks"]
    assert torch.equal(tp25["vision"]["patch_w"],
                       hf25.state_dict()["model.visual.patch_embed.proj.weight"])


def test_gemma3_text_resolves():
    from pie_tpu_torch.models.gemma3 import Gemma3Model
    from pie_tpu_torch.models.registry import get_model_class

    assert get_model_class("gemma3_text") is Gemma3Model
    assert get_model_class("gemma3") is Gemma3Model
    model = loader.build_model({"model_type": "gemma3_text", "hidden_size": 64,
                                "sliding_window": 8})
    assert isinstance(model, Gemma3Model) and model.config.sliding_window == 8


GEMMA_TINY = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=7,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=256,
    rms_norm_eps=1e-6, rope_theta=1000000.0, rope_local_base_freq=10000.0,
    sliding_window=8, sliding_window_pattern=6, query_pre_attn_scalar=16,
    max_position_embeddings=128,
    rope_scaling={"rope_type": "linear", "factor": 8.0},
)


def gemma_snapshot(path, quant=None):
    """A tiny HF Gemma3ForCausalLM saved in bf16 (a ``gemma3_text``
    snapshot), with a word-level tokenizer carrying Gemma's control tokens."""
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer.control_tokens import GEMMA

    torch.manual_seed(0)
    hf = transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(**GEMMA_TINY))
    with torch.no_grad():
        hf.model.embed_tokens.weight.mul_(10.0)
    save_snapshot(path, hf.eval(), quant=quant, dtype=torch.bfloat16)
    words = ["hello", "world", "how", "are", "you", "be", "brief", "user", "model",
             "system", "<unk>"]
    specials = GEMMA.all_control_tokens
    raw = RawTok(models.WordLevel({w: i for i, w in enumerate(specials + words)},
                                  unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<bos>", eos_token="<eos>", unk_token="<unk>",
    ).save_pretrained(path)
    return hf.float(), path


def test_gemma3_text_snapshot_matches_hf(tmp_path):
    """load_model serves a bf16 gemma3_text snapshot (HF names, the VLM
    prefixes aside): its logits match HF's on the same weights past the
    sliding window; with a quantization block every projection is INT4
    g64 on load, as the port's quantizer makes it from the dense weights."""
    from pie_tpu_torch.models.gemma3 import Gemma3Model

    hf, snap = gemma_snapshot(tmp_path / "snap")
    model, params = loader.load_model(snap, dtype=torch.float32, device="cpu")
    assert isinstance(model, Gemma3Model)
    ids = np.random.default_rng(0).integers(0, 256, (1, 12))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
        cache = make_kv_cache(7, 1, 16, 2, 16, torch.float32, device="cpu")
        first = torch.zeros(1, dtype=torch.int32)
        got, _ = model(params, torch.tensor(ids), cache.advance(first, 12),
                       torch.arange(12, dtype=torch.int32)[None])
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)

    _, qsnap = gemma_snapshot(tmp_path / "q", quant=QUANT)
    _, qparams = loader.load_model(qsnap, device="cpu")
    want_q = model.quantize_params(
        loader.load_model(snap, device="cpu")[1], 64, 4)
    for name in Gemma3Model.LINEAR_KEYS:
        got_q = qparams["layers"][name]
        assert isinstance(got_q, QuantizedTensor) and got_q.bits == 4
        for f in ("packed", "scales", "biases"):
            assert torch.equal(getattr(got_q, f), getattr(want_q["layers"][name], f))


def test_gemma3_chat_from_model_path(tmp_path):
    """create_app on a gemma3_text snapshot (what ``MODEL_PATH=... python -m
    pie_tpu_torch.server`` builds): the tokenizer is Gemma's, a chat with a
    system message renders with the Gemma template (the system text folded
    into the user turn) and answers 200."""
    from aiohttp.test_utils import TestClient, TestServer

    from pie_tpu_torch.server.app import ENGINE_KEY, create_app
    from pie_tpu_torch.server.config import Settings
    from pie_tpu_torch.tokenizer.control_tokens import GEMMA

    _, snap = gemma_snapshot(tmp_path / "snap")
    app = create_app(settings=Settings(model_path=str(snap), max_seq_len=64),
                     device="cpu")
    tok = app[ENGINE_KEY].tokenizer
    assert tok.control_tokens == GEMMA
    chat = [{"role": "system", "text": "be brief"}, {"role": "user", "text": "hello"}]
    text = tok.decode(tok.apply_chat_template(chat, add_generation_prompt=True))
    assert "be brief" in text and "system" not in text
    assert text.startswith("<bos> <start_of_turn> user be brief hello <end_of_turn>")
    assert text.endswith("<start_of_turn> model")  # words: decoded with spaces

    async def run():
        async with TestClient(TestServer(app)) as client:
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "system", "content": "be brief"},
                             {"role": "user", "content": "hello world"}],
                "max_tokens": 4, "temperature": 0.0})
            return resp.status, await resp.json()

    status, body = asyncio.run(run())
    assert status == 200, body
    assert body["usage"]["prompt_tokens"] == len(tok.apply_chat_template(
        chat[:1] + [{"role": "user", "text": "hello world"}], add_generation_prompt=True))


def test_load_model_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.load_model(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.load_params(tmp_path / "x.safetensors")


def test_hub_resolve_monkeypatched(tmp_path, monkeypatch):
    """Paths that do not exist and look like org/name go through
    huggingface_hub's snapshot_download; local paths pass through."""
    import huggingface_hub

    local = tmp_path / "snap"
    local.mkdir()
    seen = {}

    def fake_snapshot_download(repo_id, **kw):
        seen["repo"] = repo_id
        return str(local)

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    assert loader.resolve_model_path("org/model-name") == local
    assert seen["repo"] == "org/model-name"
    assert loader.resolve_model_path(tmp_path) == tmp_path
    with pytest.raises(FileNotFoundError):
        loader.resolve_model_path("/definitely/not/here")


def test_quantized_params_roundtrip(tmp_path):
    """save_params / load_params keep every tensor (bf16 stays bf16) and the
    loaded params drive the model identically."""
    model = LlamaModel(LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        tie_word_embeddings=False))
    params = model.quantize_params(
        model.init_params(seed=0, dtype=torch.bfloat16, device="cpu"),
        group_size=32, bits=8)
    path = tmp_path / "ckpt.safetensors"
    loader.save_params(params, path)
    loaded = loader.load_params(path, device="cpu")
    for k in params:
        if isinstance(params[k], dict):
            for n in params[k]:
                _assert_same(loaded[k][n], params[k][n])
        else:
            _assert_same(loaded[k], params[k])

    def run(p):
        cache = make_kv_cache(2, 1, 8, 2, 16, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            y, _ = model(p, torch.tensor([[1, 2, 3]]),
                         cache.advance(torch.zeros(1, dtype=torch.int32), 3),
                         torch.tensor([[0, 1, 2]], dtype=torch.int32))
        return y

    assert torch.equal(run(params), run(loaded))


def _assert_same(got, want):
    if isinstance(want, QuantizedTensor):
        assert (got.bits, got.group_size, got.shape) == (want.bits, want.group_size,
                                                         want.shape)
        for f in ("packed", "scales", "biases"):
            assert torch.equal(getattr(got, f), getattr(want, f))
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


# -- GGUF (the writer of tests/test_gguf.py) ---------------------------------------

_T_U32, _T_I32, _T_F32, _T_BOOL, _T_STRING, _T_ARRAY = 4, 5, 6, 7, 8, 9


def _pack_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _pack_value(vtype, value) -> bytes:
    if vtype == _T_U32:
        return struct.pack("<I", value)
    if vtype == _T_I32:
        return struct.pack("<i", value)
    if vtype == _T_F32:
        return struct.pack("<f", value)
    if vtype == _T_BOOL:
        return struct.pack("<B", 1 if value else 0)
    if vtype == _T_STRING:
        return _pack_string(value)
    if vtype == _T_ARRAY:
        etype, values = value
        return struct.pack("<IQ", etype, len(values)) + b"".join(
            _pack_value(etype, v) for v in values)
    raise ValueError(vtype)


def q8_0_encode(x: np.ndarray) -> bytes:
    out = b""
    for blk in x.reshape(-1, 32):
        amax = np.abs(blk).max()
        scale = amax / 127.0 if amax > 0 else 0.0
        q = np.round(blk / scale).astype(np.int8) if scale else np.zeros(32, np.int8)
        out += np.float16(scale).tobytes() + q.tobytes()
    return out


def q4_0_encode(x: np.ndarray) -> bytes:
    out = b""
    for blk in x.reshape(-1, 32):
        maxv = blk[np.abs(blk).argmax()]
        scale = maxv / -8.0 if maxv != 0 else 0.0
        inv = 1.0 / scale if scale else 0.0
        q = np.clip(np.round(blk * inv + 8), 0, 15).astype(np.uint8)
        out += np.float16(scale).tobytes() + (q[:16] | (q[16:] << 4)).astype(np.uint8).tobytes()
    return out


def q4_1_encode(x: np.ndarray) -> bytes:
    out = b""
    for blk in x.reshape(-1, 32):
        mn, mx = blk.min(), blk.max()
        scale = (mx - mn) / 15.0 if mx > mn else 0.0
        inv = 1.0 / scale if scale else 0.0
        q = np.clip(np.round((blk - mn) * inv), 0, 15).astype(np.uint8)
        out += (np.float16(scale).tobytes() + np.float16(mn).tobytes()
                + (q[:16] | (q[16:] << 4)).astype(np.uint8).tobytes())
    return out


def write_gguf(path, metadata, tensors, align=32):
    """tensors: list of (name, shape, gtype, payload_bytes)."""
    buf = struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(metadata))
    for key, (vtype, value) in metadata.items():
        buf += _pack_string(key) + struct.pack("<I", vtype) + _pack_value(vtype, value)
    offset, payloads = 0, []
    for name, shape, gtype, payload in tensors:
        dims = tuple(reversed(shape))
        buf += _pack_string(name) + struct.pack("<I", len(dims))
        buf += struct.pack(f"<{len(dims)}Q", *dims) + struct.pack("<IQ", gtype, offset)
        payloads.append((offset, payload))
        offset += (len(payload) + align - 1) // align * align
    data_start = (len(buf) + align - 1) // align * align
    buf += b"\0" * (data_start - len(buf))
    for off, payload in payloads:
        buf += b"\0" * (data_start + off - len(buf)) + payload
    path.write_bytes(buf)


def test_gguf_metadata_and_plain_tensors(tmp_path):
    """The port's reader returns what the JAX package's does."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(4, 8)).astype(np.float32)
    f16 = rng.normal(size=(2, 16)).astype(np.float16)
    bf = rng.normal(size=(32,)).astype(np.float32)
    path = tmp_path / "t.gguf"
    write_gguf(path, {
        "general.architecture": (_T_STRING, "llama"),
        "general.alignment": (_T_U32, 32),
        "llama.block_count": (_T_U32, 2),
        "llama.rope.freq_base": (_T_F32, 10000.0),
        "some.flag": (_T_BOOL, True),
        "some.list": (_T_ARRAY, (_T_I32, [1, 2, 3])),
    }, [
        ("a", f32.shape, tgguf.GGML_F32, f32.tobytes()),
        ("b", f16.shape, tgguf.GGML_F16, f16.tobytes()),
        ("c", bf.shape, tgguf.GGML_BF16,
         (bf.view(np.uint32) >> 16).astype(np.uint16).tobytes()),
    ])
    md, tensors = tgguf.read_gguf(path)
    assert md["general.architecture"] == "llama" and md["llama.block_count"] == 2
    assert md["some.flag"] is True and md["some.list"] == [1, 2, 3]
    np.testing.assert_array_equal(tensors["a"], f32)
    np.testing.assert_array_equal(tensors["b"].astype(np.float16), f16)
    np.testing.assert_allclose(tensors["c"], bf, rtol=1e-2, atol=1e-2)
    jmd, jtensors = jgguf.read_gguf(path)
    assert jmd == md
    for k in tensors:
        np.testing.assert_array_equal(tensors[k], jtensors[k])


@pytest.mark.parametrize("gtype,encode,tol", [
    (tgguf.GGML_Q8_0, q8_0_encode, 0.01),
    (tgguf.GGML_Q4_0, q4_0_encode, 0.15),
    (tgguf.GGML_Q4_1, q4_1_encode, 0.15),
])
def test_gguf_quant_roundtrip(tmp_path, gtype, encode, tol):
    x = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)
    path = tmp_path / "q.gguf"
    write_gguf(path, {"general.architecture": (_T_STRING, "llama")},
               [("w", x.shape, gtype, encode(x.reshape(-1)))])
    w = tgguf.read_gguf(path)[1]["w"]
    assert w.shape == x.shape
    assert np.abs(w - x).max() <= tol * np.abs(x).max()
    np.testing.assert_array_equal(w, jgguf.read_gguf(path)[1]["w"])


_GGUF_BLOCK = {
    "self_attn.q_proj.weight": "attn_q.weight",
    "self_attn.k_proj.weight": "attn_k.weight",
    "self_attn.v_proj.weight": "attn_v.weight",
    "self_attn.o_proj.weight": "attn_output.weight",
    "mlp.gate_proj.weight": "ffn_gate.weight",
    "mlp.up_proj.weight": "ffn_up.weight",
    "mlp.down_proj.weight": "ffn_down.weight",
    "input_layernorm.weight": "attn_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
}


@pytest.mark.parametrize("tied", [False, True])
def test_gguf_llama_mapping_and_e2e(tmp_path, tied):
    """A tiny llama written as GGUF loads through load_model (tied iff the
    output head is absent) and generates what the same weights do through
    from_hf_state_dict."""
    hf, cfg = hf_model()
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    names = {"model.embed_tokens.weight": "token_embd.weight",
             "model.norm.weight": "output_norm.weight"}
    if not tied:
        names["lm_head.weight"] = "output.weight"
    tensors = []
    for k, v in sd.items():
        if k.startswith("model.layers."):
            _, _, idx, rest = k.split(".", 3)
            names[k] = f"blk.{idx}.{_GGUF_BLOCK[rest]}"
        if k in names:
            tensors.append((names[k], v.shape, tgguf.GGML_F32, v.tobytes()))
    path = tmp_path / "tiny-llama.gguf"
    write_gguf(path, {
        "general.architecture": (_T_STRING, "llama"),
        "llama.embedding_length": (_T_U32, cfg["hidden_size"]),
        "llama.feed_forward_length": (_T_U32, cfg["intermediate_size"]),
        "llama.block_count": (_T_U32, cfg["num_hidden_layers"]),
        "llama.attention.head_count": (_T_U32, cfg["num_attention_heads"]),
        "llama.attention.head_count_kv": (_T_U32, cfg["num_key_value_heads"]),
        "llama.attention.layer_norm_rms_epsilon": (_T_F32, cfg["rms_norm_eps"]),
        "llama.rope.freq_base": (_T_F32, cfg["rope_theta"]),
        "llama.context_length": (_T_U32, cfg["max_position_embeddings"]),
    }, tensors)
    model_g, params_g = loader.load_model(path, dtype=torch.float32, device="cpu")
    assert model_g.config.vocab_size == 256
    assert model_g.config.tie_word_embeddings == tied
    assert ("lm_head" in params_g) == (not tied)
    model_s = LlamaModel(LlamaConfig.from_dict(dict(cfg, model_type="llama",
                                                    tie_word_embeddings=tied)))
    params_s = model_s.from_hf_state_dict(sd, dtype=torch.float32)
    kw = dict(max_seq_len=128, kv_dtype=torch.float32, device="cpu")
    out = [InferenceEngine(model=m, params=p, **kw).generate(
        [5, 17, 42, 7], max_completion_tokens=8, temperature=0.0).token_ids
        for m, p in ((model_g, params_g), (model_s, params_s))]
    assert out[0] == out[1] and len(out[0]) == 8


# -- engines and the server from a snapshot directory -----------------------------


def word_tokenizer_files(path):
    """An offline word-level tokenizer with the Llama-3 control tokens,
    saved beside the weights (the recipe of tests/test_server.py)."""
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    words = ["hello", "world", "how", "are", "you", "fine", "thanks", "user",
             "assistant", "system", "weather", "sunny", "<unk>"]
    specials = LLAMA3.all_control_tokens
    raw = RawTok(models.WordLevel({w: i for i, w in enumerate(specials + words)},
                                  unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>", unk_token="<unk>",
    ).save_pretrained(path)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny INT4-on-load snapshot with a tokenizer. Embedding and head at
    unit scale (50x) make the greedy choices decisive, as in
    tests/test_torch_engine.py."""
    hf, _ = hf_model()
    with torch.no_grad():
        hf.model.embed_tokens.weight.mul_(50.0)
        hf.lm_head.weight.mul_(50.0)
    path = save_snapshot(tmp_path_factory.mktemp("snap"), hf, quant=QUANT)
    word_tokenizer_files(path)
    return path


def test_tokenizer_from_the_directory(snapshot):
    tok = load_tokenizer(snapshot)
    assert tok.control_tokens == LLAMA3
    assert tok.token_to_id("<|eot_id|>") is not None
    ids = tok.encode("hello world", add_bos=True)
    assert tok.decode(ids[1:]) == "hello world"


PROMPT = [20, 21, 22, 23, 24, 30, 40, 50]


def test_engines_from_model_path_match_jax(snapshot):
    """The same greedy stream from the JAX engine and both port engines,
    each loading the snapshot itself (bf16, INT4 g64 on load)."""
    want = JEngine(model_path=str(snapshot), max_seq_len=128).generate(
        PROMPT, max_completion_tokens=12, temperature=0.0, logprobs=True)
    assert min(a.top[0][1] - a.top[1][1] for a in want.logprobs) > 0.1
    single = InferenceEngine(model_path=str(snapshot), max_seq_len=128, device="cpu")
    assert isinstance(single.params["layers"]["wgu"], QuantizedTensor)
    assert single.tokenizer.control_tokens == LLAMA3
    got = single.generate(PROMPT, max_completion_tokens=12, temperature=0.0)
    assert got.token_ids == want.token_ids
    batched = BatchedInferenceEngine(model_path=str(snapshot), num_pages=16,
                                     max_pages_per_seq=4, device="cpu")
    try:
        res = batched.generate(PROMPT, max_completion_tokens=12, temperature=0.0)
    finally:
        batched.shutdown()
    assert res.token_ids == want.token_ids


@pytest.mark.parametrize("batching", [False, True])
def test_create_app_from_model_path(snapshot, batching):
    """create_app builds the engine MODEL_PATH names and answers a chat;
    with BATCHING=1 NATIVE_SCHEDULER=1 the engine runs the native scheduler
    and answers the same chat."""
    from aiohttp.test_utils import TestClient, TestServer

    from pie_tpu_torch.server.app import ENGINE_KEY, create_app
    from pie_tpu_torch.server.config import Settings

    def chat(native):
        settings = Settings(model_path=str(snapshot), batching=batching,
                            max_seq_len=128, native_scheduler=native)
        app = create_app(settings=settings, device="cpu")
        engine = app[ENGINE_KEY]
        assert isinstance(engine, BatchedInferenceEngine) == batching

        async def run():
            async with TestClient(TestServer(app)) as client:
                resp = await client.post("/v1/chat/completions", json={
                    "messages": [{"role": "user", "content": "hello world"}],
                    "max_tokens": 4, "temperature": 0.0})
                return resp.status, await resp.json()

        try:
            status, body = asyncio.run(run())
        finally:
            if batching:
                assert engine.scheduler_impl == ("native" if native else "python")
                engine.shutdown()
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 4
        return body["choices"][0]["message"]["content"]

    text = chat(False)
    if batching:
        assert chat(True) == text
