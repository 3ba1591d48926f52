"""The port's Qwen2-VL / Qwen2.5-VL (pie_tpu_torch.models.qwen2_vl) on the
CPU: the cases of tests/test_qwen2vl_parity.py, tests/test_qwen25_vision.py
and tests/test_qwen2vl_batching.py (HF logits parity for text and for an
image prompt, both vision towers against HF, the window order, the
batched engine on image prompts equal to the single stream and to HF's
greedy generate with true M-RoPE), and the port against the JAX package
on the same weights: ``mrope_positions``, both towers, the logits of
``__call__`` (bf16 and INT8 caches), ``paged_forward`` and
``mixed_forward`` in bf16 and with INT4 g64 weights, with image riders
and nonzero decode offsets and the JAX decode lanes through its Pallas
kernel in interpret mode; the greedy streams of both engines on an image
prompt against the JAX engines'; the registry (``qwen2_5_vl`` resolves in
the port, where the JAX registry raises)."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("transformers.models.qwen2_vl")
pytest.importorskip("transformers.models.qwen2_5_vl")

import pie_tpu.models.qwen2_vl as jq
import pie_tpu.ops.paged_attention as jpa
from pie_tpu.cache import paged as jpaged
from pie_tpu.cache.kv_cache import KVCache as JKVCache
from pie_tpu.cache.kv_cache import QuantizedKVCache as JQKVCache
from pie_tpu_torch.cache import paged as tpaged
from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.models.llama import from_jax_params
from pie_tpu_torch.models.qwen2_vl import (
    Qwen2VisionTower,
    Qwen2VLConfig,
    Qwen2VLModel,
    apply_mrope,
    image_positions,
    mrope_positions,
    text_positions3,
)

from test_torch_llama import jax_to_np

# tests/test_qwen2vl_parity.py's tiny Qwen2-VL: patch 4, merge 2
VLM_TINY = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=300,
    rms_norm_eps=1e-6, rope_theta=1000000.0, max_position_embeddings=256,
    tie_word_embeddings=False,
    rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
    image_token_id=290, video_token_id=291, vision_start_token_id=292,
    vision_end_token_id=293,
    vision_config=dict(depth=2, embed_dim=32, num_heads=4, hidden_size=64,
                       in_channels=3, patch_size=4, temporal_patch_size=2,
                       spatial_merge_size=2, mlp_ratio=2),
)
# tests/test_qwen25_vision.py's Qwen2.5 tower: 3x3 windows of 2x2 merge
# units on a 12x12 grid, full attention at block 3
VCFG25 = dict(depth=4, hidden_size=64, out_hidden_size=32, intermediate_size=128,
              num_heads=4, patch_size=2, temporal_patch_size=2, spatial_merge_size=2,
              window_size=8, fullatt_block_indexes=[3], in_channels=3)
GRID25 = np.array([[1, 12, 12]])
GRID = np.array([[1, 4, 4]])  # 16 patches -> 4 merged tokens
PDIM = 3 * 2 * 4 * 4
IMAGE_PROMPT = [5, 292, 290, 290, 290, 290, 293, 9, 11]


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


def _pixels(seed, n=16, pdim=PDIM):
    return np.random.default_rng(seed).standard_normal((n, pdim)).astype(np.float32)


def _port(cfg=VLM_TINY):
    return Qwen2VLModel(Qwen2VLConfig.from_dict(dict(cfg, model_type="qwen2_vl")))


def _forward(model, params, ids, cache, first, **kw):
    b, t = ids.shape
    f = torch.full((b,), first, dtype=torch.int32)
    pos = f[:, None] + torch.arange(t, dtype=torch.int32)[None, :]
    with torch.no_grad():
        return model(params, torch.as_tensor(ids), cache.advance(f, t), pos, **kw)


@pytest.fixture(scope="module")
def hf_setup():
    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    hf.eval()
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    model = _port()
    return hf, sd, model, model.from_hf_state_dict(sd, dtype=torch.float32)


def test_text_logits_match_hf(hf_setup):
    hf, _, model, params = hf_setup
    ids = np.random.default_rng(0).integers(0, 280, (2, 10))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
    got, _ = _forward(model, params, ids, make_kv_cache(2, 2, 16, 2, 16, torch.float32,
                                                        device="cpu"), 0)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)


def test_image_logits_match_hf(hf_setup):
    """One image's 4 merged tokens between vision start / end: the tower,
    the scatter and the t/h/w streams against HF."""
    hf, _, model, params = hf_setup
    ids = np.array([IMAGE_PROMPT[:8]])
    px = _pixels(1)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), pixel_values=torch.tensor(px),
                  image_grid_thw=torch.tensor(GRID)).logits.numpy()
    p3, _ = image_positions(model, ids, GRID, ids.shape[1])
    got, _ = _forward(model, params, ids, make_kv_cache(2, 1, 16, 2, 16, torch.float32,
                                                        device="cpu"), 0,
                      pixel_values=torch.tensor(px), grid_thw=GRID,
                      positions3=torch.from_numpy(p3))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


@pytest.fixture(scope="module")
def tower25():
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
        Qwen2_5_VLVisionConfig,
    )
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VisionTransformerPretrainedModel,
    )

    torch.manual_seed(0)
    hf = Qwen2_5_VisionTransformerPretrainedModel(Qwen2_5_VLVisionConfig(**VCFG25))
    hf.eval()
    sd = {"visual." + k: v.detach() for k, v in hf.state_dict().items()}
    tower = Qwen2VisionTower(VCFG25)
    return hf, sd, tower, tower.from_hf_state_dict(sd, dtype=torch.float32)


@pytest.mark.parametrize("variant", ["qwen2", "qwen2_5"])
def test_towers_match_hf(hf_setup, tower25, variant):
    """Both towers against HF's (2e-4): the Qwen2-VL tower (LayerNorm,
    quick-GELU MLP, full attention) of the tiny model, and the Qwen2.5-VL
    tower (RMSNorm, gated SiLU, 3x3 windows, full attention at block 3)."""
    if variant == "qwen2":
        hf, _, model, params = hf_setup
        tower, vp, grid, px = model.vision, params["vision"], GRID, _pixels(2)
        hf_tower = hf.model.visual
    else:
        hf_tower, _, tower, vp = tower25
        grid, px = GRID25, _pixels(0, 144, 3 * 2 * 2 * 2)
    with torch.no_grad():
        want = hf_tower(torch.from_numpy(px), grid_thw=torch.from_numpy(grid))
        got = tower.forward(vp, torch.from_numpy(px), grid)
    want = getattr(want, "pooler_output", want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_windows_order_and_differ_from_full(tower25):
    """The merge-unit permutation is a bijection grouping whole windows, and
    running every block with full attention changes the output."""
    _, _, tower, vp = tower25
    order, win_seg, frame_seg = tower._window_order(GRID25)
    assert sorted(order.tolist()) == list(range(36))
    assert np.all(np.diff(win_seg) >= 0) and frame_seg.max() == 0
    px = torch.from_numpy(_pixels(0, 144, 24))
    full = Qwen2VisionTower(dict(VCFG25, fullatt_block_indexes=[0, 1, 2, 3]))
    with torch.no_grad():
        diff = (tower.forward(vp, px, GRID25) - full.forward(vp, px, GRID25)).abs().max()
    assert diff > 1e-3


def test_mrope_positions_equal_jax():
    """Prompts with several images of several grids, video runs left as
    text: element for element equal to JAX's streams, and the decode
    offset the engines derive."""
    rng = np.random.default_rng(4)
    grids = np.array([[1, 4, 4], [1, 8, 4], [2, 4, 8]])
    for trial in range(6):
        pieces = []
        for g in grids[: 1 + trial % 3]:
            pieces += list(rng.integers(0, 280, rng.integers(0, 4)))
            pieces += [292] + [290] * int(np.prod(g) // 4) + [293]
        pieces += list(rng.integers(0, 280, 3))
        ids = np.array([pieces])
        grid = grids[: 1 + trial % 3]
        want = jq.mrope_positions(ids, 290, grid)
        got = mrope_positions(ids, 290, grid)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        p3, delta = image_positions(_port(), ids, grid, ids.shape[1])
        assert np.array_equal(p3, want) and delta == ids.shape[1] - (want.max() + 1)
    assert np.array_equal(mrope_positions(ids, 290, None), jq.mrope_positions(ids, 290, None))
    # M-RoPE itself on those streams: the port's tables against JAX's
    x = np.random.default_rng(5).standard_normal((1, ids.shape[1], 4, 16)).astype(np.float32)
    inv = np.asarray(jq.Qwen2VLModel(jq.Qwen2VLConfig(head_dim=16)).inv_freq)
    want = np.asarray(jq.apply_mrope(jnp.asarray(x), jnp.asarray(jq.mrope_positions(
        ids, 290, grid)), jnp.asarray(inv), (2, 3, 3)))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(mrope_positions(ids, 290, grid)),
                      torch.from_numpy(inv), (2, 3, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the port against the JAX package on the same weights ----------------------

WEIGHTS = ("bf16", "int4_g64")
# bf16 weights keep activations in bf16 and INT4 weights round each matmul
# input to bf16, at the JAX cast points in both packages (the bound of
# tests/test_torch_llama.py and tests/test_torch_gemma3.py)
TOL = 1e-2


def _jax_model(cfg=VLM_TINY):
    return jq.Qwen2VLModel(jq.Qwen2VLConfig.from_dict(dict(cfg, model_type="qwen2_vl")))


@pytest.fixture(scope="module")
def jax_tower():
    """A JAX tower (its HF weights, f32) and the port's, same weights."""
    torch.manual_seed(1)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jm = _jax_model()
    return jm, jm.vision.from_hf_state_dict(sd, dtype=jnp.float32), sd


@pytest.mark.parametrize("variant", ["qwen2", "qwen2_5"])
def test_towers_match_jax(jax_tower, tower25, variant):
    """The port's towers against JAX's on the same weights (2e-4); the
    Qwen2-VL tower with the exact GELU the JAX tower always uses."""
    if variant == "qwen2":
        jm, jvp, _ = jax_tower
        vcfg = dict(VLM_TINY["vision_config"], hidden_act="gelu")
        grid, px = GRID, _pixels(3)
        jt = jm.vision
    else:
        _, sd, _, _ = tower25
        vcfg, grid, px = VCFG25, GRID25, _pixels(5, 144, 24)
        jt = jq.Qwen2VisionTower(VCFG25)
        jvp = jt.from_hf_state_dict({k: v.numpy() for k, v in sd.items()},
                                    dtype=jnp.float32)
    want = np.asarray(jt.forward(jvp, jnp.asarray(px), grid))
    tower = Qwen2VisionTower(vcfg)
    with torch.no_grad():
        got = tower.forward(from_jax_params(jax_to_np(jvp), "cpu"), torch.from_numpy(px),
                            grid).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def build_pair(weights, seed=3):
    """(JAX model, JAX params, port model, port params): JAX's random text
    init in bf16 or f32 (then JAX's INT4 g64 quantizer), random biases and
    norms, a larger embedding, and the tiny model's HF tower (f32)."""
    jm = _jax_model()
    dtype = jnp.bfloat16 if weights == "bf16" else jnp.float32
    jp = jm.init_params(jax.random.PRNGKey(seed), dtype=dtype)
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        jp["layers"][k] = jnp.asarray(rng.normal(0, 0.5, jp["layers"][k].shape), dtype)
    for k in ("ln1", "ln2"):
        jp["layers"][k] = jnp.asarray(rng.normal(1, 0.3, jp["layers"][k].shape), dtype)
    jp["embed"] = jp["embed"] * 20
    torch.manual_seed(seed)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    jp["vision"] = jm.vision.from_hf_state_dict(
        {k: v.detach().numpy() for k, v in hf.state_dict().items()}, dtype=jnp.float32)
    if weights == "int4_g64":
        jp = jm.quantize_params(jp, group_size=64, bits=4)
    tm = _port(dict(VLM_TINY, vision_config=dict(VLM_TINY["vision_config"],
                                                   hidden_act="gelu")))
    return jm, jp, tm, from_jax_params(jax_to_np(jp), "cpu")


# bf16 weights over a bf16 cache, INT4 weights over an INT8 one
CASES = [("bf16", False), ("int4_g64", True)]


@pytest.mark.parametrize("weights,quantized", CASES)
def test_call_matches_jax(weights, quantized):
    """``__call__`` over a contiguous bf16 or INT8 cache: an image prompt
    padded to 16 (the tower, the scatter, the t/h/w streams), then two
    decode steps at the prompt's offset."""
    jm, jp, tm, tp = build_pair(weights)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if weights == "bf16"
                else (jnp.float32, torch.float32))
    jc = (JQKVCache if quantized else JKVCache).create(2, 1, 32, 2, 16, jdt)
    tc = make_kv_cache(2, 1, 32, 2, 16, tdt, quantized=quantized, device="cpu")
    n = len(IMAGE_PROMPT)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :n] = IMAGE_PROMPT
    px = _pixels(6)
    p3, delta = image_positions(tm, ids, GRID, n)
    assert delta > 0
    vl = jnp.full((1,), n, jnp.int32)
    jemb = jm.embed_with_images(jp, jnp.asarray(ids), jnp.asarray(px), GRID)
    jc = jc.advance(jnp.zeros((1,), jnp.int32), 16, valid_lens=vl)
    lj, jc = jm(jp, jnp.asarray(ids), jc, jnp.arange(16)[None], inputs_embeds=jemb,
                positions3=jnp.asarray(p3), valid_lens=vl)
    jc = jc.trim_to(vl)
    with torch.no_grad():
        temb = tm.embed_with_images(tp, torch.from_numpy(ids), torch.from_numpy(px), GRID)
    tvl = torch.full((1,), n, dtype=torch.int32)
    tc = tc.advance(torch.zeros((1,), dtype=torch.int32), 16, valid_lens=tvl)
    with torch.no_grad():
        lt, tc = tm(tp, torch.from_numpy(ids), tc, torch.arange(16, dtype=torch.int32)[None],
                    inputs_embeds=temb, positions3=torch.from_numpy(p3), valid_lens=tvl)
    tc = tc.trim_to(tvl)
    assert _norm_err(lt[0, :n].float().numpy(), np.asarray(lj)[0, :n]) < TOL
    tok = int(np.asarray(lj)[0, n - 1].argmax())
    for pos in range(n, n + 2):
        f = jnp.full((1,), pos, jnp.int32)
        jc = jc.advance(f, 1)
        rope = jnp.full((1, 1), pos - delta, jnp.int32)
        lj, jc = jm(jp, jnp.full((1, 1), tok, jnp.int32), jc, f[:, None],
                    positions3=jq.text_positions3(rope))
        lt, tc = _forward(tm, tp, np.full((1, 1), tok), tc, pos,
                          positions3=text_positions3(torch.full((1, 1), pos - delta,
                                                                dtype=torch.int32)))
        assert _norm_err(lt.float().numpy(), np.asarray(lj)) < TOL, pos
        tok = int(np.asarray(lj)[0, 0].argmax())


@pytest.fixture
def jax_pallas_decode(monkeypatch):
    """The JAX Qwen2-VL paged forwards as on the TPU: their decode lanes run
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

    monkeypatch.setattr(jq, "jax", TpuJax())
    monkeypatch.setattr(jpa, "paged_attention_decode", interpreted)
    return calls


PAGES, MAXP = 16, 3
TABLES = np.array([[3, 7, -1], [12, 0, 5], [9, -1, -1]], np.int32)


class PagedPair:
    """The JAX and port models on the same weights, with pools of both,
    fed the same numpy inputs."""

    def __init__(self, weights, quantized):
        self.jm, self.jp, self.tm, self.tp = build_pair(weights)
        self.jpool = jpaged.PagedKVPool.create(2, PAGES, 2, 16, jnp.bfloat16, quantized)
        self.tpool = tpaged.PagedKVPool.create(2, PAGES, 2, 16, torch.bfloat16,
                                               quantized, device="cpu")

    def paged(self, ids, pos, ctx, rows, delta=None):
        bt = TABLES[rows]
        kw = {} if delta is None else {"pos_delta": delta}
        lj, self.jpool = self.jm.paged_forward(
            self.jp, jnp.asarray(ids), self.jpool, jnp.asarray(bt), jnp.asarray(pos),
            jnp.asarray(ctx), **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            lt, _ = self.tm.paged_forward(
                self.tp, torch.from_numpy(ids), self.tpool, torch.from_numpy(bt),
                torch.from_numpy(pos), torch.from_numpy(ctx),
                **{k: torch.from_numpy(v) for k, v in kw.items()})
        return np.asarray(lj), lt.float().numpy()

    def mixed(self, dec_tok, dec_pos, dec_ctx, pf_ids, pf_pos, pf_lane, pf_ctx,
              delta, pf_pos3, pf_embeds=None):
        a = lambda x: np.asarray(x, np.int32)
        jkw = dict(pos_delta=jnp.asarray(a(delta)), pf_pos3=jnp.asarray(a(pf_pos3)))
        tkw = dict(pos_delta=torch.from_numpy(a(delta)),
                   pf_pos3=torch.from_numpy(a(pf_pos3)))
        if pf_embeds is not None:
            jkw["pf_embeds"] = jnp.asarray(pf_embeds)
            tkw["pf_embeds"] = torch.from_numpy(pf_embeds)
            if (pf_embeds == 7.0).all():  # stale: the ids' embeddings apply
                jkw["pf_embeds_valid"] = jnp.asarray(False)
                tkw["pf_embeds_valid"] = torch.tensor(False)
        lj, self.jpool = self.jm.mixed_forward(
            self.jp, self.jpool, jnp.asarray(a(dec_tok)), jnp.asarray(a(dec_pos)),
            jnp.asarray(a(dec_ctx)), jnp.asarray(TABLES), jnp.asarray(a(pf_ids)),
            jnp.asarray(a(pf_pos)), jnp.int32(pf_lane), jnp.int32(pf_ctx), **jkw)
        t = lambda x: torch.from_numpy(a(x))
        with torch.no_grad():
            lt, _ = self.tm.mixed_forward(
                self.tp, self.tpool, t(dec_tok), t(dec_pos), t(dec_ctx),
                torch.from_numpy(TABLES), t(pf_ids), t(pf_pos), t([pf_lane]),
                t([pf_ctx]), pf_any=bool((a(pf_ids) >= 0).any()), **tkw)
        return np.asarray(lj), lt.float().numpy()


@pytest.mark.parametrize("weights,quantized", CASES)
def test_paged_forward_matches_jax(jax_pallas_decode, weights, quantized):
    """A padded prefill chunk of lanes 0 and 1 (40 and 20 tokens), then
    two decode steps with nonzero offsets (lane 1 frozen at the second),
    the JAX lanes through its Pallas kernel (group 2)."""
    pr = PagedPair(weights, quantized)
    lens = np.array([40, 20])
    pos = np.where(np.arange(40)[None] < lens[:, None], np.arange(40)[None], -1)
    pos = pos.astype(np.int32)
    ids = np.where(pos >= 0, np.random.default_rng(0).integers(0, 280, (2, 40)), 0)
    lj, lt = pr.paged(ids.astype(np.int32), pos, lens.astype(np.int32), [0, 1])
    assert _norm_err(lt[pos >= 0], lj[pos >= 0]) < TOL
    ctx = lens.astype(np.int32)
    tok = ids[np.arange(2), ctx - 1].astype(np.int32)
    delta = np.array([9, 3], np.int32)
    for step in range(2):
        frozen = np.array([False, step == 1])
        dpos = np.where(frozen, -1, ctx).astype(np.int32)
        dctx = np.where(frozen, 1, ctx + 1).astype(np.int32)
        lj, lt = pr.paged(tok[:, None], dpos[:, None], dctx, [0, 1], delta)
        assert _norm_err(lt[~frozen], lj[~frozen]) < TOL, step
        tok = lj[:, 0].argmax(-1).astype(np.int32)
        ctx = np.where(frozen, ctx, ctx + 1).astype(np.int32)
    assert len(jax_pallas_decode) == 2


@pytest.mark.parametrize("weights", WEIGHTS)
def test_mixed_forward_matches_jax(jax_pallas_decode, weights):
    """Lanes 0 and 1 decode at nonzero offsets while lane 2's image prompt
    rides as embeddings with its t/h/w streams; then lane 2 decodes at its
    offset beside a text rider for lane 1's table (stale embeddings passed
    with ``pf_embeds_valid`` False: its ids' apply); then an empty rider."""
    pr = PagedPair(weights, True)
    lens = np.array([40, 20])
    pos = np.where(np.arange(40)[None] < lens[:, None], np.arange(40)[None], -1)
    prompts = np.random.default_rng(1).integers(0, 280, (2, 40))
    pr.paged(np.where(pos >= 0, prompts, 0).astype(np.int32), pos.astype(np.int32),
             lens.astype(np.int32), [0, 1])
    n = len(IMAGE_PROMPT)
    ids = np.array([IMAGE_PROMPT])
    emb = np.asarray(pr.jm.embed_with_images(pr.jp, jnp.asarray(ids),
                                             jnp.asarray(_pixels(7)), GRID),
                     np.float32)[0]
    p3, delta = image_positions(pr.tm, ids, GRID, n)
    cs = 12
    rider, rpos = np.full(cs, -1), np.full(cs, -1)
    rider[:n - 1], rpos[:n - 1] = IMAGE_PROMPT[:n - 1], np.arange(n - 1)
    rp3 = np.full((3, cs), -1)
    rp3[:, :n - 1] = p3[:, 0, :n - 1]
    remb = np.zeros((cs, emb.shape[1]), np.float32)
    remb[:n - 1] = emb[:n - 1]
    text, tpos = np.full(cs, -1), np.full(cs, -1)
    text[:4], tpos[:4] = [7, 8, 9, 10], np.arange(20, 24)
    tp3 = np.where(tpos >= 0, tpos, -1)[None].repeat(3, 0)
    none3 = np.full((3, cs), -1)
    stale = np.full((cs, emb.shape[1]), 7.0, np.float32)  # marked invalid below
    steps = [  # dec tokens / positions / ctx, rider, lane, ctx, deltas, streams
        ([11, 12, 0], [40, 20, -1], [41, 21, 1], rider, rpos, 2, n - 1, [5, 2, 0], rp3,
         remb),
        ([13, 0, IMAGE_PROMPT[-1]], [41, -1, n - 1], [42, 1, n], text, tpos, 1, 24,
         [5, 2, delta], tp3, stale),
        ([14, 15, 16], [42, 24, n], [43, 25, n + 1], np.full(cs, -1), np.full(cs, -1),
         0, 0, [5, 2, delta], none3, None),
    ]
    for i, (dt, dp, dc, pi, pp, lane, pctx, dl, p3s, pe) in enumerate(steps):
        lj, lt = pr.mixed(dt, dp, dc, pi, pp, lane, pctx, dl, p3s, pe)
        live = np.asarray(dp) >= 0
        assert _norm_err(lt[live], lj[live]) < TOL, i
    assert len(jax_pallas_decode) == 3


# -- engines: greedy streams against the JAX engines and HF --------------------


@pytest.fixture(scope="module")
def engine_pair():
    """JAX and port single-stream and batched engines on the tiny model's
    HF weights (f32), and HF's model."""
    from pie_tpu.engine import InferenceEngine as JEngine
    from pie_tpu.engine.async_engine import BatchedInferenceEngine as JBatched
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine

    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    hf.eval()
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    jm = _jax_model()
    jp = jm.from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, dtype=jnp.float32)
    tm = _port()
    tp = tm.from_hf_state_dict(sd, dtype=torch.float32)
    kw = dict(max_seq_len=64, decode_chunk=4, prompt_cache=False)
    bkw = dict(num_lanes=4, num_pages=32, max_pages_per_seq=8, prefill_chunk=16)
    engines = dict(
        jax=JEngine(model=jm, params=jp, kv_dtype=jnp.float32, **kw),
        port=InferenceEngine(model=tm, params=tp, kv_dtype=torch.float32,
                             device="cpu", **kw),
        jax_batched=JBatched(model=jm, params=jp, **bkw),
        port_batched=BatchedInferenceEngine(model=tm, params=tp, kv_dtype=torch.float32,
                                            device="cpu", **bkw),
    )
    jb = engines["jax_batched"].core  # an f32 pool, as the port's
    jb.pool = dataclasses.replace(jb.pool, k=jb.pool.k.astype(jnp.float32),
                                  v=jb.pool.v.astype(jnp.float32))
    yield engines, hf
    engines["jax_batched"].shutdown()
    engines["port_batched"].shutdown()


def _image_kw(seed, new=10):
    return dict(max_completion_tokens=new, temperature=0.0, pixel_values=_pixels(seed),
                image_kwargs={"grid_thw": GRID})


def test_engine_streams_match_jax_and_hf(engine_pair):
    """Greedy streams on an image prompt: the port's single-stream engine
    and the batched one (an f32 pool) equal HF's generate (true M-RoPE)
    and their JAX twins."""
    engines, hf = engine_pair
    kw = _image_kw(7)
    with torch.no_grad():
        out = hf.generate(input_ids=torch.tensor([IMAGE_PROMPT]),
                          pixel_values=torch.tensor(kw["pixel_values"]),
                          image_grid_thw=torch.tensor(GRID), max_new_tokens=10,
                          do_sample=False)
    want = out[0, len(IMAGE_PROMPT):].tolist()
    got = {name: e.generate(IMAGE_PROMPT, **kw).token_ids for name, e in engines.items()}
    assert got["port"] == want == got["jax"]
    assert got["port_batched"] == got["jax_batched"] == want


def test_image_lane_equals_the_request_alone(engine_pair):
    """An image request decoding beside three text lanes (submitted
    together, so its slices ride mixed steps with theirs) yields the tokens
    it yields alone, and so does each text lane."""
    engines, _ = engine_pair
    batched = engines["port_batched"]
    reqs = [(IMAGE_PROMPT, _image_kw(8, 8))] + [
        ([5 + i, 9, 17, 23 + i], dict(max_completion_tokens=8, temperature=0.0))
        for i in range(3)]
    alone = [batched.generate(p, **kw).token_ids for p, kw in reqs]
    results = {}

    def run(i):
        results[i] = batched.generate(reqs[i][0], **reqs[i][1]).token_ids

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [results[i] for i in range(len(reqs))] == alone
    assert alone[0] == engines["port"].generate(IMAGE_PROMPT, **_image_kw(8, 8)).token_ids


def test_image_prompt_leaves_the_prompt_cache_claiming_nothing():
    """An image prompt overwrites the cache from slot 0: after it, a text
    prompt sharing the previous text request's prefix prefills from the
    start and decodes what a fresh engine decodes."""
    from pie_tpu_torch.engine import InferenceEngine

    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(transformers.Qwen2VLConfig(**VLM_TINY))
    tm = _port()
    tp = tm.from_hf_state_dict({k: v.detach() for k, v in hf.state_dict().items()},
                               dtype=torch.float32)
    make = lambda cache: InferenceEngine(model=tm, params=tp, kv_dtype=torch.float32,
                                         max_seq_len=64, decode_chunk=4,
                                         prompt_cache=cache, device="cpu")
    engine = make(True)
    text = [5, 9, 17, 23, 4, 8, 12, 30, 31, 32]
    engine.generate(text, max_completion_tokens=4, temperature=0.0)
    engine.generate(IMAGE_PROMPT, **_image_kw(9, 4))
    assert engine.prompt_cache.computed_ids == []
    got = engine.generate(text + [40], max_completion_tokens=6, temperature=0.0)
    want = make(False).generate(text + [40], max_completion_tokens=6, temperature=0.0)
    assert got.token_ids == want.token_ids


def test_registry_resolves_qwen2_5_vl_where_jax_raises():
    """Reference defect C3.8: the JAX registry imports a module named after
    the alias ``qwen2_5_vl``, which does not exist; the port resolves both
    names to its Qwen2-VL model."""
    from pie_tpu.models.registry import get_model_class as jax_class
    from pie_tpu_torch.models.registry import get_model_class

    for name in ("qwen2_vl", "qwen2_5_vl"):
        assert get_model_class(name) is Qwen2VLModel
    with pytest.raises(ValueError, match="qwen2_5_vl"):
        jax_class("qwen2_5_vl")


def test_qwen_entry_points_default_to_cuda():
    """The random initializers of the decoder and the tower ask for CUDA
    without a device argument and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    model = _port()
    for init in (model.init_params, model.init_quantized_params, model.vision.init_params):
        with pytest.raises(RuntimeError, match="CUDA"):
            init()
    params = model.init_params(seed=1, dtype=torch.float32, device="cpu")
    assert not params["layers"]["bq"].any() and "lm_head" in params
    vp = model.vision.init_params(seed=1, dtype=torch.float32, device="cpu")
    assert vp["blocks"]["qkv_w"].shape[0] == VLM_TINY["vision_config"]["depth"]


def test_gemma3_vision_still_refused():
    """A Gemma-3 config with a vision tower builds its SigLIP tower (no
    longer refused): the tower's geometry from vision_config, the
    projector's from the text width and mm_tokens_per_image, the image
    token from image_token_index, and the square SigLIP processor."""
    from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model, SigLipVision
    from pie_tpu_torch.vision.utils import SiglipImageProcessor, make_image_processor

    cfg = Gemma3Config.from_dict({"model_type": "gemma3", "text_config": {"hidden_size": 64},
                                  "vision_config": {"hidden_size": 32, "image_size": 56},
                                  "mm_tokens_per_image": 4, "image_token_index": 260})
    model = Gemma3Model(cfg)
    assert isinstance(model.vision, SigLipVision)
    assert (model.vision.hidden_size, model.vision.patches, model.vision.text_hidden,
            model.vision.tokens_per_image) == (32, 4, 64, 4)
    assert cfg.image_token_id == 260
    proc = make_image_processor(model)
    assert isinstance(proc, SiglipImageProcessor) and proc.image_size == 56
