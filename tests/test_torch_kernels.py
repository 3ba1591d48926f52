"""The hand-written CUDA kernels K1 (decode GEMV, and its ln pre-pass), K2
(prefill GEMM), K3 (paged decode attention), K4 (fused decode MLP block)
and B7 (the read probe) against their plain PyTorch versions, on a CUDA
card. Imports no JAX, so it runs on the card's machine (the conftest
imports JAX: skip it there):
python -m pytest --noconftest tests/test_torch_kernels.py. Elsewhere every
test skips: the kernels have no CPU mode."""

import pytest
import torch

from pie_tpu_torch.ops import fused_mlp as fm
from pie_tpu_torch.ops import paged_attention as pa
from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.rope import rope_qkv_cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _norm_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m", [1, 32, 40, 200, 256])
@pytest.mark.parametrize("bits,group_size", [(4, 64), (4, 32), (4, 128), (8, 64)])
@pytest.mark.parametrize("dh", [64, 128])
def test_kernel_matches_plain(cuda, m, bits, group_size, dh):
    """Both kernels with the rope epilogue at any M (the mixed step's QKV
    projection runs K2 with rope at M = lanes + rider); the ln prologue on
    the decode branch only."""
    hq, hkv, k = 8, 2, 1024
    n = (hq + 2 * hkv) * dh
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = (torch.randn((2, k, n), generator=gen, device=cuda) * 0.05).bfloat16()
    qt = tq.quantize(w, group_size, bits)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    pos = torch.arange(m, device=cuda, dtype=torch.int32) * 5
    inv = torch.rand(dh // 2, generator=gen, device=cuda)
    kw = dict(rope_dim=dh, rope_cs=rope_qkv_cs(pos, inv, hq, hkv, dh))
    if m <= qmc.DECODE_MAX_M:
        lnw = (1 + 0.1 * torch.randn((2, k), generator=gen, device=cuda)).to(torch.bfloat16)
        kw.update(ln_w=lnw, ln_eps=1e-5)
    qmc.reset_counts()
    got = tq.quantized_matmul(x, qt, layer=1, **kw)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K1" if m <= 32 else "K2"] == 1
    want = qmc.quant_matmul_ref(x, qt, layer=1, **kw)
    assert _norm_err(got, want) < 0.025


@pytest.mark.parametrize("m", [1, 8, 32, 40])
def test_kernel_f32_scales(cuda, m):
    """A tied head quantized from the f32 transpose of the embedding keeps
    f32 scales and biases (as in the JAX package): K1 and K2 read them."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn((1024, 640), generator=gen, device=cuda) * 0.05
    qt = tq.quantize(w, 64, 4)
    assert qt.scales.dtype == torch.float32
    x = torch.randn((m, 1024), generator=gen, device=cuda).bfloat16()
    kw = {}
    if m <= qmc.DECODE_MAX_M:
        kw = dict(ln_w=(1 + 0.1 * torch.randn(1024, generator=gen, device=cuda)).bfloat16(),
                  ln_eps=1e-5)
    got = tq.quantized_matmul(x, qt, **kw)
    assert _norm_err(got, qmc.quant_matmul_ref(x, qt, **kw)) < 0.025


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 31, 32])
@pytest.mark.parametrize("bits,group_size", [(4, 32), (4, 64), (4, 128), (8, 32), (8, 64),
                                             (8, 128)])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("ln", [False, True])
def test_k1_matches_plain_across_rows(cuda, m, bits, group_size, dh, ln):
    """K1 alone at every n8 tile edge of its tensor-core product (M = 1-32),
    every format, the rope epilogue on both head widths, with and without
    the ln prologue over a logical K that is not a multiple of the stage
    (K = 1000, padded to 1024), layer 1 of 2; one K1 launch per call, one
    pre-pass launch with the prologue, and a second call gives the same
    bits (the split partials are summed in a fixed order)."""
    hq, hkv, k = 8, 2, 1000
    n = (hq + 2 * hkv) * dh
    gen = torch.Generator(device=cuda).manual_seed(m * 131 + bits * 7 + group_size + dh)
    w = (torch.randn((2, k, n), generator=gen, device=cuda) * 0.05).bfloat16()
    qt = tq.quantize(w, group_size, bits)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    pos = torch.arange(m, device=cuda, dtype=torch.int32) * 3 + 7
    inv = torch.rand(dh // 2, generator=gen, device=cuda)
    kw = dict(rope_dim=dh, rope_cs=rope_qkv_cs(pos, inv, hq, hkv, dh))
    if ln:
        kw.update(ln_w=(1 + 0.1 * torch.randn((2, k), generator=gen, device=cuda)).bfloat16(),
                  ln_eps=1e-5)
    qmc.reset_counts()
    got = qmc.quant_gemv(x, qt, layer=1, **kw)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K1"] == 1 and qmc.launch_counts["K1 ln"] == int(ln)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert _norm_err(got, qmc.quant_matmul_ref(x, qt, layer=1, **kw)) < 0.025
    assert torch.equal(qmc.quant_gemv(x, qt, layer=1, **kw), got)


def test_k1_split_counters_reset(cuda, monkeypatch):
    """Back-to-back K1 calls with different K splits (the narrow wo-like
    tile count split many ways, then a plan forced to fewer splits) each
    leave the arrival counters at zero, and agree with the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = (torch.randn((4096, 1024), generator=gen, device=cuda) * 0.05).bfloat16()
    qt = tq.quantize(w, 64, 4)
    x = torch.randn((8, 4096), generator=gen, device=cuda).bfloat16()
    want = qmc.quant_matmul_ref(x, qt)
    counters = qmc._arrival_counters(cuda, "K1")
    seen = set()
    for blocks_per_sm in (2, 0.05, 0.1, 1):
        monkeypatch.setattr(qmc, "GEMV_BLOCKS_PER_SM", blocks_per_sm)
        qmc.gemv_plan.cache_clear()
        seen.add(qmc.gemv_plan(8, 1024, 4096, 64, sms=qmc._device_sms(cuda)).splits)
        got = qmc.quant_gemv(x, qt)
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        assert _norm_err(got, want) < 0.025
    qmc.gemv_plan.cache_clear()
    assert len(seen) >= 3 and 1 in seen


@pytest.mark.parametrize("m", [1, 8, 32])
def test_k1_in_a_cuda_graph(cuda, m):
    """K1 with the prologue, the rope epilogue and a K split, captured in a
    CUDA graph and replayed over new inputs, matches the eager call; the
    arrival counters are back at zero after each replay."""
    hq, hkv, dh, k = 16, 4, 128, 4096
    n = (hq + 2 * hkv) * dh
    gen = torch.Generator(device=cuda).manual_seed(m)
    qt = tq.quantize((torch.randn((2, k, n), generator=gen, device=cuda) * 0.05).bfloat16(),
                     64, 4)
    assert qmc.gemv_plan(m, n, k, 64, dh, sms=qmc._device_sms(cuda)).splits > 1
    lnw = (1 + 0.1 * torch.randn((2, k), generator=gen, device=cuda)).bfloat16()
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    pos = torch.arange(m, device=cuda, dtype=torch.int32) + 11
    cs = rope_qkv_cs(pos, torch.rand(dh // 2, generator=gen, device=cuda), hq, hkv, dh)
    kw = dict(ln_w=lnw, ln_eps=1e-5, rope_cs=cs, rope_dim=dh)
    qmc.quant_gemv(x, qt, layer=1, **kw)  # warm-up: build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmc.quant_gemv(x, qt, layer=1, **kw)
    for seed in range(3):
        x.copy_(torch.randn((m, k), generator=gen, device=cuda).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, qmc.quant_gemv(x, qt, layer=1, **kw))
        assert int(qmc._arrival_counters(cuda, "K1").abs().sum()) == 0


def test_k1_ln_pre_pass(cuda):
    """The prologue alone equals the plain version's normalized rows (the
    same f32 arithmetic, one bf16 rounding), zero past the logical K."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    k = 1000
    qt = tq.quantize((torch.randn((k, 256), generator=gen, device=cuda) * 0.05).bfloat16(),
                     64, 4)
    x = torch.randn((9, k), generator=gen, device=cuda).bfloat16()
    lnw = (1 + 0.1 * torch.randn(k, generator=gen, device=cuda)).bfloat16()
    qmc.reset_counts()
    xn = qmc.gemv_ln_rows(x, qt, ln_w=lnw, ln_eps=1e-5)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K1 ln"] == 1 and xn.shape == (9, qt.padded_k)
    xf = x.float()
    want = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5) * lnw.float()).bfloat16()
    assert _norm_err(xn[:, :k], want) < 1e-2
    assert int((xn[:, k:] != 0).sum()) == 0


@pytest.mark.parametrize("m", [33, 127, 129, 257, 2048])
@pytest.mark.parametrize("bits,group_size", [(4, 32), (4, 64), (4, 128), (8, 64)])
def test_k2_matches_plain_across_rows(cuda, m, bits, group_size):
    """K2 alone at the edges of its 128-row tiles, over K splits (small M)
    and none (large M), layers 0 and L - 1 of a stack, and a ragged last
    column tile (N = 5 x 128 + 8); one launch per call, and a second call
    gives the same bits (the split partials are summed in a fixed order)."""
    k, n, layers = 2048, 648, 3
    gen = torch.Generator(device=cuda).manual_seed(m + bits + group_size)
    w = (torch.randn((layers, k, n), generator=gen, device=cuda) * 0.05).bfloat16()
    qt = tq.quantize(w, group_size, bits)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    for layer in (0, layers - 1):
        qmc.reset_counts()
        got = qmc.quant_gemm(x, qt, layer=layer)
        torch.cuda.synchronize()
        assert qmc.launch_counts["K2"] == 1
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert _norm_err(got, qmc.quant_matmul_ref(x, qt, layer=layer)) < 0.025
        assert torch.equal(qmc.quant_gemm(x, qt, layer=layer), got)


@pytest.mark.parametrize("m", [64, 512])
def test_k2_int4_rounds_once(cuda, m):
    """K2's INT4 weights with bf16 scales round once, as its INT8 path and
    the plain version do (tests/test_torch_k2_numerics.py emulates it): on
    the same weights both bit widths land within one output rounding of
    their plain version (2^-8 of the largest output, plus f32 sum order),
    at the Gemma-3 4B down projection's K."""
    k, n = 10240, 640
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.02).bfloat16()
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    errs = {}
    for bits in (4, 8):
        qt = tq.quantize(w, 64, bits)
        assert qt.scales.dtype == torch.bfloat16
        errs[bits] = _norm_err(qmc.quant_gemm(x, qt), qmc.quant_matmul_ref(x, qt))
    assert errs[4] < 4e-3 and errs[8] < 4e-3, errs


@pytest.mark.parametrize("m", [40, 512])
def test_k2_tied_head_width(cuda, m):
    """The 1B tied head: K 2048, N 128,256 (vocab), f32 scales."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn((2048, 128256), generator=gen, device=cuda) * 0.02
    qt = tq.quantize(w, 64, 4)
    del w
    assert qt.scales.dtype == torch.float32
    x = torch.randn((m, 2048), generator=gen, device=cuda).bfloat16()
    got = qmc.quant_gemm(x, qt)
    assert _norm_err(got, qmc.quant_matmul_ref(x, qt)) < 0.025


def test_kernel_rejects_what_it_does_not_take(cuda):
    qt = tq.quantize(torch.randn((512, 256), device=cuda).bfloat16(), 64, 4)
    with pytest.raises(ValueError):  # f32 activations
        qmc.quant_gemv(torch.randn((1, 512), device=cuda), qt)
    with pytest.raises(ValueError):  # CPU weights
        qmc.quant_gemv(torch.randn((1, 512), device=cuda).bfloat16(), qt.to("cpu"))
    with pytest.raises(ValueError):  # prologue on the prefill branch
        qmc.quant_matmul_cuda(torch.randn((64, 512), device=cuda).bfloat16(), qt,
                              ln_w=torch.ones(512, device=cuda).bfloat16())
    with pytest.raises(ValueError):  # K2 on CPU activations
        qmc.quant_gemm(torch.randn((64, 512)).bfloat16(), qt)
    narrow = tq.quantize(torch.randn((512, 100), device=cuda).bfloat16(), 64, 4)
    with pytest.raises(ValueError, match="multiple of 8"):  # TMA's 16-byte rows
        qmc.quant_gemm(torch.randn((64, 512), device=cuda).bfloat16(), narrow)
    wide = tq.quantize(torch.randn((512, 1024), device=cuda).bfloat16(), 64, 4)
    dh = 2 * qmc.GEMM_TILE_N
    pos = torch.arange(64, device=cuda, dtype=torch.int32)
    cs = rope_qkv_cs(pos, torch.rand(dh // 2, device=cuda), 1024 // dh, 0, dh)
    with pytest.raises(ValueError):  # a head wider than K2's tile
        qmc.quant_gemm(torch.randn((64, 512), device=cuda).bfloat16(), wide,
                       rope_cs=cs, rope_dim=dh)


# -- K3: paged decode attention ------------------------------------------------


def paged_inputs(dev, lens, hq, hkv, d, quantized, layers=2, maxp=4, seed=0):
    """Random pool [L, P + 1, Hkv, 64, D] (bf16, or int8 with f32 scales),
    block tables of shuffled pages with -1 pads, bf16 queries."""
    g = torch.Generator().manual_seed(seed)
    b = len(lens)
    p = b * maxp + 2
    shape = (layers, p + 1, hkv, 64, d)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:4], generator=g) * 0.02 + 0.005 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g).bfloat16() for _ in range(2))
        ks = vs = None
    perm = torch.randperm(p, generator=g).to(torch.int32)
    tables = torch.full((b, maxp), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        need = -(-n // 64)
        tables[i, :need] = perm[i * maxp:i * maxp + need]
    q = torch.randn((b, hq, d), generator=g).bfloat16()
    ctx = torch.tensor(lens, dtype=torch.int32)
    to = lambda t: None if t is None else t.to(dev)
    return tuple(to(t) for t in (q, k, v, ks, vs, tables, ctx))


LENS = (1, 63, 64, 65, 130, 200, 7, 1000)  # 1,000: 16 pages, several per warp and split
K3_HEADS = [(d, hq, hkv) for d in (64, 128)
            for hq, hkv in ((8, 2), (4, 4), (16, 2), (32, 8), (32, 1))
            if hq // hkv <= (32 if d == 64 else 16)]
# head_dim 256 (half-page stages, q in shared memory): Gemma-3 4B (8 / 4),
# 12B (16 / 8) and 1B (4 / 1, MQA), and a group of 16
K3_HEADS += [(256, hq, hkv) for hq, hkv in ((8, 4), (16, 8), (4, 1), (16, 1))]
# odd and even groups under the padded 16 rows: Qwen2.5-VL-7B (28 / 4, a
# group of 7) and Qwen2-VL-2B (12 / 2, a group of 6)
K3_HEADS += [(128, 28, 4), (128, 12, 2)]


@pytest.mark.parametrize("d,hq,hkv", K3_HEADS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [0, 1, 64, 100])
@pytest.mark.parametrize("split", [True, False])
def test_paged_attention_matches_plain(cuda, monkeypatch, d, quantized, window,
                                       split, hq, hkv):
    """K3 against paged_attention_ref: ragged lengths, shuffled tables with
    -1 pads, sliding windows, layer 1 of 2, the page walk split across
    blocks or not, head groups of 1 to 32 (the Llama-3 heads 32 / 8; the
    Gemma-3 heads at D 256);
    bf16 output within 2e-2 of the f32 plain version."""
    if not split:
        monkeypatch.setattr(pa, "TARGET_BLOCKS", 1)
    q, k, v, ks, vs, tables, ctx = paged_inputs(cuda, LENS, hq, hkv, d, quantized,
                                                maxp=16)
    scale = d ** -0.5
    qmc.reset_counts()
    got = pa.paged_attention_decode(q, k, v, ks, vs, 1, tables, ctx, scale, window)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K3"] == 1
    want = pa.paged_attention_ref(q.float(), k, v, ks, vs, 1, tables, ctx, scale,
                                  window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _norm_err(got, want) < 2e-2
    # a second call finds the arrival counters reset
    again = pa.paged_attention_decode(q, k, v, ks, vs, 1, tables, ctx, scale, window)
    assert torch.equal(again, got)


def test_k3_in_a_cuda_graph(cuda):
    """K3 with its page walk split across blocks, captured in a CUDA graph
    and replayed over new queries and lengths, equals the eager call each
    time; the arrival counters are back at zero after each replay."""
    lens = (2048, 1500, 700, 65, 2048, 5, 1000, 130)
    q, k, v, ks, vs, tables, ctx = paged_inputs(cuda, lens, 32, 8, 128, True, maxp=32)
    plan = pa.launch_plan(cuda, len(lens), 32, 8, 128, tables.shape[1], True)
    assert plan["splits"] > 1
    scale = 128 ** -0.5
    args = (k, v, ks, vs, 1, tables, ctx, scale)
    pa.paged_attention_decode(q, *args)  # warm-up: build, attributes, counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention_decode(q, *args)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=gen, device=cuda).bfloat16())
        ctx.sub_(step)  # shorter contexts: the walk ends on other tokens
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pa.paged_attention_decode(q, *args))
        assert int(pa._counters[q.device][:len(lens) * 8].abs().sum()) == 0


@pytest.mark.parametrize("hq,hkv", [(28, 4), (12, 2)])
@pytest.mark.parametrize("quantized", [False, True])
def test_k3_qwen_groups_in_a_cuda_graph(cuda, hq, hkv, quantized):
    """K3 at the Qwen2-VL groups (7 and 6 query heads a KV head), D 128,
    INT8 and bf16 pages, 8 lanes up to 2,048 tokens: the eager call against
    the plain version (2e-2), then captured and replayed over new queries
    and shorter contexts, equal to the eager call each time."""
    lens = (2048, 1500, 700, 65, 2048, 5, 1000, 130)
    q, k, v, ks, vs, tables, ctx = paged_inputs(cuda, lens, hq, hkv, 128, quantized,
                                                maxp=32)
    scale = 128 ** -0.5
    args = (k, v, ks, vs, 1, tables, ctx, scale)
    got = pa.paged_attention_decode(q, *args)
    want = pa.paged_attention_ref(q.float(), *args)
    assert _norm_err(got, want) < 2e-2
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention_decode(q, *args)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=gen, device=cuda).bfloat16())
        ctx.sub_(step)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pa.paged_attention_decode(q, *args))
        assert _norm_err(out, pa.paged_attention_ref(q.float(), *args)) < 2e-2


def test_paged_attention_rejects_what_it_does_not_take(cuda):
    q, k, v, ks, vs, tables, ctx = paged_inputs(cuda, (70, 5), 8, 2, 128, True)
    args = (tables, ctx, 0.1)
    with pytest.raises(ValueError):  # f32 queries
        pa.paged_attention_decode(q.float(), k, v, ks, vs, 0, *args)
    with pytest.raises(ValueError):  # INT8 pool without its scales
        pa.paged_attention_decode(q, k, v, None, None, 0, *args)
    with pytest.raises(ValueError):  # pool on the CPU
        pa.paged_attention_decode(q, k.cpu(), v, ks, vs, 0, *args)
    with pytest.raises(IndexError):  # layer out of range
        pa.paged_attention_decode(q, k, v, ks, vs, 2, *args)
    q96, k96, v96, _, _, t96, c96 = paged_inputs(cuda, (70,), 8, 2, 96, False)
    with pytest.raises(ValueError):  # head dim 96
        pa.paged_attention_decode(q96, k96, v96, None, None, 0, t96, c96, 0.1)


# -- the continuous-batching path on the card ----------------------------------


def test_chunk_dispatch_reads_nothing_back(cuda, monkeypatch):
    """After a warm-up request (which fills one-time caches), every device
    program the scheduler queues (direct prefills, and chunks with riders,
    wakes and frozen lanes) runs with CUDA's sync debug mode set to raise,
    so none of them reads the device back: the drain is the chunk's one
    host read. K3 runs once per layer per device step."""
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

    model = LlamaModel(LlamaConfig(
        model_type="llama", hidden_size=512, intermediate_size=1024,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
        head_dim=64, vocab_size=1024, rope_theta=500000.0,
        tie_word_embeddings=False))
    params = model.init_quantized_params(seed=0, device=cuda)
    engine = PagedEngine(model, params, num_lanes=4, num_pages=32, max_pages_per_seq=8,
                         prefill_chunk=64, rider_width=44, kv_quantized=True,
                         device=cuda)
    sched = Scheduler(engine, decode_steps=4)
    sched.add_request(list(range(1, 101)), max_new_tokens=4, temperature=0.0)
    sched.add_request([5, 6, 7], max_new_tokens=4, temperature=0.0)
    sched.run_to_completion(max_steps=100)
    for name in ("_chunk", "_prefill"):
        real = getattr(engine, name)

        def strict(*args, _real=real, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _real(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        monkeypatch.setattr(engine, name, strict)
    qmc.reset_counts()
    steps0 = engine.device_steps
    seqs = [sched.add_request(list(range(1, 1 + n)), max_new_tokens=12, temperature=0.0)
            for n in (100, 10, 3)]  # a direct prefill, two riders
    sched.run_to_completion(max_steps=100)
    torch.cuda.synchronize()
    assert all(s.status == SeqStatus.COMPLETED and len(s.output_ids) == 12 for s in seqs)
    assert qmc.launch_counts["K3"] == 2 * (engine.device_steps - steps0) > 0
    assert qmc.launch_counts["K2"] > 0  # the mixed steps' M = 4 + 44 projections


# -- K4: the fused decode MLP block ----------------------------------------------


def mlp_weights(dev, d, di, bits=4, group_size=64, layers=2, seed=0,
                dtype=torch.bfloat16):
    """Random stacked wo [L, d, d], wgu [L, d, 2 di], wd [L, di, d], quantized
    on the card from ``dtype`` weights (so with scales of that dtype), and
    an ln2 table [L, d]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = lambda k, n: tq.quantize(
        (torch.randn((layers, k, n), generator=gen, device=dev) * 0.02).to(dtype),
        group_size, bits)
    ln2 = (torch.rand((layers, d), generator=gen, device=dev) + 0.5).bfloat16()
    return q(d, d), q(d, 2 * di), q(di, d), ln2


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [32, 64, 128])
def test_fused_mlp_matches_plain(cuda, m, bits, group_size):
    """K4 at the Llama-3.2-1B widths (d 2048, di 8192) against
    fused_mlp_ref on the same card inputs, layer 1 of 2, with the ln2 row
    given as the [L, d] table and as the layer's row; one launch per call,
    and a second call gives the same bits (the barrier words were left
    ready, the reduction order is fixed)."""
    wo, wgu, wd, ln2 = mlp_weights(cuda, 2048, 8192, bits=bits, group_size=group_size)
    gen = torch.Generator(device=cuda).manual_seed(m)
    attn = torch.randn((m, 2048), generator=gen, device=cuda).bfloat16()
    h = torch.randn((m, 2048), generator=gen, device=cuda).bfloat16()
    qmc.reset_counts()
    got = fm.fused_mlp_stacked(attn, h, ln2, 1, wo, wgu, wd, 1e-5)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K4"] == 1
    want = fm.fused_mlp_ref(attn, h, ln2, 1, wo, wgu, wd, 1e-5)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 2048)
    assert _norm_err(got, want) < 0.02
    again = fm.fused_mlp_stacked(attn, h, ln2[1], 1, wo, wgu, wd, 1e-5)
    assert torch.equal(again, got)


@pytest.mark.parametrize("m", [2, 8])
def test_fused_mlp_f32_scales(cuda, m):
    """Weights quantized from f32 keep f32 scales; K4 reads them."""
    wo, wgu, wd, ln2 = mlp_weights(cuda, 2048, 2048, dtype=torch.float32)
    assert wgu.scales.dtype == torch.float32
    attn, h = (torch.randn((m, 2048), device=cuda).bfloat16() for _ in range(2))
    got = fm.fused_mlp_stacked(attn, h, ln2, 0, wo, wgu, wd)
    assert _norm_err(got, fm.fused_mlp_ref(attn, h, ln2, 0, wo, wgu, wd)) < 0.02


def _k4_counters_zero(dev) -> bool:
    """K4's barrier arrivals and split counters are back at zero (the two
    barrier generations, words 1 and 3, only grow)."""
    c = qmc._arrival_counters(dev, "K4")[:1024].clone()
    c[1] = c[3] = 0
    return int(c.abs().sum()) == 0


def test_k4_in_a_cuda_graph(cuda):
    """K4 captured in a CUDA graph (layers 0 and 1 of the 1B widths at
    M = 8) and replayed three times over new activations matches the eager
    calls bit for bit; the barrier and split counters are back at zero
    after each replay."""
    wo, wgu, wd, ln2 = mlp_weights(cuda, 2048, 8192)
    gen = torch.Generator(device=cuda).manual_seed(9)
    attn = torch.randn((8, 2048), generator=gen, device=cuda).bfloat16()
    h = torch.randn((8, 2048), generator=gen, device=cuda).bfloat16()
    for layer in (0, 1):  # warm-up: build, attributes, tensor maps
        fm.fused_mlp_stacked(attn, h, ln2, layer, wo, wgu, wd, 1e-5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fm.fused_mlp_stacked(attn, h, ln2, layer, wo, wgu, wd, 1e-5)
                for layer in (0, 1)]
    for _ in range(3):
        attn.copy_(torch.randn((8, 2048), generator=gen, device=cuda).bfloat16())
        h.copy_(torch.randn((8, 2048), generator=gen, device=cuda).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert _k4_counters_zero(cuda)
        for layer, out in zip((0, 1), outs):
            assert torch.equal(out, fm.fused_mlp_stacked(attn, h, ln2, layer, wo, wgu, wd,
                                                         1e-5))
        assert not torch.equal(outs[0], outs[1])


def test_k4_reruns_after_another_plan(cuda, monkeypatch):
    """A call at M = 3 with another K-split plan right after a call at
    M = 8, then both again: each rerun gives the same bits and agrees with
    the plain version; the counters are back at zero after each call."""
    import dataclasses

    wo, wgu, wd, ln2 = mlp_weights(cuda, 2048, 8192)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x8 = [torch.randn((8, 2048), generator=gen, device=cuda).bfloat16() for _ in range(2)]
    x3 = [t[:3].clone() for t in x8]
    real = fm.mlp_plan

    def fewer_splits(*args, **kw):  # wo and wd in 4 K ranges, wgu unsplit
        plan = real(*args, **kw)
        phases = []
        for p, want in zip(plan.phases, (4, 1, 4)):
            per = -(-p.stages // want)
            phases.append(dataclasses.replace(p, splits=-(-p.stages // per),
                                              stages_per_split=per))
        return dataclasses.replace(plan, phases=tuple(phases))

    def call(x, other_plan):
        if other_plan:
            monkeypatch.setattr(fm, "mlp_plan", fewer_splits)
        try:
            out = fm.fused_mlp_stacked(*x, ln2, 1, wo, wgu, wd, 1e-5)
            torch.cuda.synchronize()
        finally:
            monkeypatch.setattr(fm, "mlp_plan", real)
        assert _k4_counters_zero(cuda)
        return out

    first8, first3 = call(x8, False), call(x3, True)
    assert torch.equal(call(x3, True), first3) and torch.equal(call(x8, False), first8)
    for x, got in ((x8, first8), (x3, first3)):
        assert _norm_err(got, fm.fused_mlp_ref(*x, ln2, 1, wo, wgu, wd, 1e-5)) < 0.02


def test_fused_mlp_rejects_what_it_does_not_take(cuda):
    wo, wgu, wd, ln2 = mlp_weights(cuda, 2048, 2048)
    qmc.reset_counts()
    x = lambda m: torch.randn((m, 2048), device=cuda).bfloat16()
    with pytest.raises(ValueError):  # M > 8
        fm.fused_mlp_cuda(x(9), x(9), ln2, 0, wo, wgu, wd)
    with pytest.raises(ValueError):  # unstacked weights
        fm.fused_mlp_cuda(x(1), x(1), ln2[0], 0, wo.layer(0), wgu, wd)
    _, _, wd32, _ = mlp_weights(cuda, 2048, 2048, group_size=32)
    with pytest.raises(ValueError):  # mixed group sizes
        fm.fused_mlp_cuda(x(1), x(1), ln2, 0, wo, wgu, wd32)
    with pytest.raises(ValueError):  # f32 activations
        fm.fused_mlp_cuda(x(1).float(), x(1), ln2, 0, wo, wgu, wd)
    with pytest.raises(IndexError):  # layer out of range
        fm.fused_mlp_cuda(x(1), x(1), ln2, 2, wo, wgu, wd)
    with pytest.raises(ValueError):  # an ln2 row of another width
        fm.fused_mlp_cuda(x(1), x(1), ln2[:, :1024].contiguous(), 0, wo, wgu, wd)
    bo, bgu, bd, bln = mlp_weights(cuda, 4608, 512, layers=1)
    with pytest.raises(ValueError, match="d <= 4096"):  # an ln2 row wider than K4 keeps
        fm.fused_mlp_cuda(*(torch.zeros((1, 4608), device=cuda).bfloat16(),) * 2, bln, 0,
                          bo, bgu, bd)
    import dataclasses

    real = fm.mlp_plan
    try:  # a split phase with more tasks than resident blocks: the kernel refuses it
        fm.mlp_plan = lambda *a, **kw: dataclasses.replace(
            real(*a, **kw), blocks=8)
        with pytest.raises(RuntimeError, match="CUDA error"):
            fm.fused_mlp_cuda(x(1), x(1), ln2, 0, wo, wgu, wd)
    finally:
        fm.mlp_plan = real
    assert qmc.launch_counts["K4"] == 0  # a refused call counts no launch


# -- compiled steps: the decode steps as CUDA graphs ------------------------------


def _graph_model(dev):
    """Two layers at the Llama-3.2-1B widths (K4 takes their MLP block) with
    a small vocabulary and random INT4 g64 weights."""
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

    model = LlamaModel(LlamaConfig(
        model_type="llama", hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, vocab_size=1024, rope_theta=500000.0,
        tie_word_embeddings=False))
    return model, model.init_quantized_params(seed=0, device=dev)


def _eager(graphs):
    """The same engine's steps run eagerly on the card: the reference the
    graphs are held against."""
    from pie_tpu_torch.engine.graphs import StepGraphs

    class Eager(StepGraphs):
        def __call__(self, key, fn, samples=False):
            self.keys.add(key)
            return fn()

    return Eager(graphs.device, graphs.generator)


class _Tap:
    """A step runner that keeps a copy of every step's logits (a paged
    direct prefill returns none)."""

    def __init__(self, inner):
        self.inner, self.logits = inner, []

    def __call__(self, key, fn, samples=False):
        out = self.inner(key, fn, samples)
        if len(out) > 1:
            self.logits.append(out[1].float().clone())
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _gemma_graph_model(dev):
    """Two layers (one sliding, window 64; one global) at the Gemma-3 1B
    widths (head_dim 256, one KV head) with a small vocabulary and random
    INT4 g64 weights."""
    from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model

    model = Gemma3Model(Gemma3Config(
        hidden_size=1152, intermediate_size=6912, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=256,
        vocab_size=1024, sliding_window=64, sliding_window_pattern=2))
    return model, model.init_quantized_params(seed=0, device=dev)


QWEN_IMAGE = 1000  # the small Qwen's image token (vision start 998, end 999)


def _qwen_graph_model(dev):
    """Two layers at the Qwen2-VL-2B widths (hidden 1536, heads 12 / 2,
    head_dim 128: K3 at a group of 6) with a small vocabulary, random INT4
    g64 weights and biases, and a random 2-block Qwen2.5 tower (width 128,
    windows of 2 x 2 merge units, full attention at block 1)."""
    from pie_tpu_torch.models.qwen2_vl import Qwen2VLConfig, Qwen2VLModel

    model = Qwen2VLModel(Qwen2VLConfig(
        hidden_size=1536, intermediate_size=8960, num_hidden_layers=2,
        num_attention_heads=12, num_key_value_heads=2, vocab_size=1024,
        mrope_section=(16, 24, 24), image_token_id=QWEN_IMAGE, video_token_id=1001,
        vision=dict(depth=2, hidden_size=128, out_hidden_size=1536,
                    intermediate_size=256, num_heads=2, patch_size=14,
                    window_size=56, fullatt_block_indexes=[1])))
    params = model.init_quantized_params(seed=0, device=dev)
    params["vision"] = model.vision.init_params(seed=1, device=dev)
    return model, params


def _qwen_image(model, params, dev, seed=0):
    """(prompt, image keyword arguments, embeddings [plen, D], streams
    [3, plen], offset) of a prompt holding one 112 x 112 image (8 x 8
    patches: 16 merged tokens, four windows)."""
    import numpy as np

    from pie_tpu_torch.models.qwen2_vl import image_positions

    grid = np.array([[1, 8, 8]])
    prompt = [5, 6, 998] + [QWEN_IMAGE] * 16 + [999, 7, 8, 9]
    px = np.random.default_rng(seed).standard_normal((64, 3 * 2 * 14 * 14)).astype(np.float32)
    with torch.no_grad():
        emb = model.embed_with_images(params, torch.tensor([prompt], device=dev),
                                      torch.from_numpy(px).to(dev), grid)[0]
    p3, delta = image_positions(model, [prompt], grid, len(prompt))
    return prompt, dict(pixel_values=px, image_kwargs={"grid_thw": grid}), emb, p3[:, 0], delta


def _single_pair(dev, make=_graph_model):
    from pie_tpu_torch.engine import InferenceEngine

    model, params = make(dev)
    engines = [InferenceEngine(model=model, params=params, max_seq_len=512,
                               decode_chunk=16, prompt_cache=False, device=dev)
               for _ in range(2)]
    engines[1].core.graphs = _eager(engines[1].core.graphs)
    return engines


def _paged_pair(dev, make=_graph_model):
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler

    model, params = make(dev)
    scheds = [Scheduler(PagedEngine(model, params, num_lanes=4, num_pages=64,
                                    max_pages_per_seq=8, prefill_chunk=64,
                                    rider_width=44, kv_quantized=True, device=dev),
                        decode_steps=4) for _ in range(2)]
    scheds[1].engine.graphs = _eager(scheds[1].engine.graphs)
    return scheds


PAGED_PROMPTS = (list(range(1, 101)), [5, 6, 7], list(range(40, 60)), [9])


def test_step_graphs_replay_the_eager_steps(cuda):
    """The single-stream prefill and decode step and the paged direct
    prefill and rider-free and mixed steps, replayed from their graphs,
    give the greedy tokens of the same steps run eagerly on the card,
    logits within 1e-3 normalized; every key but the first call of each
    replays."""
    engines = _single_pair(cuda)
    taps = []
    for e in engines:
        e.core.graphs = _Tap(e.core.graphs)
        taps.append(e.core.graphs)
    outs = [e.generate(list(range(3, 40)), max_completion_tokens=40, temperature=0.0,
                       logprobs=True) for e in engines]
    assert outs[0].token_ids == outs[1].token_ids and len(outs[0].token_ids) == 40
    assert taps[0].inner.replays > 0 and taps[0].inner.captures == len(taps[0].inner.keys)
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3

    scheds = _paged_pair(cuda)
    taps = []
    for s in scheds:
        s.engine.graphs = _Tap(s.engine.graphs)
        taps.append(s.engine.graphs)
    streams = []
    for s in scheds:
        seqs = [s.add_request(p, max_new_tokens=12, temperature=0.0) for p in PAGED_PROMPTS]
        s.run_to_completion(max_steps=200)
        streams.append([q.output_ids for q in seqs])
    assert streams[0] == streams[1] and all(len(t) == 12 for t in streams[0])
    assert {k[0] for k in taps[0].inner.keys} == {"decode", "mixed", "prefill"}
    assert taps[0].inner.replays > 0
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3


def test_gemma3_step_graphs_replay_the_eager_steps(cuda):
    """Gemma-3's captured steps: the single-stream prefill head chunks and
    decode step over the DualKVCache (rotating sliding slots computed on
    the card) past the window, and the paged direct prefill and rider-free
    and mixed steps (K3 at D 256, windowed on the sliding layer), give the
    tokens of the same steps run eagerly, logits within 1e-3 normalized; K3
    runs once per layer per paged step."""
    engines = _single_pair(cuda, _gemma_graph_model)
    taps = []
    for e in engines:
        e.core.graphs = _Tap(e.core.graphs)
        taps.append(e.core.graphs)
    prompt = list(range(3, 103))  # past the window of 64: two prefill chunks
    outs = [e.generate(prompt, max_completion_tokens=40, temperature=0.0)
            for e in engines]
    assert outs[0].token_ids == outs[1].token_ids and len(outs[0].token_ids) == 40
    assert taps[0].inner.replays > 0
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3

    scheds = _paged_pair(cuda, _gemma_graph_model)
    taps, streams = [], []
    for s in scheds:
        s.engine.graphs = _Tap(s.engine.graphs)
        taps.append(s.engine.graphs)
        qmc.reset_counts()
        steps0 = s.engine.device_steps
        seqs = [s.add_request(p, max_new_tokens=12, temperature=0.0) for p in PAGED_PROMPTS]
        s.run_to_completion(max_steps=200)
        assert qmc.launch_counts["K3"] == 2 * (s.engine.device_steps - steps0) > 0
        streams.append([q.output_ids for q in seqs])
    assert streams[0] == streams[1] and all(len(t) == 12 for t in streams[0])
    assert {k[0] for k in taps[0].inner.keys} == {"decode", "mixed", "prefill"}
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3


def test_qwen_image_graphs_replay_the_eager_steps(cuda):
    """Qwen2-VL's captured image prefill (embeddings and M-RoPE streams in
    static buffers) and decode steps at the prompt's offset, and the paged
    mixed steps with an image rider (embeddings in the static rider buffer,
    key "embeds on") beside text lanes, give the tokens of the same steps
    run eagerly on the card, logits within 1e-3 normalized, the single
    stream's caches byte-equal; K3 runs once per layer per paged step."""
    from pie_tpu_torch.cache.kv_cache import cache_tensors

    engines = _single_pair(cuda, _qwen_graph_model)
    model, params = engines[0].model, engines[0].params
    prompt, image, emb, p3, delta = _qwen_image(model, params, cuda)
    taps = []
    for e in engines:
        e.core.graphs = _Tap(e.core.graphs)
        taps.append(e.core.graphs)
    outs = [e.generate(prompt, max_completion_tokens=24, temperature=0.0, **image)
            for e in engines]
    assert outs[0].token_ids == outs[1].token_ids and len(outs[0].token_ids) == 24
    assert any(k[0] == "prefill" and k[6] and k[7] for k in taps[0].inner.keys)
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3
    caches = [cache_tensors(e.state.cache) for e in engines]
    for name, t in caches[0].items():
        assert torch.equal(t, caches[1][name]), name
    again = engines[0].generate(prompt, max_completion_tokens=24, temperature=0.0,
                                **image)  # replays the image prefill
    assert again.token_ids == outs[0].token_ids

    scheds = _paged_pair(cuda, _qwen_graph_model)
    taps, streams = [], []
    for s in scheds:
        s.engine.graphs = _Tap(s.engine.graphs)
        taps.append(s.engine.graphs)
        qmc.reset_counts()
        steps0 = s.engine.device_steps
        seqs = [s.add_request(p, max_new_tokens=12, temperature=0.0)
                for p in PAGED_PROMPTS[1:3]]
        seqs.append(s.add_request(prompt, max_new_tokens=12, temperature=0.0,
                                  prompt_embeds=emb, positions3=p3, pos_delta=delta))
        s.run_to_completion(max_steps=200)
        assert qmc.launch_counts["K3"] == 2 * (s.engine.device_steps - steps0) > 0
        streams.append([q.output_ids for q in seqs])
    assert streams[0] == streams[1] and all(len(t) == 12 for t in streams[0])
    assert streams[0][2][0] == outs[0].token_ids[0]
    assert any(k[0] == "mixed" and k[5] for k in taps[0].inner.keys)
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3


GEMMA_IMAGE = 1000  # the small Gemma-3 VLM's image token


def _to(tree, device):
    """A params tree (quantized leaves included) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _gemma_vlm_graph_model(dev):
    """``_gemma_graph_model``'s decoder with a random 2-block SigLIP tower
    (width 128, 112-px images: 8 x 8 patches pooled 2 x 2 to 16 tokens)."""
    from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model

    model = Gemma3Model(Gemma3Config(
        hidden_size=1152, intermediate_size=6912, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=256,
        vocab_size=1024, sliding_window=64, sliding_window_pattern=2,
        vision=dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                    num_attention_heads=2, image_size=112, patch_size=14),
        mm_tokens_per_image=16, image_token_id=GEMMA_IMAGE))
    params = model.init_quantized_params(seed=0, device=dev)
    params["vision"] = model.vision.init_params(seed=1, device=dev)
    return model, params


def _gemma_image(model, params, dev, seed=0):
    """(prompt, pixels, embeddings [plen, D]) of a 100-token prompt whose
    one image (16 placeholders at 50-65) straddles the first 64-token head
    chunk's end."""
    import numpy as np

    prompt = list(range(3, 53)) + [GEMMA_IMAGE] * 16 + list(range(60, 94))
    px = np.random.default_rng(seed).standard_normal((1, 3, 112, 112)).astype(np.float32)
    with torch.no_grad():
        emb = model.embed_with_images(params, torch.tensor([prompt], device=dev),
                                      torch.from_numpy(px).to(dev))[0]
    return prompt, px, emb


def test_gemma3_image_graphs_replay_the_eager_steps(cuda):
    """Gemma-3's captured image prefill, a prompt past the window whose
    head chunk and tail both carry their slices of the prompt's embeddings
    (key "embeds on"), and its decode steps, and the paged mixed steps
    with an image rider beside text lanes, give the tokens of the same
    steps run eagerly on the card, logits within 1e-3 normalized, the
    single stream's caches byte-equal; K3 runs once per layer per paged
    step."""
    from pie_tpu_torch.cache.kv_cache import cache_tensors

    engines = _single_pair(cuda, _gemma_vlm_graph_model)
    model, params = engines[0].model, engines[0].params
    prompt, px, emb = _gemma_image(model, params, cuda)
    taps = []
    for e in engines:
        e.core.graphs = _Tap(e.core.graphs)
        taps.append(e.core.graphs)
    outs = [e.generate(prompt, max_completion_tokens=24, temperature=0.0, pixel_values=px)
            for e in engines]
    assert outs[0].token_ids == outs[1].token_ids and len(outs[0].token_ids) == 24
    embeds_on = [k for k in taps[0].inner.keys if k[0] == "prefill" and k[6]]
    assert {k[1] for k in embeds_on} == {64}  # the head chunk and the tail's bucket
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3
    caches = [cache_tensors(e.state.cache) for e in engines]
    for name, t in caches[0].items():
        assert torch.equal(t, caches[1][name]), name
    again = engines[0].generate(prompt, max_completion_tokens=24, temperature=0.0,
                                pixel_values=px)  # replays both image prefills
    assert again.token_ids == outs[0].token_ids

    scheds = _paged_pair(cuda, _gemma_vlm_graph_model)
    taps, streams = [], []
    for s in scheds:
        s.engine.graphs = _Tap(s.engine.graphs)
        taps.append(s.engine.graphs)
        qmc.reset_counts()
        steps0 = s.engine.device_steps
        seqs = [s.add_request(p, max_new_tokens=12, temperature=0.0)
                for p in PAGED_PROMPTS[1:3]]
        seqs.append(s.add_request(prompt, max_new_tokens=12, temperature=0.0,
                                  prompt_embeds=emb))
        s.run_to_completion(max_steps=200)
        assert qmc.launch_counts["K3"] == 2 * (s.engine.device_steps - steps0) > 0
        streams.append([q.output_ids for q in seqs])
    assert streams[0] == streams[1] and all(len(t) == 12 for t in streams[0])
    assert streams[0][2][0] == outs[0].token_ids[0]
    assert any(k[0] == "mixed" and k[5] for k in taps[0].inner.keys)
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3


def test_gemma3_mixed_step_with_pf_embeds(cuda):
    """Gemma-3's mixed step with an image rider (pf_embeds: the prompt's
    first 40 embeddings, the image inside) on the card against the same
    step's plain version on the CPU, over INT8 pools (normalized 0.03), and
    the rider lane's K3-attended wake step against ``__call__``'s logits at
    the same position on the card."""
    import numpy as np

    from pie_tpu_torch.cache.paged import PagedKVPool

    model, params = _gemma_vlm_graph_model(cuda)
    prompt = [3, 4] + [GEMMA_IMAGE] * 16 + list(range(5, 27))  # 40 tokens
    px = np.random.default_rng(2).standard_normal((1, 3, 112, 112)).astype(np.float32)
    cpu_params = _to(params, "cpu")
    t = lambda a, d: torch.tensor(np.asarray(a), dtype=torch.int32, device=d)
    out = {}
    for dev, p in ((cuda, params), ("cpu", cpu_params)):
        with torch.no_grad():
            emb = model.embed_with_images(p, t([prompt], dev), torch.from_numpy(px).to(dev))[0]
            pool = PagedKVPool.create(2, 8, 1, 256, torch.bfloat16, True, device=dev)
            cs = 44
            rider, rpos = np.full(cs, -1), np.full(cs, -1)
            rider[:39], rpos[:39] = prompt[:39], np.arange(39)
            pemb = torch.zeros((cs, emb.shape[-1]), dtype=emb.dtype, device=dev)
            pemb[:39] = emb[:39]
            tables = t([[3, 2, 1, 0], [7, 6, 5, 4]], dev)
            logits, _ = model.mixed_forward(
                p, pool, t([11, prompt[-1]], dev), t([0, 39], dev), t([1, 40], dev),
                tables, t(rider, dev), t(rpos, dev), t([1], dev), t([39], dev),
                pf_embeds=pemb)
        out[dev] = logits.float().cpu()
    assert _norm_err(out[cuda], out["cpu"]) < 0.03
    cache = model.make_cache(1, 64, torch.bfloat16, device=cuda)
    with torch.no_grad():
        emb = model.embed_with_images(params, t([prompt], cuda), torch.from_numpy(px).to(cuda))
        want, _ = model(params, t([prompt], cuda), cache.advance(t([0], cuda), 40),
                        t([np.arange(40)], cuda), inputs_embeds=emb)
    assert _norm_err(out[cuda][1], want[0, -1].float().cpu()) < 0.03


class _PieceTokenizer:
    """A tokenizer of a few JSON pieces (id -> string): enough for the
    constrained lanes' masker, with no tokenizer package."""

    PIECES = (list('{}[]":,.-0123456789 ') + ['{"', '"}', '": ', '", "', "true",
                                               "false", "null"]
              + list("abcdefghijklmnopqrstuvwxyz") + ["name", "count", "alpha", "beta"])
    vocab_size = len(PIECES)

    def decode(self, ids):
        return "".join(self.PIECES[i] for i in ids)


def test_masked_step_graphs_replay_the_eager_steps(cuda):
    """The paged steps with a constrained lane's mask (use_mask in the key),
    rider-free and mixed, replayed from their graphs: a json_schema lane
    beside prompts that ride mixed steps gives the tokens of the same steps
    run eagerly on the card on every lane, logits within 1e-3 normalized."""
    from pie_tpu_torch.structured.json_machine import JsonMachine
    from pie_tpu_torch.structured.token_masks import TokenMasker

    schema = {"type": "object",
              "properties": {"name": {"enum": ["alpha", "beta"]},
                             "count": {"type": "integer"}},
              "required": ["name", "count"], "additionalProperties": False}
    masker = TokenMasker(_PieceTokenizer())
    scheds = _paged_pair(cuda)
    taps, streams = [], []
    for s in scheds:
        s.engine.graphs = _Tap(s.engine.graphs)
        taps.append(s.engine.graphs)
        seqs = [s.add_request([1, 2, 3], max_new_tokens=24, temperature=0.0,
                              machine=JsonMachine(schema), masker=masker)]
        seqs += [s.add_request(p, max_new_tokens=12, temperature=0.0)
                 for p in PAGED_PROMPTS[:3]]
        s.run_to_completion(max_steps=400)
        streams.append([(q.output_ids, q.finish_reason) for q in seqs])
    assert streams[0] == streams[1]
    keys = {(k[0], k[4]) for k in taps[0].inner.keys if k[0] != "prefill"}
    assert {("decode", True), ("mixed", True)} <= keys
    assert taps[0].inner.replays > 0
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3


def test_step_graph_samples_anew_at_every_replay(cuda):
    """A graph that samples (temperature 1, the categorical sampler) with
    the engine's generator registered: two replays draw different tokens,
    and 8,192 rows over 8 logits follow the softmax."""
    from pie_tpu_torch.engine.graphs import StepGraphs
    from pie_tpu_torch.ops.sampling import SamplingParams, sample

    gen = torch.Generator(device=cuda).manual_seed(1)
    graphs = StepGraphs(cuda, gen)
    rows = 8192
    logits = torch.log(torch.tensor([0.3, 0.2, 0.15, 0.1, 0.1, 0.08, 0.05, 0.02],
                                    device=cuda)).repeat(rows, 1)
    params = SamplingParams.make(rows, temperature=1.0, device=cuda)
    step = lambda: (sample(logits, params, gen, kind="categorical"),)
    draws = [graphs("s", step, samples=True)[0].clone() for _ in range(3)]
    assert graphs.captures == 1 and graphs.replays == 2
    assert not torch.equal(draws[1], draws[2]) and not torch.equal(draws[0], draws[1])
    for d in draws[1:]:
        freq = torch.bincount(d.long(), minlength=8).double().cpu() / rows
        want = torch.softmax(logits[0].double().cpu(), 0)
        assert float((freq - want).abs().max()) < 0.02


def test_step_graph_launch_counts(cuda):
    """Kernel launches counted over a request of replayed steps equal those
    of the same request with the steps run eagerly (K1, its ln pre-pass,
    K2, K4), and K3 runs once per layer per paged device step."""
    engines = _single_pair(cuda)
    counts = []
    for e in engines:
        e.generate(list(range(3, 40)), max_completion_tokens=9, temperature=0.0)
        qmc.reset_counts()
        e.generate(list(range(4, 41)), max_completion_tokens=33, temperature=0.0)
        torch.cuda.synchronize()
        counts.append(dict(qmc.launch_counts))
    assert counts[0] == counts[1] and counts[0]["K4"] == 2 * 32 and counts[0]["K1"] > 0
    scheds = _paged_pair(cuda)
    counts = []
    for s in scheds:
        s.add_request([5, 6, 7], max_new_tokens=6, temperature=0.0)
        s.run_to_completion(max_steps=100)
        qmc.reset_counts()
        steps0 = s.engine.device_steps
        for p in PAGED_PROMPTS:
            s.add_request(p, max_new_tokens=12, temperature=0.0)
        s.run_to_completion(max_steps=200)
        torch.cuda.synchronize()
        counts.append(dict(qmc.launch_counts))
        assert qmc.launch_counts["K3"] == 2 * (s.engine.device_steps - steps0)
    assert counts[0] == counts[1]


def test_graph_at_m1_keeps_its_k4_workspace(cuda, monkeypatch):
    """A graph captured over K4 at M = 1 replays correctly after an M = 8
    call grew the workspace, and writes nothing into memory allocated
    since: the workspace it captured stays allocated."""
    monkeypatch.setattr(fm, "_workspaces", {})
    monkeypatch.setattr(fm, "_retired", [])
    wo, wgu, wd, ln2 = mlp_weights(cuda, 2048, 8192)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x1 = [torch.randn((1, 2048), generator=gen, device=cuda).bfloat16() for _ in range(2)]
    x8 = [torch.randn((8, 2048), generator=gen, device=cuda).bfloat16() for _ in range(2)]
    fm.fused_mlp_stacked(*x1, ln2, 1, wo, wgu, wd, 1e-5)  # warm-up
    dev = x1[0].device  # the workspaces' key: cuda:0
    nbytes = fm._workspaces[dev].numel()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fm.fused_mlp_stacked(*x1, ln2, 1, wo, wgu, wd, 1e-5)
    fm.fused_mlp_stacked(*x8, ln2, 1, wo, wgu, wd, 1e-5)
    assert fm._workspaces[dev].numel() > nbytes
    # a freed workspace would be handed out again here, and the replay
    # would write into it
    junk = torch.full((nbytes,), 7, dtype=torch.uint8, device=cuda)
    graph.replay()
    torch.cuda.synchronize()
    assert bool((junk == 7).all())
    assert torch.equal(out, fm.fused_mlp_stacked(*x1, ln2, 1, wo, wgu, wd, 1e-5))
    assert len(fm._retired) == 1


def test_steady_chunk_reads_nothing_back(cuda):
    """Once its graphs are captured, a steady chunk of each engine is
    dispatched with CUDA's sync debug mode set to raise."""
    from pie_tpu_torch.engine.core import PenaltyParams
    from pie_tpu_torch.engine.scheduler import SeqStatus
    from pie_tpu_torch.ops.sampling import SamplingParams

    e = _single_pair(cuda)[0]
    e.generate(list(range(3, 40)), max_completion_tokens=40, temperature=0.0)
    core = e.core
    args = (SamplingParams.make(1, temperature=0.0, device=cuda),
            PenaltyParams.make(1, device=cuda), *e._empty_bias,
            torch.full((8,), -1, dtype=torch.int32, device=cuda))
    core._decode(e.params, e.state, *args, num_steps=16, sampler_kind="greedy",
                 kv_bucket=256, use_penalties=False, use_bias=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, outs = core._decode(e.params, e.state, *args, num_steps=16,
                               sampler_kind="greedy", kv_bucket=256,
                               use_penalties=False, use_bias=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert outs[0].shape == (16, 1)

    sched = _paged_pair(cuda)[0]
    seqs = [sched.add_request(p, max_new_tokens=40, temperature=0.0) for p in PAGED_PROMPTS]
    while sched.waiting or any(s.status != SeqStatus.DECODING for s in seqs):
        sched.step()
    sched.step()
    assert not sched._inflight
    torch.cuda.set_sync_debug_mode("error")
    try:
        sched._fill_pipeline()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(sched._inflight) == 1
    sched.run_to_completion(max_steps=200)
    assert all(len(s.output_ids) == 40 for s in seqs)

    # Qwen2-VL with an image lane: its decode steps read the lanes'
    # M-RoPE offsets from a static buffer, no host value
    sched = _paged_pair(cuda, _qwen_graph_model)[0]
    model, params = sched.engine.model, sched.engine.params
    prompt, _, emb, p3, delta = _qwen_image(model, params, cuda)
    seqs = [sched.add_request(p, max_new_tokens=40, temperature=0.0)
            for p in PAGED_PROMPTS[1:3]]
    seqs.append(sched.add_request(prompt, max_new_tokens=40, temperature=0.0,
                                  prompt_embeds=emb, positions3=p3, pos_delta=delta))
    while sched.waiting or any(s.status != SeqStatus.DECODING for s in seqs):
        sched.step()
    sched.step()
    assert not sched._inflight and int(sched.engine.pos_delta.max()) == delta > 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        sched._fill_pipeline()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(sched._inflight) == 1
    sched.run_to_completion(max_steps=200)
    assert all(len(s.output_ids) == 40 for s in seqs)


# -- the native scheduler's programs --------------------------------------------------


def _native_pair(dev):
    """Two native schedulers over paged engines (4 lanes, INT8 pages) on the
    graph model; the second runs its programs eagerly."""
    from pie_tpu_torch.engine.scheduler import PagedEngine
    from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

    model, params = _graph_model(dev)
    scheds = [NativeScheduler(PagedEngine(model, params, num_lanes=4, num_pages=64,
                                          max_pages_per_seq=8, prefill_chunk=64,
                                          kv_quantized=True, device=dev))
              for _ in range(2)]
    scheds[1].engine.graphs = _eager(scheds[1].engine.graphs)
    return scheds


class _NativeTap:
    """A step runner that keeps a copy of each native program's result: the
    prefill's logits, the first sample's token, the decode step's logits."""

    def __init__(self, inner):
        self.inner, self.outs = inner, []

    def __call__(self, key, fn, samples=False):
        out = self.inner(key, fn, samples)
        self.outs.append((key[0], out[1 if key[0] == "native" else 0].float().clone()))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_native_graphs_replay_the_eager_programs(cuda):
    """The native prefill (a 100-token prompt in chunks of 64 and 36), the
    first-token sample and the decode step, replayed from their graphs,
    give the greedy tokens of the same programs run eagerly on the card,
    logits within 1e-3 normalized, the pools byte-equal."""
    scheds = _native_pair(cuda)
    taps = []
    for s in scheds:
        s.engine.graphs = _NativeTap(s.engine.graphs)
        taps.append(s.engine.graphs)
    streams = []
    for s in scheds:
        reqs = [s.add_request(p, max_new_tokens=12, temperature=0.0) for p in PAGED_PROMPTS]
        s.run_to_completion(max_steps=200)
        streams.append([r.output_ids for r in reqs])
    assert streams[0] == streams[1] and all(len(t) == 12 for t in streams[0])
    assert {k[0] for k in taps[0].inner.keys} == {"native_prefill", "first", "native"}
    assert taps[0].inner.replays > 0
    assert [k for k, _ in taps[0].outs] == [k for k, _ in taps[1].outs]
    for (kind, got), (_, want) in zip(taps[0].outs, taps[1].outs):
        if kind == "first":
            assert torch.equal(got, want)
        else:
            assert _norm_err(got, want) < 1e-3, kind
    for a, b in zip(_pool_tensors(scheds[0].engine.pool), _pool_tensors(scheds[1].engine.pool)):
        assert torch.equal(a, b)


def test_steady_native_step_reads_back_once(cuda):
    """Once every lane decodes and the step's graph is captured, a native
    step makes one synchronizing call: the read of its [B] tokens."""
    import warnings

    sched = _native_pair(cuda)[0]
    reqs = [sched.add_request(p, max_new_tokens=40, temperature=0.0)
            for p in PAGED_PROMPTS]
    for _ in range(3):
        sched.step()
    assert sched.core.decode_view() == len(PAGED_PROMPTS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sched.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    sched.run_to_completion(max_steps=200)
    assert all(len(r.output_ids) == 40 for r in reqs)


# -- compiled prefills: every prefill as a CUDA graph ------------------------------


def _pool_tensors(pool):
    return [t for t in (pool.k, pool.v, pool.k_scale, pool.v_scale) if t is not None]


def _prefill_calls(e, v):
    """(ids, lens, first position, mask) of the prefills the card tests
    run on a single-stream engine: a 50-token prompt and a 30-token
    continuation (bucket 64: K2), then masked extends of 5 and 3 tokens
    (bucket 8: K1) and of 40 and 20 tokens (bucket 64, masked: K2)."""
    import numpy as np

    rng = np.random.default_rng(0)
    calls, first = [], 0
    for n, bucket, masked in ((50, 64, False), (30, 64, False), (5, 8, True),
                              (3, 8, True), (40, 64, True), (20, 64, True)):
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = rng.integers(1, v, n)
        mask = rng.uniform(size=(1, v)) < 0.5 if masked else None
        calls.append((ids, np.array([n], np.int32), np.array([first], np.int32), mask))
        first += n
    return calls


def _run_prefill(e, call, sync_free=False):
    ids, lens, first, mask = call
    args = (e._sampling({"temperature": 0.0}), e._penalties({}), *e._empty_bias)
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        e.state, token, _ = e.core._prefill(e.params, e.state, ids, lens, first, *args,
                                            allowed_mask=mask, sampler_kind="greedy")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return token


def test_prefill_graphs_replay_the_eager_prefills(cuda):
    """Each prefill, captured and then replayed, against the same prefill
    run eagerly by a twin on the card: single-stream prompts, continuations
    from a first position past 0 and masked extends give equal tokens and
    processed logits within 1e-3 normalized, and equal KV caches; paged
    direct prefills of one bucket (another table, positions and length the
    second time) leave equal pools. Every replay is queued under CUDA's
    sync debug mode "error"."""
    import numpy as np

    from pie_tpu_torch.cache.kv_cache import cache_tensors

    engines = _single_pair(cuda)
    taps = []
    for e in engines:
        e.core.graphs = _Tap(e.core.graphs)
        taps.append(e.core.graphs)
    v = engines[0].model.config.vocab_size
    calls = _prefill_calls(engines[0], v)
    seen = set()
    for call in calls:
        key = (call[0].shape[1], call[3] is not None)
        toks = [_run_prefill(engines[0], call, sync_free=key in seen),
                _run_prefill(engines[1], call)]
        seen.add(key)
        assert toks[0].tolist() == toks[1].tolist()
    assert taps[0].inner.replays == 3 and taps[0].inner.captures == 3
    assert len(taps[0].logits) == len(taps[1].logits) == len(calls)
    for got, want in zip(taps[0].logits, taps[1].logits):
        assert _norm_err(got, want) < 1e-3
    caches = [cache_tensors(e.state.cache) for e in engines]
    for name, t in caches[0].items():
        assert torch.equal(t, caches[1][name]), name

    scheds = _paged_pair(cuda)
    for table, first, n in (([3, 7, -1, -1, -1, -1, -1, -1], 0, 60),
                            ([12, 0, 5, -1, -1, -1, -1, -1], 40, 33)):
        ids = np.zeros((1, 64), np.int32)
        pos = np.full((1, 64), -1, np.int32)
        ids[0, :n] = np.arange(n) + 7
        pos[0, :n] = first + np.arange(n)
        args = (ids, pos, np.array([table], np.int32), np.array([first + n], np.int32))
        for i, s in enumerate(scheds):
            if i == 0 and first:
                torch.cuda.set_sync_debug_mode("error")
            try:
                s.engine._prefill(s.engine.params, *args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for a, b in zip(*(_pool_tensors(s.engine.pool) for s in scheds)):
            assert torch.equal(a, b)
    assert scheds[0].engine.graphs.replays == 1


def test_prefill_graph_launch_counts(cuda):
    """K1, its ln pre-pass, K2 and K4 launches of each replayed prefill equal
    those of the same prefill run eagerly (counted from the graph's delta):
    a 64-token bucket (K2 for every projection and the head) and a masked
    8-token extend (K1, and K4 for the MLP block at M = 8); and those of a
    replayed paged direct prefill equal its eager twin's."""
    import numpy as np

    engines = _single_pair(cuda)
    calls = _prefill_calls(engines[0], engines[0].model.config.vocab_size)
    for first, again in ((calls[0], calls[1]), (calls[2], calls[3])):
        counts = []
        for e in engines:
            _run_prefill(e, first)  # the graph engine captures here
            qmc.reset_counts()
            _run_prefill(e, again)
            torch.cuda.synchronize()
            counts.append(dict(qmc.launch_counts))
        assert counts[0] == counts[1]
        assert counts[0]["K2" if first[0].shape[1] > 32 else "K1"] > 0
    assert engines[0].core.graphs.replays == 2

    scheds = _paged_pair(cuda)
    counts = []
    for s in scheds:
        ids = np.arange(64, dtype=np.int32)[None] + 3
        pos = np.arange(64, dtype=np.int32)[None]
        args = (ids, pos, np.array([[2, -1, -1, -1, -1, -1, -1, -1]], np.int32),
                np.array([64], np.int32))
        s.engine._prefill(s.engine.params, *args)
        qmc.reset_counts()
        s.engine._prefill(s.engine.params, *args)
        torch.cuda.synchronize()
        counts.append(dict(qmc.launch_counts))
    assert counts[0] == counts[1] and counts[0]["K2"] == 4 * 2
    assert scheds[0].engine.graphs.replays == 1


def test_cache_swap_frees_the_prefill_graphs(cuda):
    """An INT8 conversion replaces the single-stream cache (another kind):
    the graphs over the old cache, prefill graphs among them, go, and their
    memory pool leaves the card once nothing holds it."""
    import gc

    from pie_tpu_torch.cache.kv_cache import maybe_quantize

    e = _single_pair(cuda)[0]
    e.generate(list(range(3, 40)), max_completion_tokens=20, temperature=0.0)
    graphs = e.core.graphs
    assert graphs.stats()["by_kind"]["prefill"]["graphs"] == 1
    pool = tuple(graphs._pool)
    assert graphs.pool_bytes() > 0
    del graphs
    e.state = e.core.set_cache(maybe_quantize(e.state.cache, 1))
    assert e.core.graphs.captures == 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool]
    assert not held
    out = e.generate(list(range(3, 40)), max_completion_tokens=8, temperature=0.0)
    assert len(out.token_ids) == 8


@pytest.mark.parametrize("m", [8, 512])
def test_padded_row_shard_on_the_card(cuda, m):
    """K1 (M = 8) and K2 (M = 512) on a tp 8 row shard of a K = 3,584
    weight (K 448, re-padded to 512 with zero codes, scales and biases)
    against the plain version; the eight shards' products sum to the
    unsharded one."""
    from pie_tpu_torch.parallel.tp import row_shard

    gen = torch.Generator(device=cuda).manual_seed(m)
    k, n, tp = 3584, 512, 8
    qt = tq.quantize((torch.randn((k, n), generator=gen, device=cuda) * 0.05).bfloat16(),
                     64, 4)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    total = 0
    for r in range(tp):
        shard = row_shard(qt, r, tp)
        assert shard.shape == (k // tp, n) and shard.padded_k == 512
        xs = x[:, r * k // tp:(r + 1) * k // tp].contiguous()
        got = tq.quantized_matmul(xs, shard)
        assert _norm_err(got, qmc.quant_matmul_ref(xs, shard)) < 0.025
        total = total + got.float()
    assert _norm_err(total, tq.quantized_matmul(x, qt).float()) < 0.025


def test_collectives_in_a_step_graph_over_nccl(cuda):
    """A one-process NCCL mesh (tp = 1): the sharded forwards'
    collectives (all-reduce, vocab all-gather, masked embedding) captured
    in a step graph replay what they compute eagerly, and the graph adds
    its collectives to the counts at every replay."""
    import socket

    import torch.distributed as dist

    from pie_tpu_torch.engine.graphs import StepGraphs
    from pie_tpu_torch.parallel import distributed, make_mesh, mesh_ops
    from pie_tpu_torch.parallel.tp import collective_counts

    joined = not dist.is_initialized()
    if joined:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        assert distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        ops = mesh_ops(make_mesh(tp=1, dp=1))
        assert ops.capturable and ops.backend == "nccl"
        gen = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn((8, 4096), generator=gen, device=cuda).bfloat16()
        logits = torch.randn((8, 1000), generator=gen, device=cuda)
        table = torch.randn((1000, 64), generator=gen, device=cuda).bfloat16()
        ids = torch.randint(0, 1000, (8,), generator=gen, device=cuda)
        graphs = StepGraphs(cuda, None, ops)

        def step():
            return ops.tp_sum(x * 2), ops.gather_vocab(logits + 1), ops.embed(table, ids)

        graphs(("decode",), step)  # warm-up and capture
        before = dict(collective_counts)
        out = graphs(("decode",), step)
        torch.cuda.synchronize()
        for got, want in zip(out, (x * 2, logits + 1, table[ids])):
            assert torch.equal(got, want)
        assert {k: collective_counts[k] - before[k] for k in before} == {
            "tp all_reduce": 2, "tp all_gather": 1, "dp all_gather": 0}
        assert graphs.stats()["by_kind"]["decode"]["replays"] == 1
    finally:
        if joined:
            dist.destroy_process_group()


@pytest.mark.parametrize("knobs", [
    dict(path="ldg"), dict(path="ldg", unroll=1), dict(path="ldg", unroll=8, blocks_per_sm=1),
    dict(path="tma"), dict(path="tma", chunk_kb=16, stages=2),
    dict(path="tma", chunk_kb=32, stages=7, blocks_per_sm=1),
])
@pytest.mark.parametrize("rows,n", [(8, 4), (64, 256), (4096, 2052), (8, 32768),
                                    (8192, 2048)])  # the last: 64 MiB, over the L2
def test_hbm_read_matches_plain(cuda, rows, n, knobs):
    """B7's two paths fold every row: bit-equal to the plain version on
    integer-valued f32 (every order of summation is exact there), one
    launch counted per call."""
    from pie_tpu_torch.tools import hbm_peak as hp

    gen = torch.Generator(device=cuda).manual_seed(rows + n)
    x = torch.randint(-8, 9, (rows, n), generator=gen, device=cuda, dtype=torch.float32)
    hp.reset_counts()
    got = hp.stream_read(x, **knobs)
    torch.cuda.synchronize()
    assert hp.launch_counts[f"B7 {knobs['path']}"] == 1
    assert torch.equal(got, hp.stream_read_plain(x))
    xr = torch.randn((rows, n), generator=gen, device=cuda)
    got = hp.stream_read(xr.view(torch.int32), **knobs)
    assert _norm_err(got, hp.stream_read_plain(xr)) < 1e-5
