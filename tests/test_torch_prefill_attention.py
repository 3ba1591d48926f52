"""K5, the paged prefill attention (``ops/prefill_attention.py``,
``csrc/paged_prefill_attention.cu``), and the route that sends a prefill
chunk's attention to it or to the plain ``gathered_attention``.

CPU tests: the route by pool dtype, head dim and device; the plain
version against a float64 dense reference; the models' prefill forwards
handing K5's wrapper the rows the plain mask is made from; K5's launch
name against the benchmark's K1 / K2 / K3 patterns; its launch plan.
Card tests (marked ``cuda``, skipped without a card; no JAX here):
python -m pytest --noconftest tests/test_torch_prefill_attention.py"""

import re
from pathlib import Path

import pytest
import torch

from pie_tpu_torch.cache.paged import PAGE_SIZE, PagedKVPool
from pie_tpu_torch.models import llama
from pie_tpu_torch.models import qwen2_vl
from pie_tpu_torch.ops import prefill_attention as k5
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.attention import attention_mask
from portbench.readers import K1, K2, K3

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU mode")
    return torch.device("cuda")


def _norm_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def prefill_inputs(dev, hq, hkv, bucket, first, n, maxp=66, layers=2, hole=None,
                   seed=0):
    """A pool of ``layers`` layers of random INT8 codes and scales at head
    dim 128, one lane whose table names shuffled pages for its context
    (-1 past it, and at page ``hole`` when given), and a chunk of
    ``bucket`` rows: ``n`` tokens at positions ``first`` .. ``first + n -
    1``, then pad rows (-1); the context is ``first + n``. Returns (q,
    pool, tables, positions, context_lens)."""
    g = torch.Generator().manual_seed(seed)
    ctx = first + n
    live = -(-ctx // PAGE_SIZE)
    pool = PagedKVPool.create(layers, maxp + 2, hkv, 128, quantized=True, device="cpu")
    for codes in (pool.k, pool.v):
        codes.copy_(torch.randint(-127, 128, codes.shape, generator=g, dtype=torch.int8))
    for s in (pool.k_scale, pool.v_scale):
        s.copy_(0.01 + 0.02 * torch.rand(s.shape, generator=g))
    table = torch.full((1, maxp), -1, dtype=torch.int32)
    table[0, :live] = torch.randperm(maxp + 2, generator=g)[:live].to(torch.int32)
    if hole is not None:
        table[0, hole] = -1
    pos = torch.full((1, bucket), -1, dtype=torch.int32)
    pos[0, :n] = torch.arange(first, first + n, dtype=torch.int32)
    q = (3 * torch.randn((1, bucket, hq, 128), generator=g)).bfloat16()
    ctxs = torch.tensor([ctx], dtype=torch.int32)
    if dev.type != "cpu":
        pool = PagedKVPool(*(t.to(dev) for t in (pool.k, pool.v, pool.k_scale, pool.v_scale)))
    return q.to(dev), pool, table.to(dev), pos.to(dev), ctxs.to(dev)


def dense_reference(q, pool, layer, tables, positions, context_lens, scale):
    """The function in float64: the pool dequantized, row t attending slot
    s iff s < ctx, s <= positions[t] and the table's page for s is not -1.
    Returns [B, T, Hq, D] float64 (pad rows: zeros)."""
    b, t, hq, d = q.shape
    hkv = pool.k.shape[2]
    out = torch.zeros((b, t, hq, d), dtype=torch.float64)
    for bi in range(b):
        tab = tables[bi].long().cpu()
        pages = tab.clamp(min=0)
        k = (pool.k[layer][pages].double() * pool.k_scale[layer][pages].double()[..., None])
        v = (pool.v[layer][pages].double() * pool.v_scale[layer][pages].double()[..., None])
        k = k.transpose(1, 2).reshape(-1, hkv, d)  # [S, Hkv, D]
        v = v.transpose(1, 2).reshape(-1, hkv, d)
        s_pos = torch.arange(k.shape[0])
        ok = (s_pos < int(context_lens[bi])) & (tab.repeat_interleave(PAGE_SIZE) >= 0)
        pos = positions[bi].long().cpu()
        mask = ok[None, :] & (s_pos[None, :] <= pos[:, None])  # [T, S]
        qg = q[bi].double().cpu().reshape(t, hkv, hq // hkv, d)
        sc = torch.einsum("thrd,shd->thrs", qg, k) * scale
        sc = sc.masked_fill(~mask[:, None, None, :], float("-inf"))
        p = torch.softmax(sc, dim=-1).nan_to_num(0.0)
        out[bi] = torch.einsum("thrs,shd->thrd", p, v).reshape(t, hq, d)
    return out


# -- the route ----------------------------------------------------------------


@pytest.mark.parametrize("head_dim,quantized,device,want", [
    (128, True, "cuda", True),
    (64, True, "cuda", False),     # Llama-3.2-1B's heads
    (256, True, "cuda", False),    # Gemma-3's heads
    (128, False, "cuda", False),   # a bf16 pool
    (128, True, "cpu", False),     # the CPU: always the plain version
    (128, True, "meta", False),
])
def test_route_by_pool_head_dim_and_device(head_dim, quantized, device, want):
    pool = PagedKVPool.create(1, 2, 2, head_dim, quantized=quantized, device="meta")
    assert k5.uses_k5(pool, head_dim, torch.device(device)) is want


def _routed(pool, layer, tables, q, pos, ctx, scale):
    """A prefill chunk's attention as the models route it."""
    mask = llama._prefill_mask(pool, q.shape[-1], q.device, pos, tables, ctx)
    return llama.prefill_attention(pool, layer, tables, q, pos, ctx, scale, mask)


@pytest.mark.parametrize("head_dim,quantized", [(128, True), (64, True), (128, False)])
def test_cpu_prefill_runs_the_plain_version(monkeypatch, head_dim, quantized):
    """On CPU tensors the route makes the mask of the rows' positions and
    ``prefill_attention`` runs ``gathered_attention`` under it, never K5's
    wrapper."""
    def no_kernel(*a, **k):
        raise AssertionError("K5's wrapper called on the CPU")

    monkeypatch.setattr(llama, "prefill_attention_cuda", no_kernel)
    g = torch.Generator().manual_seed(1)
    pool = PagedKVPool.create(1, 4, 2, head_dim, quantized=quantized, device="cpu")
    if quantized:
        pool.k.copy_(torch.randint(-127, 128, pool.k.shape, generator=g, dtype=torch.int8))
        pool.v.copy_(torch.randint(-127, 128, pool.v.shape, generator=g, dtype=torch.int8))
        pool.k_scale.fill_(0.02)
        pool.v_scale.fill_(0.03)
    else:
        pool.k.copy_(torch.randn(pool.k.shape, generator=g))
        pool.v.copy_(torch.randn(pool.v.shape, generator=g))
    tables = torch.tensor([[2, 0, -1]], dtype=torch.int32)
    pos = torch.tensor([[60, 61, 62, -1]], dtype=torch.int32)
    ctx = torch.tensor([63], dtype=torch.int32)
    q = torch.randn((1, 4, 4, head_dim), generator=g).bfloat16()
    mask = attention_mask(pos, llama._paged_kv_positions(tables, ctx))
    assert torch.equal(llama._prefill_mask(pool, head_dim, q.device, pos, tables, ctx),
                       mask)
    got = _routed(pool, 0, tables, q, pos, ctx, 0.1)
    assert torch.equal(got, llama.gathered_attention(pool, 0, tables, q, mask, 0.1))


# -- the plain version against float64 ---------------------------------------


@pytest.mark.parametrize("hq,hkv", [(8, 2), (7, 1)])  # groups 4 and 7
@pytest.mark.parametrize("bucket", [16, 64, 256])
@pytest.mark.parametrize("first", [0, 1024, 3840])
@pytest.mark.parametrize("edge", [True, False])
def test_plain_version_matches_float64(hq, hkv, bucket, first, edge):
    """The routed attention on the CPU (``gathered_attention``) against the
    float64 dense reference on the real rows: chunks of 16-256 rows from
    positions 0, 1,024 and 3,840, contexts ending on a page edge or mid-page
    with pad rows after them, -1 table pads past the context. Within 1e-2
    of the largest output: the plain version rounds q, the scaled
    probabilities and its output to bf16 (2^-9 relative each)."""
    n = bucket if edge else bucket - 5
    q, pool, tables, pos, ctx = prefill_inputs(torch.device("cpu"), hq, hkv, bucket,
                                               first, n, seed=first + bucket + hq)
    scale = 128 ** -0.5
    got = _routed(pool, 1, tables, q, pos, ctx, scale)
    want = dense_reference(q, pool, 1, tables, pos, ctx, scale)
    assert _norm_err(got[:, :n], want[:, :n]) < 1e-2


def test_plain_version_skips_an_unmapped_page():
    """A -1 page inside the context is masked like a slot past it."""
    q, pool, tables, pos, ctx = prefill_inputs(torch.device("cpu"), 8, 2, 64, 192, 64,
                                               hole=1)
    scale = 128 ** -0.5
    got = _routed(pool, 0, tables, q, pos, ctx, scale)
    want = dense_reference(q, pool, 0, tables, pos, ctx, scale)
    assert _norm_err(got, want) < 1e-2


# -- the models hand K5 the rows the plain mask is made from -----------------


def _tiny_llama():
    cfg = llama.LlamaConfig(model_type="llama", hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, vocab_size=97,
                            tie_word_embeddings=False)
    model = llama.LlamaModel(cfg)
    return model, model.init_params(seed=3, dtype=torch.float32, device="cpu")


def _tiny_qwen():
    cfg = qwen2_vl.Qwen2VLConfig(hidden_size=112, intermediate_size=128,
                                 num_hidden_layers=2, num_attention_heads=7,
                                 num_key_value_heads=1, vocab_size=97,
                                 mrope_section=(2, 3, 3))
    model = qwen2_vl.Qwen2VLModel(cfg)
    return model, model.init_params(seed=4, dtype=torch.float32, device="cpu")


def _as_kernel(calls):
    """K5's wrapper emulated on the CPU: the plain attention under the mask
    made from the arguments the wrapper is handed."""
    def fake(q, pool, layer, tables, positions, context_lens, scale):
        calls.append(layer)
        mask = attention_mask(positions, llama._paged_kv_positions(tables, context_lens))
        return llama.gathered_attention(pool, layer, tables, q, mask, scale)
    return fake


@pytest.mark.parametrize("make", [_tiny_llama, _tiny_qwen], ids=["llama", "qwen2_vl"])
@pytest.mark.parametrize("forward", ["paged", "mixed"])
def test_models_hand_k5_the_masked_rows(monkeypatch, make, forward):
    """With the route forced to K5 and its wrapper emulated by the plain
    attention over the positions, context and table it is handed, the
    direct prefill (``paged_forward``) and the rider (``mixed_forward``)
    give the plain route's logits and pool bit for bit, one wrapper call a
    layer: the models pass the rows the plain mask is made from."""
    model, params = make()
    cfg = model.config
    dh = cfg.hidden_size // cfg.num_attention_heads
    tables = torch.tensor([[3, 7, -1], [12, 0, 5]], dtype=torch.int32)

    def run():
        pool = PagedKVPool.create(2, 16, cfg.num_key_value_heads, dh, quantized=True,
                                  device="cpu")
        ids = torch.arange(1, 41, dtype=torch.int32).reshape(2, 20) % 97
        pos = torch.tensor([list(range(0, 20)), list(range(0, 17)) + [-1] * 3],
                           dtype=torch.int32)
        ctx = torch.tensor([20, 17], dtype=torch.int32)
        logits, pool = model.paged_forward(params, ids, pool, tables, pos, ctx)
        if forward == "paged":
            return logits[:, :17], pool
        pf_pos = torch.tensor(list(range(17, 30)) + [-1] * 3, dtype=torch.int32)
        return model.mixed_forward(
            params, pool, torch.tensor([5, 9], dtype=torch.int32),
            torch.tensor([20, -1], dtype=torch.int32), torch.tensor([21, 1], dtype=torch.int32),
            tables, torch.tensor([4] * 13 + [-1] * 3, dtype=torch.int32), pf_pos,
            torch.tensor([1]), torch.tensor([30], dtype=torch.int32))

    want, want_pool = run()
    calls = []
    monkeypatch.setattr(llama, "uses_k5", lambda *a, **k: True)
    monkeypatch.setattr(llama, "prefill_attention_cuda", _as_kernel(calls))
    got, got_pool = run()
    assert calls == [0, 1] * (2 if forward == "mixed" else 1)
    assert torch.equal(got, want)
    for a, b in zip((got_pool.k, got_pool.v), (want_pool.k, want_pool.v)):
        assert torch.equal(a, b)


# -- the launch name and plan ------------------------------------------------


def _kernel_names():
    src = (ROOT / "pie_tpu_torch/csrc/paged_prefill_attention.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", src)


@pytest.mark.parametrize("pattern", [(name, p) for name, ps in (("K1", K1), ("K2", K2),
                                                                  ("K3", K3)) for p in ps],
                         ids=lambda p: f"{p[0]}:{p[1]}")
def test_k5_launch_name_matches_no_reader_pattern(pattern):
    """K5's kernel, as the source names it and as a device trace shows it
    (demangled, in its anonymous namespace, with its arguments), is read by
    none of the benchmark's K1 / K2 / K3 rooflines."""
    names = _kernel_names()
    assert names == ["prefill_attention_kernel"]
    shown = [names[0], f"(anonymous namespace)::{names[0]}(__nv_bfloat16 const*, int)"]
    assert not any(re.search(pattern[1], s) for s in shown)


@pytest.mark.parametrize("name,value", [("kRows", k5.ROWS),
                                        ("kMinPagesPerSplit", k5.MIN_PAGES_PER_SPLIT)])
def test_launch_plan_constants_are_the_kernels(name, value):
    """The plan's rows a block and pages a split are the kernel's own."""
    src = (ROOT / "pie_tpu_torch/csrc/paged_prefill_attention.cu").read_text()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


@pytest.mark.parametrize("tokens,hq,hkv,maxp,tiles,splits", [
    (256, 28, 4, 66, 14, 2),   # Qwen2.5-VL-7B, a direct prefill chunk
    (128, 28, 4, 66, 7, 4),
    (16, 28, 4, 66, 1, 16),    # a 16-token rider slice: 66 pages, four a split
    (256, 32, 8, 20, 8, 2),    # Mistral-7B's 20-page table
    (16, 32, 8, 20, 1, 5),
    (256, 12, 2, 66, 12, 5),   # Qwen2-VL-2B's group of 6
    (64, 14, 2, 66, 4, 16),    # a tp = 2 shard of Qwen2.5-VL-7B
])
def test_launch_plan_fills_one_wave(tokens, hq, hkv, maxp, tiles, splits):
    plan = k5.launch_plan(1, tokens, hq, hkv, maxp)
    assert plan["tiles"] == tiles and plan["splits"] == splits
    assert plan["blocks"] <= k5.TARGET_BLOCKS


# -- on the card -------------------------------------------------------------


QWEN, MISTRAL = (28, 4), (32, 8)
# (bucket, first position, real tokens): the first chunk of a prompt, chunks
# ending at 2,048 and 4,096, a 16-token rider slice, a last chunk with pad rows
CARD_CASES = [(256, 0, 256), (256, 1792, 256), (256, 3840, 256), (16, 2000, 16),
              (256, 1024, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [QWEN, MISTRAL], ids=["qwen", "mistral"])
@pytest.mark.parametrize("bucket,first,n", CARD_CASES)
def test_k5_matches_plain(cuda, heads, bucket, first, n):
    """K5 against the plain version on the card at the Qwen (28 / 4) and
    Mistral (32 / 8) heads, layer 1 of 2, the real rows within 2e-2 of the
    largest output (both round q and P to bf16 once, at other points: P
    before the division by the sum in K5, after it in the plain version;
    and each rounds its own output to bf16); pad rows are zeros; one launch;
    a second call gives the same bits (the split counters were reset)."""
    hq, hkv = heads
    q, pool, tables, pos, ctx = prefill_inputs(cuda, hq, hkv, bucket, first, n,
                                               seed=bucket + first + hq)
    scale = 128 ** -0.5
    qmc.reset_counts()
    got = k5.prefill_attention_cuda(q, pool, 1, tables, pos, ctx, scale)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K5"] == 1
    mask = attention_mask(pos, llama._paged_kv_positions(tables, ctx))
    want = llama.gathered_attention(pool, 1, tables, q, mask, scale)
    assert _norm_err(got[:, :n], want[:, :n]) < 2e-2
    assert not got[:, n:].any()
    assert torch.equal(k5.prefill_attention_cuda(q, pool, 1, tables, pos, ctx, scale), got)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [QWEN, MISTRAL], ids=["qwen", "mistral"])
def test_k5_in_a_cuda_graph(cuda, heads):
    """Every layer's K5 call captured in one CUDA graph, replayed over new
    queries, positions and context lengths (the same buffers): each replay
    equals the eager calls, and launch_counts["K5"] gains one a layer at
    every replay (the step graphs' replay delta)."""
    from pie_tpu_torch.engine.graphs import StepGraphs

    hq, hkv = heads
    layers = 4
    q, pool, tables, pos, ctx = prefill_inputs(cuda, hq, hkv, 256, 3840, 256,
                                               layers=layers, seed=hq)
    scale = 128 ** -0.5
    outs = [torch.empty_like(q) for _ in range(layers)]

    def step():
        for i in range(layers):
            outs[i].copy_(k5.prefill_attention_cuda(q, pool, i, tables, pos, ctx, scale))
        return ()

    graphs = StepGraphs(cuda)
    graphs("k5", step)  # the first call runs eagerly and captures
    gen = torch.Generator(device=cuda).manual_seed(9)
    for first, n in ((0, 256), (1792, 256), (3000, 120)):
        q.copy_(3 * torch.randn(q.shape, generator=gen, device=cuda))
        pos.fill_(-1)
        pos[0, :n] = torch.arange(first, first + n, device=cuda, dtype=torch.int32)
        ctx.fill_(first + n)
        qmc.reset_counts()
        graphs("k5", step)
        torch.cuda.synchronize()
        assert qmc.launch_counts["K5"] == layers
        for i in range(layers):
            want = k5.prefill_attention_cuda(q, pool, i, tables, pos, ctx, scale)
            assert torch.equal(outs[i], want)
    assert graphs.replays == 3


def _model_128(dev):
    """Two layers at head dim 128 (Hq 8, Hkv 2, a group of 4), INT4 g64
    weights, a small vocabulary."""
    model = llama.LlamaModel(llama.LlamaConfig(
        model_type="llama", hidden_size=1024, intermediate_size=2048,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
        head_dim=128, vocab_size=1024, rope_theta=500000.0, tie_word_embeddings=False))
    return model, model.init_quantized_params(seed=0, device=dev)


@pytest.mark.cuda
def test_paged_forward_through_k5_matches_the_plain_route(cuda, monkeypatch):
    """Two chunks of a 300-token prompt through ``paged_forward`` on the
    card, K5's route against the plain route (``uses_k5`` forced off): layer
    0's pages hold the same bytes (written before any attention), layer 1's
    (written from layer 0's attention output) dequantize within 2e-2 of the
    largest value, the real rows' logits agree within 2e-2 of the largest
    (the first chunk's K/V feed the second chunk's attention), and K5 ran
    once a layer a chunk."""
    model, params = _model_128(cuda)
    tables = torch.tensor([[5, 2, 9, 0, 7, -1, -1, -1]], dtype=torch.int32, device=cuda)
    ids = torch.randint(1, 1024, (1, 512), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32).to(cuda)

    def run():
        pool = PagedKVPool.create(2, 12, 2, 128, quantized=True, device=cuda)
        out = []
        for first, n in ((0, 256), (256, 44)):
            pos = torch.full((1, 256), -1, dtype=torch.int32, device=cuda)
            pos[0, :n] = torch.arange(first, first + n, dtype=torch.int32, device=cuda)
            ctx = torch.tensor([first + n], dtype=torch.int32, device=cuda)
            logits, pool = model.paged_forward(params, ids[:, first:first + 256], pool,
                                               tables, pos, ctx)
            out.append(logits[:, :n])
        torch.cuda.synchronize()
        return torch.cat(out, dim=1), pool

    qmc.reset_counts()
    got, got_pool = run()
    assert qmc.launch_counts["K5"] == 2 * 2
    monkeypatch.setattr(llama, "uses_k5", lambda *a, **k: False)
    want, want_pool = run()
    assert _norm_err(got, want) < 2e-2
    for a, b in zip((got_pool.k, got_pool.v, got_pool.k_scale, got_pool.v_scale),
                    (want_pool.k, want_pool.v, want_pool.k_scale, want_pool.v_scale)):
        assert torch.equal(a[0, :12], b[0, :12])
    for codes, s in (("k", "k_scale"), ("v", "v_scale")):
        deq = [getattr(p, codes)[1, :12].float() * getattr(p, s)[1, :12, ..., None]
               for p in (got_pool, want_pool)]
        assert _norm_err(*deq) < 2e-2


@pytest.mark.cuda
def test_mixed_forward_rider_through_k5_matches_the_plain_route(cuda, monkeypatch):
    """``mixed_forward`` on the card with lane 1 frozen and a 50-token rider
    slice of its prompt (positions 100-149 in a 64-row slice) beside lane
    0's decode, then a ``paged_forward`` decode of both lanes that reads the
    rider's pages: K5's route against the plain route (``uses_k5`` forced
    off), both decode steps' logits within 2e-2 of the largest and layer
    1's pages (written from layer 0's rider attention) dequantized within
    2e-2; K5 ran once a layer in the prefill and once in the rider step."""
    model, params = _model_128(cuda)
    tables = torch.tensor([[5, 2, 9, 0], [7, 1, 3, -1]], dtype=torch.int32, device=cuda)
    ids = torch.randint(1, 1024, (2, 200), generator=torch.Generator().manual_seed(3),
                        dtype=torch.int32).to(cuda)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=cuda)

    def run():
        pool = PagedKVPool.create(2, 12, 2, 128, quantized=True, device=cuda)
        pos = torch.arange(200, dtype=torch.int32, device=cuda).repeat(2, 1)
        pos[1, 100:] = -1
        _, pool = model.paged_forward(params, ids, pool, tables, pos, i32([200, 100]),
                                      with_logits=False)
        pf_pos = torch.full((64,), -1, dtype=torch.int32, device=cuda)
        pf_pos[:50] = torch.arange(100, 150, dtype=torch.int32, device=cuda)
        pf_ids = torch.where(pf_pos >= 0, ids[1, pf_pos.clamp(min=0).long()], -1)
        mixed, pool = model.mixed_forward(
            params, pool, i32([ids[0, 199].item(), 0]), i32([200, -1]), i32([201, 1]),
            tables, pf_ids, pf_pos, i32([1]), i32([150]), pf_any=True)
        dec, pool = model.paged_forward(params, i32([[11], [12]]), pool, tables,
                                        i32([[201], [150]]), i32([202, 151]))
        torch.cuda.synchronize()
        return mixed[:1], dec, pool

    qmc.reset_counts()
    got_mixed, got, got_pool = run()
    assert qmc.launch_counts["K5"] == 2 + 2
    monkeypatch.setattr(llama, "uses_k5", lambda *a, **k: False)
    want_mixed, want, want_pool = run()
    assert _norm_err(got_mixed, want_mixed) < 2e-2
    assert _norm_err(got, want) < 2e-2
    for codes, s in (("k", "k_scale"), ("v", "v_scale")):
        deq = [getattr(p, codes)[1, :12].float() * getattr(p, s)[1, :12, ..., None]
               for p in (got_pool, want_pool)]
        assert _norm_err(*deq) < 2e-2


@pytest.mark.cuda
def test_k5_rejects_what_it_does_not_take(cuda):
    q, pool, tables, pos, ctx = prefill_inputs(cuda, 8, 2, 16, 0, 16, maxp=4)
    with pytest.raises(ValueError):  # f32 queries
        k5.prefill_attention_cuda(q.float(), pool, 0, tables, pos, ctx, 0.1)
    with pytest.raises(ValueError):  # head dim 64
        k5.prefill_attention_cuda(q[..., :64], pool, 0, tables, pos, ctx, 0.1)
    with pytest.raises(ValueError):  # int64 positions
        k5.prefill_attention_cuda(q, pool, 0, tables, pos.long(), ctx, 0.1)
    with pytest.raises(IndexError):  # layer out of range
        k5.prefill_attention_cuda(q, pool, 2, tables, pos, ctx, 0.1)
