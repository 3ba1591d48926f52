"""The port's shard plan (pie_tpu_torch/parallel/tp.py) on one process, on
the CPU: the plan against the JAX package's param_specs, the shards of
each kind put back together, quantized row shards re-padded to 512 and
their products summing to the unsharded product, replicate_kv_heads equal
to JAX's element for element (fused INT4 qkv included), local_config, and
K1's / K2's / K4's launch plans at every shard shape a rank runs of the
four geometries the card runs (Llama-3-8B, Llama-3.2-1B, Gemma-3 4B at
tp 2, 4 and 8, Gemma's KV heads replicated at 8; Qwen2.5-VL-7B at tp 2
and 4, its 28 query heads do not split over 8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.parallel import replicate_kv_heads as j_replicate_kv_heads
from pie_tpu.parallel.tp import param_specs as j_param_specs
from pie_tpu_torch.models.gemma3 import Gemma3Config
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.models.qwen2_vl import Qwen2VLConfig
from pie_tpu_torch.ops import fused_mlp as tf
from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.parallel import tp as ttp

from test_torch_gemm_plan import _check_plan as check_gemm_plan
from test_torch_gemv_plan import _check_plan as check_gemv_plan
from test_torch_llama import jax_to_np
from test_torch_mlp_plan import _check_phase as check_mlp_phase

GQA_TINY = dict(
    model_type="llama", hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=2, vocab_size=512,
    rope_theta=10000.0, tie_word_embeddings=False,
)

# name: (config, fused projections, quantized head) as the card runs them
GEOMETRIES = {
    "8B": (LlamaConfig(hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
                       num_key_value_heads=8, vocab_size=128256), True, True),
    "1B": (LlamaConfig(hidden_size=2048, intermediate_size=8192, num_attention_heads=32,
                       num_key_value_heads=8, vocab_size=128256), True, True),
    "gemma3-4b": (Gemma3Config(hidden_size=2560, intermediate_size=10240,
                               num_attention_heads=8, num_key_value_heads=4, head_dim=256,
                               vocab_size=262208), False, False),
    "qwen2.5-vl-7b": (Qwen2VLConfig(hidden_size=3584, intermediate_size=18944,
                                    num_attention_heads=28, num_key_value_heads=4,
                                    vocab_size=152064), False, True),
}
TPS = (2, 4, 8)
# the tps a geometry's heads split over (others: TPS)
GEOMETRY_TPS = {"qwen2.5-vl-7b": (2, 4)}


def _shard_shapes():
    """Every distinct (K, padded K, N, rope) of the four geometries' shards."""
    out = {}
    for geo, (cfg, fused, head) in GEOMETRIES.items():
        for tp in GEOMETRY_TPS.get(geo, TPS):
            for name, (k, n, rope) in ttp.projection_shards(cfg, tp, fused, head).items():
                kp = -(-k // tq.PACK_TILE_K) * tq.PACK_TILE_K
                out.setdefault((k, kp, n, rope), f"{geo} tp{tp} {name}")
    return out


SHARD_SHAPES = _shard_shapes()


@pytest.fixture(scope="module")
def gqa():
    """JAX and port Llama params (Hkv = 2), dense f32 and INT4 g32 fused."""
    jm = JModel(JConfig(**GQA_TINY))
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    jq = jm.quantize_params(jp, group_size=32, bits=4)
    cfg = LlamaConfig(**GQA_TINY)
    return jm, jp, jq, cfg


class _Mesh:
    """A stand-in for a DeviceMesh: shard_params reads only the tp size
    and rank through mesh_ops."""


def _ops(tp, r):
    ops = ttp._NoMesh()
    ops.tp, ops.tp_rank, ops.dp, ops.dp_rank = tp, r, 1, 0
    return ops


@pytest.fixture
def fake_mesh(monkeypatch):
    meshes = {}

    def make(tp, r):
        m = _Mesh()
        meshes[id(m)] = _ops(tp, r)
        return m

    real = ttp.mesh_ops
    monkeypatch.setattr(ttp, "mesh_ops",
                        lambda mesh: meshes[id(mesh)] if id(mesh) in meshes else real(mesh))
    return make


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def test_plan_matches_jax_specs_and_shards_fused_projections(gqa):
    """Each unfused leaf splits as JAX's PartitionSpec says; JAX replicates
    the fused quantized wqkv and wgu (its LAYER_SPECS names only unfused
    leaves), which the port splits per block."""
    _, jp, jq, _ = gqa
    kinds = {P(None, None, "tp"): "col", P(None, "tp", None): "row", P("tp", None): "vocab",
             P(None, "tp"): "head", P(None, None): "rep", P(None): "rep", P(): "rep"}
    port = ttp.param_plan(from_jax_params(jax_to_np(jp), "cpu"))
    for name, spec in j_param_specs(jp)["layers"].items():
        assert port["layers"][name] == kinds[spec], name
    for name in ("embed", "lm_head", "norm"):
        assert port[name] == kinds[j_param_specs(jp)[name]], name
    jspecs = j_param_specs(jq)["layers"]
    qplan = ttp.param_plan(from_jax_params(jax_to_np(jq), "cpu"))["layers"]
    for name, want in (("wqkv", "qkv"), ("wgu", "gu")):
        assert jspecs[name].packed == P()  # the reference replicates it
        assert qplan[name] == want


def test_local_config():
    cfg = GEOMETRIES["8B"][0]
    loc = ttp.local_config(cfg, 4)
    assert (loc.num_attention_heads, loc.num_key_value_heads, loc.intermediate_size,
            loc.resolved_head_dim, loc.vocab_size) == (8, 2, 3584, 128, 128256)
    with pytest.raises(ValueError, match="replicate_kv_heads"):
        ttp.local_config(cfg, 16)
    with pytest.raises(ValueError):
        ttp.local_config(GEOMETRIES["qwen2.5-vl-7b"][0], 8)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_reassemble(gqa, fake_mesh, tp):
    """Every rank's shard, put back together by its kind, is the unsharded
    leaf: columns (and the per-block fused ones) concatenate, rows of a
    dense weight concatenate, a quantized row shard holds its rows' words
    and groups then zero words, zero scales and zero biases to 512."""
    _, jp, jq, cfg = gqa
    for tree in (jp, jq):
        params = from_jax_params(jax_to_np(tree), "cpu")
        shards = [ttp.shard_params(params, fake_mesh(tp, r), cfg) for r in range(tp)]
        lay = params["layers"]
        for name, how in ttp.param_plan(params)["layers"].items():
            parts = [s["layers"][name] for s in shards]
            full = lay[name]
            if how == "rep":
                assert all(p is full for p in parts)
                continue
            if isinstance(full, tq.QuantizedTensor):
                dense = [tq.dequantize(p, torch.float32) for p in parts]
                want = tq.dequantize(full, torch.float32)
            else:
                dense, want = parts, full
            if how == "row":
                got = torch.cat(dense, dim=-2)
                if isinstance(full, tq.QuantizedTensor):
                    for p in parts:
                        kl = p.shape[0]
                        assert p.padded_k % tq.PACK_TILE_K == 0 and p.padded_k >= kl
                        assert not p.packed[..., kl // p.el_per_int:, :].any()
                        assert not p.scales[..., kl // p.group_size:, :].any()
                        assert not p.biases[..., kl // p.group_size:, :].any()
            elif how == "qkv":
                # each rank: its q, then its k, then its v columns
                nq, nk = 8 * 16, 2 * 16
                for r, d in enumerate(dense):
                    off = 0
                    for lo, width in ((0, nq), (nq, nk), (nq + nk, nk)):
                        w = width // tp
                        torch.testing.assert_close(
                            d[..., off:off + w], want[..., lo + r * w:lo + (r + 1) * w],
                            rtol=0, atol=0)
                        off += w
                continue
            elif how == "gu":
                half = want.shape[-1] // 2
                w = half // tp
                for r, d in enumerate(dense):
                    torch.testing.assert_close(d[..., :w], want[..., r * w:(r + 1) * w],
                                               rtol=0, atol=0)
                    torch.testing.assert_close(d[..., w:], want[..., half + r * w:half + (r + 1) * w],
                                               rtol=0, atol=0)
                continue
            else:
                got = torch.cat(dense, dim=-1)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        embed = torch.cat([s["embed"] for s in shards])
        torch.testing.assert_close(embed, params["embed"], rtol=0, atol=0)


@pytest.mark.parametrize("k,tp,bits,g", [
    (14336, 8, 4, 64), (3584, 8, 4, 64), (3584, 8, 8, 32), (18944, 8, 4, 64),
    (18944, 2, 8, 128), (3584, 2, 4, 128), (3584, 4, 4, 64), (18944, 4, 4, 64)])
def test_padded_row_shards_sum_to_the_unsharded_product(k, tp, bits, g):
    """Row shards whose K is no multiple of 512 (8B wd at tp 8 has 1,792;
    Qwen2.5-VL-7B wo at tp 4 896, wd at tp 4 4,736 and at tp 2 9,472; its
    wo at tp 2 1,792; and K 3,584 and 18,944 over 8, 448 and 2,368, as
    the row-shard arithmetic, whatever model holds them), re-padded with
    zero codes, scales and biases: their plain products over x's K slices
    sum to the unsharded product, and a padding that x would fill with
    garbage adds nothing."""
    n, m = 64, 3
    rng = np.random.default_rng(k + tp + bits + g)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    qt = tq.quantize(w, g, bits)
    want = qmc.quant_matmul_ref(x, qt).to(torch.float64)
    kl = k // tp
    got = 0
    for r in range(tp):
        shard = ttp.row_shard(qt, r, tp)
        assert shard.shape == (kl, n) and shard.padded_k % tq.PACK_TILE_K == 0
        got = got + qmc.quant_matmul_ref(x[:, r * kl:(r + 1) * kl], shard).to(torch.float64)
        # garbage in x's padding: the zero scales and biases ignore it
        wide = torch.cat([x[:, r * kl:(r + 1) * kl],
                          torch.full((m, shard.padded_k - kl), 1e4)], dim=1)
        padded = dataclasses.replace(shard, shape=(shard.padded_k, n))
        torch.testing.assert_close(qmc.quant_matmul_ref(wide, padded),
                                   qmc.quant_matmul_ref(x[:, r * kl:(r + 1) * kl], shard),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# KV-head replication
# ---------------------------------------------------------------------------


def test_replicate_kv_heads_dense_equals_jax(gqa):
    _, jp, _, cfg = gqa
    want, wcfg = j_replicate_kv_heads(jp, JConfig(**GQA_TINY), 2)
    got, gcfg = ttp.replicate_kv_heads(from_jax_params(jax_to_np(jp), "cpu"), cfg, 2)
    assert gcfg.num_key_value_heads == wcfg.num_key_value_heads == 4
    for name, leaf in got["layers"].items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want["layers"][name]))


def test_replicate_kv_heads_quantized_fused_qkv_equals_jax(gqa):
    """INT4 fused wqkv: only its K / V column blocks repeat, in the words,
    the scales and the biases; JAX's replicated tensor carried over equals
    the port's replication of the carried-over original, element for
    element."""
    _, _, jq, cfg = gqa
    want, _ = j_replicate_kv_heads(jq, JConfig(**GQA_TINY), 2)
    want = from_jax_params(jax_to_np(want), "cpu")["layers"]["wqkv"]
    got, _ = ttp.replicate_kv_heads(from_jax_params(jax_to_np(jq), "cpu"), cfg, 2)
    got = got["layers"]["wqkv"]
    assert got.shape == want.shape == (128, (8 + 2 * 4) * 16)
    for part in ("packed", "scales", "biases"):
        assert torch.equal(getattr(got, part), getattr(want, part)), part


def test_replicated_heads_keep_attention(gqa):
    """Replication alone (no mesh) leaves the forward's logits unchanged."""
    _, jp, _, cfg = gqa
    params = from_jax_params(jax_to_np(jp), "cpu")
    rep, rcfg = ttp.replicate_kv_heads(params, cfg, 4)
    from pie_tpu_torch.cache.kv_cache import make_kv_cache

    ids = torch.arange(1, 10)[None]
    outs = []
    for p, c in ((params, cfg), (rep, rcfg)):
        cache = make_kv_cache(2, 1, 16, c.num_key_value_heads, 16, dtype=torch.float32,
                              device="cpu").advance(torch.zeros((1,), dtype=torch.int32), 9)
        outs.append(LlamaModel(c)(p, ids, cache, torch.arange(9, dtype=torch.int32)[None])[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernels' plans at every shard shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHARD_SHAPES), ids=lambda s: SHARD_SHAPES[s])
def test_k1_k2_plans_at_shard_shapes(shape):
    """K1 (M = 1-32) and K2 (M = 33-2048) take every shard of the four
    geometries at tp 2, 4 and 8, on the padded K, at every group size."""
    k, kp, n, rope = shape
    for g in (32, 64, 128):
        if k % g:
            continue
        for m in (1, 8, 32):
            check_gemv_plan(qmc.gemv_plan(m, n, kp, g, rope), m, n, kp, g, rope)
        for m in (33, 512, 2048):
            check_gemm_plan(qmc.gemm_plan(m, n, kp, g, rope), m, n, kp, g, rope)


@pytest.mark.parametrize("geo", ["8B", "1B"])
@pytest.mark.parametrize("tp", TPS)
def test_k4_plan_at_sharded_widths(geo, tp):
    """K4's plan covers every stage once at the sharded Llama widths (the
    sharded model does not take K4: see the next test)."""
    cfg = GEOMETRIES[geo][0]
    shapes = ttp.projection_shards(cfg, tp)
    d_attn, d, di = shapes["wo"][0], cfg.hidden_size, shapes["wd"][0]
    for m in (1, tf.MAX_M):
        plan = tf.mlp_plan(m, d_attn, d, di, 4, 64)
        assert [(p.k, p.n) for p in plan.phases] == [(d_attn, d), (d, 2 * di), (di, d)]
        for phase in plan.phases:
            check_mlp_phase(phase, plan.blocks, di)


def test_k4_off_under_a_mesh():
    """At the 1B widths sharded over tp 2, K4's own gate takes the block,
    but a model with a mesh never fuses it: the residual add it fuses must
    wait for wo's all-reduce (JAX turns its fused MLP off under a mesh
    too)."""
    cfg = GEOMETRIES["1B"][0]
    shapes = ttp.projection_shards(cfg, 2)

    def stub(name):
        k, n, _ = shapes[name]
        return tq.QuantizedTensor(
            packed=torch.zeros((1, k // 8, n), dtype=torch.int32),
            scales=torch.zeros((1, k // 64, n), dtype=torch.bfloat16),
            biases=torch.zeros((1, k // 64, n), dtype=torch.bfloat16), bits=4,
            group_size=64, shape=(k, n))

    p = {name: stub(name) for name in ("wo", "wgu", "wd")}
    assert tf.fused_mlp_supported(p["wo"], p["wgu"], p["wd"], 1)
    model = LlamaModel(ttp.local_config(cfg, 2))
    assert model._fused_mlp_ok(p, 1)
    model.mesh = object()  # any mesh
    assert not model._fused_mlp_ok(p, 1)


def test_shard_shapes_cover_the_padded_row_shards():
    """The shapes above include the row shards that needed re-padding."""
    names = {v for v in SHARD_SHAPES.values()}
    ks = {(k, kp) for (k, kp, _, _) in SHARD_SHAPES}
    assert (1792, 2048) in ks  # 8B wd at tp 8
    assert (896, 1024) in ks  # Qwen2.5-VL-7B wo at tp 4
    assert (9472, 9728) in ks  # Qwen2.5-VL-7B wd at tp 2
    assert (256, 512) in ks  # Gemma-3 4B wo at tp 8
    assert any("gemma3-4b" in n for n in names) and any("qwen" in n for n in names)


def test_shard_shapes_only_where_the_heads_split():
    """projection_shards lists what a rank runs: Qwen2.5-VL-7B's 28 query
    heads refuse tp 8 (local_config does too), and Gemma-3 4B at tp 8
    holds one whole KV head a rank (its 4 replicated twice), not half of
    one."""
    with pytest.raises(ValueError, match="Hq=28"):
        ttp.projection_shards(GEOMETRIES["qwen2.5-vl-7b"][0], 8, False, True)
    g8 = ttp.projection_shards(GEOMETRIES["gemma3-4b"][0], 8, False, False)
    assert g8["wk"] == g8["wv"] == (2560, 256, 0) and g8["wq"] == (2560, 256, 0)
    assert g8["wo"] == (256, 2560, 0)


@pytest.mark.parametrize("tp", [2, 4])
def test_projection_shards_are_the_shards_a_rank_holds(gqa, fake_mesh, tp):
    """On the INT4 Hkv = 2 Llama, projection_shards gives each quantized
    leaf's shape on a rank: at tp 4 after replicate_kv_heads (factor 2),
    as a rank that runs it holds it."""
    _, _, jq, cfg = gqa
    params = from_jax_params(jax_to_np(jq), "cpu")
    held_cfg = cfg
    if tp > cfg.num_key_value_heads:
        params, held_cfg = ttp.replicate_kv_heads(params, cfg, tp // cfg.num_key_value_heads)
    shard = ttp.shard_params(params, fake_mesh(tp, tp - 1), held_cfg)["layers"]
    shapes = ttp.projection_shards(cfg, tp, quantized_head=False)
    assert set(shapes) == {"wqkv", "wgu", "wo", "wd"}
    for name, (k, n, _) in shapes.items():
        assert shard[name].shape == (k, n), name
    loc = ttp.rank_config(cfg, tp)
    assert loc.num_key_value_heads == 1  # tp 4: after replication
    assert loc.num_attention_heads == 8 // tp
