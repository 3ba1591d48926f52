"""The port's paged KV pool (pie_tpu_torch.cache.paged) and paged decode
attention (pie_tpu_torch.ops.paged_attention) against the JAX package's:
page bookkeeping and the prefix store (behaviour, not page ids: the JAX
allocator may be the native one), pool writes and gathers for f32, bf16
and INT8 pages, and the plain attention against JAX's XLA version (f32,
2e-5) and its Pallas kernels run in interpret mode (2e-3), over ragged
lengths, shuffled -1-padded tables, sliding windows, a non-zero layer and
head dims 64 and 128."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.cache import paged as jpaged
from pie_tpu.ops import paged_attention as jpa
from pie_tpu_torch.cache import paged as tpaged
from pie_tpu_torch.ops import paged_attention as tpa

PAGE = tpaged.PAGE_SIZE
LAYERS, PAGES, MAXP = 2, 24, 4
LENS = (1, 63, 64, 65, 130)
WINDOWS = (0, 1, 64, 100)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- page bookkeeping ----------------------------------------------------------


def _manager_story(mod):
    """The operations of the JAX package's manager tests; returns what each
    step observes."""
    seen = []
    m = mod.PagedCacheManager(num_pages=8, max_pages_per_seq=4)
    seen += [m.allocate_seq(1, 100), len(m.block_table(1))]
    seen += [m.extend_seq(1, 130), len(m.block_table(1))]
    seen += [m.extend_seq(1, 140), len(m.block_table(1))]
    m.free_seq(1)
    seen.append(m.num_free_pages())
    with pytest.raises(ValueError):
        m.allocate_seq(2, 5 * PAGE)
    m = mod.PagedCacheManager(num_pages=4, max_pages_per_seq=4)
    seen += [m.allocate_seq(1, 3 * PAGE), m.allocate_seq(2, 2 * PAGE)]
    seen.append(m.num_free_pages())
    m.free_seq(1)
    seen += [m.allocate_seq(2, 2 * PAGE), m.num_free_pages()]
    return seen


def test_manager_matches_jax():
    want = [True, 2, True, 3, True, 3, 8, True, False, 1, True, 2]
    assert _manager_story(jpaged) == _manager_story(tpaged) == want


def _prefix_story(mod):
    """The JAX package's PrefixStore tests as one story: match, insert,
    longest-prefix hits, refcounts, LRU eviction of leaves, and the roll
    back of a failed allocation."""
    seen = []
    mgr = mod.PagedCacheManager(num_pages=16, max_pages_per_seq=8)
    store = mod.PrefixStore(mgr)
    prompt = list(range(3 * PAGE + 5))
    seen.append(store.match(prompt))
    seen.append(mgr.allocate_seq(1, len(prompt)))
    table = list(mgr.block_table(1))
    store.insert(prompt, table)
    seen.append(len(store))
    seen.append(store.match(prompt) == table[:3])
    seen.append(store.match(prompt[:2 * PAGE + 1]) == table[:2])
    diverged = list(prompt)
    diverged[PAGE] = 999
    seen.append(store.match(diverged) == table[:1])
    seen.append(store.match(prompt[:2 * PAGE]) == table[:1])
    free = mgr.num_free_pages()
    mgr.free_seq(1)
    seen.append(mgr.num_free_pages() - free)
    seen.append([mgr.allocator.ref_count(p) for p in table[:3]])
    seen.append(store.evict(1))
    seen.append(store.match(prompt) == table[:2])
    seen.append(store.evict(10))
    seen.append(store.match(prompt))
    seen.append(mgr.num_free_pages())
    seen.append((store.hits, store.misses, store.hit_tokens))

    mgr = mod.PagedCacheManager(num_pages=4, max_pages_per_seq=8)
    store = mod.PrefixStore(mgr)
    prompt = list(range(2 * PAGE + 1))
    seen.append(mgr.allocate_seq(1, len(prompt)))
    store.insert(prompt, mgr.block_table(1))
    mgr.free_seq(1)
    shared = store.match(prompt)
    seen.append(len(shared))
    seen.append(mgr.allocate_seq_with_prefix(2, 5 * PAGE, shared))
    seen.append(mgr.num_free_pages())
    store.clear()
    seen.append(mgr.num_free_pages())
    return seen


def test_prefix_store_matches_jax():
    want = [[], True, 3, True, True, True, True, 1, [1, 1, 1], 1, True, 2, [],
            16, (5, 2, 9 * PAGE), True, 2, False, 2, 4]
    assert _prefix_story(jpaged) == _prefix_story(tpaged) == want


# -- pool writes and gathers ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def build_pools(d, quantized, dtype="f32", hkv=2, seed=0):
    """The same tokens written through both packages' ``write_tokens`` into
    pools of both packages, one call per (sequence, layer); layer i holds
    other values than layer 0. Returns (JAX pool, port pool, tables), shared
    between tests: a test that writes calls ``build_pools.__wrapped__``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(PAGES)
    bt = np.full((len(LENS), MAXP), -1, np.int32)
    for i, n in enumerate(LENS):
        k = -(-n // PAGE)
        bt[i, :k] = perm[i * MAXP:i * MAXP + k]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jpool = jpaged.PagedKVPool.create(LAYERS, PAGES, hkv, d, jdt, quantized)
    tpool = tpaged.PagedKVPool.create(LAYERS, PAGES, hkv, d, tdt, quantized,
                                      device="cpu")
    for i, n in enumerate(LENS):
        pos = np.arange(n, dtype=np.int32)[None]
        for layer in range(LAYERS):
            k, v = rng.standard_normal((2, 1, n, hkv, d)).astype(np.float32)
            jpool = jpaged.write_tokens(jpool, jnp.asarray(k), jnp.asarray(v), layer,
                                        jnp.asarray(bt[i:i + 1]), jnp.asarray(pos))
            out = tpaged.write_tokens(tpool, torch.from_numpy(k), torch.from_numpy(v),
                                      layer, torch.from_numpy(bt[i:i + 1]),
                                      torch.from_numpy(pos))
            assert out is tpool  # written in place
    return jpool, tpool, bt


def _np(t):
    return t.to(torch.float32).numpy() if t.is_floating_point() else t.numpy()


@pytest.mark.parametrize("quantized,dtype", [(False, "f32"), (False, "bf16"),
                                             (True, "f32")])
@pytest.mark.parametrize("d", [64, 128])
def test_write_and_gather_match_jax(d, quantized, dtype):
    jpool, tpool, bt = build_pools(d, quantized, dtype)
    assert tpool.num_pages == jpool.num_pages == PAGES
    # pages [0, P) hold the same values; page P is the port's scratch page
    np.testing.assert_array_equal(_np(tpool.k[:, :PAGES]),
                                  np.asarray(jpool.k, np.float32))
    np.testing.assert_array_equal(_np(tpool.v[:, :PAGES]),
                                  np.asarray(jpool.v, np.float32))
    if quantized:
        for jt, tt in ((jpool.k_scale, tpool.k_scale), (jpool.v_scale, tpool.v_scale)):
            natural = np.asarray(jpaged.unpermute_page_scales(jt))[..., 0]
            np.testing.assert_allclose(_np(tt[:, :PAGES]), natural, rtol=1e-6, atol=0)
    for layer in range(LAYERS):
        jk, jv = jpaged.gather_kv(jpool, layer, jnp.asarray(bt), jnp.float32)
        tk, tv = tpaged.gather_kv(tpool, layer, torch.from_numpy(bt), torch.float32)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_invalid_writes_land_on_the_scratch_page(quantized):
    """Writes JAX drops (position -1, a -1 table entry) go to page P, so the
    pages a table can name keep their values and no count is read back."""
    _, tpool, bt = build_pools.__wrapped__(64, quantized)
    before = [a[:, :PAGES].clone() for a in (tpool.k, tpool.v)]
    k = torch.ones((2, 3, 2, 64))
    pos = torch.tensor([[-1, -1, -1], [200, 201, -1]], dtype=torch.int32)
    tables = torch.from_numpy(bt[[0, 1]])  # lane 1's 4th page is a -1 pad
    tpaged.write_tokens(tpool, k, k, 1, tables, pos)
    for a, b in zip((tpool.k, tpool.v), before):
        assert torch.equal(a[:, :PAGES], b)
    assert tpool.k[1, PAGES].abs().sum() > 0
    phys, slot = tpaged.page_slots(tables, pos, PAGES)
    assert (phys == PAGES).all() and (slot == pos % PAGE).all()


# -- paged decode attention ----------------------------------------------------


def _queries(d, hq=4, seed=1):
    q = np.random.default_rng(seed).standard_normal((len(LENS), hq, d))
    return q.astype(np.float32)


def _port_attn(tpool, q, bt, layer, window):
    return tpa.paged_attention_decode(
        torch.from_numpy(q), tpool.k, tpool.v, tpool.k_scale, tpool.v_scale, layer,
        torch.from_numpy(bt), torch.tensor(LENS, dtype=torch.int32),
        q.shape[-1] ** -0.5, window,
    ).numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_attention_matches_xla(d, quantized):
    jpool, tpool, bt = build_pools(d, quantized)
    q = _queries(d)
    lens = jnp.asarray(np.array(LENS, np.int32))
    for layer in range(LAYERS):
        for window in WINDOWS:
            want = jpa.paged_attention_xla(
                jnp.asarray(q), jpool.k[layer], jpool.v[layer], jnp.asarray(bt), lens,
                d ** -0.5, jpool.k_scale[layer] if quantized else None,
                jpool.v_scale[layer] if quantized else None, window=window,
            )
            got = _port_attn(tpool, q, bt, layer, window)
            np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_attention_matches_pallas_interpret(d, quantized):
    """Against both TPU kernels (the port's one kernel K3 replaces them):
    the per-layer kernel over every window, the stacked one at layer 1."""
    jpool, tpool, bt = build_pools(d, quantized)
    q = _queries(d, seed=2)
    lens = jnp.asarray(np.array(LENS, np.int32))
    layer = 1
    for window in WINDOWS:
        want = jpa.paged_attention_decode(
            jnp.asarray(q), jpool.k[layer], jpool.v[layer], jpool.k_scale[layer],
            jpool.v_scale[layer], jnp.asarray(bt), lens, d ** -0.5,
            window=jnp.int32(window), interpret=True,
        )
        got = _port_attn(tpool, q, bt, layer, window)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    want = jpa.paged_attention_decode_stacked(
        jnp.asarray(q), jpool.k, jpool.v, jpool.k_scale, jpool.v_scale,
        jnp.int32(layer), jnp.asarray(bt), lens, d ** -0.5, window=jnp.int32(100),
        interpret=True,
    )
    np.testing.assert_allclose(_port_attn(tpool, q, bt, layer, 100), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the plain version itself; K3's launch
    count does not move."""
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    _, tpool, bt = build_pools(64, True)
    q = _queries(64)
    qmc.reset_counts()
    args = (tpool.k, tpool.v, tpool.k_scale, tpool.v_scale, 1,
            torch.from_numpy(bt), torch.tensor(LENS, dtype=torch.int32), 0.125, 64)
    got = tpa.paged_attention_decode(torch.from_numpy(q), *args)
    assert torch.equal(got, tpa.paged_attention_ref(torch.from_numpy(q), *args))
    assert qmc.launch_counts["K3"] == 0
