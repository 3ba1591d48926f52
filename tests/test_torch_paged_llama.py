"""The port's forwards over the paged KV pool (LlamaModel.paged_forward and
mixed_forward) against the JAX package's on the same 2-layer narrow model
and the same pool writes: a prefill chunk with padded lanes then decode
steps with a frozen lane, and mixed steps with a rider, an empty rider and
frozen lanes. Logits agree to 1e-5 with dense weights and an f32 pool, and
to 1e-2 with INT4 weights or an INT8 pool: both cast activations to bf16
at the JAX cast points (the quantized matmul its input, the INT8 attention
its queries and probabilities), where values an f32 ulp apart may round
to neighbouring bf16 values; test_torch_llama states and witnesses that
tolerance. Pool pages [0, P) agree after the same writes, to the same
tolerances (an INT8 code one step off is 1/127 of its row's range)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.cache import paged as jpaged
from pie_tpu_torch.cache import paged as tpaged

from test_torch_llama import build_pair, small_config

PAGES, MAXP = 16, 3

CASES = {
    # name: (hidden, weights, int8 pool, tolerance)
    "dense_f32_dh64": (256, "dense", False, 1e-5),
    "int4_g64_dh128": (512, "int4_g64", False, 1e-2),
    "dense_int8_pool": (256, "dense", True, 1e-2),
}


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


class Pair:
    """The JAX and port models on the same weights with pools of both, fed
    the same numpy inputs."""

    def __init__(self, case):
        hidden, weights, quantized, self.tol = CASES[case]
        cfg = small_config(hidden, 4, 2)
        self.jm, self.jp, self.tm, self.tp = build_pair(cfg, weights)
        dh = hidden // 4
        self.jpool = jpaged.PagedKVPool.create(2, PAGES, 2, dh, jnp.float32, quantized)
        self.tpool = tpaged.PagedKVPool.create(2, PAGES, 2, dh, torch.float32,
                                               quantized, device="cpu")
        self.tables = np.array([[3, 7, -1], [12, 0, 5], [9, -1, -1]], np.int32)

    def paged(self, ids, pos, ctx, rows=None):
        rows = list(range(3)) if rows is None else rows
        bt = self.tables[rows]
        lj, self.jpool = self.jm.paged_forward(
            self.jp, jnp.asarray(ids), self.jpool, jnp.asarray(bt), jnp.asarray(pos),
            jnp.asarray(ctx))
        with torch.no_grad():
            lt, pool = self.tm.paged_forward(
                self.tp, torch.from_numpy(ids), self.tpool, torch.from_numpy(bt),
                torch.from_numpy(pos), torch.from_numpy(ctx))
        assert pool is self.tpool
        return np.asarray(lj), lt.numpy()

    def mixed(self, dec_tok, dec_pos, dec_ctx, pf_ids, pf_pos, pf_lane, pf_ctx):
        a = lambda x: np.asarray(x, np.int32)
        lj, self.jpool = self.jm.mixed_forward(
            self.jp, self.jpool, jnp.asarray(a(dec_tok)), jnp.asarray(a(dec_pos)),
            jnp.asarray(a(dec_ctx)), jnp.asarray(self.tables), jnp.asarray(a(pf_ids)),
            jnp.asarray(a(pf_pos)), jnp.int32(pf_lane), jnp.int32(pf_ctx))
        t = lambda x: torch.from_numpy(a(x))
        with torch.no_grad():
            lt, _ = self.tm.mixed_forward(
                self.tp, self.tpool, t(dec_tok), t(dec_pos), t(dec_ctx),
                torch.from_numpy(self.tables), t(pf_ids), t(pf_pos), t([pf_lane]),
                t([pf_ctx]), pf_any=bool((a(pf_ids) >= 0).any()))
        return np.asarray(lj), lt.numpy()

    def check_pool(self):
        """Pages [0, P) of the two pools agree (dequantized for INT8)."""
        def dense(pool, k, s, n):
            a = np.asarray(getattr(pool, k)[:, :n], np.float32)
            if pool.quantized:
                sc = getattr(pool, s)
                sc = (np.asarray(jpaged.unpermute_page_scales(sc)) if n is None
                      else sc[:, :n].numpy()[..., None])
                a = a * sc
            return a

        for k, s in (("k", "k_scale"), ("v", "v_scale")):
            want = dense(self.jpool, k, s, None)
            got = dense(self.tpool, k, s, PAGES)
            assert _norm_err(got, want) < self.tol


PROMPTS = np.random.default_rng(0).integers(0, 512, (3, 40)).astype(np.int32)
LENS = (40, 20, 33)


@pytest.mark.parametrize("case", list(CASES))
def test_paged_forward_matches_jax(case):
    """A padded prefill chunk of three lanes, then four decode steps, the
    third with lane 1 frozen (position -1, context 1)."""
    pr = Pair(case)
    pos = np.where(np.arange(40)[None] < np.array(LENS)[:, None],
                   np.arange(40)[None], -1).astype(np.int32)
    ids = np.where(pos >= 0, PROMPTS, 0).astype(np.int32)
    lj, lt = pr.paged(ids, pos, np.array(LENS, np.int32))
    assert lt.shape == lj.shape == (3, 40, 512)
    valid = pos >= 0
    assert _norm_err(lt[valid], lj[valid]) < pr.tol
    ctx = np.array(LENS, np.int32)
    tok = ids[np.arange(3), ctx - 1]
    for step in range(4):
        frozen = np.array([False, step == 2, False])
        dpos = np.where(frozen, -1, ctx).astype(np.int32)
        dctx = np.where(frozen, 1, ctx + 1).astype(np.int32)
        lj, lt = pr.paged(tok[:, None], dpos[:, None], dctx)
        assert _norm_err(lt[~frozen], lj[~frozen]) < pr.tol, step
        tok = lj[:, 0].argmax(-1).astype(np.int32)
        ctx = np.where(frozen, ctx, ctx + 1).astype(np.int32)
    pr.check_pool()


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_forward_matches_jax(case):
    """Lanes 0 and 1 prefilled, lane 2's prompt arriving as riders: a mixed
    step with a rider while lane 2 is frozen, a step with an empty rider
    after lane 2 wakes, then a rider for lane 1's next tokens with lane 1
    frozen."""
    pr = Pair(case)
    pos = np.where(np.arange(40)[None] < np.array([40, 20])[:, None],
                   np.arange(40)[None], -1).astype(np.int32)
    ids = np.where(pos >= 0, PROMPTS[:2], 0).astype(np.int32)
    pr.paged(ids, pos, np.array([40, 20], np.int32), rows=[0, 1])
    cs = 24
    rider = np.full(cs, -1, np.int32)
    rider_pos = np.full(cs, -1, np.int32)
    rider[:20] = PROMPTS[2, :20]
    rider_pos[:20] = np.arange(20)
    steps = [
        # (dec tokens, dec positions, dec ctx, rider ids, rider pos, lane, ctx)
        ([PROMPTS[0, 39], PROMPTS[1, 19], 0], [39, 19, -1], [40, 20, 1],
         rider, rider_pos, 2, 20),
        ([11, 12, PROMPTS[2, 20]], [40, 20, 20], [41, 21, 21],
         np.full(cs, -1), np.full(cs, -1), 0, 0),
        ([13, 0, 14], [41, -1, 21], [42, 1, 22],
         np.r_[[101, 102, 103], np.full(cs - 3, -1)],
         np.r_[[21, 22, 23], np.full(cs - 3, -1)], 1, 24),
    ]
    for i, step in enumerate(steps):
        lj, lt = pr.mixed(*step)
        assert lt.shape == lj.shape == (3, 512)
        live = np.asarray(step[1]) >= 0
        assert _norm_err(lt[live], lj[live]) < pr.tol, i
    pr.check_pool()
