"""B7, the read probe (pie_tpu_torch/tools/hbm_peak.py) on the CPU: its
plain version against the unedited JAX kernel benchmarks/hbm_peak.py
stream_read, run in TPU interpret mode; the wrapper's refusals; the launch
plan's slab dealing, emulated as the CUDA kernels index; and the one home
of the data sheet's rates. The kernels themselves run in
tests/test_torch_kernels.py on a card."""

import ast
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pie_tpu_torch.tools import hbm_peak as hp

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_probe():
    """benchmarks/hbm_peak.py loaded by path, benchmarks/ on sys.path for
    its trace_decode import."""
    bench = str(ROOT / "benchmarks")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location("jax_hbm_peak", ROOT / "benchmarks"
                                                      / "hbm_peak.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod


def _bits(shape, kind, seed):
    """uint32 bits of f32 values: integers in [-8, 8] or standard normals."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        vals = rng.integers(-8, 9, size=shape).astype(np.float32)
    else:
        vals = rng.standard_normal(shape).astype(np.float32)
    return vals.view(np.uint32)


def _jax_stream_read(mod, bits, rows):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.block_until_ready(mod.stream_read(jnp.asarray(bits), rows)))


@pytest.mark.parametrize("kind", ["int", "normal"])
@pytest.mark.parametrize("shape", [(8, 128), (64, 256), (128, 512)])
def test_plain_matches_jax_stream_read(jax_probe, shape, kind):
    """stream_read_plain equals the JAX kernel at rows = 8: exactly on
    integer-valued f32, within 1e-6 relative on random normals (the two
    sum the slabs in other orders)."""
    bits = _bits(shape, kind, seed=shape[0] + shape[1])
    want = _jax_stream_read(jax_probe, bits, 8)
    got = hp.stream_read_plain(torch.from_numpy(bits.view(np.int32))).numpy()
    assert got.shape == want.shape == (8, shape[1])
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_jax_folds_only_the_first_8_rows_of_each_block(jax_probe):
    """A recorded fact: at rows = 16 the JAX kernel adds the first 8 rows of
    each 16-row block and leaves the other 8 unused (its DMA still moves
    them). Only the rows = 8 function reads every row into the result, so
    that is the port's."""
    bits = _bits((64, 256), "int", seed=3)
    vals = bits.view(np.float32)
    got = _jax_stream_read(jax_probe, bits, 16)
    first8 = vals.reshape(4, 16, 256)[:, :8].sum(0)
    np.testing.assert_array_equal(got, first8)
    every_row = hp.stream_read_plain(torch.from_numpy(vals)).numpy()
    assert not np.array_equal(got, every_row)


@pytest.mark.parametrize("path", hp.PATHS)
def test_cpu_tensor_takes_the_plain_version(path):
    x = torch.from_numpy(_bits((64, 256), "normal", seed=5).view(np.float32))
    assert torch.equal(hp.stream_read(x, path), hp.stream_read_plain(x))
    assert hp.launch_counts == {"B7 ldg": 0, "B7 tma": 0}


def _x(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("x,kw,match", [
    (_x((12, 128)), {}, "multiple of 8"),
    (_x((0, 128)), {}, "multiple of 8"),
    (_x((8, 6)), {}, "multiple of 4"),
    (_x((8, 8, 8)), {}, r"\[R, n\]"),
    (_x((8, 256))[:, ::2], {}, "contiguous"),
    (_x((8, 128), torch.bfloat16), {}, "4-byte"),
    (_x((8, 128), torch.float64), {}, "4-byte"),
    (_x((8, 128)), dict(path="dma"), "path"),
    (_x((8, 128)), dict(unroll=3), "unroll"),
    (_x((8, 128)), dict(path="tma", chunk_kb=24), "chunk_kb"),
    (_x((8, 128)), dict(path="tma", stages=1), "stages"),
    (_x((8, 128)), dict(path="tma", chunk_kb=32, stages=8), "shared memory"),
])
def test_wrapper_refuses(x, kw, match):
    """On the CPU too, the wrapper refuses what the kernel does not take."""
    with pytest.raises(ValueError, match=match):
        hp.stream_read(x, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_wrapper_takes_4_byte_types(dtype):
    x = torch.from_numpy(_bits((16, 8), "int", seed=7).view(np.int32)).view(dtype)
    want = x.view(torch.float32).reshape(2, 8, 8).sum(0)
    assert torch.equal(hp.stream_read(x, "ldg"), want)


def test_read_rate_raises_above_the_data_sheet():
    gb = 4 * 2 ** 30
    ms = gb / hp.HBM_BYTES_PER_S * 1e3  # the data sheet's time
    assert hp.read_rate(gb, ms * 1.1) == pytest.approx(hp.HBM_BYTES_PER_S / 1.1)
    assert hp.read_rate(gb, ms) == pytest.approx(hp.HBM_BYTES_PER_S)
    with pytest.raises(ValueError, match="data sheet"):
        hp.read_rate(gb, ms * 0.99)
    with pytest.raises(ValueError, match="positive"):
        hp.read_rate(gb, 0.0)


def _dealt_slabs(plan):
    """Each slab's readers as the CUDA kernels index them: ldg warp w of
    slab group g reads slabs g*8 + w + k*(groups*8); a TMA block of group g
    reads g + k*groups. Returns {tile: [slab count per slab]}."""
    seen = {}
    for tile in range(plan.col_tiles):
        count = np.zeros(plan.slabs, dtype=int)
        for g in range(plan.groups):
            if plan.path == "ldg":
                step = plan.groups * hp.LDG_WARPS
                for w in range(hp.LDG_WARPS):
                    count[g * hp.LDG_WARPS + w::step] += 1
            else:
                count[g::plan.groups] += 1
        seen[tile] = count
    return seen


@pytest.mark.parametrize("path,knobs", [
    ("ldg", dict(blocks_per_sm=4, unroll=2)), ("ldg", dict(blocks_per_sm=1, unroll=8)),
    ("tma", dict(blocks_per_sm=3, chunk_kb=16, stages=4)),
    ("tma", dict(blocks_per_sm=1, chunk_kb=32, stages=7)),
])
@pytest.mark.parametrize("rows,n", [(8, 4), (64, 256), (8008, 2048), (4096, 2052),
                                    (524288, 2048), (8, 32768)])
def test_plan_reads_every_slab_once(path, knobs, rows, n):
    """Every slab of every column tile is read by exactly one warp (ldg) or
    block (tma); the grid fits one wave of blocks_per_sm x 132; the tiles
    cover the 2n float4 columns."""
    plan = hp.read_plan(rows, n, path, 132, **knobs)
    tile = hp.LDG_TILE_F4 if path == "ldg" else knobs["chunk_kb"] * 64
    assert (plan.col_tiles - 1) * tile < 2 * n <= plan.col_tiles * tile
    assert plan.grid <= max(plan.col_tiles, knobs["blocks_per_sm"] * 132)
    for count in _dealt_slabs(plan).values():
        assert (count == 1).all()


def test_plan_at_the_probe_size():
    """The CLI's 4 GiB buffer [524288, 2048] on 132 SMs: ldg at 4 blocks an
    SM is 32 tiles x 16 groups (128 KB in flight an SM at unroll 2), tma
    at 3 is 4 tiles x 99 groups (192 KB: 3 rings of 4 x 16 KB); both over
    the ~16-20 KB an SM that Little's law asks."""
    ldg = hp.read_plan(524288, 2048, "ldg", 132, 4, unroll=2)
    assert (ldg.col_tiles, ldg.groups, ldg.in_flight_per_sm) == (32, 16, 128 * 1024)
    tma = hp.read_plan(524288, 2048, "tma", 132, 3, chunk_kb=16, stages=4)
    assert (tma.col_tiles, tma.groups, tma.in_flight_per_sm) == (4, 99, 192 * 1024)
    assert tma.grid == 3 * 132


def _module_assigns(tree, names):
    return {t.id for node in tree.body if isinstance(node, ast.Assign)
            for t in node.targets if isinstance(t, ast.Name) and t.id in names}


RATES = {"HBM_BYTES_PER_S", "BF16_FLOP_PER_S"}


@pytest.mark.parametrize("path,names", [
    ("chip_smoke.py", RATES),
    ("pie_tpu_torch/tools/k1_breakdown.py", {"HBM_BYTES_PER_S"}),
    ("pie_tpu_torch/tools/k2_breakdown.py", {"BF16_FLOP_PER_S"}),
    ("pie_tpu_torch/tools/k3_sweep.py", {"HBM_BYTES_PER_S"}),
    ("pie_tpu_torch/tools/k4_breakdown.py", {"HBM_BYTES_PER_S"}),
])
def test_rates_come_from_the_probe_module(path, names):
    """chip_smoke.py and the tools import the data sheet's rates from
    tools/hbm_peak.py and keep no copy."""
    tree = ast.parse((ROOT / path).read_text())
    imported = {a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                and node.module == "pie_tpu_torch.tools.hbm_peak" for a in node.names}
    assert names <= imported
    assert not _module_assigns(tree, RATES)


def test_only_the_probe_module_defines_the_rates():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "pie_tpu_torch").rglob("*.py"))]
    owners = [f.relative_to(ROOT).as_posix() for f in files
              if _module_assigns(ast.parse(f.read_text()), RATES)]
    assert owners == ["pie_tpu_torch/tools/hbm_peak.py"]
