"""The decode MLP block in one launch: a hand-written CUDA kernel (K4) and
the plain PyTorch version beside it.

Replaces the TPU kernel ``pie_tpu/ops/fused_mlp_pallas.py``
``fused_mlp_stacked``: ``h2 = h + attn @ wo``, ``x = rms_norm(h2) * ln2``,
``g, u = x @ wgu``, ``out = h2 + (silu(g) * u) @ wd`` for M <= 8 rows and
group-wise quantized weights stacked over layers.

- ``fused_mlp_supported`` is a copy of the JAX package's gate, tile
  divisibility terms included, so the port takes the fused path exactly
  where the reference does.
- ``fused_mlp_ref`` is the plain version, with the reference kernel's
  rounding points: the residual adds in bf16, the norm statistic in f32,
  bf16 ``gu`` and ``act``; each dot is the port's ``quant_matmul_ref``.
- ``fused_mlp_cuda`` launches K4 (``csrc/fused_mlp.cu``): one cooperative
  launch per call, three split-K GEMV phases on K1's tensor-core machinery
  (``csrc/gemv_tile.cuh``) with two grid barriers, the weights streamed
  through a TMA ring that runs ahead across the barriers. ``mlp_plan``
  lays out its tiles, K splits, grid and ring; the weights' tensor maps
  are encoded once per stacked weight and cached. Bound by bytes: one
  layer's packed words plus scales and biases of wo, wgu and wd over
  3.35 TB/s.
- ``fused_mlp_stacked`` routes: a CPU tensor to the plain version, a CUDA
  tensor to K4, which launches or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.quant import QuantizedTensor

# the JAX kernel's tiles, which its gate asks the dims to divide into
BN = 2048
BK_O = 1024   # wo K tile
BK_G = 2048   # wgu / wd K tile
#: rows K4 takes (the decode batch of the reference's gate; one n8 mma tile)
MAX_M = 8
#: K4's tile: 128 output features (a wgu tile: 64 g features and the 64 u
#: features they pair with); K rows of one TMA ring stage (csrc/gemv_tile.cuh)
TILE_N, STAGE_K = 128, 128
#: K4's resident blocks per SM where the card is not asked (its ring, as
#: K1's, is sized for two)
BLOCKS_PER_SM = 2
#: grid barriers per call: after h2 (the norm needs all of it), after act
GRID_BARRIERS = 2
#: the widest model K4 takes (its ln2 row is kept in shared memory, kMaxD)
MAX_D = 4096
#: the ring's bytes per block and its most stages (kRingBudget, kMaxStages)
_RING_BUDGET, _MAX_STAGES = 100 * 1024, 8

_lock = threading.Lock()
_workspaces: dict = {}  # per device: K4's scratch (partial sums, h2, act)
#: workspaces a larger one replaced: a CUDA graph captured over one still
#: writes into it at every replay, so it is never freed
_retired: list = []
_maps: dict = {}  # per stacked weight: its three encoded tensor maps
_blocks: dict = {}  # per (device, format): resident blocks per SM


def fused_mlp_supported(qt_wo, qt_wgu, qt_wd, m: int) -> bool:
    """Static gate: decode-sized batch, tile-divisible dims, stacked
    weights with a shared group size (the JAX package's rule)."""
    try:
        d_attn, d = qt_wo.shape
        d2, di2 = qt_wgu.shape
        di, d3 = qt_wd.shape
        stacked = qt_wo.packed.dim() == 3
    except (AttributeError, TypeError, ValueError):
        return False
    return (
        m <= MAX_M
        and stacked
        and d == d2 == d3
        and di2 == 2 * di
        and d % BN == 0 and di2 % BN == 0 and di % BK_G == 0
        and d_attn % BK_O == 0 and d % BK_G == 0
        and qt_wo.padded_k == d_attn and qt_wgu.padded_k == d
        and qt_wd.padded_k == di
        and qt_wo.group_size == qt_wgu.group_size == qt_wd.group_size
        and qt_wo.bits == qt_wgu.bits == qt_wd.bits
        and qt_wo.group_size <= BK_O
    )


def fused_mlp_ref(attn, h_in, ln2_w, layer, wo: QuantizedTensor,
                  wgu: QuantizedTensor, wd: QuantizedTensor, eps: float = 1e-5):
    """Plain version of K4; attn [M, d_attn], h_in [M, d], ln2_w [d] or
    [L, d] -> [M, d] in h_in's dtype. ``quant_matmul_ref`` of an f32 input
    that holds bf16 values returns its f32 accumulation unrounded."""
    bf, f32 = torch.bfloat16, torch.float32
    dot = lambda x, qt: qmc.quant_matmul_ref(x.to(bf).to(f32), qt, layer=layer)
    h2 = (h_in.to(f32) + dot(attn, wo).to(bf).to(f32)).to(bf)
    hf = h2.to(f32)
    inv = torch.rsqrt((hf * hf).sum(-1, keepdim=True) / hf.shape[-1] + eps)
    xg = (hf * inv * qmc._ln_row(ln2_w, layer, True).to(f32)).to(bf)
    gu = dot(xg, wgu).to(bf).to(f32)
    di = gu.shape[-1] // 2
    g, u = gu[..., :di], gu[..., di:]
    act = (g * torch.sigmoid(g) * u).to(bf)
    return h2.to(h_in.dtype) + dot(act, wd).to(h_in.dtype)


def ring_stages(bits: int, group_size: int, f32_scales: bool = False) -> int:
    """Stages of K4's TMA ring (``ring_stages`` in csrc/gemv_tile.cuh at 8
    token rows): x boxes, words, scale and bias rows and x sums of 128 K
    rows, rounded up to 1 KB, as many as 100 KB hold, at most 8."""
    tx = 2 * MAX_M * 128 + STAGE_K * bits // 32 * TILE_N * 4 + 2 * (
        STAGE_K // group_size * TILE_N * (4 if f32_scales else 2))
    stage = -(-(tx + 4 * MAX_M * 4) // 1024) * 1024
    return min(_RING_BUDGET // stage, _MAX_STAGES)


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """One GEMV phase of K4: ``tiles`` 128-feature tiles over K = ``k`` in
    ``stages`` 128-row stages, each tile's K split into ``splits`` ranges
    of ``stages_per_split`` stages (the last may be shorter); task
    ``split * tiles + tile`` runs on block ``task % blocks``."""

    name: str
    k: int
    n: int
    tiles: int
    stages: int
    splits: int
    stages_per_split: int

    @property
    def tasks(self) -> int:
        return self.tiles * self.splits

    def split_stages(self, split: int) -> range:
        lo = split * self.stages_per_split
        return range(lo, min(self.stages, lo + self.stages_per_split))

    def tile_features(self, tile: int, di: int = 0) -> list[int]:
        """The weight columns of a tile (wgu: g features [64 j, 64 j + 64)
        then the u features di + [64 j, 64 j + 64))."""
        if self.name == "wgu":
            lo = tile * TILE_N // 2
            return list(range(lo, lo + TILE_N // 2)) + list(range(di + lo, di + lo + TILE_N // 2))
        return list(range(tile * TILE_N, (tile + 1) * TILE_N))


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """K4's launch for one call: ``blocks`` resident blocks (the cooperative
    grid), a ring of ``ring_stages`` stages per block, the three phases
    (wo, wgu, wd) and the scratch they need."""

    m: int
    d_attn: int
    d: int
    di: int
    bits: int
    group_size: int
    f32_scales: bool
    blocks: int
    ring_stages: int
    phases: tuple

    grid_barriers = GRID_BARRIERS

    @property
    def counters(self) -> int:
        """Zeroed words kept between calls: two grid barriers (tile
        arrivals, generation), then one split counter per tile of each
        phase."""
        return 2 * GRID_BARRIERS + sum(p.tiles for p in self.phases)

    @property
    def workspace_bytes(self) -> int:
        """f32 partials [tiles, splits, M, 128] of each split phase (split
        0's block keeps its own in shared memory), each
        row's sum of squares per wo tile (padded to 16 bytes), then h2
        [M, d] and act [M, di] bf16 (``workspace_need`` in csrc/fused_mlp.cu)."""
        floats = sum(p.tiles * p.splits * self.m * TILE_N for p in self.phases
                     if p.splits > 1)
        floats += -(-self.phases[0].tiles * self.m // 4) * 4
        return 4 * floats + 2 * self.m * (self.d + self.di)

    def summary(self) -> dict:
        """What chip_smoke.py prints beside K4's times."""
        return dict(blocks=self.blocks, ring_stages=self.ring_stages,
                    grid_barriers=self.grid_barriers,
                    **{f"{p.name} tiles x splits x stages": [p.tiles, p.splits,
                                                            p.stages_per_split]
                       for p in self.phases})


def _phase(name: str, k: int, n: int, tiles: int, blocks: int) -> PhasePlan:
    stages = k // STAGE_K
    want = 1 if tiles >= blocks else max(1, min(stages, blocks // tiles))
    per = -(-stages // want)
    return PhasePlan(name=name, k=k, n=n, tiles=tiles, stages=stages,
                     splits=-(-stages // per), stages_per_split=per)


@functools.lru_cache(maxsize=1024)
def mlp_plan(m: int, d_attn: int, d: int, di: int, bits: int, group_size: int,
             f32_scales: bool = False, sms: int = qmc.H100_SMS,
             blocks_per_sm: int = BLOCKS_PER_SM) -> MlpPlan:
    """K4's tiles, K splits, grid and ring for the block at these widths.

    The grid is every resident block (``blocks_per_sm`` x ``sms``: the
    cooperative launch needs them all resident). Each phase splits its
    tiles' K into ranges of whole 128-row stages, as many as keep its
    tasks to one task per block (a tile count that covers the grid is not
    split), as K1's ``gemv_plan`` does for one wave. One task per block is
    also what keeps the split-K wait safe: split 0's block owns a tile and
    waits for the other splits' partials, so none of them may sit behind
    it on the same block (the kernel refuses such a plan). At the Llama-3.2-1B
    widths on an H100 (264 blocks): wo 16 tiles x 16 splits of 1 stage,
    wgu 128 x 2 of 8, wd 16 x 16 of 4, so each block streams 13 stages.
    Raises ValueError for what K4 does not take (M outside 1..8, widths not
    whole tiles and stages, a format outside INT4/INT8 x g 32/64/128)."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"K4 takes 1..{MAX_M} rows, got {m}")
    if bits not in (4, 8) or group_size not in (32, 64, 128):
        raise ValueError(f"K4 takes INT4/INT8 with g in (32, 64, 128), got "
                         f"bits={bits}, g={group_size}")
    if (min(d_attn, d, di) < TILE_N or d_attn % STAGE_K or d % TILE_N or di % TILE_N
            or d > MAX_D):
        raise ValueError(f"K4 needs d_attn, d and di multiples of {TILE_N} and "
                         f"d <= {MAX_D}, got {d_attn}, {d}, {di}")
    if sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"no resident blocks: {sms} SMs x {blocks_per_sm}")
    blocks = sms * blocks_per_sm
    phases = (_phase("wo", d_attn, d, d // TILE_N, blocks),
              _phase("wgu", d, 2 * di, di // (TILE_N // 2), blocks),
              _phase("wd", di, d, d // TILE_N, blocks))
    return MlpPlan(m=m, d_attn=d_attn, d=d, di=di, bits=bits, group_size=group_size,
                   f32_scales=bool(f32_scales), blocks=blocks,
                   ring_stages=ring_stages(bits, group_size, f32_scales), phases=phases)


def _workspace(device: torch.device, nbytes: int) -> torch.Tensor:
    """The device's K4 workspace, grown as needed and kept between calls,
    which run one at a time on the current stream. A workspace that a
    larger plan replaces stays allocated (``_retired``): a graph captured
    at a smaller M keeps its address."""
    with _lock:
        ws = _workspaces.get(device)
        if ws is None or ws.numel() < nbytes:
            if ws is not None:
                _retired.append(ws)
            ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
            _workspaces[device] = ws
        return ws


def _blocks_per_sm(device, bits: int, group_size: int, f32_scales: int, d: int) -> int:
    """K4's resident blocks per SM on this card for one weight format and
    model width (the occupancy query at its real shared memory)."""
    key = (device, bits, group_size, f32_scales, d)
    if key not in _blocks:
        with torch.cuda.device(device):
            n = qmc.kernel("fused_mlp_blocks_per_sm")(bits, group_size, f32_scales, d)
        if n <= 0:
            raise RuntimeError(f"K4 has no resident block per SM (CUDA error {-n})")
        _blocks[key] = n
    return _blocks[key]


def _tensor_maps(qt: QuantizedTensor) -> int:
    """Host address of the three TMA tensor maps (words, scales, biases) of
    a stacked weight, the layer a coordinate: encoded at its first call and
    cached, keyed on what a map holds (pointers, shapes, strides, dtype)."""
    p, s, b = qt.packed, qt.scales, qt.biases
    key = (p.device, p.data_ptr(), s.data_ptr(), b.data_ptr(), tuple(p.shape),
           tuple(s.shape), s.dtype, qt.bits, qt.group_size)
    with _lock:
        hit = _maps.get(key)
    if hit is not None:
        return hit[1]
    buf = ctypes.create_string_buffer(3 * 128 + 64)
    addr = -(-ctypes.addressof(buf) // 64) * 64
    err = qmc.kernel("fused_mlp_encode")(
        p.data_ptr(), s.data_ptr(), b.data_ptr(), p.shape[0], p.stride(0) * 4,
        s.stride(0) * s.element_size(), qt.padded_k, qt.shape[1], qt.bits,
        qt.group_size, qmc._f32_scales(qt), addr)
    if err:
        raise RuntimeError(f"K4's tensor maps did not encode: CUDA error {err}")
    with _lock:
        if len(_maps) >= 1024:
            _maps.clear()
        _maps[key] = (buf, addr)
    return addr


def fused_mlp_cuda(attn, h_in, ln2_w, layer, wo: QuantizedTensor,
                   wgu: QuantizedTensor, wd: QuantizedTensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """K4: one launch of the decode MLP block; attn [M, d_attn] and h_in
    [M, d] bf16 CUDA, M <= 8; stacked weights of one format; returns
    [M, d] bf16. The layer is a coordinate of the weights' tensor maps and
    a pointer offset into ``ln2_w`` ([d] row or [L, d] table)."""
    if attn.dim() != 2 or h_in.dim() != 2:
        raise ValueError(f"attn and h_in must be [M, *], got {tuple(attn.shape)}, "
                         f"{tuple(h_in.shape)}")
    m, d_attn = attn.shape
    d = h_in.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"K4 takes 1..{MAX_M} rows, got {m}")
    for name, qt in (("wo", wo), ("wgu", wgu), ("wd", wd)):
        if not isinstance(qt, QuantizedTensor) or not qt.stacked:
            raise ValueError(f"K4 needs stacked quantized {name}")
        if qt.padded_k != qt.shape[0] or qt.shape[0] % STAGE_K:
            raise ValueError(f"{name}: K = {qt.shape[0]} must be a multiple of "
                             f"{STAGE_K} with no padding")
    if not (wo.bits == wgu.bits == wd.bits
            and wo.group_size == wgu.group_size == wd.group_size):
        raise ValueError("K4 needs one bit width and one group size for wo, wgu, wd")
    if not wo.scales.dtype == wgu.scales.dtype == wd.scales.dtype:
        raise ValueError("K4 needs one scale dtype for wo, wgu, wd")
    di = wd.shape[0]
    if (wo.shape != (d_attn, d) or wgu.shape != (d, 2 * di)
            or wd.shape != (di, d)):
        raise ValueError(f"shapes wo {wo.shape}, wgu {wgu.shape}, wd {wd.shape} "
                         f"do not chain from attn [{m}, {d_attn}], h [{m}, {d}]")
    f32 = qmc._f32_scales(wo)
    plan = mlp_plan(m, d_attn, d, di, wo.bits, wo.group_size, bool(f32))  # ValueError
    qmc._check(attn, "attn", torch.bfloat16)
    qmc._check(h_in, "h_in", torch.bfloat16, (m, d))
    dev = attn.device
    for qt in (wo, wgu, wd):
        qmc._weight_ptrs(qt, layer, dev)  # device, scale dtype, layer range, alignment
    lw = qmc._ln_ptr(ln2_w, layer, wgu)
    plan = mlp_plan(m, d_attn, d, di, wo.bits, wo.group_size, bool(f32),
                    sms=qmc._device_sms(dev),
                    blocks_per_sm=_blocks_per_sm(dev, wo.bits, wo.group_size, f32, d))
    maps = [_tensor_maps(qt) for qt in (wo, wgu, wd)]
    out = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    ws = _workspace(dev, plan.workspace_bytes)
    counters = qmc._arrival_counters(dev, "K4")
    if plan.counters > counters.numel():
        raise ValueError(f"K4 needs {plan.counters} counters, has {counters.numel()}")
    po, pg, pd = plan.phases
    err = qmc.kernel("fused_mlp")(
        attn.data_ptr(), h_in.data_ptr(), lw, *maps, out.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), m, int(layer), d_attn, d, di, wo.bits, wo.group_size, f32,
        po.splits, po.stages_per_split, pg.splits, pg.stages_per_split,
        pd.splits, pd.stages_per_split, plan.blocks, plan.ring_stages, float(eps),
        ws.numel(), torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K4 (fused_mlp) launch failed: CUDA error {err}")
    qmc.launch_counts["K4"] += 1
    return out


def fused_mlp_stacked(attn, h_in, ln2_w, layer, wo: QuantizedTensor,
                      wgu: QuantizedTensor, wd: QuantizedTensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """The decode MLP block of layer ``layer`` (the JAX package's argument
    order): the plain version for CPU tensors, K4 for CUDA tensors."""
    if attn.device.type == "cpu":
        return fused_mlp_ref(attn, h_in, ln2_w, layer, wo, wgu, wd, eps)
    if attn.device.type != "cuda":
        raise ValueError(f"no fused MLP block for device {attn.device}")
    return fused_mlp_cuda(attn, h_in, ln2_w, layer, wo, wgu, wd, eps)
