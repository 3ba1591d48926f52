"""Plain float32 reference of the decoders the benchmark serves.

One pre-norm decoder covers both configurations: Mistral / Llama (RMSNorm,
grouped-query attention with rotary positions, gated SiLU MLP, untied head)
and the text decoder of Qwen2-VL / Qwen2.5-VL, which adds q / k / v biases
and turns its rotary frequencies with M-RoPE: frequency j takes the
position stream (t, h, w) that ``mrope_section`` assigns it. Text tokens
put the same position on all three streams, and this reference builds the
three streams and applies them as M-RoPE does. A sequence with images
takes the vision features over its image placeholders and the streams of
``mrope_index`` (Qwen2-VL's ``get_rope_index``): an image's merged grid
spreads over (t, h, w) from the position after the text before it, and the
text after it goes on from the image's largest position + 1.

It works the served precision out again from the bf16 weights it is given,
independently of the program: each linear weight is quantized group-wise
along its input dimension (affine, unsigned codes, scale and minimum
rounded to bf16: ``quant_dequant``) and every key and value is rounded to
int8 with one scale per (token, head) (``kv_int8``). All arithmetic is
float32 with TF32 off. ``precision="fp8"`` is the control, a step below
the bf16 activations the configuration states: every activation is kept
in float8 e4m3 with one scale per row (the residual stream after each
addition, each linear layer's input and output, the attention's output).

Imports torch alone: nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FP8_MAX = 448.0


def quant_dequant(w_kn: torch.Tensor, group: int, bits: int) -> torch.Tensor:
    """The weight [K, N] as group-wise affine quantization stores it, in f32:
    per (group of ``group`` rows, column) min and max, codes
    round((w - min) / scale) in [0, 2**bits - 1] with scale = (max - min) /
    (2**bits - 1) (1 for a constant group), then codes * bf16(scale) +
    bf16(min)."""
    k, n = w_kn.shape
    if k % group:
        raise ValueError(f"K={k} is not a multiple of the group {group}")
    g = w_kn.to(torch.float32).reshape(k // group, group, n)
    wmin, wmax = g.amin(dim=1), g.amax(dim=1)
    levels = (1 << bits) - 1
    delta = (wmax - wmin) / levels
    scale = torch.where(delta > 1e-8, delta, torch.ones_like(delta))
    codes = torch.clamp(torch.round((g - wmin[:, None]) / scale[:, None]), 0, levels)
    s = scale.to(torch.bfloat16).to(torch.float32)
    b = wmin.to(torch.bfloat16).to(torch.float32)
    return (codes * s[:, None] + b[:, None]).reshape(k, n)


def kv_int8(x: torch.Tensor) -> torch.Tensor:
    """x [T, H, D] rounded to symmetric int8 with one scale per (token,
    head), returned dequantized in f32."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """The control's activations: each row scaled to e4m3's range, rounded
    to float8 e4m3, scaled back (f32)."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off inside, restored after."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def mrope_index(ids: list, image_token_id: int, vision_start_token_id: int,
                grids: list, merge: int) -> torch.Tensor:
    """The (t, h, w) position streams [3, T] of a token sequence with
    images, as Qwen2-VL's ``get_rope_index`` lays them out: each image
    follows a ``vision_start`` token and fills its ``t * (h / merge) *
    (w / merge)`` placeholders; text runs on one position for all three
    streams; an image's merged grid (frame, row, column) is offset by the
    position after the text before it, and the text after it starts at the
    image's largest position + 1. ``grids``: each image's (t, h, w) in
    patches, in order."""
    out, at, nxt = [], 0, 0  # streams so far, index in ids, next text position
    for t, h, w in grids:
        start = ids.index(vision_start_token_id, at) + 1
        if ids[start] != image_token_id:
            raise ValueError(f"no image placeholder after vision_start at {start - 1}")
        text = torch.arange(start - at) + nxt
        out.append(torch.stack([text, text, text]))
        nxt += start - at
        gh, gw = h // merge, w // merge
        tt = torch.arange(t).repeat_interleave(gh * gw)
        hh = torch.arange(gh).repeat_interleave(gw).repeat(t)
        ww = torch.arange(gw).repeat(t * gh)
        grid = torch.stack([tt, hh, ww]) + nxt
        out.append(grid)
        nxt = int(grid.max()) + 1
        at = start + t * gh * gw
    text = torch.arange(len(ids) - at) + nxt
    out.append(torch.stack([text, text, text]))
    return torch.cat(out, dim=1)


class Decoder:
    """The reference over a configuration dict (the HF ``config.json`` keys)
    and a weight source: ``layer(i)`` and ``top()`` return the bf16 HF
    tensors of layer i and of the embedding / norm / head."""

    def __init__(self, cfg: dict, layer, top, group: int = 64, bits: int = 4,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.cfg, self.layer, self.top = cfg, layer, top
        self.group, self.bits = group, bits
        self.fp8 = precision == "fp8"
        d = cfg["hidden_size"]
        self.hq, self.hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.dh = cfg.get("head_dim") or d // self.hq
        self.eps = float(cfg["rms_norm_eps"])
        rs = cfg.get("rope_scaling") or {}
        self.sections = rs.get("mrope_section")
        self.theta = float(cfg["rope_theta"])

    # -- pieces -------------------------------------------------------------

    def _w(self, w_nk: torch.Tensor) -> torch.Tensor:
        """An HF [out, in] bf16 weight -> the served [in, out] f32 weight."""
        return quant_dequant(w_nk.T.contiguous(), self.group, self.bits)

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_rows(x) if self.fp8 else x

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps)
        return x * inv * w.to(torch.float32)

    def _rope(self, x: torch.Tensor, pos3: torch.Tensor) -> torch.Tensor:
        """Rotate-half rotary embedding of x [T, H, D] at the position
        streams pos3 [3, T]; with M-RoPE sections, frequency j turns with
        stream section(j) (without them, with the first)."""
        half = self.dh // 2
        inv = 1.0 / (self.theta ** (torch.arange(0, self.dh, 2, dtype=torch.float64,
                                                 device=x.device) / self.dh))
        inv = inv.to(torch.float32)
        streams = pos3.to(torch.float32)  # [3, T]
        if self.sections:
            which = torch.repeat_interleave(
                torch.arange(3, device=x.device),
                torch.tensor(self.sections, device=x.device))
        else:
            which = torch.zeros(half, dtype=torch.long, device=x.device)
        ang = streams[which].T * inv  # [T, half]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attend(self, q, k, v) -> torch.Tensor:
        """Causal grouped-query attention, q [T, Hq, D], k / v [T, Hkv, D]."""
        t = q.shape[0]
        rep = self.hq // self.hkv
        qg = q.reshape(t, self.hkv, rep, self.dh).permute(1, 2, 0, 3)  # [G, r, T, D]
        kg = k.permute(1, 0, 2)[:, None]  # [G, 1, T, D]
        vg = v.permute(1, 0, 2)[:, None]
        s = torch.matmul(qg, kg.transpose(-1, -2)) * self.dh ** -0.5
        causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), vg)  # [G, r, T, D]
        return o.permute(2, 0, 1, 3).reshape(t, self.hq * self.dh)

    # -- forward ------------------------------------------------------------

    @torch.no_grad()
    def logits(self, seqs: list, rows: list, images: Optional[list] = None) -> list:
        """For each token sequence ``seqs[r]`` (a 1-D int64 tensor), the f32
        logits [len(rows[r]), V] at its positions ``rows[r]`` (each row's
        logits predict the token after it), computed layer by layer over all
        sequences so that each layer's weights are made once. ``images[r]``,
        where given and not None: (the vision features [n, D] written over
        the sequence's ``image_token_id`` placeholders in order, its
        position streams [3, T])."""
        with no_tf32():
            return self._logits(seqs, rows, images or [None] * len(seqs))

    def _logits(self, seqs, rows, images):
        top = self.top()
        emb = top["model.embed_tokens.weight"]
        hs, pos3s = [], []
        for s, img in zip(seqs, images):
            h = emb[s].to(torch.float32)
            if img is not None:
                h[s == self.cfg["image_token_id"]] = img[0].to(torch.float32)
            hs.append(self._x(h))
            pos3s.append(None if img is None else img[1].to(s.device))
        del emb
        for i in range(self.cfg["num_hidden_layers"]):
            w = self.layer(i)
            wq, wk, wv = (self._w(w[f"self_attn.{p}_proj.weight"]) for p in "qkv")
            wo = self._w(w["self_attn.o_proj.weight"])
            wg, wu = self._w(w["mlp.gate_proj.weight"]), self._w(w["mlp.up_proj.weight"])
            wd = self._w(w["mlp.down_proj.weight"])
            bias = {p: w[f"self_attn.{p}_proj.bias"].to(torch.float32)
                    for p in "qkv" if f"self_attn.{p}_proj.bias" in w}
            ln1, ln2 = w["input_layernorm.weight"], w["post_attention_layernorm.weight"]
            del w
            for r, h in enumerate(hs):
                t = h.shape[0]
                pos3 = pos3s[r]
                if pos3 is None:
                    pos = torch.arange(t, device=h.device)
                    pos3 = torch.stack([pos, pos, pos])
                x = self._x(self._norm(h, ln1))
                q, k, v = (x @ wq, x @ wk, x @ wv)
                if bias:
                    q, k, v = q + bias["q"], k + bias["k"], v + bias["v"]
                q, k, v = self._x(q), self._x(k), self._x(v)
                q = self._rope(q.reshape(t, self.hq, self.dh), pos3)
                k = kv_int8(self._rope(k.reshape(t, self.hkv, self.dh), pos3))
                v = kv_int8(v.reshape(t, self.hkv, self.dh))
                h = self._x(h + self._x(self._x(self._attend(q, k, v)) @ wo))
                x = self._x(self._norm(h, ln2))
                g, u = self._x(x @ wg), self._x(x @ wu)
                h = self._x(h + self._x(self._x(g * torch.sigmoid(g) * u) @ wd))
                hs[r] = h
            del wq, wk, wv, wo, wg, wu, wd
        head_bf16 = top.get("lm_head.weight", top["model.embed_tokens.weight"])
        head = self._w(head_bf16)  # [D, V]
        out = []
        for h, rr in zip(hs, rows):
            x = self._x(self._norm(h[rr], top["model.norm.weight"]))
            out.append(x @ head)
        return out


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position: ref_logits [N, V], tokens [N]."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    return float((best - got).max()) if tokens.numel() else 0.0
