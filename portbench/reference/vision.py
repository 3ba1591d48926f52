"""Plain float32 reference of Qwen2.5-VL's vision tower, from the published
description (Hugging Face ``Qwen2_5_VisionTransformerPretrainedModel``).

Each image arrives as its patches [t * h * w, C * Tp * P * P] in the
processor's order: row-major over 2 x 2 merge units, the four patches of a
unit consecutive, and its grid (t, h, w) in patches. The tower:

- embeds each patch by one product with the patch-embedding weight (a 3-D
  convolution whose stride is its kernel);
- turns q and k of every block with 2-D rotary positions: a patch's row
  and column, each over half of the rotated frequencies (base 10,000 over
  half the head size), rotate-half over the whole head;
- runs ``depth`` pre-norm blocks (RMSNorm, biased q / k / v and output
  projections, RMSNorm, gated-SiLU MLP with biases). Blocks named in
  ``fullatt_block_indexes`` attend over the whole frame; the others within
  windows of ``window_size`` pixels (``window_size / patch_size /
  spatial_merge_size`` merge units a side), tiled from the frame's top
  left, so windows at the right and bottom edges are ragged;
- merges each 2 x 2 unit: RMSNorm, the unit's four rows side by side, a
  GELU MLP (exact erf) out to ``out_hidden_size``.

Attention here is computed window by window, over groups of windows of one
shape gathered by index, with the tokens left in the processor's order
throughout: no permutation into window order and none back.

All arithmetic is float32 with TF32 off. ``precision="fp8"`` is the
control: every activation is kept in float8 e4m3 with one scale per row.
Imports torch alone: nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import torch

from portbench.reference.decoder import fp8_rows, no_tf32

EPS = 1e-6


class Tower:
    """The tower over its configuration (``vision_config``'s keys) and a
    weight source: ``block(i)`` returns block i's bf16 tensors (HF names
    after ``visual.blocks.{i}.``), ``top()`` the patch embedding's and the
    merger's (after ``visual.``)."""

    def __init__(self, vcfg: dict, block, top, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.v, self.block, self.top = vcfg, block, top
        self.fp8 = precision == "fp8"
        self.d, self.heads = vcfg["hidden_size"], vcfg["num_heads"]
        self.dh = self.d // self.heads
        self.merge = vcfg["spatial_merge_size"]
        self.win = vcfg["window_size"] // vcfg["patch_size"] // self.merge
        self.full = set(vcfg["fullatt_block_indexes"])

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_rows(x) if self.fp8 else x

    @staticmethod
    def _norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + EPS) * w.float()

    @staticmethod
    def _lin(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return x @ w.float().T + b.float()

    # -- the layout of one image ------------------------------------------

    def positions(self, grid) -> torch.Tensor:
        """[t * h * w, 2] (row, column) of each patch in the processor's
        order."""
        t, h, w = grid
        m = self.merge
        rows = torch.arange(h).view(h // m, m, 1, 1).expand(h // m, m, w // m, m)
        cols = torch.arange(w).view(1, 1, w // m, m).expand(h // m, m, w // m, m)
        unit = lambda a: a.permute(0, 2, 1, 3).reshape(-1)  # noqa: E731
        return torch.stack([unit(rows), unit(cols)], dim=-1).repeat(t, 1)

    def windows(self, grid) -> list:
        """Each window's patch indices (in the processor's order): tiles of
        ``win`` x ``win`` merge units from the frame's top left, cut at its
        right and bottom edges, frame by frame."""
        t, h, w = grid
        m, ws = self.merge, self.win
        gh, gw = h // m, w // m
        out = []
        for f in range(t):
            for r0 in range(0, gh, ws):
                for c0 in range(0, gw, ws):
                    units = [f * gh * gw + r * gw + c
                             for r in range(r0, min(r0 + ws, gh))
                             for c in range(c0, min(c0 + ws, gw))]
                    out.append([u * m * m + k for u in units for k in range(m * m)])
        return out

    def frames(self, grid) -> list:
        t, h, w = grid
        return [list(range(f * h * w, (f + 1) * h * w)) for f in range(t)]

    # -- the pieces -------------------------------------------------------

    def _rotary(self, pos: torch.Tensor, device) -> tuple:
        """cos / sin [N, 1, dh] of the 2-D rotary positions."""
        half = self.dh // 2
        inv = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float64) / half))
        ang = torch.cat([pos[:, :1] * inv, pos[:, 1:] * inv], dim=-1)  # [N, dh / 2]
        ang = torch.cat([ang, ang], dim=-1).to(torch.float32).to(device)
        return torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    @staticmethod
    def _turn(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos + rot * sin

    def _attend(self, q, k, v, groups: list) -> torch.Tensor:
        """Softmax attention of q / k / v [N, H, dh] within each group of
        patch indices; groups of one size are gathered and run together."""
        out = torch.empty_like(q)
        by_size: dict = {}
        for g in groups:
            by_size.setdefault(len(g), []).append(g)
        for gs in by_size.values():
            idx = torch.tensor(gs, device=q.device)  # [G, n]
            qg, kg, vg = (a[idx].permute(0, 2, 1, 3) for a in (q, k, v))  # [G, H, n, dh]
            s = torch.matmul(qg, kg.transpose(-1, -2)) * self.dh ** -0.5
            o = torch.matmul(torch.softmax(s, dim=-1), vg)
            out[idx] = o.permute(0, 2, 1, 3)
        return out

    # -- forward ------------------------------------------------------------

    @torch.no_grad()
    def features(self, images: list) -> list:
        """For each image (patches [N, C * Tp * P * P], grid (t, h, w)), its
        merged features [N / merge**2, out_hidden_size] f32, in the
        processor's order; block by block over every image, so that each
        block's weights are made once."""
        with no_tf32():
            return self._features(images)

    def _features(self, images):
        top = self.top()
        pw = top["patch_embed.proj.weight"].float().reshape(self.d, -1)
        hs, rot, windows, frames = [], [], [], []
        for px, grid in images:
            hs.append(self._x(px.float() @ pw.T))
            rot.append(self._rotary(self.positions(grid), px.device))
            windows.append(self.windows(grid))
            frames.append(self.frames(grid))
        for i in range(self.v["depth"]):
            w = self.block(i)
            for r, h in enumerate(hs):
                n = h.shape[0]
                x = self._x(self._norm(h, w["norm1.weight"]))
                qkv = self._x(self._lin(x, w["attn.qkv.weight"], w["attn.qkv.bias"]))
                q, k, v = qkv.reshape(n, 3, self.heads, self.dh).unbind(1)
                cos, sin = rot[r]
                q, k = self._turn(q, cos, sin), self._turn(k, cos, sin)
                groups = frames[r] if i in self.full else windows[r]
                o = self._x(self._attend(q, k, v, groups).reshape(n, self.d))
                h = self._x(h + self._x(self._lin(o, w["attn.proj.weight"],
                                                  w["attn.proj.bias"])))
                x = self._x(self._norm(h, w["norm2.weight"]))
                g = self._x(self._lin(x, w["mlp.gate_proj.weight"], w["mlp.gate_proj.bias"]))
                u = self._x(self._lin(x, w["mlp.up_proj.weight"], w["mlp.up_proj.bias"]))
                y = self._x(g * torch.sigmoid(g) * u)
                hs[r] = self._x(h + self._x(self._lin(y, w["mlp.down_proj.weight"],
                                                      w["mlp.down_proj.bias"])))
            del w
        out = []
        for h in hs:
            x = self._x(self._norm(h, top["merger.ln_q.weight"]))
            x = x.reshape(-1, self.merge ** 2 * self.d)
            y = self._x(self._lin(x, top["merger.mlp.0.weight"], top["merger.mlp.0.bias"]))
            y = self._x(torch.nn.functional.gelu(y))
            out.append(self._lin(y, top["merger.mlp.2.weight"], top["merger.mlp.2.bias"]))
        return out
