"""The kit of Qwen2.5-VL with its vision tower: the dense decoder's pieces
(``kits/dense_decoder.py``), and beside them

- the tower's weights in the Hugging Face layout (``visual.patch_embed``,
  ``visual.blocks.{i}.*``, ``visual.merger.*``), made from the seed in the
  scheme of ``weights.py``: one ``torch.randn`` call a block on the device,
  linear weights N(0, 1 / fan_in), biases N(0, ``BIAS_STD``), norm weights
  1 + N(0, ``NORM_STD``);
- the reference: the plain tower (``reference/vision.py``) over each judged
  request's pixels, its features written over the image placeholders of
  the plain decoder, whose M-RoPE streams ``mrope_index`` lays out; the
  same features, with their placeholder rows, for the check's
  ``features_gap``;
- the FLOPs of a tower call, counted as the tower needs them (each
  window's attention over its own patches);
- the image inputs of a traffic's ``inputs.images``.

An image request's inputs are what Qwen2.5-VL's processor hands the model:
``pixel_values`` [t * h * w patches, C * Tp * P * P] f32 in the normalized
pixel space, here N(0, 1) from the seed on the device, and
``image_kwargs={"grid_thw": [[1, h, w]]}``, h and w in patches. Its prompt
is the text with ``vision_start``, the image placeholder repeated once a
merged token (h * w / merge**2), and ``vision_end`` put inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.kits import dense_decoder as dense
from portbench.reference.decoder import mrope_index
from portbench.reference.vision import Tower

decode_token_flops = dense.decode_token_flops
prefill_flops = dense.prefill_flops
rider_flops = dense.rider_flops

#: text tokens a warm-up image request carries around its image
WARM_TEXT = 16


# -- the tower's weights ----------------------------------------------------


def patch_dim(v: dict) -> int:
    return v.get("in_chans", 3) * v["temporal_patch_size"] * v["patch_size"] ** 2


def block_shapes(v: dict) -> dict:
    """HF names after ``visual.blocks.{i}.`` -> shapes, of one block."""
    d, di = v["hidden_size"], v["intermediate_size"]
    return {
        "norm1.weight": (d,),
        "attn.qkv.weight": (3 * d, d), "attn.qkv.bias": (3 * d,),
        "attn.proj.weight": (d, d), "attn.proj.bias": (d,),
        "norm2.weight": (d,),
        "mlp.gate_proj.weight": (di, d), "mlp.gate_proj.bias": (di,),
        "mlp.up_proj.weight": (di, d), "mlp.up_proj.bias": (di,),
        "mlp.down_proj.weight": (d, di), "mlp.down_proj.bias": (d,),
    }


def top_shapes(v: dict) -> dict:
    """HF names after ``visual.`` -> shapes, of the patch embedding and the
    merger."""
    d, m = v["hidden_size"], v["hidden_size"] * v["spatial_merge_size"] ** 2
    p = v["patch_size"]
    return {
        "patch_embed.proj.weight": (d, v.get("in_chans", 3), v["temporal_patch_size"], p, p),
        "merger.ln_q.weight": (d,),
        "merger.mlp.0.weight": (m, m), "merger.mlp.0.bias": (m,),
        "merger.mlp.2.weight": (v["out_hidden_size"], m), "merger.mlp.2.bias": (v["out_hidden_size"],),
    }


def _seeded(shapes: dict, seed: int, name: str, device) -> dict:
    """One randn call over all of ``shapes``, cut into views and scaled."""
    gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, name))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn((sum(sizes),), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (key, shape), n in zip(shapes.items(), sizes):
        part = flat[at:at + n].view(shape)
        at += n
        if key.endswith("norm1.weight") or key.endswith("norm2.weight") or "ln_q" in key:
            t = 1.0 + weights.NORM_STD * part
        elif key.endswith(".bias"):
            t = weights.BIAS_STD * part
        else:
            t = part * (n // shape[0]) ** -0.5
        out[key] = t.to(weights.DTYPE)
    return out


def tower_block(cfg: dict, seed: int, i: int, device) -> dict:
    return _seeded(block_shapes(cfg["vision_config"]), seed, f"visual.block{i}", device)


def tower_top(cfg: dict, seed: int, device) -> dict:
    return _seeded(top_shapes(cfg["vision_config"]), seed, "visual.top", device)


def state_dict(cfg: dict, seed: int, device) -> dict:
    sd = dense.state_dict(cfg, seed, device)
    sd.update({f"visual.{k}": t for k, t in tower_top(cfg, seed, device).items()})
    for i in range(cfg["vision_config"]["depth"]):
        sd.update({f"visual.blocks.{i}.{k}": t
                   for k, t in tower_block(cfg, seed, i, device).items()})
    return sd


# -- the reference ---------------------------------------------------------------


def images_of(extras: dict) -> list:
    """A request's images: (patches, (t, h, w)) each, in order."""
    grids = [tuple(int(x) for x in g) for g in np.asarray(extras["image_kwargs"]["grid_thw"])]
    px = extras["pixel_values"]
    out, at = [], 0
    for t, h, w in grids:
        out.append((px[at:at + t * h * w], (t, h, w)))
        at += t * h * w
    return out


class Reference:
    def __init__(self, cfg: dict, seed: int, device, precision: str = "f32"):
        self.cfg = cfg
        self.decoder = dense.decoder(cfg, seed, device, precision)
        self.tower = Tower(cfg["vision_config"], lambda i: tower_block(cfg, seed, i, device),
                           lambda: tower_top(cfg, seed, device), precision)
        self._seen: dict = {}  # id(pixel_values) -> (pixel_values, features)

    def _features(self, requests: list) -> list:
        """Each request's image features [n, out_hidden] f32 (None without
        images); the tower runs once over the images it has not seen."""
        new = [ex for _, ex in requests if ex and id(ex["pixel_values"]) not in self._seen]
        per = [images_of(ex) for ex in new]
        feats = iter(self.tower.features([im for ims in per for im in ims]))
        for ex, ims in zip(new, per):
            self._seen[id(ex["pixel_values"])] = (
                ex["pixel_values"], torch.cat([next(feats) for _ in ims]))
        return [self._seen[id(ex["pixel_values"])][1] if ex else None for _, ex in requests]

    def features(self, requests: list) -> list:
        """(placeholder rows, features) of each ``(prompt ids, extras)``."""
        return [(torch.nonzero(ids == self.cfg["image_token_id"])[:, 0], f)
                for (ids, _), f in zip(requests, self._features(requests))]

    def logits(self, requests: list, rows: list) -> list:
        per = [images_of(extras) if extras else [] for _, extras in requests]
        images = []
        for (ids, _), ims, f in zip(requests, per, self._features(requests)):
            if not ims:
                images.append(None)
                continue
            pos3 = mrope_index(ids.tolist(), self.cfg["image_token_id"],
                               self.cfg["vision_start_token_id"], [g for _, g in ims],
                               self.cfg["vision_config"]["spatial_merge_size"])
            images.append((f, pos3))
        return self.decoder.logits([ids for ids, _ in requests], rows, images)


def reference(cfg: dict, seed: int, device, precision: str = "f32") -> Reference:
    return Reference(cfg, seed, device, precision)


# -- model FLOPs ----------------------------------------------------------------


def tower_flops(v: dict, grid) -> float:
    """Model FLOPs of the tower over one image of ``grid`` (t, h, w)
    patches: the patch embedding, every block's projections, its attention
    over what it attends (a window's patches, or the whole frame), and the
    merger."""
    t, h, w = (int(x) for x in grid)
    n, d, di = t * h * w, v["hidden_size"], v["intermediate_size"]
    m = v["spatial_merge_size"]
    md = d * m * m
    tower = Tower(v, None, None)
    windowed = sum(len(g) ** 2 for g in tower.windows((t, h, w)))
    full = t * (h * w) ** 2
    blocks = 2 * n * (3 * d * d + d * d + 3 * d * di)
    attn = sum(4 * d * (full if i in tower.full else windowed) for i in range(v["depth"]))
    merger = 2 * (n // (m * m)) * (md * md + md * v["out_hidden_size"])
    return 2 * n * patch_dim(v) * d + v["depth"] * blocks + attn + merger


def call_flops(cfg: dict, call: dict) -> float:
    """A tower call's FLOPs (``call["grid_thw"]``: its images' grids)."""
    return sum(tower_flops(cfg["vision_config"], g) for g in call["grid_thw"])


# -- request inputs ----------------------------------------------------------------


def _sides(spec: dict, step: int) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if lo % step or hi % step:
        raise ValueError(f"image sides {lo}-{hi} px are not multiples of {step}")
    return np.arange(lo, hi + 1, step)


def _image(cfg: dict, seed: int, name: str, hpx: int, wpx: int, device) -> tuple:
    """(placeholder ids, extras) of one image of hpx x wpx pixels, its
    pixels from (seed, name)."""
    v = cfg["vision_config"]
    p, m = v["patch_size"], v["spatial_merge_size"]
    h, w = hpx // p, wpx // p
    gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, name))
    px = torch.randn((h * w, patch_dim(v)), generator=gen, device=device, dtype=torch.float32)
    ids = ([cfg["vision_start_token_id"]] + [cfg["image_token_id"]] * (h * w // (m * m))
           + [cfg["vision_end_token_id"]])
    return ids, {"pixel_values": px, "image_kwargs": {"grid_thw": np.array([[1, h, w]])}}


def draw_inputs(spec: dict, cfg: dict, reqs: list, streams: list, seed: int, device) -> None:
    """``spec["images"]``: {"share", "side_px": {"min", "max"}}. Each
    request carries one image with probability ``share``; the image's
    height and width are independent draws, uniform over the multiples of
    patch x merge pixels from min to max; it goes in after text token k, k
    uniform over 1 .. L - 1 of the request's L text tokens. The schedule
    (who carries an image, its sides, where) comes from ``streams`` and is
    every seed's; the pixels come from the seed, one generator a request."""
    im, v = spec["images"], cfg["vision_config"]
    n = len(reqs)
    share, hs, ws, at = (np.random.default_rng(s) for s in streams[:4])
    sides = _sides(im["side_px"], v["patch_size"] * v["spatial_merge_size"])
    has = share.random(n) < float(im["share"])
    hpx, wpx, where = hs.choice(sides, n), ws.choice(sides, n), at.random(n)
    for r in reqs:
        i = r.index
        if not has[i]:
            continue
        k = 1 + int(where[i] * (len(r.prompt) - 1))
        ids, r.extras = _image(cfg, seed, f"pixels{i}", int(hpx[i]), int(wpx[i]), device)
        r.prompt = r.prompt[:k] + ids + r.prompt[k:]


def warm_requests(spec: dict, cfg: dict, seed: int, device) -> list:
    """One request of the largest image the spec draws, in ``WARM_TEXT``
    text tokens: the tower at its largest and the mixed step that carries
    image embeddings."""
    side = int(_sides(spec["images"]["side_px"], 1)[-1])
    lo = cfg["assumed"]["ordinary_token_ids"][0]
    ids, extras = _image(cfg, seed, "warm", side, side, device)
    text = [lo + i for i in range(WARM_TEXT)]
    return [(text[:1] + ids + text[1:], extras)]
