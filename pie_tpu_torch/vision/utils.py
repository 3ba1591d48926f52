"""Image loading, resizing and preprocessing on the host (numpy).

The port's copy of the JAX package's ``pie_tpu/vision/utils.py``:
``load_image`` (a local path, a data URI, raw bytes, a file object, a PIL
image, or an http(s) URL fetched with ``requests``), EXIF transpose and RGB
conversion, aspect-preserving downscaling, the square resize + normalize
of ``process_image``, the SigLIP processor (Gemma-3, kept for its tower)
and the Qwen2-VL processor, whose merge-block patchify is split out as
``qwen2vl_patchify`` so numpy pixels can be patchified without Pillow.
Loading and resizing need Pillow; nothing here touches a device.
"""

from __future__ import annotations

import base64
import dataclasses
import io
from pathlib import Path
from typing import Any, Union

import numpy as np


def load_image(source: Union[str, bytes, "io.BytesIO", Any]):
    """A PIL image in RGB from a URL, a local path, a data URI, raw bytes,
    a file object, or a PIL image."""
    from PIL import Image, ImageOps

    if hasattr(source, "read"):
        img = Image.open(source)
    elif isinstance(source, bytes):
        img = Image.open(io.BytesIO(source))
    elif isinstance(source, str) and source.startswith("data:"):
        _, b64 = source.split(",", 1)
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
    elif isinstance(source, str) and source.startswith(("http://", "https://")):
        import requests

        resp = requests.get(source, timeout=30)
        resp.raise_for_status()
        img = Image.open(io.BytesIO(resp.content))
    elif isinstance(source, (str, Path)):
        img = Image.open(source)
    else:
        img = source  # already a PIL image
    img = ImageOps.exif_transpose(img)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def resize_image(img, max_size: tuple[int, int]):
    """Aspect-preserving downscale to fit in ``max_size`` (w, h)."""
    from PIL import Image

    w, h = img.size
    mw, mh = max_size
    scale = min(mw / w, mh / h, 1.0)
    if scale < 1.0:
        img = img.resize((max(1, int(w * scale)), max(1, int(h * scale))),
                         Image.Resampling.BICUBIC)
    return img


def normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    """[H, W, 3] pixels in [0, 1] -> (x - mean) / std as [3, H, W] f32."""
    mean = np.asarray(mean, np.float32).reshape(1, 1, 3)
    std = np.asarray(std, np.float32).reshape(1, 1, 3)
    return ((arr.astype(np.float32) - mean) / std).transpose(2, 0, 1)


def process_image(img, size: int, mean, std) -> np.ndarray:
    """Resize to (size, size) and normalize -> [3, H, W] f32."""
    from PIL import Image

    img = img.resize((size, size), Image.Resampling.BICUBIC)
    return normalize(np.asarray(img, np.float32) / 255.0, mean, std)


@dataclasses.dataclass
class BaseImageProcessor:
    """Square size and mean / std."""

    image_size: int = 224
    image_mean: tuple = (0.5, 0.5, 0.5)
    image_std: tuple = (0.5, 0.5, 0.5)

    def __call__(self, source) -> np.ndarray:
        return process_image(load_image(source), self.image_size, self.image_mean,
                             self.image_std)

    def batch(self, sources) -> np.ndarray:
        return np.stack([self(s) for s in sources])


class SiglipImageProcessor(BaseImageProcessor):
    """Gemma-3 / SigLIP defaults."""


OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def qwen2vl_patchify(arr: np.ndarray, patch_size: int, merge_size: int,
                     temporal_patch_size: int) -> np.ndarray:
    """One normalized image [3, H, W] as Qwen2-VL patches
    [grid_h * grid_w, 3 * temporal * patch * patch] f32: the still image
    repeated along the temporal patch axis, patches in merge-block order
    (each ``merge_size`` x ``merge_size`` block of patches contiguous), the
    layout the vision tower reads (HF Qwen2VLImageProcessor)."""
    c, h, w = arr.shape
    p, m, t = patch_size, merge_size, temporal_patch_size
    gh, gw = h // p, w // p
    patches = np.broadcast_to(arr[None], (t, c, h, w))
    patches = patches.reshape(1, t, c, gh // m, m, p, gw // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return patches.reshape(gh * gw, c * t * p * p).astype(np.float32)


@dataclasses.dataclass
class Qwen2VLImageProcessor:
    """Qwen2-VL preprocessing: resize to a fixed square whose side divides
    patch * merge, CLIP-normalize and patchify (``qwen2vl_patchify``).
    ``batch`` returns (pixel_values, grid_thw); ``returns_grid`` tells the
    chat layer to pass grid_thw on as ``image_kwargs``."""

    image_size: int = 224
    patch_size: int = 14
    merge_size: int = 2
    temporal_patch_size: int = 2
    image_mean: tuple = OPENAI_CLIP_MEAN
    image_std: tuple = OPENAI_CLIP_STD

    returns_grid = True

    @property
    def tokens_per_image(self) -> int:
        g = self.image_size // self.patch_size
        return (g * g) // (self.merge_size ** 2)

    def patchify(self, arr: np.ndarray) -> np.ndarray:
        return qwen2vl_patchify(arr, self.patch_size, self.merge_size,
                                self.temporal_patch_size)

    def _one(self, source) -> np.ndarray:
        return self.patchify(process_image(load_image(source), self.image_size,
                                           self.image_mean, self.image_std))

    def grid(self, n: int) -> np.ndarray:
        """grid_thw [n, 3] of ``n`` images."""
        g = self.image_size // self.patch_size
        return np.asarray([[1, g, g]] * n, np.int64)

    def batch(self, sources):
        return np.concatenate([self._one(s) for s in sources]), self.grid(len(sources))


def make_image_processor(model):
    """The host image processor a model needs, or None for a text-only
    model: the Qwen2-VL family (an M-RoPE config) gets the patchifying
    processor, a SigLIP-style tower (Gemma-3) the square resize +
    normalize one."""
    if getattr(model, "vision", None) is None:
        return None
    cfg = model.config
    v = getattr(cfg, "vision", None) or {}
    if hasattr(cfg, "mrope_section"):
        return Qwen2VLImageProcessor(
            patch_size=int(v.get("patch_size", 14)),
            merge_size=int(v.get("spatial_merge_size", 2)),
            temporal_patch_size=int(v.get("temporal_patch_size", 2)),
        )
    return SiglipImageProcessor(image_size=int(v.get("image_size", 224)))
