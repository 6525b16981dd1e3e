"""Image preprocessing: pixel-budget smart resize, CLIP normalization, and
patchification into the Qwen2.5-VL vision-token layout.

A copy of ``spatialthinker_tpu/data/image.py``, unchanged in behaviour
(tests/test_torch_host.py pins it to the original): that package's
``data/__init__`` imports jax. HF Qwen2VL image processor contract
(smart_resize rounding + patch flatten order (grid_t, gh/m, gw/m, m, m, C,
T, P, P)) in plain numpy.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def budget_resize_dims(width: int, height: int, min_pixels: int, max_pixels: int) -> Tuple[int, int]:
    """Pre-resize to the dataset pixel budget via sqrt-factor scaling.
    Returns (width, height)."""
    if width * height > max_pixels:
        ratio = math.sqrt((width * height) / max_pixels)
        width, height = int(width / ratio), int(height / ratio)
    if width * height < min_pixels:
        ratio = math.sqrt(min_pixels / (width * height))
        width, height = int(width * ratio), int(height * ratio)
    return width, height


def smart_resize_dims(
    height: int, width: int, factor: int = 28,
    min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[int, int]:
    """Qwen2VL smart resize: round to multiples of `factor`, keep pixel count
    inside [min_pixels, max_pixels], preserve aspect ratio. Returns (h, w)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _bilinear_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (H, W, C) float32 without PIL (align_corners=False)."""
    in_h, in_w = image.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return image
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
    bot = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def process_image(
    image,
    min_pixels: int,
    max_pixels: int,
    *,
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Full path: decode -> budget resize -> smart resize -> normalize ->
    patchify. Accepts a PIL image, dict with 'bytes', or (H, W, 3) array.
    Returns (patches (N, C*T*P*P) float32, grid_thw)."""
    arr = to_rgb_array(image)
    h, w = arr.shape[:2]
    # dataset-level pixel budget (sqrt scaling), then processor smart resize
    bw, bh = budget_resize_dims(w, h, min_pixels, max_pixels)
    factor = patch_size * merge_size
    rh, rw = smart_resize_dims(bh, bw, factor=factor, min_pixels=min_pixels, max_pixels=max_pixels)
    arr = _bilinear_resize(arr.astype(np.float32), rh, rw)

    arr = arr / 255.0
    arr = (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    chw = arr.transpose(2, 0, 1)  # (C, H, W)
    return patchify(chw[None], rh, rw, patch_size, merge_size, temporal_patch_size)


def to_rgb_array(image) -> np.ndarray:
    """Best-effort decode to (H, W, 3) uint8."""
    if isinstance(image, np.ndarray):
        arr = image
    elif isinstance(image, dict) and "bytes" in image:
        from io import BytesIO

        from PIL import Image

        arr = np.asarray(Image.open(BytesIO(image["bytes"])).convert("RGB"))
    elif hasattr(image, "convert"):  # PIL
        arr = np.asarray(image.convert("RGB"))
    else:
        raise TypeError(f"unsupported image type {type(image)}")
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def patchify(
    frames: np.ndarray,  # (T_frames, C, H, W) float32, already normalized
    height: int,
    width: int,
    patch_size: int,
    merge_size: int,
    temporal_patch_size: int,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """HF Qwen2VL patch flatten order: rows grouped by 2x2 merge blocks."""
    patches = frames
    if patches.shape[0] % temporal_patch_size != 0:
        reps = np.repeat(
            patches[-1:], temporal_patch_size - (patches.shape[0] % temporal_patch_size), axis=0
        )
        patches = np.concatenate([patches, reps], axis=0)
    channel = patches.shape[1]
    grid_t = patches.shape[0] // temporal_patch_size
    grid_h, grid_w = height // patch_size, width // patch_size
    patches = patches.reshape(
        grid_t, temporal_patch_size, channel,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w, channel * temporal_patch_size * patch_size * patch_size
    )
    return flat.astype(np.float32), (grid_t, grid_h, grid_w)
