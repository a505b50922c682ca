"""Host-side image ops of the camera pipeline (the port's copy of
``tmae_tpu/datasets/image_ops.py``; numpy): the numpy equivalents of the
reference's cv2-based image processors (``pcdet/datasets/processor/
data_processor.py:174-266``) and of ``photo_metric_distortion``
(``augmentor/data_augmentor.py:173``).

The resize reproduces cv2.INTER_LINEAR's half-pixel-centre sampling, and
the HSV conversions follow cv2's float32 convention (H in [0, 360], S in
[0, 1], V unscaled). Random draws come from the loader's ``RandomState``
in the JAX package's order."""

from __future__ import annotations

import numpy as np


def imresize_bilinear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """cv2.resize(..., INTER_LINEAR) equivalent (align half-pixel centers)."""
    h, w = img.shape[:2]
    out_dtype = img.dtype
    x = (np.arange(new_w) + 0.5) * (w / new_w) - 0.5
    y = (np.arange(new_h) + 0.5) * (h / new_h) - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[..., None]
    top = (im[y0c][:, x0c] * (1 - fx)[None, :, None]
           + im[y0c][:, x1c] * fx[None, :, None])
    bot = (im[y1c][:, x0c] * (1 - fx)[None, :, None]
           + im[y1c][:, x1c] * fx[None, :, None])
    out = top * (1 - fy)[:, None, None] + bot * fy[:, None, None]
    if img.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(out_dtype, np.integer):
        out = np.clip(np.round(out), 0, np.iinfo(out_dtype).max)
    return out.astype(out_dtype)


def imrescale(img, image_scales, keep_ratio: bool, rng) -> tuple:
    """Reference ``imrescale`` (data_processor.py:174-213). ``image_scales``
    must be [(w, h), ...]; multiple scales → jittered long/short edges.
    Returns (img, (w_scale, h_scale))."""
    h, w = img.shape[:2]
    if len(image_scales) > 1:
        longs = [max(s) for s in image_scales]
        shorts = [min(s) for s in image_scales]
        size = [rng.randint(min(longs), max(longs) + 1),
                rng.randint(min(shorts), max(shorts) + 1)]
    else:
        size = list(image_scales[0])
    if keep_ratio:
        scale = min(max(size) / max(h, w), min(size) / min(h, w))
        new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
    else:
        new_w, new_h = size
    out = imresize_bilinear(img, new_w, new_h)
    return out, (new_w / w, new_h / h)


def imflip(img) -> np.ndarray:
    return np.ascontiguousarray(np.flip(img, axis=1))


def imnormalize(img, mean, std, to_rgb: bool) -> np.ndarray:
    img = img.astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (img - mean) / std


def impad(img, size_divisor: int) -> np.ndarray:
    h, w = img.shape[:2]
    ph = int(np.ceil(h / size_divisor)) * size_divisor
    pw = int(np.ceil(w / size_divisor)) * size_divisor
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(BGR2HSV) for float32: H [0,360], S [0,1], V = max."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.max(img, axis=-1)
    mn = np.min(img, axis=-1)
    diff = v - mn
    s = np.where(v > 0, diff / np.maximum(v, 1e-12), 0.0)
    with np.errstate(divide='ignore', invalid='ignore'):
        d = np.where(diff > 0, diff, 1.0)
        h = np.where(
            v == r, 60.0 * (g - b) / d,
            np.where(v == g, 120.0 + 60.0 * (b - r) / d,
                     240.0 + 60.0 * (r - g) / d),
        )
    h = np.where(diff > 0, h, 0.0)
    h = np.where(h < 0, h + 360.0, h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    h = (h % 360.0) / 60.0
    i = np.floor(h).astype(np.int64) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([b, g, r], axis=-1).astype(np.float32)


def photo_metric_distortion(img, cfg, rng) -> np.ndarray:
    """Reference photo_metric_distortion (data_augmentor.py:173-227): random
    brightness/contrast/saturation/hue + channel swap, on float32 BGR."""
    img = img.astype(np.float32).copy()
    bright = float(cfg['BRIGHTNESS_DELTA'])
    c_lo, c_hi = cfg['CONTRAST_RANGE']
    s_lo, s_hi = cfg['SATURATION_RANGE']
    hue = float(cfg['HUE_DELTA'])

    if rng.randint(2):
        img += rng.uniform(-bright, bright)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        img *= rng.uniform(c_lo, c_hi)
    hsv = bgr_to_hsv(img)
    if rng.randint(2):
        hsv[..., 1] *= rng.uniform(s_lo, s_hi)
    if rng.randint(2):
        hsv[..., 0] += rng.uniform(-hue, hue)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    img = hsv_to_bgr(hsv)
    if mode == 0 and rng.randint(2):
        img *= rng.uniform(c_lo, c_hi)
    if rng.randint(2):
        img = img[..., rng.permutation(3)]
    return img
