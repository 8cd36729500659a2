"""Seeded synthetic photo-like test images (numpy only).

Smooth gradients + sensor-like noise + hard edges, so JPEG/HEVC/VP8
coefficient statistics resemble real content.  Used by the corpus
generator, the benchmark and the smoke test; imports nothing beyond
numpy so it runs where PIL is not installed."""

from __future__ import annotations

import numpy as np


def synth_rgb(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        128 + 100 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
        128 + 80 * np.cos(xx / 11.0 + yy / 41.0),
        128 + 110 * np.sin((xx + yy) / 53.0),
    ], axis=-1)
    img += rng.normal(0, 12, size=img.shape)  # sensor-ish noise
    # hard edges
    img[h // 3:h // 3 + max(4, h // 40), :, :] = 240
    img[:, w // 2:w // 2 + max(4, w // 40), :] = 16
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_rgba(h: int, w: int, seed: int = 0,
               alpha: bool = False) -> np.ndarray:
    """synth_rgb plus an alpha plane: opaque, or a diagonal ramp."""
    rgb = synth_rgb(h, w, seed)
    if alpha:
        a = ((np.arange(h)[:, None] + np.arange(w)[None, :]) * 255
             // max(1, h + w - 2)).astype(np.uint8)
    else:
        a = np.full((h, w), 255, np.uint8)
    return np.dstack([rgb, a])
