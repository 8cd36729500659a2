"""The decoded-picture container.

Analog of the reference's ``struct pic``
(reference format/file.h:29-40): refcounting is replaced by Python GC;
``pixels`` is canonically an ``(H, W, 4)`` uint8 **RGBA** array that may
live on device (jax.Array) so decoded batches feed models with no host
round-trip. ``to_bgra32()`` reproduces the reference's BGRA byte order
for conformance comparison and the BMP writer sink.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


class PixelFormat:
    """Pixel formats, mirroring the reference's SDL-style enum
    (reference utils/colorspace.h:113-249) at the granularity we need."""

    RGBA32 = "RGBA32"
    BGRA32 = "BGRA32"
    GRAY = "GRAY"
    GRAY16 = "GRAY16"
    RGB24 = "RGB24"
    INDEXED8 = "INDEXED8"
    FLOAT_RGBA = "FLOAT_RGBA"


@dataclass
class Pic:
    pixels: Any = None            # (H, W, 4) uint8, RGBA; may be jax.Array
    width: int = 0
    height: int = 0
    depth: int = 32               # bits per pixel of the canonical surface
    pitch: int = 0                # bytes per row of the canonical surface
    format: str = PixelFormat.RGBA32
    left: int = 0
    top: int = 0
    codec: str = ""
    meta: dict = field(default_factory=dict)   # format-specific info() data
    frames: list = field(default_factory=list)  # extra frames (GIF/HEIF/…)
    delay_ms: int = 0             # animation frame delay, if any

    # -- conversions -------------------------------------------------------
    def np_pixels(self) -> np.ndarray:
        """Pixels as a host numpy array (device→host copy if needed)."""
        return np.asarray(self.pixels)

    def exif_transpose(self) -> "Pic":
        """Return a Pic with EXIF orientation applied to the pixels
        (meta orientation reset to 1).  No-op without pixels or when
        orientation is absent/1.  Opt-in, matching PIL's
        ImageOps.exif_transpose — decoders never auto-rotate, so
        conformance comparisons stay byte-stable."""
        import numpy as np
        o = (self.meta or {}).get("exif", {}).get("orientation", 1)
        if self.pixels is None or o in (0, 1):
            return self
        px = self.np_pixels()
        if o == 2:
            px = px[:, ::-1]
        elif o == 3:
            px = px[::-1, ::-1]
        elif o == 4:
            px = px[::-1]
        elif o == 5:
            px = np.rot90(px, 3)[:, ::-1]
        elif o == 6:
            px = np.rot90(px, 3)
        elif o == 7:
            px = np.rot90(px, 1)[:, ::-1]
        elif o == 8:
            px = np.rot90(px, 1)
        px = np.ascontiguousarray(px)
        h, w = px.shape[:2]
        meta = dict(self.meta or {})
        meta["exif"] = dict(meta.get("exif", {}), orientation=1)
        import dataclasses
        return dataclasses.replace(self, pixels=px, width=w, height=h,
                                   pitch=w * (self.depth // 8), meta=meta)

    def to_rgba32(self) -> np.ndarray:
        px = self.np_pixels()
        if self.format == PixelFormat.BGRA32:
            return px[..., [2, 1, 0, 3]]
        if px.ndim == 2:
            return np.stack([px, px, px, np.full_like(px, 255)], axis=-1)
        return px

    def to_bgra32(self) -> np.ndarray:
        """Byte order the reference emits (format/file.h:29, colorspace.c)."""
        px = self.np_pixels()
        if self.format == PixelFormat.BGRA32:
            return px
        if px.ndim == 2:
            return np.stack([px, px, px, np.full_like(px, 255)], axis=-1)
        return px[..., [2, 1, 0, 3]]

    @property
    def n_frames(self) -> int:
        return 1 + len(self.frames)

    def __repr__(self) -> str:  # keep terse; meta can be huge
        dev = type(self.pixels).__name__ if self.pixels is not None else "none"
        return (f"Pic({self.codec} {self.width}x{self.height} depth={self.depth} "
                f"format={self.format} pixels={dev} frames={self.n_frames})")
