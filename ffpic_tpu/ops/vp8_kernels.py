"""Device kernels for the VP8 dense math: batched dequant ->
Y2 IWHT -> DC scatter -> 4x4 IDCT over the whole-image block grid,
plus the libwebp fixed-point YUV->RGB with fancy upsampling.

The device equivalent of the reference's accel layer for VP8
(arch/x86/sse2.c:49-182 two-blocks-per-call SIMD IDCT, dispatched at
format/webp.c:1136,1173): one jitted launch covers every block of the
frame.  Bit-exact vs the numpy golden models (ops/golden.py), which
are themselves pixel-exact vs libwebp through the decoder tests.

All products fit int32: inputs are wrapped to int16 before each pass
(VP8's in-place int16 semantics), so |x*35468| < 2^31.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _i16(x):
    return x.astype(jnp.int16)


@jax.jit
def vp8_idct4x4(blocks):
    """(..., 4, 4) int16 dequantized coeffs -> int16 residuals;
    mirror of ops/golden.vp8_idct4x4 / utils/idct.c:121-150."""
    c1, c2 = 20091, 35468
    inp = blocks.astype(jnp.int32)
    i0, i1, i2, i3 = (inp[..., k, :] for k in range(4))
    a0 = i0 + i2
    a1 = i0 - i2
    a2 = ((i1 * c2) >> 16) - i3 - ((i3 * c1) >> 16)
    a3 = i1 + ((i1 * c1) >> 16) + ((i3 * c2) >> 16)
    t = jnp.stack([_i16(a0 + a3), _i16(a1 + a2),
                   _i16(a1 - a2), _i16(a0 - a3)], axis=-2) \
        .astype(jnp.int32)
    j0, j1, j2, j3 = (t[..., :, k] for k in range(4))
    a0 = j0 + j2
    a1 = j0 - j2
    a2 = ((j1 * c2) >> 16) - j3 - ((j3 * c1) >> 16)
    a3 = j1 + ((j1 * c1) >> 16) + ((j3 * c2) >> 16)
    return jnp.stack([_i16((a0 + a3 + 4) >> 3), _i16((a1 + a2 + 4) >> 3),
                      _i16((a1 - a2 + 4) >> 3), _i16((a0 - a3 + 4) >> 3)],
                     axis=-1)


@jax.jit
def vp8_iwht4x4(blocks):
    """Y2 inverse WHT (format/webp.c:1067-1096 IWHT_long)."""
    inp = blocks.astype(jnp.int32)
    i0, i1, i2, i3 = (inp[..., k, :] for k in range(4))
    a1, b1 = i0 + i3, i1 + i2
    c1, d1 = i1 - i2, i0 - i3
    t = jnp.stack([a1 + b1, c1 + d1, a1 - b1, d1 - c1], axis=-2)
    j0, j1, j2, j3 = (t[..., :, k] for k in range(4))
    a1, b1 = j0 + j3, j1 + j2
    c1, d1 = j1 - j2, j0 - j3
    a2 = a1 + b1 + 3
    return _i16(jnp.stack([a2 >> 3, (c1 + d1 + 3) >> 3,
                           (a1 - b1 + 3) >> 3, (d1 - c1 + 3) >> 3],
                          axis=-1))


@jax.jit
def vp8_residuals(levels, dq_per_mb, has_y2):
    """Whole-frame residual stage on device.

    levels: (mbh, mbw, 25, 16) int32 raw token levels;
    dq_per_mb: (mbh, mbw, 6) int32 [y1dc, y1ac, y2dc, y2ac, uvdc, uvac];
    has_y2: (mbh, mbw) bool.
    Returns (mbh, mbw, 24, 4, 4) int16 residuals.
    """
    lv = levels.astype(jnp.int32)
    y1dc = dq_per_mb[..., 0][..., None]
    y1ac = dq_per_mb[..., 1][..., None]
    y2dc = dq_per_mb[..., 2][..., None]
    y2ac = dq_per_mb[..., 3][..., None]
    uvdc = dq_per_mb[..., 4][..., None]
    uvac = dq_per_mb[..., 5][..., None]

    yblk = lv[..., :16, :] * y1ac[..., None, :]
    yblk = yblk.at[..., 0].set(lv[..., :16, 0] * y1dc)
    uvblk = lv[..., 16:24, :] * uvac[..., None, :]
    uvblk = uvblk.at[..., 0].set(lv[..., 16:24, 0] * uvdc)
    y2 = lv[..., 24, :] * y2ac
    y2 = y2.at[..., 0].set(lv[..., 24, 0] * y2dc[..., 0])

    wht = vp8_iwht4x4(_i16(y2).reshape(*y2.shape[:-1], 4, 4)) \
        .reshape(*y2.shape[:-1], 16).astype(jnp.int32)
    ydc = jnp.where(has_y2[..., None], wht, yblk[..., 0])
    yblk = yblk.at[..., 0].set(ydc)

    blocks = jnp.concatenate([yblk, uvblk], axis=-2)
    blocks = _i16(blocks).reshape(*blocks.shape[:-1], 4, 4)
    return vp8_idct4x4(blocks)


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


@functools.partial(jax.jit, static_argnames=("h", "w"))
def vp8_yuv_to_rgba(Y, U, V, h: int, w: int):
    """libwebp fixed-point YUV->RGBA with fancy (diamond) chroma
    upsampling, on device — mirror of webp._yuv_to_rgb_libwebp."""
    y = Y[:h, :w].astype(jnp.int32)
    ch, cw = (h + 1) // 2, (w + 1) // 2

    def fancy(c):
        c = c[:ch, :cw].astype(jnp.int32)
        cN = jnp.concatenate([c[:1], c[:-1]], axis=0)
        cS = jnp.concatenate([c[1:], c[-1:]], axis=0)

        def row_mix(a, b):
            aW = jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)
            aE = jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)
            bW = jnp.concatenate([b[:, :1], b[:, :-1]], axis=1)
            bE = jnp.concatenate([b[:, 1:], b[:, -1:]], axis=1)
            left = (9 * a + 3 * (b + aW) + bW + 8) >> 4
            right = (9 * a + 3 * (b + aE) + bE + 8) >> 4
            return jnp.stack([left, right], axis=2).reshape(a.shape[0],
                                                            -1)
        top = row_mix(c, cN)
        bot = row_mix(c, cS)
        out = jnp.stack([top, bot], axis=1).reshape(2 * ch, 2 * cw)
        return out[:h, :w]

    u = fancy(U)
    v = fancy(V)
    yv = _mult_hi(y, 19077)
    r = yv + _mult_hi(v, 26149) - 14234
    g = yv - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708
    b = yv + _mult_hi(u, 33050) - 17685

    def clip8(x):
        return jnp.clip(x >> 6, 0, 255).astype(jnp.uint8)
    a = jnp.full((h, w), 255, jnp.uint8)
    return jnp.stack([clip8(r), clip8(g), clip8(b), a], axis=-1)
