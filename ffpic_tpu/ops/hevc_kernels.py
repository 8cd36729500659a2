"""HEVC device kernels: batched dequant + inverse transforms per
TU-size bucket, as matrix products.

This is the device seam of formats/hevc_recon.execute_ops: residual
inverse transforms have no prediction-feedback dependency, so every TU
of one (size, dst) bucket batches into a single launch over a
(B, n, n) grid.  The N-point inverse DCT/DST are plain matrix
multiplies (reference: transMatrixCol, hevc.c:3826-3859; scale +
transform hevc.c:4172, 3743-3999) — shapes the device's matrix units take.

Bit-exactness strategy: the spec pipeline is int arithmetic with
16-bit clips between stages.  Device matmuls are floating point, so each
int16-range operand is split hi/lo (a = 256*hi + lo); each half's
dot product stays under 2^24 (|M| <= 91, n <= 32 -> 91*32*256 < 2^20
per half) and is therefore exact in f32; the halves recombine in
int32.  Dequant pre-clips levels so the per-element product fits
int32 without changing the saturated result (monotonicity of the
scaling function).

Differential-tested against the golden numpy pass
(coding/hevc_consts.dequant/inverse_transform), which is itself
dual-oracle validated (encoder roundtrip + byte-exact vs the compiled
C reference).

Default decode keeps the host C path (native/host_hevc.c r_residual):
one picture's launches cost more than the C loop, but a batched
pipeline over many HEICs amortizes them — set FFPIC_HEVC_DEVICE=1 to
route execute_ops residuals through these kernels.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ffpic_tpu.coding.hevc_consts import (DST4, LEVEL_SCALE,
                                          dct_matrix)

_LS = jnp.asarray(np.asarray(LEVEL_SCALE, np.int32))


def _exact_matmul_i16(a, m_f32):
    """Exact int32 result of a @ m for int16-range a (|a| <= 32768)
    and small-int m (|m| <= 91, k <= 32), via hi/lo f32 matmuls.

    a: (..., k) int32; m_f32: (k, n) float32 with integer values.
    """
    hi = (a >> 8).astype(jnp.float32)          # floor: a = 256*hi + lo
    lo = (a & 255).astype(jnp.float32)
    # HIGHEST precision: at DEFAULT the GPU may run f32 matmuls in
    # TF32 (10-bit mantissa), breaking the exact-integer guarantee
    hp = jnp.einsum("...k,kn->...n", hi, m_f32,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    lp = jnp.einsum("...k,kn->...n", lo, m_f32,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    return (hp.astype(jnp.int32) << 8) + lp.astype(jnp.int32)


def _dequant_dev(levels, qps, n: int, bit_depth: int):
    """8.6.3 scaling, batched: levels (B, n, n) int32, qps (B,)."""
    log2n = n.bit_length() - 1
    bd_shift = bit_depth + log2n - 5
    scale = (16 * jnp.take(_LS, qps % 6)) << (qps // 6)   # (B,)
    scale = scale[:, None, None]
    # pre-clip so the product fits int32 without changing the
    # saturated output (d is monotone in levels)
    bound = ((32768 << bd_shift) // scale) + 1
    lv = jnp.clip(levels, -bound, bound)
    d = (lv * scale + (1 << (bd_shift - 1))) >> bd_shift
    return jnp.clip(d, -32768, 32767)


@partial(jax.jit, static_argnames=("n", "bit_depth", "dst"))
def dequant_itransform_batch(levels, qps, n: int, bit_depth: int = 8,
                             dst: bool = False):
    """Batched dequant + 2-D inverse transform (8.6.3 + 8.6.4.1).

    levels: (B, n, n) int32 TransCoeffLevel [y][x]; qps: (B,) int32.
    Returns (B, n, n) int32 residuals, bit-exact vs the golden pass.
    """
    m = (DST4 if dst else dct_matrix(n)).astype(np.float32)
    mf = jnp.asarray(m)                       # (n, n): M[row=freq][col]
    d = _dequant_dev(levels, qps, n, bit_depth)
    # column pass: e[y][x] = sum_j M[j][y] * d[j][x]  -> contract over
    # the first spatial axis with M (i.e. d^T @ M per batch, then
    # transpose back): einsum over axis -2
    e = _exact_matmul_i16(jnp.swapaxes(d, -1, -2), mf)   # (B, x, y)
    e = jnp.swapaxes(e, -1, -2)                          # (B, y, x)
    e = jnp.clip((e + (1 << 6)) >> 7, -32768, 32767)
    # row pass: r[y][i] = sum_j M[j][i] * e[y][j]
    shift2 = 20 - bit_depth
    r = _exact_matmul_i16(e, mf)
    r = (r + (1 << (shift2 - 1))) >> shift2
    return jnp.clip(r, -32768, 32767)


@partial(jax.jit, static_argnames=("n", "bit_depth"))
def dequant_skip_batch(levels, qps, n: int, bit_depth: int = 8):
    """Batched dequant + transform-skip scaling (8.6.4.2 ts path):
    r = (d << 7 + round) >> (20 - bd), clipped."""
    d = _dequant_dev(levels, qps, n, bit_depth)
    shift2 = 20 - bit_depth
    r = ((d << 7) + (1 << (shift2 - 1))) >> shift2
    return jnp.clip(r, -32768, 32767)


def residuals_for_ops(ops, bit_depth: int) -> dict:
    """Compute all residuals for a recon op list in per-bucket device
    launches.  Returns {id(tu): (n, n) int32 numpy residual}.

    Buckets: (n, dst, skip) for transformed TUs; bypass TUs are
    identity (levels) and stay host-side.
    """
    buckets: dict[tuple, list] = {}
    for op in ops:
        tu = getattr(op, "tu", None)     # PcmOps carry no TU
        if tu is None or tu.bypass:
            continue
        key = (tu.n, bool(tu.dst), bool(tu.skip))
        buckets.setdefault(key, []).append(tu)
    out: dict[int, np.ndarray] = {}
    for (n, dst, skip), tus in buckets.items():
        lv = jnp.asarray(
            np.stack([t.levels for t in tus]).astype(np.int32))
        qp = jnp.asarray(np.array([t.qp for t in tus], np.int32))
        if skip:
            res = dequant_skip_batch(lv, qp, n, bit_depth)
        else:
            res = dequant_itransform_batch(lv, qp, n, bit_depth,
                                           dst=dst)
        res_np = np.asarray(res)
        for i, t in enumerate(tus):
            out[id(t)] = res_np[i]
    return out


def residuals_packed(tu_meta: np.ndarray, levels: np.ndarray,
                     bit_depth: int) -> np.ndarray:
    """Device TU-bucket residuals over the NATIVE flat layout
    (tu_meta rows: x,y,n,cidx,skip,bypass,qp,dst; levels int16 packed
    per TU).  Returns int16 packed residuals in the same layout —
    feed native.hevc_recon(..., residuals=...).

    One batched launch per (n, dst, skip) bucket: the whole picture's
    inverse transforms (the FLOP-dense stage) run as device matmuls
    while the host keeps only CABAC + the prediction wavefront."""
    m = len(tu_meta)
    out = np.empty(len(levels), np.int16)
    if m == 0:
        return out
    ns = tu_meta[:, 2].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(ns * ns)])
    buckets: dict[tuple, list] = {}
    for t in range(m):
        n = int(tu_meta[t, 2])
        skip = bool(tu_meta[t, 4])
        byp = bool(tu_meta[t, 5])
        dst = bool(tu_meta[t, 7])
        if byp:
            out[offs[t]:offs[t + 1]] = levels[offs[t]:offs[t + 1]]
            continue
        buckets.setdefault((n, dst, skip), []).append(t)
    for (n, dst, skip), idxs in buckets.items():
        lv = np.stack([
            levels[offs[t]:offs[t + 1]].astype(np.int32)
            .reshape(n, n) for t in idxs])
        qp = np.array([tu_meta[t, 6] for t in idxs], np.int32)
        if skip:
            res = dequant_skip_batch(jnp.asarray(lv), jnp.asarray(qp),
                                     n, bit_depth)
        else:
            res = dequant_itransform_batch(jnp.asarray(lv),
                                           jnp.asarray(qp), n,
                                           bit_depth, dst=dst)
        res_np = np.asarray(res).astype(np.int16)
        for k, t in enumerate(idxs):
            out[offs[t]:offs[t + 1]] = res_np[k].ravel()
    return out
