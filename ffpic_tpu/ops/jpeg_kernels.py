"""Device-side JPEG decode pipeline: fused dequant → 8x8 IDCT →
chroma upsample → YUV→RGBA/BGRA over whole-image block grids.

Design (replaces the reference's per-MCU serial pipeline,
format/jpg.c:512-576): the host entropy decoder emits one planar
coefficient tensor per component, shaped (blocks_y, blocks_x, 8, 8)
int16 in natural (de-zigzagged) raster order, and a single jitted XLA
program does all dense math for the whole image (or a batch of images)
in one launch. All integer stages are bit-exact mirrors of the C
reference (utils/idct.c:512-534); the float color stage follows
utils/colorspace.c:133-172 (computed in f32; the C double path is
matched within +-1 LSB, covered by golden-model tests).

The IDCT is unrolled constant shift-add chains that XLA fuses into
elementwise integer loops; int32 wraparound semantics are preserved
because XLA integer ops wrap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ffpic_tpu.ops.golden import IDCT_P13, FDCT_P13

_T = jnp.asarray(IDCT_P13.astype(np.int32))
_D = jnp.asarray(FDCT_P13.astype(np.int32))


def _i16(x):
    return x.astype(jnp.int16)


def _lincomb8(mat: np.ndarray, vecs: list):
    """rows of constant-scalar linear combinations: out[i] = sum_u
    mat[i,u]*vecs[u]. Unrolled with Python-int constants — XLA:CPU
    compiles integer dots pathologically slowly (minutes for an 8-wide
    int32 einsum), while this shift-add form compiles in <1s and fuses
    into one elementwise loop. int32 wraparound matches C."""
    return [sum(int(mat[i, u]) * vecs[u] for u in range(8) if mat[i, u] != 0)
            for i in range(8)]


@jax.jit
def dequant_idct_blocks(coeffs, quant):
    """coeffs: (..., 8, 8) int16 de-zigzagged; quant: (8, 8) int32.
    Returns (..., 8, 8) int16 samples in [0, 65535]-clamped int16
    storage — exact mirror of dequant_data_unit + idct_8x8_16
    (format/jpg.c:247-253 + utils/idct.c:512-534)."""
    x = _i16(coeffs.astype(jnp.int32) * quant).astype(jnp.int32)
    # column pass: col[i, x] = sum_u T[i,u] * in[u, x]
    cols = [x[..., u, :] for u in range(8)]
    col = _lincomb8(IDCT_P13, cols)
    col = [_i16((c + (1 << 10)) >> 11).astype(jnp.int32) for c in col]
    # row pass: out[y, i] = sum_u T[i,u] * col[u][y]  per row y == col idx
    # col[i] has shape (..., 8=x); regroup to per-row vectors over x
    colm = jnp.stack(col, axis=-2)                    # (..., 8y, 8x)
    rows = [colm[..., u] for u in range(8)]           # along x
    row = _lincomb8(IDCT_P13, rows)
    out = jnp.stack(row, axis=-1)                     # (..., y, i=x)
    return _i16(jnp.clip((out + (257 << 17)) >> 18, 0, 65535))


@jax.jit
def fdct_blocks(samples):
    """Forward DCT, exact mirror of fdct_8x8_8 (utils/idct.c:778-807).
    samples: (..., 8, 8) int16 level-shifted (y-128)."""
    x = samples.astype(jnp.int32)
    rows_in = [x[..., :, u] for u in range(8)]
    row = _lincomb8(FDCT_P13, rows_in)
    row = [_i16(((r >> 1) + (1 << 12)) >> 13).astype(jnp.int32) for r in row]
    rowm = jnp.stack(row, axis=-1)                    # (..., y, i)
    cols_in = [rowm[..., u, :] for u in range(8)]
    col = _lincomb8(FDCT_P13, cols_in)
    out = jnp.stack([_i16(((c >> 1) + (1 << 12)) >> 13) for c in col], axis=-2)
    return out


def blocks_to_plane(blocks):
    """(nby, nbx, 8, 8) -> (nby*8, nbx*8)"""
    nby, nbx = blocks.shape[0], blocks.shape[1]
    return blocks.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)


def plane_to_blocks(plane):
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def upsample_nearest(plane, v: int, h: int, out_h: int, out_w: int):
    """Nearest-neighbor chroma upsample; index math identical to the
    reference's uu = U[(i/v)*8 + (k/h)] (colorspace.c:149-150)."""
    if v != 1:
        plane = jnp.repeat(plane, v, axis=0)
    if h != 1:
        plane = jnp.repeat(plane, h, axis=1)
    return plane[:out_h, :out_w]


def upsample_fancy(plane, v: int, h: int, out_h: int, out_w: int):
    """libjpeg's 'fancy' (triangle-filter) chroma upsampling
    (jdsample.c h2v2/h2v1): 3:1 blend toward the nearer sample with
    the 8/7 alternating bias, borders replicated. Vectorized — the
    per-pixel sequential C loop becomes shifted-plane math."""
    x = plane.astype(jnp.int32)
    if v == 2:
        up = jnp.concatenate([x[:1], x[:-1]], axis=0)
        dn = jnp.concatenate([x[1:], x[-1:]], axis=0)
        rows = jnp.stack([3 * x + up, 3 * x + dn], axis=1) \
            .reshape(-1, x.shape[1])
        ebias, obias = 8, 7          # h2v2: (3t + l + 8)>>4 / (+7)
    else:
        rows = x * 4
        ebias, obias = 4, 8          # h2v1: == (3a + b + 1)>>2 / (+2)
    if h == 2:
        lf = jnp.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
        rt = jnp.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
        even = (3 * rows + lf + ebias) >> 4
        odd = (3 * rows + rt + obias) >> 4
        out = jnp.stack([even, odd], axis=2).reshape(rows.shape[0], -1)
    else:
        out = (rows + 2) >> 2
    return out[:out_h, :out_w].astype(jnp.int16)


def color_convert(yp, up, vp, order: str = "bgra", mode: str = "reference"):
    """(H, W) int16 planes -> (H, W, 4) uint8.

    mode="reference": the C decoder's coefficients with
    truncation-toward-zero (colorspace.c:162-164): r=y+1.280v,
    g=y-0.215u-0.381v, b=y+2.128u.
    mode="bt601": standard JFIF/BT.601 with round-half-up
    (the "correct" path the reference comments out,
    colorspace.c:153-155).
    mode="rgb": the planes already ARE R,G,B (Adobe transform=0 /
    TIFF-EP photometric-RGB JPEG; component ids 'R','G','B') — no
    matrix, just clip.
    """
    if mode == "rgb":
        r = jnp.clip(yp, 0, 255).astype(jnp.uint8)
        g = jnp.clip(up, 0, 255).astype(jnp.uint8)
        b = jnp.clip(vp, 0, 255).astype(jnp.uint8)
        a = jnp.full_like(r, 255)
        if order == "bgra":
            return jnp.stack([b, g, r, a], axis=-1)
        if order == "rgba":
            return jnp.stack([r, g, b, a], axis=-1)
        raise ValueError(order)
    yy = yp.astype(jnp.float32)
    uu = up.astype(jnp.float32) - 128.0
    vv = vp.astype(jnp.float32) - 128.0
    if mode == "reference":
        r = jnp.trunc(yy + 1.280 * vv)
        g = jnp.trunc(yy - 0.215 * uu - 0.381 * vv)
        b = jnp.trunc(yy + 2.128 * uu)
    elif mode == "bt601":
        r = jnp.floor(yy + 1.402 * vv + 0.5)
        g = jnp.floor(yy - 0.344136 * uu - 0.714136 * vv + 0.5)
        b = jnp.floor(yy + 1.772 * uu + 0.5)
    else:
        raise ValueError(mode)
    r = jnp.clip(r, 0, 255).astype(jnp.uint8)
    g = jnp.clip(g, 0, 255).astype(jnp.uint8)
    b = jnp.clip(b, 0, 255).astype(jnp.uint8)
    a = jnp.full_like(r, 255)
    if order == "bgra":
        return jnp.stack([b, g, r, a], axis=-1)
    if order == "rgba":
        return jnp.stack([r, g, b, a], axis=-1)
    raise ValueError(order)


@functools.partial(
    jax.jit,
    static_argnames=("samplings", "out_h", "out_w", "order", "mode",
                     "gray_chroma", "upsample"),
)
def decode_mcu_planes(coeffs, quants, samplings, out_h, out_w,
                      order="bgra", mode="reference", gray_chroma=128,
                      upsample="nearest"):
    """Full device pipeline for one image.

    coeffs: tuple of per-component (nby_c, nbx_c, 8, 8) int16 arrays.
    quants: tuple of per-component (8, 8) int32 quant tables.
    samplings: static tuple of (v, h) per component, as luma-relative
      upsample factors (reference jpg.c uses the luma sampling as the
      MCU geometry; chroma planes are 1x1-per-MCU).
    out_h/out_w: cropped output size (width already 8-aligned per the
      reference's p->width convention, jpg.c:792).
    """
    if len(coeffs) not in (1, 3):
        # matches the reference's scope: 1 (gray) or 3 (YCbCr)
        # components reach the pixel path (jpg.c handles no CMYK)
        raise ValueError(
            f"unsupported component count {len(coeffs)} (want 1 or 3)")
    up_fn = upsample_fancy if upsample == "fancy" else upsample_nearest
    planes = []
    for c, (coef, q) in enumerate(zip(coeffs, quants)):
        samples = dequant_idct_blocks(coef, q)
        plane = blocks_to_plane(samples)
        v, h = samplings[c]
        if v == 1 and h == 1:
            planes.append(plane[:out_h, :out_w])
        else:
            # crop to the valid sample grid so fancy upsampling's edge
            # replication (not MCU padding) feeds the borders
            ph = -(-out_h // v)
            pw = -(-out_w // h)
            planes.append(up_fn(plane[:ph, :pw], v, h, out_h, out_w))
    if len(planes) == 1:
        # grayscale: gray_chroma=128 is neutral; 0 replicates the
        # reference's tinted dummy-zero blocks (jpg.c:552-555)
        zero = jnp.full((out_h, out_w), gray_chroma, jnp.int16)
        yp, up, vp = planes[0], zero, zero
    else:
        yp, up, vp = planes[0], planes[1], planes[2]
    return color_convert(yp, up, vp, order=order, mode=mode)


@functools.partial(jax.jit, static_argnames=("order", "mode"))
def decode_batch_420(ycoef, ucoef, vcoef, yquant, cquant,
                     order="rgba", mode="reference"):
    """Batched 4:2:0 pipeline: (N, nby, nbx, 8, 8) luma + (N, nby/2,
    nbx/2, 8, 8) chroma coefficient tensors -> (N, H, W, 4) uint8.
    Used by the benchmark and decode_batch for same-sized shards."""
    ys = dequant_idct_blocks(ycoef, yquant)
    us = dequant_idct_blocks(ucoef, cquant)
    vs = dequant_idct_blocks(vcoef, cquant)

    def assemble(b):
        n, nby, nbx = b.shape[0], b.shape[1], b.shape[2]
        return b.transpose(0, 1, 3, 2, 4).reshape(n, nby * 8, nbx * 8)

    yp = assemble(ys)
    up = assemble(us)
    vp = assemble(vs)
    H, W = yp.shape[1], yp.shape[2]
    up = jnp.repeat(jnp.repeat(up, 2, axis=1), 2, axis=2)[:, :H, :W]
    vp = jnp.repeat(jnp.repeat(vp, 2, axis=1), 2, axis=2)[:, :H, :W]
    return color_convert(yp, up, vp, order=order, mode=mode)


@functools.lru_cache(maxsize=32)
def mcu_block_map(samplings, mcus_x: int, mcus_y: int, actual=None):
    """Static geometry map for the packed host-emission path: the g-th
    block in MCU decode order (components in frame order, v*h blocks
    raster within the MCU) -> flat GLOBAL block index into the
    concatenated per-component coefficient space.  Returned as a
    device-resident jnp.int32[G] (constant across frames of one
    geometry, so it is staged to the device exactly once).

    Single-component scans are NON-interleaved (ITU-T81 A.2.2): pass
    ``actual=(nby_actual, nbx_actual)`` and the map is a raster walk
    of the actual block grid with the padded plane stride."""
    import jax.numpy as jnp_
    if len(samplings) == 1 and actual is not None:
        v, h = samplings[0]
        nbx = mcus_x * h
        nbya, nbxa = actual
        by, bx = np.mgrid[0:nbya, 0:nbxa]
        return jnp_.asarray((by * nbx + bx).reshape(-1).astype(np.int32))
    maps = []
    base = 0
    per_comp = []
    for (v, h) in samplings:
        nby, nbx = mcus_y * v, mcus_x * h
        per_comp.append((base, nby, nbx, v, h))
        base += nby * nbx
    my, mx = np.mgrid[0:mcus_y, 0:mcus_x]
    for (cbase, nby, nbx, v, h) in per_comp:
        # (mcus_y, mcus_x, v, h) block indices for this component
        vi, hi = np.mgrid[0:v, 0:h]
        by = my[:, :, None, None] * v + vi[None, None]
        bx = mx[:, :, None, None] * h + hi[None, None]
        maps.append((cbase + by * nbx + bx).reshape(mcus_y, mcus_x, v * h))
    # interleave per MCU: comp-major within each MCU
    g = np.concatenate(maps, axis=2).reshape(-1)
    return jnp_.asarray(g.astype(np.int32))


def _zz_dev():
    """zigzag position k -> raster position within the 8x8 block
    (converted per call: inside a jit trace this becomes a baked
    constant; caching the converted array would leak a tracer)."""
    from ffpic_tpu.ops.golden import ZIGZAG
    return jnp.asarray(np.asarray(ZIGZAG, np.int32))


@functools.partial(jax.jit, static_argnames=("shapes",))
def _unpack_coeffs(counts, ks, vals, block_map, shapes):
    """Rebuild dense per-component coefficient tensors from the packed
    host emission (counts/ks/vals, see host_jpeg.c) with one
    scatter-add over the concatenated coefficient space."""
    counts = counts.astype(jnp.int32)
    starts = jnp.cumsum(counts) - counts          # start offset per block
    n = ks.shape[0]
    # block id per nonzero: +1 at each later block's start (zero-count
    # blocks collapse onto the same offset and accumulate — cumsum
    # still lands on the right id); starts beyond n (trailing empties)
    # are dropped.
    marks = jnp.zeros(n, jnp.int32).at[starts[1:]].add(1, mode="drop")
    ids = jnp.cumsum(marks)
    flat_idx = block_map[ids] * 64 + _zz_dev()[ks.astype(jnp.int32)]
    total = sum(nby * nbx for nby, nbx in shapes) * 64
    flat = jnp.zeros(total, jnp.int16).at[flat_idx].add(vals, mode="drop")
    out = []
    base = 0
    for (nby, nbx) in shapes:
        out.append(flat[base:base + nby * nbx * 64]
                   .reshape(nby, nbx, 8, 8))
        base += nby * nbx * 64
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("shapes", "order", "mode"))
def decode_frame_420_packed(counts, ks, vals, block_map, yquant, cquant,
                            shapes, order="rgba", mode="reference"):
    """Packed-staging single-frame 4:2:0 pipeline: host ships ~2.4x
    fewer bytes than dense planes (u8 count/pos + i16 value per
    nonzero); the dense rebuild, dequant+IDCT, upsample and color all
    fuse into this one launch."""
    y, u, v = _unpack_coeffs(counts, ks, vals, block_map, shapes)
    return decode_batch_420(y[None], u[None], v[None], yquant, cquant,
                            order=order, mode=mode)[0]


def fuse_packed(counts, ks, vals) -> np.ndarray:
    """Concatenate one frame's packed emission (counts u8[G], ks
    u8[E], vals i16[E]) into a single uint8 staging buffer — ONE
    host->device transfer per frame instead of three, paying the
    per-transfer fixed cost once."""
    return np.concatenate([np.asarray(counts, np.uint8),
                           np.asarray(ks, np.uint8),
                           np.asarray(vals, np.int16).view(np.uint8)])


@functools.partial(jax.jit, static_argnames=("g", "e", "shapes",
                                             "order", "mode"))
def decode_frame_420_packed_fused(buf, block_map, yquant, cquant,
                                  g: int, e: int, shapes,
                                  order="rgba", mode="reference"):
    """decode_frame_420_packed on a fuse_packed buffer: the split
    into counts/ks/vals happens on device (g = block count, e =
    emission bucket; little-endian int16 bitcast matches the host)."""
    counts = buf[:g]
    ks = buf[g:g + e]
    vals = jax.lax.bitcast_convert_type(
        buf[g + e:g + e + 2 * e].reshape(e, 2), jnp.int16)
    y, u, v = _unpack_coeffs(counts, ks, vals, block_map, shapes)
    return decode_batch_420(y[None], u[None], v[None], yquant, cquant,
                            order=order, mode=mode)[0]


@functools.partial(jax.jit, static_argnames=("shapes", "order", "mode"))
def decode_batch_420_packed(counts, ks, vals, block_map, yquant,
                            cquant, shapes, order="rgba",
                            mode="reference"):
    """Batched packed-staging pipeline: N same-geometry frames'
    packed emissions decode in ONE launch (vs a launch per frame),
    and the host ships ONE stacked transfer per array instead of
    three per frame — the per-transfer fixed cost amortizes N-fold.

    counts (N, G) uint8; ks (N, E) uint8 / vals (N, E) int16 padded
    to a common bucket with zeros (padded entries scatter-add zeros —
    harmless); yquant/cquant (N, 1, 1, 8, 8) per-image tables."""
    def unpack(c, k, v):
        return _unpack_coeffs(c, k, v, block_map, shapes)

    y, u, v = jax.vmap(unpack)(counts, ks, vals)
    return decode_batch_420(y, u, v, yquant, cquant, order=order,
                            mode=mode)


def stack_packed(packed_list, minimum: int = 2048):
    """Host side of the batched packed path: stack per-frame
    (counts, ks, vals, nnz) tuples into rectangular arrays, padding
    ks/vals to the batch's power-of-two nnz bucket (stable jit
    shapes).  Returns (counts (N, G), ks (N, E), vals (N, E))."""
    n = len(packed_list)
    emax = _bucket(max(int(p[3]) for p in packed_list), minimum)
    c0 = np.asarray(packed_list[0][0])
    counts = np.empty((n, c0.shape[0]), np.uint8)
    ks = np.zeros((n, emax), np.uint8)
    vals = np.zeros((n, emax), np.int16)
    for i, (c, k, v, nnz) in enumerate(packed_list):
        counts[i] = np.asarray(c)
        ks[i, :nnz] = np.asarray(k)[:nnz]
        vals[i, :nnz] = np.asarray(v)[:nnz]
    return counts, ks, vals


def stack_packed_fused(packed_list, minimum: int = 2048):
    """Fused-batch staging: stack N frames' packed emissions into ONE
    uint8 buffer (counts (N,G) | ks (N,E) | vals (N,E) int16 views)
    so the batch ships in a SINGLE host->device transfer: three
    stacked transfers would pay the per-transfer fixed cost three
    times, one fused buffer pays it once."""
    n = len(packed_list)
    emax = _bucket(max(int(p[3]) for p in packed_list), minimum)
    g = np.asarray(packed_list[0][0]).shape[0]
    buf = np.zeros(n * (g + 3 * emax), np.uint8)
    cb = buf[:n * g].reshape(n, g)
    kb = buf[n * g:n * (g + emax)].reshape(n, emax)
    vb = buf[n * (g + emax):].reshape(n, 2 * emax)
    for i, (c, k, v, nnz) in enumerate(packed_list):
        cb[i] = np.asarray(c)
        kb[i, :nnz] = np.asarray(k)[:nnz]
        vb[i, :2 * nnz] = np.asarray(v, np.int16)[:nnz].view(np.uint8)
    return buf, g, emax


@functools.partial(jax.jit, static_argnames=("n", "g", "e", "shapes",
                                             "order", "mode"))
def decode_batch_420_packed_fused(buf, block_map, yquant, cquant,
                                  n: int, g: int, e: int, shapes,
                                  order="rgba", mode="reference"):
    """decode_batch_420_packed on a stack_packed_fused buffer: the
    counts/ks/vals split happens on device, so the whole batch is ONE
    transfer + ONE launch."""
    counts = buf[:n * g].reshape(n, g)
    ks = buf[n * g:n * (g + e)].reshape(n, e)
    vals = jax.lax.bitcast_convert_type(
        buf[n * (g + e):n * (g + 3 * e)].reshape(n, e, 2), jnp.int16)

    def unpack(c, k, v):
        return _unpack_coeffs(c, k, v, block_map, shapes)

    y, u, v = jax.vmap(unpack)(counts, ks, vals)
    return decode_batch_420(y, u, v, yquant, cquant, order=order,
                            mode=mode)


def _bucket(n: int, minimum: int = 2048) -> int:
    """Round nnz up to the next power of two (min 2048): few distinct
    jit shapes, padding bounded at 2x."""
    b = minimum
    while b < n:
        b <<= 1
    return b


@functools.partial(jax.jit, static_argnames=("shape",))
def _scatter_plane(idx, val, shape):
    """Rebuild a dense coefficient tensor from packed (idx, val) pairs
    on device.  Padding entries are (0, 0) and scatter-ADD zeros, so
    they are harmless."""
    flat = jnp.zeros(shape[0] * shape[1] * shape[2] * 64, jnp.int16)
    flat = flat.at[idx].add(val)
    return flat.reshape(shape[0], shape[1], shape[2], 8, 8)


def pack_coeffs(plane: np.ndarray, minimum: int = 2048):
    """Host side of the sparse staging path: pack nonzeros (C kernel)
    and pad to a power-of-two bucket for stable jit shapes."""
    from ffpic_tpu import native
    idx, val = native.pack_nonzero(plane)
    n = _bucket(len(idx), minimum)
    pidx = np.zeros(n, np.int32)
    pval = np.zeros(n, np.int16)
    pidx[:len(idx)] = idx
    pval[:len(val)] = val
    return pidx, pval


def decode_batch_420_sparse(packed, shapes, yquant, cquant,
                            order="rgba", mode="reference"):
    """Sparse-staged batched 4:2:0 pipeline.

    packed: ((yidx, yval), (uidx, uval), (vidx, vval)) from
    pack_coeffs, each covering a (N, nby, nbx, 8, 8) tensor flattened;
    shapes: ((N, nby, nbx), (N, nbc_y, nbc_x), same) static.  The
    host->device transfer is the packed pairs (~3x smaller than dense);
    the dense tensors are rebuilt on device by scatter-add.
    """
    (yi, yv), (ui, uv), (vi, vv) = packed
    ycoef = _scatter_plane(jnp.asarray(yi), jnp.asarray(yv), shapes[0])
    ucoef = _scatter_plane(jnp.asarray(ui), jnp.asarray(uv), shapes[1])
    vcoef = _scatter_plane(jnp.asarray(vi), jnp.asarray(vv), shapes[2])
    return decode_batch_420(ycoef, ucoef, vcoef, yquant, cquant,
                            order=order, mode=mode)
