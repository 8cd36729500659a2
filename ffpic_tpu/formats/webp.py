"""WebP container codec.

Parity with the reference's format/webp.c RIFF layer: VP8 (lossy key
frame, full decode via ffpic_tpu.formats.vp8), VP8X extended files,
ALPH chunk (we actually decode the alpha plane — the reference parses
but ignores it, webp.c:2031-2039), EXIF/XMP metadata; VP8L lossless is
FULLY decoded (native C entropy path; the reference stubs it,
webp.c:1928-1999); ANIM/ANMF animations composite to full canvases
with libwebp-exact blending and disposal (the reference has no
animation support at all).

Color output modes:
* "libwebp": BT.601 limited-range with libwebp's exact fixed-point
  (yuv.h constants) and fancy (diamond) chroma upsampling — matches
  libwebp/PIL output.
* "reference": the C reference's plane-level conversion
  (colorspace.c:291-329 — full-range treatment, 1.28/2.128
  coefficients, truncation) for conformance against it.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu.formats.pic import Pic, PixelFormat
from ffpic_tpu.formats.registry import Codec, register
from ffpic_tpu.utils.vlog import get_logger
from ffpic_tpu.utils import trace

log = get_logger("webp")


def probe(data: bytes) -> bool:
    return (len(data) > 16 and data[:4] == b"RIFF" and
            data[8:12] == b"WEBP")


def _fancy_upsample(chroma: np.ndarray, H: int, W: int) -> np.ndarray:
    """libwebp's 'fancy' 2x chroma upsampler (upsampling.c): each
    output pixel is a (9a+3b+3c+d+8)>>4 diamond blend of the four
    nearest chroma samples, borders replicated."""
    c = chroma.astype(np.int32)
    ch, cw = c.shape
    cN = np.vstack([c[:1], c[:-1]])
    cS = np.vstack([c[1:], c[-1:]])
    cW = np.hstack([c[:, :1], c[:, :-1]])
    cE = np.hstack([c[:, 1:], c[:, -1:]])
    cNW = np.hstack([cN[:, :1], cN[:, :-1]])
    cNE = np.hstack([cN[:, 1:], cN[:, -1:]])
    cSW = np.hstack([cS[:, :1], cS[:, :-1]])
    cSE = np.hstack([cS[:, 1:], cS[:, -1:]])
    out = np.zeros((2 * ch, 2 * cw), np.int32)
    out[0::2, 0::2] = (9 * c + 3 * (cN + cW) + cNW + 8) >> 4
    out[0::2, 1::2] = (9 * c + 3 * (cN + cE) + cNE + 8) >> 4
    out[1::2, 0::2] = (9 * c + 3 * (cS + cW) + cSW + 8) >> 4
    out[1::2, 1::2] = (9 * c + 3 * (cS + cE) + cSE + 8) >> 4
    return out[:H, :W].astype(np.uint8)


def _yuv_to_rgb_libwebp(Y, U, V, H, W):
    """libwebp yuv.h fixed point: value>>6 after MultHi (>>8) terms."""
    y = Y[:H, :W].astype(np.int32)
    # crop chroma to its valid sample grid first so the upsampler's
    # edge replication (not MB padding) feeds the borders
    ch, cw = (H + 1) // 2, (W + 1) // 2
    u = _fancy_upsample(U[:ch, :cw], H, W).astype(np.int32)
    v = _fancy_upsample(V[:ch, :cw], H, W).astype(np.int32)

    def mult_hi(val, coeff):
        return (val * coeff) >> 8

    yv = mult_hi(y, 19077)
    r = yv + mult_hi(v, 26149) - 14234
    g = yv - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708
    b = yv + mult_hi(u, 33050) - 17685

    def clip8(x):
        return np.clip(x >> 6, 0, 255).astype(np.uint8)

    return clip8(r), clip8(g), clip8(b)


def _yuv_to_rgb_reference(Y, U, V, H, W):
    """C reference plane path (colorspace.c:316-318): nearest upsample,
    full-range treatment with the quirky coefficients + truncation."""
    y = Y[:H, :W].astype(np.float64)
    u = np.repeat(np.repeat(U, 2, 0), 2, 1)[:H, :W].astype(np.float64) - 128
    v = np.repeat(np.repeat(V, 2, 0), 2, 1)[:H, :W].astype(np.float64) - 128
    r = np.clip(np.trunc(y + 1.28 * v), 0, 255).astype(np.uint8)
    g = np.clip(np.trunc(y - 0.215 * u - 0.381 * v), 0, 255).astype(np.uint8)
    b = np.clip(np.trunc(y + 2.128 * u), 0, 255).astype(np.uint8)
    return r, g, b


def _decode_alpha(alph: bytes, H: int, W: int) -> np.ndarray | None:
    """ALPH chunk: method 0 = raw, method 1 = VP8L-compressed (the
    latter needs the VP8L decoder — returns None until it lands)."""
    if not alph:
        return None
    b0 = alph[0]
    method = b0 & 3
    filt = (b0 >> 2) & 3
    if method == 0:
        a = np.frombuffer(alph, np.uint8, W * H, 1).reshape(H, W).copy()
    elif method == 1:
        from ffpic_tpu.formats.vp8l import decode_alpha_stream
        a = decode_alpha_stream(alph[1:], W, H)
    else:
        return None
    if filt == 1:    # horizontal
        a = a.astype(np.int32)
        for x in range(1, W):
            a[:, x] = (a[:, x] + a[:, x - 1]) & 255
        a = a.astype(np.uint8)
    elif filt == 2:  # vertical
        a = (np.cumsum(a.astype(np.int64), axis=0) & 255).astype(np.uint8)
    elif filt == 3:  # gradient — serial recurrence
        a = a.astype(np.int32)
        for yy in range(H):
            for xx in range(W):
                l = a[yy, xx - 1] if xx else 0
                t = a[yy - 1, xx] if yy else 0
                tl = a[yy - 1, xx - 1] if (xx and yy) else 0
                g = np.clip(l + t - tl, 0, 255)
                a[yy, xx] = (a[yy, xx] + g) & 255
        a = a.astype(np.uint8)
    return a


def _decode_frame_rgba(sub: dict, mode: str) -> np.ndarray:
    """Decode one animation frame's VP8/VP8L (+ALPH) payload to a
    numpy RGBA array (host paths only — frames feed the host
    compositor, so shipping YUV to the device would lose like the
    single-image case, see load())."""
    import os
    if "VP8 " in sub:
        from ffpic_tpu.formats.vp8 import VP8Decoder
        dec = VP8Decoder(sub["VP8 "])
        H, W = dec.hdr.height, dec.hdr.width
        Y, U, V = dec.decode()
        a = _decode_alpha(sub.get("ALPH", b""), H, W)
        from ffpic_tpu import native
        if mode == "libwebp" and native.available() \
                and not os.environ.get("FFPIC_HOST_COLOR"):
            rgba = native.vp8_color_libwebp(
                np.ascontiguousarray(Y[:H, :W]), U, V, H, W, a)
        else:
            conv = (_yuv_to_rgb_libwebp if mode == "libwebp"
                    else _yuv_to_rgb_reference)
            r, g, b = conv(Y, U, V, H, W)
            if a is None:
                a = np.full((H, W), 255, np.uint8)
            rgba = np.dstack([r, g, b, a])
        return np.asarray(rgba)
    if "VP8L" in sub:
        from ffpic_tpu.formats.vp8l import decode_vp8l
        return np.asarray(decode_vp8l(sub["VP8L"]))
    raise ValueError("ANMF frame without VP8/VP8L payload")


def _blend_libwebp(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """libwebp's non-premultiplied alpha-blend of a new frame over
    the canvas (demux/anim_decode.c BlendPixelNonPremult), exact
    integer arithmetic as of libwebp 1.6: the dst weight is
    (dst_a * (256 - src_a)) >> 8, the per-pixel divide is a
    truncated 0x1000000/blend_a reciprocal multiply, and fully
    opaque / fully transparent source pixels short-circuit."""
    src32 = src.astype(np.uint64)
    dst32 = dst.astype(np.uint64)
    sa = src32[..., 3]
    scale = (dst32[..., 3] * (256 - sa)) >> 8
    ba = sa + scale
    recip = 0x1000000 // np.maximum(ba, 1)
    out = np.empty_like(src)
    for c in range(3):
        out[..., c] = (((src32[..., c] * sa + dst32[..., c] * scale)
                        * recip) >> 24).astype(np.uint8)
    out[..., 3] = ba.astype(np.uint8)
    out = np.where((sa == 255)[..., None], src, out)
    return np.where((sa == 0)[..., None], dst, out)


def _load_animation(anmf: list, chunks: dict, meta: dict,
                    skip_decode: bool, mode: str) -> list[Pic]:
    """ANIM/ANMF animation: each frame decodes like a still WebP and
    composites onto the canvas per its blend/dispose flags —
    WebPAnimDecoder semantics (dispose-to-background clears to
    TRANSPARENT black; the ANIM background color is a player hint).
    The reference's webp.c has no animation support at all."""
    cw, ch = meta.get("canvas", (0, 0))
    if "ANIM" in chunks and len(chunks["ANIM"]) >= 6:
        bg, loop = struct.unpack_from("<IH", chunks["ANIM"], 0)
        meta["background"] = bg
        meta["loop"] = loop
    meta.update(width=cw, height=ch, format="animation",
                frames=len(anmf))
    if skip_decode:
        return [Pic(width=cw, height=ch, depth=32, pitch=cw * 4,
                    codec="WEBP", meta=meta)]
    canvas = np.zeros((ch, cw, 4), np.uint8)
    pics: list[Pic] = []
    dispose_rect = None
    for payload in anmf:
        if len(payload) < 16:
            raise ValueError("truncated ANMF header")
        fx = int.from_bytes(payload[0:3], "little") * 2
        fy = int.from_bytes(payload[3:6], "little") * 2
        fw = int.from_bytes(payload[6:9], "little") + 1
        fh = int.from_bytes(payload[9:12], "little") + 1
        dur = int.from_bytes(payload[12:15], "little")
        flags = payload[15]
        no_blend = bool(flags & 2)
        dispose_bg = bool(flags & 1)
        if fy + fh > ch or fx + fw > cw:
            raise ValueError("ANMF frame rect outside canvas")
        sub: dict[str, bytes] = {}
        p = 16
        while p + 8 <= len(payload):
            tag = payload[p:p + 4].decode("latin1")
            size = struct.unpack_from("<I", payload, p + 4)[0]
            if p + 8 + size > len(payload):
                raise ValueError("truncated ANMF subchunk")
            sub[tag] = payload[p + 8:p + 8 + size]
            p += 8 + size + (size & 1)
        rgba = _decode_frame_rgba(sub, mode)[:fh, :fw]
        if dispose_rect is not None:
            dy, dx, dh, dw = dispose_rect
            canvas[dy:dy + dh, dx:dx + dw] = 0
        target = canvas[fy:fy + fh, fx:fx + fw]
        if no_blend:
            target[:] = rgba
        else:
            target[:] = _blend_libwebp(rgba, target)
        dispose_rect = (fy, fx, fh, fw) if dispose_bg else None
        pics.append(Pic(pixels=canvas.copy(), width=cw, height=ch,
                        depth=32, pitch=cw * 4,
                        format=PixelFormat.RGBA32, codec="WEBP",
                        delay_ms=dur, meta=meta))
    if not pics:
        raise ValueError("animated WebP with zero ANMF frames")
    return pics


def load(data: bytes, skip_decode: bool = False,
         mode: str = "libwebp") -> list[Pic]:
    riff_size = struct.unpack_from("<I", data, 4)[0]
    pos = 12
    chunks: dict[str, bytes] = {}
    anmf: list[bytes] = []
    order = []
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4].decode("latin1")
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > len(data):
            raise ValueError(f"truncated WEBP: chunk {tag!r} claims "
                             f"{size} bytes past end of file")
        if tag == "ANMF":
            anmf.append(data[pos + 8:pos + 8 + size])
        else:
            chunks[tag] = data[pos + 8:pos + 8 + size]
        order.append(tag)
        pos += 8 + size + (size & 1)

    meta = dict(chunks=order, riff_size=riff_size)
    if "VP8X" in chunks:
        x = chunks["VP8X"]
        meta["features"] = x[0]
        meta["canvas"] = (1 + (int.from_bytes(x[4:7], "little")),
                          1 + (int.from_bytes(x[7:10], "little")))

    if anmf:
        with trace.stage("webp.animation"):
            return _load_animation(anmf, chunks, meta, skip_decode,
                                   mode)

    if "VP8 " in chunks:
        vp8_data = chunks["VP8 "]
        from ffpic_tpu.formats.vp8 import VP8Decoder
        dec = VP8Decoder(vp8_data)
        W, H = dec.hdr.width, dec.hdr.height
        meta.update(width=W, height=H, format="lossy VP8",
                    version=dec.version)
        if skip_decode:
            return [Pic(width=W, height=H, depth=32, pitch=W * 4,
                        codec="WEBP", meta=meta)]
        with trace.stage("webp.vp8_decode"):
            Y, U, V = dec.decode()
        meta["partitions"] = dec.hdr.n_partitions
        meta["filter"] = ("simple" if dec.hdr.filter_type
                          else "normal")
        meta["quant_yac"] = dec.hdr.q_yac
        a = _decode_alpha(chunks.get("ALPH", b""), H, W)
        if mode == "libwebp":
            import os
            from ffpic_tpu import native
            if os.environ.get("FFPIC_VP8_DEVICE_COLOR"):
                # fancy upsample + fixed-point color matrix as one
                # device launch (ops/vp8_kernels.vp8_yuv_to_rgba,
                # bit-exact vs the host paths — tests/test_webp.py);
                # the VP8 analog of the reference's accel-layer
                # dispatch (webp.c:1868 -> colorspace.c:291).  Opt-in
                # for single-image loads: shipping Y/U/V to the device
                # and back for ~0.2 ms of math does not pay (device
                # color belongs to batched pipelines feeding further
                # device work).
                with trace.stage("webp.device_color"):
                    from ffpic_tpu.ops.vp8_kernels import vp8_yuv_to_rgba
                    rgba = vp8_yuv_to_rgba(Y, U, V, H, W)
                    if a is not None:
                        import jax.numpy as jnp
                        rgba = rgba.at[:, :, 3].set(jnp.asarray(a))
            elif (native.available()
                    and not os.environ.get("FFPIC_HOST_COLOR")):
                with trace.stage("webp.host_color"):
                    rgba = native.vp8_color_libwebp(
                        np.ascontiguousarray(Y[:H, :W]), U, V, H, W,
                        a)
            else:
                r, g, b = _yuv_to_rgb_libwebp(Y, U, V, H, W)
                if a is None:
                    a = np.full((H, W), 255, np.uint8)
                rgba = np.dstack([r, g, b, a])
        else:
            r, g, b = _yuv_to_rgb_reference(Y, U, V, H, W)
            if a is None:
                a = np.full((H, W), 255, np.uint8)
            rgba = np.dstack([r, g, b, a])
        return [Pic(pixels=rgba, width=W, height=H, depth=32,
                    pitch=W * 4, format=PixelFormat.RGBA32, codec="WEBP",
                    meta=meta)]

    if "VP8L" in chunks:
        l = chunks["VP8L"]
        if l[0] != 0x2F:
            raise ValueError("bad VP8L signature")
        bits = int.from_bytes(l[1:5], "little")
        W = (bits & 0x3FFF) + 1
        H = ((bits >> 14) & 0x3FFF) + 1
        meta.update(width=W, height=H, format="lossless VP8L",
                    alpha_hint=(bits >> 28) & 1)
        if skip_decode:
            return [Pic(width=W, height=H, depth=32, pitch=W * 4,
                        codec="WEBP", meta=meta)]
        from ffpic_tpu.formats.vp8l import decode_vp8l
        rgba = decode_vp8l(l)
        return [Pic(pixels=rgba, width=W, height=H, depth=32,
                    pitch=W * 4, format=PixelFormat.RGBA32, codec="WEBP",
                    meta=meta)]

    raise ValueError("no VP8/VP8L payload in WebP container")


def info(pic: Pic) -> str:
    m = pic.meta
    lines = ["WEBP file format",
             f"\twidth {m.get('width')}, height {m.get('height')}",
             f"\t{m.get('format', '?')}"]
    if "partitions" in m:
        lines.append(f"\tpartitions {m['partitions']}, "
                     f"{m['filter']} loop filter, "
                     f"q_yac {m['quant_yac']}")
    lines.append(f"\tchunks: {' '.join(m['chunks'])}")
    return "\n".join(lines)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    """RIFF chunk with the even-size padding byte."""
    pad = b"\x00" if len(payload) & 1 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def encode(pic, loops: int = 0, **options) -> bytes:
    """Lossless WebP (VP8L) encode; multi-frame pics emit an
    animated VP8X+ANIM+ANMF container (full-canvas frames, blending
    off — lossless round-trip by construction).  The reference has
    no WebP encoder and even its VP8L *decoder* is a stub
    (webp.c:1928-1999)."""
    import numpy as np
    from ffpic_tpu.formats.vp8l_enc import encode_webp_lossless, \
        encode_vp8l
    rgba = pic.np_pixels() if hasattr(pic, "np_pixels") \
        else np.asarray(pic.pixels)
    frames = list(getattr(pic, "frames", None) or [])
    if not frames:
        return encode_webp_lossless(rgba)

    cw, ch = pic.width, pic.height
    has_alpha = False
    body = bytearray()
    for fr in [pic] + frames:
        fa = fr.np_pixels() if hasattr(fr, "np_pixels") \
            else np.asarray(fr.pixels)
        if fa.shape[0] != ch or fa.shape[1] != cw:
            raise ValueError("animated WebP frames must match the "
                             "canvas size")
        if fa.shape[-1] == 4 and (fa[..., 3] != 255).any():
            has_alpha = True
        dur = int(getattr(fr, "delay_ms", 0) or 0)
        # full-canvas frame, blending off (flag bit 1), keep-dispose
        anmf = (_u24(0) + _u24(0) + _u24(cw - 1) + _u24(ch - 1)
                + _u24(dur) + bytes([2])
                + _chunk(b"VP8L", encode_vp8l(fa)))
        body += _chunk(b"ANMF", anmf)

    vp8x = (bytes([(0x10 if has_alpha else 0) | 0x02, 0, 0, 0])
            + _u24(cw - 1) + _u24(ch - 1))
    anim = struct.pack("<IH", 0, int(loops))    # bg color + loops
    payload = (_chunk(b"VP8X", vp8x) + _chunk(b"ANIM", anim)
               + bytes(body))
    return (b"RIFF" + struct.pack("<I", len(payload) + 4)
            + b"WEBP" + payload)


register(Codec(name="WEBP", probe=probe, load=load, info=info,
               encode=encode))
