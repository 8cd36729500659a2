"""PNG codec.

Decode parity with the reference's format/png.c:518-637 — chunk walk
with CRC verification, multi-IDAT concatenation, inflate, all five
scanline filters, sub-byte sample handling — plus the pieces the
reference leaves undone (png.c:707, 625-637): Adam7 deinterlacing,
palette→RGBA expansion, tRNS transparency, and 16-bit narrowing.

Host/device split: inflate runs on the host (CPython zlib; semantics defined
and differentially tested by ffpic_tpu.coding.deflate); filter
reconstruction runs on the host in C (native/host_png.c) because
Average/Paeth are nonlinear byte-serial recurrences — except for
streams using only None/Sub/Up, which reconstruct on device as
scan kernels (ops/png_kernels.unfilter_device_subup); all per-pixel
format conversion (bit expansion, palette gather, tRNS, RGBA
assembly) is one jitted device program (ops/png_kernels.assemble_rgba).

Encoder: 32-bit RGBA, filter None, zlib — enough for transcode
round-trips (the reference has no PNG encoder at all).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ffpic_tpu.formats.pic import Pic, PixelFormat
from ffpic_tpu.formats.registry import Codec, register
from ffpic_tpu.utils import trace
from ffpic_tpu.utils.checksum import crc32
from ffpic_tpu.utils.vlog import get_logger

log = get_logger("png")

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 pass geometry: (x0, y0, dx, dy)
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]

_NCH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def probe(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _unfilter_py(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Pure-Python oracle for the five filters (reference
    png.c:106-168); differential test target for the C and device
    paths."""
    out = np.zeros((height, stride), np.int32)
    raw = raw.reshape(height, stride + 1)
    for y in range(height):
        ft = raw[y, 0]
        src = raw[y, 1:].astype(np.int32)
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = src
        elif ft == 1:
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                out[y, i] = (src[i] + a) & 255
        elif ft == 2:
            out[y] = (src + prev) & 255
        elif ft == 3:
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                out[y, i] = (src[i] + ((a + prev[i]) >> 1)) & 255
        elif ft == 4:
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                b = prev[i]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                out[y, i] = (src[i] + pred) & 255
        else:
            raise ValueError(f"bad filter {ft}")
    return out.astype(np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int,
              prefer_device: bool = True) -> np.ndarray:
    if height == 0 or stride == 0:
        return np.zeros((height, stride), np.uint8)
    rows = raw.reshape(height, stride + 1)
    filters = rows[:, 0]
    if prefer_device and filters.max(initial=0) <= 2:
        import jax.numpy as jnp
        from ffpic_tpu.ops.png_kernels import unfilter_device_subup
        out = unfilter_device_subup(jnp.asarray(rows[:, 1:]),
                                    jnp.asarray(filters.astype(np.int32)),
                                    bpp=bpp)
        return np.asarray(out)
    from ffpic_tpu import native
    if native.available():
        return native.png_unfilter(raw, height, stride, bpp)
    return _unfilter_py(raw, height, stride, bpp)


def load(data: bytes, skip_decode: bool = False,
         verify_crc: bool = True) -> list[Pic]:
    if not probe(data):
        raise ValueError("not a PNG")
    pos = 8
    idat = bytearray()
    meta: dict = {"chunks": []}
    palette = np.zeros((256, 4), np.uint8)
    palette[:, 3] = 255
    trns = np.full(256, -1, np.int64)
    w = h = bitdepth = color_type = interlace = 0

    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        chunk = data[pos + 8:pos + 8 + length]
        crc = struct.unpack_from(">I", data, pos + 8 + length)[0]
        if verify_crc and crc32(data[pos + 4:pos + 8 + length]) != crc:
            raise ValueError(f"CRC mismatch in {ctype!r} chunk")
        pos += 12 + length
        name = ctype.decode("latin1")
        meta["chunks"].append(name)

        if name == "IHDR":
            w, h, bitdepth, color_type, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            meta.update(width=w, height=h, bitdepth=bitdepth,
                        color_type=color_type, interlace=interlace)
        elif name == "PLTE":
            n = length // 3
            palette[:n, :3] = np.frombuffer(chunk, np.uint8,
                                            n * 3).reshape(n, 3)
            meta["palette_size"] = n
        elif name == "tRNS":
            if color_type == 3:
                a = np.frombuffer(chunk, np.uint8)
                trns[:len(a)] = a
            elif color_type == 0:
                trns[0] = struct.unpack(">H", chunk[:2])[0]
            elif color_type == 2:
                trns[0], trns[1], trns[2] = struct.unpack(">HHH", chunk[:6])
            meta["trns"] = True
        elif name == "IDAT":
            idat += chunk
        elif name == "gAMA":
            meta["gamma"] = struct.unpack(">I", chunk)[0] / 100000
        elif name == "pHYs":
            x, y, unit = struct.unpack(">IIB", chunk)
            meta["phys"] = (x, y, unit)
        elif name == "tEXt":
            k, _, v = chunk.partition(b"\x00")
            meta.setdefault("text", {})[k.decode("latin1")] = \
                v.decode("latin1", "replace")
        elif name == "tIME":
            meta["time"] = struct.unpack(">HBBBBB", chunk)
        elif name == "sRGB":
            meta["srgb_intent"] = chunk[0] if chunk else 0
        elif name == "bKGD":
            meta["bkgd"] = chunk.hex()
        elif name == "IEND":
            break

    if skip_decode:
        return [Pic(width=w, height=h, depth=32, pitch=w * 4, codec="PNG",
                    meta=meta)]

    nch = _NCH[color_type]
    bpp = max(1, (bitdepth * nch) // 8)
    with trace.stage("png.inflate"):
        raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)

    def stride_of(width):
        return (width * nch * bitdepth + 7) // 8

    import jax.numpy as jnp
    from ffpic_tpu.ops.png_kernels import assemble_rgba

    pal_d = jnp.asarray(palette)
    trns_d = jnp.asarray(trns.astype(np.int32))

    if interlace == 0:
        with trace.stage("png.unfilter"):
            recon = _unfilter(raw, h, stride_of(w), bpp)
        # pixels STAY on device (like the JPEG path): np_pixels()
        # transfers lazily only when a host consumer asks
        rgba = assemble_rgba(jnp.asarray(recon), pal_d, trns_d,
                             color_type, bitdepth, w, h)
    else:
        # Adam7: each pass is an independently filtered sub-image
        # (reference only prints the flag, png.c:707 — no deinterlace)
        rgba = np.zeros((h, w, 4), np.uint8)
        off = 0
        for (x0, y0, dx, dy) in ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            st = stride_of(pw)
            nbytes = ph * (st + 1)
            recon = _unfilter(raw[off:off + nbytes], ph, st, bpp)
            off += nbytes
            sub = np.asarray(assemble_rgba(jnp.asarray(recon), pal_d, trns_d,
                                           color_type, bitdepth, pw, ph))
            rgba[y0::dy, x0::dx] = sub
    return [Pic(pixels=rgba, width=w, height=h, depth=32, pitch=w * 4,
                format=PixelFormat.RGBA32, codec="PNG", meta=meta)]


def info(pic: Pic) -> str:
    m = pic.meta
    ct_names = {0: "grayscale", 2: "truecolor", 3: "palette",
                4: "gray+alpha", 6: "truecolor+alpha"}
    lines = ["PNG file format",
             f"\twidth {m['width']}, height {m['height']}",
             f"\tbit depth {m['bitdepth']}, "
             f"color type {ct_names.get(m['color_type'])}",
             f"\tinterlace {'Adam7' if m.get('interlace') else 'none'}"]
    if "palette_size" in m:
        lines.append(f"\tpalette {m['palette_size']} colors"
                     + (" + tRNS" if m.get("trns") else ""))
    if "gamma" in m:
        lines.append(f"\tgAMA {m['gamma']:.5f}")
    if "text" in m:
        for k, v in m["text"].items():
            lines.append(f"\ttEXt {k}: {v[:60]}")
    lines.append(f"\tchunks: {' '.join(m['chunks'])}")
    return "\n".join(lines)


def _filter_rows(px: np.ndarray) -> np.ndarray:
    """Adaptive per-row filter selection (None/Sub/Up/Average/Paeth)
    by the minimum-sum-of-absolute-differences heuristic, fully
    vectorized.  The filters are exact inverses of _unfilter_py and
    are covered by the decode roundtrip tests."""
    h, stride = px.shape
    src = px.astype(np.int32)
    left = np.zeros_like(src)
    left[:, 4:] = src[:, :-4]                      # bpp = 4 (RGBA)
    up = np.zeros_like(src)
    up[1:] = src[:-1]
    ul = np.zeros_like(src)
    ul[1:, 4:] = src[:-1, :-4]

    p = left + up - ul
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, ul))
    cands = np.stack([src,
                      (src - left) & 255,
                      (src - up) & 255,
                      (src - ((left + up) >> 1)) & 255,
                      (src - pred) & 255])          # (5, h, stride)
    # SAD heuristic: treat filtered bytes as signed, smaller is better
    signed = np.where(cands < 128, cands, 256 - cands)
    best = signed.sum(axis=2).argmin(axis=0)        # (h,)
    rows = np.zeros((h, stride + 1), np.uint8)
    rows[:, 0] = best
    rows[:, 1:] = cands[best, np.arange(h)].astype(np.uint8)
    return rows


def encode(pic: Pic, level: int = 6, **options) -> bytes:
    rgba = pic.to_rgba32()
    h, w = rgba.shape[:2]
    rows = _filter_rows(rgba.reshape(h, -1))
    comp = zlib.compress(rows.tobytes(), level)

    def chunk(name: bytes, payload: bytes) -> bytes:
        c = crc32(name + payload)
        return struct.pack(">I", len(payload)) + name + payload + \
            struct.pack(">I", c)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", comp) +
            chunk(b"IEND", b""))


register(Codec(name="PNG", alias="APNG", probe=probe, load=load, info=info,
               encode=encode))
