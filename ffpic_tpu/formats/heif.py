"""HEIF/HEIC container codec.

Container parity with the reference's format/heif.c: ftyp brand probe
(heif.c:22-63), meta box family (iloc/iinf/ipco/ipma/iref/pitm/idat),
hvcC parameter-set extraction (heif.c:78-125), item pre-read including
idat and multi-extent items (heif.c:212-242), grid tiling
(heif.c:273-312), auxiliary alpha items, Exif items, and moov/trak
image sequences.

Pixel decode is FULL: hvc1 items run through the HEVC Main/Main-Still
slice decoder (native C syntax + recon, coding/hevc_slice.py oracle) —
single items, grids, auxiliary alpha, 8- and 10-bit (Main10), with
real deblocking and SAO (the reference stubs/disables those).
``encode`` writes HEIC (formats/heif_enc.py) — single item, grid
tiles, alpha aux; the reference has no HEIF encoder.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu.formats.pic import Pic
from ffpic_tpu.formats.registry import Codec, register
from ffpic_tpu.formats import basemedia as bm
from ffpic_tpu.formats import hevc
from ffpic_tpu.utils.vlog import get_logger

log = get_logger("heif")

BRANDS = {b"heic", b"heix", b"hevc", b"hevx", b"mif1", b"msf1", b"heim",
          b"heis", b"hevm", b"hevs"}


def probe(data: bytes) -> bool:
    if len(data) < 12 or data[4:8] != b"ftyp":
        return False
    major = data[8:12]
    if major in (b"avif", b"avis"):   # AVIF claims these (avif.py)
        return False
    if major in BRANDS:
        return True
    size = struct.unpack_from(">I", data, 0)[0]
    for off in range(16, min(size, 64), 4):
        if data[off:off + 4] in BRANDS:
            return True
    return False


def _parse_hvcc(data: bytes, box: bm.Box) -> dict:
    """hvcC: config record with parameter-set NALU arrays
    (heif.c:78-125)."""
    p = box.start
    cfg_version = data[p]
    length_size = (data[p + 21] & 3) + 1
    num_arrays = data[p + 22]
    p += 23
    nalus = {"vps": [], "sps": [], "pps": [], "sei": []}
    names = {32: "vps", 33: "sps", 34: "pps", 39: "sei", 40: "sei"}
    for _ in range(num_arrays):
        ntype = data[p] & 0x3F
        cnt = struct.unpack_from(">H", data, p + 1)[0]
        p += 3
        for _ in range(cnt):
            ln = struct.unpack_from(">H", data, p)[0]
            p += 2
            nalus.setdefault(names.get(ntype, str(ntype)), []) \
                .append(data[p:p + ln])
            p += ln
    return dict(length_size=length_size, nalus=nalus,
                version=cfg_version)


def _item_properties(data, boxes, item_id, ipma, ipco_children):
    props = {}
    for idx, _ess in ipma.get(item_id, []):
        if 1 <= idx <= len(ipco_children):
            b = ipco_children[idx - 1]
            if b.type == "ispe":
                w, h = struct.unpack_from(">II", data, b.start + 4)
                props["width"], props["height"] = w, h
            elif b.type == "hvcC":
                props["hvcC"] = _parse_hvcc(data, b)
            elif b.type == "av1C":
                props["av1C"] = data[b.start:b.start + b.size]
            elif b.type == "irot":
                props["rotation"] = (data[b.start] & 3) * 90
            elif b.type == "imir":
                # ISO 23008-12 6.5.12: axis 0 = vertical (left-right
                # flip), 1 = horizontal (top-bottom flip)
                props["mirror"] = data[b.start] & 1
            elif b.type == "colr":
                ctype = data[b.start:b.start + 4]
                props["colr"] = ctype
                if ctype == b"nclx" and b.size >= 11:
                    props["nclx"] = dict(
                        primaries=struct.unpack_from(
                            ">H", data, b.start + 4)[0],
                        transfer=struct.unpack_from(
                            ">H", data, b.start + 6)[0],
                        matrix=struct.unpack_from(
                            ">H", data, b.start + 8)[0],
                        full_range=bool(data[b.start + 10] >> 7))
            elif b.type == "pixi":
                n = data[b.start + 4]
                props["bits_per_channel"] = list(
                    data[b.start + 5:b.start + 5 + n])
            elif b.type == "auxC":
                e = data.index(b"\0", b.start + 4)
                props["aux_type"] = data[b.start + 4:e].decode(
                    "latin1", "replace")
    return props


def parse_structure(data: bytes) -> dict:
    boxes = bm.parse_boxes(data, 0, len(data))
    meta = bm.find_box(boxes, "meta")
    if meta is None:
        raise ValueError("no meta box")
    out = {"items": {}, "primary": None, "grid": None, "refs": [],
           "sequence": bool(bm.find_box(boxes, "moov"))}

    pitm = bm.find_box(meta.children, "pitm")
    if pitm:
        if pitm.version == 0:
            out["primary"] = struct.unpack_from(">H", data,
                                                pitm.start + 4)[0]
        else:
            out["primary"] = struct.unpack_from(">I", data,
                                                pitm.start + 4)[0]

    iloc = bm.find_box(meta.children, "iloc")
    iinf = bm.find_box(meta.children, "iinf")
    ipma_box = bm.find_box(meta.children, "iprp/ipma")
    ipco = bm.find_box(meta.children, "iprp/ipco")
    iref = bm.find_box(meta.children, "iref")
    idat = bm.find_box(meta.children, "idat")

    locs = bm.parse_iloc(data, iloc) if iloc else {}
    infos = bm.parse_iinf(data, iinf) if iinf else {}
    ipma = bm.parse_ipma(data, ipma_box) if ipma_box else {}
    out["refs"] = bm.parse_iref(data, iref) if iref else []

    for item_id, info in infos.items():
        item = dict(info)
        item["extents"] = locs.get(item_id, [])
        item["properties"] = _item_properties(
            data, boxes, item_id, ipma, ipco.children if ipco else [])
        out["items"][item_id] = item

    out["idat"] = (idat.start, idat.size) if idat else None
    return out


def read_item(data: bytes, structure: dict, item_id: int) -> bytes:
    """Assemble an item's bytes from its extents (file or idat
    construction, heif.c:212-242)."""
    item = structure["items"][item_id]
    blob = bytearray()
    for method, off, ln in item["extents"]:
        if method == 1:   # idat
            base = structure["idat"][0]
            blob += data[base + off:base + off + ln]
        else:
            blob += data[off:off + ln]
    return bytes(blob)


def _grid_layout(grid_bytes: bytes) -> dict:
    ver, flags, rows, cols = grid_bytes[0], grid_bytes[1], \
        grid_bytes[2] + 1, grid_bytes[3] + 1
    if flags & 1:
        w, h = struct.unpack_from(">II", grid_bytes, 4)
    else:
        w, h = struct.unpack_from(">HH", grid_bytes, 4)
    return dict(rows=rows, cols=cols, width=w, height=h)


def load(data: bytes, skip_decode: bool = False,
         mode: str = "bt601") -> list[Pic]:
    s = parse_structure(data)
    primary_id = s["primary"]
    items = s["items"]
    meta = dict(primary=primary_id,
                n_items=len(items),
                items={i: dict(type=it["type"],
                               size=sum(e[2] for e in it["extents"]),
                               **{k: v for k, v in it["properties"].items()
                                  if k != "hvcC"})
                       for i, it in items.items()},
                sequence=s["sequence"])

    primary = items.get(primary_id, {})
    props = primary.get("properties", {})
    W = props.get("width", 0)
    H = props.get("height", 0)

    tile_ids = []
    if primary.get("type") == "grid":
        grid = _grid_layout(read_item(data, s, primary_id))
        meta["grid"] = grid
        W, H = grid["width"], grid["height"]
        for rtype, frm, tos in s["refs"]:
            if rtype == "dimg" and frm == primary_id:
                tile_ids = tos
    hvcc = props.get("hvcC")
    if hvcc is None and tile_ids:
        hvcc = items[tile_ids[0]]["properties"].get("hvcC")

    if hvcc:
        sps_list = hvcc["nalus"].get("sps", [])
        if sps_list:
            sps = hevc.parse_sps(sps_list[0])
            meta["hevc"] = dict(
                profile=sps.ptl.profile_idc, level=sps.ptl.level_idc,
                bit_depth=sps.bit_depth_luma,
                chroma_format=sps.chroma_format,
                coded_size=(sps.width, sps.height),
                ctb=1 << sps.ctb_log2)
            if not W:
                W, H = sps.pic_width_cropped, sps.pic_height_cropped

    # EXIF metadata item (item_type 'Exif', cdsc-linked): payload is a
    # u32 tiff-header offset, then usually "Exif\0\0" + TIFF — reuse
    # the JPEG APP1 parser (the reference ignores Exif items entirely)
    for iid, it in items.items():
        if it.get("type") != "Exif":
            continue
        try:
            from ffpic_tpu.formats.jpg import _parse_exif
            raw = read_item(data, s, iid)
            off = struct.unpack_from(">I", raw, 0)[0]
            body = raw[4 + off:] if 4 + off < len(raw) else raw[4:]
            if body[:6] == b"Exif\x00\x00":
                body = body[6:]
            meta["exif"] = _parse_exif(body)
        except Exception:
            pass                         # malformed EXIF is non-fatal
        break

    # colr/nclx override: wild HEICs are usually BT.709 limited range;
    # only the default mode is overridden (explicit modes win)
    if mode == "bt601":
        nclx = props.get("nclx")
        if nclx is None and tile_ids:
            nclx = items[tile_ids[0]]["properties"].get("nclx")
        if nclx is not None and (nclx.get("matrix", 5) not in (5, 6)
                                 or not nclx.get("full_range", True)):
            mode = nclx

    meta.update(width=W, height=H)
    pic = Pic(width=W, height=H, depth=32, pitch=W * 4, codec="HEIF",
              meta=meta)
    if skip_decode:
        return [pic]

    # ---- pixel decode: single hvc1 item or grid of tiles ----------------
    if primary.get("type") == "grid":
        rgba = _decode_grid(data, s, tile_ids, meta["grid"], mode)
    elif primary.get("type") == "hvc1":
        rgba = _decode_item_rgba(data, s, primary_id, mode)[:H, :W]
    else:
        raise NotImplementedError(
            f"HEIF primary item type {primary.get('type')!r} "
            "(only hvc1/grid decode to pixels)")

    # auxiliary alpha plane (heif.c:347-388 blends; we fill the real
    # alpha channel instead — strictly more information)
    alpha_id = _find_alpha_item(s, primary_id, tile_ids)
    if alpha_id is not None:
        try:
            a = _decode_alpha(data, s, alpha_id, meta, tile_ids,
                              primary_id)
            if a is not None and a.shape == rgba.shape[:2]:
                rgba = rgba.copy()
                rgba[:, :, 3] = a
                meta["alpha"] = True
        except (ValueError, NotImplementedError) as e:
            log.warning("alpha aux item decode failed: %s", e)

    # irot: anti-clockwise rotation in 90-degree units (ISO 23008-12
    # 6.5.10) — the reference parses but never applies it
    rot = props.get("rotation", 0)
    if rot:
        rgba = np.ascontiguousarray(np.rot90(rgba, rot // 90))
        pic.width, pic.height = rgba.shape[1], rgba.shape[0]
        pic.pitch = pic.width * 4
        meta.update(width=pic.width, height=pic.height, rotation=rot)

    pic.pixels = rgba
    pics = [pic]
    if s["sequence"]:
        boxes = bm.parse_boxes(data, 0, len(data))
        for frame in _decode_sequence(data, boxes, mode):
            fh, fw = frame.shape[:2]
            pics.append(Pic(width=fw, height=fh, depth=32,
                            pitch=fw * 4, codec="HEIF",
                            pixels=frame, meta=dict(width=fw,
                                                    height=fh)))
    return pics


def _decode_item_yuv(data, s, item_id):
    """Decode one hvc1 item's NALUs to a reconstructed Picture
    (heif.c decode_hvc1, heif.c:244-256 -> coding/hevc.c:7194)."""
    item = s["items"][item_id]
    props = item["properties"]
    hvcc = props.get("hvcC")
    if hvcc is None:
        # tiles may share the first tile's hvcC via ipma; fall back
        raise ValueError(f"item {item_id} has no hvcC")
    sps_l = hvcc["nalus"].get("sps", [])
    pps_l = hvcc["nalus"].get("pps", [])
    if not sps_l or not pps_l:
        raise ValueError("hvcC missing SPS/PPS")
    sps = hevc.parse_sps(sps_l[0])
    pps = hevc.parse_pps(pps_l[0])
    blob = read_item(data, s, item_id)
    slices = []
    for nalu in hevc.split_nalus_length_prefixed(blob,
                                                 hvcc["length_size"]):
        t = hevc.nal_type(nalu)
        if t == hevc.NAL_SPS:
            sps = hevc.parse_sps(nalu)
        elif t == hevc.NAL_PPS:
            pps = hevc.parse_pps(nalu)
        elif (t in (hevc.NAL_IDR_W_RADL, hevc.NAL_IDR_N_LP)
              or t == hevc.NAL_CRA or 16 <= t <= 18):
            # CRA/BLA stills (the wild-iPhone norm) decode like IDR;
            # collect ALL slice segment NALUs — multi-slice pictures
            # and dependent segments decode together
            slices.append(nalu)
    if not slices:
        raise ValueError("no slice NALU in hvc1 item")
    pic = hevc.decode_picture(sps, pps, slices)
    return pic, sps, props


def _yuv_pic_to_rgba(pic, sps, out_w, out_h, mode):
    """Crop + chroma upsample + color convert.

    Host by default: HEVC stills arrive host-side (CABAC+recon) and
    the conversion is a few ms, while each new geometry costs the
    device a compile.  Set
    FFPIC_HEIF_DEVICE_COLOR=1 to route through the device kernel
    (ops/jpeg_kernels.color_convert) when feeding a device pipeline
    with stable geometries.
    """
    import os
    import numpy as np

    out_w = min(out_w or sps.pic_width_cropped, pic.planes[0].shape[1])
    out_h = min(out_h or sps.pic_height_cropped, pic.planes[0].shape[0])

    if os.environ.get("FFPIC_HEIF_DEVICE_COLOR") \
            and not isinstance(mode, dict):   # nclx path is host-only
        import jax.numpy as jnp
        from ffpic_tpu.ops.jpeg_kernels import color_convert
        yp = jnp.asarray(pic.planes[0].astype(np.int16))
        if len(pic.planes) > 1:
            up = jnp.asarray(pic.planes[1].astype(np.int16))
            vp = jnp.asarray(pic.planes[2].astype(np.int16))
            up = jnp.repeat(jnp.repeat(up, 2, 0), 2, 1)[:yp.shape[0],
                                                        :yp.shape[1]]
            vp = jnp.repeat(jnp.repeat(vp, 2, 0), 2, 1)[:yp.shape[0],
                                                        :yp.shape[1]]
        else:
            up = vp = jnp.full_like(yp, 128)
        rgba = color_convert(yp, up, vp, order="rgba", mode=mode)
        return np.asarray(rgba)[:out_h, :out_w]

    bd = pic.bd
    sc = 255.0 / ((1 << bd) - 1)      # 10-bit planes -> 8-bit RGB
    mid = float(1 << (bd - 1))
    nclx = mode if isinstance(mode, dict) else None

    if not os.environ.get("FFPIC_NO_NATIVE"):
        from ffpic_tpu import native
        if native.available():
            if nclx is not None:
                kr, kb = {1: (0.2126, 0.0722), 9: (0.2627, 0.0593),
                          10: (0.2627, 0.0593)}.get(
                    nclx.get("matrix", 5), (0.299, 0.114))
                kg = 1.0 - kr - kb
                coeffs = (2 * (1 - kr), -(2 * kb * (1 - kb) / kg),
                          -(2 * kr * (1 - kr) / kg), 2 * (1 - kb))
                limited = not nclx.get("full_range", True)
                trunc = False
            elif mode == "reference":
                coeffs = (1.280, -0.215, -0.381, 2.128)
                limited, trunc = False, True
            else:
                coeffs = (1.402, -0.344136, -0.714136, 1.772)
                limited, trunc = False, False
            rgba = native.hevc_color(pic.planes, bd, coeffs, limited,
                                     trunc)
            return rgba[:out_h, :out_w]
    yy = pic.planes[0].astype(np.float32) * sc
    if len(pic.planes) > 1:
        uu = np.repeat(np.repeat(pic.planes[1], 2, 0), 2, 1)
        vv = np.repeat(np.repeat(pic.planes[2], 2, 0), 2, 1)
        uu = (uu[:yy.shape[0], :yy.shape[1]].astype(np.float32)
              - mid) * sc
        vv = (vv[:yy.shape[0], :yy.shape[1]].astype(np.float32)
              - mid) * sc
    else:
        uu = vv = np.zeros_like(yy)
    if nclx is not None:
        # honor the colr/nclx box (wild HEICs are typically BT.709 or
        # BT.2020 limited range; the reference ignores colr entirely)
        kr, kb = {1: (0.2126, 0.0722),    # BT.709
                  9: (0.2627, 0.0593),    # BT.2020 NCL
                  10: (0.2627, 0.0593),   # BT.2020 CL (approx as NCL)
                  }.get(nclx.get("matrix", 5), (0.299, 0.114))
        if not nclx.get("full_range", True):
            yy = (yy - 16.0) * (255.0 / 219.0)
            uu = uu * (255.0 / 224.0)
            vv = vv * (255.0 / 224.0)
        kg = 1.0 - kr - kb
        r = np.floor(yy + 2 * (1 - kr) * vv + 0.5)
        b = np.floor(yy + 2 * (1 - kb) * uu + 0.5)
        g = np.floor(yy - (2 * kb * (1 - kb) / kg) * uu
                     - (2 * kr * (1 - kr) / kg) * vv + 0.5)
    elif mode == "reference":
        r = np.trunc(yy + 1.280 * vv)
        g = np.trunc(yy - 0.215 * uu - 0.381 * vv)
        b = np.trunc(yy + 2.128 * uu)
    else:  # bt601 round-half-up, same formulas as the device kernel
        r = np.floor(yy + 1.402 * vv + 0.5)
        g = np.floor(yy - 0.344136 * uu - 0.714136 * vv + 0.5)
        b = np.floor(yy + 1.772 * uu + 0.5)
    rgba = np.stack([np.clip(r, 0, 255), np.clip(g, 0, 255),
                     np.clip(b, 0, 255),
                     np.full_like(yy, 255)], axis=-1).astype(np.uint8)
    return rgba[:out_h, :out_w]


def _decode_item_rgba(data, s, item_id, mode):
    pic, sps, props = _decode_item_yuv(data, s, item_id)
    return _yuv_pic_to_rgba(pic, sps, props.get("width"),
                            props.get("height"), mode)


def _grid_workers(n_tiles: int) -> int:
    """Host-parallelism over grid tiles (SURVEY §2.6(a)): each tile is
    an independent entropy+recon unit, and the native decode path
    releases the GIL across its ctypes calls, so tiles scale across
    host cores.  Defaults to the core count (serial on this image's
    1-vCPU hosts, where thread overhead is a measured loss);
    FFPIC_THREADS overrides."""
    import os
    env = os.environ.get("FFPIC_THREADS")
    if env:
        return max(1, min(int(env), n_tiles))
    return max(1, min(os.cpu_count() or 1, n_tiles))


def _decode_grid(data, s, tile_ids, grid, mode):
    """Grid image: decode every dimg tile and paste row-major
    (heif.c:273-312).  Each tile is an independent batch element —
    the natural device batching seam (and the host-thread split point)."""
    import numpy as np
    W, H = grid["width"], grid["height"]
    rows, cols = grid["rows"], grid["cols"]
    canvas = np.zeros((H, W, 4), np.uint8)
    canvas[:, :, 3] = 255

    nw = _grid_workers(len(tile_ids))
    if nw > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nw) as ex:
            tiles = list(ex.map(
                lambda tid: _decode_item_rgba(data, s, tid, mode),
                tile_ids))
    else:
        tiles = [_decode_item_rgba(data, s, tid, mode)
                 for tid in tile_ids]

    for idx, tile in enumerate(tiles):
        r, c = divmod(idx, cols)
        th, tw = tile.shape[:2]
        y0, x0 = r * th, c * tw
        if y0 >= H or x0 >= W:
            continue
        canvas[y0:y0 + th, x0:x0 + tw] = tile[:H - y0, :W - x0]
    return canvas


def _find_alpha_item(s, primary_id, tile_ids):
    """auxl reference onto the primary (or its tiles) whose auxC urn
    mentions alpha."""
    targets = {primary_id, *tile_ids}
    for rtype, frm, tos in s["refs"]:
        if rtype == "auxl" and (primary_id in tos
                                or any(t in targets for t in tos)):
            it = s["items"].get(frm, {})
            aux = it.get("properties", {}).get("aux_type", "")
            # "urn:mpeg:hevc:2015:auxid:1" (ISO 23008-12) is the alpha
            # aux type; libheif also writes urns containing "alpha"
            if "alpha" in aux.lower() or aux.rstrip("\x00").endswith(
                    "auxid:1"):
                return frm
    return None


def _decode_alpha(data, s, alpha_id, meta, tile_ids, primary_id):
    """Aux alpha image: mono or 4:2:0 luma; may itself be a grid."""
    import numpy as np
    item = s["items"][alpha_id]
    if item.get("type") == "grid":
        grid = _grid_layout(read_item(data, s, alpha_id))
        a_tiles = []
        for rtype, frm, tos in s["refs"]:
            if rtype == "dimg" and frm == alpha_id:
                a_tiles = tos
        W, H = grid["width"], grid["height"]
        canvas = np.zeros((H, W), np.uint8)
        for idx, tid in enumerate(a_tiles):
            r, c = divmod(idx, grid["cols"])
            pic, sps, props = _decode_item_yuv(data, s, tid)
            t = np.clip(pic.planes[0], 0, 255).astype(np.uint8)
            th = min(props.get("height") or sps.pic_height_cropped,
                     t.shape[0])
            tw = min(props.get("width") or sps.pic_width_cropped,
                     t.shape[1])
            y0, x0 = r * th, c * tw
            if y0 < H and x0 < W:
                canvas[y0:y0 + th, x0:x0 + tw] = \
                    t[:min(th, H - y0), :min(tw, W - x0)]
        return canvas
    pic, sps, props = _decode_item_yuv(data, s, alpha_id)
    a = np.clip(pic.planes[0], 0, 255).astype(np.uint8)
    h = min(props.get("height") or sps.pic_height_cropped, a.shape[0])
    w = min(props.get("width") or sps.pic_width_cropped, a.shape[1])
    return a[:h, :w]


def info(pic: Pic) -> str:
    m = pic.meta
    lines = ["HEIF file format",
             f"\twidth {m['width']}, height {m['height']}",
             f"\tprimary item {m['primary']}, {m['n_items']} items"]
    if m.get("grid"):
        g = m["grid"]
        lines.append(f"\tgrid {g['rows']}x{g['cols']} tiles")
    if m.get("hevc"):
        h = m["hevc"]
        lines.append(f"\tHEVC profile {h['profile']} level {h['level']} "
                     f"{h['bit_depth']}-bit chroma {h['chroma_format']} "
                     f"CTB {h['ctb']}")
    for i, it in m["items"].items():
        lines.append(f"\titem {i}: {it['type']} {it.get('width', '')}"
                     f"x{it.get('height', '')} ({it['size']} bytes)")
    return "\n".join(lines)


def encode(pic: Pic, **options) -> bytes:
    from ffpic_tpu.formats.heif_enc import encode_heif
    return encode_heif(pic, **options)


register(Codec(name="HEIF", alias="HEIC", probe=probe, load=load,
               info=info, encode=encode))


# ---------------------------------------------------------------------------
# image sequences (moov/trak, heif.c:431-462)
# ---------------------------------------------------------------------------

def _decode_sequence(data: bytes, boxes, mode: str) -> list:
    """Decode hvc1 track samples to frames.  Like the reference, only
    intra (IDR) samples decode; non-IDR samples are skipped (intra-only
    framework — the reference's decoder is intra-only too)."""
    import numpy as np
    moov = bm.find_box(boxes, "moov")
    if moov is None:
        return []
    frames = []
    for trak in [b for b in moov.children if b.type == "trak"]:
        stbl = bm.find_box(trak.children, "mdia/minf/stbl")
        if stbl is None:
            continue
        stsd = bm.find_box(stbl.children, "stsd")
        stsz = bm.find_box(stbl.children, "stsz")
        stco = bm.find_box(stbl.children, "stco")
        stsc = bm.find_box(stbl.children, "stsc")
        if not (stsd and stsz and stco and stsc):
            continue
        # stsd -> first hvc1 visual sample entry -> hvcC child box
        p = stsd.start + 8
        entry_size, entry_type = struct.unpack_from(">I4s", data, p)
        if entry_type != b"hvc1":
            continue
        hvcc_pos = p + 86
        hb = bm.parse_boxes(data, hvcc_pos, p + entry_size)
        hvcc_box = bm.find_box(hb, "hvcC")
        if hvcc_box is None:
            continue
        hvcc = _parse_hvcc(data, hvcc_box)
        sps_l = hvcc["nalus"].get("sps", [])
        pps_l = hvcc["nalus"].get("pps", [])
        if not sps_l or not pps_l:
            continue
        sps = hevc.parse_sps(sps_l[0])
        pps = hevc.parse_pps(pps_l[0])
        # sample sizes
        v = struct.unpack_from(">I", data, stsz.start)[0] & 0xFFFFFF
        uniform = struct.unpack_from(">I", data, stsz.start + 4)[0]
        n_samples = struct.unpack_from(">I", data, stsz.start + 8)[0]
        if uniform:
            sizes = [uniform] * n_samples
        else:
            sizes = list(struct.unpack_from(f">{n_samples}I", data,
                                            stsz.start + 12))
        n_chunks = struct.unpack_from(">I", data, stco.start + 4)[0]
        chunk_off = struct.unpack_from(f">{n_chunks}I", data,
                                       stco.start + 8)
        n_stsc = struct.unpack_from(">I", data, stsc.start + 4)[0]
        stsc_e = [struct.unpack_from(">III", data, stsc.start + 8
                                     + 12 * k) for k in range(n_stsc)]
        # expand samples-per-chunk runs
        spc = []
        for k in range(n_chunks):
            cur = 1
            for first, per, _desc in stsc_e:
                if first <= k + 1:
                    cur = per
            spc.append(cur)
        # full sequence decode (I/P/B) through the DPB-backed
        # SequenceDecoder — P/B samples motion-compensate for real
        # (beyond the reference, which has no inter pixel path)
        seq = hevc.SequenceDecoder()
        seq.sps[sps.sps_id] = sps
        seq.pps[pps.pps_id] = pps
        decoded = []                   # (poc, Picture) decode order
        si = 0
        for ci in range(n_chunks):
            off = chunk_off[ci]
            for _ in range(spc[ci]):
                if si >= n_samples:
                    break
                blob = data[off:off + sizes[si]]
                off += sizes[si]
                si += 1
                try:
                    for nalu in hevc.split_nalus_length_prefixed(
                            blob, hvcc["length_size"]):
                        pic = seq.push(nalu)
                        if pic is not None:
                            decoded.append(pic)
                except (ValueError, NotImplementedError) as e:
                    log.warning("sequence sample %d skipped: %s",
                                si, e)
        try:
            pic = seq.flush()
            if pic is not None:
                decoded.append(pic)
        except (ValueError, NotImplementedError) as e:
            log.warning("sequence flush failed: %s", e)
        # presentation order: reorder by POC within each IDR group
        groups = []
        for pic in decoded:
            if pic.poc == 0 or not groups:
                groups.append([])
            groups[-1].append(pic)
        for g in groups:
            for pic in sorted(g, key=lambda q: q.poc):
                frames.append(_yuv_pic_to_rgba(pic, pic.sps, None,
                                               None, mode))
    return frames
