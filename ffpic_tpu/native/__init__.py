"""Native host-kernel module: builds and loads the C entropy decoders.

The C sources compile on first use into a cached shared library (no
external deps, plain cc -O3). ``available()`` gates the fast path;
every caller has a pure-Python fallback so the framework works even
without a toolchain. Set FFPIC_NO_NATIVE=1 to force the fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["host_jpeg.c", "host_png.c", "host_vp8.c", "host_hevc.c", "host_lzw.c", "host_vp8l.c", "host_jp2.c", "host_av1.c", "host_av1_itx.c"]
_lib = None
_tried = False


def _cpu_id() -> str:
    """What -march=native compiles for: the host CPU's model and
    feature flags (one copy of each distinct /proc/cpuinfo line)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine() + " " + platform.processor()
    keys = ("model name", "flags", "Features", "CPU implementer",
            "CPU part")
    return "\n".join(sorted({ln for ln in lines if ln.startswith(keys)}))


def _so_path(srcs: list[str], flags: list[str], cpu: str) -> str:
    """Cached library path, keyed by the sources, the compiler command
    and the host CPU, so a library built on another machine (a copied
    build/ directory) is never loaded here."""
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update(cpu.encode())
    return os.path.join(_DIR, "build",
                        f"libffpic_host_{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES
            if os.path.exists(os.path.join(_DIR, s))]
    if not srcs:
        return None
    cc = os.environ.get("CC", "cc")
    flags = [cc, "-O3", "-march=native", "-fPIC", "-shared",
             "-fvisibility=hidden"]
    so = _so_path(srcs, flags, _cpu_id())
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    cmd = flags + ["-o", so] + srcs
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        err = getattr(e, "stderr", b"")
        raise RuntimeError(f"native build failed: {err!r}") from e
    return so


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("FFPIC_NO_NATIVE"):
        return None
    try:
        so = os.environ.get("FFPIC_NATIVE_SO") or _build()
        if so is None:
            return None
        _lib = ctypes.CDLL(so)
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def jpeg_decode_scan(scan: bytes, dht: dict, frame_comps, scan_comps,
                     ss: int, se: int, ah: int, al: int,
                     restart_interval: int, mcus_x: int, mcus_y: int,
                     planes: list[np.ndarray]) -> None:
    """Decode one scan into raster-order coefficient planes.

    dht: {(class, id): (counts, symbols)}.
    planes: per-frame-component (nby, nbx, 64) int16 arrays in natural
    raster order (modified in place).
    """
    lib = _load()
    assert lib is not None

    counts = np.zeros((8, 16), np.uint8)
    syms = np.zeros((8, 256), np.uint8)
    present = np.zeros(8, np.int32)
    for (tc, th), (cnt, sy) in dht.items():
        if th > 3:
            raise ValueError("huffman table id > 3")
        slot = tc * 4 + th
        counts[slot, :] = cnt
        syms[slot, :len(sy)] = sy
        present[slot] = 1

    ncomps = len(frame_comps)
    ch = np.array([c.h for c in frame_comps], np.int32)
    cv = np.array([c.v for c in frame_comps], np.int32)
    nbx = np.array([c.nbx for c in frame_comps], np.int32)
    nby = np.array([c.nby for c in frame_comps], np.int32)
    nbxa = np.array([c.nbx_actual for c in frame_comps], np.int32)
    nbya = np.array([c.nby_actual for c in frame_comps], np.int32)

    ns = len(scan_comps)
    sc_comp = np.array([s.comp_idx for s in scan_comps], np.int32)
    sc_dc = np.array([s.dc_tbl for s in scan_comps], np.int32)
    sc_ac = np.array([s.ac_tbl for s in scan_comps], np.int32)

    PlaneArr = ctypes.c_void_p * ncomps
    plane_ptrs = PlaneArr(*[p.ctypes.data_as(ctypes.c_void_p).value
                            for p in planes])
    for p in planes:
        assert p.dtype == np.int16 and p.flags["C_CONTIGUOUS"]

    scan_buf = np.frombuffer(scan, np.uint8)
    fn = lib.ffpic_jpeg_decode_scan
    fn.restype = ctypes.c_int
    rc = fn(
        scan_buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(scan)),
        counts.ctypes.data_as(ctypes.c_void_p),
        syms.ctypes.data_as(ctypes.c_void_p),
        present.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(ncomps),
        ch.ctypes.data_as(ctypes.c_void_p), cv.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(mcus_x), ctypes.c_int(mcus_y),
        nbx.ctypes.data_as(ctypes.c_void_p), nby.ctypes.data_as(ctypes.c_void_p),
        nbxa.ctypes.data_as(ctypes.c_void_p), nbya.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(ns),
        sc_comp.ctypes.data_as(ctypes.c_void_p),
        sc_dc.ctypes.data_as(ctypes.c_void_p),
        sc_ac.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(ss), ctypes.c_int(se), ctypes.c_int(ah), ctypes.c_int(al),
        ctypes.c_int(restart_interval),
        plane_ptrs,
    )
    if rc != 0:
        raise ValueError(f"native jpeg scan decode failed rc={rc}")


import threading as _threading
_packed_tls = _threading.local()    # per-thread scratch: the packed
# emission returns views into it, and decode_batch may parse from a
# host worker pool


def jpeg_decode_scan_packed(scan: bytes, dht: dict, frame_comps,
                            scan_comps, restart_interval: int,
                            mcus_x: int, mcus_y: int):
    """Packed-emission decode of ONE interleaved baseline scan.

    Returns (counts uint8[G], ks uint8[N], vals int16[N]) in MCU decode
    order — see host_jpeg.c ffpic_jpeg_decode_scan_packed.  The static
    block-order -> plane-flat-index map comes from
    ffpic_tpu.ops.jpeg_kernels.mcu_block_map (pure geometry).
    """
    lib = _load()
    assert lib is not None
    counts = np.zeros((8, 16), np.uint8)
    syms = np.zeros((8, 256), np.uint8)
    present = np.zeros(8, np.int32)
    for (tc, th), (cnt, sy) in dht.items():
        if th > 3:
            raise ValueError("huffman table id > 3")
        slot = tc * 4 + th
        counts[slot, :] = cnt
        syms[slot, :len(sy)] = sy
        present[slot] = 1
    ncomps = len(frame_comps)
    ch = np.array([c.h for c in frame_comps], np.int32)
    cv = np.array([c.v for c in frame_comps], np.int32)
    nbxa = np.array([c.nbx_actual for c in frame_comps], np.int32)
    nbya = np.array([c.nby_actual for c in frame_comps], np.int32)
    ns = len(scan_comps)
    sc_comp = np.array([s.comp_idx for s in scan_comps], np.int32)
    sc_dc = np.array([s.dc_tbl for s in scan_comps], np.int32)
    sc_ac = np.array([s.ac_tbl for s in scan_comps], np.int32)
    if ns > 1:
        blocks_per_mcu = int(sum(c.h * c.v for c in frame_comps))
        G = mcus_x * mcus_y * blocks_per_mcu
    else:
        c0 = frame_comps[scan_comps[0].comp_idx]
        G = c0.nbx_actual * c0.nby_actual
    cap = G * 64
    # reused scratch: fresh multi-MB allocations per frame cause
    # page-fault/madvise churn that costs more than the decode itself
    # on this host.  The returned arrays are views — each call
    # invalidates the previous call's result (callers stage to device
    # or copy immediately).
    sc = getattr(_packed_tls, "sc", None)
    if sc is None:
        sc = _packed_tls.sc = {}
    if sc.get("cap", 0) < cap:
        sc["counts"] = np.empty(cap // 64, np.uint8)
        sc["ks"] = np.empty(cap, np.uint8)
        sc["vals"] = np.empty(cap, np.int16)
        sc["cap"] = cap
    out_counts = sc["counts"][:G]
    out_ks = sc["ks"]
    out_vals = sc["vals"]
    scan_buf = np.frombuffer(scan, np.uint8)
    fn = lib.ffpic_jpeg_decode_scan_packed
    fn.restype = ctypes.c_long
    n = fn(scan_buf.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_long(len(scan)),
           counts.ctypes.data_as(ctypes.c_void_p),
           syms.ctypes.data_as(ctypes.c_void_p),
           present.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int(ncomps),
           ch.ctypes.data_as(ctypes.c_void_p),
           cv.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int(mcus_x), ctypes.c_int(mcus_y),
           nbxa.ctypes.data_as(ctypes.c_void_p),
           nbya.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int(ns),
           sc_comp.ctypes.data_as(ctypes.c_void_p),
           sc_dc.ctypes.data_as(ctypes.c_void_p),
           sc_ac.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int(restart_interval),
           out_counts.ctypes.data_as(ctypes.c_void_p),
           out_ks.ctypes.data_as(ctypes.c_void_p),
           out_vals.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        raise ValueError(f"native packed jpeg scan decode failed rc={n}")
    # pad to a power-of-two bucket for stable jit shapes: the tail is
    # zeroed in place (zigzag pos 0 / value 0 scatter-adds nothing), no
    # reallocation or copy of the payload
    cap2 = 2048
    while cap2 < n:
        cap2 <<= 1
    cap2 = min(cap2, cap)
    out_ks[n:cap2] = 0
    out_vals[n:cap2] = 0
    return out_counts, out_ks[:cap2], out_vals[:cap2], int(n)


def jpeg_destuff(scan: bytes):
    """Destuff the entropy stream (0xFF00 -> 0xFF, split at RSTn).
    Returns (bytes_array uint8, seg_bounds int64[n_segs+1])."""
    lib = _load()
    assert lib is not None
    n = len(scan)
    out = np.empty(max(n, 1), np.uint8)
    bounds = np.zeros(65537, np.int64)
    out_len = ctypes.c_long(0)
    fn = lib.ffpic_jpeg_destuff
    fn.restype = ctypes.c_int
    n_segs = fn(scan, ctypes.c_long(n),
                out.ctypes.data_as(ctypes.c_void_p),
                bounds.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(out_len))
    if n_segs < 0:
        raise ValueError(f"destuff failed ({n_segs})")
    return out[:out_len.value], bounds[:n_segs + 1].copy()


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Reconstruct PNG scanlines. raw: height*(stride+1) bytes of
    filter-tagged rows; returns (height, stride) uint8."""
    lib = _load()
    assert lib is not None
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(height * stride, np.uint8)
    fn = lib.ffpic_png_unfilter
    fn.restype = ctypes.c_int
    rc = fn(raw.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(height), ctypes.c_long(stride), ctypes.c_int(bpp))
    if rc != 0:
        raise ValueError("invalid PNG filter type")
    return out.reshape(height, stride)


def pack_nonzero(plane: np.ndarray):
    """Pack nonzero coefficients of an int16 array into
    (flat_idx int32[], val int16[]) — cuts host->device bytes ~3x for
    typical baseline scans (85-90% zeros).  Returns (idx, val)."""
    lib = _load()
    assert lib is not None
    flat = np.ascontiguousarray(plane.reshape(-1), np.int16)
    n = flat.size
    idx = np.empty(n, np.int32)
    val = np.empty(n, np.int16)
    fn = lib.ffpic_pack_nonzero
    fn.restype = ctypes.c_long
    nnz = fn(flat.ctypes.data_as(ctypes.c_void_p),
             ctypes.c_long(n),
             idx.ctypes.data_as(ctypes.c_void_p),
             val.ctypes.data_as(ctypes.c_void_p))
    return idx[:nnz], val[:nnz]


def vp8_loop_filter(Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                    levels: np.ndarray, inner: np.ndarray,
                    simple: bool, sharpness: int) -> None:
    """In-place VP8 loop filter over whole planes (host_vp8.c)."""
    lib = _load()
    assert lib is not None
    mbh, mbw = levels.shape
    fn = lib.ffpic_vp8_loop_filter
    fn.restype = None
    fn(Y.ctypes.data_as(ctypes.c_void_p),
       U.ctypes.data_as(ctypes.c_void_p),
       V.ctypes.data_as(ctypes.c_void_p),
       ctypes.c_int(mbh), ctypes.c_int(mbw),
       np.ascontiguousarray(levels, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(inner, np.uint8).ctypes
         .data_as(ctypes.c_void_p),
       ctypes.c_int(1 if simple else 0), ctypes.c_int(sharpness))


def vp8_tokens(rest: bytes, part_off, part_len, probs: np.ndarray,
               skip: np.ndarray, has_y2: np.ndarray,
               mbh: int, mbw: int):
    """Native VP8 token-partition decode (host_vp8.c).  Returns
    (levels (mbh,mbw,25,16) int32, nnz_total (mbh,mbw,25) int32)."""
    lib = _load()
    assert lib is not None
    levels = np.zeros((mbh, mbw, 25, 16), np.int32)
    nnz = np.zeros((mbh, mbw, 25), np.int32)
    rest_b = np.frombuffer(rest, np.uint8)
    off = np.ascontiguousarray(part_off, np.int64)
    ln = np.ascontiguousarray(part_len, np.int64)
    fn = lib.ffpic_vp8_tokens
    fn.restype = ctypes.c_int
    rc = fn(rest_b.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(len(rest)),
            off.ctypes.data_as(ctypes.c_void_p),
            ln.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(len(off)),
            np.ascontiguousarray(probs, np.uint8).ctypes
              .data_as(ctypes.c_void_p),
            np.ascontiguousarray(skip, np.uint8).ctypes
              .data_as(ctypes.c_void_p),
            np.ascontiguousarray(has_y2, np.uint8).ctypes
              .data_as(ctypes.c_void_p),
            ctypes.c_int(mbh), ctypes.c_int(mbw),
            levels.ctypes.data_as(ctypes.c_void_p),
            nnz.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"vp8 token decode failed ({rc})")
    return levels, nnz


def vp8_residuals(levels: np.ndarray, nnz: np.ndarray, dq: np.ndarray,
                  seg, has_y2: np.ndarray, mbh: int, mbw: int) -> np.ndarray:
    """Native dequant + Y2 IWHT + 4x4 IDCT over the whole image with
    zero/DC-only block fast paths (host_vp8.c).  Returns
    (mbh, mbw, 24, 4, 4) int16 residuals."""
    lib = _load()
    assert lib is not None
    out = np.empty((mbh, mbw, 24, 4, 4), np.int16)
    fn = lib.ffpic_vp8_residuals
    fn.restype = None
    seg_ptr = (np.ascontiguousarray(seg, np.int32).ctypes
               .data_as(ctypes.c_void_p) if seg is not None else None)
    fn(np.ascontiguousarray(levels, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(nnz, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(dq, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       seg_ptr,
       np.ascontiguousarray(has_y2, np.uint8).ctypes
         .data_as(ctypes.c_void_p),
       ctypes.c_int(mbh), ctypes.c_int(mbw),
       out.ctypes.data_as(ctypes.c_void_p))
    return out


def vp8_coeff_probs(part0: bytes, br, update_probs: np.ndarray,
                    probs: np.ndarray) -> None:
    """Native RFC 6386 §13.4 coefficient-probability update parse;
    resumes the Python BoolDecoder ``br`` in place and updates
    ``probs`` (4,8,3,11) in place."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(part0, np.uint8)
    pos = ctypes.c_long(br.pos)
    value = ctypes.c_uint32(br.value)
    rng = ctypes.c_uint32(br.range)
    bc = ctypes.c_int(br.bit_count)
    fn = lib.ffpic_vp8_coeff_probs
    fn.restype = None
    assert probs.dtype == np.uint8 and probs.flags.c_contiguous
    fn(buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(part0)),
       ctypes.byref(pos), ctypes.byref(value), ctypes.byref(rng),
       ctypes.byref(bc),
       np.ascontiguousarray(update_probs, np.uint8).ctypes
         .data_as(ctypes.c_void_p),
       probs.ctypes.data_as(ctypes.c_void_p))
    br.pos, br.value, br.range, br.bit_count = (
        pos.value, value.value, rng.value, bc.value)


def vp8_recon_fused(Y, U, V, levels, nnz, dq, seg, has_y2,
                    ymode, bmodes, uvmode, mbh: int, mbw: int) -> None:
    """Fused native residual transform + intra recon (host_vp8.c):
    one MB walk, no whole-image residual intermediate."""
    lib = _load()
    assert lib is not None
    fn = lib.ffpic_vp8_recon_fused
    fn.restype = None
    seg_ptr = (np.ascontiguousarray(seg, np.int32).ctypes
               .data_as(ctypes.c_void_p) if seg is not None else None)
    fn(Y.ctypes.data_as(ctypes.c_void_p),
       U.ctypes.data_as(ctypes.c_void_p),
       V.ctypes.data_as(ctypes.c_void_p),
       np.ascontiguousarray(levels, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(nnz, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(dq, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       seg_ptr,
       np.ascontiguousarray(has_y2, np.uint8).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(ymode, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(bmodes, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(uvmode, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       ctypes.c_int(mbh), ctypes.c_int(mbw))


def vp8_recon(Y, U, V, residual, ymode, bmodes, uvmode,
              mbh: int, mbw: int) -> None:
    """Native intra prediction + residual add (host_vp8.c), writing
    the planes in place."""
    lib = _load()
    assert lib is not None
    fn = lib.ffpic_vp8_recon
    fn.restype = None
    fn(Y.ctypes.data_as(ctypes.c_void_p),
       U.ctypes.data_as(ctypes.c_void_p),
       V.ctypes.data_as(ctypes.c_void_p),
       np.ascontiguousarray(residual, np.int16).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(ymode, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(bmodes, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       np.ascontiguousarray(uvmode, np.int32).ctypes
         .data_as(ctypes.c_void_p),
       ctypes.c_int(mbh), ctypes.c_int(mbw))


def hevc_decode_slice(data: bytes, params, init_state: np.ndarray,
                      init_mps: np.ndarray):
    """Native HEVC I-slice syntax decode (host_hevc.c).  Returns
    (ops (n,6) int32, tu_meta (m,8) int32, levels int16 packed,
    sao (ctbs,21) int32, ct_depth, luma_mode, qp_map int8 maps,
    bypass_map uint8)."""
    lib = _load()
    assert lib is not None
    w, h, ctb_log2 = params[0], params[1], params[2]
    mw, mh = (w + 3) // 4, (h + 3) // 4
    ctbs = (((w + (1 << ctb_log2) - 1) >> ctb_log2)
            * ((h + (1 << ctb_log2) - 1) >> ctb_log2))
    n44 = mw * mh
    # np.empty: the C side fully initializes every entry it reports
    # (levels are memset per TU, maps are memset at entry) — zeroing
    # ~4 MB per 512^2 tile here was ~20% of the syntax-pass wall time
    ops = np.empty((3 * n44 + 64, 6), np.int32)
    tu_meta = np.empty((3 * n44 + 64, 8), np.int32)
    levels = np.empty(2 * w * h + 4096, np.int16)
    sao = np.zeros((ctbs, 21), np.int32)     # zeros: sparse writes
    ct_depth = np.empty(n44, np.int8)
    luma_mode = np.empty(n44, np.int8)
    qp_map = np.empty(n44, np.int8)
    bypass_map = np.empty(n44, np.uint8)
    n_tus = np.zeros(1, np.int64)
    buf = np.frombuffer(data, np.uint8)
    prm = np.ascontiguousarray(params, np.int32)
    fn = lib.ffpic_hevc_decode_slice
    fn.restype = ctypes.c_long
    n_ops = fn(buf.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(data)),
               prm.ctypes.data_as(ctypes.c_void_p),
               np.ascontiguousarray(init_state, np.uint8).ctypes
                 .data_as(ctypes.c_void_p),
               np.ascontiguousarray(init_mps, np.uint8).ctypes
                 .data_as(ctypes.c_void_p),
               ops.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(ops)),
               tu_meta.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(tu_meta)),
               levels.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(levels)),
               sao.ctypes.data_as(ctypes.c_void_p),
               ct_depth.ctypes.data_as(ctypes.c_void_p),
               luma_mode.ctypes.data_as(ctypes.c_void_p),
               qp_map.ctypes.data_as(ctypes.c_void_p),
               bypass_map.ctypes.data_as(ctypes.c_void_p),
               n_tus.ctypes.data_as(ctypes.c_void_p))
    if n_ops < 0:
        raise ValueError(f"hevc native slice decode failed ({n_ops})")
    m = int(n_tus[0])
    return (ops[:n_ops], tu_meta[:m], levels, sao,
            ct_depth.reshape(mh, mw), luma_mode.reshape(mh, mw),
            qp_map.reshape(mh, mw), bypass_map.reshape(mh, mw))


def hevc_picture_state(w: int, h: int, ctb_log2: int, layout) -> dict:
    """Persistent per-picture buffers for multi-segment native decode
    (ffpic_hevc_decode_segment): syntax maps, availability zones, WPP
    context snapshot, tile-scan address maps."""
    mw, mh = (w + 3) // 4, (h + 3) // 4
    ctbs = (((w + (1 << ctb_log2) - 1) >> ctb_log2)
            * ((h + (1 << ctb_log2) - 1) >> ctb_log2))
    ident = layout is None or not getattr(layout, "n_tiles", 1) > 1
    return dict(
        mw=mw, mh=mh, ctbs=ctbs,
        zone=np.full(mw * mh, -1, np.int32),
        slice_of=np.full(ctbs, -1, np.int32),
        ct_depth=np.full(mw * mh, -1, np.int8),
        luma_mode=np.full(mw * mh, -1, np.int8),
        qp_map=np.zeros(mw * mh, np.int8),
        bypass_map=np.zeros(mw * mh, np.uint8),
        sao=np.zeros((ctbs, 21), np.int32),
        wpp_sm=np.zeros(137, np.uint8),
        wpp_meta=np.zeros(2, np.int32),
        ts_to_rs=(None if ident
                  else np.ascontiguousarray(layout.ts_to_rs)),
        rs_to_ts=(None if ident
                  else np.ascontiguousarray(layout.rs_to_ts)),
        tile_of=(None if ident
                 else np.ascontiguousarray(layout.tile_of_rs)),
    )


def hevc_decode_segment(data: bytes, params, segp, sub_bounds,
                        state: dict, sm_fresh: np.ndarray,
                        sm_io: np.ndarray):
    """Decode one slice segment (native); returns (ops, tu_meta,
    levels) — maps/sao/zone accumulate in `state`, contexts carry in
    sm_io."""
    lib = _load()
    assert lib is not None
    w, h = params[0], params[1]
    n44 = state["mw"] * state["mh"]
    ops = np.empty((3 * n44 + 64, 6), np.int32)
    tu_meta = np.empty((3 * n44 + 64, 8), np.int32)
    levels = np.empty(2 * w * h + 4096, np.int16)
    n_tus = np.zeros(1, np.int64)
    buf = np.frombuffer(data, np.uint8)
    prm = np.ascontiguousarray(params, np.int32)
    sg = np.ascontiguousarray(segp, np.int32)
    sb = np.ascontiguousarray(sub_bounds, np.int32)

    def ptr(a):
        return (a.ctypes.data_as(ctypes.c_void_p) if a is not None
                else None)
    fn = lib.ffpic_hevc_decode_segment
    fn.restype = ctypes.c_long
    n_ops = fn(buf.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(data)),
               prm.ctypes.data_as(ctypes.c_void_p),
               sg.ctypes.data_as(ctypes.c_void_p),
               sb.ctypes.data_as(ctypes.c_void_p),
               ptr(state["ts_to_rs"]), ptr(state["rs_to_ts"]),
               ptr(state["tile_of"]),
               state["slice_of"].ctypes.data_as(ctypes.c_void_p),
               np.ascontiguousarray(sm_fresh, np.uint8).ctypes
                 .data_as(ctypes.c_void_p),
               sm_io.ctypes.data_as(ctypes.c_void_p),
               state["wpp_sm"].ctypes.data_as(ctypes.c_void_p),
               state["wpp_meta"].ctypes.data_as(ctypes.c_void_p),
               state["zone"].ctypes.data_as(ctypes.c_void_p),
               ops.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(ops)),
               tu_meta.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(tu_meta)),
               levels.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_long(len(levels)),
               state["sao"].ctypes.data_as(ctypes.c_void_p),
               state["ct_depth"].ctypes.data_as(ctypes.c_void_p),
               state["luma_mode"].ctypes.data_as(ctypes.c_void_p),
               state["qp_map"].ctypes.data_as(ctypes.c_void_p),
               state["bypass_map"].ctypes.data_as(ctypes.c_void_p),
               n_tus.ctypes.data_as(ctypes.c_void_p))
    if n_ops < 0:
        raise ValueError(f"hevc native segment decode failed ({n_ops})")
    m = int(n_tus[0])
    nlv = int((tu_meta[:m, 2].astype(np.int64) ** 2).sum()) if m else 0
    return ops[:n_ops].copy(), tu_meta[:m].copy(), levels[:nlv].copy()


def hevc_recon(planes, bd: int, strong: bool, ops: np.ndarray,
               tu_meta: np.ndarray, levels: np.ndarray,
               residuals: np.ndarray | None = None) -> None:
    """Native HEVC reconstruction (host_hevc.c): runs the op list
    (prediction + residual add) in place on int32 planes.  With
    `residuals` (int16, packed like `levels`), the transforms are
    skipped and the precomputed values (e.g. from the device TU-bucket
    kernels) are added instead."""
    lib = _load()
    assert lib is not None
    Y = planes[0]
    U = planes[1] if len(planes) > 1 else np.zeros((1, 1), np.int32)
    V = planes[2] if len(planes) > 1 else np.zeros((1, 1), np.int32)
    assert Y.dtype == np.int32 and Y.flags.c_contiguous
    fn = lib.ffpic_hevc_recon2
    fn.restype = ctypes.c_int
    resid_p = (np.ascontiguousarray(residuals, np.int16).ctypes
               .data_as(ctypes.c_void_p)
               if residuals is not None else None)
    rc = fn(Y.ctypes.data_as(ctypes.c_void_p),
            U.ctypes.data_as(ctypes.c_void_p),
            V.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(Y.shape[1]), ctypes.c_int(Y.shape[0]),
            ctypes.c_int(U.shape[1]), ctypes.c_int(U.shape[0]),
            ctypes.c_int(len(planes)), ctypes.c_int(bd),
            ctypes.c_int(1 if strong else 0),
            np.ascontiguousarray(ops, np.int32).ctypes
              .data_as(ctypes.c_void_p),
            ctypes.c_long(len(ops)),
            np.ascontiguousarray(tu_meta, np.int32).ctypes
              .data_as(ctypes.c_void_p),
            ctypes.c_long(len(tu_meta)),
            np.ascontiguousarray(levels, np.int16).ctypes
              .data_as(ctypes.c_void_p),
            resid_p)
    if rc != 0:
        raise ValueError(f"hevc native recon failed ({rc})")


def hevc_color(planes, bd: int, coeffs, limited: bool,
               trunc: bool) -> np.ndarray:
    """Native YUV420/400 int32 planes -> RGBA uint8 (host_hevc.c
    ffpic_yuv_to_rgba); bit-identical to the numpy float32 path in
    formats/heif.py (same op order/constants)."""
    lib = _load()
    assert lib is not None
    Y = planes[0]
    mono = len(planes) < 2
    U = planes[1] if not mono else np.zeros((1, 1), np.int32)
    V = planes[2] if not mono else np.zeros((1, 1), np.int32)
    assert Y.dtype == np.int32 and Y.flags.c_contiguous
    h, w = Y.shape
    out = np.empty((h, w, 4), np.uint8)
    a_rv, a_gu, a_gv, a_bu = coeffs
    fn = lib.ffpic_yuv_to_rgba
    fn.restype = None
    fn(Y.ctypes.data_as(ctypes.c_void_p),
       U.ctypes.data_as(ctypes.c_void_p),
       V.ctypes.data_as(ctypes.c_void_p),
       ctypes.c_int(w), ctypes.c_int(h),
       ctypes.c_int(U.shape[1]), ctypes.c_int(U.shape[0]),
       ctypes.c_int(1 if mono else 0), ctypes.c_int(bd),
       ctypes.c_float(a_rv), ctypes.c_float(a_gu),
       ctypes.c_float(a_gv), ctypes.c_float(a_bu),
       ctypes.c_int(1 if limited else 0),
       ctypes.c_int(1 if trunc else 0),
       out.ctypes.data_as(ctypes.c_void_p))
    return out


def jp2_block(data: bytes, n_passes: int, mb: int, zbp: int,
              w: int, h: int, orient: int) -> np.ndarray:
    """EBCOT tier-1 code-block decode (host_jp2.c): returns (h, w)
    int32 signed coefficients."""
    lib = _load()
    assert lib is not None
    out = np.empty((h, w), np.int32)
    fn = lib.ffpic_jp2_block
    fn.restype = ctypes.c_int
    rc = fn(data, ctypes.c_long(len(data)), ctypes.c_int(n_passes),
            ctypes.c_int(mb), ctypes.c_int(zbp), ctypes.c_int(w),
            ctypes.c_int(h), ctypes.c_int(orient),
            out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"jp2 native block decode failed ({rc})")
    return out


def lzw_gif(data: bytes, min_code_size: int, max_out: int) -> bytearray:
    lib = _load()
    assert lib is not None
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_out, np.uint8)
    fn = lib.ffpic_lzw_gif
    fn.restype = ctypes.c_long
    n = fn(src.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(data)),
           ctypes.c_int(min_code_size),
           out.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(max_out))
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return bytearray(out[:n].tobytes())


def lzw_tiff(data: bytes, max_out: int) -> bytearray:
    lib = _load()
    assert lib is not None
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_out, np.uint8)
    fn = lib.ffpic_lzw_tiff
    fn.restype = ctypes.c_long
    n = fn(src.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(data)),
           out.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(max_out))
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return bytearray(out[:n].tobytes())


def vp8_mb_headers(part0: bytes, state, mbh: int, mbw: int,
                   seg_update: bool, seg_probs, mb_no_skip: bool,
                   prob_skip: int, kf_bmode_probs: np.ndarray):
    """Native VP8 MB-header parse resuming a bool-decoder state
    (pos, value, range, bit_count).  Returns (seg, skip, ymode,
    uvmode, bmodes(mbh,mbw,4,4)) int32 arrays."""
    lib = _load()
    assert lib is not None
    pos, value, rng, bit_count = state
    seg = np.zeros((mbh, mbw), np.int32)
    skip = np.zeros((mbh, mbw), np.int32)
    ymode = np.zeros((mbh, mbw), np.int32)
    uvmode = np.zeros((mbh, mbw), np.int32)
    bmodes = np.zeros((mbh, mbw, 16), np.int32)
    buf = np.frombuffer(part0, np.uint8)
    fn = lib.ffpic_vp8_mb_headers
    fn.restype = None
    fn(buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(part0)),
       ctypes.c_long(pos), ctypes.c_uint32(value), ctypes.c_uint32(rng),
       ctypes.c_int(bit_count), ctypes.c_int(mbh), ctypes.c_int(mbw),
       ctypes.c_int(1 if seg_update else 0),
       np.ascontiguousarray(seg_probs, np.uint8).ctypes
         .data_as(ctypes.c_void_p),
       ctypes.c_int(1 if mb_no_skip else 0), ctypes.c_int(prob_skip),
       np.ascontiguousarray(kf_bmode_probs, np.uint8).ctypes
         .data_as(ctypes.c_void_p),
       seg.ctypes.data_as(ctypes.c_void_p),
       skip.ctypes.data_as(ctypes.c_void_p),
       ymode.ctypes.data_as(ctypes.c_void_p),
       uvmode.ctypes.data_as(ctypes.c_void_p),
       bmodes.ctypes.data_as(ctypes.c_void_p))
    return seg, skip, ymode, uvmode, bmodes.reshape(mbh, mbw, 4, 4)


def vp8l_entropy(data: bytes, pos: int, bit: int, w: int, h: int,
                 allow_meta: bool, clcl_order, dist_map):
    """Native VP8L entropy-image decode.  Returns (argb (h,w,4) uint8,
    new_pos, new_bit)."""
    lib = _load()
    assert lib is not None
    out = np.empty((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    p = ctypes.c_long(pos)
    b = ctypes.c_int(bit)
    fn = lib.ffpic_vp8l_entropy
    fn.restype = ctypes.c_int
    rc = fn(buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(data)),
            ctypes.byref(p), ctypes.byref(b),
            ctypes.c_int(w), ctypes.c_int(h),
            ctypes.c_int(1 if allow_meta else 0),
            np.ascontiguousarray(clcl_order, np.uint8).ctypes
              .data_as(ctypes.c_void_p),
            np.ascontiguousarray(dist_map, np.int16).ctypes
              .data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"corrupt VP8L stream ({rc})")
    return out, p.value, b.value


def av1_recon(op_arr, planes, pw, ph, res_buf, dr, smw, taps,
              pal_buf, bd: int):
    """Native AV1 intra reconstruction (host_av1.c:av1_recon): replay
    the precomputed op list sequentially over the int32 plane
    buffers (mutated in place)."""
    lib = _load()
    fn = lib.av1_recon
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_void_p, c.c_longlong] + [c.c_void_p] * 10 \
            + [c.c_int]
        fn._bound = True
    assert op_arr.dtype == np.int32 and op_arr.flags.c_contiguous
    p = [pl.ctypes.data for pl in planes] + [None] * (3 - len(planes))
    fn(op_arr.ctypes.data, op_arr.shape[0], p[0], p[1], p[2],
       pw.ctypes.data, ph.ctypes.data, res_buf.ctypes.data,
       dr.ctypes.data, smw.ctypes.data, taps.ctypes.data,
       pal_buf.ctypes.data, bd)


def vp8_color_libwebp(Y, U, V, H: int, W: int, A=None):
    """libwebp-exact host YUV420->RGBA (host_vp8.c): fancy chroma
    upsample + fixed-point matrix; bit-identical to the numpy path in
    formats/webp.py."""
    lib = _load()
    fn = lib.vp8_color_libwebp
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_void_p, c.c_long, c.c_void_p, c.c_void_p,
                       c.c_long, c.c_int, c.c_int, c.c_void_p,
                       c.c_void_p]
        fn._bound = True
    Y = np.ascontiguousarray(Y, np.uint8)
    ch, cw = (H + 1) // 2, (W + 1) // 2
    U = np.ascontiguousarray(U[:ch, :cw], np.uint8)
    V = np.ascontiguousarray(V[:ch, :cw], np.uint8)
    out = np.empty((H, W, 4), np.uint8)
    a_ptr = None
    if A is not None:
        A = np.ascontiguousarray(A, np.uint8)
        assert A.shape == (H, W)
        a_ptr = A.ctypes.data
    fn(Y.ctypes.data, Y.shape[1], U.ctypes.data, V.ctypes.data,
       U.shape[1], H, W, a_ptr, out.ctypes.data)
    return out


def av1_block_parse(data: bytes, st, ptrs, blk, pp, nplanes: int,
                    ops, coef, tbmeta, clip: int, inout):
    """Whole-block AV1 residual parse (host_av1.c:av1_block_parse):
    C iterates the residual() TB geometry, decodes coefficients and
    emits recon ops, maintaining BlockDecoded bitmaps / a,l contexts
    / chroma tx grids / MaxLuma in place."""
    lib = _load()
    fn = lib.av1_block_parse
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_char_p, c.c_longlong, c.c_void_p,
                       c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,
                       c.c_void_p, c.c_void_p, c.c_void_p,
                       c.c_longlong, c.c_void_p]
        fn._bound = True
    fn(data, len(data), st.ctypes.data, ptrs.ctypes.data,
       blk.ctypes.data, pp.ctypes.data, nplanes, ops.ctypes.data,
       coef.ctypes.data, tbmeta.ctypes.data, clip,
       inout.ctypes.data)



def av1_block_mode(data: bytes, st, mode_ptrs, blk, out, pal):
    """Per-block AV1 mode-info symbol decode (host_av1.c:
    av1_block_mode): seg/skip/cdef/deltas/modes/CfL/filter-intra/
    tx-depth against the shared mode CDF arenas; mutates the context
    grids and msac state in place."""
    lib = _load()
    fn = lib.av1_block_mode
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_char_p, c.c_longlong, c.c_void_p,
                       c.c_void_p, c.c_void_p, c.c_void_p,
                       c.c_void_p]
        fn._bound = True
    fn(data, len(data), st.ctypes.data, mode_ptrs.ctypes.data,
       blk.ctypes.data, out.ctypes.data, pal.ctypes.data)


def av1_color_cicp(planes, h: int, w: int, sx: int, sy: int, bd: int,
                   limited: bool, mode: int,
                   kr: float = 0.0, kb: float = 0.0) -> np.ndarray:
    """CICP YUV -> RGBA uint8 (host_av1.c av1_color_cicp), bit-exact
    vs the numpy float32 oracle in formats/avif.py (_yuv_to_rgba_np):
    integer 3/4-1/4 chroma upsample then float32 matrix with
    floor(x+0.5).  mode: 0=matrix(kr,kb), 1=identity GBR, 2=mono."""
    lib = _load()
    assert lib is not None
    c = ctypes
    fn = lib.av1_color_cicp
    if not getattr(fn, "_bound", False):
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_long, c.c_void_p, c.c_long,
                       c.c_void_p, c.c_long, c.c_int,
                       c.c_int, c.c_int, c.c_int, c.c_int,
                       c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
                       c.c_double, c.c_double, c.c_void_p]
        fn._bound = True

    def prep(p):
        if p.dtype == np.uint8 and p.strides[1] == 1:
            return p, 1
        if p.dtype == np.uint16 and p.strides[1] == 2:
            return p, 2
        return np.ascontiguousarray(p, np.uint16), 2

    Y, ey = prep(planes[0])
    if len(planes) > 1:
        U, eu = prep(planes[1])
        V, ev = prep(planes[2])
        if not (ey == eu == ev):            # mixed dtypes: widen all
            Y = np.ascontiguousarray(Y, np.uint16); ey = 2
            U = np.ascontiguousarray(U, np.uint16)
            V = np.ascontiguousarray(V, np.uint16)
    else:
        U = V = Y
    ch, cw = U.shape
    out = np.empty((h, w, 4), np.uint8)
    rc = fn(Y.ctypes.data, Y.strides[0] // ey,
            U.ctypes.data, U.strides[0] // ey,
            V.ctypes.data, V.strides[0] // ey, ey,
            h, w, ch, cw, sx, sy, bd, 1 if limited else 0, mode,
            float(kr), float(kb), out.ctypes.data)
    if rc != 0:
        raise MemoryError("av1_color_cicp allocation failed")
    return out


def av1_sb_parse(data: bytes, st, ptrs, mode_ptrs, x_ptrs, sbp,
                 ops, coef, tbmeta, pal, io):
    """Whole-superblock AV1 parse (host_av1.c av1_sb_parse): the
    partition walk, per-block mode-info, grid record writes and the
    residual TB walk fused into one C call per superblock.  Mutates
    the CDF arenas, context grids and msac state in place; returns
    via the io record (counts, qindex/delta-lf state, error code)."""
    lib = _load()
    fn = lib.av1_sb_parse
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_char_p, c.c_longlong] + [c.c_void_p] * 10
        fn._bound = True
    fn(data, len(data), st.ctypes.data, ptrs.ctypes.data,
       mode_ptrs.ctypes.data, x_ptrs.ctypes.data, sbp.ctypes.data,
       ops.ctypes.data, coef.ctypes.data, tbmeta.ctypes.data,
       pal.ctypes.data, io.ctypes.data)


def av1_deblock_pass(arr, h: int, w: int, plane: int, pass_: int,
                     prm, txw, txh, bc0, br0, skip, seg, dlf):
    """One AV1 deblock pass (host_av1.c av1_deblock_pass) over an
    int32 plane in place; 1:1 with the numpy/scalar oracles in
    formats/av1_loopfilter.py."""
    lib = _load()
    fn = lib.av1_deblock_pass
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_void_p] + [c.c_int] * 4 + [c.c_void_p] * 8
        fn._bound = True
    fn(arr.ctypes.data, h, w, plane, pass_, prm.ctypes.data,
       txw.ctypes.data, txh.ctypes.data, bc0.ctypes.data,
       br0.ctypes.data, skip.ctypes.data, seg.ctypes.data,
       dlf.ctypes.data)


def av1_itx_batch(coeffs, aw: int, ah: int, w: int, h: int,
                  hk: int, vk: int, rect2: bool, row_shift: int,
                  rlo: int, rhi: int, clo: int, chi: int, cos_tab):
    """Lane-major batched AV1 inverse transforms
    (host_av1_itx.c av1_itx_batch): one call per
    (tx_size, tx_type) group, bit-exact with the numpy int32 lane
    path in coding/av1_itx.py (wrap semantics included).  coeffs is
    (B, ah, aw) int32; returns (B, h, w) int32."""
    lib = _load()
    fn = lib.av1_itx_batch
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = ctypes.c_int
        fn.argtypes = [c.c_void_p, c.c_long] + [c.c_int] * 6 \
            + [c.c_int, c.c_int] + [c.c_int32] * 4 \
            + [c.c_void_p, c.c_void_p]
        fn._bound = True
    B = coeffs.shape[0]
    out = np.empty((B, h, w), np.int32)
    rc = fn(coeffs.ctypes.data, B, aw, ah, w, h, hk, vk,
            int(rect2), row_shift, rlo, rhi, clo, chi,
            cos_tab.ctypes.data, out.ctypes.data)
    if rc:
        raise MemoryError("av1_itx_batch allocation failed")
    return out


def av1_wht_batch(coeffs):
    """Lossless 4x4 inverse Walsh-Hadamard batch
    (host_av1_itx.c av1_wht_batch): (B, 4, 4) int32 -> same."""
    lib = _load()
    fn = lib.av1_wht_batch
    if not getattr(fn, "_bound", False):
        c = ctypes
        fn.restype = None
        fn.argtypes = [c.c_void_p, c.c_long, c.c_void_p]
        fn._bound = True
    B = coeffs.shape[0]
    out = np.empty((B, 4, 4), np.int32)
    fn(coeffs.ctypes.data, B, out.ctypes.data)
    return out
