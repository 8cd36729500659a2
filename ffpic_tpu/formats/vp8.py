"""VP8 key-frame decoder (RFC 6386) — the lossy-WebP pixel path.

Capability parity with the reference's format/webp.c VP8 path
(control partition, segmentation, token partitions, dequant, Y2 WHT,
4x4 IDCT, all 10 B-modes + 4 16x16/chroma modes, simple+normal loop
filters). Architecture differs, device-first:

* header/mode parse: Python bool decoder (small, host).
* token partitions -> raw coefficient LEVELS tensor (mby, mbx, 25, 16)
  — no inline dequant; dequantization, the Y2 inverse WHT, DC scatter
  and all 4x4 IDCTs then run BATCHED over the whole image (numpy golden
  here; same math as ops/jpeg_kernels' device path), because residuals
  are prediction-independent.
* intra prediction + residual add is the inherently serial feedback
  loop (left/top wavefront) and runs on host; a device wavefront
  variant is the planned experiment (SURVEY.md §7 hard part 2).
* loop filter + YUV->RGBA run vectorized.

Validated pixel-exact against libwebp (via PIL) in tests/test_webp.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ffpic_tpu.coding.booldec import BoolDecoder
from ffpic_tpu.formats import vp8_tables as T
from ffpic_tpu.ops import golden
from ffpic_tpu.utils.vlog import get_logger

log = get_logger("vp8")

DC, V_PRED, H_PRED, TM, B_PRED = 0, 1, 2, 3, 4
# b-modes in the libwebp/reference enum order (matches KF_BMODE_PROBS
# layout and BMODE_TREE leaves; see vp8_tables.py)
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# context-propagation submode for whole-MB modes (RFC 6386 11.3)
MODE_TO_B = {DC: B_DC, V_PRED: B_VE, H_PRED: B_HE, TM: B_TM}


@dataclass
class FrameHeader:
    width: int = 0
    height: int = 0
    xscale: int = 0
    yscale: int = 0
    version: int = 0
    seg_enabled: bool = False
    seg_update_map: bool = False
    seg_abs: bool = False
    seg_quant: list = field(default_factory=lambda: [0, 0, 0, 0])
    seg_lf: list = field(default_factory=lambda: [0, 0, 0, 0])
    seg_tree_probs: list = field(default_factory=lambda: [255, 255, 255])
    filter_type: int = 0
    filter_level: int = 0
    sharpness: int = 0
    lf_delta_enabled: bool = False
    ref_lf_deltas: list = field(default_factory=lambda: [0, 0, 0, 0])
    mode_lf_deltas: list = field(default_factory=lambda: [0, 0, 0, 0])
    n_partitions: int = 1
    q_yac: int = 0
    q_ydc_delta: int = 0
    q_y2dc_delta: int = 0
    q_y2ac_delta: int = 0
    q_uvdc_delta: int = 0
    q_uvac_delta: int = 0
    mb_no_skip: bool = False
    prob_skip: int = 0


def _clip255(x):
    return np.clip(x, 0, 255)


class VP8Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self._parse_frame_tag()

    # ------------------------------------------------------------------
    def _parse_frame_tag(self):
        d = self.data
        tag = d[0] | (d[1] << 8) | (d[2] << 16)
        self.keyframe = not (tag & 1)
        self.version = (tag >> 1) & 7
        self.show = (tag >> 4) & 1
        first_size = tag >> 5
        pos = 3
        if not self.keyframe:
            raise ValueError("only key frames occur in WebP stills")
        if d[3:6] != b"\x9d\x01\x2a":
            raise ValueError("bad VP8 start code")
        if 10 + first_size > len(d):
            raise ValueError("truncated VP8: first partition size "
                             f"{first_size} exceeds available data")
        w = d[6] | (d[7] << 8)
        h = d[8] | (d[9] << 8)
        self.hdr = FrameHeader(width=w & 0x3FFF, height=h & 0x3FFF,
                               xscale=w >> 14, yscale=h >> 14,
                               version=self.version)
        self.part0 = d[10:10 + first_size]
        self.rest = d[10 + first_size:]

    # ------------------------------------------------------------------
    def _parse_control_partition(self):
        h = self.hdr
        br = BoolDecoder(self.part0)
        self.color_space = br.get_bit()
        self.clamp_type = br.get_bit()

        h.seg_enabled = bool(br.get_bit())
        if h.seg_enabled:
            h.seg_update_map = bool(br.get_bit())
            update_data = br.get_bit()
            if update_data:
                h.seg_abs = bool(br.get_bit())
                for i in range(4):
                    h.seg_quant[i] = br.maybe_get_signed(7)
                for i in range(4):
                    h.seg_lf[i] = br.maybe_get_signed(6)
            if h.seg_update_map:
                for i in range(3):
                    h.seg_tree_probs[i] = (br.get_literal(8)
                                           if br.get_bit() else 255)

        h.filter_type = br.get_bit()
        h.filter_level = br.get_literal(6)
        h.sharpness = br.get_literal(3)
        h.lf_delta_enabled = bool(br.get_bit())
        if h.lf_delta_enabled:
            if br.get_bit():  # mode_ref_lf_delta_update
                for i in range(4):
                    if br.get_bit():
                        h.ref_lf_deltas[i] = br.get_signed(6)
                for i in range(4):
                    if br.get_bit():
                        h.mode_lf_deltas[i] = br.get_signed(6)

        h.n_partitions = 1 << br.get_literal(2)

        h.q_yac = br.get_literal(7)
        h.q_ydc_delta = br.maybe_get_signed(4)
        h.q_y2dc_delta = br.maybe_get_signed(4)
        h.q_y2ac_delta = br.maybe_get_signed(4)
        h.q_uvdc_delta = br.maybe_get_signed(4)
        h.q_uvac_delta = br.maybe_get_signed(4)

        br.get_bit()  # refresh_entropy_probs (ignored for stills)

        self.coeff_probs = np.ascontiguousarray(
            T.DEFAULT_COEFF_PROBS.copy(), np.uint8)
        upd = T.COEFF_UPDATE_PROBS
        import os
        native_ok = False
        if not os.environ.get("FFPIC_NO_NATIVE"):
            from ffpic_tpu import native
            native_ok = native.available()
        if native_ok:
            from ffpic_tpu import native
            native.vp8_coeff_probs(bytes(br.data), br,
                                   np.ascontiguousarray(upd, np.uint8),
                                   self.coeff_probs)
        else:
            for t in range(4):
                for b in range(8):
                    for c in range(3):
                        for p in range(11):
                            if br.get_bool(int(upd[t, b, c, p])):
                                self.coeff_probs[t, b, c, p] = \
                                    br.get_literal(8)

        h.mb_no_skip = bool(br.get_bit())
        if h.mb_no_skip:
            h.prob_skip = br.get_literal(8)
        self.br0 = br

    # ------------------------------------------------------------------
    def _dequant_tables(self):
        """Per-segment dequant factors (RFC 6386 9.6/14.1; libwebp's
        uv_dc index clamp to 117)."""
        h = self.hdr
        dcq, acq = T.DC_QLOOKUP, T.AC_QLOOKUP

        def clip_q(x, m=127):
            return min(max(x, 0), m)

        self.dq = []
        for s in range(4):
            if h.seg_enabled:
                base = (h.seg_quant[s] if h.seg_abs
                        else h.q_yac + h.seg_quant[s])
            else:
                base = h.q_yac
            q = clip_q(base)
            y1dc = dcq[clip_q(q + h.q_ydc_delta)]
            y1ac = acq[q]
            y2dc = dcq[clip_q(q + h.q_y2dc_delta)] * 2
            y2ac = acq[clip_q(q + h.q_y2ac_delta)] * 155 // 100
            y2ac = max(y2ac, 8)
            uvdc = dcq[clip_q(q + h.q_uvdc_delta, 117)]
            uvac = acq[clip_q(q + h.q_uvac_delta)]
            self.dq.append((y1dc, y1ac, y2dc, y2ac, uvdc, uvac))

    # ------------------------------------------------------------------
    def _parse_mb_headers(self):
        import os
        h = self.hdr
        br = self.br0
        mbw = (h.width + 15) // 16
        mbh = (h.height + 15) // 16
        self.mbw, self.mbh = mbw, mbh

        if not os.environ.get("FFPIC_NO_NATIVE"):
            from ffpic_tpu import native
            if native.available():
                state = (br.pos, br.value, br.range, br.bit_count)
                (self.seg, self.skip, self.ymode, self.uvmode,
                 self.bmodes) = native.vp8_mb_headers(
                    bytes(br.data), state, mbh, mbw,
                    h.seg_enabled and h.seg_update_map,
                    np.asarray(h.seg_tree_probs, np.uint8),
                    h.mb_no_skip, h.prob_skip,
                    np.asarray(T.KF_BMODE_PROBS, np.uint8))
                return

        self.seg = np.zeros((mbh, mbw), np.int32)
        self.skip = np.zeros((mbh, mbw), np.int32)
        self.ymode = np.zeros((mbh, mbw), np.int32)
        self.uvmode = np.zeros((mbh, mbw), np.int32)
        self.bmodes = np.zeros((mbh, mbw, 4, 4), np.int32)

        above_b = np.full((mbw, 4), B_DC, np.int32)
        for my in range(mbh):
            left_b = np.full(4, B_DC, np.int32)
            for mx in range(mbw):
                if h.seg_enabled and h.seg_update_map:
                    self.seg[my, mx] = br.get_tree(T.SEGMENT_TREE,
                                                   h.seg_tree_probs)
                if h.mb_no_skip:
                    self.skip[my, mx] = br.get_bool(h.prob_skip)
                ym = br.get_tree(T.KF_YMODE_TREE, T.KF_YMODE_PROBS)
                self.ymode[my, mx] = ym
                if ym == B_PRED:
                    for sy in range(4):
                        for sx in range(4):
                            a = (above_b[mx, sx] if sy == 0
                                 else self.bmodes[my, mx, sy - 1, sx])
                            l = (left_b[sy] if sx == 0
                                 else self.bmodes[my, mx, sy, sx - 1])
                            m = br.get_tree(T.BMODE_TREE,
                                            T.KF_BMODE_PROBS[a][l])
                            self.bmodes[my, mx, sy, sx] = m
                else:
                    self.bmodes[my, mx, :, :] = MODE_TO_B[ym]
                above_b[mx] = self.bmodes[my, mx, 3, :]
                left_b = self.bmodes[my, mx, :, 3]
                self.uvmode[my, mx] = br.get_tree(T.UV_MODE_TREE,
                                                  T.KF_UV_MODE_PROBS)

    # ------------------------------------------------------------------
    def _parse_tokens(self):
        """Decode coefficient levels for every MB into
        (mbh, mbw, 25, 16) int32: blocks 0-15 Y (raster), 16-19 U,
        20-23 V, 24 Y2. Levels are raw (pre-dequant), zigzag order
        undone (natural 4x4 raster)."""
        h = self.hdr
        nparts = h.n_partitions
        # (nparts-1) 3-byte little-endian sizes precede the partitions;
        # the last partition runs to the end of the stream (RFC 9.5)
        sizes = []
        pos = 0
        for i in range(nparts - 1):
            sizes.append(self.rest[pos] | (self.rest[pos + 1] << 8) |
                         (self.rest[pos + 2] << 16))
            pos += 3
        offs, lens = [], []
        p = pos
        for i in range(nparts):
            end = p + sizes[i] if i < nparts - 1 else len(self.rest)
            if end > len(self.rest) or p > len(self.rest):
                raise ValueError("truncated VP8: token partition "
                                 f"{i} claims bytes past end of data")
            offs.append(p)
            lens.append(end - p)
            p = end

        mbw, mbh = self.mbw, self.mbh
        self.has_y2 = (self.ymode != B_PRED)

        import os
        if not os.environ.get("FFPIC_NO_NATIVE"):
            from ffpic_tpu import native
            if native.available():
                self.levels, self.nnz_total = native.vp8_tokens(
                    self.rest, offs, lens, self.coeff_probs,
                    self.skip.astype(np.uint8),
                    self.has_y2.astype(np.uint8), mbh, mbw)
                self.mb_has_coeffs = self.nnz_total.sum(axis=2) > 0
                return

        parts = [BoolDecoder(self.rest[o:o + n])
                 for o, n in zip(offs, lens)]
        self.levels = np.zeros((mbh, mbw, 25, 16), np.int32)
        self.has_y2 = (self.ymode != B_PRED)
        self.nnz_total = np.zeros((mbh, mbw, 25), np.int32)

        # nonzero-context state: above (per MB column) and left
        above_nz = np.zeros((mbw, 9), np.int32)  # 4 Y, 2 U, 2 V, 1 Y2
        probs = self.coeff_probs
        bands = T.COEFF_BANDS
        zz = T.ZIGZAG4
        tree = T.TOKEN_TREE
        cat_probs = T.CAT_PROBS
        cat_base = T.CAT_BASE

        for my in range(mbh):
            left_nz = np.zeros(9, np.int32)
            br = parts[my % len(parts)]
            for mx in range(mbw):
                has_y2 = bool(self.has_y2[my, mx])
                if self.skip[my, mx]:
                    # skipped MB: no tokens; context resets (except y2
                    # which keeps its context when has_y2, RFC 13.1?
                    # libwebp: nz set to 0 for all; y2 left/above kept
                    # when !has_y2)
                    if has_y2:
                        above_nz[mx, :] = 0
                        left_nz[:] = 0
                    else:
                        above_nz[mx, :8] = 0
                        left_nz[:8] = 0
                    continue

                lv = self.levels[my, mx]

                def decode_block(bi, btype, first, ctx):
                    """RFC 6386 13.3: token tree walk per coefficient;
                    after a DCT_0 token the EOB branch is skipped
                    (tree start index 2)."""
                    nz = 0
                    blk = lv[bi]
                    c = ctx
                    start = 0
                    for n in range(first, 16):
                        pr = probs[btype][bands[n]][c]
                        tok = br.get_tree(tree, pr, start)
                        if tok == T.DCT_EOB:
                            break
                        if tok == 0:
                            start = 2
                            c = 0
                            continue
                        start = 0
                        if tok <= 4:
                            val = tok
                        else:
                            cat = tok - 5
                            extra = 0
                            for pb in cat_probs[cat]:
                                extra = (extra << 1) | br.get_bool(pb)
                            val = cat_base[cat] + extra
                        c = 2 if val > 1 else 1
                        if br.get_bit():
                            val = -val
                        blk[zz[n]] = val
                        nz = n + 1
                    return nz

                # token decode order: Y2 (if present), 16 Y, 4 U, 4 V
                if has_y2:
                    ctx = above_nz[mx, 8] + left_nz[8]
                    nz = decode_block(24, 1, 0, int(ctx))
                    above_nz[mx, 8] = left_nz[8] = int(nz > 0)
                    self.nnz_total[my, mx, 24] = nz
                    ytype, yfirst = 0, 1
                else:
                    ytype, yfirst = 3, 0

                nzy = [[0] * 4 for _ in range(4)]
                for sy in range(4):
                    for sx in range(4):
                        bi = sy * 4 + sx
                        a = above_nz[mx, sx] if sy == 0 else nzy[sy - 1][sx]
                        l = left_nz[sy] if sx == 0 else nzy[sy][sx - 1]
                        nz = decode_block(bi, ytype, yfirst, int(a + l))
                        nzy[sy][sx] = int(nz > 0)
                        self.nnz_total[my, mx, bi] = nz
                for sx in range(4):
                    above_nz[mx, sx] = nzy[3][sx]
                for sy in range(4):
                    left_nz[sy] = nzy[sy][3]

                for ci, base in ((0, 16), (1, 20)):   # U then V
                    nzc = [[0, 0], [0, 0]]
                    for sy in range(2):
                        for sx in range(2):
                            bi = base + sy * 2 + sx
                            aidx = 4 + 2 * ci + sx
                            a = (above_nz[mx, aidx] if sy == 0
                                 else nzc[sy - 1][sx])
                            l = (left_nz[4 + 2 * ci + sy] if sx == 0
                                 else nzc[sy][sx - 1])
                            nz = decode_block(bi, 2, 0, a + l)
                            nzc[sy][sx] = int(nz > 0)
                            self.nnz_total[my, mx, bi] = nz
                    for sx in range(2):
                        above_nz[mx, 4 + 2 * ci + sx] = nzc[1][sx]
                    for sy in range(2):
                        left_nz[4 + 2 * ci + sy] = nzc[sy][1]

        self.mb_has_coeffs = self.nnz_total.sum(axis=2) > 0

    # ------------------------------------------------------------------
    def _residuals(self):
        """Batched: dequant -> Y2 IWHT -> DC scatter -> 4x4 IDCT for the
        whole image (prediction-independent).  FFPIC_VP8_DEVICE=1 runs
        it as one jitted device launch (ops/vp8_kernels — the reference's
        accel-layer equivalent, sse2.c:49-182); default is the numpy
        golden path (no per-geometry compile cost on CPU runs)."""
        import os
        mbh, mbw = self.mbh, self.mbw
        if os.environ.get("FFPIC_VP8_DEVICE"):
            import numpy as _np
            from ffpic_tpu.ops import vp8_kernels as vk
            seg = (self.seg if self.hdr.seg_enabled
                   else _np.zeros((mbh, mbw), _np.int32))
            dq_mb = _np.array(self.dq, _np.int32)[seg]
            self.residual = _np.asarray(vk.vp8_residuals(
                self.levels, dq_mb, self.has_y2))
            return
        if not os.environ.get("FFPIC_NO_NATIVE"):
            from ffpic_tpu import native
            if native.available():
                self.residual = native.vp8_residuals(
                    self.levels, self.nnz_total,
                    np.array(self.dq, np.int32),
                    self.seg if self.hdr.seg_enabled else None,
                    self.has_y2.astype(np.uint8), mbh, mbw)
                return
        lv = self.levels
        seg = (self.seg if self.hdr.seg_enabled
               else np.zeros((mbh, mbw), np.int32))
        dqa = np.array(self.dq, np.int32)       # (4, 6)
        y1dc = dqa[seg, 0][..., None]
        y1ac = dqa[seg, 1][..., None]
        y2dc = dqa[seg, 2][..., None]
        y2ac = dqa[seg, 3][..., None]
        uvdc = dqa[seg, 4][..., None]
        uvac = dqa[seg, 5][..., None]

        deq = np.zeros_like(lv)
        deq[..., :16, :] = lv[..., :16, :] * y1ac[..., None, :]
        deq[..., :16, 0] = lv[..., :16, 0] * y1dc
        deq[..., 16:24, :] = lv[..., 16:24, :] * uvac[..., None, :]
        deq[..., 16:24, 0] = lv[..., 16:24, 0] * uvdc
        deq[..., 24, :] = lv[..., 24, :] * y2ac
        deq[..., 24, 0] = lv[..., 24, 0] * y2dc[..., 0]

        # Y2: inverse WHT then scatter DC into the 16 Y blocks
        y2 = deq[..., 24, :].reshape(mbh, mbw, 4, 4).astype(np.int16)
        wht = golden.vp8_iwht4x4(y2).reshape(mbh, mbw, 16)
        mask = self.has_y2[..., None]
        deq[..., :16, 0] = np.where(mask, wht, deq[..., :16, 0])

        blocks = deq[..., :24, :].reshape(mbh, mbw, 24, 4, 4) \
            .astype(np.int16)
        self.residual = golden.vp8_idct4x4(blocks)  # (mbh,mbw,24,4,4) i16

    # ------------------------------------------------------------------
    def _reconstruct(self):
        """Serial intra prediction + residual add (host wavefront)."""
        import os
        mbh, mbw = self.mbh, self.mbw
        W, H = mbw * 16, mbh * 16
        Y = np.zeros((H, W), np.uint8)
        U = np.zeros((H // 2, W // 2), np.uint8)
        Vp = np.zeros((H // 2, W // 2), np.uint8)

        if not os.environ.get("FFPIC_NO_NATIVE"):
            from ffpic_tpu import native
            if native.available():
                native.vp8_recon(Y, U, Vp, self.residual, self.ymode,
                                 self.bmodes, self.uvmode, mbh, mbw)
                self.Y, self.U, self.V = Y, U, Vp
                return

        res = self.residual.astype(np.int32)

        for my in range(mbh):
            for mx in range(mbw):
                self._recon_luma_mb(Y, my, mx, res)
                self._recon_chroma_mb(U, my, mx, res, 16)
                self._recon_chroma_mb(Vp, my, mx, res, 20)
        self.Y, self.U, self.V = Y, U, Vp

    # -- prediction helpers --------------------------------------------
    @staticmethod
    def _edge(plane, y0, x0, size, my, mx):
        """Gather top (incl. top-left) and left edges with VP8's
        127/129 defaults (RFC 6386 12.2)."""
        H, W = plane.shape
        has_top = y0 > 0
        has_left = x0 > 0
        top = np.full(size + 1, 127, np.int32)       # top[0] = top-left
        if has_top:
            top[1:] = plane[y0 - 1, x0:x0 + size]
            top[0] = plane[y0 - 1, x0 - 1] if has_left else 129
        left = np.full(size, 129, np.int32)
        if has_left:
            left[:] = plane[y0:y0 + size, x0 - 1]
        return top, left, has_top, has_left

    def _pred_whole(self, plane, y0, x0, size, mode):
        top, left, has_top, has_left = self._edge(plane, y0, x0, size,
                                                  0, 0)
        if mode == DC:
            if has_top and has_left:
                dc = (top[1:].sum() + left.sum() + size) >> \
                    (4 if size == 8 else 5)
            elif has_top:
                dc = (top[1:].sum() + size // 2) >> (3 if size == 8 else 4)
            elif has_left:
                dc = (left.sum() + size // 2) >> (3 if size == 8 else 4)
            else:
                dc = 128
            return np.full((size, size), dc, np.int32)
        if mode == V_PRED:
            return np.tile(top[1:], (size, 1))
        if mode == H_PRED:
            return np.tile(left[:, None], (1, size))
        # TM
        return _clip255(left[:, None] + top[None, 1:] - top[0])

    def _recon_chroma_mb(self, plane, my, mx, res, base):
        mode = self.uvmode[my, mx]
        y0, x0 = my * 8, mx * 8
        pred = self._pred_whole(plane, y0, x0, 8, mode)
        blk = pred.copy()
        for sy in range(2):
            for sx in range(2):
                r = res[my, mx, base + sy * 2 + sx]
                blk[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4] = _clip255(
                    blk[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4] + r)
        plane[y0:y0 + 8, x0:x0 + 8] = blk.astype(np.uint8)

    def _recon_luma_mb(self, Y, my, mx, res):
        ym = self.ymode[my, mx]
        y0, x0 = my * 16, mx * 16
        if ym != B_PRED:
            pred = self._pred_whole(Y, y0, x0, 16, ym)
            blk = pred.copy()
            for sy in range(4):
                for sx in range(4):
                    r = res[my, mx, sy * 4 + sx]
                    blk[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4] = _clip255(
                        blk[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4] + r)
            Y[y0:y0 + 16, x0:x0 + 16] = blk.astype(np.uint8)
            return
        # B_PRED: 16 serial 4x4 predictions
        H, W = Y.shape
        for sy in range(4):
            for sx in range(4):
                by, bx = y0 + sy * 4, x0 + sx * 4
                pred = self._pred_b4(Y, by, bx, my, mx, sy, sx)
                r = res[my, mx, sy * 4 + sx]
                Y[by:by + 4, bx:bx + 4] = _clip255(pred + r) \
                    .astype(np.uint8)

    def _pred_b4(self, Y, by, bx, my, mx, sy, sx):
        """4x4 B-mode prediction (RFC 6386 12.3, libwebp edge rules)."""
        mode = self.bmodes[my, mx, sy, sx]
        H, W = Y.shape
        has_top = by > 0
        has_left = bx > 0

        # top row incl. top-left and 4 top-right pixels: 9 values
        t = np.full(9, 127, np.int32)
        if has_top:
            t[1:5] = Y[by - 1, bx:bx + 4]
            t[0] = Y[by - 1, bx - 1] if has_left else 129
            # top-right: from the row above if it exists there
            if sy == 0:
                if bx + 4 < W:
                    t[5:9] = Y[by - 1, bx + 4:bx + 8]
                else:
                    t[5:9] = Y[by - 1, W - 1]
            else:
                if sx < 3:
                    t[5:9] = Y[by - 1, bx + 4:bx + 8]
                else:
                    # interior right-column blocks reuse the MB's
                    # above-row top-right pixels (VP8 quirk)
                    ty = my * 16 - 1
                    if ty >= 0:
                        txe = mx * 16 + 16
                        if txe + 4 <= W:
                            t[5:9] = Y[ty, txe:txe + 4]
                        else:
                            t[5:9] = Y[ty, W - 1]
                    # else stay 127
        left = np.full(4, 129, np.int32)
        if has_left:
            left[:] = Y[by:by + 4, bx - 1]

        X = t[0]
        A, B, C, D = t[1], t[2], t[3], t[4]
        E, F, G, Hh = t[5], t[6], t[7], t[8]
        I, J, K, L = left

        def avg2(a, b):
            return (a + b + 1) >> 1

        def avg3(a, b, c):
            return (a + 2 * b + c + 2) >> 2

        o = np.zeros((4, 4), np.int32)
        if mode == B_DC:
            o[:] = (A + B + C + D + I + J + K + L + 4) >> 3
        elif mode == B_TM:
            o[:] = _clip255(left[:, None] + t[None, 1:5] - X)
        elif mode == B_VE:
            row = [avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                   avg3(C, D, E)]
            o[:] = np.array(row)[None, :]
        elif mode == B_HE:
            col = [avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                   avg3(K, L, L)]
            o[:] = np.array(col)[:, None]
        elif mode == B_LD:
            s = [avg3(A, B, C), avg3(B, C, D), avg3(C, D, E),
                 avg3(D, E, F), avg3(E, F, G), avg3(F, G, Hh),
                 avg3(G, Hh, Hh)]
            for r in range(4):
                for c in range(4):
                    o[r, c] = s[r + c]
        elif mode == B_RD:
            o[3, 0] = avg3(J, K, L)
            o[3, 1] = o[2, 0] = avg3(I, J, K)
            o[3, 2] = o[2, 1] = o[1, 0] = avg3(X, I, J)
            o[3, 3] = o[2, 2] = o[1, 1] = o[0, 0] = avg3(A, X, I)
            o[2, 3] = o[1, 2] = o[0, 1] = avg3(B, A, X)
            o[1, 3] = o[0, 2] = avg3(C, B, A)
            o[0, 3] = avg3(D, C, B)
        elif mode == B_VR:
            o[0, 0] = o[2, 1] = avg2(X, A)
            o[0, 1] = o[2, 2] = avg2(A, B)
            o[0, 2] = o[2, 3] = avg2(B, C)
            o[0, 3] = avg2(C, D)
            o[3, 0] = avg3(K, J, I)
            o[2, 0] = avg3(J, I, X)
            o[1, 0] = o[3, 1] = avg3(I, X, A)
            o[1, 1] = o[3, 2] = avg3(X, A, B)
            o[1, 2] = o[3, 3] = avg3(A, B, C)
            o[1, 3] = avg3(B, C, D)
        elif mode == B_VL:
            o[0, 0] = avg2(A, B)
            o[0, 1] = o[2, 0] = avg2(B, C)
            o[0, 2] = o[2, 1] = avg2(C, D)
            o[0, 3] = o[2, 2] = avg2(D, E)
            o[1, 0] = avg3(A, B, C)
            o[1, 1] = o[3, 0] = avg3(B, C, D)
            o[1, 2] = o[3, 1] = avg3(C, D, E)
            o[1, 3] = o[3, 2] = avg3(D, E, F)
            o[2, 3] = avg3(E, F, G)
            o[3, 3] = avg3(F, G, Hh)
        elif mode == B_HD:
            o[0, 0] = o[1, 2] = avg2(I, X)
            o[1, 0] = o[2, 2] = avg2(J, I)
            o[2, 0] = o[3, 2] = avg2(K, J)
            o[3, 0] = avg2(L, K)
            o[0, 3] = avg3(A, B, C)
            o[0, 2] = avg3(X, A, B)
            o[0, 1] = o[1, 3] = avg3(I, X, A)
            o[1, 1] = o[2, 3] = avg3(X, I, J)
            o[2, 1] = o[3, 3] = avg3(I, J, K)
            o[3, 1] = avg3(J, K, L)
        elif mode == B_HU:
            o[0, 0] = avg2(I, J)
            o[0, 1] = avg3(I, J, K)
            o[0, 2] = o[1, 0] = avg2(J, K)
            o[0, 3] = o[1, 1] = avg3(J, K, L)
            o[1, 2] = o[2, 0] = avg2(K, L)
            o[1, 3] = o[2, 1] = avg3(K, L, L)
            o[2, 2] = o[2, 3] = L
            o[3, 0] = o[3, 1] = o[3, 2] = o[3, 3] = L
        return o

    # ------------------------------------------------------------------
    def decode(self):
        import os
        self._parse_control_partition()
        self._dequant_tables()
        self._parse_mb_headers()
        self._parse_tokens()
        fused = not (os.environ.get("FFPIC_VP8_DEVICE")
                     or os.environ.get("FFPIC_NO_NATIVE"))
        if fused:
            from ffpic_tpu import native
            fused = native.available()
        if fused:
            # single MB walk: dequant+IWHT+IDCT into a stack buffer,
            # then prediction + residual add (no whole-image residual
            # intermediate)
            from ffpic_tpu import native
            mbh, mbw = self.mbh, self.mbw
            Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
            U = np.zeros((mbh * 8, mbw * 8), np.uint8)
            Vp = np.zeros((mbh * 8, mbw * 8), np.uint8)
            native.vp8_recon_fused(
                Y, U, Vp, self.levels, self.nnz_total,
                np.array(self.dq, np.int32),
                self.seg if self.hdr.seg_enabled else None,
                self.has_y2.astype(np.uint8),
                self.ymode, self.bmodes, self.uvmode, mbh, mbw)
            self.Y, self.U, self.V = Y, U, Vp
        else:
            self._residuals()
            self._reconstruct()
        from ffpic_tpu.formats.vp8_filter import loop_filter_frame
        loop_filter_frame(self)
        return self.Y, self.U, self.V
