"""VP8 luma intra-prediction WAVEFRONT on device (SURVEY §7 "hard
part 2" experiment): reconstruct the whole luma plane with
`lax.scan` over macroblock anti-diagonals, all MBs on a diagonal
predicted/reconstructed in parallel.

Dependency structure (RFC 6386 12.2/12.3): an MB needs its left MB,
the MB row above, and — through the 4x4 above-right pixels — the MB
above-right.  Diagonal index d = 2*my + mx satisfies all three
(left: d-1, above-right: d-1, above: d-2).

Semantics are the full luma set: DC/V/H/TM 16x16 with edge
fallbacks, and B_PRED's 16 serial 4x4 subblocks with all ten
B-modes, the 127/129 virtual edges, the above-right clamp at the
frame edge, and the interior-right-column top-right quirk —
validated bit-exact against the host reconstruction
(tests/test_vp8_wavefront.py) on real corpus streams.

This exists as a MEASURED EXPERIMENT (PARITY.md "vp8 wavefront"):
the wavefront is ~95 sequential scan steps for a 512x512 frame,
each step a handful of 4x4/16x16 vector ops over <=32 lanes —
far below what the device's vector units can fill; the B_PRED inner dependency chain
adds 16 more sequential stages inside each step.  The numbers (see
PARITY) quantify why the production default keeps intra recon on
the host: the wavefront's critical path is ~1500 dependent tiny
launch stages vs ~4 ms of branchy-but-cache-hot host C.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

B_PRED = 4
DC, V_PRED, H_PRED, TM = 0, 1, 2, 3
# bitstream mode numbering (formats/vp8.py): RD/VR before LD
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = \
    range(10)


def _clip255(x):
    return jnp.clip(x, 0, 255)


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _pred4(mode, t, left):
    """All ten 4x4 B-mode predictions; t = [TL, A..D, E..H] (9,),
    left = [I..L] (4,).  Returns (10, 4, 4) stacked, caller selects
    row `mode` — cheaper under vmap than lax.switch."""
    X = t[0]
    A, Bv, Cv, D = t[1], t[2], t[3], t[4]
    E, F, G, Hh = t[5], t[6], t[7], t[8]
    I, J, K, L = left[0], left[1], left[2], left[3]
    o = []
    # B_DC
    dc = (A + Bv + Cv + D + I + J + K + L + 4) >> 3
    o.append(jnp.full((4, 4), dc))
    # B_TM
    o.append(_clip255(left[:, None] + t[None, 1:5] - X))
    # B_VE
    row = jnp.stack([_avg3(X, A, Bv), _avg3(A, Bv, Cv),
                     _avg3(Bv, Cv, D), _avg3(Cv, D, E)])
    o.append(jnp.tile(row[None, :], (4, 1)))
    # B_HE
    col = jnp.stack([_avg3(X, I, J), _avg3(I, J, K),
                     _avg3(J, K, L), _avg3(K, L, L)])
    o.append(jnp.tile(col[:, None], (1, 4)))
    # B_LD (computed here, appended at bitstream index 6)
    s = jnp.stack([_avg3(A, Bv, Cv), _avg3(Bv, Cv, D),
                   _avg3(Cv, D, E), _avg3(D, E, F), _avg3(E, F, G),
                   _avg3(F, G, Hh), _avg3(G, Hh, Hh)])
    idx = jnp.arange(4)[:, None] + jnp.arange(4)[None, :]
    ld = s[idx]
    # B_RD (bitstream index 4)
    s = jnp.stack([_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J),
                   _avg3(A, X, I), _avg3(Bv, A, X), _avg3(Cv, Bv, A),
                   _avg3(D, Cv, Bv)])
    o.append(s[3 - jnp.arange(4)[:, None] + jnp.arange(4)[None, :]])
    # B_VR (bitstream index 5)
    vr = jnp.zeros((4, 4), t.dtype)
    vr = vr.at[0, 0].set(_avg2(X, A)).at[2, 1].set(_avg2(X, A))
    vr = vr.at[0, 1].set(_avg2(A, Bv)).at[2, 2].set(_avg2(A, Bv))
    vr = vr.at[0, 2].set(_avg2(Bv, Cv)).at[2, 3].set(_avg2(Bv, Cv))
    vr = vr.at[0, 3].set(_avg2(Cv, D))
    vr = vr.at[1, 0].set(_avg3(I, X, A)).at[3, 1].set(_avg3(I, X, A))
    vr = vr.at[1, 1].set(_avg3(X, A, Bv)).at[3, 2].set(
        _avg3(X, A, Bv))
    vr = vr.at[1, 2].set(_avg3(A, Bv, Cv)).at[3, 3].set(
        _avg3(A, Bv, Cv))
    vr = vr.at[1, 3].set(_avg3(Bv, Cv, D))
    vr = vr.at[2, 0].set(_avg3(J, I, X))
    vr = vr.at[3, 0].set(_avg3(K, J, I))
    o.append(vr)
    # B_LD (bitstream index 6)
    o.append(ld)
    # B_VL
    vl = jnp.zeros((4, 4), t.dtype)
    vl = vl.at[0, 0].set(_avg2(A, Bv))
    vl = vl.at[0, 1].set(_avg2(Bv, Cv)).at[2, 0].set(_avg2(Bv, Cv))
    vl = vl.at[0, 2].set(_avg2(Cv, D)).at[2, 1].set(_avg2(Cv, D))
    vl = vl.at[0, 3].set(_avg2(D, E)).at[2, 2].set(_avg2(D, E))
    vl = vl.at[2, 3].set(_avg3(E, F, G))
    vl = vl.at[1, 0].set(_avg3(A, Bv, Cv))
    vl = vl.at[1, 1].set(_avg3(Bv, Cv, D)).at[3, 0].set(
        _avg3(Bv, Cv, D))
    vl = vl.at[1, 2].set(_avg3(Cv, D, E)).at[3, 1].set(
        _avg3(Cv, D, E))
    vl = vl.at[1, 3].set(_avg3(D, E, F)).at[3, 2].set(
        _avg3(D, E, F))
    vl = vl.at[3, 3].set(_avg3(F, G, Hh))
    o.append(vl)
    # B_HD
    hd = jnp.zeros((4, 4), t.dtype)
    hd = hd.at[0, 0].set(_avg2(X, I)).at[1, 2].set(_avg2(X, I))
    hd = hd.at[0, 1].set(_avg3(I, X, A)).at[1, 3].set(
        _avg3(I, X, A))
    hd = hd.at[0, 2].set(_avg3(X, A, Bv))
    hd = hd.at[0, 3].set(_avg3(A, Bv, Cv))
    hd = hd.at[1, 0].set(_avg2(I, J)).at[2, 2].set(_avg2(I, J))
    hd = hd.at[1, 1].set(_avg3(X, I, J)).at[2, 3].set(_avg3(X, I, J))
    hd = hd.at[2, 0].set(_avg2(J, K)).at[3, 2].set(_avg2(J, K))
    hd = hd.at[2, 1].set(_avg3(I, J, K)).at[3, 3].set(_avg3(I, J, K))
    hd = hd.at[3, 0].set(_avg2(K, L))
    hd = hd.at[3, 1].set(_avg3(J, K, L))
    o.append(hd)
    # B_HU
    hu = jnp.zeros((4, 4), t.dtype)
    hu = hu.at[0, 0].set(_avg2(I, J))
    hu = hu.at[0, 1].set(_avg3(I, J, K))
    hu = hu.at[0, 2].set(_avg2(J, K)).at[1, 0].set(_avg2(J, K))
    hu = hu.at[0, 3].set(_avg3(J, K, L)).at[1, 1].set(
        _avg3(J, K, L))
    hu = hu.at[1, 2].set(_avg2(K, L)).at[2, 0].set(_avg2(K, L))
    hu = hu.at[1, 3].set(_avg3(K, L, L)).at[2, 1].set(
        _avg3(K, L, L))
    hu = hu.at[2, 2].set(L).at[2, 3].set(L)
    hu = hu.at[3, :].set(L)
    o.append(hu)
    stacked = jnp.stack(o)        # (10, 4, 4)
    return stacked[mode]


def _mb16_pred(patch17, has_top, has_left, ymode):
    """16x16 DC/V/H/TM from a (17,17) patch (row0 = top edge incl.
    corner, col0 = left edge)."""
    top = patch17[0, 1:]
    left = patch17[1:, 0]
    corner = patch17[0, 0]
    s_top = top.sum()
    s_left = left.sum()
    dc = jnp.where(
        has_top & has_left, (s_top + s_left + 16) >> 5,
        jnp.where(has_top, (s_top + 8) >> 4,
                  jnp.where(has_left, (s_left + 8) >> 4, 128)))
    pred_dc = jnp.full((16, 16), dc)
    pred_v = jnp.tile(top[None, :], (16, 1))
    pred_h = jnp.tile(left[:, None], (1, 16))
    pred_tm = _clip255(left[:, None] + top[None, :] - corner)
    return jnp.stack([pred_dc, pred_v, pred_h, pred_tm])[ymode]


def make_wavefront(mbh: int, mbw: int):
    """Build the jitted wavefront reconstructor for a fixed MB
    geometry.  Returns fn(residual(mbh,mbw,16,4,4) int32,
    ymode(mbh,mbw) int32, bmodes(mbh,mbw,16) int32) -> Y (H,W)
    uint8."""
    H, W = mbh * 16, mbw * 16
    ndiag = 2 * (mbh - 1) + (mbw - 1) + 1
    my_lanes = jnp.arange(mbh)

    def process_lane(Yp, d, my, residual, ymode, bmodes):
        mx = d - 2 * my
        valid = (mx >= 0) & (mx < mbw)
        mxc = jnp.clip(mx, 0, mbw - 1)
        y0 = my * 16          # padded coords: +1 for the pad
        x0 = mxc * 16
        # (17, 21) patch: rows y0..y0+16, cols x0..x0+20 of padded
        # buffer, col indices clamped (above-right replication)
        rows = y0 + jnp.arange(17)
        cols = jnp.clip(x0 + jnp.arange(21), 0, W)
        patch = Yp[rows[:, None], cols[None, :]].astype(jnp.int32)
        has_top = my > 0
        has_left = mx > 0
        # virtual edges: padded buffer already holds 127 row /
        # 129 col; the (0,0) corner special cases are encoded in
        # the pad content (see make_initial)
        res = residual[my, mxc].astype(jnp.int32)    # (16,4,4)
        # --- 16x16 path
        p16 = _mb16_pred(patch[:, :17], has_top, has_left,
                         jnp.clip(ymode[my, mxc], 0, 3))
        blk = p16
        for sy in range(4):
            for sx in range(4):
                sub = blk[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
                blk = lax.dynamic_update_slice(
                    blk, _clip255(sub + res[sy * 4 + sx]),
                    (sy * 4, sx * 4))
        # --- B_PRED path
        bp = patch
        for sy in range(4):
            for sx in range(4):
                py, px = 1 + sy * 4, 1 + sx * 4
                t = jnp.concatenate([
                    bp[py - 1, px - 1][None],
                    lax.dynamic_slice(bp, (py - 1, px), (1, 4))[0],
                    (lax.dynamic_slice(bp, (py - 1, px + 4),
                                       (1, 4))[0]
                     if sx < 3 else bp[0, 17:21]),
                ])
                left = lax.dynamic_slice(bp, (py, px - 1),
                                         (4, 1))[:, 0]
                pred = _pred4(bmodes[my, mxc, sy * 4 + sx], t, left)
                rec = _clip255(pred + res[sy * 4 + sx])
                bp = lax.dynamic_update_slice(bp, rec, (py, px))
        tile = jnp.where(ymode[my, mxc] == B_PRED,
                         bp[1:17, 1:17], blk)
        return jnp.where(valid, tile, 0), my * 16 + 1, \
            jnp.where(valid, mxc * 16 + 1, W + 1), valid

    def step(Yp, d, residual, ymode, bmodes):
        tiles, ys0, xs0, valid = jax.vmap(
            lambda my: process_lane(Yp, d, my, residual, ymode,
                                    bmodes))(my_lanes)
        ys = ys0[:, None, None] + jnp.arange(16)[None, :, None]
        xs = xs0[:, None, None] + jnp.arange(16)[None, None, :]
        ys = jnp.broadcast_to(ys, (mbh, 16, 16))
        xs = jnp.broadcast_to(xs, (mbh, 16, 16))
        # invalid lanes land in the dump column (x = W+1)
        Yp = Yp.at[ys.reshape(-1), xs.reshape(-1)].set(
            tiles.reshape(-1).astype(jnp.uint8), mode="drop")
        return Yp

    @jax.jit
    def run(residual, ymode, bmodes):
        # padded buffer: row 0 = virtual top (127), col 0 = virtual
        # left (129), corner (0,0) = 127 (only read at MB (0,0));
        # one dump column at the right for invalid lanes
        Yp = jnp.full((H + 1, W + 2), 127, jnp.uint8)
        Yp = Yp.at[1:, 0].set(129)
        def body(Yp, d):
            return step(Yp, d, residual, ymode, bmodes), None
        Yp, _ = lax.scan(body, Yp, jnp.arange(ndiag))
        return Yp[1:, 1:W + 1]

    return run
