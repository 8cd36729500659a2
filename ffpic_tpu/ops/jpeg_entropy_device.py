"""Device-side JPEG entropy decode (the VERDICT r2 #1 experiment).

Huffman decoding is bit-serial, but restart intervals are exact
entropy split points (DRI resets the DC predictors and byte-aligns
the stream, format/jpg.c:562-573): every restart segment decodes
independently.  This kernel runs ONE LANE PER SEGMENT as a vectorized
`lax.while_loop` — each iteration decodes one run/size symbol per
lane via a 16-bit combined code+magnitude LUT gather (the device twin
of host_jpeg.c's full12 table, widened so every code resolves in one
lookup), then scatters the coefficient into the concatenated
per-component coefficient space using the same mcu_block_map geometry
the packed host path uses.

Why this can win: the host ships the ~raw entropy bytes (0.1-0.3
bytes/px) instead of decoded coefficient planes (3-6 bytes/px) — a
10-20x cut in host->device staging bytes — and the decode itself
parallelizes over segments x images on the device.

Scope: baseline sequential, 8-bit, interleaved scans.  DRI streams
use exact split points (one lane per restart segment).  DRI-LESS
streams use the self-sync speculative decoder (`spec_scan_lanes` /
`spec_decode_full` / `decode_coeffs_device_spec`): B-byte chunks are
decoded speculatively from guessed block-aligned entry states, the
prefix-free code self-synchronizes within each chunk, a device-side
fixpoint re-scan from each predecessor's exit state makes the chunk
boundary states exact (verified, with host fallback), and segmented
prefix sums turn per-chunk block counts and DC-diff sums into the
absolute block indices and DC predictors the emission pass needs —
all in ONE launch (host round-trips cost more than the kernel).

Differentially tested against the native host decoder over the full
corpus geometry in tests/test_jpeg_entropy_device.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ffpic_tpu import runtime
from ffpic_tpu.ops.golden import ZIGZAG

RUN_EOB = 0xFF
RUN_ZRL = 0xFE
RUN_CODE = 0xFD

# Symbols each lane decodes per while-loop step on the accelerator.
# XLA:GPU brings a data-dependent while_loop's predicate back to the
# host on every iteration, so the unroll amortizes that round trip.
# On an H100 (chip_smoke.py phase 4, 32 x 1088p) unroll 8 ran as fast
# as 64 within the spread (0.45-0.48 s vs 0.42-0.47 s; 2 took
# 0.58-0.62 s) and compiled in 4.7 s instead of 31 s, paid again for
# every new stream length.  The CPU keeps 2: larger unrolls only
# lengthen its compile.
ACCEL_UNROLL = 8


def default_unroll() -> int:
    return ACCEL_UNROLL if runtime.on_accelerator() else 2


# ---------------------------------------------------------------------------
# 16-bit combined LUT (numpy, host-side build; ~256 KiB per table)
# ---------------------------------------------------------------------------

def build_lut16(counts, syms, is_ac: bool) -> np.ndarray:
    """uint32[65536]: (consume << 24) | (flags << 16) | uint16(value).

    flags 0..63 = zero-run with combined EXTENDed value (for DC:
    flags 0, value = diff); RUN_EOB/RUN_ZRL/RUN_CODE sentinels as in
    host_jpeg.c; entry 0 = invalid code."""
    counts = np.asarray(counts, np.int64)
    code_len = np.zeros(65536, np.uint8)
    code_sym = np.zeros(65536, np.int32)
    code = 0
    k = 0
    for bitlen in range(1, 17):
        for _ in range(int(counts[bitlen - 1])):
            base = code << (16 - bitlen)
            span = 1 << (16 - bitlen)
            code_len[base:base + span] = bitlen
            code_sym[base:base + span] = syms[k]
            code += 1
            k += 1
        code <<= 1

    w = np.arange(65536, dtype=np.uint32)
    l = code_len.astype(np.uint32)
    sym = code_sym
    run = (sym >> 4) & 15
    sz = (sym & 15).astype(np.uint32)
    out = np.zeros(65536, np.uint32)
    valid = l > 0

    if is_ac:
        size0 = valid & (sz == 0)
        zrl = size0 & (run == 15)
        eob = size0 & (run != 15)
        out[zrl] = (l[zrl] << 24) | (RUN_ZRL << 16)
        out[eob] = (l[eob] << 24) | (RUN_EOB << 16) \
            | run[eob].astype(np.uint32)
    else:
        size0 = valid & (sym == 0)
        out[size0] = l[size0] << 24

    comb = valid & (sz > 0) & (l + sz <= 16)
    mag = (w >> (16 - l - sz)) & ((1 << sz) - 1)
    val = np.where(mag < (1 << (sz - np.where(sz > 0, 1, 0))),
                   mag.astype(np.int64) - (1 << sz) + 1,
                   mag.astype(np.int64))
    runf = np.zeros_like(run) if not is_ac else run
    out[comb] = ((l + sz)[comb].astype(np.uint32) << 24) \
        | (runf[comb].astype(np.uint32) << 16) \
        | (val[comb].astype(np.int64) & 0xFFFF).astype(np.uint32)

    spill = valid & (sz > 0) & (l + sz > 16)
    out[spill] = (l[spill] << 24) | (RUN_CODE << 16) \
        | (sym[spill] & 0xFFFF).astype(np.uint32)
    return out


def sliding_u32(buf: np.ndarray) -> np.ndarray:
    """uint32[i] = big-endian bytes buf[i..i+4) (padded), so the kernel
    fetches a 32-bit bit-window with ONE gather.

    Built with in-place shift-or into one output buffer: the naive
    `(a<<24)|(b<<16)|...` spelling materializes five full-size uint32
    temporaries, which on this 1-vCPU host measured 40-80x slower
    (~600-1100 ms vs ~14 ms for a 4.9 MB scan)."""
    b = np.concatenate([buf, np.zeros(8, np.uint8)])
    n = len(b) - 8
    out = np.empty(n, np.uint32)
    out[:] = b[:n]
    out <<= 8
    out |= b[1:n + 1]
    out <<= 8
    out |= b[2:n + 2]
    out <<= 8
    out |= b[3:n + 3]
    return out


# ---------------------------------------------------------------------------
# the vectorized decode loop
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("bpm", "out_size",
                                             "max_steps", "unroll"))
def decode_lanes_bmap(u32win, luts, zz, comp_of_sub, tclass_of_sub,
                      bmap, bit0, blk0, blk_end, img_base, bpm: int,
                      out_size: int, max_steps: int, unroll: int = 1,
                      lut_idx=None, bmap_base=None, k0=None, sub0=None,
                      pred0=None, bit_stop=None):
    """Decode all lanes to coefficients.

    u32win: uint32[nbytes] sliding windows of the concatenated
      destuffed streams; luts: uint32[G*4, 65536] (per table group:
      DC-Y, AC-Y, DC-C, AC-C); zz: int32[64];
      comp_of_sub/tclass_of_sub: int32[bpm];
    bmap: int32[sum blocks_per_img] maps an in-image MCU-order block
    index to the image's concatenated per-component block index
    (per-image sections when bmap_base is given);
    bit0/blk0/blk_end/img_base: int32[L] per-lane init (absolute bit
    offset into u32win's byte space; in-image block counter bounds;
    flat int16 offset of the lane's image = cumulative comp_space*64).
    lut_idx: int32[L] per-lane table-group index (default 0);
    bmap_base: int32[L] per-lane offset into bmap (default 0) — these
    two let ONE launch decode a mixed batch (any sizes, any tables)
    as long as sampling stays 4:2:0 (bpm identical).
    k0/sub0/pred0: optional per-lane entry state (in-block coefficient
    index, sub-block index, DC predictors (L, 3)) for lanes that start
    mid-MCU — the speculative DRI-less path stitches chunk boundaries
    to arbitrary symbol boundaries (all-zero for DRI lanes, which
    start at byte-aligned MCU boundaries with reset predictors).
    bit_stop: optional per-lane exit bit — REQUIRED for segments whose
    boundaries fall mid-block: the lane must decode its full bit span
    (a block straddling the exit is emitted part by this lane, rest by
    the next), with blk_end then acting only as the absolute cap that
    keeps the final lane out of the byte-padding bits.
    Returns (int16[out_size] flat coefficients in concatenated
    per-component space with a trailing dump slot, step count)."""
    L = bit0.shape[0]
    if lut_idx is None:
        lut_idx = jnp.zeros(L, jnp.int32)
    if bmap_base is None:
        bmap_base = jnp.zeros(L, jnp.int32)
    if k0 is None:
        k0 = jnp.zeros(L, jnp.int32)
    if sub0 is None:
        sub0 = jnp.zeros(L, jnp.int32)
    lut_flat = luts.reshape(-1)
    zzc = zz.astype(jnp.int32)

    def cond(st):
        return jnp.any(~st[6]) & (st[7] < max_steps)

    def body(st):
        bitpos, blk, sub, k, pred, out, done, step = st
        active = ~done
        byte = (bitpos >> 3).astype(jnp.int32)
        s = (bitpos & 7).astype(jnp.uint32)
        w32 = u32win[byte]
        win16 = ((w32 >> (16 - s)) & jnp.uint32(0xFFFF)).astype(jnp.int32)
        is_dc = k == 0
        tcls = tclass_of_sub[sub]
        tbl = lut_idx * 4 + tcls * 2 + jnp.where(is_dc, 0, 1)
        e = lut_flat[tbl * 65536 + win16]
        consume = (e >> 24).astype(jnp.int32)
        flags = ((e >> 16) & 0xFF).astype(jnp.int32)
        v16 = (e & jnp.uint32(0xFFFF)).astype(jnp.int32)
        val = v16 - 2 * (v16 & 0x8000)              # sign-extend

        invalid = (e == 0) & active

        # magnitude-spill read (RUN_CODE): raw rs symbol in val
        is_code = flags == RUN_CODE
        r_sp = jnp.where(is_dc, 0, val >> 4)
        sz_sp = jnp.where(is_dc, val, val & 15)
        pos2 = bitpos + consume
        w2 = u32win[(pos2 >> 3).astype(jnp.int32)]
        s2 = (pos2 & 7).astype(jnp.uint32)
        szu = jnp.clip(sz_sp, 1, 16).astype(jnp.uint32)  # avoid shift-by-32
        mag = (w2 >> (jnp.uint32(32) - s2 - szu)) \
            & ((jnp.uint32(1) << szu) - 1)
        mag = mag.astype(jnp.int32)
        ext = jnp.where(mag < (1 << jnp.clip(sz_sp - 1, 0, 15)),
                        mag - (1 << jnp.clip(sz_sp, 0, 16)) + 1, mag)
        ext = jnp.where(sz_sp > 0, ext, 0)

        total_consume = consume + jnp.where(is_code, sz_sp, 0)

        # --- DC step -------------------------------------------------
        dc_diff = jnp.where(is_code, ext, val)      # combined or spill
        comp = comp_of_sub[sub]
        pred_new = pred + (dc_diff * (active & is_dc))[:, None] \
            * (jax.nn.one_hot(comp, 3, dtype=jnp.int32))
        dc_value = pred_new[jnp.arange(L), comp]

        # --- AC step -------------------------------------------------
        is_comb = flags < 64
        is_eob = flags == RUN_EOB
        is_zrl = flags == RUN_ZRL
        run = jnp.where(is_comb, flags, r_sp)
        kk = k + run
        ac_value = jnp.where(is_comb, val, ext)
        ac_emit = (~is_dc) & (is_comb | is_code) & (kk <= 63)
        overrun = (~is_dc) & (is_comb | is_code) & (kk > 63) & active

        emit = active & (is_dc | ac_emit)
        emit_pos = jnp.where(is_dc, 0, zzc[jnp.clip(kk, 0, 63)])
        emit_val = jnp.where(is_dc, dc_value, ac_value)
        flat_idx = jnp.where(
            emit,
            img_base + bmap[jnp.clip(bmap_base + blk, 0,
                                     bmap.shape[0] - 1)] * 64
            + emit_pos,
            out_size - 1)
        out = out.at[flat_idx].set(emit_val.astype(jnp.int16),
                                   mode="drop")

        # --- state transitions ----------------------------------------
        k_next = jnp.where(is_dc, 1,
                           jnp.where(is_zrl, k + 16, kk + 1))
        block_end = (~is_dc) & (is_eob | (k_next > 63))
        k_next = jnp.where(block_end, 0, k_next)
        sub_next = jnp.where(block_end, sub + 1, sub)
        wrap = sub_next >= bpm
        sub_next = jnp.where(wrap, 0, sub_next)
        blk_next = jnp.where(block_end, blk + 1, blk)

        bitpos = jnp.where(active, bitpos + total_consume, bitpos)
        blk = jnp.where(active, blk_next, blk)
        sub = jnp.where(active, sub_next, sub)
        k = jnp.where(active, k_next, k)
        pred = jnp.where(active[:, None], pred_new, pred)
        done = done | invalid | overrun | (blk >= blk_end)
        if bit_stop is not None:
            done = done | (bitpos >= bit_stop)
        return (bitpos, blk, sub, k, pred, out, done, step + 1)

    out0 = jnp.zeros(out_size, jnp.int16)
    if pred0 is None:
        pred0 = jnp.zeros((L, 3), jnp.int32)
    done0 = blk0 >= blk_end
    if bit_stop is not None:
        done0 = done0 | (bit0 >= bit_stop)
    st = (bit0.astype(jnp.int32), blk0.astype(jnp.int32),
          sub0.astype(jnp.int32), k0.astype(jnp.int32),
          pred0.astype(jnp.int32), out0, done0, jnp.int32(0))
    if unroll > 1:
        # amortize the fixed per-iteration cost of the while loop by
        # decoding `unroll` symbols per loop step; done-lane masking
        # makes the extra sub-steps harmless no-ops
        one = body

        def body(st):
            for _ in range(unroll):
                st = one(st)
            return st

    st = jax.lax.while_loop(cond, body, st)
    return st[5], st[7]


# ---------------------------------------------------------------------------
# speculative self-sync scan (DRI-less streams)
# ---------------------------------------------------------------------------

SNAP = 256         # snapshot slots per chunk
SNAP_STRIDE = 8    # record every 8th symbol boundary.  Bit-phase sync
# is fast (prefix-free code), but the JOINT state must also align k
# (in-block position) and sub (table class), which only locks via
# EOB/table-selection events — measured sync distances run to
# hundreds of symbols.  Sparse recording works because POST-sync the
# speculative and true decoders visit the SAME boundaries, so any
# recorded boundary past the sync point is an exact match; stride
# costs at most SNAP_STRIDE-1 extra merge symbols while covering
# SNAP*SNAP_STRIDE = 2048 symbols per chunk.  No merge within
# coverage -> ok=False -> host path.


def _spec_symbol_step(u32win, lut_flat, comp_of_sub, tclass_of_sub,
                      bpm_arr, bitpos, k, sub):
    """One speculative symbol transition from (bitpos, k, sub) —
    shared by the scan/snapshot/merge kernels.  Garbage-prefix
    robustness: an invalid code advances one bit, an AC overrun ends
    the block (a prefix-free code self-synchronizes to the true
    symbol stream within a few symbols).

    Returns (advance_bits, k_next, sub_next, block_end, dc_take,
    dc_diff, comp): dc_take is True when this symbol was a valid DC
    diff for component `comp`."""
    byte = (bitpos >> 3).astype(jnp.int32)
    s = (bitpos & 7).astype(jnp.uint32)
    w32 = u32win[byte]
    win16 = ((w32 >> (16 - s)) & jnp.uint32(0xFFFF)).astype(jnp.int32)
    is_dc = k == 0
    tcls = tclass_of_sub[sub]
    tbl = tcls * 2 + jnp.where(is_dc, 0, 1)
    e = lut_flat[tbl * 65536 + win16]
    consume = (e >> 24).astype(jnp.int32)
    flags = ((e >> 16) & 0xFF).astype(jnp.int32)
    v16 = (e & jnp.uint32(0xFFFF)).astype(jnp.int32)
    val = v16 - 2 * (v16 & 0x8000)

    invalid = e == 0

    is_code = flags == RUN_CODE
    r_sp = jnp.where(is_dc, 0, val >> 4)
    sz_sp = jnp.where(is_dc, val, val & 15)
    pos2 = bitpos + consume
    w2 = u32win[(pos2 >> 3).astype(jnp.int32)]
    s2 = (pos2 & 7).astype(jnp.uint32)
    szu = jnp.clip(sz_sp, 1, 16).astype(jnp.uint32)
    mag = (w2 >> (jnp.uint32(32) - s2 - szu)) \
        & ((jnp.uint32(1) << szu) - 1)
    mag = mag.astype(jnp.int32)
    ext = jnp.where(mag < (1 << jnp.clip(sz_sp - 1, 0, 15)),
                    mag - (1 << jnp.clip(sz_sp, 0, 16)) + 1, mag)
    ext = jnp.where(sz_sp > 0, ext, 0)
    adv = jnp.where(invalid, 1,
                    consume + jnp.where(is_code, sz_sp, 0))

    dc_diff = jnp.where(is_code, ext, val)
    comp = comp_of_sub[sub]
    dc_take = is_dc & ~invalid

    is_comb = flags < 64
    is_eob = flags == RUN_EOB
    is_zrl = flags == RUN_ZRL
    run = jnp.where(is_comb, flags, r_sp)
    kk = k + run
    k_next = jnp.where(is_dc, 1,
                       jnp.where(is_zrl, k + 16, kk + 1))
    block_end = (~is_dc) & (is_eob | (k_next > 63)) & ~invalid
    k_next = jnp.where(block_end, 0, k_next)
    k_next = jnp.where(invalid, k, k_next)
    sub_next = jnp.where(block_end, sub + 1, sub)
    sub_next = jnp.where(sub_next >= bpm_arr, 0, sub_next)
    return adv, k_next, sub_next, block_end, dc_take, dc_diff, comp


@functools.partial(jax.jit, static_argnames=("max_steps", "unroll"))
def spec_scan_lanes(u32win, luts, comp_of_sub, tclass_of_sub,
                    bit0, bit_end, k0, sub0, bpm_arr,
                    max_steps: int, unroll: int = 1):
    """Speculative per-chunk Huffman scan — the self-synchronization
    pass of the DRI-less device decoder (Weißenberger & Schmidt-style
    subsequence decoding, adapted to the JPEG DC/AC/Y/C table state).

    Each lane decodes symbols from bit0 (entry state k0/sub0) until
    the first symbol boundary at-or-past bit_end, WITHOUT emitting
    coefficients.  Returns (exit_bit, exit_k, exit_sub, blk_cnt,
    dcsum[L,3]): completed-block count and per-component DC-diff sums
    over the decoded span (exact when the entry state was exact)."""
    L = bit0.shape[0]
    lut_flat = luts.reshape(-1)

    def cond(st):
        return jnp.any(~st[5]) & (st[6] < max_steps)

    def body(st):
        bitpos, k, sub, blk, dcs, done, step = st
        active = ~done
        adv, k_next, sub_next, block_end, dc_take, dc_diff, comp = \
            _spec_symbol_step(u32win, lut_flat, comp_of_sub,
                              tclass_of_sub, bpm_arr, bitpos, k, sub)
        dcs = dcs + (dc_diff * (dc_take & active))[:, None] \
            * jax.nn.one_hot(comp, 3, dtype=jnp.int32)
        bitpos = jnp.where(active, bitpos + adv, bitpos)
        k = jnp.where(active, k_next, k)
        sub = jnp.where(active, sub_next, sub)
        blk = blk + (block_end & active)
        done = done | (bitpos >= bit_end)
        return (bitpos, k, sub, blk, dcs, done, step + 1)

    done0 = bit0 >= bit_end
    st = (bit0.astype(jnp.int32), k0.astype(jnp.int32),
          sub0.astype(jnp.int32), jnp.zeros(L, jnp.int32),
          jnp.zeros((L, 3), jnp.int32), done0, jnp.int32(0))
    if unroll > 1:
        one = body

        def body(st):
            for _ in range(unroll):
                st = one(st)
            return st

    st = jax.lax.while_loop(cond, body, st)
    return st[0], st[1], st[2], st[3], st[4]


@functools.partial(jax.jit, static_argnames=("unroll",))
def spec_snap_lanes(u32win, luts, comp_of_sub, tclass_of_sub,
                    bit0, bit_end, bpm_arr, unroll: int = 16):
    """Record the first SNAP symbol-boundary states of each chunk's
    speculative decode (guessed block-aligned entry): the merge pass
    validates sync against this list instead of re-decoding whole
    chunks (the round-3 fixpoint did, costing ~10 full decodes).

    Returns (sbit, sk, ssub, sblk, sdc): (L, SNAP[, 3]) int32 views
    of one packed (L, SNAP, 7) snapshot array (a SINGLE scatter per
    symbol keeps the unrolled body compilable and the update cheap);
    unused slots keep sbit = -1.  The boundary BEFORE the first
    symbol and the exit boundary (first at-or-past bit_end) are
    included."""
    L = bit0.shape[0]
    lut_flat = luts.reshape(-1)
    rows = jnp.arange(L)

    def cond(st):
        return jnp.any(~st[6])

    def body(st):
        bitpos, k, sub, blk, dcs, snap, done, bidx = st
        active = ~done
        col = jnp.clip(bidx // SNAP_STRIDE, 0, SNAP - 1)
        w = active & (bidx % SNAP_STRIDE == 0) \
            & (bidx < SNAP * SNAP_STRIDE)
        rec = jnp.stack([bitpos, k, sub, blk,
                         dcs[:, 0], dcs[:, 1], dcs[:, 2]], axis=1)
        snap = snap.at[rows, col].set(
            jnp.where(w[:, None], rec, snap[rows, col]))
        bidx = bidx + active
        done = done | (bitpos >= bit_end) \
            | (bidx >= SNAP * SNAP_STRIDE)

        active = ~done
        adv, k_next, sub_next, block_end, dc_take, dc_diff, comp = \
            _spec_symbol_step(u32win, lut_flat, comp_of_sub,
                              tclass_of_sub, bpm_arr, bitpos, k, sub)
        dcs = dcs + (dc_diff * (dc_take & active))[:, None] \
            * jax.nn.one_hot(comp, 3, dtype=jnp.int32)
        bitpos = jnp.where(active, bitpos + adv, bitpos)
        k = jnp.where(active, k_next, k)
        sub = jnp.where(active, sub_next, sub)
        blk = blk + (block_end & active)
        return (bitpos, k, sub, blk, dcs, snap, done, bidx)

    z = jnp.zeros(L, jnp.int32)
    snap0 = jnp.full((L, SNAP, 7), -1, jnp.int32)
    st = (bit0.astype(jnp.int32), z, z, z,
          jnp.zeros((L, 3), jnp.int32), snap0,
          bit0 >= bit_end, z)
    if unroll > 1:
        one = body

        def body(st):
            for _ in range(unroll):
                st = one(st)
            return st

    st = jax.lax.while_loop(cond, body, st)
    snap = st[5]
    return (snap[:, :, 0], snap[:, :, 1], snap[:, :, 2],
            snap[:, :, 3], snap[:, :, 4:7])


@functools.partial(jax.jit, static_argnames=("unroll",))
def spec_merge_lanes(u32win, luts, comp_of_sub, tclass_of_sub,
                     ent_b, ent_k, ent_s, bpm_arr,
                     sbit, sk, ssub, sblk, sdc, unroll: int = 8):
    """Short re-decode from each lane's TRUE entry state (predecessor
    exit) until it merges with the lane's own snapshot list — the
    sync-validation pass.  At the merge boundary m, the lane's
    speculative pass-1 stream is the true stream, so its exit state
    is exact and the true span counts are:

        blk_total = blk2(entry->merge) + (blk1_exit - sblk[m])
        dcsum     = dc2(entry->merge)  + (dc1_exit  - sdc[m])

    Returns (matched, mblk, mdc3): per-lane merge success, and the
    entry->merge completed-block count / DC-diff sums."""
    L = ent_b.shape[0]
    lut_flat = luts.reshape(-1)

    def cond(st):
        return jnp.any(~st[7])

    def body(st):
        bitpos, k, sub, blk, dcs, matched, midx, done, steps = st
        active = ~done
        # boundary check against this lane's snapshot list
        hit = ((sbit == bitpos[:, None]) & (sk == k[:, None])
               & (ssub == sub[:, None]))
        any_hit = hit.any(axis=1)
        hidx = jnp.argmax(hit, axis=1).astype(jnp.int32)
        new_match = active & any_hit
        matched = matched | new_match
        midx = jnp.where(new_match, hidx, midx)
        done = done | new_match
        # fail when past the last recorded boundary without a merge
        maxbit = sbit.max(axis=1)
        done = done | (bitpos > maxbit) \
            | (steps > SNAP * SNAP_STRIDE + 16)

        active = ~done
        adv, k_next, sub_next, block_end, dc_take, dc_diff, comp = \
            _spec_symbol_step(u32win, lut_flat, comp_of_sub,
                              tclass_of_sub, bpm_arr, bitpos, k, sub)
        dcs = dcs + (dc_diff * (dc_take & active))[:, None] \
            * jax.nn.one_hot(comp, 3, dtype=jnp.int32)
        bitpos = jnp.where(active, bitpos + adv, bitpos)
        k = jnp.where(active, k_next, k)
        sub = jnp.where(active, sub_next, sub)
        blk = blk + (block_end & active)
        return (bitpos, k, sub, blk, dcs, matched, midx, done,
                steps + 1)

    z = jnp.zeros(L, jnp.int32)
    st = (ent_b.astype(jnp.int32), ent_k.astype(jnp.int32),
          ent_s.astype(jnp.int32), z, jnp.zeros((L, 3), jnp.int32),
          jnp.zeros(L, bool), z, jnp.zeros(L, bool), jnp.int32(0))
    if unroll > 1:
        one = body

        def body(st):
            for _ in range(unroll):
                st = one(st)
            return st

    st = jax.lax.while_loop(cond, body, st)
    return st[5], st[6], st[3], st[4]   # matched, midx, mblk, mdc


@functools.partial(jax.jit, static_argnames=(
    "bpm", "out_size", "blocks_per_img", "max_steps", "unroll"))
def spec_decode_full(u32win, luts, zz, comp_of_sub, tclass_of_sub,
                     bmap, bit0, bit_end, first, img_start, img_last,
                     img_base, bpm: int, out_size: int,
                     blocks_per_img: int, max_steps: int,
                     unroll: int = 1):
    """The whole speculative pipeline as ONE device launch:

      pass 0  snapshot the first SNAP boundary states per chunk
              (<= 64 symbols per lane),
      pass 1  full speculative scan -> per-chunk exit states,
      merge   short re-decode from each predecessor's exit until it
              meets the lane's own snapshot list — validates that
              every chunk self-synchronized, and corrects the span's
              block/DC-diff totals for the garbage prefix,
      emit    decode_lanes_bmap with absolute block indices and DC
              predictor bases from segmented prefix sums.

    Bin-serial work is ~2.05x the stream (pass 1 + emission); the
    round-3-tail fixpoint variant re-decoded everything per iteration
    (up to ~10x, measured 8.6 MP/s vs 376 for the DRI path in
    BENCH context — this design removes that).

    first: bool[L] marks each image's first lane (its entry state is
    ground truth); img_start/img_last: int32[L] index of the lane's
    image's first/last lane (for segmented prefix subtraction).
    Returns (flat int16 coeffs, ok flag — False when any chunk failed
    to merge or block totals do not reconcile; the caller must then
    fall back to the host path)."""
    bpm_arr = jnp.int32(bpm)
    zeros = jnp.zeros_like(bit0)
    rows = jnp.arange(bit0.shape[0])

    def shift(x, fill):
        return jnp.where(first, fill, jnp.roll(x, 1))

    sbit, sk, ssub, sblk, sdc = spec_snap_lanes(
        u32win, luts, comp_of_sub, tclass_of_sub, bit0, bit_end,
        bpm_arr)
    eb, ek, es, cnt1, dcs1 = spec_scan_lanes(
        u32win, luts, comp_of_sub, tclass_of_sub, bit0, bit_end,
        zeros, zeros, bpm_arr, max_steps, unroll)

    ent_b = shift(eb, bit0)
    ent_k = shift(ek, zeros)
    ent_s = shift(es, zeros)
    matched, midx, mblk, mdc = spec_merge_lanes(
        u32win, luts, comp_of_sub, tclass_of_sub, ent_b, ent_k,
        ent_s, bpm_arr, sbit, sk, ssub, sblk, sdc)
    ok = jnp.all(matched)

    # true span totals: entry->merge (pass 2) + merge->exit (pass 1
    # minus its garbage prefix, read off the snapshot at the merge)
    cnt = mblk + (cnt1 - sblk[rows, midx])
    dcs = mdc + (dcs1 - sdc[rows, midx])

    inc = jnp.cumsum(cnt)
    blk0g = inc - cnt
    blk0 = blk0g - blk0g[img_start]
    total = inc[img_last] - blk0g[img_start]
    ok = ok & jnp.all(total >= blocks_per_img) \
        & jnp.all(blk0 >= 0) & jnp.all(blk0 <= blocks_per_img)
    dexc = jnp.cumsum(dcs, axis=0) - dcs
    pred0 = dexc - dexc[img_start]

    flat, _steps = decode_lanes_bmap(
        u32win, luts, zz, comp_of_sub, tclass_of_sub, bmap,
        ent_b, blk0,
        jnp.full_like(blk0, blocks_per_img), img_base, bpm,
        out_size, max_steps, unroll,
        k0=ent_k, sub0=ent_s, pred0=pred0,
        bit_stop=eb)
    return flat, ok


def decode_coeffs_device_spec(datas, chunk_bytes: int = 1024,
                              max_steps: int = 1 << 22,
                              unroll: int = 1):
    """Device entropy decode for DRI-LESS baseline JPEGs — the
    self-sync speculative follow-up to decode_coeffs_device (which
    needs restart markers for its exact split points, jpg.c:562-573).
    See spec_decode_full for the snapshot/scan/merge/emit pipeline.

    Raises ValueError if any chunk failed to self-synchronize or the
    block totals do not reconcile (caller falls back to the host
    path).  Returns (flat int16 coeffs, js, consts, lanes)."""
    from ffpic_tpu import native
    from ffpic_tpu.formats import jpg

    js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    j0 = js[0]
    consts = prepare_frame(j0)
    luts = build_luts_from_dht(j0.dht_raw)
    bpm = consts["bpm"]
    blocks_per_img = consts["blocks_per_img"]

    bufs, offs = [], []
    off = 0
    for d in datas:
        buf, _bounds = native.jpeg_destuff(extract_scan(d))
        bufs.append(buf)
        offs.append(off)
        off += len(buf)
    concat = np.concatenate(bufs)

    # chunk table: per-lane absolute [bit0, bit_end) spans + image id.
    # The tail merges into the last chunk so every chunk is at least
    # ~half-size: a predecessor exit always lands strictly inside the
    # next chunk (merge entries assume entry < bit_end).
    bit0, bit_end, lane_img = [], [], []
    for i, buf in enumerate(bufs):
        n = len(buf)
        nch = max(1, n // chunk_bytes)
        for c in range(nch):
            b0 = (offs[i] + c * chunk_bytes) * 8
            b1 = (offs[i] + ((c + 1) * chunk_bytes
                             if c + 1 < nch else n)) * 8
            bit0.append(b0)
            bit_end.append(b1)
            lane_img.append(i)
    bit0 = np.array(bit0, np.int32)
    bit_end = np.array(bit_end, np.int32)
    lane_img = np.array(lane_img, np.int32)
    L = len(bit0)
    starts = np.searchsorted(lane_img, np.arange(len(datas)))
    lasts = np.concatenate([starts[1:], [L]]) - 1
    first = np.zeros(L, bool)
    first[starts] = True
    img_start = starts[lane_img].astype(np.int32)
    img_last = lasts[lane_img].astype(np.int32)
    img_base = (lane_img.astype(np.int64)
                * consts["comp_space"] * 64).astype(np.int32)
    out_size = len(datas) * consts["comp_space"] * 64 + 1

    flat, ok = spec_decode_full(
        jnp.asarray(sliding_u32(concat)), jnp.asarray(luts),
        jnp.asarray(np.asarray(ZIGZAG, np.int32)),
        jnp.asarray(consts["comp_of_sub"]),
        jnp.asarray(consts["tclass_of_sub"]),
        jnp.asarray(np.asarray(consts["bmap"])),
        jnp.asarray(bit0), jnp.asarray(bit_end), jnp.asarray(first),
        jnp.asarray(img_start), jnp.asarray(img_last),
        jnp.asarray(img_base), bpm, out_size, blocks_per_img,
        max_steps, unroll)
    if not bool(ok):
        raise ValueError(
            "speculative entropy decode: a chunk failed to "
            "self-synchronize or block totals do not reconcile — "
            "host path fallback")
    return flat, js, consts, L


def decode_batch_device_entropy_spec(datas, order="rgba", mode="bt601",
                                     chunk_bytes: int = 1024,
                                     unroll: int | None = None):
    """End-to-end DRI-less device decode: speculative self-sync
    entropy -> fused dequant|IDCT|upsample|color.  Returns uint8
    (N, H, W, 4) on device."""
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420

    if unroll is None:
        unroll = default_unroll()
    flat, js, consts, _lanes = decode_coeffs_device_spec(
        datas, chunk_bytes=chunk_bytes, unroll=unroll)
    j = js[0]
    y, u, v = assemble_planes(flat, len(datas), j)
    yq = jnp.asarray(np.stack(
        [jj.dqt[jj.comps[0].tq].reshape(8, 8) for jj in js])
        [:, None, None])
    cq = jnp.asarray(np.stack(
        [jj.dqt[jj.comps[1].tq].reshape(8, 8) for jj in js])
        [:, None, None])
    return decode_batch_420(y, u, v, yq, cq, order=order, mode=mode)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

def prepare_frame(j):
    """Per-geometry constants from a parsed JPEG (formats/jpg state):
    LUT stack, block map, lane tables.  Requires baseline 4:2:0-style
    interleaved scan with DRI."""
    from ffpic_tpu.ops.jpeg_kernels import mcu_block_map

    samplings = tuple((c.v, c.h) for c in j.comps)
    bpm = sum(v * h for v, h in samplings)
    comp_of_sub = []
    tclass_of_sub = []
    for ci, (v, h) in enumerate(samplings):
        comp_of_sub += [ci] * (v * h)
        tclass_of_sub += [0 if ci == 0 else 1] * (v * h)
    bmap = mcu_block_map(samplings, j.mcus_x, j.mcus_y)
    return {
        "bpm": bpm,
        "comp_of_sub": np.array(comp_of_sub, np.int32),
        "tclass_of_sub": np.array(tclass_of_sub, np.int32),
        "bmap": bmap,
        "blocks_per_img": j.mcus_x * j.mcus_y * bpm,
        "comp_space": sum((j.mcus_y * v) * (j.mcus_x * h)
                          for v, h in samplings),
    }


def build_luts_from_dht(dht: dict) -> np.ndarray:
    """(4, 65536) uint32 stack: DC-Y, AC-Y, DC-chroma, AC-chroma."""
    out = np.zeros((4, 65536), np.uint32)
    out[0] = build_lut16(*dht[(0, 0)], is_ac=False)
    out[1] = build_lut16(*dht[(1, 0)], is_ac=True)
    if (0, 1) in dht:
        out[2] = build_lut16(*dht[(0, 1)], is_ac=False)
        out[3] = build_lut16(*dht[(1, 1)], is_ac=True)
    else:
        out[2], out[3] = out[0], out[1]
    return out


def extract_scan(data: bytes) -> bytes:
    """Raw entropy-coded bytes of the first SOS scan."""
    from ffpic_tpu.formats.jpg import _find_scan_end
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xDA:
            ln = int.from_bytes(data[pos + 2:pos + 4], "big")
            start = pos + 2 + ln
            return data[start:_find_scan_end(data, start)]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        ln = int.from_bytes(data[pos + 2:pos + 4], "big")
        pos += 2 + ln
    raise ValueError("no SOS scan found")


def decode_coeffs_device(datas, max_steps: int = 1 << 22,
                         unroll: int = 1):
    """Full device-entropy path for a batch of same-geometry baseline
    JPEGs with restart intervals: host destuffs (SIMD memchr pass) and
    ships raw bytes; the device decodes Huffman + builds the dense
    coefficient tensors.

    Returns (coeff flat jnp.int16[(N * comp_space * 64) + 1], js,
    consts, steps) — feed through assemble_planes + decode_batch_420.
    """
    from ffpic_tpu import native
    from ffpic_tpu.formats import jpg

    js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    j0 = js[0]
    if j0.restart_interval <= 0:
        raise ValueError("device entropy path needs DRI > 0")
    consts = prepare_frame(j0)
    luts = build_luts_from_dht(j0.dht_raw)

    bufs, all_bounds = [], []
    off = 0
    offs = []
    for d in datas:
        buf, bounds = native.jpeg_destuff(extract_scan(d))
        bufs.append(buf)
        all_bounds.append(bounds)
        offs.append(off)
        off += len(buf)
    concat = np.concatenate(bufs)

    bpm = consts["bpm"]
    dri_blocks = j0.restart_interval * bpm
    blocks_per_img = consts["blocks_per_img"]
    bit0, blk0, blk_end, img_base = [], [], [], []
    for i, bounds in enumerate(all_bounds):
        n_segs = len(bounds) - 1
        for s in range(n_segs):
            bit0.append((offs[i] + bounds[s]) * 8)
            blk0.append(s * dri_blocks)
            blk_end.append(min((s + 1) * dri_blocks, blocks_per_img))
            img_base.append(i * consts["comp_space"] * 64)

    out_size = len(datas) * consts["comp_space"] * 64 + 1
    flat, steps = decode_lanes_bmap(
        jnp.asarray(sliding_u32(concat)), jnp.asarray(luts),
        jnp.asarray(np.asarray(ZIGZAG, np.int32)),
        jnp.asarray(consts["comp_of_sub"]),
        jnp.asarray(consts["tclass_of_sub"]),
        consts["bmap"],
        jnp.asarray(np.array(bit0, np.int32)),
        jnp.asarray(np.array(blk0, np.int32)),
        jnp.asarray(np.array(blk_end, np.int32)),
        jnp.asarray(np.array(img_base, np.int32)),
        bpm, out_size, max_steps, unroll)
    return flat, js, consts, steps


def decode_coeffs_device_mixed(datas, js, max_steps: int = 1 << 22,
                               unroll: int = 1):
    """ONE merged entropy launch for a MIXED batch of eligible DRI
    JPEGs — any sizes and any Huffman tables together (per-lane
    LUT-group + bmap-base indices); eligible() guarantees 4:2:0, so
    bpm and the sub-block maps are identical across members.  More
    lanes per launch is the throughput lever (the while-step cost is
    nearly flat in lane count — PARITY.md device-entropy notes).

    Returns (flat int16 coefficients, per-image flat offsets, steps).
    """
    from ffpic_tpu import native

    # unique Huffman table groups
    lut_list, lut_key_to_idx, img_lut = [], {}, []
    for j in js:
        key = tuple(sorted((k, bytes(c), bytes(s))
                           for k, (c, s) in j.dht_raw.items()))
        if key not in lut_key_to_idx:
            lut_key_to_idx[key] = len(lut_list)
            lut_list.append(build_luts_from_dht(j.dht_raw))
        img_lut.append(lut_key_to_idx[key])
    luts = np.concatenate(lut_list, axis=0)       # (G*4, 65536)

    # unique geometries -> shared consts + concatenated block maps
    geo_cache, img_consts = {}, []
    for j in js:
        gk = (j.mcus_x, j.mcus_y)
        if gk not in geo_cache:
            geo_cache[gk] = prepare_frame(j)
        img_consts.append(geo_cache[gk])
    c0 = img_consts[0]
    bmap_parts, bmap_off, off = [], {}, 0
    for gk, c in geo_cache.items():
        bmap_off[gk] = off
        arr = np.asarray(c["bmap"])
        bmap_parts.append(arr)
        off += arr.shape[0]
    bmap_all = np.concatenate(bmap_parts)

    bufs, all_bounds, offs = [], [], []
    boff = 0
    for d in datas:
        buf, bounds = native.jpeg_destuff(extract_scan(d))
        bufs.append(buf)
        all_bounds.append(bounds)
        offs.append(boff)
        boff += len(buf)
    concat = np.concatenate(bufs)

    bpm = c0["bpm"]
    bit0, blk0, blk_end, img_base = [], [], [], []
    lane_lut, lane_bbase, img_out_off = [], [], []
    out_off = 0
    for i, (j, bounds) in enumerate(zip(js, all_bounds)):
        cst = img_consts[i]
        img_out_off.append(out_off)
        dri_blocks = j.restart_interval * bpm
        for s in range(len(bounds) - 1):
            bit0.append((offs[i] + bounds[s]) * 8)
            blk0.append(s * dri_blocks)
            blk_end.append(min((s + 1) * dri_blocks,
                               cst["blocks_per_img"]))
            img_base.append(out_off)
            lane_lut.append(img_lut[i])
            lane_bbase.append(bmap_off[(j.mcus_x, j.mcus_y)])
        out_off += cst["comp_space"] * 64
    out_size = out_off + 1

    flat, steps = decode_lanes_bmap(
        jnp.asarray(sliding_u32(concat)), jnp.asarray(luts),
        jnp.asarray(np.asarray(ZIGZAG, np.int32)),
        jnp.asarray(c0["comp_of_sub"]),
        jnp.asarray(c0["tclass_of_sub"]),
        jnp.asarray(bmap_all),
        jnp.asarray(np.array(bit0, np.int32)),
        jnp.asarray(np.array(blk0, np.int32)),
        jnp.asarray(np.array(blk_end, np.int32)),
        jnp.asarray(np.array(img_base, np.int32)),
        bpm, out_size, max_steps, unroll,
        lut_idx=jnp.asarray(np.array(lane_lut, np.int32)),
        bmap_base=jnp.asarray(np.array(lane_bbase, np.int32)))
    return flat, img_out_off, steps


def decode_batch_dri_mixed(datas, js, order="rgba", mode="bt601",
                           unroll: int | None = None):
    """Mixed DRI batch: one merged entropy launch, then one fused
    dequant|IDCT|upsample|color launch per geometry group (the dense
    stage needs rectangular stacks).  Returns {image index: uint8
    (H_pad, W_pad, 4) device array}."""
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420

    if unroll is None:
        unroll = default_unroll()
    flat, img_off, _steps = decode_coeffs_device_mixed(
        datas, js, unroll=unroll)

    groups: dict = {}
    for i, j in enumerate(js):
        groups.setdefault((j.mcus_x, j.mcus_y), []).append(i)
    out = {}
    for gk, idxs in groups.items():
        j0 = js[idxs[0]]
        comp_space = sum(c.nby * c.nbx for c in j0.comps)
        secs = [jax.lax.dynamic_slice(flat, (img_off[i],),
                                      (comp_space * 64,))
                for i in idxs]
        body = jnp.stack(secs)
        planes, base = [], 0
        for c in j0.comps:
            planes.append(
                body[:, base * 64:(base + c.nby * c.nbx) * 64]
                .reshape(len(idxs), c.nby, c.nbx, 8, 8))
            base += c.nby * c.nbx
        y, u, v = planes
        yq = jnp.asarray(np.stack(
            [js[i].dqt[js[i].comps[0].tq].reshape(8, 8)
             for i in idxs])[:, None, None])
        cq = jnp.asarray(np.stack(
            [js[i].dqt[js[i].comps[1].tq].reshape(8, 8)
             for i in idxs])[:, None, None])
        res = decode_batch_420(y, u, v, yq, cq, order=order, mode=mode)
        for k, i in enumerate(idxs):
            out[i] = res[k]
    return out


def assemble_planes(flat, n_imgs: int, j):
    """Split the kernel's flat output into per-component coefficient
    tensors (N, nby, nbx, 8, 8) — device-side reshapes only."""
    comp_space = 0
    spans = []
    for c in j.comps:
        spans.append((comp_space, c.nby, c.nbx))
        comp_space += c.nby * c.nbx
    body = flat[:-1].reshape(n_imgs, comp_space * 64)
    outs = []
    for (base, nby, nbx) in spans:
        outs.append(body[:, base * 64:(base + nby * nbx) * 64]
                    .reshape(n_imgs, nby, nbx, 8, 8))
    return outs


def decode_batch_device_entropy(datas, order="rgba", mode="bt601",
                                unroll: int = 1):
    """End-to-end: device entropy decode -> fused dequant|IDCT|
    upsample|color.  Returns uint8 (N, H, W, 4) on device."""
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420

    flat, js, consts, _steps = decode_coeffs_device(datas,
                                                    unroll=unroll)
    j = js[0]
    y, u, v = assemble_planes(flat, len(datas), j)
    yq = jnp.asarray(j.dqt[j.comps[0].tq].reshape(8, 8))
    cq = jnp.asarray(j.dqt[j.comps[1].tq].reshape(8, 8))
    return decode_batch_420(y, u, v, yq, cq, order=order, mode=mode)


def eligible(j) -> bool:
    """Can this parsed JPEG take the device-entropy path?  Baseline
    8-bit single interleaved 4:2:0 scan with restart intervals."""
    return (j.restart_interval > 0 and j.mode == "baseline"
            and j.precision == 8 and len(j.comps) == 3
            and [(c.v, c.h) for c in j.comps]
            == [(2, 2), (1, 1), (1, 1)]
            and len(j.scans) == 1
            and len(j.scans[0].get("comps", ())) == 3)


def spec_eligible(j) -> bool:
    """Same scan shape as eligible() but WITHOUT restart markers —
    the self-sync speculative path's domain."""
    return (j.restart_interval == 0 and j.mode == "baseline"
            and j.precision == 8 and len(j.comps) == 3
            and [(c.v, c.h) for c in j.comps]
            == [(2, 2), (1, 1), (1, 1)]
            and len(j.scans) == 1
            and len(j.scans[0].get("comps", ())) == 3)


def spec_group_key(j) -> tuple:
    """Spec batches share one LUT stack + geometry (decode_coeffs_
    device_spec builds consts from js[0]): bucket on both."""
    dht = tuple(sorted((k, bytes(c), bytes(s))
                       for k, (c, s) in j.dht_raw.items()))
    return (j.mcus_x, j.mcus_y, dht)


def decode_batch_spec(datas, js, order="rgba", mode="bt601",
                      chunk_bytes: int = 4096,
                      unroll: int | None = None):
    """Batched decode for same-(geometry, tables) DRI-LESS JPEGs via
    the speculative device entropy path, with PER-IMAGE quant tables.
    Raises ValueError when the self-sync fixpoint cannot be verified
    (caller falls back to the host path).  Returns uint8
    (N, H, W, 4) on device (padded dims)."""
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420

    if unroll is None:
        unroll = default_unroll()
    flat, js2, consts, _lanes = decode_coeffs_device_spec(
        datas, chunk_bytes=chunk_bytes, unroll=unroll)
    j = js2[0]
    y, u, v = assemble_planes(flat, len(datas), j)
    yq = jnp.asarray(np.stack(
        [jj.dqt[jj.comps[0].tq].reshape(8, 8) for jj in js])
        [:, None, None])
    cq = jnp.asarray(np.stack(
        [jj.dqt[jj.comps[1].tq].reshape(8, 8) for jj in js])
        [:, None, None])
    return decode_batch_420(y, u, v, yq, cq, order=order, mode=mode)


def group_key(j) -> tuple:
    """Bucket key: geometry + huffman tables + DRI (quant tables may
    differ per image — they ride along per-image)."""
    dht = tuple(sorted((k, bytes(c), bytes(s))
                       for k, (c, s) in j.dht_raw.items()))
    return (j.mcus_x, j.mcus_y, j.restart_interval, dht)


def decode_batch_dri(datas, js, order="rgba", mode="bt601",
                     unroll: int | None = None):
    """Production batched decode for same-key DRI JPEGs: device-side
    entropy + fused dequant|IDCT|upsample|color with PER-IMAGE quant
    tables.  Returns uint8 (N, H, W, 4) on device (padded dims)."""
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420

    if unroll is None:
        unroll = default_unroll()
    flat, js2, consts, _steps = decode_coeffs_device(
        datas, unroll=unroll)
    j = js2[0]
    y, u, v = assemble_planes(flat, len(datas), j)
    yq = jnp.asarray(np.stack(
        [jj.dqt[jj.comps[0].tq].reshape(8, 8) for jj in js])
        [:, None, None])
    cq = jnp.asarray(np.stack(
        [jj.dqt[jj.comps[1].tq].reshape(8, 8) for jj in js])
        [:, None, None])
    return decode_batch_420(y, u, v, yq, cq, order=order, mode=mode)
