"""Smoke test of the decode path on one NVIDIA GPU.

Drives the entry points users call (``ffpic_tpu.load`` and
``ffpic_tpu.decode_batch``) once at real sizes, compares every output
with a plain reference, and prints one JSON object as the last line:

    python chip_smoke.py [--seed N]     # one card, phases 1-7
    python chip_smoke.py --multi        # decode_batch(mesh=) on 4 cards

Inputs are minted from --seed with numpy and the repo's own encoders,
plus the three files under tests/data/ that those encoders cannot
write.  Each phase prints one line of results.  Any failure raises, so
the script exits non-zero and prints no result line; without a GPU it
fails in phase 1.  Everything runs in this one process (a JAX process
reserves most of the card's memory); only nvidia-smi runs as a child.

Tolerances (the observed maximum and the share of exact pixels are
printed for every comparison):
  * integer stages are exact: JPEG dequant+IDCT (int32 wrap, int16
    stores), chroma upsampling, PNG unfilter, HEVC residuals through
    _exact_matmul_i16, VP8 IDCT/WHT;
  * the float32 colour stage may differ from the float64 reference by
    COLOR_LSB: XLA:GPU may contract `y + 1.402*v + 0.5` into an FMA
    before floor/trunc, which moves exact .5 ties;
  * bilinear resize may differ from the same resize on the CPU backend
    by RESIZE_LSB.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

EXACT = 0
COLOR_LSB = 1
RESIZE_LSB = 1
MIN_PSNR_DB = 24.0      # lossy codecs vs their synthetic source

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tests", "data")
DRI_JPEG = os.path.join(DATA, "jpeg_1088p_420_q85_dri.jpg")
LOSSY_WEBP = (os.path.join(DATA, "webp_512_lossy.webp"), 102)
AVIF = (os.path.join(DATA, "avif_512.avif"), 103)
RESIZE = (224, 224)

DEVICE_KNOBS = ("FFPIC_DEVICE_ENTROPY", "FFPIC_HYBRID", "FFPIC_HEVC_DEVICE",
                "FFPIC_VP8_DEVICE", "FFPIC_VP8_DEVICE_COLOR",
                "FFPIC_HEIF_DEVICE_COLOR", "FFPIC_HOST_COLOR",
                "FFPIC_SPEC_ENTROPY")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_T0 = time.perf_counter()


def report(phase: str, fields: dict) -> None:
    fields = {**fields, "elapsed_s": time.perf_counter() - _T0}
    print(f"[{phase}] {json.dumps(fields, default=str)}", flush=True)


@contextlib.contextmanager
def env(**kv):
    """Set (value) or clear (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def host_only():
    """No device stage beyond what a format always runs there."""
    return env(**{k: None for k in DEVICE_KNOBS})


def compare(name: str, got, want, tol: int) -> dict:
    """Max |got - want| over uint8 images; raises above tol."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    per_px = d.max(axis=-1) if d.ndim >= 3 else d
    res = {"name": name, "max": int(d.max()) if d.size else 0,
           "tol": tol, "exact_px": float((per_px == 0).mean())}
    if res["max"] > tol:
        raise AssertionError(f"{name}: max |diff| {res['max']} > {tol} "
                             f"(exact share {res['exact_px']:.6f})")
    return res


def psnr(got, src) -> float:
    err = np.mean((np.asarray(got)[..., :3].astype(np.float64)
                   - np.asarray(src)[..., :3].astype(np.float64)) ** 2)
    return float("inf") if err == 0 else 10 * np.log10(255.0 ** 2 / err)


def block(x):
    import jax
    return jax.block_until_ready(x)


def timed(fn):
    """(result, seconds) with the result ready on the device."""
    t0 = time.perf_counter()
    out = block(fn())
    return out, time.perf_counter() - t0


def cpu_resize(img, size=RESIZE):
    """The same bilinear resize on the CPU backend (resize reference)."""
    import jax
    import jax.numpy as jnp
    from ffpic_tpu.ops.resize import resize_rgba
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(resize_rgba(jnp.asarray(np.asarray(img)),
                                      tuple(size), "bilinear"))


def write(tmp: str, name: str, data: bytes) -> str:
    path = os.path.join(tmp, name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------------------
# inputs and references
# ---------------------------------------------------------------------------

def mint_jpeg(h: int, w: int, seed: int, quality: int = 85) -> bytes:
    """Baseline 4:2:0 JPEG from the repo's encoder."""
    from ffpic_tpu.formats.jpg_encode import encode_baseline
    from ffpic_tpu.formats.pic import Pic
    from ffpic_tpu.utils.synth import synth_rgba
    return encode_baseline(Pic(pixels=synth_rgba(h, w, seed), width=w,
                               height=h), quality=quality)


def mint_jpegs(tmp: str, n: int, h: int, w: int, seed: int,
               distinct: int) -> list[str]:
    """n paths over `distinct` minted images (encoding is host Python,
    so a batch repeats a few images)."""
    paths = [write(tmp, f"jpeg_{h}x{w}_{i}.jpg",
                   mint_jpeg(h, w, seed + i)) for i in range(distinct)]
    return [paths[i % distinct] for i in range(n)]


def png_sub_up(rgba: np.ndarray) -> bytes:
    """RGBA PNG whose rows alternate the Sub and Up filters, the two
    the device unfilter (ops/png_kernels.unfilter_device_subup) takes.
    png.encode picks filters adaptively and mostly writes Paeth."""
    h, w = rgba.shape[:2]
    px = rgba.reshape(h, w * 4).astype(np.int32)
    left = np.zeros_like(px)
    left[:, 4:] = px[:, :-4]
    up = np.zeros_like(px)
    up[1:] = px[:-1]
    ftype = np.where(np.arange(h) % 2 == 0, 1, 2)      # 1 Sub, 2 Up
    body = np.where((ftype == 1)[:, None], px - left, px - up) & 255
    rows = np.concatenate([ftype[:, None], body], axis=1).astype(np.uint8)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def jpeg_reference(data: bytes) -> np.ndarray:
    """numpy-only decode of a baseline 4:2:0 JPEG: host-decoded dense
    coefficients -> golden dequant + idct8x8_16 -> 2x nearest chroma
    upsample -> BT.601 colour in float64 with round-half-up.  No JAX."""
    from ffpic_tpu.formats import jpg
    from ffpic_tpu.ops import golden
    j, _ = jpg.parse_and_decode(data)
    if not j.coeffs_raster or len(j.comps) != 3:
        raise ValueError("reference needs native 3-component coefficients")
    planes = []
    for c, coef in zip(j.comps, j.coeffs):
        q = np.asarray(j.dqt[c.tq]).reshape(8, 8)
        s = golden.idct8x8_16(golden.dequant(
            coef.reshape(c.nby, c.nbx, 8, 8), q))
        planes.append(s.transpose(0, 2, 1, 3)
                      .reshape(c.nby * 8, c.nbx * 8).astype(np.float64))
    y, u, v = planes
    hh, ww = y.shape
    u = np.repeat(np.repeat(u, 2, 0), 2, 1)[:hh, :ww] - 128.0
    v = np.repeat(np.repeat(v, 2, 0), 2, 1)[:hh, :ww] - 128.0
    r = np.floor(y + 1.402 * v + 0.5)
    g = np.floor(y - 0.344136 * u - 0.714136 * v + 0.5)
    b = np.floor(y + 1.772 * u + 0.5)
    rgba = np.stack([r, g, b, np.full_like(y, 255.0)], axis=-1)
    return np.clip(rgba, 0, 255).astype(np.uint8)[:j.height, :j.width]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    """1. A GPU or nothing; the card's name and power limit."""
    from ffpic_tpu import runtime
    devs = runtime.require_gpu()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    out = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    report("1 device", out)
    print(smi.stdout.strip(), flush=True)
    return out


def phase_native() -> dict:
    """2. The C host decoders built and loaded (no silent Python)."""
    from ffpic_tpu import native
    if not native.available():
        raise RuntimeError("native host library failed to build or load")
    out = {"native": True, "library": native._lib._name}
    report("2 native", out)
    return out


def phase_jpeg_batch(tmp: str, seed: int, n: int = 32, h: int = 1088,
                     w: int = 1920, distinct: int = 4) -> dict:
    """3. Training-input batch: n baseline 4:2:0 q85 JPEGs through
    decode_batch, unresized and at RESIZE, against jpeg_reference."""
    import ffpic_tpu
    from ffpic_tpu.utils import trace
    t0 = time.perf_counter()
    paths = mint_jpegs(tmp, n, h, w, seed, distinct)
    mint_s = time.perf_counter() - t0

    trace.enable()
    trace.reset()
    full, first_s = timed(lambda: ffpic_tpu.decode_batch(paths))
    paths_full = trace.counts()
    trace.reset()
    small, first_small_s = timed(
        lambda: ffpic_tpu.decode_batch(paths, size=RESIZE))
    paths_small = trace.counts()
    trace.enable(False)
    want = {"decode_batch.bucket.packed_fused": 1}
    if paths_full != want or paths_small != want:
        raise AssertionError(f"staging paths {paths_full} / {paths_small}"
                             f", expected {want}")
    _, warm_s = timed(lambda: ffpic_tpu.decode_batch(paths))

    full = np.asarray(full)
    small = np.asarray(small)
    if full.shape != (n, h, w, 4) or small.shape != (n, *RESIZE, 4):
        raise AssertionError(f"shapes {full.shape} {small.shape}")
    cmps = []
    for i in range(distinct):
        with open(paths[i], "rb") as f:
            ref = jpeg_reference(f.read())
        cmps.append(compare(f"jpeg{i} vs numpy", full[i], ref, COLOR_LSB))
        cmps.append(compare(f"jpeg{i} resized vs cpu", small[i],
                            cpu_resize(full[i]), RESIZE_LSB))
    for i in range(distinct, n):
        if not np.array_equal(full[i], full[i % distinct]):
            raise AssertionError(f"batch member {i} differs from its copy")
    out = {"n": n, "hw": [h, w], "mp": n * h * w / 1e6,
           "paths": paths_full, "mint_s": mint_s, "setup_s": first_s,
           "setup_resize_s": first_small_s, "warm_s": warm_s,
           "compare": cmps}
    report("3 jpeg_batch", out)
    out["files"] = paths
    return out


def phase_device_entropy(n: int = 32, reps: int = 3, unrolls=(2, 8, 64),
                         path: str = DRI_JPEG) -> dict:
    """4. Device entropy decode of n copies of a restart-marker JPEG:
    host only, device only and the hybrid split, timed after warm-up;
    then the entropy launch at each unroll."""
    import ffpic_tpu
    from ffpic_tpu.formats import jpg
    from ffpic_tpu.ops import jpeg_entropy_device as jed
    from ffpic_tpu.utils import trace
    paths = [path] * n
    settings = {
        "host": {"FFPIC_DEVICE_ENTROPY": "0"},
        "device": {"FFPIC_DEVICE_ENTROPY": "1", "FFPIC_HYBRID": "0"},
        "hybrid": {"FFPIC_DEVICE_ENTROPY": "1", "FFPIC_HYBRID": None},
    }
    expect_dev = {"host": 0, "device": n, "hybrid": max(4, round(n / 2))}
    outs, times, setup, dev_done = {}, {}, {}, {}
    trace.enable()
    for name, kv in settings.items():
        with host_only(), env(**kv):
            trace.reset()
            outs[name], setup[name] = timed(
                lambda: ffpic_tpu.decode_batch(paths))
            dev_done[name] = trace.counts().get(
                "decode_batch.device_entropy", 0)
            times[name] = [timed(lambda: ffpic_tpu.decode_batch(paths))[1]
                           for _ in range(reps)]
    trace.enable(False)
    if dev_done != expect_dev:
        raise AssertionError(f"images decoded on the device {dev_done}, "
                             f"expected {expect_dev}")
    host = np.asarray(outs["host"])
    cmps = [compare(f"{k} vs host", outs[k], host, EXACT)
            for k in ("device", "hybrid")]
    with open(path, "rb") as f:
        data = f.read()
    cmps.append(compare("host vs numpy", host[0], jpeg_reference(data),
                        COLOR_LSB))

    js = [jpg.parse_and_decode(data, skip_decode=True)[0]] * n
    unroll_s, unroll_setup = {}, {}
    for u in unrolls:
        def run():
            return list(jed.decode_batch_dri_mixed([data] * n, js,
                                                   unroll=u).values())
        res, unroll_setup[u] = timed(run)
        unroll_s[u] = [timed(run)[1] for _ in range(reps)]
        got = np.stack([np.asarray(r)[:js[0].height, :js[0].width]
                        for r in res])
        cmps.append(compare(f"unroll {u} vs host", got, host, EXACT))
    out = {"n": n, "device_images": dev_done, "seconds": times,
           "setup_s": setup, "unroll_seconds": unroll_s,
           "unroll_setup_s": unroll_setup,
           "default_unroll": jed.default_unroll(), "compare": cmps}
    report("4 device_entropy", out)
    return out


def mixed_inputs(tmp: str, seed: int, png_hw=(1080, 1920),
                 webp_hw=(512, 512), heic_hw=(1536, 2048),
                 heic_tile: int = 512) -> list:
    """Mixed-format members: (name, path, source RGBA, tol of
    load vs its host reference).  PNG and lossless WebP round-trip
    exactly to their source; lossy members are checked for PSNR."""
    from ffpic_tpu.formats.heif_enc import encode_heif
    from ffpic_tpu.formats.pic import Pic
    from ffpic_tpu.formats.vp8l_enc import encode_webp_lossless
    from ffpic_tpu.utils.synth import synth_rgb, synth_rgba
    png_src = synth_rgba(*png_hw, seed=seed + 10, alpha=True)
    webp_src = synth_rgba(*webp_hw, seed=seed + 11)
    heic_src = synth_rgba(*heic_hw, seed=seed + 12)
    return [
        ("png", write(tmp, "mixed.png", png_sub_up(png_src)), png_src,
         EXACT),
        ("webp_lossless", write(tmp, "mixed_ll.webp",
                                encode_webp_lossless(webp_src)),
         webp_src, EXACT),
        ("webp_lossy", LOSSY_WEBP[0],
         synth_rgb(512, 512, seed=LOSSY_WEBP[1]), COLOR_LSB),
        ("heic", write(tmp, "mixed.heic", encode_heif(
            Pic(pixels=heic_src, width=heic_hw[1], height=heic_hw[0]),
            quality=50, tile=heic_tile)), heic_src, COLOR_LSB),
        ("avif", AVIF[0], synth_rgb(512, 512, seed=AVIF[1]), EXACT),
    ]


def host_reference(name: str, path: str, src) -> np.ndarray:
    """The same file decoded on the host with the device stages off:
    the source itself for the lossless members, else a host decode
    with numpy colour conversion where the format has one."""
    from ffpic_tpu.formats import registry
    if name in ("png", "webp_lossless"):
        return src
    with host_only(), env(FFPIC_HOST_COLOR="1"):
        return registry.load(path).np_pixels()


def phase_mixed_load(items: list) -> dict:
    """5. Each member through ffpic_tpu.load and through
    decode_batch(size=RESIZE), against its host reference."""
    import ffpic_tpu
    cmps, psnrs, loaded = [], {}, {}
    t0 = time.perf_counter()
    with host_only():
        for name, path, src, tol in items:
            got = ffpic_tpu.load(path).np_pixels()
            loaded[name] = got
            cmps.append(compare(f"{name} load vs host", got,
                                host_reference(name, path, src), tol))
            if src is not None:
                psnrs[name] = psnr(got, src)
                if psnrs[name] < MIN_PSNR_DB:
                    raise AssertionError(f"{name}: PSNR {psnrs[name]:.2f}"
                                         f" dB vs its source")
        load_s = time.perf_counter() - t0
        batch, batch_s = timed(lambda: ffpic_tpu.decode_batch(
            [p for _n, p, _s, _t in items], size=RESIZE))
    batch = np.asarray(batch)
    for k, (name, _p, _s, _t) in enumerate(items):
        cmps.append(compare(f"{name} decode_batch vs cpu resize", batch[k],
                            cpu_resize(loaded[name]), RESIZE_LSB))
    out = {"members": [(n, list(loaded[n].shape)) for n, *_ in items],
           "psnr_db": psnrs, "load_s": load_s, "setup_batch_s": batch_s,
           "compare": cmps}
    report("5 mixed_load", out)
    out["loaded"] = loaded
    return out


def phase_opt_in(items: list, loaded: dict) -> dict:
    """6. Opt-in device paths a user can reach, each against the
    default host output of phase 5."""
    import ffpic_tpu
    paths = {n: p for n, p, _s, _t in items}
    runs = [("FFPIC_HEVC_DEVICE", "heic", EXACT),
            ("FFPIC_VP8_DEVICE", "webp_lossy", EXACT),
            ("FFPIC_VP8_DEVICE_COLOR", "webp_lossy", EXACT),
            ("FFPIC_HEIF_DEVICE_COLOR", "heic", COLOR_LSB)]
    cmps, setup = [], {}
    for var, name, tol in runs:
        if name not in paths:
            continue
        with host_only(), env(**{var: "1"}):
            pic, setup[var] = timed(lambda: ffpic_tpu.load(paths[name]))
            cmps.append(compare(f"{var} {name}", pic.np_pixels(),
                                loaded[name], tol))
    out = {"setup_s": setup, "compare": cmps}
    report("6 opt_in", out)
    return out


def phase_memory(paths: list, setup: dict) -> dict:
    """7. Compiled memory of phase 3's batch-decode step at its shapes,
    the device's peak bytes in use, and each phase's set-up time."""
    import jax
    import jax.numpy as jnp
    from ffpic_tpu.formats import jpg
    from ffpic_tpu.ops.jpeg_kernels import (decode_batch_420_packed_fused,
                                            stack_packed_fused)
    packed = []
    for p in paths:
        with open(p, "rb") as f:
            jj, _ = jpg.parse_and_decode(f.read(), packed=True)
        c, k, v, nnz = jj.packed
        packed.append((np.array(c), np.array(k), np.array(v), nnz))
    n = len(paths)
    buf, g, e = stack_packed_fused(packed)
    shapes = tuple((c.nby, c.nbx) for c in jj.comps)
    q = jax.ShapeDtypeStruct((n, 1, 1, 8, 8), jnp.int32)
    t0 = time.perf_counter()
    compiled = decode_batch_420_packed_fused.lower(
        jax.ShapeDtypeStruct(buf.shape, buf.dtype),
        jpg.packed_block_map(jj), q, q, n, g, e, shapes,
        order="rgba", mode="bt601").compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
    stats = jax.devices()[0].memory_stats() or {}
    out = {"decode_batch_420_packed_fused": mem, "compile_s": compile_s,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
           "bytes_limit": stats.get("bytes_limit"), "setup_s": setup}
    report("7 memory", out)
    return out


def phase_multi(tmp: str, seed: int, devices, sizes=(32, 30),
                h: int = 1088, w: int = 1920, distinct: int = 4) -> dict:
    """--multi: decode_batch(mesh=) over a (len(devices), 1) mesh and
    sharded_decode_420 on the same coefficients, each bit-equal to the
    one-card result, including a ragged batch."""
    import jax
    import jax.numpy as jnp
    import ffpic_tpu
    from ffpic_tpu.formats import jpg
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420
    from ffpic_tpu.parallel.mesh import make_mesh, sharded_decode_420
    mesh = make_mesh(devices=list(devices))
    paths = mint_jpegs(tmp, max(sizes), h, w, seed, distinct)
    cmps, shards = [], {}
    for n in sizes:
        ps = paths[:n]
        one = np.asarray(ffpic_tpu.decode_batch(ps))
        sh = block(ffpic_tpu.decode_batch(ps, mesh=mesh))
        shards[f"decode_batch n={n}"] = sorted(
            {str(s.device) for s in sh.addressable_shards})
        cmps.append(compare(f"decode_batch mesh n={n}", sh, one, EXACT))

        js = []
        for p in ps:
            with open(p, "rb") as f:
                js.append(jpg.parse_and_decode(f.read())[0])
        coef = [np.stack([j.coeffs[c].reshape(j.comps[c].nby,
                                                 j.comps[c].nbx, 8, 8)
                          for j in js]) for c in range(3)]
        yq, cq = (np.stack([j.dqt[j.comps[c].tq].reshape(8, 8)
                            for j in js])[:, None, None] for c in (0, 1))
        sd = block(sharded_decode_420(mesh, *coef, yq, cq, order="rgba",
                                      mode="bt601"))
        shards[f"sharded_decode_420 n={n}"] = sorted(
            {str(s.device) for s in sd.addressable_shards})
        single = decode_batch_420(*(jnp.asarray(a) for a in coef),
                                  jnp.asarray(yq), jnp.asarray(cq),
                                  order="rgba", mode="bt601")
        cmps.append(compare(f"sharded_decode_420 n={n}", sd, single, EXACT))
    out = {"mesh": dict(mesh.shape), "shard_devices": shards,
           "compare": cmps}
    report("multi", out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="only the mesh path over 4 cards")
    args = ap.parse_args(argv)

    from ffpic_tpu import runtime
    runtime.setup_compile_cache()
    dev = phase_device()
    phase_native()
    with tempfile.TemporaryDirectory() as tmp:
        if args.multi:
            import jax
            if len(jax.devices()) < 4:
                raise RuntimeError(f"--multi needs 4 GPUs, found "
                                   f"{len(jax.devices())}")
            phase_multi(tmp, args.seed, jax.devices()[:4])
        else:
            setup = {}
            r3 = phase_jpeg_batch(tmp, args.seed)
            setup["3 jpeg_batch"] = r3["setup_s"]
            r4 = phase_device_entropy()
            setup["4 device_entropy"] = r4["setup_s"]
            items = mixed_inputs(tmp, args.seed)
            r5 = phase_mixed_load(items)
            setup["5 mixed_load"] = r5["setup_batch_s"]
            r6 = phase_opt_in(items, r5["loaded"])
            setup["6 opt_in"] = r6["setup_s"]
            phase_memory(r3["files"], setup)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
