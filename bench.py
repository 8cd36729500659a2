"""Benchmark: 1080p baseline JPEG decode on one NVIDIA GPU.

Prints the card's name and power limit, then ONE JSON line:
  metric/value/unit/vs_baseline — end-to-end decode MP/s of the fastest
  production JPEG path (host entropy + device dequant|IDCT|upsample|
  color), against the BASELINE.json north star of 2000 MP/s,
plus one MP/s key per row (stage breakdown, other formats, opt-in
device paths).  Each row is warmed once, then timed ROUNDS times
round-robin; the best time counts.  Fails without a GPU: no row is
ever measured on the CPU.

Inputs are minted with the repo's own encoders, plus the committed
files under tests/data/.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

H, W = 1088, 1920          # MCU-aligned 1080p-class frame
BATCH = 8
ITERS = 20
BASELINE_MPS = 2000.0
ROUNDS = int(os.environ.get("FFPIC_BENCH_ROUNDS", "5"))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tests", "data")


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ffpic_tpu import runtime
    runtime.setup_compile_cache()
    devs = runtime.require_gpu()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())

    import ffpic_tpu
    from ffpic_tpu.formats import jpg
    from ffpic_tpu.formats.heif_enc import encode_heif
    from ffpic_tpu.formats.jpg_encode import encode_baseline
    from ffpic_tpu.formats.pic import Pic
    from ffpic_tpu.ops import jpeg_entropy_device as jed
    from ffpic_tpu.ops.jpeg_kernels import (
        decode_batch_420, decode_batch_420_packed_fused,
        decode_frame_420_packed_fused, fuse_packed, stack_packed_fused)
    from ffpic_tpu.utils.synth import synth_rgba

    if os.environ.get("FFPIC_TRACE"):
        from ffpic_tpu.utils import trace
        trace.enable()

    data = encode_baseline(Pic(pixels=synth_rgba(H, W, seed=42), width=W,
                               height=H), quality=85)
    with open(os.path.join(DATA, "jpeg_1088p_420_q85_dri.jpg"), "rb") as f:
        ddata = f.read()
    with open(os.path.join(DATA, "webp_512_lossy.webp"), "rb") as f:
        wdata = f.read()
    with open(os.path.join(DATA, "avif_512.avif"), "rb") as f:
        adata = f.read()
    hdata = encode_heif(Pic(pixels=synth_rgba(1024, 1024, seed=43),
                            width=1024, height=1024), quality=50, tile=512)

    trials = {}     # name -> (fn returning seconds, MP per call)
    mp = H * W / 1e6

    def register(name, fn, mp_per_call):
        _log(f"warming {name}")
        fn()
        trials[name] = (fn, mp_per_call)

    def per_call(fn, k=1):
        def trial():
            t0 = time.perf_counter()
            for _ in range(k):
                jax.block_until_ready(fn())
            return (time.perf_counter() - t0) / k
        return trial

    # ---- host entropy stage ------------------------------------------
    j, _ = jpg.parse_and_decode(data)
    register("host_entropy", per_call(lambda: jpg.parse_and_decode(data),
                                      6), mp)
    register("host_entropy_packed", per_call(
        lambda: jpg.parse_and_decode(data, packed=True), 6), mp)

    yq = j.dqt[j.comps[0].tq].reshape(8, 8)
    cq = j.dqt[j.comps[1].tq].reshape(8, 8)
    yq_d, cq_d = jnp.asarray(yq), jnp.asarray(cq)

    # ---- packed host entropy -> one uint8 transfer -> fused launch ---
    jp, _ = jpg.parse_and_decode(data, packed=True)
    shapes = tuple((c.nby, c.nbx) for c in jp.comps)
    bmap = jpg.packed_block_map(jp)

    def e2e_packed():
        jj, _ = jpg.parse_and_decode(data, packed=True)
        c_, k_, v_, _n = jj.packed
        return decode_frame_420_packed_fused(
            jnp.asarray(fuse_packed(c_, k_, v_)), bmap, yq_d, cq_d,
            len(c_), len(k_), shapes)
    register("e2e_packed", per_call(e2e_packed, 12), mp)

    # ---- batched packed staging (production decode_batch shape) ------
    yqs = jnp.asarray(np.broadcast_to(yq, (BATCH, 1, 1, 8, 8)))
    cqs = jnp.asarray(np.broadcast_to(cq, (BATCH, 1, 1, 8, 8)))

    def e2e_batch():
        pl = []
        for _ in range(BATCH):
            jj, _ = jpg.parse_and_decode(data, packed=True)
            c_, k_, v_, nnz_ = jj.packed
            pl.append((np.array(c_), np.array(k_), np.array(v_), nnz_))
        buf, g_, e_ = stack_packed_fused(pl)
        return decode_batch_420_packed_fused(
            jnp.asarray(buf), bmap, yqs, cqs, BATCH, g_, e_, shapes)
    register("e2e_batch", per_call(e2e_batch), BATCH * mp)

    # ---- device pipeline stage (coefficients pre-staged) -------------
    coefs = [jnp.asarray(np.broadcast_to(
        c.reshape(cc.nby, cc.nbx, 8, 8), (BATCH, cc.nby, cc.nbx, 8, 8))
        .copy()) for c, cc in zip(j.coeffs, j.comps)]
    register("device_pipeline", per_call(
        lambda: decode_batch_420(*coefs, yq_d, cq_d), ITERS), BATCH * mp)

    # ---- device-side entropy decode over DRI split points ------------
    dlist = [ddata] * BATCH
    register("device_entropy_dri", per_call(
        lambda: jed.decode_batch_device_entropy(
            dlist, unroll=jed.default_unroll())), BATCH * mp)
    register("decode_batch_dri", per_call(
        lambda: ffpic_tpu.decode_batch(dlist)), BATCH * mp)
    register("device_entropy_spec", per_call(
        lambda: jed.decode_batch_device_entropy_spec(
            [data] * BATCH, chunk_bytes=4096)), BATCH * mp)

    # ---- other formats through load, and their opt-in device paths ---
    def load(dat, gate=None):
        def fn():
            if gate:
                os.environ[gate] = "1"
            try:
                return ffpic_tpu.load(dat).pixels
            finally:
                if gate:
                    os.environ.pop(gate, None)
        return fn

    register("webp_512", per_call(load(wdata), 5), 512 * 512 / 1e6)
    register("webp_device", per_call(load(wdata, "FFPIC_VP8_DEVICE")),
             512 * 512 / 1e6)
    register("avif_512", per_call(load(adata)), 512 * 512 / 1e6)
    register("heic_1mp", per_call(load(hdata)), 1024 * 1024 / 1e6)
    register("heic_device", per_call(load(hdata, "FFPIC_HEVC_DEVICE")),
             1024 * 1024 / 1e6)

    # ---- sweep: round-robin every row, best time counts --------------
    best = {}
    t_sweep0 = time.perf_counter()
    for r in range(ROUNDS):
        for name, (fn, _mp) in trials.items():
            best[name] = min(best.get(name, float("inf")), fn())
        _log(f"round {r + 1}/{ROUNDS} done")
    sweep_s = time.perf_counter() - t_sweep0

    mps = {name: trials[name][1] / best[name] for name in trials}
    headline = ("e2e_packed", "e2e_batch", "device_entropy_dri",
                "decode_batch_dri", "device_entropy_spec")
    best_path = max(headline, key=lambda k: mps[k])
    result = {
        "metric": "jpeg_1080p_420_decode_end_to_end",
        "value": mps[best_path],
        "unit": "MP/s/chip",
        "vs_baseline": mps[best_path] / BASELINE_MPS,
        "e2e_best_path": best_path,
        **{f"{k}_mps": v for k, v in mps.items()},
        "bench_rounds": ROUNDS,
        "bench_sweep_s": sweep_s,
        "batch": BATCH,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }
    print(json.dumps(result))
    if os.environ.get("FFPIC_TRACE"):
        from ffpic_tpu.utils import trace
        print("trace:", json.dumps(trace.report()), file=sys.stderr)


if __name__ == "__main__":
    main()
