"""Model-facing batched decode pipeline (BASELINE.json config 5).

``decode_batch`` turns a mixed list of image files into one on-device
``(N, H, W, 4)`` uint8 tensor:

1. Host pass: parse every input; baseline 4:2:0 3-component JPEGs are
   *not* rendered — their coefficient tensors are collected and
   bucketed by block geometry.
2. One coalesced device launch per geometry bucket
   (ops/jpeg_kernels.decode_batch_420 with per-image quant tables) —
   the batch-data-parallel analog of the reference's per-MCU loop
   (SURVEY.md §2.6(b)); every other codec decodes through the registry
   per image.
3. On-device resize to the common output size and reassembly in input
   order.

Pass ``mesh=`` (jax.sharding.Mesh with a "data" axis) to place the
final batch sharded for a downstream model.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ffpic_tpu.utils import trace


def _read(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def _jpeg_420_plan(data: bytes, use_packed: bool = True):
    """Return the coefficient-plan for a baseline/progressive 4:2:0
    3-component JPEG decoded by the native path, else None.  Prefers
    the packed-emission fast path (j.packed set, ~2.4x smaller
    staging); falls back to dense coefficient planes for progressive /
    multi-scan files (or when the caller wants dense tensors for
    coalesced sharded launches, use_packed=False)."""
    from ffpic_tpu.formats import jpg
    if not use_packed:
        try:
            j, _ = jpg.parse_and_decode(data)
        except ValueError:
            return None
        if not j.coeffs_raster or len(j.comps) != 3:
            return None
        if [(c.v, c.h) for c in j.comps] != [(2, 2), (1, 1), (1, 1)]:
            return None
        return j
    try:
        j, _ = jpg.parse_and_decode(data, packed=True)
    except jpg.PackedIneligible:
        try:
            j, _ = jpg.parse_and_decode(data)
        except ValueError:
            return None
        if not j.coeffs_raster:
            return None
    except ValueError:
        return None
    if len(j.comps) != 3:
        return None
    samps = [(c.v, c.h) for c in j.comps]
    if samps != [(2, 2), (1, 1), (1, 1)]:
        return None
    return j


def _device_entropy_default() -> bool:
    """Device-side entropy decode (ops/jpeg_entropy_device) for DRI'd
    baseline JPEG batches: opt-in with FFPIC_DEVICE_ENTROPY=1 on every
    backend.  On an H100 it lost to the host packed path: 32 restart-
    marker 1088p JPEGs took 0.53 s on the device, 0.45 s split half
    and half, 0.16 s on the host (chip_smoke.py phase 4)."""
    return os.environ.get("FFPIC_DEVICE_ENTROPY") == "1"


def decode_batch(srcs: Sequence, size: tuple[int, int] | None = None,
                 dtype="uint8", mode: str = "bt601", mesh=None):
    """Decode a batch of images to a single (N, H, W, 4) device array."""
    import jax.numpy as jnp
    from ffpic_tpu.formats import registry
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420
    from ffpic_tpu.ops.resize import resize_rgba

    n = len(srcs)
    slots: list = [None] * n
    buckets: dict[tuple, list] = {}

    color_mode = "bt601" if mode == "bt601" else mode

    use_dev_entropy = mesh is None and _device_entropy_default()
    # DRI-less speculative entropy (self-sync chunk decoder): opt-in,
    # it lost to both the DRI and the host packed paths (PARITY.md)
    use_spec = os.environ.get("FFPIC_SPEC_ENTROPY") == "1"
    dri_list: list = []
    spec_groups: dict = {}
    datas: list = [None] * n
    dev_done = set()
    if use_dev_entropy:
        from ffpic_tpu.formats import jpg as _jpg
        from ffpic_tpu.ops import jpeg_entropy_device as _jed
        for i, src in enumerate(srcs):
            data = _read(src)
            datas[i] = data
            if data[:2] != b"\xff\xd8":
                continue
            try:
                jh, _ = _jpg.parse_and_decode(data, skip_decode=True)
            except (ValueError, NotImplementedError):
                continue
            if _jed.eligible(jh):
                dri_list.append((i, jh))
            elif use_spec and _jed.spec_eligible(jh):
                spec_groups.setdefault(_jed.spec_group_key(jh),
                                       []).append((i, jh))
        # mixed sizes and tables all merge into ONE entropy launch
        # (per-lane LUT/bmap indices); >= 4 members amortize the
        # device loop, smaller batches stay on the host packed path
        if len(dri_list) >= 4:
            dev_members = dri_list
            # hybrid scheduling: the device-entropy launch is async
            # (dispatch returns before the while_loop runs), so when
            # the WHOLE batch would go to the device the host core
            # sits idle behind it.  Keep a share on the host packed
            # path instead — both engines decode concurrently and the
            # batch finishes at max(host, device) rather than their
            # sum.  Only when there is no other host work in this
            # batch (non-DRI members already overlap naturally).
            if (os.environ.get("FFPIC_HYBRID", "1") != "0"
                    and len(dri_list) == n and n >= 6):
                frac = float(os.environ.get("FFPIC_HYBRID_FRAC",
                                            "0.5"))
                k = max(4, int(round(n * frac)))
                if n - k >= 2:
                    dev_members = dri_list[:k]
            idxs = [i for i, _ in dev_members]
            try:
                out = _jed.decode_batch_dri_mixed(
                    [datas[i] for i in idxs],
                    [jh for _, jh in dev_members],
                    order="rgba", mode=color_mode)
            except (ValueError, NotImplementedError):
                out = None             # fall back to the host path
            if out is not None:
                for k, (i, jh) in enumerate(dev_members):
                    slots[i] = out[k][:jh.height, :jh.width]
                    dev_done.add(i)
                trace.count("decode_batch.device_entropy",
                            len(dev_members))
        for members in spec_groups.values():
            if len(members) < 4:
                continue
            try:
                out = _jed.decode_batch_spec(
                    [datas[i] for i, _ in members],
                    [jh for _, jh in members],
                    order="rgba", mode=color_mode)
            except (ValueError, NotImplementedError):
                continue               # host path fallback
            for k, (i, jh) in enumerate(members):
                slots[i] = out[k][:jh.height, :jh.width]
                dev_done.add(i)
            trace.count("decode_batch.device_entropy", len(members))

    def _prep(item):
        i, src = item
        data = datas[i] if datas[i] is not None else _read(src)
        # with a mesh, keep dense coefficient tensors so each geometry
        # bucket launches ONE sharded decode over the data axis
        # (VERDICT r2 #7) instead of per-frame packed launches
        j = _jpeg_420_plan(data, use_packed=mesh is None)
        if j is not None and j.packed is not None:
            # host copy now: the packed emission lives in a per-thread
            # scratch the next parse overwrites; staging happens once
            # per bucket as a stacked transfer (decode_batch_420_packed)
            c, k, v, nnz = j.packed
            j.packed = (np.array(c), np.array(k), np.array(v), nnz)
        pic = None
        if j is None:
            # non-JPEG members (WebP/HEIC/AVIF/PNG/...) decode fully
            # on the host INSIDE the pool — each is an independent
            # entropy+recon unit and the native decoders release the
            # GIL across their ctypes calls (same seam as HEIF grid
            # tiles)
            pic = registry.load(data)
        return i, data, j, pic

    # host worker pool over the entropy-decode stage (SURVEY 2.6(a)):
    # the native parsers release the GIL, so reads+Huffman+staging of
    # independent images scale across host cores.  Serial on 1-vCPU
    # hosts (measured loss there); FFPIC_THREADS overrides.
    items = [(i, s) for i, s in enumerate(srcs) if i not in dev_done]
    env_t = os.environ.get("FFPIC_THREADS")
    nw = int(env_t) if env_t else (os.cpu_count() or 1)
    nw = max(1, min(nw, len(items) or 1))
    if nw > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nw) as ex:
            prepped = list(ex.map(_prep, items))
    else:
        prepped = [_prep(it) for it in items]

    for (i, data, j, pic) in prepped:
        if j is not None:
            key = (j.comps[0].nby, j.comps[0].nbx)
            buckets.setdefault(key, []).append((i, j))
        else:
            slots[i] = jnp.asarray(pic.to_rgba32())

    # coalesced launches per geometry bucket, per-image quant tables;
    # staging is adaptive: packed (idx, val) pairs when the scan is
    # sparse enough to cut host->device bytes (~3x on photo-like
    # content, break-even at ~1/3 nonzero), dense planes otherwise.
    # trace counts "decode_batch.bucket.<path>" once per launch.
    from ffpic_tpu.ops.jpeg_kernels import (
        decode_batch_420_packed_fused, decode_batch_420_sparse,
        decode_frame_420_packed, pack_coeffs, stack_packed_fused)
    for (nby, nbx), allmembers in buckets.items():
        # packed-emission members: one coalesced unpack|decode launch
        # for the whole bucket (stacked staging pays the per-transfer
        # fixed cost once); single members keep the per-frame launch
        pmembers = [(i, j) for i, j in allmembers if j.packed is not None]
        if len(pmembers) >= 2:
            from ffpic_tpu.formats.jpg import packed_block_map
            j0 = pmembers[0][1]
            shapes = tuple((c.nby, c.nbx) for c in j0.comps)
            bmap = packed_block_map(j0)
            # fused staging: ONE uint8 transfer + ONE launch per bucket
            trace.count("decode_batch.bucket.packed_fused")
            buf, g_, e_ = stack_packed_fused([j.packed for _i, j in
                                              pmembers])
            yq = jnp.asarray(np.stack(
                [j.dqt[j.comps[0].tq].reshape(8, 8)
                 for _i, j in pmembers])[:, None, None])
            cq = jnp.asarray(np.stack(
                [j.dqt[j.comps[1].tq].reshape(8, 8)
                 for _i, j in pmembers])[:, None, None])
            outp = decode_batch_420_packed_fused(
                jnp.asarray(buf), bmap, yq, cq, len(pmembers), g_,
                e_, shapes, order="rgba", mode=color_mode)
            for k, (i, j) in enumerate(pmembers):
                slots[i] = outp[k, :j.height, :j.width]
        elif pmembers:
            i, j = pmembers[0]
            shapes = tuple((c.nby, c.nbx) for c in j.comps)
            from ffpic_tpu.formats.jpg import packed_block_map
            bmap = packed_block_map(j)
            yq1 = jnp.asarray(j.dqt[j.comps[0].tq].reshape(8, 8))
            cq1 = jnp.asarray(j.dqt[j.comps[1].tq].reshape(8, 8))
            c, k, v, _nnz = j.packed
            trace.count("decode_batch.bucket.packed")
            out1 = decode_frame_420_packed(
                jnp.asarray(c), jnp.asarray(k), jnp.asarray(v), bmap,
                yq1, cq1, shapes, order="rgba", mode=color_mode)
            slots[i] = out1[:j.height, :j.width]
        members = [(i, j) for i, j in allmembers if j.packed is None]
        if not members:
            continue
        ycoef = np.stack([j.coeffs[0].reshape(nby, nbx, 8, 8)
                          for _i, j in members])
        ucoef = np.stack([j.coeffs[1].reshape(nby // 2, nbx // 2, 8, 8)
                          for _i, j in members])
        vcoef = np.stack([j.coeffs[2].reshape(nby // 2, nbx // 2, 8, 8)
                          for _i, j in members])
        yq = np.stack([j.dqt[j.comps[0].tq].reshape(8, 8)
                       for _i, j in members])[:, None, None]
        cq = np.stack([j.dqt[j.comps[1].tq].reshape(8, 8)
                       for _i, j in members])[:, None, None]
        if mesh is not None:
            # coalesced sharded launch: the bucket's batch dimension
            # shards over the mesh's data axis, per-image quant tables
            # ride along sharded; ragged N is padded inside
            from ffpic_tpu.parallel.mesh import sharded_decode_420
            trace.count("decode_batch.bucket.sharded")
            out = sharded_decode_420(mesh, ycoef, ucoef, vcoef,
                                     yq, cq, order="rgba",
                                     mode=color_mode)
            for k, (i, j) in enumerate(members):
                slots[i] = out[k, :j.height, :j.width]
            continue
        dense_bytes = ycoef.nbytes + ucoef.nbytes + vcoef.nbytes
        packed = tuple(pack_coeffs(c) for c in (ycoef, ucoef, vcoef))
        packed_bytes = sum(a.nbytes + b.nbytes for a, b in packed)
        if packed_bytes < dense_bytes * 0.7:
            shapes = ((len(members), nby, nbx),
                      (len(members), nby // 2, nbx // 2),
                      (len(members), nby // 2, nbx // 2))
            trace.count("decode_batch.bucket.sparse")
            out = decode_batch_420_sparse(packed, shapes,
                                          jnp.asarray(yq),
                                          jnp.asarray(cq),
                                          order="rgba", mode=color_mode)
        else:
            trace.count("decode_batch.bucket.dense")
            out = decode_batch_420(jnp.asarray(ycoef),
                                   jnp.asarray(ucoef),
                                   jnp.asarray(vcoef), jnp.asarray(yq),
                                   jnp.asarray(cq), order="rgba",
                                   mode=color_mode)
        for k, (i, j) in enumerate(members):
            slots[i] = out[k, :j.height, :j.width]

    if size is None:
        shapes = {tuple(s.shape) for s in slots}
        if len(shapes) != 1:
            raise ValueError(
                "mixed sizes: pass size=(H, W) to resize on device")
        batch = jnp.stack(slots)
    else:
        batch = jnp.stack([resize_rgba(s, tuple(size), "bilinear")
                           for s in slots])

    if mesh is not None:
        from ffpic_tpu.parallel.mesh import shard_batch
        batch = shard_batch(mesh, np.asarray(batch))[:n]
    return batch
