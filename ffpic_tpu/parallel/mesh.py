"""Multi-chip scaling: plain JAX data parallelism over a device mesh.

The reference is single-process/single-thread (SURVEY.md §2.6); the
parallelism set replacing it is:
  (a) batch data-parallelism across images → one block grid per launch,
  (b) block-grid parallelism inside kernels,
  (c) multi-chip = shard the image batch over the ``data`` mesh axis
      (this module), with the ``model`` axis reserved for
      tensor-parallel consumers (ffpic_tpu.models.vit).

No hand-written collectives are needed for decode itself — batch
sharding is embarrassingly parallel; XLA inserts collectives only for
the downstream model (psum over the ``model`` axis in the ViT's TP
layers and gradient all-reduce over ``data``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """(data, model) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}")
    arr = np.array(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, axis_names=("data", "model"))


def _pad_to(x, n):
    """Pad leading dim up to n with zeros (host-side, cheap)."""
    if x.shape[0] == n:
        return x
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad)


def shard_batch(mesh: Mesh, x):
    """Place a host batch (leading dim N) sharded over the data axis.

    Ragged batches (N % dp != 0) are zero-padded up to the next
    multiple of the data-axis size; callers that care about exact N
    should slice the result (sharded_decode_420 does)."""
    dp = mesh.shape["data"]
    n = -(-x.shape[0] // dp) * dp
    sh = NamedSharding(mesh, P("data"))
    return jax.device_put(_pad_to(x, n), sh)


def sharded_decode_420(mesh: Mesh, ycoef, ucoef, vcoef, yquant, cquant,
                       order: str = "rgba", mode: str = "reference"):
    """Batched 4:2:0 JPEG device pipeline sharded over the data axis.

    Inputs are (N, nby, nbx, 8, 8) int16 (+ (N, nby/2, nbx/2, 8, 8)
    chroma); output (N, H, W, 4) uint8 stays sharded on device for the
    consuming model.  Ragged N (not divisible by the data-axis size)
    is zero-padded for the launch and sliced back afterwards.
    Quant tables may be shared (8, 8) — replicated — or per-image
    (N, 1, 1, 8, 8) — sharded along with the batch."""
    from ffpic_tpu.ops.jpeg_kernels import decode_batch_420

    n = ycoef.shape[0]
    dp = mesh.shape["data"]
    npad = -(-n // dp) * dp
    ycoef, ucoef, vcoef = (_pad_to(c, npad) for c in (ycoef, ucoef, vcoef))

    data_sh = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    per_image_q = np.asarray(yquant).ndim > 2
    if per_image_q:
        yquant = _pad_to(yquant, npad)
        cquant = _pad_to(cquant, npad)
    qsh = data_sh if per_image_q else repl
    fn = jax.jit(
        functools.partial(decode_batch_420, order=order, mode=mode),
        in_shardings=(data_sh, data_sh, data_sh, qsh, qsh),
        out_shardings=data_sh,
    )
    out = fn(ycoef, ucoef, vcoef, yquant, cquant)
    return out[:n] if npad != n else out
