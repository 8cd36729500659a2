"""ffpic_tpu — a batched image decode/encode framework for accelerators.

A ground-up rebuild of the capability set of the ffpic C library
(reference: format/file.h:18-66) designed device-first:

* Serial entropy stages (Huffman, DEFLATE, LZW, VP8 bool, CABAC) run on the
  host — in native C via ``ffpic_tpu.native`` with pure-Python
  fallbacks in ``ffpic_tpu.coding``.
* All dense block math (dequant + inverse transforms, intra prediction,
  loop filters, PNG filter reconstruction, colorspace conversion) runs as
  batched XLA kernels over whole-image block grids in
  ``ffpic_tpu.ops``.
* Multi-chip scaling is plain JAX data parallelism over a
  ``jax.sharding.Mesh`` (``ffpic_tpu.parallel``).

Public API mirrors the reference's file registry
(format/file.c:30-92): ``probe``, ``load``, ``info``, ``encode`` plus the
batched ``decode_batch`` entry that feeds JAX models directly.
"""

from ffpic_tpu.formats import (
    Pic,
    probe,
    load,
    load_all,
    info,
    encode,
    find_codec,
    registered_codecs,
)
from ffpic_tpu.pipeline import decode_batch

__version__ = "0.1.0"

__all__ = [
    "Pic",
    "probe",
    "load",
    "load_all",
    "info",
    "encode",
    "find_codec",
    "registered_codecs",
    "decode_batch",
    "__version__",
]
