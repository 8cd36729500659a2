"""Codec registry: probe-by-content dispatch.

Analog of the reference's TAILQ file registry
(reference format/file.c:30-113): codecs register a probe over leading
bytes plus load/info/encode callables; ``probe()`` walks registrants in
registration order and returns the first match, exactly like
``file_probe`` (format/file.c:30-44).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

from ffpic_tpu.formats.pic import Pic
from ffpic_tpu.utils.vlog import get_logger

log = get_logger("registry")


@dataclass
class Codec:
    name: str
    alias: str = ""
    # probe(data: bytes, size: int) -> bool ; data is a prefix+suffix window
    probe: Callable[[bytes], bool] = None
    # load(data: bytes, skip_decode: bool) -> list[Pic]
    load: Callable[[bytes, bool], list] = None
    # info(pic) -> str  (structured metadata dump)
    info: Callable[[Pic], str] = None
    # encode(pic, **options) -> bytes
    encode: Optional[Callable] = None


_codecs: list[Codec] = []
_initialized = False


def register(codec: Codec) -> None:
    _codecs.append(codec)


def _ensure_init() -> None:
    """Import all format modules once; each registers itself on import,
    the analog of the reference's ``file_ops_init`` table
    (format/file.c:94-113)."""
    global _initialized
    if _initialized:
        return
    _initialized = True
    from ffpic_tpu.formats import all_formats  # noqa: F401  (side-effect import)


def registered_codecs() -> list[str]:
    _ensure_init()
    return [c.name for c in _codecs]


def find_codec(name: str) -> Codec:
    """Lookup by name or alias, case-insensitive
    (reference format/file.c:82-92)."""
    _ensure_init()
    name_l = name.lower()
    for c in _codecs:
        if c.name.lower() == name_l or (c.alias and c.alias.lower() == name_l):
            return c
    raise KeyError(f"no codec named {name!r}; have {registered_codecs()}")


def _read_input(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read()
    raise TypeError(f"unsupported input type {type(src)}")


def probe(src) -> Codec:
    """Identify the codec for a file path or bytes by content."""
    data = _read_input(src)
    _ensure_init()
    for c in _codecs:
        try:
            if c.probe is not None and c.probe(data):
                return c
        except Exception:   # a codec's probe must never break the walk
            continue
    raise ValueError("unrecognized image format")


def load_all(src, skip_decode: bool = False) -> list[Pic]:
    """Decode every frame/picture in the input
    (reference format/file.c:46-60 + the 64-slot output ring)."""
    data = _read_input(src)
    codec = probe(data)
    try:
        pics = codec.load(data, skip_decode)
    except (ValueError, NotImplementedError, OSError):
        raise
    except (struct.error, KeyError, IndexError, EOFError, OverflowError,
            ZeroDivisionError, zlib.error) as e:
        # Malformed files that pass probe must surface as the documented
        # ValueError contract, not raw parser tracebacks.
        raise ValueError(f"corrupt {codec.name} file: "
                         f"{type(e).__name__}: {e}") from e
    for p in pics:
        p.codec = codec.name
    if pics and len(pics) > 1:
        pics[0].frames = pics[1:]
    return pics


def load(src, skip_decode: bool = False) -> Pic:
    """Decode the primary picture; extra frames hang off ``pic.frames``."""
    pics = load_all(src, skip_decode)
    if not pics:
        raise ValueError("decode produced no pictures")
    return pics[0]


def info(pic: Pic) -> str:
    codec = find_codec(pic.codec)
    if codec.info is not None:
        return codec.info(pic)
    return repr(pic)


def encode(pic: Pic, codec_name: str, **options) -> bytes:
    codec = find_codec(codec_name)
    if codec.encode is None:
        raise NotImplementedError(f"codec {codec.name} has no encoder")
    return codec.encode(pic, **options)
