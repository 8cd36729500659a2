"""Stage tracing/profiling — the observability layer the reference
lacks (SURVEY.md §5: vlog levels were its only visibility).

Host stages time with perf_counter; device work integrates with
jax.profiler traces. Counters aggregate per stage for pipeline
tuning (host entropy vs staging vs device kernels).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_stats: dict[str, list[float]] = defaultdict(list)
_counts: dict[str, int] = defaultdict(int)
_enabled = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def stage(name: str):
    """Time a host-side pipeline stage."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stats[name].append(time.perf_counter() - t0)


def count(name: str, n: int = 1) -> None:
    """Add n to a named counter (which path a batch took, how many
    images went to the device)."""
    if _enabled:
        _counts[name] += n


def counts() -> dict:
    return dict(_counts)


@contextlib.contextmanager
def device_trace(name: str):
    """Annotate device work for jax.profiler traces."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield


def start_profiler(logdir: str = "/tmp/ffpic_trace") -> None:
    import jax
    jax.profiler.start_trace(logdir)


def stop_profiler() -> None:
    import jax
    jax.profiler.stop_trace()


def report() -> dict:
    """Per-stage aggregate: count, total, mean (seconds)."""
    return {k: dict(count=len(v), total=sum(v), mean=sum(v) / len(v))
            for k, v in _stats.items() if v}


def reset() -> None:
    _stats.clear()
    _counts.clear()
