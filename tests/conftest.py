"""Test harness config.

Tests run on the CPU with 8 virtual devices, so the multi-device
sharding path (jax.sharding.Mesh over DP/TP axes) is exercised without
a GPU.  Must set env before jax initializes a backend.  What needs the
card runs in chip_smoke.py, one process per card, never under pytest's
workers (each would reserve most of the card's memory).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import pytest  # noqa: E402

# pin the CPU backend even if jax was imported before this file set
# JAX_PLATFORMS
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def rng():
    import numpy as np
    return np.random.default_rng(1234)


def pytest_configure(config):
    """Register the markers, generate the synthetic corpus on first run
    so corpus-dependent tests work from a fresh checkout
    (tools/make_corpus.py, ~10 s), and build the C reference oracles
    (refbuild/, refbuild-asan/, ~1-2 min once, cached) so the 46
    vs-C-reference conformance tests run instead of skipping.
    FFPIC_NO_REFBUILD=1 opts out."""
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects these")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; runs in chip_smoke.py")
    repo = pathlib.Path(__file__).resolve().parent.parent
    corpus = repo / "corpus"
    sys.path.insert(0, str(repo / "tools"))
    if not corpus.is_dir():
        try:
            import make_corpus
            make_corpus.main()
        except Exception:
            pass  # corpus tests will skip
    try:
        import ensure_refbuild
        ensure_refbuild.ensure_refbuild()
    except Exception:
        pass  # conformance tests will skip
