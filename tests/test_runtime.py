"""Runtime hygiene: the accelerator predicate, the GPU check, the
compile-cache path, and the multi-device dry run refusing to switch
backends."""

import os
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_on_accelerator_false_on_cpu():
    from ffpic_tpu import runtime
    assert runtime.on_accelerator() is False


def test_require_gpu_raises_on_cpu():
    from ffpic_tpu import runtime
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from ffpic_tpu import runtime
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from ffpic_tpu import runtime
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compile_cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert runtime.compile_cache_dir() == path


@pytest.mark.parametrize("accel,env,want", [
    (True, None, False), (False, None, False),
    (True, "1", True), (False, "1", True), (True, "0", False),
])
def test_device_entropy_default_from_predicate(monkeypatch, accel, env,
                                               want):
    """Device entropy lost to the host path on the GPU, so it is
    opt-in whatever the accelerator predicate says; no backend name
    decides it."""
    from ffpic_tpu import pipeline, runtime
    monkeypatch.setattr(runtime, "on_accelerator", lambda: accel)
    if env is None:
        monkeypatch.delenv("FFPIC_DEVICE_ENTROPY", raising=False)
    else:
        monkeypatch.setenv("FFPIC_DEVICE_ENTROPY", env)
    assert pipeline._device_entropy_default() is want


@pytest.mark.parametrize("accel", [True, False])
def test_unroll_from_predicate(monkeypatch, accel):
    from ffpic_tpu import runtime
    from ffpic_tpu.ops import jpeg_entropy_device as jed
    monkeypatch.setattr(runtime, "on_accelerator", lambda: accel)
    assert jed.default_unroll() == (jed.ACCEL_UNROLL if accel else 2)


def test_dryrun_multichip_raises_with_too_few_devices():
    import importlib
    import sys
    import jax
    sys.path.insert(0, str(REPO))
    ge = importlib.import_module("__graft_entry__")
    n = len(jax.devices())
    with pytest.raises(ValueError, match="needs"):
        ge.dryrun_multichip(n + 1)
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) == n


def test_setup_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    import jax
    from ffpic_tpu import runtime
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path)
