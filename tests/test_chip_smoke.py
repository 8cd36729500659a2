"""Rehearsal of chip_smoke.py without the card: its comparison helpers
and references on small images, phases 3-5 and the --multi phase at a
tiny size on the CPU (4 of conftest's virtual devices for the mesh),
and the script itself refusing to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _jpeg(h, w, seed):
    from ffpic_tpu.formats.jpg_encode import encode_baseline
    from ffpic_tpu.formats.pic import Pic
    from ffpic_tpu.utils.synth import synth_rgba
    return encode_baseline(Pic(pixels=synth_rgba(h, w, seed), width=w,
                               height=h), quality=85)


@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_reference_vs_device_decode(seed):
    """The numpy reference (ops/golden dequant + idct8x8_16, float64
    colour) agrees with the JAX decode within the colour LSB."""
    from ffpic_tpu.formats import jpg
    data = _jpeg(48, 64, seed)
    ref = cs.jpeg_reference(data)
    assert ref.shape == (48, 64, 4) and ref.dtype == np.uint8
    dev = jpg.load(data, order="rgba", mode="bt601")[0].np_pixels()
    res = cs.compare("device vs numpy", dev[:48, :64], ref, cs.COLOR_LSB)
    assert res["max"] <= cs.COLOR_LSB and res["exact_px"] > 0.99


def test_compare_reports_and_raises():
    a = np.zeros((4, 4, 4), np.uint8)
    b = a.copy()
    b[0, 0, 1] = 1
    r = cs.compare("one off", b, a, 1)
    assert r["max"] == 1 and r["exact_px"] == 15 / 16
    with pytest.raises(AssertionError, match="max"):
        cs.compare("too far", b + 1, a, 1)
    with pytest.raises(AssertionError, match="shape"):
        cs.compare("shape", a[:2], a, 0)


def test_png_sub_up_roundtrips_through_device_unfilter():
    import ffpic_tpu
    from ffpic_tpu.utils.synth import synth_rgba
    src = synth_rgba(40, 56, seed=3, alpha=True)
    data = cs.png_sub_up(src)
    np.testing.assert_array_equal(ffpic_tpu.load(data).np_pixels(), src)


def test_phase_jpeg_batch_tiny(tmp_path):
    out = cs.phase_jpeg_batch(str(tmp_path), seed=0, n=2, h=64, w=64,
                              distinct=2)
    assert out["paths"] == {"decode_batch.bucket.packed_fused": 1}
    assert all(c["max"] <= c["tol"] for c in out["compare"])


def test_phase_mixed_load_tiny(tmp_path):
    items = [it for it in cs.mixed_inputs(str(tmp_path), seed=0,
                                          png_hw=(64, 64),
                                          webp_hw=(64, 64),
                                          heic_hw=(64, 64), heic_tile=32)
             if it[0] in ("png", "webp_lossless")]
    out = cs.phase_mixed_load(items)
    assert [m[0] for m in out["members"]] == ["png", "webp_lossless"]
    assert all(c["max"] == 0 for c in out["compare"])


def test_phase_device_entropy_tiny(tmp_path):
    from PIL import Image
    from ffpic_tpu.utils.synth import synth_rgb
    p = tmp_path / "dri.jpg"
    Image.fromarray(synth_rgb(48, 64, seed=5)).save(
        p, "JPEG", quality=85, subsampling="4:2:0", restart_marker_rows=1)
    out = cs.phase_device_entropy(n=8, reps=1, unrolls=(2,), path=str(p))
    assert out["device_images"] == {"host": 0, "device": 8, "hybrid": 4}


def test_phase_multi_on_four_virtual_devices(tmp_path):
    import jax
    out = cs.phase_multi(str(tmp_path), seed=0, devices=jax.devices()[:4],
                         sizes=(8, 6), h=64, w=64, distinct=2)
    assert out["mesh"] == {"data": 4, "model": 1}
    for devs in out["shard_devices"].values():
        assert len(devs) == 4
    assert [c["max"] for c in out["compare"]] == [0, 0, 0, 0]


def test_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
