"""Generate the test/bench corpus with PIL + numpy.

Images are synthetic but photo-like (smooth gradients + texture +
edges) so JPEG coefficient statistics resemble real content. Sizes are
chosen so the MCU-aligned subset can be compared bit-level against the
C reference decoder (which mis-tracks the entropy stream on non-MCU-
aligned edges, see format/jpg.c:526-527 edge-skip).
"""

import io
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from ffpic_tpu.utils.synth import synth_rgb  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "corpus")


def save_jpeg(arr, path, quality=85, subsampling="4:2:0", progressive=False,
              gray=False):
    im = Image.fromarray(arr if not gray else arr[..., 0], "L" if gray else "RGB")
    im.save(path, "JPEG", quality=quality, subsampling=subsampling,
            progressive=progressive)


def main():
    os.makedirs(OUT, exist_ok=True)
    specs = [
        # (name, h, w, kwargs)
        ("jpeg_512_420.jpg", 512, 512, dict(subsampling="4:2:0")),
        ("jpeg_512_444.jpg", 512, 512, dict(subsampling="4:4:4")),
        ("jpeg_512_422.jpg", 512, 512, dict(subsampling="4:2:2")),
        ("jpeg_1088p_420.jpg", 1088, 1920, dict(subsampling="4:2:0")),
        ("jpeg_1080p_420.jpg", 1080, 1920, dict(subsampling="4:2:0")),
        ("jpeg_160_420.jpg", 160, 160, dict(subsampling="4:2:0")),
        ("jpeg_160_444.jpg", 160, 160, dict(subsampling="4:4:4")),
        ("jpeg_prog_512_444.jpg", 512, 512,
         dict(subsampling="4:4:4", progressive=True)),
        ("jpeg_prog_512_420.jpg", 512, 512,
         dict(subsampling="4:2:0", progressive=True)),
        ("jpeg_gray_512.jpg", 512, 512, dict(gray=True)),
        ("jpeg_q95_512_420.jpg", 512, 512, dict(subsampling="4:2:0", quality=95)),
        ("jpeg_q30_512_420.jpg", 512, 512, dict(subsampling="4:2:0", quality=30)),
    ]
    for name, h, w, kw in specs:
        arr = synth_rgb(h, w, seed=hash(name) % 2**31)
        save_jpeg(arr, os.path.join(OUT, name), **kw)

    # lossless PNG/BMP/etc. references of the same content
    arr = synth_rgb(512, 512, seed=7)
    Image.fromarray(arr).save(os.path.join(OUT, "png_512_rgb.png"))
    Image.fromarray(np.dstack([arr, np.full(arr.shape[:2], 200, np.uint8)])) \
        .save(os.path.join(OUT, "png_512_rgba.png"))
    Image.fromarray(arr).save(os.path.join(OUT, "bmp_512.bmp"))
    arr1080 = synth_rgb(1080, 1920, seed=9)
    Image.fromarray(
        np.dstack([arr1080, np.full(arr1080.shape[:2], 255, np.uint8)])
    ).save(os.path.join(OUT, "png_1080p_rgba.png"))
    Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE).save(
        os.path.join(OUT, "gif_512.gif"))
    Image.fromarray(arr).save(os.path.join(OUT, "webp_512.webp"),
                              lossless=False, quality=80)
    Image.fromarray(arr).save(os.path.join(OUT, "tga_512.tga"))
    Image.fromarray(arr).save(os.path.join(OUT, "avif_512.avif"),
                              quality=60)
    Image.fromarray(arr).save(os.path.join(OUT, "ppm_512.ppm"))

    # 12MP iPhone-style grid HEIC (48 x 512^2 tiles, ~2.6 MB at q50 —
    # realistic bits/px), written with the in-repo HEVC/HEIF encoder;
    # slow (~5 min) so skipped when already present
    heic = os.path.join(OUT, "heic_12mp_grid.heic")
    if not os.path.exists(heic):
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        from ffpic_tpu.formats.heif_enc import encode_heif
        from ffpic_tpu.formats.pic import Pic
        a12 = synth_rgb(3024, 4032, seed=11)
        rgba = np.dstack([a12, np.full(a12.shape[:2], 255, np.uint8)])
        blob = encode_heif(Pic(pixels=rgba, width=4032, height=3024),
                           quality=50, tile=512)
        with open(heic, "wb") as f:
            f.write(blob)
    print("corpus written to", os.path.abspath(OUT))


if __name__ == "__main__":
    sys.exit(main())
