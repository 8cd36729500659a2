"""transbmp — decode any supported format and write a 32bpp BMP
(CLI parity with app/transbmp.c; output naming matches the reference's
bmpwriter '<title> (W * H).bmp' convention when --out is omitted)."""

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="transbmp")
    ap.add_argument("file")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    import ffpic_tpu
    from ffpic_tpu import runtime
    runtime.setup_compile_cache()
    try:
        pic = ffpic_tpu.load(args.file)
    except (ValueError, OSError, NotImplementedError) as e:
        print(f"transbmp: {e}", file=sys.stderr)
        return 1
    out = args.out or f"{args.file} ({pic.width} * {pic.height}).bmp"
    data = ffpic_tpu.encode(pic, "BMP")
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out} ({pic.width}x{pic.height})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
