"""transcode — decode any supported format, re-encode with a named
codec (CLI parity with app/transcode.c:24-89; the reference registers
encoders for JPG and BMP only — we match that set and grow it)."""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="transcode")
    ap.add_argument("file")
    ap.add_argument("-c", "--codec", required=True, help="target codec name")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("-q", "--quality", type=int, default=None,
                    help="encoder quality (codec-specific)")
    args = ap.parse_args(argv)

    import ffpic_tpu
    from ffpic_tpu import runtime
    runtime.setup_compile_cache()
    opts = {}
    if args.quality is not None:
        opts["quality"] = args.quality
    try:
        pic = ffpic_tpu.load(args.file)
        data = ffpic_tpu.encode(pic, args.codec, **opts)
    except (ValueError, OSError, KeyError, NotImplementedError) as e:
        msg = e.args[0] if e.args else e
        print(f"transcode: {msg}", file=sys.stderr)
        return 1
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out} ({len(data)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
