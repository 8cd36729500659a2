"""picinfo — probe a file, print structured metadata, optionally decode.

CLI parity with the reference's app/picinfo.c (including
--skip_decode which parses structure without pixel decode,
picinfo.c:21-37)."""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="picinfo")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-s", "--skip_decode", action="store_true",
                    help="parse headers only, no pixel decode")
    args = ap.parse_args(argv)

    import ffpic_tpu
    from ffpic_tpu import runtime
    runtime.setup_compile_cache()
    rc = 0
    for path in args.files:
        try:
            codec = ffpic_tpu.probe(path)
            pic = ffpic_tpu.load(path, skip_decode=args.skip_decode)
        except (ValueError, OSError, NotImplementedError) as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue
        print(f"{path}: codec {codec.name}")
        print(ffpic_tpu.info(pic))
        if pic.frames:
            print(f"\t+{len(pic.frames)} extra frame(s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
