"""show — decode and display (the sdlshow analog, app/sdlshow.c).

Without SDL in this image, default sink is the platform viewer via
PIL; --sink bmp/png writes files instead. Animations dump each frame.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="show")
    ap.add_argument("file")
    ap.add_argument("--sink", default="window",
                    choices=["window", "bmp", "png"])
    args = ap.parse_args(argv)

    import ffpic_tpu
    from ffpic_tpu import runtime
    runtime.setup_compile_cache()
    from ffpic_tpu import display
    pic = ffpic_tpu.load(args.file)
    frames = [pic] + pic.frames
    for i, fr in enumerate(frames):
        title = args.file if len(frames) == 1 else f"{args.file}.frame{i}"
        out = display.show(fr, sink=args.sink, title=title)
        if out:
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
