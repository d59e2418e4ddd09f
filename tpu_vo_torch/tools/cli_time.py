"""Host time per frame of the CLI over a directory of Paeth-filtered PNG
frames, the case where the port's Python PNG reader is slowest.

    python tpu_vo_torch/tools/cli_time.py [--frames 32] [--root DIR]
        [--device cpu]

Writes make_sequence(frames, 1241, 376, seed=0) as PNG files whose rows
all carry the Paeth filter, then runs tpu_vo_torch.cli.main over them
twice, headless and quiet: the first run warms up (it builds the
kernels), the second is timed on the host clock, the CLI's whole run
over the frame count. With --root the package is imported from that
checkout instead of this one, so that an older tree's CLI is timed by the
same script in the same call (run it by its file path then). Prints one
JSON line: ms per frame, the decoder the CLI named (none where it reads
frames inline) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PAETH = 4


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="cli_time", description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--root", default=REPO, help="checkout to import tpu_vo_torch from")
    p.add_argument("--device", default=None, help="'cpu' runs on the CPU (default: the card)")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from tpu_vo_torch import cli
    from tpu_vo_torch.io.dataset import write_png
    from tpu_vo_torch.utils.profiling import card
    from tpu_vo_torch.utils.synthetic import make_sequence

    frames = make_sequence(n_frames=args.frames, width=1241, height=376, seed=0)[0]
    flags = ["--no-viewer", "--quiet"] + (["--device", args.device] if args.device else [])
    with tempfile.TemporaryDirectory() as d:
        img = os.path.join(d, "frames")
        os.mkdir(img)
        for i, f in enumerate(frames):
            write_png(os.path.join(img, f"{i:06d}.png"), f, filter_type=PAETH)
        for _ in range(2):
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = cli.main([img, *flags, "--out-dir", os.path.join(d, "out")])
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"the CLI exited with {rc}")
    decoder = [ln for ln in text.getvalue().splitlines() if ln.startswith("Decoder:")]
    out = {"root": os.path.abspath(args.root), "frames": args.frames, "png_filter": "Paeth",
           "ms_per_frame": seconds * 1e3 / args.frames,
           "decoder": decoder[0] if decoder else "none named (decoded inline)",
           "device": "cpu" if args.device == "cpu" else card()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
