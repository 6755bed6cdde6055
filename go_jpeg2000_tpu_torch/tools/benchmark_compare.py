"""The port against OpenJPEG through Pillow (the port of the JAX package's
tools/benchmark_compare.py, itself after the Go reference's harness).

    python -m go_jpeg2000_tpu_torch.tools.benchmark_compare
        [--sizes 64,128,256,512] [--iters 5] [--device cuda|cpu]

At each size an RGB image of smooth noise: the port's encode and decode
(Part-1 lossless, 5 resolutions; and HTJ2K lossless), each the mean of
`iters` calls after one warm-up by the host clock; every round trip must
be exact.  Where Pillow has OpenJPEG (PIL.features.check('jpg_2000')),
the same for its reversible encode and its decode, the ratios, and
OpenJPEG's decode of the port's Part-1 stream, which must equal the
image; elsewhere "OpenJPEG: not run", and nothing is fetched.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np

from . import _clock as ck


def natural(h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w, c)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def time_it(fn, iters: int):
    """(mean seconds of `iters` calls after a warm-up, the last result)."""
    out = fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def openjpeg():
    """Pillow's Image where it has OpenJPEG, else None."""
    try:
        from PIL import Image, features
    except ImportError:
        return None
    return Image if features.check("jpg_2000") else None


def run(argv=None):
    args = parse(argv)
    dev = ck.resolve_device(args.device)
    import go_jpeg2000_tpu_torch as tp
    image_mod = openjpeg()
    if image_mod is None:
        print(f"OpenJPEG: not run (Pillow has no jpg_2000) {ck.tag()}",
              flush=True)
    rows = []
    for size in args.sizes:
        img = natural(size, size, 3, seed=size)
        row = {"tool": "benchmark_compare", "size": size,
               "card": ck.card_line(), "cpu_count": os.cpu_count(),
               "device": str(args.device)}
        for label, ht in (("part1", False), ("ht", True)):
            opts = tp.Options(format=tp.Format.J2K, lossless=True,
                              num_resolutions=5, high_throughput=ht)
            row[f"{label} enc"], data = time_it(
                lambda: tp.encode(img, opts, device=dev), args.iters)
            row[f"{label} dec"], dec = time_it(
                lambda: tp.decode(data, device=dev), args.iters)
            if not np.array_equal(dec, img):
                raise AssertionError(f"{size}: the port's {label} round trip "
                                     "is not exact")
            row[f"{label} bytes"] = len(data)
            if label == "part1":
                part1 = data
        text = (f"{size:>4}^2 RGB: ours Part-1 enc {row['part1 enc'] * 1e3:.1f}"
                f" ms, dec {row['part1 dec'] * 1e3:.1f} ms; HT enc "
                f"{row['ht enc'] * 1e3:.1f} ms, dec {row['ht dec'] * 1e3:.1f}"
                " ms")
        if image_mod is not None:
            def opj_enc():
                buf = io.BytesIO()
                image_mod.fromarray(img).save(buf, format="JPEG2000",
                                              irreversible=False,
                                              num_resolutions=5)
                return buf.getvalue()
            row["opj enc"], opj_data = time_it(opj_enc, args.iters)
            row["opj dec"], opj_out = time_it(
                lambda: np.asarray(image_mod.open(io.BytesIO(opj_data))),
                args.iters)
            if not np.array_equal(opj_out, img):
                raise AssertionError(f"{size}: OpenJPEG's round trip is not "
                                     "exact")
            if not np.array_equal(
                    np.asarray(image_mod.open(io.BytesIO(part1))), img):
                raise AssertionError(f"{size}: OpenJPEG's decode of the "
                                     "port's Part-1 stream is not the image")
            text += (f"; OpenJPEG enc {row['opj enc'] * 1e3:.1f} ms, dec "
                     f"{row['opj dec'] * 1e3:.1f} ms; ratio ours/OpenJPEG "
                     f"enc {row['part1 enc'] / row['opj enc']:.2f}, dec "
                     f"{row['part1 dec'] / row['opj dec']:.2f}; OpenJPEG "
                     "decodes the port's stream exactly")
        print(f"{text} {ck.tag()}", flush=True)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m go_jpeg2000_tpu_torch.tools.benchmark_compare")
    ap.add_argument("--sizes", type=lambda s: [int(x) for x in s.split(",")],
                    default=[64, 128, 256, 512])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
