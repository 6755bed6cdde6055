"""The encode and decode entry points in their stages (the port of the JAX
package's tools/profile_stages.py, with tools/ablate_ebcot.py as the
"ebcot" path).

    python -m go_jpeg2000_tpu_torch.tools.profile_stages [--path P]
        [--frames N] [--size S] [--tile T] [--reps R] [--threads 1,2,4,8]
        [--tree DIR ...] [--device cuda|cpu]

Paths, each through the entry points a user calls:
- ht53 (the default, the JAX tool's case): N gray S^2 frames (8, 512),
  HTJ2K lossless, 6 resolutions, encode_batch and decode_batch;
- ht97: the same lossy at quality 85;
- ebcot: Part-1 lossless through encode_batch's paths A (backend
  "device"), B ("hybrid") and C ("native"), whose codestreams must be
  equal, and the Part-1 decode_batch;
- single: S1, an S^2 RGB image (4096) with the default options, through
  encode and decode;
- config2: BASELINE config 2, an S^2 RGB image (2048), JP2 at quality 98,
  3 layers at 20:1, through encode and decode;
- config4: BASELINE config 4, S^2 16-bit RGB (8192) in T^2 tiles (512),
  5 resolutions, HTJ2K lossless, through encode_sharded and
  decode_sharded on a grid of one.

Each case runs once to warm up, then R times (3) under a StageClock
(_clock.py): the breakdown printed is that of the run of median wall,
with the spread of the walls; per stage its calls, host ms, device ms
(CUDA events) and the bytes it copies; then the unattributed remainder
and, on the card, the device idle share as a bracket (a run under the
clock's events over every device stage, and one under torch.profiler).
Each case's results also go out as one JSON line.  The tool asserts its
own exactness: every run's codestreams equal the warm-up's, lossless
decodes equal the input, lossy decodes equal the warm-up's, and, at
several thread counts, every count gives the same bytes.

--threads sweeps the native coder's thread pool: native.loader._nthreads,
which every native call reads, is swapped in this process only.
--tree DIR (repeatable) runs the tool on each checkout in turn, each in a
subprocess: the tool's code comes from this checkout, the package under
test from DIR, so a parent that predates the tools can be timed beside
its change in one call (give the trees in turns: parent, change, change,
parent).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from . import _clock as ck
from ._clock import Stage, arg_bytes, moved_bytes, out_bytes

PATHS = ("ht53", "ht97", "ebcot", "single", "config2", "config4")
SIZES = {"ht53": 512, "ht97": 512, "ebcot": 512, "single": 4096,
         "config2": 2048, "config4": 8192}

HEADER = (Stage("models.encoder", "_image_components", "components"),
          Stage("models.encoder", "header_and_main", "header"))
FINALIZE = Stage("models.encoder", "_finalize_codestream",
                 "codestream assembly")
TIER2 = Stage("models.encoder", "_assemble_packets", "Python Tier-2")
DOWNLOAD = Stage("models.decoder", "download", "download", True, out_bytes)

# encode_batch's fused HT encode (fused_encode_chunk, then native Tier-2)
HT_ENCODE = HEADER + (
    Stage("tcd.geometry", "build_tile", "tile geometry"),
    Stage("models.fused_encode", "plan_for", "block plan"),
    Stage("models.transforms", "upload", "upload", True, arg_bytes(0)),
    Stage("models.transforms", "forward_pyramid",
          "DC shift, colour transform and DWT levels", True),
    Stage("models.fused_encode", "encode_pyramid", "HT kernels", True),
    Stage("models.fused_encode", "fetch_pool", "fetch", True, out_bytes),
    Stage("models.fused_encode", "t2_bodies", "native Tier-2"),
    FINALIZE)
# decode_batch's device HT branch
HT_DECODE = (
    Stage("models.decoder", "prepare_batch", "header parse"),
    Stage("models.decoder", "parse_chunk", "native parse"),
    Stage("models.decoder", "upload_parsed", "upload", True,
          arg_bytes(0, 1, 2)),
    Stage("ops.ht_dec", "fused_decode",
          "MagSgn, assembly, inverse DWT and colour", True),
    DOWNLOAD)
# encode_batch's Part-1 paths: A, B on the device, C the host coder
EBCOT_FETCH = Stage("models.ebcot_fused", "fetch", "fetch", True, out_bytes)
EBCOT_ENCODE = {
    "A": HEADER + (
        Stage("models.ebcot_fused", "ebcot_encode_chunk",
              "device program (decisions, MQ, pool)", True),
        EBCOT_FETCH,
        Stage("models.ebcot_fused", "fetch_results", "segment results"),
        TIER2, FINALIZE),
    "B": HEADER + (
        Stage("models.ebcot_fused", "ebcot_decisions_chunk",
              "device program (decisions)", True),
        EBCOT_FETCH,
        Stage("native.loader", "mq_encode_streams", "native MQ"),
        Stage("models.ebcot_fused", "fetch_results_hybrid",
              "segment results"),
        TIER2, FINALIZE),
    "C": HEADER + (
        Stage("models.transforms", "dispatch_forward_batch",
              "device transform", True),
        Stage("models.transforms", "fetch_forward_batch", "fetch", True,
              arg_bytes(0)),
        Stage("models.encoder", "_entropy_jobs", "block jobs"),
        Stage("models.encoder", "_code_blocks", "host block coding"),
        TIER2, FINALIZE)}
# decode_batch's Part-1 branch
EBCOT_DECODE = (
    Stage("models.decoder", "prepare_batch", "header parse"),
    Stage("models.decoder", "ebcot_jobs", "Python Tier-2"),
    Stage("models.decoder", "decode_blocks_batch", "native T1"),
    Stage("models.decoder", "ebcot_slots", "slot fill"),
    Stage(torch.Tensor, "to", "slot upload", True, moved_bytes,
          outer_only=True),
    Stage("ops.ht_dec_cuda", "blocks_to_pyramid", "device assembly", True),
    Stage("models.transforms", "inverse_pyramid", "device inverse", True),
    DOWNLOAD)
# the single-image API, per tile
SINGLE_ENCODE = HEADER + (
    Stage("models.transforms", "run_forward", "device transform", True),
    Stage("models.encoder", "_entropy_jobs", "block jobs"),
    Stage("models.encoder", "_code_blocks", "host block coding"),
    Stage("models.encoder", "_build_blocks", "block records"),
    Stage("models.encoder", "_assemble_with_budget", "PCRD and Tier-2"),
    FINALIZE)
SINGLE_DECODE = (
    Stage("models.decoder", "_parse", "codestream parse"),
    Stage("models.decoder", "_tier2", "Python Tier-2"),
    Stage("models.decoder", "decode_blocks_batch", "native block decode"),
    Stage("models.decoder", "tile_pyramids", "dequantization and placement"),
    Stage("models.decoder", "_inverse_tile", "pyramid stacking"),
    Stage("models.transforms", "run_inverse", "device inverse", True),
    Stage("models.decoder", "_decode_tiles", "planes and narrowing"),
    Stage("models.decoder", "_apply_colorspace", "colour space"))
# encode_sharded and decode_sharded, single-layer HTJ2K
SHARDED_ENCODE = HEADER + (
    Stage("parallel.sharded", "tile_batch", "tile batch on the host"),
    Stage("models.transforms", "upload", "upload", True, arg_bytes(0)),
    Stage("parallel.sharded", "tile_transform_step",
          "transform step (DWT kernels, band_stats)", True),
    Stage("parallel.sharded", "ht_plans", "block plans"),
    Stage("models.fused_encode", "encode_pyramid", "HT kernels", True),
    Stage("models.fused_encode", "fetch_pool", "fetch", True, out_bytes),
    Stage("models.fused_encode", "t2_bodies", "native Tier-2"),
    Stage("parallel.sharded", "_device_ht_entropy",
          "tile-parts (SOT, SOD and body joined)"),
    FINALIZE)
SHARDED_DECODE = (
    Stage("models.decoder", "sniff_format", "format"),
    Stage("codestream.parser:Parser", "read_header", "codestream parse"),
    Stage("codestream.parser:Parser", "read_all_tile_parts",
          "codestream parse"),
    Stage("parallel.sharded", "ht_plans", "block plans"),
    Stage("models.fused_encode", "t2_geom", "packet walk"),
    Stage("parallel.sharded", "empty_leaves", "empty leaves", True),
    Stage("parallel.sharded", "parse_tiles", "native parse"),
    Stage("models.decoder", "upload_parsed", "upload", True,
          arg_bytes(0, 1, 2)),
    Stage("parallel.sharded", "place_tiles", "MagSgn and assembly kernels",
          True),
    Stage("parallel.sharded", "tile_inverse_step", "inverse step", True),
    Stage(torch.Tensor, "cpu", "download (Tensor.cpu)", True, out_bytes),
    Stage("parallel.sharded", "decode_sharded",
          "decode_sharded's own lines (the planes, each tile's rows "
          "placed)"))


@dataclasses.dataclass
class Case:
    label: str
    encode: Callable[[], object]
    decode: Optional[Callable[[object], object]]
    enc_stages: tuple
    dec_stages: tuple
    lossless: bool
    source: object          # what a lossless decode must give back
    pixels: int


def config4_image(size: int, seed: int = 1) -> np.ndarray:
    """bench.py's sharded_config4 image: smooth 16-bit RGB noise."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << 16, size=(size, size, 3)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint16)


def config2_image(size: int) -> np.ndarray:
    """bench.py's lossy_psnr image: RGB noise smoothed twice by three
    taps, seed 0."""
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, size=(size, size, 3)).astype(np.float32)
    for ax in (0, 1):
        for _ in range(2):
            a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def cases(path: str, args, dev) -> List[Case]:
    """The cases of one path at the arguments' sizes."""
    import go_jpeg2000_tpu_torch as tp
    from go_jpeg2000_tpu_torch.parallel import encode_sharded, sharded
    size = args.size or SIZES[path]
    if path in ("ht53", "ht97", "ebcot"):
        frames = [ck.natural_image(size, size, seed=i)
                  for i in range(args.frames)]
        pixels = args.frames * size * size

        def batch(opts, enc, dec, lossless=True, label=path):
            return Case(label,
                        lambda: tp.encode_batch(frames, opts, device=dev),
                        (lambda s: tp.decode_batch(s, device=dev))
                        if dec else None, enc, dec, lossless, frames, pixels)
        if path == "ebcot":
            return [batch(tp.Options(format=tp.Format.J2K, lossless=True,
                                     num_resolutions=6,
                                     high_throughput=False, backend=backend),
                          EBCOT_ENCODE[p], EBCOT_DECODE if p == "A" else (),
                          label=f"ebcot path {p}")
                    for p, backend in (("A", "device"), ("B", "hybrid"),
                                       ("C", "native"))]
        lossless = path == "ht53"
        return [batch(tp.Options(format=tp.Format.J2K, lossless=lossless,
                                 quality=85, num_resolutions=6,
                                 high_throughput=True),
                      HT_ENCODE, HT_DECODE, lossless)]
    if path in ("single", "config2"):
        if path == "single":
            img, opts = ck.rgb_image(size, size, 500), tp.Options()
        else:
            img = config2_image(size)
            opts = tp.Options(format=tp.Format.JP2, lossless=False,
                              quality=98, num_resolutions=6, num_layers=3,
                              compression_ratio=20.0, backend="native")
        return [Case(path, lambda: tp.encode(img, opts, device=dev),
                     lambda s: tp.decode(s, device=dev), SINGLE_ENCODE,
                     SINGLE_DECODE, opts.lossless, img, size * size)]
    img = config4_image(size)
    opts = tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=5,
                      tile_size=(args.tile, args.tile), high_throughput=True)
    # decode_sharded looked up at the call, so that its wrap reaches it
    return [Case(path, lambda: encode_sharded(img, opts, device=dev),
                 lambda s: sharded.decode_sharded(s, device=dev),
                 SHARDED_ENCODE, SHARDED_DECODE, True, img, size * size)]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def measure(case: Case, reps: int, dev, idle: bool = True) -> dict:
    """One warm-up, then reps encodes and decodes under the clock; returns
    {"data", "decoded", "encode", "decode"} (median reports) and, on the
    card with `idle`, the idle brackets; exactness asserted."""
    data = case.encode()
    decoded = None
    if case.decode is not None:
        decoded = case.decode(data)
        if case.lossless:
            check(ck.same(decoded, case.source),
                  f"{case.label}: the round trip is not exact")
    enc, dec = [], []
    for _ in range(reps):
        got, rep = ck.timed_run(case.encode, case.enc_stages, dev)
        check(got == data, f"{case.label}: an encode differs from the first")
        enc.append(rep)
        if case.decode is not None:
            out, rep = ck.timed_run(lambda: case.decode(data),
                                    case.dec_stages, dev)
            check(ck.same(out, decoded),
                  f"{case.label}: a decode differs from the first")
            dec.append(rep)
    out = {"data": data, "decoded": decoded, "encode": ck.median_report(enc),
           "decode": ck.median_report(dec) if dec else None}
    if idle and torch.device(dev).type == "cuda":
        out["idle"] = {"encode": ck.idle_bracket(case.encode, dev)}
        if case.decode is not None:
            out["idle"]["decode"] = ck.idle_bracket(
                lambda: case.decode(data), dev)
    return out


def run(argv=None) -> List[dict]:
    """Measure what argv asks for (one tree: this process's package);
    print each case's report and JSON line; return the results, with each
    case's codestreams under "data"."""
    args = parse(argv)
    dev = ck.resolve_device(args.device)
    from go_jpeg2000_tpu_torch.native import loader
    import go_jpeg2000_tpu_torch as tp
    package = os.path.dirname(os.path.abspath(tp.__file__))
    if args.in_tree and not package.startswith(
            os.path.abspath(args.in_tree) + os.sep):
        raise RuntimeError(f"imported {package}, not the tree "
                           f"{args.in_tree}")
    results = []
    first = {}
    own = loader._nthreads
    for threads in args.threads or [None]:
        if threads is not None:
            loader._nthreads = lambda k=threads: k
        try:
            for case in cases(args.path, args, dev):
                # the idle brackets at the first thread count only
                res = measure(case, args.reps, dev,
                              idle=case.label not in first)
                want = first.setdefault(case.label, res["data"])
                check(res["data"] == want, f"{case.label}: {threads} "
                      "threads give other bytes")
                res.update(label=case.label, threads=threads or own(),
                           mpix=case.pixels / 1e6)
                report(res, args, package)
                results.append(res)
        finally:
            loader._nthreads = own
    if args.path == "ebcot":
        streams = [r["data"] for r in results]
        check(all(s == streams[0] for s in streams),
              "Part-1 paths A, B and C give different codestreams")
    return results


def report(res: dict, args, package: str) -> None:
    name = f"profile_stages {res['label']} ({res['threads']} native threads)"
    for what in ("encode", "decode"):
        rep = res[what]
        if rep is None:
            continue
        ck.print_report(f"{name} {what}, {res['mpix']:.2f} Mpix, "
                        f"{res['mpix'] / rep['wall_ms'] * 1e3:.2f} Mpix/s",
                        rep)
        bracket = res.get("idle", {}).get(what)
        if bracket is not None:
            print(f"  device idle share {what}: {ck.bracket_text(bracket)} "
                  f"{ck.tag()}", flush=True)
    line = {k: v for k, v in res.items() if k not in ("data", "decoded")}
    line.update(tool="profile_stages", path=args.path, package=package,
                card=ck.card_line(), cpu_count=os.cpu_count(),
                device=str(args.device))
    print(json.dumps(line, default=str), flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m go_jpeg2000_tpu_torch.tools.profile_stages")
    ap.add_argument("--path", choices=PATHS, default="ht53")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=None,
                    help="side in pixels (default: the path's)")
    ap.add_argument("--tile", type=int, default=512, help="config4's tile")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", type=lambda s: [int(x) for x in
                                                 s.split(",")],
                    default=None, help="native coder threads, e.g. 1,2,4,8")
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time, in turns (repeatable)")
    ap.add_argument("--in-tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


# runs this directory's tools as the package "port_tools" against the
# go_jpeg2000_tpu_torch of the tree argv[1]
_BOOT = ("import importlib, importlib.util, sys\n"
         "tree, here, tool = sys.argv[1:4]\n"
         "sys.path.insert(0, tree)\n"
         "spec = importlib.util.spec_from_file_location('port_tools', "
         "here + '/__init__.py', submodule_search_locations=[here])\n"
         "pkg = importlib.util.module_from_spec(spec)\n"
         "sys.modules['port_tools'] = pkg\n"
         "spec.loader.exec_module(pkg)\n"
         "sys.exit(importlib.import_module('port_tools.' + tool)"
         ".main(sys.argv[4:]))\n")


def tree_argv(argv: List[str]) -> List[str]:
    """argv without its --tree options."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--tree":
            skip = True
        elif not a.startswith("--tree="):
            out.append(a)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    if not args.tree:
        run(argv)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    rest = tree_argv(argv)
    failed = []
    for tree in args.tree:
        tree = os.path.abspath(tree)
        print(f"profile_stages: tree {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", _BOOT, tree, here,
                             "profile_stages"] + rest
                            + ["--in-tree", tree], cwd=tree).returncode
        if rc:
            failed.append((tree, rc))
    if failed:
        print(f"profile_stages: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
