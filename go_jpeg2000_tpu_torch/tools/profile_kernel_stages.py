"""The kernels of one fused HT encode program and one HT decode program,
each between a CUDA event pair (the port of the JAX package's
tools/profile_kernel_stages.py, with tools/profile_fused.py).

    python -m go_jpeg2000_tpu_torch.tools.profile_kernel_stages [H] [N]
        [CHUNK] [--reps R] [--device cuda|cpu]

N gray H^2 frames (512, 8), HTJ2K lossless, 6 resolutions, in chunks of
CHUNK frames (4).  The JAX tool timed jitted prefixes of the program and
took their differences; here each kernel wrapper of
fused_encode.fused_encode_chunk (the DWT levels, block extraction, the
cleanup pass with its bit packing, the pool compaction, and the head: DC
shift and colour transform) and of ht_dec.fused_decode (MagSgn, assembly,
the inverse levels, the tail: inverse colour transform, rounding, DC
shift, clamp and narrowing; head and tail one colour kernel each) runs
under a StageClock (_clock.py) inside the program's own run, with the
program's upload and its parse (native, on the host) as stages of their
own.  Per stage: calls, host ms, the in-program event ms and, for each
kernel, its launches (ops.kernel_launches), which must equal the
wrapper's calls on the card; then the program's glue, the torch ops
between the kernels: program event ms less the stages inside it.  The
breakdown printed is the run of median wall of R (3) after one warm-up.

An event span inside a program holds the host's launch wait wherever the
host lags the card: the end event is recorded only when the wrapper has
launched, so a kernel that the card finishes before the host reaches the
next launch reads as long as the host's time.  That is the "ev" against
"alone" gap of PERF.md's kernel table; the time of a kernel alone is
kernel_times.py's.  The JAX tool's PACK_IMPL sweep has no counterpart
(a TPU-only switch, ROADMAP "Do not port").
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from . import _clock as ck
from ._clock import Stage, arg_bytes, out_bytes

# (stage, the kernels its wrapper launches once a call on the card (5/3
# levels)); the stages before "program" run outside it
ENCODE = (
    (Stage("models.fused_encode", "fetch_pool", "fetch", True, out_bytes),
     ()),
    (Stage("models.fused_encode", "fused_encode_chunk", "program", True),
     ()),
    (Stage("models.transforms", "upload", "upload", True, arg_bytes(0)), ()),
    (Stage("models.transforms", "coefficients",
           "head (DC shift, colour transform)", True), ("mct_forward",)),
    (Stage("models.transforms", "forward_level", "DWT levels", True),
     ("dwt53_fwd_level",)),
    (Stage("ops.ht_enc_cuda", "extract_blocks", "block extraction", True),
     ("ht_extract_blocks",)),
    (Stage("ops.ht_enc_cuda", "cleanup_fields", "cleanup and packing", True),
     ("ht_cleanup_pack",)),
    (Stage("ops.ht_enc_cuda", "assemble_pool", "pool compaction", True),
     ("ht_compact_pool",)))
DECODE = (
    (Stage("models.decoder", "parse_chunk", "native parse"), ()),
    (Stage("models.decoder", "upload_parsed", "upload", True,
           arg_bytes(0, 1, 2)), ()),
    (Stage("ops.ht_dec", "fused_decode", "program", True), ()),
    (Stage("ops.ht_dec_cuda", "magsgn_decode_blocks", "MagSgn", True),
     ("ht_magsgn_decode",)),
    (Stage("ops.ht_dec_cuda", "blocks_to_pyramid", "assembly", True),
     ("ht_blocks_to_pyramid",)),
    (Stage("models.transforms", "inverse_level", "inverse DWT levels", True),
     ("dwt53_inv_level",)),
    (Stage("models.transforms", "samples",
           "tail (inverse colour, DC shift, clamp, narrowing)", True),
     ("mct_inverse",)))


def encode_chunks(frames, opts, chunk, dev):
    """fused_encode_chunk on each chunk of frames, as encode_batch runs
    it, then its fetch: the chunks' (pool, totals) on the host."""
    from go_jpeg2000_tpu_torch.models import encoder, fused_encode
    from go_jpeg2000_tpu_torch.ops import dwt
    from go_jpeg2000_tpu_torch.tcd import geometry as geo
    header, _main = encoder.header_and_main(frames[0], opts)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile)
    nl = tile.comps[0].coding.num_decompositions
    prec = header.components[0].precision
    batch = np.stack([f[None] for f in frames])
    out = []

    def run():
        out.clear()
        for s in range(0, len(frames), chunk):
            sub = batch[s:s + chunk]
            pool, totals = fused_encode.fused_encode_chunk(
                sub, plan, nl, dwt.REV53, False, prec, False, dev)
            out.append(fused_encode.fetch_pool(pool, totals, sub.shape[0],
                                               plan))
        return out
    return run


def decode_chunks(streams, chunk, dev):
    """decode_chunk's device branch on each chunk of streams, then the
    download: the chunks' pixels on the host."""
    from go_jpeg2000_tpu_torch.models import decoder
    from go_jpeg2000_tpu_torch.ops import ht_dec
    batch = decoder.prepare_batch(streams)

    def run():
        out = []
        for s in range(0, len(streams), chunk):
            bodies = batch.bodies[s:s + chunk]
            qinfo, pool, woff = decoder.upload_parsed(
                *decoder.parse_chunk(batch, bodies), dev)
            pix = ht_dec.fused_decode(qinfo, pool, woff, batch.plan,
                                      len(bodies), batch.n_comps, batch.nl,
                                      batch.kind, batch.use_mct,
                                      batch.precision, batch.signed)
            out.append(decoder.download(pix, np.uint8))
        return np.concatenate(out)
    return run


def timed(run, stages, reps: int, dev) -> Dict:
    """reps runs of run() under the clock with the kernels' launches
    counted in each; the median run's report, its launches checked
    against the wrappers' calls on the card."""
    from go_jpeg2000_tpu_torch.ops import kernel_launches, reset_launches
    first = run()
    reports = []
    for _ in range(reps):
        reset_launches()
        out, rep = ck.timed_run(run, [s for s, _k in stages], dev)
        if not ck.same(out, first):
            raise AssertionError("a run differs from the warm-up")
        rep["launches"] = {k: v for k, v in kernel_launches().items() if v}
        reports.append(rep)
    rep = ck.median_report(reports)
    if torch.device(dev).type == "cuda":
        for st, kernels in stages:
            calls = rep["stages"][st.label]["calls"]
            for k in kernels:
                if rep["launches"].get(k, 0) != calls:
                    raise AssertionError(
                        f"{st.label}: {calls} wrapper calls, "
                        f"{rep['launches'].get(k, 0)} launches of {k}")
    program = rep["stages"]["program"]
    labels = [st.label for st, _k in stages]
    inner = labels[labels.index("program") + 1:]
    if program["device_ms"] is not None:
        rep["glue_device_ms"] = program["device_ms"] - sum(
            rep["stages"][lab]["device_ms"] for lab in inner)
    rep["glue_host_ms"] = program["host_ms"]
    return rep, first


def run(argv=None) -> List[Dict]:
    args = parse(argv)
    dev = ck.resolve_device(args.device)
    import go_jpeg2000_tpu_torch as tp
    frames = [ck.natural_image(args.H, args.H, seed=i) for i in range(args.N)]
    opts = tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=6,
                      high_throughput=True)
    enc_run = encode_chunks(frames, opts, args.CHUNK, dev)
    streams = tp.encode_batch(frames, opts, device=dev)
    dec_run = decode_chunks(streams, args.CHUNK, dev)
    out = []
    for what, runner, stages in (("encode", enc_run, ENCODE),
                                 ("decode", dec_run, DECODE)):
        rep, first = timed(runner, stages, args.reps, dev)
        if what == "decode" and not np.array_equal(
                first, np.stack(frames).reshape(-1)):
            raise AssertionError("the decode programs' pixels are not the "
                                 "frames")
        title = (f"profile_kernel_stages {what}, {args.N}x{args.H}^2 gray in "
                 f"chunks of {args.CHUNK}")
        ck.print_report(title, rep)
        glue = rep.get("glue_device_ms")
        print(f"  glue (program less the stages inside it): "
              + ("not measured (no card)" if glue is None
                 else f"{glue:.3f} ms of events")
              + f", host {rep['glue_host_ms']:.2f} ms; launches "
              f"{rep['launches']} {ck.tag()}", flush=True)
        line = dict(rep, tool="profile_kernel_stages", what=what, H=args.H,
                    N=args.N, CHUNK=args.CHUNK, card=ck.card_line(),
                    cpu_count=os.cpu_count(), device=str(args.device))
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m go_jpeg2000_tpu_torch.tools.profile_kernel_stages")
    ap.add_argument("H", type=int, nargs="?", default=512)
    ap.add_argument("N", type=int, nargs="?", default=8)
    ap.add_argument("CHUNK", type=int, nargs="?", default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
