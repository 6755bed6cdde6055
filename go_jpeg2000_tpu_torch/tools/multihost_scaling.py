"""Multi-host scaling of the process-decomposed encoder (BASELINE config
5's efficiency table; the port of the JAX package's
tools/multihost_scaling.py).

    python -m go_jpeg2000_tpu_torch.tools.multihost_scaling [--size S]
        [--rgb] [--hosts 1,2,4] [--device cuda|cpu]

encode_multihost (parallel/multihost.py) at each host count, with one
warm-up run in the hosts, so that the compute wall leaves out the spawn
and the first-call builds.  Default: the JAX tool's case, an S^2 gray
image (1024) of noise smoothed twice by two taps, 256^2 tiles (16 at
1024^2), HTJ2K lossless, 4 resolutions.  --rgb: config 5, as chip_smoke.py
runs it, an S^2 RGB image of three natural_image planes (seeds 800-802;
give --size 4096), 512^2 tiles, HTJ2K lossless, 2 layers at 6:1.

Each host count's codestream must equal `encode`'s on the same device.
Per count: compute wall (the hosts' measured run, from their start
barrier), Mpix/s, speedup and efficiency against the first count,
reduction rounds, gathered bytes, the measured run's kernel launches
summed over the hosts, and hosts x native threads against os.cpu_count():
every spawned host's native coder starts a pool of os.cpu_count() threads
(native/loader.py _nthreads), so 4 hosts run 4 pools on the same cores.
The tool shows that and changes nothing of it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import _clock as ck


def image_and_options(args):
    import go_jpeg2000_tpu_torch as tp
    if args.rgb:
        img = np.stack([ck.natural_image(args.size, args.size, seed=800 + c)
                        for c in range(3)], axis=-1)
        opts = tp.Options(format=tp.Format.J2K, lossless=True,
                          high_throughput=True, tile_size=(512, 512),
                          num_layers=2, compression_ratio=6.0)
        return img, opts, "config 5"
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, size=(args.size, args.size)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    tile = max(1, args.size // 4)
    opts = tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=4,
                      tile_size=(tile, tile), high_throughput=True)
    return a.astype(np.uint8), opts, "gray"


def run(argv=None):
    args = parse(argv)
    dev = ck.resolve_device(args.device)
    import go_jpeg2000_tpu_torch as tp
    from go_jpeg2000_tpu_torch.parallel import encode_multihost
    img, opts, label = image_and_options(args)
    t0 = time.perf_counter()
    ref = tp.encode(img, opts, device=dev)
    single_ms = (time.perf_counter() - t0) * 1e3
    mpix = img.shape[0] * img.shape[1] / 1e6
    cores = os.cpu_count()
    print(f"multihost_scaling {label}: image {img.shape}, {mpix:.2f} Mpix, "
          f"tiles {opts.tile_size}, single-process encode {len(ref)} bytes "
          f"in {single_ms:.1f} ms (first call) {ck.tag()}", flush=True)
    rows = []
    base = None
    for n in args.hosts:
        stats = {}
        t0 = time.perf_counter()
        data = encode_multihost(img, opts, n_hosts=n, _stats=stats,
                                warmups=1, device=dev)
        total_ms = (time.perf_counter() - t0) * 1e3
        if data != ref:
            raise AssertionError(f"{n} hosts: the codestream differs from "
                                 "encode's")
        wall = stats["compute_wall_s"]
        base = base or (wall, n)
        speedup = base[0] / wall
        eff = speedup * base[1] / n
        threads = n * cores     # one pool of cpu_count threads a host
        row = {"tool": "multihost_scaling", "case": label, "hosts": n,
               "compute_wall_ms": wall * 1e3, "call_ms": total_ms,
               "mpix_s": mpix / wall, "speedup": speedup,
               "efficiency": eff, "reduce_rounds": stats["reduce_rounds"],
               "gathered_bytes": stats["gathered_bytes"],
               "host_launches": stats["host_launches"],
               "native_threads": threads, "cpu_count": cores,
               "bytes": len(data), "card": ck.card_line(),
               "device": str(args.device)}
        print(f"hosts={n}: compute {wall * 1e3:.1f} ms ({mpix / wall:.2f} "
              f"Mpix/s), speedup {speedup:.2f}x, efficiency {eff:.2f}, "
              f"reduce rounds {stats['reduce_rounds']}, gathered "
              f"{stats['gathered_bytes']} bytes, launches "
              f"{sum(stats['host_launches'].values())}, native threads "
              f"{n} x {cores} = {threads} on {cores} cores; call "
              f"{total_ms:.1f} ms; byte-identical to encode {ck.tag()}",
              flush=True)
        print(json.dumps(row), flush=True)
        rows.append(dict(row, data=data))
    return rows


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m go_jpeg2000_tpu_torch.tools.multihost_scaling")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--rgb", action="store_true",
                    help="config 5's image and options")
    ap.add_argument("--hosts", type=lambda s: [int(x) for x in s.split(",")],
                    default=[1, 2, 4])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
