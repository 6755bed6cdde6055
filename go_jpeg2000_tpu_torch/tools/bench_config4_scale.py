"""Config 4 (BASELINE.json row 4: multi-tile 16-bit RGB with the MCT,
sharded) at several sizes, through the port's encode_sharded and
decode_sharded (the port of the JAX package's
tools/bench_config4_scale.py, which ran bench.sharded_config4).

    python -m go_jpeg2000_tpu_torch.tools.bench_config4_scale [size ...]
        [--dp DP --sp SP] [--device cuda|cpu]

Each size (default 2048 4096; 8192 is BASELINE's) takes tile = size // 4
(16 tiles) and 5 resolutions, on bench.py's image (smooth 16-bit RGB
noise, seed 1).  The legs, each a warm-up and then the best of 2 by the
host clock (the decode ends in the pixels on the host, so no run ends
with device work queued):
- ht: HTJ2K lossless encode and decode; the round trip must be exact;
- ebcot: Part-1 lossless encode (the host block coder per tile); its
  decode must give the image back;
- lossy97: HTJ2K 9/7 at quality 85 on the image >> 8, encode and decode;
  the decode's PSNR must exceed 25 dB, as bench.py checks.
One row per size, in Mpix/s and ms, and one JSON line.

--dp and --sp run the legs on a (dp, sp) grid of dp * sp spawned gloo
ranks sharing the one card (or the CPU), each rank timing its calls
between barriers; the row shows the slowest rank's best.  spawn_ranks is
the spawn, rendezvous and collection code that chip_smoke.py's phase 19
uses too.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import sys
import time
from typing import Dict

import numpy as np
import torch

from . import _clock as ck
from .profile_stages import config4_image

LEGS = ("ht enc", "ht dec", "ebcot enc", "lossy97 enc", "lossy97 dec")


def free_port() -> int:
    """A free TCP port on this host for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(target, world: int, args: tuple, timeout: float = 600,
                what: str = "grid") -> Dict[int, object]:
    """Run target(rank, world, port, *args, queue) in `world` spawned
    processes that meet at tcp://127.0.0.1:port; each puts (rank, its
    result) or (rank, an error string) on the queue.  Returns {rank:
    result}; raises AssertionError if a rank fails or the ranks give no
    result within `timeout` s, and stops every process it started."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(r, world, port) + tuple(args) + (results,),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.perf_counter() + timeout
        while len(got) < world:
            try:
                rank, res = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                raise AssertionError(f"{what}: ranks "
                                     f"{sorted(set(range(world)) - set(got))}"
                                     f" gave no result in {timeout} s")
            if isinstance(res, str):
                raise AssertionError(f"{what} rank {rank}: {res}")
            got[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return got


def legs(size: int, dev, grid=None) -> Dict[str, float]:
    """Seconds of each leg at `size` (best of 2 after a warm-up), every
    round trip checked; `grid` a torch.distributed grid or None."""
    import go_jpeg2000_tpu_torch as tp
    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    img = config4_image(size)
    tile = size // 4
    barrier = (lambda: None) if grid is None else torch.distributed.barrier

    def best(fn):
        out = fn()
        times = []
        for _ in range(2):
            barrier()
            t0 = time.perf_counter()
            again = fn()
            times.append(time.perf_counter() - t0)
            ok = (again == out if isinstance(out, bytes)
                  else np.array_equal(again, out))
            if not ok:
                raise AssertionError(f"config 4 at {size}: a run differs "
                                     "from the warm-up")
        return out, min(times)

    def opts(lossless, ht):
        return tp.Options(format=tp.Format.J2K, lossless=lossless,
                          quality=85, num_resolutions=5,
                          tile_size=(tile, tile), high_throughput=ht)

    enc = lambda im, o: encode_sharded(im, o, grid=grid, device=dev)  # noqa
    dec = lambda d: decode_sharded(d, grid=grid, device=dev)  # noqa
    out = {}
    ht = opts(True, True)
    data, out["ht enc"] = best(lambda: enc(img, ht))
    pix, out["ht dec"] = best(lambda: dec(data))
    if not np.array_equal(pix, img):
        raise AssertionError(f"config 4 at {size}: the HT round trip is not "
                             "exact")
    data, out["ebcot enc"] = best(lambda: enc(img, opts(True, False)))
    if not np.array_equal(dec(data), img):
        raise AssertionError(f"config 4 at {size}: the Part-1 round trip is "
                             "not exact")
    img8 = (img >> 8).astype(np.uint8)
    data, out["lossy97 enc"] = best(lambda: enc(img8, opts(False, True)))
    pix, out["lossy97 dec"] = best(lambda: dec(data))
    out["lossy97 psnr"] = ck.psnr(pix, img8)
    if not out["lossy97 psnr"] > 25.0:
        raise AssertionError(f"config 4 at {size}: lossy PSNR "
                             f"{out['lossy97 psnr']:.2f} dB")
    return out


def _rank(rank, world, port, dp, sp, size, device, queue):
    """One rank of a --dp/--sp grid: the legs at `size` on the grid."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    except BaseException as exc:
        queue.put((rank, f"{type(exc).__name__}: {exc}"))
        raise
    try:
        from go_jpeg2000_tpu_torch.parallel import make_grid
        grid = make_grid(dist.group.WORLD, dp=dp, sp=sp)
        queue.put((rank, legs(size, dev, grid)))
    except BaseException as exc:
        queue.put((rank, f"{type(exc).__name__}: {exc}"))
        raise
    finally:
        dist.destroy_process_group()


def run(argv=None):
    args = parse(argv)
    dev = ck.resolve_device(args.device)
    world = args.dp * args.sp
    print(f"config 4 through encode_sharded/decode_sharded, grid (dp, sp) = "
          f"{(args.dp, args.sp)}: Mpix/s (ms), best of 2 after a warm-up "
          f"{ck.tag()}", flush=True)
    print("| size | tiles | " + " | ".join(LEGS) + " | lossy PSNR |")
    print("|---" * (len(LEGS) + 3) + "|")
    rows = []
    for size in args.sizes:
        if world == 1:
            res = legs(size, dev)
        else:
            ranks = spawn_ranks(_rank, world, (args.dp, args.sp, size,
                                               str(dev)),
                                what=f"config 4 grid {(args.dp, args.sp)}")
            res = {k: max(r[k] for r in ranks.values()) for k in LEGS}
            res["lossy97 psnr"] = ranks[0]["lossy97 psnr"]
        mpix = size * size / 1e6
        cells = [f"{mpix / res[k]:.2f} ({res[k] * 1e3:.1f})" for k in LEGS]
        print(f"| {size}^2 | 4x4 | " + " | ".join(cells)
              + f" | {res['lossy97 psnr']:.2f} dB | {ck.tag()}", flush=True)
        line = {"tool": "bench_config4_scale", "size": size, "tile": size // 4,
                "dp": args.dp, "sp": args.sp, "seconds": res,
                "card": ck.card_line(), "cpu_count": os.cpu_count(),
                "device": str(args.device)}
        print(json.dumps(line), flush=True)
        rows.append(line)
    return rows


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m go_jpeg2000_tpu_torch.tools.bench_config4_scale")
    ap.add_argument("sizes", type=int, nargs="*", default=[2048, 4096])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
