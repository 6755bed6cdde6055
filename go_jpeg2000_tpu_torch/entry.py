"""Entry points of the port (the twin of the JAX package's
__graft_entry__.py).

entry(device):        the single-device forward step on the main path: the
                      fused HT encode program (DC shift, five levels of the
                      5/3 DWT, block extraction, the HT cleanup pass with
                      its bit packing, pool compaction) on two gray 256^2
                      frames.
dryrun_multichip(n):  the tile-sharded encode and decode on a grid of n
                      torch.distributed ranks (halo exchange over sp, the
                      distributed PCRD over dp), held to the single-process
                      encoder and decoder: the JAX function's four checks.
"""
from __future__ import annotations

import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .models import decoder, encoder, fused_encode, transforms
from .models.entropy_backend import require_native
from .ops import cuda_build, dwt
from .options import Format, Options
from .parallel import mesh as pmesh
from .parallel import sharded
from .tcd import geometry as geo


def entry(device="cuda"):
    """(fn, args): fn(*args) runs the fused HT encode program (lossless,
    six resolutions) on a batch of two gray 256^2 frames, uint8 [2, 1, 256,
    256] on `device`, and returns the pool array and its word totals
    (fused_encode.encode_pyramid).  Raises if the block plan refuses the
    shape; there is no transform-only fallback."""
    dev = transforms.resolve_device(device)
    n, h, w, levels = 2, 256, 256, 5
    opts = Options(format=Format.J2K, lossless=True,
                   num_resolutions=levels + 1, high_throughput=True)
    header = encoder.build_header(np.zeros((h, w), np.uint8), opts)
    plan = fused_encode.plan_for(header, geo.build_tile(header, 0))
    if plan is None:
        raise RuntimeError("entry: the fused HT encode has no block plan "
                           "for 256^2 frames at six resolutions")
    precision = header.components[0].precision

    def forward_step(batch: torch.Tensor):
        pyr = transforms.forward_pyramid(batch, levels, dwt.REV53, False,
                                         precision, False, 0, 0)
        return fused_encode.encode_pyramid(pyr, plan, batch.shape[0], levels)

    example = torch.zeros((n, 1, h, w), dtype=torch.uint8, device=dev)
    return forward_step, (example,)


def _dryrun_checks(grid: pmesh.Grid, device) -> None:
    """The JAX dryrun_multichip's four checks on `grid` (every rank of the
    grid runs them), with the device work on `device`."""
    sp, dp = grid.sp, grid.dp
    levels = 2
    th = sp * (1 << levels) * 2            # tile dims: sp * 2^levels | th
    tw = max(32, 1 << levels)
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, size=(th * 2, tw * dp, 3)).astype(np.float32)
    for ax in (0, 1):
        img = (img + np.roll(img, 1, axis=ax)) / 2
    img = img.astype(np.uint8)

    def opts(**kw):
        return Options(format=Format.J2K, num_resolutions=levels + 1,
                       tile_size=(tw, th), **kw)

    # lossless Part-1: sharded bytes == single-process bytes; decodes exact
    o1 = opts(lossless=True)
    data = sharded.encode_sharded(img, o1, grid, device)
    assert data == encoder.encode(img, o1, device), \
        "sharded codestream differs from single-process"
    assert np.array_equal(decoder.decode(data, device=device), img), \
        "sharded decode is not pixel-exact"
    assert np.array_equal(sharded.decode_sharded(data, None, grid, device),
                          img), "grid-sharded decode is not pixel-exact"

    # budgeted: the distributed PCRD must match the local one
    o2 = opts(lossless=True, num_layers=2, compression_ratio=6.0)
    data2 = sharded.encode_sharded(img, o2, grid, device)
    assert data2 == encoder.encode(img, o2, device), \
        "distributed PCRD diverged from local PCRD"
    assert decoder.decode(data2, device=device).shape == img.shape

    # HT: the device HT encode inside the sharded pipeline
    o3 = opts(lossless=True, high_throughput=True)
    data3 = sharded.encode_sharded(img, o3, grid, device)
    assert data3 == encoder.encode(img, o3, device), \
        "sharded HT codestream differs from single-process"
    assert np.array_equal(decoder.decode(data3, device=device), img), \
        "sharded HT decode is not pixel-exact"

    # lossy 9/7 HT: quality parity with the single-process encoder
    o4 = opts(lossless=False, quality=85, high_throughput=True)
    data4 = sharded.encode_sharded(img, o4, grid, device)
    dec4 = decoder.decode(data4, device=device)
    dec4g = sharded.decode_sharded(data4, None, grid, device)
    assert np.max(np.abs(dec4g.astype(np.int32)
                         - dec4.astype(np.int32))) <= 1, \
        "grid-sharded lossy decode diverged from the general decoder"
    mse = np.mean((dec4.astype(np.float64) - img) ** 2)
    single = decoder.decode(encoder.encode(img, o4, device), device=device)
    mse_single = np.mean((single.astype(np.float64) - img) ** 2)
    assert mse <= mse_single * 1.02 + 1e-9, \
        "sharded lossy quality fell below the single-process encoder"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, world: int, init_method: str, backend: str,
                 device: str) -> None:
    """One rank of dryrun_multichip."""
    if device == "cpu":
        torch.set_num_threads(1)          # the ranks share the host's cores
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=600))
    try:
        _dryrun_checks(pmesh.make_grid(dist.group.WORLD), device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The tile-sharded pipeline on n_devices ranks (make_grid's default
    (dp, sp) split), each running the four checks against the
    single-process encoder and decoder; a failed check raises.  n_devices
    = 1 runs in this process on a grid of one.  Otherwise the ranks are
    spawned processes meeting at a localhost TCP address: NCCL where every
    rank has a card of its own, else gloo (the collectives through host
    tensors, the kernels still on the card: on one card every rank shares
    it, as NCCL takes no two ranks on one GPU)."""
    dev = transforms.resolve_device(device)
    require_native()
    if dev.type == "cuda":
        cuda_build.build()
    if n_devices <= 1:
        _dryrun_checks(pmesh.make_grid(), dev)
        return
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend = "nccl"
    mp.spawn(_dryrun_rank,
             args=(n_devices, f"tcp://127.0.0.1:{_free_port()}", backend,
                   dev.type),
             nprocs=n_devices, join=True)
