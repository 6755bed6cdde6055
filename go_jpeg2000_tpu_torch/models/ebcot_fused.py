"""Device EBCOT encode: image batch -> MQ codeword segments on the device.

Port of go_jpeg2000_tpu/models/ebcot_fused.py.  One device program per chunk
of frames runs DC shift, RCT and the 5/3 DWT levels (models/transforms.py),
code-block extraction (the ht_extract_blocks kernel on the lossless plan),
then the EBCOT Tier-1 decisions, their compaction, the MQ coder and the
segment pool (ops/ebcot_cuda.py: the CUDA kernels of csrc/ebcot_enc.cu on
the card, their plain torch versions on the CPU).  The host fetches the
used prefix of the pool and each block's segment length, bit-plane count
and distortion, and assembles Tier-2 packets.

Two programs, as in the JAX package:
  path A (`ebcot_encode_chunk`, backend "device" or "auto"): everything up
    to the segment pool on the device;
  path B (`ebcot_decisions_chunk`, backend "hybrid"): the device stops at
    the pooled decision streams, which the native mq_encode_streams codes
    on the host.

Both give one MQ segment a block with a single truncation point: valid for
one quality layer without a byte budget only (the callers check).  The
pools are sized from counts and scans computed on the device, so nothing
overflows and nothing is retried.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..codestream.header import Header
from ..native import loader
from ..ops import block_layout, dwt, ebcot_cuda, ht_enc_cuda, t1
from ..tcd import geometry as geo
from . import fused_encode, transforms
from .fused_encode import BlockPlan


def plan_for(header: Header, tile: geo.Tile) -> Optional[BlockPlan]:
    """The lossless block plan of plain style-0 EBCOT code-blocks, or None
    where the fused geometry does not apply: the decision kernel needs
    blocks of whole 4-row stripes, and a plane for each of a block's Mb
    bitplanes (max_planes caps them at 29: gray samples of 27 bits and
    up code on the host)."""
    plan = fused_encode.plan_for(header, tile, ht=False)
    if plan is None or plan.cbh % 4 or max_planes(plan) < int(plan.mb.max()):
        return None
    return plan


def max_planes(plan: BlockPlan) -> int:
    """Bitplanes the decisions cover: the plan's largest Mb."""
    return plan.max_mn - 2


_CLASSES: Dict = {}


def block_inputs(blocks: torch.Tensor, plan: BlockPlan, n: int):
    """The decision kernel's inputs of a block batch int32 [n*nb, cbh, cbw]:
    (mags int32, signs int32 (1 = negative), band classes int32 [n*nb],
    valid bool [n*nb, cbh, cbw])."""
    dev = blocks.device
    bclass = block_layout.plan_cache(
        _CLASSES, plan, (n, dev), lambda: torch.from_numpy(
            np.tile(plan.bclass, n).astype(np.int32)).to(dev))
    hs, ws = fused_encode._block_dims(plan, n, dev)
    yy = torch.arange(plan.cbh, dtype=torch.int32, device=dev).view(1, -1, 1)
    xx = torch.arange(plan.cbw, dtype=torch.int32, device=dev).view(1, 1, -1)
    valid = (yy < hs.view(-1, 1, 1)) & (xx < ws.view(-1, 1, 1))
    return blocks.abs(), (blocks < 0).to(torch.int32), bclass, valid


def numbps(mags: torch.Tensor, valid: torch.Tensor,
           planes: int) -> torch.Tensor:
    """Per block, the bitplanes its largest valid magnitude needs (at most
    `planes`), int32 [B]."""
    maxmag = torch.where(valid, mags, torch.zeros_like(mags)).amax(
        dim=(1, 2))
    out = torch.zeros_like(maxmag)
    for p in range(planes):
        out += ((maxmag >> p) > 0).to(out.dtype)
    return out


def dist(mags: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per block, the sum of the valid squared magnitudes, float32 [B]."""
    m = torch.where(valid, mags, torch.zeros_like(mags)).to(torch.float32)
    return (m * m).sum(dim=(1, 2))


@dataclasses.dataclass
class ChunkOut:
    """What one chunk's device program leaves on the device."""
    n: int                        # frames
    pool: torch.Tensor            # uint8: segments (A) or decisions (B)
    total: torch.Tensor           # int64 [1]: used bytes of pool
    lens: torch.Tensor            # int32 [B]: segment lengths (A) or ndec (B)
    numbps: torch.Tensor          # int32 [B]
    dist: torch.Tensor            # float32 [B]


def _decisions(batch: np.ndarray, plan: BlockPlan, levels: int,
               use_mct: bool, precision: int, signed: bool, device):
    """The shared head of both programs: upload, DC shift, RCT, the 5/3
    levels, block extraction and the decision slots.  Returns (slots,
    numbps, dist)."""
    dev = torch.device(device)
    n = batch.shape[0]
    pyr = transforms.forward_pyramid(transforms.upload(batch, dev), levels,
                                     dwt.REV53, use_mct, precision, signed,
                                     0, 0)
    blocks = ht_enc_cuda.extract_blocks(pyr, plan, n, levels)
    del pyr
    mags, signs, bclass, valid = block_inputs(blocks, plan, n)
    del blocks
    planes = max_planes(plan)
    slots = ebcot_cuda.decision_slots(mags, signs, bclass, valid, planes)
    return slots, numbps(mags, valid, planes), dist(mags, valid)


def ebcot_encode_chunk(batch: np.ndarray, plan: BlockPlan, levels: int,
                       use_mct: bool, precision: int, signed: bool,
                       device) -> ChunkOut:
    """Path A, the device program of one chunk of frames [N, C, H, W]
    (narrow host samples): the decisions, their compaction, the MQ coder
    and the segment pool."""
    slots, nbp, d = _decisions(batch, plan, levels, use_mct, precision,
                               signed, device)
    dec, ndec, off, largest = ebcot_cuda.compact_rows(slots)
    del slots
    rows, lens = ebcot_cuda.mq_encode(dec, ndec, off, largest)
    del dec
    pool, total = ebcot_cuda.pool_rows(rows, off, lens)
    return ChunkOut(batch.shape[0], pool, total, lens, nbp, d)


def ebcot_decisions_chunk(batch: np.ndarray, plan: BlockPlan, levels: int,
                          use_mct: bool, precision: int, signed: bool,
                          device) -> ChunkOut:
    """Path B, the device program of one chunk: the decisions and their
    compaction into one pool of decision streams."""
    slots, nbp, d = _decisions(batch, plan, levels, use_mct, precision,
                               signed, device)
    dec, ndec, _off, _largest = ebcot_cuda.compact_rows(slots)
    total = torch.tensor([dec.numel()], dtype=torch.int64)
    return ChunkOut(batch.shape[0], dec, total, ndec, nbp, d)


def fetch(out: ChunkOut):
    """Copy a chunk's results to the host: the used bytes of the pool (the
    total first, which waits for the device), then lens, numbps and dist
    in one copy.  Returns (pool uint8, lens int64, numbps int32, dist
    float32)."""
    total = int(out.total.cpu()[0])
    meta = torch.stack([out.lens, out.numbps,
                        out.dist.view(torch.int32)]).cpu().numpy()
    used = out.pool[:total]
    if used.is_cuda:
        host = torch.empty(used.shape, dtype=used.dtype, pin_memory=True)
        host.copy_(used)
        used = host
    return (used.numpy(), meta[0].astype(np.int64), meta[1],
            meta[2].view(np.float32))


def _split(pool: np.ndarray, lens: np.ndarray) -> List[bytes]:
    ends = np.cumsum(lens)
    return [pool[e - ln:e].tobytes() for e, ln in zip(ends, lens)]


def fetch_results(out: ChunkOut) -> List[t1.T1EncodeResult]:
    """Path A: per-block results in canonical job order (frame-major)."""
    pool, lens, nbp, d = fetch(out)
    return [_single_segment_result(seg, int(b), float(x))
            for seg, b, x in zip(_split(pool, lens), nbp, d)]


def fetch_results_hybrid(out: ChunkOut) -> List[t1.T1EncodeResult]:
    """Path B: fetch the decision streams and MQ-code them on the host
    (native), then per-block results as fetch_results."""
    pool, ndec, nbp, d = fetch(out)
    segs = loader.mq_encode_streams(_split(pool, ndec))
    return [_single_segment_result(seg, int(b), float(x))
            for seg, b, x in zip(segs, nbp, d)]


def _single_segment_result(seg: bytes, nbp: int,
                           distortion: float) -> t1.T1EncodeResult:
    """Result for a block coded as one MQ segment spanning all its passes:
    every pass reports the final rate and only the last carries the
    distortion, so there is one truncation point.  Valid only for one
    quality layer without a byte budget, where rate allocation never looks
    at intermediate passes."""
    if nbp == 0:
        return t1.T1EncodeResult(b"", 0, [], [])
    if seg and seg[-1] == 0xFF:
        seg = seg[:-1]                      # the flush's trailing-0xFF strip
    npasses = 3 * nbp - 2
    passes = [t1.PassInfo(
        pass_type=(2 if j == 0 else (j - 1) % 3), bitplane=0,
        rate=len(seg), distortion=(distortion if j == npasses - 1 else 0.0),
        terminated=(j == npasses - 1)) for j in range(npasses)]
    return t1.T1EncodeResult(seg, nbp, passes, [len(seg)])
