"""Batch decoder: HTJ2K or Part-1 J2K codestreams -> frames.

Port of go_jpeg2000_tpu/models/decoder.py `_decode_batch_fused` (HTJ2K) and
of the slice's part of `_decode_tile` (Part-1 EBCOT).  The device HT
branch (every HT stream whose tile origin is (0, 0)): the native C++
library runs Tier-2 and the HT cleanup's control phase, MEL, CxtVLC and
UVLC, for every block of a chunk of frames in one call
(ht_t2_parse_frames); only its per-quad words and the unstuffed MagSgn pool
go to the device, where ops/ht_dec.py `fused_decode` extracts the MagSgn
values and assembles the pyramid (the CUDA kernels of csrc/ht_dec.cu on the
card), with the midpoint dequantization of 9/7 plans, and runs the inverse
DWT (the CUDA level kernels), inverse RCT/ICT, DC shift, clamp and
narrowing.  The host branch, for a tile origin off (0, 0): the native call
decodes every block on the host (ht_t2_decode_frames), the slots become
leaves in numpy (`_blocks_to_pyramid`) and ride one flat upload to the
same inverse chain.  The EBCOT branch: the Python Tier-2 per frame, the
native T1 decoder for every block of a chunk of frames in one call, one
upload of the block slots, and on the device the block-to-pyramid
assembly (the ht_blocks_to_pyramid kernel on the card), the inverse 5/3
levels and the inverse RCT.  Counters: dec.device_ht_chunks,
dec.host_ht_frames, dec.ebcot_frames.

The slices: single-tile, single-layer, lossless 5/3 or lossy 9/7 HT J2K
streams and lossless 5/3 Part-1 streams of code-block style 0, of one
shape, without SOP/EPH/PPM/PPT, decoded whole.  Everything else raises
NotImplementedError naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..codestream.parser import Parser
from ..native import loader
from ..ops import dwt, ht_dec, ht_dec_cuda
from ..options import Config, Format
from ..tcd import geometry as geo
from ..tcd import t2
from ..utils import markers as mk
from ..utils.bio import BitReader
from ..utils.metrics import counters
from . import fused_encode, transforms
from .encoder import _chunk_frames
from .entropy_backend import decode_blocks_batch, require_native


# Peak device bytes per sample (frame pixels times components) of one chunk
# of the device HT decode: the int32 block slots (4 B and the padding of
# small bands), the quad words (1 B), the pool (about the stream's size),
# the leaves (4 B) and the inverse chain's int32 or float32 tensors.
# chip_smoke.py measured 13.9 (32 x 512^2 gray, lossless) and 21.7
# (2 x 2048^2 RGB, lossy) on an H100; 16-bit streams carry a larger pool.
DECODE_BYTES_PER_SAMPLE = 28
# device memory one chunk of the decode may take
DECODE_CHUNK_BYTES = 1 << 31


class DecodeError(ValueError):
    pass


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def sniff_format(data: bytes):
    """Returns (Format.J2K, codestream_bytes, None) for a raw codestream."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return Format.J2K, data, None
    if len(data) >= 12 and data[4:8] == b"jP \x20":
        raise _not_ported("JP2 decoding", "6")
    raise DecodeError("not a JPEG 2000 file (no JP2 signature or SOC)")


def _check_slice(parsed, config: Config) -> None:
    if config.decode_area is not None or config.reduce_resolution:
        raise _not_ported("region and reduced-resolution decoding", "6")
    h0 = parsed[0][0]
    for hdr, tile_parts, _ in parsed:
        cs = hdr.coding_style
        if (hdr.width, hdr.height, hdr.num_components) != \
                (h0.width, h0.height, h0.num_components) \
                or cs.num_decompositions != \
                h0.coding_style.num_decompositions \
                or cs.mct != h0.coding_style.mct \
                or [(c.precision, c.signed) for c in hdr.components] != \
                [(c.precision, c.signed) for c in h0.components]:
            raise _not_ported("batches of differing stream geometry", "6")
        if hdr.num_tiles != 1:
            raise _not_ported("multi-tile decoding", "6")
        if cs.transform != h0.coding_style.transform:
            raise _not_ported("batches mixing 5/3 and 9/7 streams", "6")
        if (cs.cb_style & mk.CBSTYLE_HT) != \
                (h0.coding_style.cb_style & mk.CBSTYLE_HT):
            raise _not_ported("batches mixing HT and Part-1 streams", "6")
        if not cs.cb_style & mk.CBSTYLE_HT:
            if cs.transform != 1:
                raise _not_ported("lossy EBCOT (Part 1) decoding", "7")
            if cs.cb_style:
                raise _not_ported(f"code-block style {cs.cb_style:#x}", "6")
        if cs.num_layers != 1:
            raise _not_ported("quality layers", "6")
        if (cs.has_sop or cs.has_eph or hdr.ppm
                or any(tp.packed_headers for tp in tile_parts)):
            raise _not_ported("SOP/EPH/PPM/PPT streams", "6")
        if any(c.signed or not 8 <= c.precision <= 16
               for c in hdr.components):
            raise _not_ported("signed or out-of-range sample precision", "6")


def _blocks_to_pyramid(coeffs: np.ndarray, plan, n: int, n_comps: int,
                       nl: int):
    """Inverse of the fused encode's block extraction: padded block slots
    [N, nb, CBH, CBW] -> stacked pyramid leaves [N, C, bh, bw] (numpy)."""
    levels = max(1, nl)
    stacked = [dict() for _ in range(levels)]
    per_band = {}   # (lev_key, name) -> list of [N, bh, bw] per comp
    base = 0
    for (c, lev, name, gy, gx, eh, ew, bh, bw, oy, ox) in plan.band_specs:
        blk = coeffs[:, base:base + gy * gx, :eh, :ew]
        base += gy * gx
        blk = blk.reshape(n, gy, gx, eh, ew)
        if oy:   # offset grid: first-row slots anchor at oy
            blk = np.concatenate(
                [np.roll(blk[:, :1], oy, axis=-2), blk[:, 1:]], axis=1)
        if ox:
            blk = np.concatenate(
                [np.roll(blk[:, :, :1], ox, axis=-1), blk[:, :, 1:]], axis=2)
        a = (blk.transpose(0, 1, 3, 2, 4)
             .reshape(n, gy * eh, gx * ew)[:, oy:oy + bh, ox:ox + bw])
        per_band.setdefault((lev, name), []).append(a)
    for (lev, name), comps in per_band.items():
        # [N, C, bh, bw]
        stacked[ht_dec.leaf_level(lev, name, nl)][name] = np.stack(comps, axis=1)
    return stacked


def _pyramid_deltas(plan, nl: int):
    """The plan's per-band quantizer steps, shaped like _blocks_to_pyramid's
    result: per level, band -> one step per component."""
    deltas = [dict() for _ in range(max(1, nl))]
    for (_c, lev, name, *_), d in zip(plan.band_specs, plan.deltas):
        deltas[ht_dec.leaf_level(lev, name, nl)].setdefault(name, []).append(d)
    return deltas


@dataclasses.dataclass
class Batch:
    """A batch of same-shape streams, parsed to their tile bodies, with what
    both decode branches need to know of them."""
    bodies: List[bytes]       # each stream's tile-part data, joined
    tile: geo.Tile
    plan: fused_encode.BlockPlan
    geom: Dict
    kind: str
    use_mct: bool
    precision: int
    signed: bool
    n_comps: int
    nl: int
    on_device: bool           # tile origin (0, 0): the device HT branch
    header: object = None     # the first stream's main header
    ht: bool = True           # HT code-blocks (else Part-1 EBCOT)


def prepare_batch(streams, config: Optional[Config] = None) -> Batch:
    """Parse the streams' headers and tile parts, check that they are in
    the slice, and find the block plan and packet walk."""
    config = config or Config()
    parsed = []
    for s in streams:
        _fmt, codestream, _jp2 = sniff_format(s)
        parser = Parser(codestream)
        header = parser.read_header()
        parsed.append((header, parser.read_all_tile_parts(header),
                       codestream))
    _check_slice(parsed, config)
    header = parsed[0][0]
    tile = geo.build_tile(header, 0)
    lossless = header.coding_style.transform == 1
    ht = bool(header.coding_style.cb_style & mk.CBSTYLE_HT)
    on_device = tile.comps[0].x0 == 0 and tile.comps[0].y0 == 0
    # a tile origin off (0, 0) gives offset code-block grids, which only
    # the multi-tile plans describe
    plan = fused_encode.plan_for(header, tile, ht=ht,
                                 multi_tile=not on_device,
                                 lossy=not lossless)
    if plan is None:
        raise _not_ported("this code-block/precinct geometry or origin", "6")
    require_native()
    n_comps = header.num_components
    return Batch(
        bodies=[b"".join(cs[tp.data_start:tp.data_end] for tp in tps)
                for _hdr, tps, cs in parsed],
        tile=tile, plan=plan, geom=fused_encode.t2_geom(header, tile, plan),
        kind=dwt.REV53 if lossless else dwt.IRR97,
        use_mct=bool(header.coding_style.mct) and n_comps >= 3,
        precision=header.components[0].precision,
        signed=header.components[0].signed, n_comps=n_comps,
        nl=tile.comps[0].coding.num_decompositions, on_device=on_device,
        header=header, ht=ht)


def _native_args(batch: Batch, bodies: List[bytes]):
    """The native T2 calls' arguments for these bodies."""
    frame_off = np.zeros(len(bodies) + 1, np.int64)
    np.cumsum([len(d) for d in bodies], out=frame_off[1:])
    plan = batch.plan
    return (np.frombuffer(b"".join(bodies), dtype=np.uint8), frame_off,
            len(bodies), plan.nb, batch.geom, batch.geom["mb"], plan.ws,
            plan.hs, plan.cbh, plan.cbw)


def _refused() -> NotImplementedError:
    return _not_ported("HT refinement passes (or truncated streams)", "6")


def parse_chunk(batch: Batch, bodies: List[bytes]):
    """The host's control phase (native T2 + MEL/VLC parse) of some frames:
    (quad words uint32 [n*nb, qh, qw], MagSgn pool uint32 [P], block word
    offsets int64 [n*nb])."""
    out = loader.ht_t2_parse_frames(*_native_args(batch, bodies))
    if out is None:
        raise _refused()
    return out[:3]


def upload_parsed(qinfo: np.ndarray, pool: np.ndarray, woff: np.ndarray,
                  dev: torch.device):
    """The parse's arrays on the device; uint32 words travel as their int32
    bit patterns."""
    return (torch.from_numpy(qinfo.view(np.int32)).to(dev),
            torch.from_numpy(pool.view(np.int32)).to(dev),
            torch.from_numpy(woff).to(dev))


def ebcot_jobs(batch: Batch, body: bytes) -> List:
    """Tier-2 of one Part-1 frame (the slice's part of the JAX package's
    _decode_tile): per block of the plan, in canonical job order, its T1
    decode job (data, w, h, numbps, num_passes, band, cb_style,
    segment_lengths), or None where the block carries no pass."""
    header, tile = batch.header, batch.tile
    pd_map: Dict = {}
    for c, tc in enumerate(tile.comps):
        for res in tc.resolutions:
            for p_idx in range(res.num_px * res.num_py):
                pd_map[(c, res.r, p_idx)] = [
                    t2.PrecinctDecoder(band.precincts[p_idx])
                    for band in res.bands]
    cb_style = header.coding_style.cb_style
    pos = 0
    for pid in t2.packet_sequence(tile, header):
        if pos >= len(body):
            break
        pds = pd_map.get((pid.comp, pid.res, pid.precinct), [])
        br = BitReader(body[pos:], stuffing=True)
        decoded = t2.decode_packet_header(br, pds, pid.layer, cb_style)
        br.align()
        pos = t2.apply_packet_body(body, pos + br.bytes_consumed(), decoded,
                                   cb_style)
    jobs = []
    for c, tc in enumerate(tile.comps):
        for res in tc.resolutions:
            for b_i, band in enumerate(res.bands):
                mb = tc.quant.guard_bits + band.eps - 1
                for p_idx in range(res.num_px * res.num_py):
                    pd = pd_map[(c, res.r, p_idx)][b_i]
                    for cb, blk in zip(pd.precinct.code_blocks, pd.blocks):
                        if not blk.included or blk.passes_done == 0:
                            jobs.append(None)
                            continue
                        jobs.append((bytes(blk.data), cb.w, cb.h,
                                     mb - blk.zero_bitplanes,
                                     blk.passes_done, band.name, cb_style,
                                     t2.finalize_segments(blk)))
    if len(jobs) != batch.plan.nb:
        raise DecodeError(f"{len(jobs)} code-blocks in the packet walk, "
                          f"{batch.plan.nb} in the plan")
    return jobs


def ebcot_slots(batch: Batch, bodies: List[bytes]) -> np.ndarray:
    """The host half of a Part-1 chunk: the Python Tier-2 of each frame,
    then the native T1 decode of every block of the chunk in one call.
    Returns the block slots int32 [n*nb, cbh, cbw], each block's samples
    at its top left, zeros elsewhere."""
    plan = batch.plan
    slots = np.zeros((len(bodies) * plan.nb, plan.cbh, plan.cbw), np.int32)
    where, jobs = [], []
    for f, body in enumerate(bodies):
        for k, job in enumerate(ebcot_jobs(batch, body)):
            if job is not None:
                where.append(f * plan.nb + k)
                jobs.append(job)
    for i, coeffs in zip(where, decode_blocks_batch(jobs)):
        h, w = coeffs.shape
        slots[i, :h, :w] = coeffs
    return slots


def decode_chunk(batch: Batch, bodies: List[bytes], dev: torch.device
                 ) -> torch.Tensor:
    """Decode some frames of the batch to their narrow pixels, flat, on
    `dev`.  Device branch: host parse, upload of the quad words and the
    MagSgn pool, then ht_dec.fused_decode (MagSgn and assembly kernels,
    inverse DWT, inverse MCT).  Host branch (a tile origin off (0, 0)): the
    native HT decode, assembly in numpy, and the inverse on `dev`.  EBCOT
    branch: ebcot_slots on the host, then one upload, the block-to-pyramid
    assembly and the inverse on `dev`."""
    n = len(bodies)
    x0, y0 = batch.tile.comps[0].x0, batch.tile.comps[0].y0
    if not batch.ht:
        counters.add("dec.ebcot_frames", n)
        slots = torch.from_numpy(ebcot_slots(batch, bodies)).to(dev)
        pyr = ht_dec_cuda.blocks_to_pyramid(slots, batch.plan, n,
                                            batch.n_comps, batch.nl)
        del slots
        return transforms.inverse_pyramid(pyr, batch.kind, batch.use_mct,
                                          batch.precision, batch.signed,
                                          x0, y0)
    if batch.on_device:
        counters.add("dec.device_ht_chunks")
        qinfo, pool, woff = upload_parsed(*parse_chunk(batch, bodies), dev)
        return ht_dec.fused_decode(qinfo, pool, woff, batch.plan, n,
                                   batch.n_comps, batch.nl, batch.kind,
                                   batch.use_mct, batch.precision,
                                   batch.signed)
    counters.add("dec.host_ht_frames", n)
    coeffs = loader.ht_t2_decode_frames(*_native_args(batch, bodies))
    if coeffs is None:
        raise _refused()
    lossy = batch.kind == dwt.IRR97
    return transforms.dispatch_inverse_stacked(
        _blocks_to_pyramid(coeffs, batch.plan, n, batch.n_comps, batch.nl),
        n, batch.n_comps, max(1, batch.nl), batch.kind, batch.use_mct,
        batch.precision, batch.signed, x0, y0, dev,
        _pyramid_deltas(batch.plan, batch.nl) if lossy else None)


def decode_batch(streams, config: Optional[Config] = None,
                 device="cuda") -> List[np.ndarray]:
    """Decode same-shape single-tile HTJ2K codestreams, lossless or lossy,
    or lossless Part-1 codestreams, to frames ([H, W] gray or [H, W, C]),
    in chunks of frames (decode_chunk), each host work (native calls, and
    the Python Tier-2 for Part-1) and one device program on `device`.
    "cuda" without a card raises.  Counters: dec.device_ht_chunks,
    dec.host_ht_frames, dec.ebcot_frames."""
    dev = transforms.resolve_device(device)
    if not streams:
        return []
    batch = prepare_batch(streams, config)
    n_frames = len(streams)
    th, tw = batch.tile.comps[0].h, batch.tile.comps[0].w
    chunk = _chunk_frames(n_frames, batch.n_comps * th * tw,
                          DECODE_CHUNK_BYTES // DECODE_BYTES_PER_SAMPLE)
    outs = [decode_chunk(batch, batch.bodies[s:s + chunk], dev)
            for s in range(0, n_frames, chunk)]
    dt = np.uint8 if batch.precision <= 8 else np.uint16
    arr = np.concatenate([o.cpu().numpy() for o in outs]).view(dt).reshape(
        n_frames, batch.n_comps, th, tw)
    counters.add("dec.bytes_in", sum(len(s) for s in streams))
    counters.add("dec.pixels_out", int(arr.size))
    return [a[0] if batch.n_comps == 1 else np.moveaxis(a, 0, -1)
            for a in arr]
