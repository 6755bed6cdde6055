"""Decoder: J2K codestreams or JP2 files -> images.

Port of go_jpeg2000_tpu/models/decoder.py.  `decode` decodes one image
tile by tile (`_decode_tiles`: `tile_pyramids`, then `_inverse_tile`): on
the host the Python Tier-2 walks each tile's packets (SOP, EPH, PPM and
PPT headers, any number of quality layers) and the native block decoder
(HT cleanup and refinement passes, or EBCOT) decodes every code-block,
with the JAX package's midpoint dequantization of 9/7 bands in numpy; the
tile's pyramid then goes to the device, where the inverse DWT levels (the
hand-written CUDA level kernels on the card), the inverse RCT or ICT, DC
shift and clamp run (transforms.run_inverse).  A tile of a tiled image
whose data are corrupt stays zero, as in the JAX package; any other
failure raises.  `decode_metadata` reads the headers only.

`decode_batch` decodes streams of one shape and one tile together,
through the JAX package's `_decode_batch_fused` (HTJ2K) and the slice's
part of `tile_pyramids` (Part-1 EBCOT).  The device HT branch (every HT
stream whose tile origin is (0, 0)): the native C++ library runs Tier-2
and the HT cleanup's control phase, MEL, CxtVLC and UVLC, for every block
of a chunk of frames in one call (ht_t2_parse_frames); only its per-quad
words and the unstuffed MagSgn pool go to the device, where ops/ht_dec.py
`fused_decode` extracts the MagSgn values and assembles the pyramid (the
CUDA kernels of csrc/ht_dec.cu on the card), with the midpoint
dequantization of 9/7 plans, and runs the inverse DWT (the CUDA level
kernels), inverse RCT/ICT, DC shift, clamp and narrowing.  The host
branch, for a tile origin off (0, 0): the native call decodes every block
on the host (ht_t2_decode_frames), the slots become leaves in numpy
(`_blocks_to_pyramid`) and ride one flat upload to the same inverse
chain.  The EBCOT branch: the Python Tier-2 per frame, the native T1
decoder for every block of a chunk of frames in one call, one upload of
the block slots, and on the device the block-to-pyramid assembly (the
ht_blocks_to_pyramid kernel on the card), the inverse 5/3 levels and the
inverse RCT.  Streams the batch branches do not take (JP2 files, tiled
images, differing shapes, quality layers, SOP/EPH/PPM/PPT, HT refinement
passes, lossy Part-1, other code-block styles, subsampled components)
and region or
reduced decodes go through `decode` one by one, as in the JAX package.
Counters: dec.device_ht_chunks, dec.host_ht_frames, dec.ebcot_frames,
dec.tiles_decoded.

`decode` takes the JAX package's decode options (Config): a region
(`decode_area`: tiles outside it are skipped, and so are the packets of
its tiles' precincts outside it, by PLT seek where every tile-part
carries PLT, else their blocks), a reduced resolution
(`reduce_resolution`: the bands of dropped resolutions are not decoded,
and the inverse starts at the kept level), and fewer quality layers
(`quality_layers`: later layers still parse, only the kept passes reach
the block decoder).  Signed and 1- to 32-bit samples come back as int8 or
uint8 up to 8 bits, int16 or uint16 up to 16, int32 above; subsampled
components are decoded on their own grids and upsampled by sample
replication; JP2 colour spaces with a converter (ops/colorspace.py) are
converted to sRGB on the decode's device.  Counters as the JAX package's:
dec.tiles_skipped, dec.packets_skipped, dec.packet_bytes_skipped,
dec.blocks_skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codestream.header import Header, TilePartInfo
from ..codestream.parser import Parser
from ..native import loader
from ..ops import colorspace, dwt, ht_dec, ht_dec_cuda, t1
from ..options import (ColorSpace, ComponentMetadata, Config, Format,
                       Metadata, ProgressionOrder)
from ..tcd import geometry as geo
from ..tcd import t2
from ..utils import boxes
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


def sniff_format(data: bytes):
    """Returns (Format, codestream_bytes, jp2_info | None)."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return Format.J2K, data, None
    if len(data) >= 12 and data[4:8] == b"jP \x20":
        info = boxes.parse_jp2(data)
        fmt = Format.JPX if info.brand == b"jpx " else Format.JP2
        return fmt, info.codestream, info
    raise DecodeError("not a JPEG 2000 file (no JP2 signature or SOC)")


def _included_precincts(header: Header, tile: geo.Tile, area):
    """The (comp, res, precinct) keys whose synthesis footprint meets the
    region `area` (x0, y0, x1, y1 on the reference grid), as the JAX
    package's: a precinct's rectangle at decomposition level nb widened by
    8 * 2^nb * (dx, dy) on each side (the 9/7 synthesis reaches less than
    4 * 2^nb; the 5/3 less)."""
    ax0, ay0, ax1, ay1 = area
    inc = set()
    for c, tc in enumerate(tile.comps):
        ci = header.components[c]
        for res in tc.resolutions:
            for band in res.bands:
                nb = band.dec_level
                sx, sy = ci.dx << nb, ci.dy << nb
                mx, my = 8 * sx, 8 * sy
                for p_idx, prec in enumerate(band.precincts):
                    if not prec.code_blocks:
                        continue
                    if (prec.x1 * sx + mx > ax0 and prec.x0 * sx - mx < ax1
                            and prec.y1 * sy + my > ay0
                            and prec.y0 * sy - my < ay1):
                        inc.add((c, res.r, p_idx))
    return inc


def _plt_lengths(parts: List[TilePartInfo]) -> Optional[List[int]]:
    """Every packet's length from the tile-parts' PLT markers, or None
    where a seek by them would not be sound: some tile-part carries no PLT
    (the lengths would pair with the wrong packets), or the lengths do not
    sum to the tile's body."""
    if not all(tp.packet_lengths for tp in parts):
        return None
    lens = [n for tp in parts for n in tp.packet_lengths]
    body = sum(tp.data_end - tp.data_start for tp in parts)
    return lens if lens and sum(lens) == body else None


def _parse(data: bytes):
    """(header, tile parts, codestream, jp2 info) of one stream."""
    _fmt, codestream, jp2 = sniff_format(data)
    parser = Parser(codestream)
    header = parser.read_header()
    return header, parser.read_all_tile_parts(header), codestream, jp2


def image_dtype(precision: int, signed: bool):
    """The decoded image's dtype (the JAX package's rule): int8 or uint8 up
    to 8 bits, int16 or uint16 up to 16, int32 above."""
    if precision <= 8:
        return np.int8 if signed else np.uint8
    if precision <= 16:
        return np.int16 if signed else np.uint16
    return np.int32


def decode(data: bytes, config: Optional[Config] = None,
           device="cuda") -> np.ndarray:
    """Decode a J2K codestream or a JP2 file to an array [H, W] (gray) or
    [H, W, C] of image_dtype, honouring the Config's region, reduced
    resolution and quality layers; a JP2 colour space with a converter
    comes back as sRGB.  The Tier-2 and block decoding run on the host,
    each tile's inverse transform and the colour conversion on `device`;
    "cuda" without a card raises."""
    config = config or Config()
    dev = transforms.resolve_device(device)
    counters.add("dec.bytes_in", len(data))
    header, tile_parts, codestream, jp2 = _parse(data)
    image = _decode_tiles(header, tile_parts, codestream, config, dev)
    counters.add("dec.pixels_out", int(image.size))
    image = _apply_colorspace(image, header, jp2, dev)
    if config.decode_area is not None:
        x0, y0, x1, y1 = config.decode_area
        s = 1 << config.reduce_resolution
        image = image[max(0, y0 - header.y_offset) // s:
                      max(0, y1 - header.y_offset + s - 1) // s,
                      max(0, x0 - header.x_offset) // s:
                      max(0, x1 - header.x_offset + s - 1) // s]
    return image


# what the host half of a tile's decode (tile_pyramids) raises on corrupt
# data: DecodeError and the parse's own ValueError and IndexError; device
# errors (RuntimeError, torch's) and a missing native library are not among
# them
CORRUPT_DATA_ERRORS = (ValueError, IndexError)


def _plane_index(a: int, d: int, offset: int, s: int) -> int:
    """A position `a` on the reference grid as an index into a component's
    plane of subsampling `d` at the reduced resolution s = 2^reduce."""
    return geo.ceil_div(geo.ceil_div(a, d) - geo.ceil_div(offset, d), s)


def _decode_tiles(header: Header, tile_parts: List[TilePartInfo],
                  codestream: bytes, config: Config,
                  dev: torch.device) -> np.ndarray:
    """Every tile present in the stream (and meeting the region, if any)
    decoded into its place on its component's plane at the reduced
    resolution; subsampled planes upsampled by sample replication, then
    stacked and narrowed to image_dtype.  Per-tile containment, for
    corrupt data only: a tile whose host decode raises one of
    CORRUPT_DATA_ERRORS stays zero in a tiled image and raises in a
    single-tile one; every other error (the native library missing, a
    device inverse that fails) raises."""
    reduce = max(0, config.reduce_resolution)
    s = 1 << reduce
    out_h = geo.ceil_div(header.height - header.y_offset, s)
    out_w = geo.ceil_div(header.width - header.x_offset, s)
    if out_h * out_w > config.max_pixels:
        raise DecodeError(
            f"image {out_w}x{out_h} exceeds Config.max_pixels "
            f"({config.max_pixels}); raise the limit to decode")
    planes = [np.zeros((_plane_index(header.height, ci.dy, header.y_offset,
                                     s),
                        _plane_index(header.width, ci.dx, header.x_offset,
                                     s)), np.int32)
              for ci in header.components]
    parts_by_tile: Dict[int, List[TilePartInfo]] = {}
    for tp in tile_parts:
        parts_by_tile.setdefault(tp.tile_index, []).append(tp)
    multi_tile = len(parts_by_tile) > 1
    area = config.decode_area
    require_native()
    for t_idx, parts in sorted(parts_by_tile.items()):
        tx0, ty0, tx1, ty1 = header.tile_bounds(t_idx)
        if area is not None and not (tx1 > area[0] and tx0 < area[2]
                                     and ty1 > area[1] and ty0 < area[3]):
            # tiles are independent (the DWT extends at tile edges)
            counters.add("dec.tiles_skipped")
            continue
        tile = geo.build_tile(header, t_idx,
                              parts[0] if parts[0].coding_style else None)
        try:
            pyramids = tile_pyramids(header, tile, parts, codestream, config)
        except CORRUPT_DATA_ERRORS:
            if not multi_tile:
                raise
            continue
        comps = _inverse_tile(header, tile, pyramids, dev, reduce)
        counters.add("dec.tiles_decoded")
        for ci, plane, arr in zip(header.components, planes, comps):
            oy0 = _plane_index(ty0, ci.dy, header.y_offset, s)
            ox0 = _plane_index(tx0, ci.dx, header.x_offset, s)
            plane[oy0:oy0 + arr.shape[0], ox0:ox0 + arr.shape[1]] = arr
    for c, ci in enumerate(header.components):
        if planes[c].shape != (out_h, out_w):
            planes[c] = np.repeat(np.repeat(planes[c], ci.dy, axis=0),
                                  ci.dx, axis=1)[:out_h, :out_w]
    image = planes[0] if len(planes) == 1 else np.stack(planes, axis=-1)
    return image.astype(image_dtype(header.components[0].precision,
                                    header.components[0].signed))


def _tier2(header: Header, tile: geo.Tile, data: bytes,
           hdr_stream: Optional[bytes] = None,
           tp0: Optional[TilePartInfo] = None, max_layers: int = 1 << 30,
           inc=None, plt_lens: Optional[List[int]] = None):
    """The Python Tier-2 of one tile: every packet of its tile data `data`
    in the progression's order (SOP and EPH markers skipped; with
    `hdr_stream`, the packed PPM or PPT headers, the packet headers come
    from there).  Returns the per-precinct decoder state,
    (comp, res, precinct) -> one t2.PrecinctDecoder per band, whose blocks
    hold their passes' bytes and, in keep_passes, keep_bytes and
    keep_segments, their state after the last packet of a layer below
    `max_layers` (the quality-layer checkpoint: later layers still parse,
    so the state stays coherent).  With `plt_lens` (and no packed
    headers), a packet of a precinct outside `inc` is skipped whole by its
    PLT length."""
    pd_map: Dict[Tuple[int, int, int], List[t2.PrecinctDecoder]] = {}
    for c, tc in enumerate(tile.comps):
        for res in tc.resolutions:
            for p_idx in range(res.num_px * res.num_py):
                pd_map[(c, res.r, p_idx)] = [
                    t2.PrecinctDecoder(band.precincts[p_idx])
                    for band in res.bands]
    pos = hpos = 0
    use_sop = header.coding_style.has_sop
    use_eph = header.coding_style.has_eph
    seek = plt_lens if hdr_stream is None else None
    for n, pid in enumerate(t2.packet_sequence(tile, header)):
        if hdr_stream is None and pos >= len(data):
            break
        if hdr_stream is not None and hpos >= len(hdr_stream):
            break
        if (seek is not None and n < len(seek)
                and (pid.comp, pid.res, pid.precinct) not in inc):
            # PLT seek: the whole packet (SOP, header, body, EPH)
            pos += seek[n]
            counters.add("dec.packets_skipped")
            counters.add("dec.packet_bytes_skipped", seek[n])
            continue
        counters.add("dec.packets_parsed")
        if use_sop and data[pos:pos + 2] == b"\xff\x91":
            pos += 6
        cb_style = header.coding_for(pid.comp, tp0).cb_style \
            & ~mk.CBSTYLE_HT_MIXED
        pds = pd_map.get((pid.comp, pid.res, pid.precinct), [])
        hsrc = hdr_stream[hpos:] if hdr_stream is not None else data[pos:]
        br = BitReader(hsrc, stuffing=True)
        decoded = t2.decode_packet_header(br, pds, pid.layer, cb_style)
        br.align()
        if hdr_stream is not None:
            hpos += br.bytes_consumed()
            if use_eph and hdr_stream[hpos:hpos + 2] == b"\xff\x92":
                hpos += 2
        else:
            pos += br.bytes_consumed()
            if use_eph and data[pos:pos + 2] == b"\xff\x92":
                pos += 2
        pos = t2.apply_packet_body(data, pos, decoded, cb_style)
        if pid.layer < max_layers:
            for blk, _n_new, _chunks in decoded:
                blk.keep_passes = blk.passes_done
                blk.keep_bytes = len(blk.data)
                blk.keep_segments = t2.finalize_segments(blk)
    return pd_map


def tile_pyramids(header: Header, tile: geo.Tile,
                  parts: List[TilePartInfo], codestream: bytes,
                  config: Optional[Config] = None):
    """The host half of one tile's decode: the Python Tier-2 over its
    packets, then the native block decoder per component, for the passes of
    the first `config.quality_layers` layers (all without), skipping the
    bands that `config.reduce_resolution` drops and the precincts outside
    `config.decode_area`.  Returns each component's pyramid in numpy:
    levels ascending, each a dict of bands (int32 for 5/3, float32
    dequantized at the midpoint for 9/7, as the JAX package reconstructs),
    the top level holding LL ([{"LL": ..}] without a decomposition level);
    a band not decoded stays zero."""
    config = config or Config()
    reduce = max(0, config.reduce_resolution)
    data = b"".join(codestream[tp.data_start:tp.data_end] for tp in parts)
    # packed packet headers (A.7.4 PPM, A.7.5 PPT): the headers come from
    # the packed stream, only SOP and the bodies stay in the tile data
    hdr_stream = None
    if header.ppm:
        chunks = header.ppm_chunks()
        hdr_stream = b"".join(chunks[tp.order] for tp in parts
                              if tp.order < len(chunks))
    elif any(tp.packed_headers for tp in parts):
        hdr_stream = b"".join(tp.packed_headers for tp in parts)
    # region decode: packets of precincts whose footprint misses the area
    # are skipped by PLT seek where the lengths allow it; otherwise their
    # headers still parse, but their blocks are not decoded
    inc = plt_lens = None
    if config.decode_area is not None:
        inc = _included_precincts(header, tile, config.decode_area)
        plt_lens = _plt_lengths(parts)
    pd_map = _tier2(header, tile, data, hdr_stream, parts[0],
                    config.quality_layers or 1 << 30, inc, plt_lens)
    lossless = header.coding_style.transform == 1
    pyramids = []
    for c, tc in enumerate(tile.comps):
        nl = tc.coding.num_decompositions
        cb_style = tc.coding.cb_style & ~mk.CBSTYLE_HT_MIXED
        shapes = dwt.subband_shapes(tc.h, tc.w, nl, u0=tc.x0, v0=tc.y0)
        f_dtype = np.int32 if lossless else np.float32
        pyramid = [{k: np.zeros(v, f_dtype) for k, v in lev.items()}
                   for lev in shapes]
        jobs, slots = [], []
        for res in tc.resolutions:
            for b_i, band in enumerate(res.bands):
                if band.dec_level <= reduce and band.name != "LL":
                    continue   # a resolution reduce_resolution drops
                target = pyramid[max(nl, 1) - 1 if band.name == "LL"
                                 else band.dec_level - 1][band.name]
                mb = tc.quant.guard_bits + band.eps - 1
                for p_idx in range(res.num_px * res.num_py):
                    pd = pd_map[(c, res.r, p_idx)][b_i]
                    if inc is not None and (c, res.r, p_idx) not in inc:
                        counters.add("dec.blocks_skipped",
                                     len(pd.precinct.code_blocks))
                        continue
                    for cb, blk in zip(pd.precinct.code_blocks, pd.blocks):
                        if not blk.included or blk.keep_passes == 0:
                            continue
                        # lossy: midpoint-biased reconstruction of
                        # truncated EBCOT blocks (t1.STY_LOSSY_BIAS)
                        sty = cb_style if lossless else \
                            cb_style | t1.STY_LOSSY_BIAS
                        jobs.append((bytes(blk.data[:blk.keep_bytes]), cb.w,
                                     cb.h, mb - blk.zero_bitplanes,
                                     blk.keep_passes, band.name, sty,
                                     blk.keep_segments))
                        slots.append((target, band, cb))
        counters.add("dec.blocks_decoded", len(jobs))
        for (target, band, cb), coeffs in zip(slots,
                                              decode_blocks_batch(jobs)):
            if lossless:
                vals = coeffs
            elif cb_style & mk.CBSTYLE_HT:
                # HT: midpoint dequantization (E.1.1.2, r = 0.5)
                qa = np.abs(coeffs).astype(np.float32)
                vals = np.where(coeffs == 0, np.float32(0),
                                np.sign(coeffs).astype(np.float32)
                                * (qa + 0.5) * np.float32(band.delta))
            else:
                # EBCOT: the decoder reconstructed each sample at the
                # midpoint of its last plane in x2 fixed point
                vals = coeffs.astype(np.float32) \
                    * np.float32(band.delta * 0.5)
            target[cb.y0 - band.y0:cb.y1 - band.y0,
                   cb.x0 - band.x0:cb.x1 - band.x0] = vals
        pyramids.append(pyramid)
    return pyramids


def _inverse_tile(header: Header, tile: geo.Tile, pyramids,
                  dev: torch.device, reduce: int = 0) -> List[np.ndarray]:
    """transforms.run_inverse of one tile's pyramids on `dev`, from the
    level `reduce` keeps (only LL when it keeps none) at the origin
    ceil((x0, y0) / 2^reduce), all components in one call where they share
    their geometry (one call each otherwise): int32 [h, w] per component
    at the reduced resolution."""
    kind = dwt.REV53 if header.coding_style.transform == 1 else dwt.IRR97
    precision = header.components[0].precision
    signed = header.components[0].signed
    use_mct = bool(header.coding_style.mct) and len(tile.comps) >= 3
    tc0 = tile.comps[0]
    groups = [list(range(len(tile.comps)))]
    if not all(tc.coding.num_decompositions == tc0.coding.num_decompositions
               and (tc.w, tc.h) == (tc0.w, tc0.h) for tc in tile.comps):
        groups = [[c] for c in range(len(tile.comps))]
        use_mct = False
    out = []
    for comps in groups:
        tc = tile.comps[comps[0]]
        nl = tc.coding.num_decompositions
        if nl - reduce <= 0:
            top = max(nl, 1) - 1
            stacked = [{"LL": np.stack([pyramids[c][top]["LL"]
                                        for c in comps])}]
        else:
            stacked = [{k: np.stack([pyramids[c][lev][k] for c in comps])
                        for k in pyramids[comps[0]][lev]}
                       for lev in range(reduce, nl)]
        x = transforms.run_inverse(stacked, kind, use_mct, precision, signed,
                                   geo.ceil_div(tc.x0, 1 << reduce),
                                   geo.ceil_div(tc.y0, 1 << reduce), dev)
        out += list(x)
    return out


def _apply_colorspace(image: np.ndarray, header: Header, jp2,
                      dev: torch.device) -> np.ndarray:
    """The JP2 colour space converted to sRGB on `dev` where it has a
    converter (ops/colorspace.py; CMYK and YCCK give 3 components of 4),
    in the image's dtype; sRGB, gray and unspecified as they are."""
    if jp2 is None or image.ndim != 3:
        return image
    conv = colorspace.get_color_conversion(jp2.color_space)
    if conv is None:
        return image
    comps = [torch.from_numpy(image[:, :, i].astype(np.int32)).to(dev)
             for i in range(image.shape[2])]
    out = conv(comps, header.components[0].precision)
    return np.stack([t.cpu().numpy() for t in out],
                    axis=-1).astype(image.dtype)


def decode_metadata(data: bytes) -> Metadata:
    """Header-only decode (the JAX package's decode_metadata)."""
    fmt, codestream, jp2 = sniff_format(data)
    header = Parser(codestream).read_header()
    cs = header.coding_style
    color_space = ColorSpace.UNSPECIFIED
    icc = None
    if jp2 is not None:
        color_space = jp2.color_space
        icc = jp2.icc_profile
    return Metadata(
        format=fmt,
        width=header.width - header.x_offset,
        height=header.height - header.y_offset,
        num_components=header.num_components,
        components=[ComponentMetadata(ci.precision, ci.signed, ci.dx, ci.dy)
                    for ci in header.components],
        color_space=color_space,
        tile_width=header.tile_width,
        tile_height=header.tile_height,
        num_tiles_x=header.num_tiles_x,
        num_tiles_y=header.num_tiles_y,
        num_resolutions=cs.num_decompositions + 1,
        num_layers=cs.num_layers,
        progression_order=ProgressionOrder(cs.progression_order),
        lossless=cs.transform == 1,
        is_htj2k=header.is_htj2k,
        code_block_width=1 << cs.cb_width_exp,
        code_block_height=1 << cs.cb_height_exp,
        profile=header.profile,
        comments=list(header.comments),
        icc_profile=icc,
    )


def batch_refusal(parsed, config: Config) -> Optional[str]:
    """Why decode_batch's branches do not take these parsed streams
    together (decode does, one by one), or None: the JAX package's
    conditions (one shape, one tile, no JP2, whole decodes at full
    resolution), and the branches' own (one layer, no SOP/EPH/PPM/PPT, HT
    or lossless Part-1 of code-block style 0; fused_encode.plan_for
    refuses subsampled components).  Signed samples and any precision
    batch, as in the JAX package."""
    if config.decode_area is not None or config.reduce_resolution:
        return "a region or reduced-resolution decode"
    h0 = parsed[0][0]
    cs0 = h0.coding_style
    for hdr, tile_parts, _cs, jp2 in parsed:
        cs = hdr.coding_style
        if jp2 is not None:
            return "a JP2 file"
        if hdr.num_tiles != 1:
            return "a tiled image"
        if ((hdr.width, hdr.height, hdr.num_components)
                != (h0.width, h0.height, h0.num_components)
                or (cs.num_decompositions, cs.mct, cs.transform)
                != (cs0.num_decompositions, cs0.mct, cs0.transform)
                or [(c.precision, c.signed) for c in hdr.components]
                != [(c.precision, c.signed) for c in h0.components]
                or (cs.cb_style & mk.CBSTYLE_HT)
                != (cs0.cb_style & mk.CBSTYLE_HT)):
            return "streams of differing geometry"
        if not cs.cb_style & mk.CBSTYLE_HT and (cs.transform != 1
                                                or cs.cb_style):
            return "a lossy or styled Part-1 stream"
        if cs.num_layers != 1:
            return "quality layers"
        if (cs.has_sop or cs.has_eph or hdr.ppm
                or any(tp.packed_headers for tp in tile_parts)):
            return "SOP/EPH/PPM/PPT markers"
    return None


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


def prepare_batch(streams, config: Optional[Config] = None
                  ) -> Optional[Batch]:
    """Parse the streams' headers and tile parts and, where decode_batch's
    branches take them together, the Batch with its block plan and packet
    walk; None where batch_refusal refuses them or no block plan describes
    their geometry (decode takes those one by one)."""
    parsed = [_parse(s) for s in streams]
    if batch_refusal(parsed, config or Config()):
        return None
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
        return None
    require_native()
    n_comps = header.num_components
    return Batch(
        bodies=[b"".join(cs[tp.data_start:tp.data_end] for tp in tps)
                for _hdr, tps, cs, _jp2 in parsed],
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


def parse_chunk(batch: Batch, bodies: List[bytes]):
    """The host's control phase (native T2 + MEL/VLC parse) of some frames:
    (quad words uint32 [n*nb, qh, qw], MagSgn pool uint32 [P], block word
    offsets int64 [n*nb]), or None where the native parse refuses a frame
    (HT refinement passes, or truncated data): `decode` takes those."""
    out = loader.ht_t2_parse_frames(*_native_args(batch, bodies))
    return None if out is None else out[:3]


def upload_parsed(qinfo: np.ndarray, pool: np.ndarray, woff: np.ndarray,
                  dev: torch.device):
    """The parse's arrays on the device; uint32 words travel as their int32
    bit patterns."""
    return (torch.from_numpy(qinfo.view(np.int32)).to(dev),
            torch.from_numpy(pool.view(np.int32)).to(dev),
            torch.from_numpy(woff).to(dev))


def ebcot_jobs(batch: Batch, body: bytes) -> List:
    """Tier-2 of one Part-1 frame (_tier2): per block of the plan, in
    canonical job order, its T1 decode job (data, w, h, numbps,
    num_passes, band, cb_style, segment_lengths), or None where the block
    carries no pass."""
    header, tile = batch.header, batch.tile
    pd_map = _tier2(header, tile, body)
    cb_style = header.coding_style.cb_style
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
                 ) -> Optional[torch.Tensor]:
    """Decode some frames of the batch to their narrow pixels, flat, on
    `dev`.  Device branch: host parse, upload of the quad words and the
    MagSgn pool, then ht_dec.fused_decode (MagSgn and assembly kernels,
    inverse DWT, inverse MCT).  Host branch (a tile origin off (0, 0)): the
    native HT decode, assembly in numpy, and the inverse on `dev`.  EBCOT
    branch: ebcot_slots on the host, then one upload, the block-to-pyramid
    assembly and the inverse on `dev`.  None where the native HT calls
    refuse a frame (HT refinement passes): `decode` takes those."""
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
        parsed = parse_chunk(batch, bodies)
        if parsed is None:
            return None
        counters.add("dec.device_ht_chunks")
        qinfo, pool, woff = upload_parsed(*parsed, dev)
        return ht_dec.fused_decode(qinfo, pool, woff, batch.plan, n,
                                   batch.n_comps, batch.nl, batch.kind,
                                   batch.use_mct, batch.precision,
                                   batch.signed)
    coeffs = loader.ht_t2_decode_frames(*_native_args(batch, bodies))
    if coeffs is None:
        return None
    counters.add("dec.host_ht_frames", n)
    lossy = batch.kind == dwt.IRR97
    return transforms.dispatch_inverse_stacked(
        _blocks_to_pyramid(coeffs, batch.plan, n, batch.n_comps, batch.nl),
        n, batch.n_comps, max(1, batch.nl), batch.kind, batch.use_mct,
        batch.precision, batch.signed, x0, y0, dev,
        _pyramid_deltas(batch.plan, batch.nl) if lossy else None)


def download(out: torch.Tensor, dt) -> np.ndarray:
    """A chunk's narrow pixels, flat, to the host (this waits for the
    device), viewed as the image's dtype `dt`."""
    return out.cpu().numpy().view(dt)


def decode_batch(streams, config: Optional[Config] = None,
                 device="cuda") -> List[np.ndarray]:
    """Decode codestreams or JP2 files to frames ([H, W] gray or
    [H, W, C]).  Single-tile HTJ2K streams of one shape, lossless or lossy,
    and lossless Part-1 ones, one layer each, go together in chunks of
    frames (decode_chunk): host work (native calls, and the Python Tier-2
    for Part-1) and one device program on `device` per chunk.  Everything
    else (batch_refusal, and frames with HT refinement passes) goes
    through `decode` one by one, and so do region and reduced decodes.
    "cuda" without a card raises.  Counters:
    dec.device_ht_chunks, dec.host_ht_frames, dec.ebcot_frames."""
    config = config or Config()
    dev = transforms.resolve_device(device)
    if not streams:
        return []
    batch = prepare_batch(streams, config)
    if batch is None:
        return [decode(s, config, dev) for s in streams]
    n_frames = len(streams)
    th, tw = batch.tile.comps[0].h, batch.tile.comps[0].w
    chunk = _chunk_frames(n_frames, batch.n_comps * th * tw,
                          DECODE_CHUNK_BYTES // DECODE_BYTES_PER_SAMPLE)
    # every chunk's device program is queued before the first download, so
    # the host parse of a chunk overlaps the device work of the one before
    starts = range(0, n_frames, chunk)
    outs = [decode_chunk(batch, batch.bodies[s:s + chunk], dev)
            for s in starts]
    dt = image_dtype(batch.precision, batch.signed)
    frames = []
    for s, out in zip(starts, outs):
        if out is None:
            frames += [decode(x, config, dev) for x in streams[s:s + chunk]]
            continue
        arr = download(out, dt).reshape(-1, batch.n_comps, th, tw)
        frames += [a[0] if batch.n_comps == 1 else np.moveaxis(a, 0, -1)
                   for a in arr]
        counters.add("dec.bytes_in",
                     sum(len(x) for x in streams[s:s + chunk]))
        counters.add("dec.pixels_out", int(arr.size))
    return frames
