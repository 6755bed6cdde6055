"""Encoder: an image or frames of one shape -> J2K codestreams or JP2 files.

Port of go_jpeg2000_tpu/models/encoder.py.  `encode` codes one image tile
by tile (`_tile_entropy`): the tile's samples go to the device, where DC
shift, RCT or ICT, the DWT levels (the hand-written CUDA level kernels on
the card) and, for 9/7, the deadzone quantization run; the native block
coder (HT or EBCOT) codes the blocks on the host; then one PCRD over every
tile's passes sets the quality layers and meets the byte budget
(`_assemble_with_budget`), the Python Tier-2 writes each tile's packets,
and `_finalize_codestream` wraps JP2.  `encode_batch` codes frames of one
shape and one tile together, through the JAX package's three branches:
the fused branch (models/fused_encode.py) runs the whole device half of
an HTJ2K encode on the card, with hand-written CUDA kernels for the DWT
levels, block extraction, the HT cleanup pass with its bit packing and pool
compaction, and leaves the host only segment serialization and Tier-2 in
C++ (or, with quality layers, a byte budget, SOP, EPH, PLT or PPT, a
PCRD per frame and the Python Tier-2 on natively serialized segments).
The device EBCOT branch (models/ebcot_fused.py) runs the 5/3 transform,
block extraction, the EBCOT Tier-1 decisions, their compaction and (path
A) the MQ coder and the segment pool on the card, or (path B, backend
"hybrid") MQ-codes the fetched decision streams on the host in C++; the
Python Tier-2 assembles the packets.  The chunked branch, for what the
device branches refuse (a band of several precincts, HT refinement
passes, Part-1 quality layers, code-block styles, byte budgets, lossy
Part-1, PPM) and for backends "native" (path C) and "python", runs the
transforms on the device and the block coder, a PCRD per frame and the
Python Tier-2 on the host.  Frames of differing shapes, tiled and offset
images go through `encode` one by one.  Lossless codestreams are
byte-identical to the JAX package's `encode`; lossy ones decode within
one grey level of them (float32 lifting drifts by ulps between program
shapes, so a quantizer index can flip at a step boundary).

What it takes is what the JAX package's encoders take: HTJ2K or Part-1
with any code-block style, lossless 5/3 or lossy 9/7, any number of
quality layers and byte budgets (HT refinement passes where they are
used); J2K, JP2 or JPX; one tile or a tile grid with tile and image
offsets; any number of components (RCT for 5/3 or ICT for 9/7 on the
first three); unsigned or signed samples of 1 to 29 bits lossless (28
under the RCT) and 31 lossy (`check_precision` raises ValueError past
them, where the JAX package fails); SOP, EPH, PLT, PPT, PPM and TLM
markers and POC progression changes; backend "python" codes the blocks
with the Python oracles (ops/ht.py, ops/t1.py).  Two departures from the
JAX package, where it is wrong: a signed image without `precision` gets
the smallest width that holds every sample (`_natural_precision`), and
`encode_batch` writes TLM and PPM as `encode` does.  The tile-sharded
pipeline (parallel/sharded.py) and the multi-host decomposition
(parallel/multihost.py) assemble through `_assemble_with_budget` and
`_finalize_codestream` too.
"""
from __future__ import annotations

import itertools
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..codestream import writer as cw
from ..codestream.header import (Capabilities, CodingStyle, ComponentInfo,
                                 Header, ProgressionChange, Quantization)
from ..ops import dwt, quant as quant_ops, t1
from ..options import Format, Options, default_options
from ..tcd import geometry as geo
from ..tcd import t2
from ..utils import boxes
from ..utils import markers as mk
from ..utils.bio import BitWriter
from ..utils.metrics import counters
from . import ebcot_fused, fused_encode
from . import rate as rate_mod
from . import transforms
from .entropy_backend import encode_blocks_batch


def _image_components(image: np.ndarray) -> List[np.ndarray]:
    if image.ndim == 2:
        return [image]
    if image.ndim == 3:
        return [image[:, :, i] for i in range(image.shape[2])]
    raise ValueError("image must be HxW or HxWxC")


def _natural_precision(image: np.ndarray, opts: Options) -> Tuple[int, bool]:
    if opts.precision:
        return opts.precision, np.issubdtype(image.dtype, np.signedinteger)
    if image.dtype == np.uint8:
        return 8, False
    if image.dtype == np.uint16:
        return 16, False
    if image.dtype == np.int8:
        return 8, True
    if image.dtype == np.int16:
        return 16, True
    if np.issubdtype(image.dtype, np.integer):
        lo, hi = int(image.min()), int(image.max())
        if lo >= 0:
            return max(1, hi.bit_length()), False
        # the smallest signed width that holds every sample; the JAX
        # package takes bit_length(max |x|), one bit short wherever a
        # positive sample reaches 2^(P-1) or a negative one passes -2^(P-1)
        return max(max(hi, 0).bit_length(), (-lo - 1).bit_length()) + 1, True
    raise ValueError(f"unsupported dtype {image.dtype}")


def effective_ht_refinement(opts: Options) -> bool:
    """Resolved ht_refinement: explicit True/False wins; the None default
    enables the 3-pass refined sets exactly when their extra truncation
    points are consumed (multiple quality layers or a byte budget)."""
    if opts.ht_refinement is not None:
        return bool(opts.ht_refinement)
    return (opts.high_throughput
            and (opts.num_layers > 1 or opts.compression_ratio > 1.0))


def _effective_quality(opts: Options) -> int:
    """Base-quantizer quality.  A compression_ratio budget makes PCRD
    truncation set the operating point, so the base quantizer should be as
    fine as practical, except for HT, whose few truncation points per block
    leave the quality-derived step the primary rate instrument."""
    if (opts.compression_ratio > 1.0 and not opts.lossless
            and not opts.high_throughput):
        return 100
    return opts.quality


def check_precision(header: Header, opts: Options) -> None:
    """Raise ValueError where the JAX package fails on the sample width: a
    lossless step exponent above 31 does not fit the quantization marker's
    five bits (more than 29-bit samples, 28 under the RCT), and lossy
    samples above 31 bits do not fit the int32 transform."""
    precision = header.components[0].precision
    if not opts.lossless and precision > 31:
        raise ValueError(f"{precision}-bit samples: a lossy encode takes "
                         "at most 31 bits")
    quants = [header.quantization] + list(header.comp_quant.values())
    if any(s.exponent > 31 for q in quants for s in q.step_sizes):
        raise ValueError(f"{precision}-bit samples: a lossless encode takes "
                         "at most 29 bits (28 under the RCT)")


def batch_takes(images: Sequence[np.ndarray], opts: Options) -> bool:
    """Whether encode_batch codes the frames together: frames of one shape
    and dtype, one tile at the origin, as the JAX package's encode_batch
    asks before it falls back to per-image encode."""
    im0 = images[0]
    return (all(im.shape == im0.shape and im.dtype == im0.dtype
                for im in images)
            and opts.tile_size == (0, 0) and opts.image_offset == (0, 0))


def build_header(image: np.ndarray, opts: Options) -> Header:
    """Main header of a single-tile codestream, HT or Part-1 (the slices'
    part of the JAX package's build_header)."""
    comps = _image_components(image)
    h_img, w_img = comps[0].shape
    precision, signed = _natural_precision(image, opts)
    h = Header()
    h.profile = int(opts.profile)
    h.x_offset, h.y_offset = opts.image_offset
    h.width = w_img + h.x_offset
    h.height = h_img + h.y_offset
    tw, th = opts.tile_size
    h.tile_x_offset, h.tile_y_offset = opts.tile_offset
    if h.tile_x_offset > h.x_offset or h.tile_y_offset > h.y_offset:
        # Header.validate's rule, which every decoder holds a stream to
        raise ValueError("tile offset must not exceed image offset")
    h.tile_width = tw if tw > 0 else h.width - h.tile_x_offset
    h.tile_height = th if th > 0 else h.height - h.tile_y_offset
    h.components = [ComponentInfo.make(precision, signed) for _ in comps]

    cs = CodingStyle()
    cs.progression_order = int(opts.progression_order)
    cs.num_layers = max(1, opts.num_layers)
    n_comps = len(comps)
    use_mct = opts.mct if opts.mct is not None else n_comps >= 3
    cs.mct = 1 if (use_mct and n_comps >= 3) else 0
    cs.num_decompositions = max(0, opts.num_resolutions - 1)
    if opts.high_throughput and opts.ht_block_width:
        cs.cb_width_exp = int(math.log2(opts.ht_block_width))
        cs.cb_height_exp = int(math.log2(opts.ht_block_height
                                         or opts.ht_block_width))
    else:
        cs.cb_width_exp, cs.cb_height_exp = opts.code_block_size
    cs.cb_style = opts.code_block_style
    if opts.high_throughput:
        cs.cb_style |= mk.CBSTYLE_HT
    cs.transform = 1 if opts.lossless else 0
    if opts.enable_sop:
        cs.scod |= mk.SCOD_SOP
    if opts.enable_eph:
        cs.scod |= mk.SCOD_EPH
    if opts.precinct_size:
        cs.scod |= mk.SCOD_PRECINCTS_DEFINED
        cs.precincts = [tuple(p) for p in opts.precinct_size]
    h.coding_style = cs
    if opts.progression_changes:
        h.poc = _progression_changes(opts, cs, n_comps)
    h.quantization = component_quant(h, opts, 0, precision)
    if opts.high_throughput:
        h.capabilities = Capabilities(pcap=mk.pcap_bit(15))
    return h


def _progression_changes(opts: Options, cs: CodingStyle,
                         n_comps: int) -> List[ProgressionChange]:
    """The POC segments of opts.progression_changes, and, where they leave
    a (layer, resolution, component) uncovered, a catch-all final segment
    in the COD order: the POC governs the whole progression (A.6.6), and
    OpenJPEG refuses a stream whose segments miss a packet."""
    for pc in opts.progression_changes:
        if len(pc) != 6:
            raise ValueError(
                f"progression_changes entries must be (res_start, "
                f"comp_start, layer_end, res_end, comp_end, order); got {pc}")
    poc = [ProgressionChange(*pc) for pc in opts.progression_changes]
    numres = cs.num_decompositions + 1
    covered = (any(p.res_start <= r < p.res_end
                   and p.comp_start <= c < p.comp_end and l < p.layer_end
                   for p in poc)
               for r in range(numres) for c in range(n_comps)
               for l in range(cs.num_layers))
    if not all(covered):
        poc.append(ProgressionChange(0, 0, cs.num_layers, numres, n_comps,
                                     int(opts.progression_order)))
    return poc


def component_quant(h: Header, opts: Options, comp: int,
                    precision: int) -> Quantization:
    """Per-component quantization accounting for MCT range expansion: RCT
    chroma gains one bit; ICT chroma stays in range and shares the luma
    steps.  Two guard bits, three for HT: its decoders bound
    U_q <= (Mb - 1) + 1."""
    nl = h.coding_style.num_decompositions
    guard = 3 if opts.high_throughput else 2
    if opts.lossless:
        eff_prec = precision + 1 if h.coding_style.mct and comp in (1, 2) \
            else precision
        return quant_ops.make_reversible_quant(eff_prec, nl,
                                               guard_bits=guard)
    base_delta = rate_mod.base_delta_for_quality(_effective_quality(opts),
                                                 precision)
    return quant_ops.make_irreversible_quant(precision, nl, base_delta,
                                             guard_bits=guard)


def _apply_comp_quants(header: Header, opts: Options, n_comps: int,
                       precision: int) -> None:
    """Per-component quantization; registers QCC for differing components."""
    comp_quants = [component_quant(header, opts, c, precision)
                   for c in range(n_comps)]
    header.quantization = comp_quants[0]
    for c, q in enumerate(comp_quants):
        if q != comp_quants[0]:
            header.comp_quant[c] = q


def header_and_main(image: np.ndarray, opts: Options
                    ) -> Tuple[Header, bytes]:
    """The main header of `image` under `opts`, each component's
    quantization in it (check_precision holds it to what the markers
    take), and its bytes."""
    header = build_header(image, opts)
    n_comps = header.num_components
    _apply_comp_quants(header, opts, n_comps, header.components[0].precision)
    check_precision(header, opts)
    return header, _write_main_header(header, opts, n_comps)


def _write_main_header(header: Header, opts: Options, n_comps: int) -> bytes:
    out = bytearray()
    out += cw.write_soc()
    out += cw.write_siz(header)
    if header.capabilities is not None:
        out += cw.write_cap(header.capabilities.pcap, header.capabilities.ccap)
    out += cw.write_cod(header.coding_style)
    out += cw.write_qcd(header.quantization)
    for c, q in sorted(header.comp_quant.items()):
        out += cw.write_qcc(c, n_comps, q)
    if header.poc:
        out += cw.write_poc(header.poc, n_comps)
    if opts.comment:
        out += cw.write_com(opts.comment)
    return bytes(out)


def _walk_geometry(tile: geo.Tile):
    """Enumerate (comp, res, band, precinct, code-block) in canonical job
    order.  Returns (enc_state, job_slots):
    enc_state[(comp, res, precinct_idx)] -> [(band, precinct, blocks)];
    job_slots: (blocks_list, index, band, mb, cb_style, cb, comp) per
    block."""
    enc_state: Dict[Tuple[int, int, int], List] = {}
    job_slots = []
    for c, tc in enumerate(tile.comps):
        cb_style = tc.coding.cb_style
        for res in tc.resolutions:
            r = res.r
            for band in res.bands:
                mb = tc.quant.guard_bits + band.eps - 1
                for p_idx, prec in enumerate(band.precincts):
                    blocks: List[Optional[t2.EncBlock]] = \
                        [None] * len(prec.code_blocks)
                    for i, cb in enumerate(prec.code_blocks):
                        job_slots.append((blocks, i, band, mb, cb_style,
                                          cb, c))
                    enc_state.setdefault((c, r, p_idx), []).append(
                        (band, prec, blocks))
    return enc_state, job_slots


def _leaf_deltas(tile: geo.Tile, nl: int) -> Tuple[float, ...]:
    """Per-leaf quantizer steps in tree-leaves order (levels ascending,
    band keys sorted: HH, HL, LH [, LL at the top level]) for the device
    quantization in transforms.forward_transform_batch.  Component 0's
    steps serve every component: under the ICT all share one quantizer."""
    by = {}
    for res in tile.comps[0].resolutions:
        for band in res.bands:
            lev = nl if band.name == "LL" else band.dec_level
            by[(lev, band.name)] = float(band.delta)
    if nl == 0:
        return (by[(0, "LL")],)
    return tuple(by[(lev, k)] for lev in range(1, nl + 1)
                 for k in ["HH", "HL", "LH"] + (["LL"] if lev == nl else []))


def _entropy_jobs(tile: geo.Tile, pyramids, lossless: bool = True,
                  pre_quantized: bool = True):
    """Code-block split of a pyramid: returns (enc_state, job_slots,
    block_jobs) with block_jobs = (coeff_array, band_name, cb_style, mb).
    The leaves are integers (lossless coefficients, or 9/7 indices the
    device quantized), or, for 9/7 with pre_quantized=False, float32
    coefficients, quantized here in float32 with each band's step."""
    enc_state, job_slots = _walk_geometry(tile)
    block_jobs = []
    for c, tc in enumerate(tile.comps):
        nl = tc.coding.num_decompositions
        cb_style = tc.coding.cb_style
        for res in tc.resolutions:
            for band in res.bands:
                if band.name == "LL":
                    arr = pyramids[max(nl, 1) - 1]["LL"][c]
                else:
                    arr = pyramids[band.dec_level - 1][band.name][c]
                arr = np.asarray(arr)
                if not lossless and not pre_quantized:
                    a32 = arr.astype(np.float32, copy=False)
                    arr = (np.sign(a32)
                           * np.floor(np.abs(a32) / np.float32(band.delta))
                           ).astype(np.int32)
                mb = tc.quant.guard_bits + band.eps - 1
                for prec in band.precincts:
                    for cb in prec.code_blocks:
                        sub = arr[cb.y0 - band.y0:cb.y1 - band.y0,
                                  cb.x0 - band.x0:cb.x1 - band.x0]
                        block_jobs.append((sub, band.name, cb_style, mb))
    return enc_state, job_slots, block_jobs


MCT_NORMS_ICT = (1.7321, 1.8051, 1.5734)   # sqrt(3.0, 3.2584, 2.4756)
MCT_NORMS_RCT = (1.7321, 0.8292, 0.8292)   # sqrt(3.0, 0.6876, 0.6876)


def mct_comp_weights(header: Header, lossless: bool,
                     n_comps: int) -> Optional[List[float]]:
    """Per-component PCRD distortion weights under the active MCT, ICT or
    RCT (OpenJPEG's opj_mct_get_mct_norms values); None when no MCT is
    active."""
    if not header.coding_style.mct or n_comps < 3:
        return None
    base = MCT_NORMS_RCT if lossless else MCT_NORMS_ICT
    return [base[c] ** 2 if c < 3 else 1.0 for c in range(n_comps)]


def _build_blocks(job_slots, results, num_layers: int,
                  reversible: bool = True, comp_weights=None
                  ) -> Tuple[List[t2.EncBlock], List[float]]:
    """Wire coder results into EncBlocks (direct slot references,
    order-safe); returns (blocks, PCRD distortion weights): the coder's
    per-pass distortion times (delta_b * ||basis||_2)^2 * mct_norm_c^2."""
    all_blocks: List[t2.EncBlock] = []
    weights: List[float] = []
    for (blocks, i, band, mb, cb_style, _cb, c), r in zip(job_slots,
                                                           results):
        blk = t2.EncBlock(
            zero_bitplanes=max(0, mb - r.num_bitplanes),
            num_passes_total=len(r.passes),
            pass_rates=[p.rate for p in r.passes],
            pass_terminated=[p.terminated for p in r.passes],
            data=r.data,
            layer_passes=[0] * num_layers,
            cb_style=cb_style,
        )
        blk._passes = r.passes  # for PCRD
        blocks[i] = blk
        all_blocks.append(blk)
        norm = quant_ops.band_norm_true(reversible, band.name,
                                        band.dec_level)
        w = (band.delta * norm) ** 2
        if comp_weights is not None:
            w *= comp_weights[c]
        weights.append(w)

    counters.add("enc.blocks_coded", len(all_blocks))
    counters.add("enc.passes_coded",
                 sum(b.num_passes_total for b in all_blocks))
    counters.add("enc.truncation_points",
                 sum(len(b.pass_rates) for b in all_blocks))
    return all_blocks, weights


def _packets_to_tile_part(header: Header, tile: geo.Tile, enc_state,
                          t_idx: int, opts: Options) -> Tuple[bytes, bytes]:
    """Tier-2 packet assembly for one tile whose blocks already carry final
    layer assignments.  Returns (tile-part, packed packet headers): with
    PPT or PPM each packet header (and its EPH) goes to the packed stream,
    which a PPT in the tile-part holds, or, with PPM, the main header
    (the second value; b"" otherwise)."""
    pe_map: Dict[Tuple[int, int, int], List[t2.PrecinctEncoder]] = {}
    for key, entries in enc_state.items():
        pe_map[key] = [t2.PrecinctEncoder(prec, blocks)
                       for band, prec, blocks in entries]
    use_sop = header.coding_style.has_sop
    use_eph = header.coding_style.has_eph
    packed = opts.enable_ppt or opts.enable_ppm
    packets: List[bytes] = []
    packed_hdrs: List[bytes] = []
    for n, pid in enumerate(t2.packet_sequence(tile, header)):
        pes = pe_map.get((pid.comp, pid.res, pid.precinct), [])
        bw = BitWriter(stuffing=True)
        body = b"".join(t2.encode_packet_header(bw, pes, pid.layer))
        bw.flush()
        if packed:
            hdr = bw.getvalue()
            if use_eph:
                hdr += struct.pack(">H", mk.EPH)
            packed_hdrs.append(hdr)
            packets.append(t2.wrap_packet(b"", body, n, use_sop, False))
        else:
            packets.append(t2.wrap_packet(bw.getvalue(), body, n, use_sop,
                                          use_eph))
    body = b"".join(packets)
    plt = cw.write_plt(0, [len(p) for p in packets]) if opts.enable_plt \
        else b""
    ppt = cw.write_ppt(b"".join(packed_hdrs)) if opts.enable_ppt else b""
    sot_len = 12 + len(plt) + len(ppt) + 2 + len(body)
    tile_part = (cw.write_sot(t_idx, sot_len, 0, 1) + plt + ppt
                 + cw.write_sod() + body)
    return tile_part, b"".join(packed_hdrs) if opts.enable_ppm else b""


def _assemble_packets(header: Header, tile: geo.Tile, enc_state, job_slots,
                      results, t_idx: int, opts: Options,
                      rate_budget: Optional[int] = None
                      ) -> Tuple[bytes, bytes]:
    """Single-tile path: build blocks, run PCRD locally (one pass, as the
    JAX package's batch path: no correction of the overhead estimate),
    assemble packets.  Returns (tile-part, PPM chunk)."""
    num_layers = header.coding_style.num_layers
    all_blocks, weights = _build_blocks(
        job_slots, results, num_layers, opts.lossless,
        mct_comp_weights(header, opts.lossless, len(tile.comps)))
    rate_mod.assign_layers(all_blocks, weights, num_layers, rate_budget)
    return _packets_to_tile_part(header, tile, enc_state, t_idx, opts)


def _ppm_size(payload: int) -> int:
    """Bytes of the PPM segments (cw.write_ppm) of `payload` bytes of
    Nppm-prefixed chunks: 5 bytes of marker, length and Zppm a segment of
    at most 65532."""
    return payload + 5 * -(-max(1, payload) // 65532)


def _assemble_with_budget(header: Header, opts: Options, states, all_blocks,
                          num_layers: int, rate_budget: Optional[int],
                          main: bytes, assign_fn, size_reduce=None,
                          tile_ids=None) -> Tuple[List[bytes], List[bytes]]:
    """PCRD (assign_fn) and Tier-2 of the tiles in `states` ((tile,
    enc_state) each, indices `tile_ids`, default 0..), correcting the
    bisection's estimate of the header overhead against the size actually
    assembled until the codestream meets rate_budget.  With several ranks
    each passes its own tiles and `size_reduce`, the sum of a local byte
    count over the ranks, so that every rank sees the whole codestream's
    size, PPM and TLM included.  Returns the tile-parts and their PPM
    chunks."""
    ids = tile_ids if tile_ids is not None else list(range(len(states)))
    tlm = (len(cw.write_tlm([(t, 0) for t in range(header.num_tiles)]))
           if opts.enable_tlm else 0)

    def build_parts() -> Tuple[List[bytes], List[bytes]]:
        parts = [_packets_to_tile_part(header, tile, enc_state, t_idx, opts)
                 for t_idx, (tile, enc_state) in zip(ids, states)]
        return [tp for tp, _ in parts], [hdrs for _, hdrs in parts]

    def core_size(tile_parts, ppm_chunks) -> int:
        local = sum(len(tp) for tp in tile_parts)
        ppm = sum(4 + len(c) for c in ppm_chunks)
        if size_reduce is not None:
            local = int(size_reduce(local))
            if opts.enable_ppm:
                ppm = int(size_reduce(ppm))
        n = len(main) + 2 + local + tlm
        return n + _ppm_size(ppm) if opts.enable_ppm else n

    def reset_blocks():
        for blk in all_blocks:
            blk.layer_passes = [0] * num_layers
            blk.included_layer = -1
            blk.lblock = 3
            blk.passes_done = 0

    est = assign_fn(rate_budget)
    parts = build_parts()
    if rate_budget is None:
        return parts
    best = None
    best_total = -1
    target = rate_budget
    prev_targets = set()
    # the estimate counts pass bytes and about 4 bytes a block; the real
    # overhead (tag trees, lengths, packet headers) is nearly constant near
    # a threshold, so re-targeting by (actual - estimate) converges in 2-3
    # rebuilds
    for _ in range(10):
        total = core_size(*parts)
        if total <= rate_budget:
            if total > best_total:
                best, best_total = parts, total
            if total >= rate_budget - max(16, rate_budget // 1024):
                break
        delta = (total - est) if est is not None else 0
        new_target = rate_budget - delta
        if total > rate_budget and new_target >= target:
            new_target = target - (total - rate_budget)   # force progress
        new_target = max(64, new_target)
        if new_target in prev_targets:
            break   # staircase fixed point: no finer threshold exists
        prev_targets.add(new_target)
        target = new_target
        reset_blocks()
        est = assign_fn(target)
        parts = build_parts()
        if target == 64 and core_size(*parts) > rate_budget:
            break   # minimum content still overshoots: unreachable
    if core_size(*parts) <= rate_budget and core_size(*parts) > best_total:
        best = parts
    if best is None:
        # unreachable even at minimum content: the smallest assembly, and
        # the overshoot is counted
        counters.add("enc.budget_overshoot")
        counters.add("enc.budget_overshoot_bytes",
                     core_size(*parts) - rate_budget)
        best = parts
    return best


def _wrap(header: Header, opts: Options, codestream: bytes) -> bytes:
    """The codestream as opts.format asks: raw (J2K) or in a JP2 or JPX
    container (utils/boxes.py)."""
    if opts.format == Format.J2K:
        return codestream
    return boxes.wrap_jp2(codestream, header, opts)


def _finalize_codestream(header: Header, opts: Options, main: bytes,
                         tile_parts: List[bytes], ppm_chunks: List[bytes],
                         total_pixels: int) -> bytes:
    """Main header, PPM (the tile-parts' packed packet headers), TLM (the
    tile-part lengths, A.4.17), the tile-parts and EOC, wrapped as
    opts.format asks."""
    out = bytearray(main)
    if opts.enable_ppm:
        out += cw.write_ppm(ppm_chunks)
    if opts.enable_tlm:
        out += cw.write_tlm([(t, len(tp)) for t, tp in enumerate(tile_parts)])
    for tp in tile_parts:
        out += tp
    out += cw.write_eoc()
    counters.add("enc.pixels_in", total_pixels)
    counters.add("enc.bytes_out", len(out))
    return _wrap(header, opts, bytes(out))


def _code_blocks(block_jobs, opts: Options, num_layers: int,
                 rate_budget: Optional[int]):
    """The block coder of opts.backend (the native one, or the Python
    oracles for "python") on one tile's jobs, with HT refinement passes
    where effective_ht_refinement turns them on; the native EBCOT coder
    computes the exact D.4.1 pass lengths only where asked and where PCRD
    reads them (layers or a budget), else its monotone upper bounds."""
    return encode_blocks_batch(
        block_jobs, backend=opts.backend,
        ht_refinement=opts.high_throughput and effective_ht_refinement(opts),
        ht_require_exact=opts.lossless,
        exact_rates=opts.exact_rates and (num_layers > 1
                                          or rate_budget is not None))


def _entropy_and_packets(header: Header, tile: geo.Tile, pyramids,
                         t_idx: int, opts: Options,
                         rate_budget: Optional[int]) -> Tuple[bytes, bytes]:
    """Single-tile host entropy + PCRD + packets for one frame (the JAX
    package's batch-path body); (tile-part, PPM chunk)."""
    enc_state, job_slots, block_jobs = _entropy_jobs(tile, pyramids)
    results = _code_blocks(block_jobs, opts,
                           header.coding_style.num_layers, rate_budget)
    return _assemble_packets(header, tile, enc_state, job_slots, results,
                             t_idx, opts, rate_budget)


def _tile_entropy(header: Header, comps: List[np.ndarray], t_idx: int,
                  opts: Options, precision: int, signed: bool,
                  num_layers: int, rate_budget: Optional[int], dev):
    """Transform and entropy-code one tile; returns (tile, enc_state,
    job_slots, results) for PCRD and packet assembly.  The tile's samples
    go to `dev` in their narrow dtype; DC shift, RCT or ICT, the DWT levels
    (the level kernels on the card) and, for 9/7, the deadzone
    quantization run there, the block coding on the host."""
    tile = geo.build_tile(header, t_idx)
    tx0, ty0, tx1, ty1 = header.tile_bounds(t_idx)
    tile_data = [comps[c][ty0 - header.y_offset:ty1 - header.y_offset,
                          tx0 - header.x_offset:tx1 - header.x_offset]
                 for c in range(len(tile.comps))]
    kind = dwt.REV53 if opts.lossless else dwt.IRR97
    nl0 = tile.comps[0].coding.num_decompositions
    use_mct = bool(header.coding_style.mct) and len(tile_data) >= 3
    quant_deltas = None
    if not opts.lossless and not header.comp_quant:
        quant_deltas = _leaf_deltas(tile, nl0)
    pyramids = transforms.run_forward(
        tile_data, nl0, kind, use_mct, precision, signed, tile.comps[0].x0,
        tile.comps[0].y0, dev, quant_deltas=quant_deltas)
    enc_state, job_slots, block_jobs = _entropy_jobs(
        tile, pyramids, opts.lossless,
        pre_quantized=quant_deltas is not None)
    results = _code_blocks(block_jobs, opts, num_layers, rate_budget)
    return tile, enc_state, job_slots, results


def encode(image: np.ndarray, opts: Optional[Options] = None,
           device="cuda") -> bytes:
    """Encode one image ([H, W] or [H, W, C] of any C, unsigned or signed
    integer samples of 1 to 29 bits lossless, 31 lossy) to a J2K
    codestream or a JP2 file, as the JAX package's encode: per tile
    (opts.tile_size, tile_offset, image_offset), the device transform and
    the host block coder (_tile_entropy); then one PCRD over every tile's
    passes (quality layers, and the byte budget of compression_ratio,
    corrected against the assembled size), and the Tier-2 packets of each
    tile, with the markers opts asks for.  `device` is where the
    transforms run; "cuda" without a card raises."""
    opts = opts or default_options()
    dev = transforms.resolve_device(device)
    image = np.asarray(image)
    comps = _image_components(image)
    header, main = header_and_main(image, opts)
    precision = header.components[0].precision
    signed = header.components[0].signed

    num_layers = header.coding_style.num_layers
    rate_budget = rate_mod.byte_budget(image, opts)
    states = []
    all_blocks: List[t2.EncBlock] = []
    all_weights: List[float] = []
    cw_mct = mct_comp_weights(header, opts.lossless, len(comps))
    for t_idx in range(header.num_tiles):
        tile, enc_state, job_slots, results = _tile_entropy(
            header, comps, t_idx, opts, precision, signed, num_layers,
            rate_budget, dev)
        blocks, wts = _build_blocks(job_slots, results, num_layers,
                                    opts.lossless, cw_mct)
        all_blocks += blocks
        all_weights += wts
        states.append((tile, enc_state))
    tile_parts, ppm_chunks = _assemble_with_budget(
        header, opts, states, all_blocks, num_layers, rate_budget, main,
        lambda target: rate_mod.assign_layers(all_blocks, all_weights,
                                              num_layers, target))
    return _finalize_codestream(header, opts, main, tile_parts, ppm_chunks,
                                int(image.size))


# Peak device bytes per sample (frame pixels times components) of one chunk
# of the fused encode: the int32 block batch (4 B, plus the padding of small
# bands) and the int32 values and lengths of its fields (17 B: one MagSgn,
# 3/4 VLC and 3/8 MEL field a sample) are alive together.  chip_smoke.py
# measured 23.5 (32 x 512^2 gray, lossless, max_mn 14) and 21.0 (2 x 2048^2
# RGB, lossy); the MagSgn word rows and the pool grow with max_mn, by up to
# 4 B a sample at max_mn 31.
FUSED_BYTES_PER_SAMPLE = 28
# device memory one chunk of the fused HT or device EBCOT encode may take
FUSED_CHUNK_BYTES = 1 << 31


def _chunk_frames(n_frames: int, pixels_per_frame: int,
                  target_pix: int = 1 << 26) -> int:
    """Frames per device chunk: at most target_pix samples (the host
    entropy branch keeps about 16 bytes of int32 buffers per sample;
    the fused branch passes FUSED_CHUNK_BYTES // FUSED_BYTES_PER_SAMPLE),
    in equal-sized chunks."""
    per = max(1, target_pix // max(1, pixels_per_frame))
    if per >= n_frames:
        return n_frames
    n_chunks = -(-n_frames // per)
    return max(1, -(-n_frames // n_chunks))


def segment_results(segs) -> List[t1.T1EncodeResult]:
    """Each block's (segment, numbps, distortion) from the fused HT encode
    -> the host coder's result for a cleanup-only block: one pass, its
    bitplanes signalled as 1 (the numbps the packet carries)."""
    out = []
    for seg, numbps, dist in segs:
        if numbps == 0:
            out.append(t1.T1EncodeResult(b"", 0, [], []))
        else:
            p = t1.PassInfo(2, 0, len(seg), dist, True)
            out.append(t1.T1EncodeResult(seg, 1, [p], [len(seg)]))
    return out


def tile_part_markers(opts: Options) -> bool:
    """Whether opts put markers inside the tile-parts or take the packet
    headers out of them (SOP, EPH, PLT, PPT, PPM), which the native
    single-layer Tier-2 of the fused HT encode does not write; TLM and
    JP2 wrap its output."""
    return bool(opts.enable_sop or opts.enable_eph or opts.enable_plt
                or opts.enable_ppt or opts.enable_ppm)


def _encode_batch_fused(batch: np.ndarray, header: Header, tile: geo.Tile,
                        plan, opts: Options, precision: int, signed: bool,
                        nl0: int, use_mct: bool, main: bytes, kind: str,
                        dev, rate_budget: Optional[int]) -> List[bytes]:
    """The fused device HT encode (models/fused_encode.py), one device
    program per chunk of frames, then native serialization and Tier-2 at
    one layer without a budget or markers in the tile-part; otherwise the
    natively serialized segments (one truncation point a block) go
    through the PCRD of each frame (quality layers, the byte budget) and
    the Python Tier-2, as the JAX package's fused branch.  Each frame's
    tile-part then goes through _finalize_codestream (TLM, PPM, JP2)."""
    n_frames = batch.shape[0]
    pixels = int(np.prod(batch.shape[1:]))
    chunk = _chunk_frames(n_frames, pixels,
                          FUSED_CHUNK_BYTES // FUSED_BYTES_PER_SAMPLE)
    native = (header.coding_style.num_layers == 1 and rate_budget is None
              and not tile_part_markers(opts))
    out: List[bytes] = []
    for s in range(0, n_frames, chunk):
        sub = batch[s:s + chunk]
        n = sub.shape[0]
        pool, totals = fused_encode.fused_encode_chunk(
            sub, plan, nl0, kind, use_mct, precision, signed, dev)
        counters.add("enc.fused_chunks")
        if native:
            bodies = fused_encode.fetch_bodies(pool, totals, n, plan, header,
                                               tile)
        else:
            parts = []
            for segs in fused_encode.fetch_segments(pool, totals, n, plan):
                enc_state, job_slots = _walk_geometry(tile)
                parts.append(_assemble_packets(
                    header, tile, enc_state, job_slots,
                    segment_results(segs), 0, opts, rate_budget))
        with counters.span("enc.finalize"):
            if native:
                parts = [(cw.write_sot(0, 12 + 2 + len(body), 0, 1)
                          + cw.write_sod() + body, b"") for body in bodies]
            out += [_finalize_codestream(header, opts, main, [tp], [hdrs],
                                         pixels) for tp, hdrs in parts]
    return out


# Peak device bytes per sample of one chunk of the device EBCOT encode, in
# two parts: per bitplane of the plan, the decision slots (23 per stripe
# column and plane: 5.75 bytes a sample for 64x64 blocks, 6.3 with the
# padding of the small bands of a 512^2 frame); and, whatever the planes,
# the int32 blocks, mags and signs, the valid mask and the transform's
# tensors, which the decision pool and the MQ segment rows (3 bytes per
# decision, about 6 decisions a sample) replace once the slots are freed.
# chip_smoke.py measured 87.8 (8 x 512^2 gray, 11 planes) on an H100.
EBCOT_BYTES_PER_SAMPLE_PLANE = 8
EBCOT_BYTES_PER_SAMPLE = 40


def _encode_batch_ebcot(batch: np.ndarray, header: Header, tile: geo.Tile,
                        plan, opts: Options, precision: int, signed: bool,
                        nl0: int, use_mct: bool, main: bytes, dev,
                        hybrid: bool) -> List[bytes]:
    """The device EBCOT encode (models/ebcot_fused.py), one device program
    per chunk of frames: path A (hybrid=False) codes the MQ segments on the
    device, path B (hybrid=True) fetches the decision streams and codes
    them with the native MQ coder.  Then the Python Tier-2 per frame (with
    the markers opts asks for) and _finalize_codestream."""
    n_frames = batch.shape[0]
    pixels = int(np.prod(batch.shape[1:]))
    per_sample = (EBCOT_BYTES_PER_SAMPLE
                  + EBCOT_BYTES_PER_SAMPLE_PLANE * ebcot_fused.max_planes(plan))
    chunk = _chunk_frames(n_frames, pixels, FUSED_CHUNK_BYTES // per_sample)
    program = (ebcot_fused.ebcot_decisions_chunk if hybrid
               else ebcot_fused.ebcot_encode_chunk)
    fetch = (ebcot_fused.fetch_results_hybrid if hybrid
             else ebcot_fused.fetch_results)
    nb = plan.nb
    out: List[bytes] = []
    for s in range(0, n_frames, chunk):
        sub = batch[s:s + chunk]
        results = fetch(program(sub, plan, nl0, use_mct, precision, signed,
                                dev))
        counters.add("enc.ebcot_hybrid_chunks" if hybrid
                     else "enc.ebcot_device_chunks")
        for i in range(sub.shape[0]):
            enc_state, job_slots = _walk_geometry(tile)
            tp, hdrs = _assemble_packets(header, tile, enc_state, job_slots,
                                         results[i * nb:(i + 1) * nb], 0,
                                         opts)
            out.append(_finalize_codestream(header, opts, main, [tp],
                                            [hdrs], pixels))
    return out


# encode_batch calls in this process: the number its enc.batch span carries
_BATCH_CALLS = itertools.count(1)


def encode_batch(images: Sequence[np.ndarray],
                 opts: Optional[Options] = None,
                 device="cuda") -> List[bytes]:
    """Encode frames of one shape to J2K codestreams or JP2 files; frames
    of differing shapes or dtypes, and tiled or offset images, go one by
    one through `encode`, as in the JAX package.  HTJ2K: where
    fused_encode.plan_for admits the configuration (one precinct per band,
    no HT refinement, no PPM, backend "auto" or "native"), each chunk of
    frames runs the fused device HT encode (DC shift, RCT/ICT, DWT, block
    extraction and quantization, the HT cleanup pass with its bit packing,
    pool compaction) and the host serializes and assembles packets in C++
    (with quality layers, a budget, SOP, EPH, PLT or PPT: a PCRD per
    frame, Python Tier-2).  Part-1 lossless, code-block style 0, one layer,
    no budget and no PPM: where ebcot_fused.plan_for admits it, backend
    "device" or "auto" (path A) runs the device EBCOT encode up to the MQ
    segment pool, backend "hybrid" (path B) up to the decision streams,
    which the native MQ coder codes; the Python Tier-2 assembles packets.
    Otherwise (HT refinement, Part-1 layers, styles, byte budgets, lossy
    Part-1, PPM, backend "native" (path C) or "python") the device
    transforms and the host codes blocks, runs PCRD and assembles packets
    per frame.  Every frame's codestream equals `encode`'s of the frame,
    TLM and PPM included (the JAX package's encode_batch drops TLM and
    fails on PPM).  `device` is where the device work runs; "cuda" without
    a card raises.  Counters: enc.fused_chunks, enc.ebcot_device_chunks,
    enc.ebcot_hybrid_chunks, enc.host_entropy_frames; under a torch
    profiler, the spans enc.batch, enc.header, enc.stack and the fused
    path's (utils/metrics.py)."""
    opts = opts or default_options()
    dev = transforms.resolve_device(device)
    images = [np.asarray(im) for im in images]
    if not images:
        return []
    if not batch_takes(images, opts):
        return [encode(im, opts, dev) for im in images]
    with counters.span("enc.batch", str(next(_BATCH_CALLS))):
        with counters.span("enc.header"):
            header, main = header_and_main(images[0], opts)
            precision = header.components[0].precision
            signed = header.components[0].signed
            n_comps = header.num_components

            tile = geo.build_tile(header, 0)
            use_mct = bool(header.coding_style.mct) and n_comps >= 3
            nl0 = tile.comps[0].coding.num_decompositions
            x0, y0 = tile.comps[0].x0, tile.comps[0].y0
            kind = dwt.REV53 if opts.lossless else dwt.IRR97
            deltas = None if opts.lossless else _leaf_deltas(tile, nl0)
            num_layers = header.coding_style.num_layers
            rate_budget = rate_mod.byte_budget(images[0], opts)
        # frames ship in their narrow dtype; the cast to int32 runs on
        # device
        with counters.span("enc.stack"):
            batch = np.stack([np.stack(_image_components(im))
                              for im in images])
        n_frames, c, h, w = batch.shape
        pixels = c * h * w
        with counters.span("enc.header"):
            plan = eplan = None
            if (opts.high_throughput and not effective_ht_refinement(opts)
                    and not opts.enable_ppm
                    and opts.backend in ("auto", "native")):
                plan = fused_encode.plan_for(header, tile,
                                             lossy=not opts.lossless)
            if (not opts.high_throughput and opts.lossless
                    and num_layers == 1 and rate_budget is None
                    and not effective_ht_refinement(opts)
                    and not opts.enable_ppm
                    and header.coding_style.cb_style == 0
                    and opts.backend in ("auto", "device", "hybrid")):
                eplan = ebcot_fused.plan_for(header, tile)
        if plan is not None:
            out = _encode_batch_fused(batch, header, tile, plan, opts,
                                      precision, signed, nl0, use_mct, main,
                                      kind, dev, rate_budget)
        elif eplan is not None:
            out = _encode_batch_ebcot(batch, header, tile, eplan, opts,
                                      precision, signed, nl0, use_mct, main,
                                      dev, hybrid=opts.backend == "hybrid")
        else:
            counters.add("enc.host_entropy_frames", n_frames)
            chunk = _chunk_frames(n_frames, pixels)
            out = []
            for s in range(0, n_frames, chunk):
                sub = batch[s:s + chunk]
                flat = transforms.dispatch_forward_batch(
                    sub, nl0, kind, use_mct, precision, signed, x0, y0, dev,
                    deltas)
                pyrs = transforms.fetch_forward_batch(
                    flat, sub.shape[0], c, h, w, nl0, x0, y0)
                for pyr in pyrs:
                    tp, hdrs = _entropy_and_packets(header, tile, pyr, 0,
                                                    opts, rate_budget)
                    out.append(_finalize_codestream(header, opts, main,
                                                    [tp], [hdrs], pixels))
    return out
