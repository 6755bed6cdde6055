"""Batch decoder: HTJ2K J2K codestreams -> frames.

Port of the host-HT branch of go_jpeg2000_tpu/models/decoder.py
`_decode_batch_fused`: the native C++ library parses Tier-2 and decodes
every HT code-block of every frame in one call (ht_t2_decode_frames); the
block slots become pyramid leaves on the host (`_blocks_to_pyramid`), ride
one flat upload, and the device runs, for the whole batch, the inverse 5/3
and inverse RCT, or the midpoint dequantization (as the JAX package's
ops/ht_tpu_decode.py does it), inverse 9/7 and inverse ICT; then DC shift,
clamp and narrowing.  The DWT levels go through the CUDA level kernels on
the card.  The JAX package sends lossy streams to its device MagSgn decode
instead (ROADMAP Queue 1 item 4); the native call gives the same indices.

The slices: single-tile, single-layer, lossless 5/3 or lossy 9/7 HT J2K
streams of one shape, without SOP/EPH/PPM/PPT, decoded whole.  Everything
else raises NotImplementedError naming the ROADMAP item that brings it.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..codestream.parser import Parser
from ..native import loader
from ..ops import dwt
from ..options import Config, Format
from ..tcd import geometry as geo
from ..utils import markers as mk
from ..utils.metrics import counters
from . import fused_encode, transforms
from .entropy_backend import require_native


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
        if not cs.cb_style & mk.CBSTYLE_HT:
            raise _not_ported("EBCOT (Part 1) decoding", "6")
        if cs.num_layers != 1:
            raise _not_ported("quality layers", "6")
        if (cs.has_sop or cs.has_eph or hdr.ppm
                or any(tp.packed_headers for tp in tile_parts)):
            raise _not_ported("SOP/EPH/PPM/PPT streams", "6")
        if any(c.signed or not 8 <= c.precision <= 16
               for c in hdr.components):
            raise _not_ported("signed or out-of-range sample precision", "6")


def _leaf_level(lev: int, name: str, nl: int) -> int:
    """Pyramid list index of a plan band (LL sits with the top level)."""
    if name == "LL":
        return nl - 1 if nl > 0 else 0
    return lev - 1


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
        stacked[_leaf_level(lev, name, nl)][name] = np.stack(comps, axis=1)
    return stacked


def _pyramid_deltas(plan, nl: int):
    """The plan's per-band quantizer steps, shaped like _blocks_to_pyramid's
    result: per level, band -> one step per component."""
    deltas = [dict() for _ in range(max(1, nl))]
    for (_c, lev, name, *_), d in zip(plan.band_specs, plan.deltas):
        deltas[_leaf_level(lev, name, nl)].setdefault(name, []).append(d)
    return deltas


def decode_batch(streams, config: Optional[Config] = None,
                 device="cuda") -> List[np.ndarray]:
    """Decode same-shape single-tile HTJ2K codestreams, lossless or lossy,
    to frames ([H, W] gray or [H, W, C]): host T2 + HT decode in one native
    call, then one inverse transform on `device` for the whole batch.
    "cuda" without a card raises."""
    config = config or Config()
    dev = transforms.resolve_device(device)
    if not streams:
        return []
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
    plan = fused_encode.plan_for(header, tile, lossy=not lossless)
    if plan is None:
        raise _not_ported("this code-block/precinct geometry", "6")
    geom = fused_encode.t2_geom(header, tile, plan)
    require_native()

    n_frames = len(parsed)
    nl = tile.comps[0].coding.num_decompositions
    n_comps = header.num_components
    precision = header.components[0].precision
    signed = header.components[0].signed
    use_mct = bool(header.coding_style.mct) and n_comps >= 3
    datas = [b"".join(cs[tp.data_start:tp.data_end] for tp in tps)
             for _hdr, tps, cs in parsed]
    frame_off = np.zeros(n_frames + 1, np.int64)
    np.cumsum([len(d) for d in datas], out=frame_off[1:])
    buf = np.frombuffer(b"".join(datas), dtype=np.uint8)
    coeffs = loader.ht_t2_decode_frames(
        buf, frame_off, n_frames, plan.nb, geom, geom["mb"], plan.ws,
        plan.hs, plan.cbh, plan.cbw)
    if coeffs is None:
        raise _not_ported("HT refinement passes (or truncated streams)",
                          "6")
    stacked = _blocks_to_pyramid(coeffs, plan, n_frames, n_comps, nl)
    out = transforms.dispatch_inverse_stacked(
        stacked, n_frames, n_comps, max(1, nl),
        dwt.REV53 if lossless else dwt.IRR97, use_mct, precision, signed,
        tile.comps[0].x0, tile.comps[0].y0, dev,
        None if lossless else _pyramid_deltas(plan, nl))

    dt = np.uint8 if precision <= 8 else np.uint16
    th, tw = tile.comps[0].h, tile.comps[0].w
    arr = out.cpu().numpy().view(dt).reshape(n_frames, n_comps, th, tw)
    counters.add("dec.bytes_in", sum(len(s) for s in streams))
    counters.add("dec.pixels_out", int(arr.size))
    return [a[0] if n_comps == 1 else np.moveaxis(a, 0, -1) for a in arr]
