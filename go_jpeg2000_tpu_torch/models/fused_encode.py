"""Host-side block plan of the fused HT encode (numpy only).

Port of the host half of go_jpeg2000_tpu/models/fused_encode.py: the static
per-configuration block geometry (`BlockPlan`, `plan_for`, `plan_blocks`)
and the flattened single-layer packet walk (`t2_geom`) that the native
ht_t2_{en,de}code_frames consume.  The decoder uses them to run T2 and HT
block decoding in one native call.  The device half (block extraction and
the HT cleanup field, packing and compaction kernels) arrives with slice 3
(ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..codestream.header import Header
from ..tcd import geometry as geo
from ..utils import markers as mk


@dataclasses.dataclass
class BlockPlan:
    """Static per-config geometry: device block order == canonical job order
    (_walk_geometry in models/encoder.py)."""
    nb: int                       # blocks per frame
    cbh: int                      # padded (uniform) block dims
    cbw: int
    hs: np.ndarray                # true per-block dims [nb]
    ws: np.ndarray
    band_specs: List[Tuple]       # (comp, dec_level|0 for LL, name, gy, gx,
                                  #  eff_cbh, eff_cbw, bh, bw, oy, ox) where
                                  #  (oy, ox) = band origin offset within
                                  #  its code-block grid cell (0 for tiles
                                  #  at the canonical origin)
    max_mn: int
    total_pixels: int             # pool caps are adaptive (_caps_for)
    bclass: np.ndarray = None     # per-block band class [nb] (0 LL/LH,
                                  # 1 HL, 2 HH) — device EBCOT path
    mb: np.ndarray = None         # per-block max bitplanes [nb]
    deltas: Tuple = None          # per-band quantizer steps (lossy plans;
                                  # None => reversible, no quantization)


_PLAN_MEMO = {}


def plan_for(header: Header, tile: geo.Tile,
             ht: bool = True, multi_tile: bool = False,
             lossy: bool = False) -> Optional[BlockPlan]:
    """Memoized plan: one BlockPlan (and hence one jit cache entry) per
    codestream configuration.  With multi_tile=True, plans are shared by
    tile-origin CLASS — tiles whose origins agree modulo
    cb_size * 2^levels have identical band/grid offsets everywhere, so one
    compiled kernel serves all of them (at most 4 classes on a uniform
    grid).  lossy=True admits the irreversible 9/7 path: the plan carries
    per-band quantizer steps and the kernel quantizes on device."""
    cs = tile.comps[0].coding
    # every component's quantization: it sets each block's Mb and, lossy,
    # each band's step (a QCC may differ from the QCD)
    key = [header.num_components,
           header.components[0].precision, header.components[0].signed,
           cs.num_decompositions, cs.cb_width_exp, cs.cb_height_exp,
           cs.mct, tuple(cs.precincts or ()), ht, lossy,
           tuple((tc.quant.guard_bits, tc.quant.style,
                  tuple((s.exponent, s.mantissa)
                        for s in tc.quant.step_sizes))
                 for tc in tile.comps)]
    if multi_tile:
        mx = 1 << (cs.cb_width_exp + cs.num_decompositions)
        my = 1 << (cs.cb_height_exp + cs.num_decompositions)
        key += [tile.x1 - tile.x0, tile.y1 - tile.y0,
                tile.x0 % mx, tile.y0 % my]
    else:
        key += [header.width, header.height]
    key = tuple(key)
    if key not in _PLAN_MEMO:
        _PLAN_MEMO[key] = plan_blocks(header, tile, ht=ht,
                                      multi_tile=multi_tile, lossy=lossy)
    return _PLAN_MEMO[key]


def plan_blocks(header: Header, tile: geo.Tile,
                ht: bool = True, multi_tile: bool = False,
                lossy: bool = False) -> Optional[BlockPlan]:
    """Build the static block plan, or None if the fast path doesn't apply.

    Gates (mirrors dwt_pallas-style eligibility): no subsampling, uniform
    coding across components, one precinct per band, reversible 5/3, and HT
    code-blocks (ht=True) or plain style-0 EBCOT blocks (ht=False, the
    device EBCOT path).  Default: single tile at the canonical origin.
    multi_tile=True additionally admits tiles at offsets divisible by
    2^levels (the encode_sharded grid gate) — their code-block grids carry
    per-band (oy, ox) offsets handled by _extract_blocks.
    """
    if not multi_tile and (header.num_tiles != 1
                           or tile.x0 != 0 or tile.y0 != 0):
        return None
    if header.coding_style.transform != (0 if lossy else 1):
        return None
    cs0 = tile.comps[0].coding
    if ht and not (cs0.cb_style & mk.CBSTYLE_HT):
        return None
    if not ht and cs0.cb_style != 0:
        return None
    levels = cs0.num_decompositions
    if multi_tile and ((tile.x0 % (1 << levels))
                       or (tile.y0 % (1 << levels))):
        return None
    cbh, cbw = 1 << cs0.cb_height_exp, 1 << cs0.cb_width_exp
    hs: List[int] = []
    ws: List[int] = []
    bclass: List[int] = []
    mbs: List[int] = []
    band_specs: List[Tuple] = []
    deltas: List[float] = []
    max_mb = 0
    band_cls = {"LL": 0, "LH": 0, "HL": 1, "HH": 2}
    for c, tc in enumerate(tile.comps):
        if tc.x0 != tile.x0 or tc.y0 != tile.y0:
            return None
        if (tc.coding.cb_width_exp != cs0.cb_width_exp
                or tc.coding.cb_height_exp != cs0.cb_height_exp
                or tc.coding.num_decompositions != cs0.num_decompositions
                or tc.coding.cb_style != cs0.cb_style):
            return None
        hdr_c = header.components[c]
        if hdr_c.dx != 1 or hdr_c.dy != 1:
            return None
        for res in tc.resolutions:
            for band in res.bands:
                if len(band.precincts) != 1:
                    return None
                prec = band.precincts[0]
                eh, ew = 1 << res.cb_h_exp, 1 << res.cb_w_exp
                bh, bw = band.h, band.w
                if bh == 0 or bw == 0:
                    if prec.code_blocks:
                        return None
                    continue
                # block grid anchored at multiples of (eh, ew) in band
                # coords (B.7): offset of the band origin within its cell
                oy, ox = band.y0 % eh, band.x0 % ew
                gy = geo.ceil_div(bh + oy, eh)
                gx = geo.ceil_div(bw + ox, ew)
                if len(prec.code_blocks) != gy * gx:
                    return None
                mb = tc.quant.guard_bits + band.eps - 1
                gx0 = band.x0 - ox
                gy0 = band.y0 - oy
                # geometry emits row-major grid blocks — verify
                for i, cb in enumerate(prec.code_blocks):
                    yy, xx = divmod(i, gx)
                    if (cb.x0 != max(gx0 + xx * ew, band.x0)
                            or cb.y0 != max(gy0 + yy * eh, band.y0)):
                        return None
                    hs.append(cb.h)
                    ws.append(cb.w)
                    bclass.append(band_cls[band.name])
                    mbs.append(mb)
                band_specs.append((c, band.dec_level if band.name != "LL"
                                   else 0, band.name, gy, gx, eh, ew, bh, bw,
                                   oy, ox))
                deltas.append(float(band.delta))
                max_mb = max(max_mb, mb)
    nb = len(hs)
    if nb == 0:
        return None
    hs_a = np.asarray(hs, np.int32)
    ws_a = np.asarray(ws, np.int32)
    total_px = int((hs_a.astype(np.int64) * ws_a).sum())
    max_mn = min(31, max_mb + 2)
    return BlockPlan(nb=nb, cbh=cbh, cbw=cbw, hs=hs_a, ws=ws_a,
                     band_specs=band_specs, max_mn=max_mn,
                     total_pixels=total_px,
                     bclass=np.asarray(bclass, np.int32),
                     mb=np.asarray(mbs, np.int32),
                     deltas=tuple(deltas) if lossy else None)




# ---------------------------------------------------------------------------
# Native single-layer T2: flat geometry arrays for j2k_native's packet walk.
# ---------------------------------------------------------------------------

_GEOM_MEMO = {}


def t2_geom(header: Header, tile: geo.Tile, plan: BlockPlan):
    """Flatten the packet walk (progression order, single layer) into the
    arrays ht_t2_{en,de}code_frames consume.  Block ids are the canonical
    job order (models/encoder.py::_walk_geometry)."""
    key = id(plan)
    if key in _GEOM_MEMO:
        return _GEOM_MEMO[key]
    from ..tcd import t2 as t2_mod

    # canonical job order walk: id per block + per-block mb
    state = {}
    mb_list = []
    next_id = 0
    for c, tc in enumerate(tile.comps):
        for res in tc.resolutions:
            for band in res.bands:
                mb = tc.quant.guard_bits + band.eps - 1
                for p_idx, prec in enumerate(band.precincts):
                    state.setdefault((c, res.r, p_idx), []).append(
                        (prec, next_id))
                    for cb in prec.code_blocks:
                        mb_list.append(mb)
                        next_id += 1
    assert next_id == plan.nb

    seq = t2_mod.packet_sequence(tile, header)
    # single layer: keep layer-0 packets only (callers gate num_layers == 1)
    seq = [p for p in seq if p.layer == 0]
    pkt_nbp = []
    bp_cbw = []
    bp_cbh = []
    bp_nblocks = []
    bp_blocks = []
    bp_block_xy = []
    for pid in seq:
        entries = state.get((pid.comp, pid.res, pid.precinct), [])
        pkt_nbp.append(len(entries))
        for prec, base in entries:
            bp_cbw.append(prec.cbw)
            bp_cbh.append(prec.cbh)
            bp_nblocks.append(len(prec.code_blocks))
            for i, cb in enumerate(prec.code_blocks):
                bp_blocks.append(base + i)
                bp_block_xy += [cb.cbx, cb.cby]
    geom = {
        "n_packets": len(seq),
        "pkt_nbp": np.asarray(pkt_nbp, np.int32),
        "bp_cbw": np.asarray(bp_cbw, np.int32),
        "bp_cbh": np.asarray(bp_cbh, np.int32),
        "bp_nblocks": np.asarray(bp_nblocks, np.int32),
        "bp_blocks": np.asarray(bp_blocks, np.int32),
        "bp_block_xy": np.asarray(bp_block_xy, np.int32),
        "mb": np.asarray(mb_list, np.int32),
    }
    _GEOM_MEMO[key] = geom
    return geom
