"""Fused device HT encode: image batch -> compacted HT bitstreams.

Port of go_jpeg2000_tpu/models/fused_encode.py.  The host half is the
static per-configuration block geometry (`BlockPlan`, `plan_for`,
`plan_blocks`) and the flattened single-layer packet walk (`t2_geom`) that
the native ht_t2_{en,de}code_frames consume; the decoder uses them too.

The device half, `fused_encode_chunk`, runs on the tensor's device: upload,
DC shift, RCT/ICT and the DWT levels (models/transforms.py), then block
extraction (with deadzone quantization for 9/7), the HT cleanup pass with
its bit packing, and pool compaction (ops/ht_enc_cuda.py: the CUDA kernels
on the card, their plain torch versions on the CPU).  What reaches the
host is one int32 array, [6 x Nb meta | MagSgn | VLC | MEL], of which
only the used prefix is copied (`fetch_pool`), never the coefficient
pyramid.  The host then only serializes segments and assembles Tier-2
packets in C++ (`fetch_bodies`, or `fetch_segments` for the Python Tier-2
with PLT).
The pools hold exactly the streams' words, so nothing overflows and nothing
is retried.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codestream.header import Header
from ..native import loader
from ..ops import block_layout, ht_enc, ht_enc_cuda, quant
from ..tcd import geometry as geo
from ..utils import markers as mk
from ..utils.metrics import counters
from . import transforms


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
    key: Tuple = None             # plan_for's memo key (None when built
                                  # by plan_blocks directly)


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
           cs.mct, cs.cb_style, tuple(cs.precincts or ()), ht, lossy,
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
        plan = plan_blocks(header, tile, ht=ht, multi_tile=multi_tile,
                           lossy=lossy)
        if plan is not None:
            plan.key = key
        _PLAN_MEMO[key] = plan
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


def extract_blocks(pyr, plan: BlockPlan, n: int, nl: int,
                   tiles: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Pyramid leaves [N, C, bh, bw] -> block batch int32 [N*nb, CBH, CBW]
    in canonical job order (frame-major); the plain version of the
    ht_extract_blocks kernel.  Lossy plans quantize each band with its own
    step (plan.deltas: one per band and component) as quant.quantize does.
    With `tiles` (N positions) the batch is those frames of the leaves, as
    the JAX program's jnp.take of a class's tiles before _extract_blocks
    (ht_enc_cuda.check_tiles: ValueError unless every leaf holds the same
    number of frames and each position lies below it).

    Offset grids (multi-tile plans): the band content is padded into its
    grid-aligned footprint, which leaves first-row/first-column slots with
    their valid samples at (oy, ox) instead of the kernel's expected
    top-left anchor; those slots are rolled up/left (the vacated area is
    zero padding, so the roll is clean)."""
    if tiles is not None:
        ht_enc_cuda.check_tiles("extract_blocks", tiles, n, [
            ht_enc_cuda.band_leaf(pyr, s[1], s[2], nl).shape[0]
            for s in plan.band_specs])
    per_band = []
    for bi, (c, lev, name, gy, gx, eh, ew, bh, bw, oy, ox) in \
            enumerate(plan.band_specs):
        a = ht_enc_cuda.band_leaf(pyr, lev, name, nl)
        if tiles is not None:
            a = a.index_select(0, torch.tensor(list(tiles), dtype=torch.int64,
                                               device=a.device))
        a = a[:, c]
        if plan.deltas is not None:
            a = quant.quantize(a, plan.deltas[bi])
        ph, pw = gy * eh, gx * ew
        grid = a.new_zeros((n, ph, pw), dtype=torch.int32)
        grid[:, oy:oy + bh, ox:ox + bw] = a
        a = grid.reshape(n, gy, eh, gx, ew).permute(0, 1, 3, 2, 4)
        if oy:
            a = torch.cat([torch.roll(a[:, :1], -oy, dims=-2), a[:, 1:]],
                          dim=1)
        if ox:
            a = torch.cat([torch.roll(a[:, :, :1], -ox, dims=-1),
                           a[:, :, 1:]], dim=2)
        a = a.reshape(n, gy * gx, eh, ew)
        if (eh, ew) != (plan.cbh, plan.cbw):
            slots = a.new_zeros((n, gy * gx, plan.cbh, plan.cbw))
            slots[:, :, :eh, :ew] = a
            a = slots
        per_band.append(a)
    blocks = torch.cat(per_band, dim=1)             # [N, nb, CBH, CBW]
    return blocks.reshape(n * plan.nb, plan.cbh, plan.cbw)


_DIMS = {}


def _block_dims(plan: BlockPlan, n: int, device: torch.device):
    """True block sizes (hs, ws) of n frames, int32 on `device`, cached per
    plan (block_layout.plan_cache)."""
    def build():
        return tuple(torch.from_numpy(np.tile(a, n).astype(np.int32)).to(
            device) for a in (plan.hs, plan.ws))
    return block_layout.plan_cache(_DIMS, plan, (n, torch.device(device)),
                                   build)


def fused_encode_chunk(batch: np.ndarray, plan: BlockPlan, levels: int,
                       kind: str, use_mct: bool, precision: int,
                       signed: bool, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The device program of one chunk of frames [N, C, H, W] (narrow host
    samples): upload, DC shift, MCT, the DWT levels, then block extraction,
    the HT cleanup pass with its three streams packed, and pool
    compaction.  Returns the int32 array [6*Nb meta | MagSgn | VLC | MEL]
    (valid up to 6*Nb + sum(totals)) and the pools' word totals int64 [3],
    both on `device`."""
    dev = torch.device(device)
    # no reference to the pyramid stays here: encode_pyramid frees it once
    # the blocks are extracted
    with counters.span("enc.launch"):
        return encode_pyramid(
            transforms.forward_pyramid(_upload(batch, dev), levels, kind,
                                       use_mct, precision, signed, 0, 0),
            plan, batch.shape[0], levels)


def _upload(batch: np.ndarray, dev: torch.device) -> torch.Tensor:
    """transforms.upload under the fused path's enc.upload span."""
    with counters.span("enc.upload"):
        return transforms.upload(batch, dev)


def encode_pyramid(pyr, plan: BlockPlan, n: int, levels: int,
                   tiles: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The entropy half of fused_encode_chunk on the pyramid of n frames or
    tiles of one plan (leaves [n, C, h, w] on one device; a lossy plan
    quantizes them): block extraction, the HT cleanup pass with its streams
    packed, and pool compaction.  With `tiles` (n positions) the batch is
    those frames of the leaves, which may hold more (a tile-origin class of
    a tile batch), read in place.  Returns the pool array and its word
    totals."""
    blocks = ht_enc_cuda.extract_blocks(pyr, plan, n, levels, tiles)
    del pyr
    hs, ws = _block_dims(plan, n, blocks.device)
    f = ht_enc_cuda.cleanup_fields(blocks, hs, ws, plan.max_mn)
    del blocks
    return ht_enc_cuda.assemble_pool(*(f[k] for k in (
        "ms_words", "ms_bits", "vlc_words", "vlc_bits", "mel_words",
        "mel_bits", "numbps", "u_max", "dist")))


def fetch_pool(out: torch.Tensor, totals: torch.Tensor, n: int,
               plan: BlockPlan):
    """Copy the used prefix of a chunk's array to the host: the word totals
    first (this waits for the device), then meta and the three pools in one
    copy into pinned memory.  Returns (meta int32 [6, Nb], pool uint32,
    totals int64 [3])."""
    nmeta = 6 * plan.nb * n
    with counters.span("enc.fetch.wait"):
        tot = totals.cpu().numpy()
    with counters.span("enc.fetch.copy"):
        used = out[:nmeta + int(tot.sum())]
        if used.is_cuda:
            host = torch.empty(used.shape, dtype=used.dtype, pin_memory=True)
            host.copy_(used)
            used = host
        arr = used.numpy()
    return arr[:nmeta].reshape(6, -1), arr[nmeta:].view(np.uint32), tot


def _pool_placement(meta: np.ndarray, tot: np.ndarray):
    """Host twin of ht_compact_pool's placement: (offset, word count, bits)
    of each stream in the pool.  Raises if it disagrees with the device's
    totals."""
    out = []
    base = 0
    for s in range(3):
        off, nw = ht_enc.pool_offsets(meta[s], base)
        if int(nw.sum()) != int(tot[s]):
            raise RuntimeError(f"stream {s}: the device pool holds "
                               f"{int(tot[s])} words, the bit counts "
                               f"{int(nw.sum())}")
        out += [off, nw, meta[s]]
        base += int(tot[s])
    return out


def fetch_bodies(out: torch.Tensor, totals: torch.Tensor, n: int,
                 plan: BlockPlan, header: Header, tile: geo.Tile
                 ) -> List[bytes]:
    """Single-layer path: fetch, then native segment serialization and
    Tier-2 in one C++ call per chunk.  Returns per-frame tile-body bytes
    (packets only)."""
    return t2_bodies(*fetch_pool(out, totals, n, plan), n, plan, header,
                     tile)


def t2_bodies(meta: np.ndarray, pool: np.ndarray, tot: np.ndarray, n: int,
              plan: BlockPlan, header: Header, tile: geo.Tile
              ) -> List[bytes]:
    """The host tail of fetch_bodies: ht_t2_encode_frames on a fetched
    pool."""
    with counters.span("enc.t2"):
        numbps = meta[3]
        geom = t2_geom(header, tile, plan)
        mb = np.tile(geom["mb"], n)
        # cleanup-only HT convention (matches the host path + OpenJPEG
        # interop): one coding pass -> signal a single magnitude bitplane
        # (zbp = Mb - 1)
        zbp = np.where(numbps > 0, mb - 1, mb).astype(np.int32)
        return loader.ht_t2_encode_frames(
            pool, *_pool_placement(meta, tot), numbps, zbp, n, plan.nb, geom)


def fetch_segments(out: torch.Tensor, totals: torch.Tensor, n: int,
                   plan: BlockPlan) -> List[List[Tuple[bytes, int, float]]]:
    """Fetch and serialize every block natively.  Returns per-frame lists
    of (segment, numbps, distortion)."""
    meta, pool, tot = fetch_pool(out, totals, n, plan)
    numbps = meta[3]
    dist = meta[5].view(np.float32)
    segs = loader.ht_serialize_blocks(pool, *_pool_placement(meta, tot),
                                      numbps)
    nb = plan.nb
    return [[(segs[i * nb + j], int(numbps[i * nb + j]),
              float(dist[i * nb + j])) for j in range(nb)]
            for i in range(n)]


# ---------------------------------------------------------------------------
# Native single-layer T2: flat geometry arrays for j2k_native's packet walk.
# ---------------------------------------------------------------------------

_GEOM_MEMO = {}


def t2_geom(header: Header, tile: geo.Tile, plan: BlockPlan):
    """Flatten the packet walk (progression order, single layer) into the
    arrays ht_t2_{en,de}code_frames consume.  Block ids are the canonical
    job order (models/encoder.py::_walk_geometry).  Memoized on what sets
    the walk: the plan's key (the block geometry, one tile-origin class of
    a multi-tile grid) and the header's progression order and POC
    segments; a plan without a key is walked afresh."""
    cs = header.coding_style
    key = None if plan.key is None else (
        plan.key, int(cs.progression_order), cs.num_layers,
        tuple(tuple(vars(p).values()) for p in header.poc))
    if key is not None and key in _GEOM_MEMO:
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
    if key is not None:
        _GEOM_MEMO[key] = geom
    return geom
