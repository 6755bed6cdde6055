"""Tile-sharded encode and decode (BASELINE config 4) on torch.distributed.

Port of go_jpeg2000_tpu/parallel/sharded.py.  Tiles shard over the grid's
'dp' ranks (tile t to shard t // ceil(T / dp), as the JAX package assigns
them) and the rows of each tile over its 'sp' ranks (parallel/mesh.py).
One rank runs, on its device:

- the transform step (`tile_transform_step`, for make_tile_transform_step):
  DC shift, RCT or ICT, the multi-level DWT of its row shards through the
  level kernels (csrc/dwt53.cu, dwt97.cu), which read the rows that the
  vertical lifting reaches beyond the shard from every shard's edge rows
  (`edges`), and the band statistics
  (ops/band_stats.py, csrc/band_stats.cu), summed over the grid;
- the device HT entropy (`_device_ht_entropy`, for _shard_fields_fn): per
  tile-origin class, the three HT encode kernels of csrc/ht_enc.cu
  (fused_encode.encode_pyramid; the extraction reads the class's tiles in
  place in the leaves) and native Tier-2 on the host, or, with SOP, EPH,
  PLT, PPT or PPM, the Python Tier-2 on the natively serialized segments;
- for layers, byte budgets, Part-1 and backend "python" the host entropy
  branch: the block coder per tile;
- after either, where Python Tier-2 assembles, the distributed PCRD
  (rate.assign_layers_sharded with `GroupComm`, a float64 all_reduce over
  the dp ranks), each dp shard assembling its own tile-parts (and PPM
  chunks) against the global byte count;
- on decode, the native Tier-2 and MEL/VLC parse per class, the two HT
  decode kernels of csrc/ht_dec.cu (with the midpoint dequantization of 9/7
  streams) scattered into one leaf per band, and the inverse step
  (`tile_inverse_step`, for make_tile_inverse_step): the inverse level
  kernels on the shards' edges, then inverse RCT or ICT, rounding, DC
  shift and clamp.

The halo exchange differs from the JAX package's, which sends one boundary
row per lifting step with ppermute (two exchanges a 5/3 level, four a 9/7
level).  Here each level exchanges once: every sp rank packs its edge slot
(its first and last dwt.EDGE_ROWS rows, one launch of the packing kernel,
csrc/dwt_edges.cu) and gathers every rank's into one tensor, edges [sp, N,
E, W] (`gather`: all_gather_into_tensor on NCCL; on gloo through the host
and one upload), and the level kernel reads the rows of the globally
extended signal just outside its shard from there itself, so a shard of 2
rows, shorter than the 9/7 lifting's reach of 4 rows, still lifts exactly
as the whole tile.  Codestreams are byte-identical to the single-process
encode (and, lossless, to the JAX package's encoder.encode) whatever the
grid.

Streams that the device HT decode does not take (layered, Part-1,
SOP/EPH/PPM/PPT, HT refinement passes, absent tiles) decode per tile on
the host (decoder.tile_pyramids: Python Tier-2 and the native block
decoder), and their leaves go through the same inverse step, as the JAX
package decodes them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..codestream import writer as cw
from ..codestream.parser import Parser
from ..models import decoder as dec
from ..models import encoder as enc
from ..models import fused_encode, transforms
from ..models import rate as rate_mod
from ..native import loader
from ..ops import band_stats, dwt, dwt_cuda, ht_dec_cuda, quant
from ..options import Config, default_options
from ..tcd import geometry as geo
from ..utils import markers as mk
from ..utils.metrics import counters
from .mesh import Grid, make_grid


# ------------------------------------------------------------ collectives

def _comm_device(group) -> torch.device:
    """Where a group's collectives take their tensors: NCCL wants CUDA."""
    return torch.device("cuda" if dist.get_backend(group) == "nccl"
                        else "cpu")


def gather(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Every sp rank's `t` (equal shapes) stacked in sp order, [sp, *shape],
    on t's device: one all_gather_into_tensor on NCCL; on gloo, gathered on
    the host, then one upload."""
    shape = (grid.sp,) + tuple(t.shape)
    t = t.contiguous()
    if grid.sp == 1:
        return t.reshape(shape)
    if _comm_device(grid.sp_group).type == "cuda":
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=grid.sp_group)
        return out
    host = torch.empty(shape, dtype=t.dtype)
    dist.all_gather(list(host.unbind(0)), t.cpu(), group=grid.sp_group)
    return host.to(t.device)


class GroupComm:
    """allreduce(vec, op) for rate.assign_layers_sharded over the dp ranks:
    this rank's local sum, max or min of vec, then one float64 all_reduce.
    Byte totals are integers and slopes are compared by max and min, so
    every rank derives the thresholds of one process (the JAX package's
    MeshComm carries integer limbs, as TPU collectives have no float64)."""

    _OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}

    def __init__(self, grid: Grid):
        self.grid = grid

    def __call__(self, vec, op: str) -> float:
        v = np.asarray(vec, np.float64)
        if op == "sum":
            local = float(v.sum())
        elif op == "max":
            local = float(v.max()) if v.size else -np.inf
        else:
            local = float(v.min()) if v.size else np.inf
        if self.grid.dp == 1:
            return local
        t = torch.tensor([local], dtype=torch.float64,
                         device=_comm_device(self.grid.dp_group))
        dist.all_reduce(t, op=getattr(dist.ReduceOp, self._OPS[op]),
                        group=self.grid.dp_group)
        return float(t.item())


# ------------------------------------------------ sharded DWT levels

def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def level_edges(src, grid: Optional[Grid]):
    """edges [sp, N, E, W] of one level of this rank's row shard: its edge
    slot (dwt_cuda.pack_edges of its rows, or of its bands for an inverse
    level; one launch on the card) gathered over the sp ranks.  None on a
    grid without row shards."""
    if grid is None or grid.sp == 1:
        return None
    return gather(dwt_cuda.pack_edges(src), grid)


def _forward_level(x: torch.Tensor, kind: str, edges, rank: int):
    return transforms.forward_level(x, kind, 0, 0, edges, rank)


def _inverse_level(bands, kind: str, edges, rank: int):
    return transforms.inverse_level(bands, kind, 0, 0, edges, rank)


def _rank(grid: Optional[Grid]) -> int:
    return 0 if grid is None else grid.sp_rank


def dwt_multilevel_sharded(x: torch.Tensor, levels: int, kind: str,
                           grid: Optional[Grid] = None
                           ) -> List[Dict[str, torch.Tensor]]:
    """Row shard x [N, C, h, W] of tiles whose origins are divisible by
    2^levels -> its pyramid, leaves [N, C, h/2^l, ...] contiguous (levels
    ascending, LL with the last).  Each level gathers every sp rank's edge
    rows (level_edges) and runs the level kernel on them."""
    lead = tuple(x.shape[:2])
    cur = _flat(x)
    out = []
    for lev in range(1, levels + 1):
        bands = _forward_level(cur, kind, level_edges(cur, grid), _rank(grid))
        entry = {k: bands[k].contiguous().reshape(
            lead + tuple(bands[k].shape[-2:])) for k in ("HL", "LH", "HH")}
        cur = bands["LL"].contiguous()
        if lev == levels:
            entry["LL"] = cur.reshape(lead + tuple(cur.shape[-2:]))
        out.append(entry)
    return out


def idwt_multilevel_sharded(pyr: List[Dict[str, torch.Tensor]], kind: str,
                            grid: Optional[Grid] = None) -> torch.Tensor:
    """Inverse of dwt_multilevel_sharded: the pyramid of a row shard ->
    its rows [N, C, h, W]."""
    lead = tuple(pyr[-1]["LL"].shape[:2])
    cur = _flat(pyr[-1]["LL"])
    for lev in range(len(pyr), 0, -1):
        bands = {k: _flat(pyr[lev - 1][k]) for k in ("HL", "LH", "HH")}
        bands["LL"] = cur
        cur = _inverse_level(bands, kind, level_edges(bands, grid),
                             _rank(grid))
    return cur.reshape(lead + tuple(cur.shape[-2:]))


def _split_edges(srcs: Sequence, pack) -> torch.Tensor:
    """edges [sp, N, E, W] of consecutive row shards in one process: each
    shard's slot packed in place (`pack`: dwt_cuda.pack_edges, or
    dwt.pack_edges, the plain version), standing in for the gather."""
    pairs = isinstance(srcs[0], dict)
    first = srcs[0]["LL"] if pairs else srcs[0]
    n, h, w = first.shape
    if pairs:
        h, w = 2 * h, w + srcs[0]["HL"].shape[-1]
    edges = first.new_empty((len(srcs), n, dwt.edge_count(h), w))
    for r, src in enumerate(srcs):
        pack(src, out=edges[r])
    return edges


def forward_level_split(shards: Sequence[torch.Tensor], kind: str,
                        level=_forward_level, pack=dwt_cuda.pack_edges
                        ) -> List[Dict[str, torch.Tensor]]:
    """One forward level of consecutive row shards [N, h, W] of one signal,
    in one process: each shard on the edges the gather would give it (how
    the halo kernels are held to the unsharded ones on one card).  `level`
    may be dwt.forward_2d_halo and `pack` dwt.pack_edges, the plain
    versions."""
    edges = _split_edges(shards, pack)
    return [level(s, kind, edges, r) for r, s in enumerate(shards)]


def inverse_level_split(bands: Sequence[Dict[str, torch.Tensor]], kind: str,
                        level=_inverse_level, pack=dwt_cuda.pack_edges
                        ) -> List[torch.Tensor]:
    """One inverse level of consecutive row shards' bands, in one process
    (forward_level_split's inverse; `level` may be dwt.inverse_2d_halo and
    `pack` dwt.pack_edges)."""
    edges = _split_edges(bands, pack)
    return [level(b, kind, edges, r) for r, b in enumerate(bands)]


# ------------------------------------------------------- transform steps

def tile_transform_step(batch: torch.Tensor, levels: int, use_mct: bool,
                        precision: int, signed: bool, kind: str,
                        grid: Optional[Grid] = None):
    """This rank's row shard of its tiles, samples [n, C, th/sp, tw] as
    transforms.upload ships them -> (pyramid leaves [n, C, h, w], band
    statistics float32 [L, 2]): DC shift, RCT or ICT (on the card one
    launch of mct_forward), the sharded DWT, then per leaf (levels
    ascending; HL, LH, HH, LL) the sum of squares and the nonzero count
    over the whole grid."""
    x = transforms.coefficients(batch, kind, use_mct, precision, signed)
    pyr = dwt_multilevel_sharded(x, levels, kind, grid)
    sums, counts = band_stats.band_stats(band_stats.leaves_of(pyr))
    if grid is not None and grid.size > 1:
        dev = _comm_device(grid.group)
        sums, counts = sums.to(dev), counts.to(dev)
        dist.all_reduce(sums, group=grid.group)
        dist.all_reduce(counts, group=grid.group)
    stats = torch.stack([sums.to(torch.float32), counts.to(torch.float32)],
                        dim=1)
    return pyr, stats


def tile_inverse_step(pyr: List[Dict[str, torch.Tensor]], use_mct: bool,
                      precision: int, signed: bool, kind: str,
                      grid: Optional[Grid] = None) -> torch.Tensor:
    """Pyramid leaves of this rank's row shard (int32, or float32
    dequantized for 9/7) -> its samples [n, C, th/sp, tw]: the sharded
    inverse DWT, inverse RCT or ICT, rounding, DC shift, clamp and
    narrowing (transforms.samples: on the card one launch of
    mct_inverse)."""
    return transforms.samples(idwt_multilevel_sharded(pyr, kind, grid), kind,
                              use_mct, precision, signed)


# ---------------------------------------------------------------- helpers

def _check_grid(header, levels: int, sp: int, what: str):
    """The JAX package's geometry gates (ValueError): uniform tiles, tile
    origins divisible by 2^levels, tile height by sp * 2^levels, no
    subsampling.  Returns (T, th, tw)."""
    if levels < 1:
        raise ValueError(f"{what}: needs >= 1 decomposition level")
    T = header.num_tiles
    b0 = header.tile_bounds(0)
    tw, th = b0[2] - b0[0], b0[3] - b0[1]
    for t in range(T):
        tb = header.tile_bounds(t)
        if (tb[2] - tb[0], tb[3] - tb[1]) != (tw, th):
            raise ValueError(f"{what}: uniform tile grid required")
        if (tb[0] % (1 << levels)) or (tb[1] % (1 << levels)):
            raise ValueError(f"{what}: tile origins must be divisible by "
                             "2^levels")
    if th % (sp * (1 << levels)):
        raise ValueError(f"{what}: tile height must be divisible by "
                         "sp * 2^levels")
    for ci in header.components:
        if ci.dx != 1 or ci.dy != 1:
            raise ValueError(f"{what}: no subsampling")
    return T, th, tw


def _my_tiles(T: int, grid: Grid) -> List[int]:
    """The tiles of this rank's dp shard: t // ceil(T / dp) == dp_rank."""
    per = -(-T // grid.dp)
    return list(range(grid.dp_rank * per, min(T, (grid.dp_rank + 1) * per)))


def _classes(header, tiles: Sequence[int]) -> Dict[Tuple, List[int]]:
    """Positions in `tiles` grouped by tile-origin class: tiles whose
    origins agree modulo the code-block size times 2^levels (and of equal
    size) share one block plan (fused_encode.plan_for, multi_tile)."""
    cs = header.coding_style
    mx = 1 << (cs.cb_width_exp + cs.num_decompositions)
    my = 1 << (cs.cb_height_exp + cs.num_decompositions)
    out: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tiles):
        x0, y0, x1, y1 = header.tile_bounds(t)
        out.setdefault((x0 % mx, y0 % my, x1 - x0, y1 - y0), []).append(i)
    return out


def _chunks(idx: List[int], per: int):
    for s in range(0, len(idx), per):
        yield idx[s:s + per]


def _per_chunk(samples_per_tile: int, bytes_per_sample: int,
               chunk_bytes: int) -> int:
    return max(1, chunk_bytes // bytes_per_sample // samples_per_tile)


# ----------------------------------------------------------------- encode

def ht_plans(header, tiles: Sequence[int]):
    """[(block plan, a tile of the class, positions in `tiles`)] per
    tile-origin class of `tiles`, or None when a class has no HT block plan
    (several precincts a band)."""
    lossy = header.coding_style.transform == 0
    work = []
    for pos in _classes(header, tiles).values():
        rep = geo.build_tile(header, tiles[pos[0]])
        plan = fused_encode.plan_for(header, rep, ht=True, multi_tile=True,
                                     lossy=lossy)
        if plan is None:
            return None
        work.append((plan, rep, pos))
    return work


def fused_chunk_tiles(n_comps: int, th: int, tw: int) -> int:
    """Tiles per device chunk of the HT encode (FUSED_CHUNK_BYTES)."""
    return _per_chunk(n_comps * th * tw, enc.FUSED_BYTES_PER_SAMPLE,
                      enc.FUSED_CHUNK_BYTES)


def _device_ht_entropy(header, opts, pyr, tiles: List[int], levels: int,
                       th: int, tw: int, assemble
                       ) -> Optional[Dict[int, Tuple[bytes, bytes]]]:
    """(tile-part, PPM chunk) of each of `tiles` through the device HT
    encode: per tile-origin class, in chunks of FUSED_CHUNK_BYTES, the
    three HT encode kernels on the class's tiles, read in place;
    then native Tier-2, or, where opts put markers in the tile-parts
    (encoder.tile_part_markers), the natively serialized segments through
    `assemble` (the PCRD and the Python Tier-2, as the JAX package's
    sharded encode).  None when a class's geometry has no block plan."""
    work = ht_plans(header, tiles)
    if work is None:
        return None
    per = fused_chunk_tiles(header.num_components, th, tw)
    counters.add("enc.sharded_device_ht_tiles", len(tiles))
    native = not enc.tile_part_markers(opts)
    parts: Dict[int, Tuple[bytes, bytes]] = {}
    coded: Dict[int, List] = {}
    for plan, rep, pos in work:
        for sub in _chunks(pos, per):
            out, totals = fused_encode.encode_pyramid(
                pyr, plan, len(sub), levels, tiles=sub)
            if not native:
                for i, segs in zip(sub, fused_encode.fetch_segments(
                        out, totals, len(sub), plan)):
                    coded[tiles[i]] = enc.segment_results(segs)
                continue
            bodies = fused_encode.fetch_bodies(out, totals, len(sub), plan,
                                               header, rep)
            for i, body in zip(sub, bodies):
                parts[tiles[i]] = (cw.write_sot(tiles[i], 12 + 2 + len(body),
                                                0, 1) + cw.write_sod() + body,
                                   b"")
    if native:
        return parts
    return assemble([(t, coded[t]) for t in tiles])


def _quantized(pyr, tile: geo.Tile, levels: int):
    """Lossy leaves -> deadzone quantizer indices, each band with its step
    (component 0's: under the ICT the components share one quantizer)."""
    deltas = iter(enc._leaf_deltas(tile, levels))
    return [{k: quant.quantize(e[k], next(deltas)) for k in sorted(e)}
            for e in pyr]


def _host_entropy(header, opts, pyr, tiles: List[int], levels: int,
                  num_layers: int, rate_budget, assemble
                  ) -> Dict[int, Tuple[bytes, bytes]]:
    """(tile-part, PPM chunk) of each of `tiles` through the host branch:
    the block coder of opts.backend per tile (HT with refinement passes
    where layers or a budget use them, or Part-1 with its code-block
    style), then `assemble`."""
    counters.add("enc.sharded_host_entropy_tiles", len(tiles))
    geoms = [geo.build_tile(header, t) for t in tiles]
    if header.coding_style.transform == 0 and tiles:
        pyr = _quantized(pyr, geoms[0], levels)
    host = [{k: v.cpu().numpy() for k, v in e.items()} for e in pyr]
    coded = []
    for i, (t, tile) in enumerate(zip(tiles, geoms)):
        pyramids = [{k: v[i] for k, v in e.items()} for e in host]
        _state, _slots, block_jobs = enc._entropy_jobs(tile, pyramids)
        coded.append((t, enc._code_blocks(block_jobs, opts, num_layers,
                                          rate_budget)))
    return assemble(coded)


def _assembler(header, opts, num_layers: int, rate_budget, main: bytes,
               grid: Grid, n_comps: int):
    """The tail both entropy branches share: [(tile, its blocks' coder
    results in canonical job order)] -> the distributed PCRD and Tier-2,
    each dp shard assembling its own tiles against the global byte count
    -> {tile: (tile-part, PPM chunk)}."""
    cw_mct = enc.mct_comp_weights(header, opts.lossless, n_comps)
    comm = GroupComm(grid)
    size_reduce = None
    if grid.dp > 1:
        size_reduce = lambda local: comm(np.asarray([float(local)]), "sum")

    def assemble(coded) -> Dict[int, Tuple[bytes, bytes]]:
        blocks, weights, states = [], [], []
        for t, results in coded:
            tile = geo.build_tile(header, t)
            enc_state, job_slots = enc._walk_geometry(tile)
            b, w = enc._build_blocks(job_slots, results, num_layers,
                                     opts.lossless, cw_mct)
            blocks += b
            weights += w
            states.append((tile, enc_state))
        tiles = [t for t, _ in coded]
        tile_parts, ppm_chunks = enc._assemble_with_budget(
            header, opts, states, blocks, num_layers, rate_budget, main,
            lambda target: rate_mod.assign_layers_sharded(
                [blocks], [weights], num_layers, target, allreduce=comm),
            size_reduce=size_reduce, tile_ids=tiles)
        return dict(zip(tiles, zip(tile_parts, ppm_chunks)))

    return assemble


def tile_batch(header, comps: Sequence[np.ndarray], tiles: Sequence[int],
               rows: int, r0: int) -> np.ndarray:
    """Rows r0 .. r0+rows of each of `tiles` [n, C, rows, tw], in the
    image's dtype."""
    b0 = header.tile_bounds(0)
    tw = b0[2] - b0[0]
    batch = np.empty((len(tiles), len(comps), rows, tw), comps[0].dtype)
    for i, t in enumerate(tiles):
        tx0, ty0, _tx1, _ty1 = header.tile_bounds(t)
        y0 = ty0 - header.y_offset + r0
        x0 = tx0 - header.x_offset
        for c, plane in enumerate(comps):
            batch[i, c] = plane[y0:y0 + rows, x0:x0 + tw]
    return batch


def _gather_rows(pyr, grid: Grid):
    """Whole leaves from every sp rank's row shards."""
    if grid.sp == 1:
        return pyr
    return [{k: torch.cat(tuple(gather(v, grid)), dim=-2)
             for k, v in e.items()} for e in pyr]


def encode_sharded(image, opts=None, grid: Optional[Grid] = None,
                   device="cuda") -> bytes:
    """Encode a multi-tile image to a J2K codestream or a JP2 file on a
    (dp, sp) grid of ranks (parallel/mesh.py; default: this process
    alone), with the device work on `device` ("cuda" without a card
    raises).  Every rank returns the same codestream, byte-identical to the
    single-process encode on lossless input.  It takes what
    encoder.encode takes: markers (SOP, EPH, PLT, PPT, PPM, TLM, POC),
    code-block styles, backend "python", signed and wide samples and any
    number of components.

    Single-layer HTJ2K without a budget takes the device HT entropy
    (counted in enc.sharded_device_ht_tiles), with native Tier-2, or, with
    markers in the tile-parts, the Python Tier-2 on its segments; layers,
    byte budgets, Part-1 and backend "python" the host entropy branch
    (enc.sharded_host_entropy_tiles).

    Gates: ValueError as the JAX package's (no subsampling, >= 1
    decomposition level, a uniform tile grid with tile heights divisible by
    sp * 2^levels and tile origins by 2^levels), and encoder.check_precision's
    sample widths."""
    opts = opts or default_options()
    dev = transforms.resolve_device(device)
    grid = grid or make_grid()
    image = np.asarray(image)
    if opts.num_resolutions < 2:
        raise ValueError("encode_sharded: needs >= 1 decomposition level")
    comps = enc._image_components(image)
    header, main = enc.header_and_main(image, opts)
    precision = header.components[0].precision
    signed = header.components[0].signed
    n_comps = len(comps)
    levels = header.coding_style.num_decompositions
    T, th, tw = _check_grid(header, levels, grid.sp, "encode_sharded")

    # this rank's tiles, its rows of each, shipped narrow
    tiles = _my_tiles(T, grid)
    rows = th // grid.sp
    batch = tile_batch(header, comps, tiles, rows, grid.sp_rank * rows)
    use_mct = bool(header.coding_style.mct) and n_comps >= 3
    kind = dwt.REV53 if header.coding_style.transform == 1 else dwt.IRR97
    pyr, _stats = tile_transform_step(transforms.upload(batch, dev), levels,
                                      use_mct, precision, signed, kind, grid)
    # the statistics are the step's output, as in the JAX package; no
    # stage of the encode reads them
    pyr = _gather_rows(pyr, grid)

    num_layers = header.coding_style.num_layers
    rate_budget = rate_mod.byte_budget(image, opts)
    assemble = _assembler(header, opts, num_layers, rate_budget, main, grid,
                          n_comps)
    parts = None
    if (opts.high_throughput and not enc.effective_ht_refinement(opts)
            and num_layers == 1 and rate_budget is None
            and opts.backend != "python"):
        parts = _device_ht_entropy(header, opts, pyr, tiles, levels, th, tw,
                                   assemble)
    if parts is None:
        parts = _host_entropy(header, opts, pyr, tiles, levels, num_layers,
                              rate_budget, assemble)
    del pyr
    if grid.dp > 1:
        # every dp shard's tile-parts (NCCL: on this rank's current card)
        shards = [None] * grid.dp
        dist.all_gather_object(shards, parts, group=grid.dp_group)
        parts = {t: tp for shard in shards for t, tp in shard.items()}
    return enc._finalize_codestream(header, opts, main,
                                    [parts[t][0] for t in range(T)],
                                    [parts[t][1] for t in range(T)],
                                    int(image.size))


# ----------------------------------------------------------------- decode

def _device_ht_decode(header, parts_by_tile, codestream, tiles: List[int],
                      th: int, tw: int, dev: torch.device):
    """Pyramid leaves [n, C, h, w] of `tiles` (int32, or float32
    dequantized for 9/7) on dev: per tile-origin class, in chunks of
    DECODE_CHUNK_BYTES, the native Tier-2 and MEL/VLC parse, then the MagSgn
    and assembly kernels, scattered into one leaf per band.  None where the
    stream is not one the device HT decode takes (the JAX package's
    _device_ht_decode conditions: HTJ2K, one layer, no SOP/EPH/PPM/PPT,
    every tile present), a class has no block plan or the native parse
    refuses a tile (HT refinement passes): the host tile decode takes
    those streams."""
    cs = header.coding_style
    if not (cs.cb_style & mk.CBSTYLE_HT and cs.num_layers == 1
            and not (cs.has_sop or cs.has_eph or header.ppm)
            and not any(tp.packed_headers for parts in parts_by_tile.values()
                        for tp in parts)
            and all(t in parts_by_tile
                    for t in range(header.num_tiles))):
        return None
    levels = cs.num_decompositions
    n_comps = header.num_components
    lossy = cs.transform == 0
    work = ht_plans(header, tiles)
    if work is None:
        return None
    leaves = empty_leaves(len(tiles), n_comps, th, tw, levels, lossy, dev)
    for plan, rep, pos in work:
        geom = fused_encode.t2_geom(header, rep, plan)
        for sub in _chunks(pos, decode_chunk_tiles(n_comps, th, tw)):
            parsed = parse_tiles(header, parts_by_tile, codestream, plan,
                                 geom, [tiles[i] for i in sub])
            if parsed is None:
                return None
            place_tiles(leaves, dec.upload_parsed(*parsed, dev), plan, sub,
                        n_comps, levels, lossy)
    counters.add("dec.sharded_device_ht_tiles", len(tiles))
    return leaves


def _host_decode(header, parts_by_tile, codestream, tiles: List[int],
                 th: int, tw: int, dev: torch.device, config: Config):
    """Pyramid leaves [n, C, h, w] of `tiles` on dev through the host tile
    decode (decoder.tile_pyramids: the Python Tier-2 and the native block
    decoder, 9/7 bands dequantized, the Config's quality layers), as the
    JAX package's decode_sharded decodes what its device branch refuses; a
    tile absent from the stream keeps zero leaves."""
    cs = header.coding_style
    levels = cs.num_decompositions
    leaves = empty_leaves(len(tiles), header.num_components, th, tw, levels,
                          cs.transform == 0, dev)
    for i, t in enumerate(tiles):
        if t not in parts_by_tile:
            continue
        pyrs = dec.tile_pyramids(header, geo.build_tile(header, t),
                                 parts_by_tile[t], codestream, config)
        for lev, entry in enumerate(leaves):
            for k, leaf in entry.items():
                leaf[i] = torch.from_numpy(np.stack(
                    [p[lev][k] for p in pyrs])).to(dev)
    counters.add("dec.sharded_host_tiles", len(tiles))
    return leaves


def empty_leaves(n: int, n_comps: int, th: int, tw: int, levels: int,
                 lossy: bool, dev: torch.device):
    """Zeroed pyramid leaves [n, C, h, w] of n tiles, float32 (9/7) or
    int32, for place_tiles to fill."""
    dtype = torch.float32 if lossy else torch.int32
    return [{k: torch.zeros((n, n_comps) + shape, dtype=dtype, device=dev)
             for k, shape in e.items()}
            for e in dwt.subband_shapes(th, tw, levels)]


def decode_chunk_tiles(n_comps: int, th: int, tw: int) -> int:
    """Tiles per device chunk of the HT decode (DECODE_CHUNK_BYTES)."""
    return _per_chunk(n_comps * th * tw, dec.DECODE_BYTES_PER_SAMPLE,
                      dec.DECODE_CHUNK_BYTES)


def parse_tiles(header, parts_by_tile, codestream, plan, geom,
                tiles: Sequence[int]):
    """The host's control phase (native Tier-2 and MEL/VLC parse) of some
    tiles of one class: (quad words, MagSgn pool, block word offsets), or
    None where it refuses a tile (HT refinement passes, truncated data)."""
    datas = [b"".join(codestream[tp.data_start:tp.data_end]
                      for tp in parts_by_tile[t]) for t in tiles]
    frame_off = np.zeros(len(datas) + 1, np.int64)
    np.cumsum([len(d) for d in datas], out=frame_off[1:])
    parsed = loader.ht_t2_parse_frames(
        np.frombuffer(b"".join(datas), dtype=np.uint8), frame_off,
        len(tiles), plan.nb, geom, geom["mb"], plan.ws, plan.hs, plan.cbh,
        plan.cbw)
    return None if parsed is None else parsed[:3]


def place_tiles(leaves, uploaded, plan, sub: Sequence[int], n_comps: int,
                levels: int, lossy: bool) -> None:
    """The MagSgn and assembly kernels on one chunk's parse, and its tiles
    scattered into the leaves at positions `sub`."""
    qinfo, pool, woff = uploaded
    blocks = ht_dec_cuda.magsgn_decode_blocks(qinfo, pool, woff, plan.cbh,
                                              plan.cbw)
    got = ht_dec_cuda.blocks_to_pyramid(blocks, plan, len(sub), n_comps,
                                        levels, dequant=lossy)
    del blocks
    idx = torch.tensor(list(sub), device=qinfo.device)
    for lev, entry in enumerate(got):
        for k, v in entry.items():
            leaves[lev][k].index_copy_(0, idx, v)


def decode_sharded(data: bytes, config: Optional[Config] = None,
                   grid: Optional[Grid] = None, device="cuda") -> np.ndarray:
    """Decode a multi-tile codestream on a (dp, sp) grid of ranks (default:
    this process alone), with the device work on `device`.  Each dp shard
    decodes its own tiles, then runs the sharded inverse over its sp ranks,
    and every rank returns the whole image, of decoder.image_dtype.
    Single-layer HTJ2K streams with every tile present, decoded whole,
    take the device HT decode (dec.sharded_device_ht_tiles); the rest
    (Part-1, quality layers in the stream or in the Config, SOP/EPH/PPM/PPT,
    HT refinement passes, absent tiles, which stay zero) the host tile
    decode (dec.sharded_host_tiles), as in the JAX package.

    Gates: ValueError as the JAX package's (full-resolution whole decodes
    only, >= 1 decomposition level, the encode's tile grid rules, no
    subsampling)."""
    config = config or Config()
    dev = transforms.resolve_device(device)
    grid = grid or make_grid()
    if config.reduce_resolution or config.decode_area is not None:
        raise ValueError("decode_sharded: full-resolution full-frame "
                         "decodes only")
    _fmt, codestream, _jp2 = dec.sniff_format(data)
    parser = Parser(codestream)
    header = parser.read_header()
    tile_parts = parser.read_all_tile_parts(header)
    cs = header.coding_style
    levels = cs.num_decompositions
    T, th, tw = _check_grid(header, levels, grid.sp, "decode_sharded")
    parts_by_tile: Dict[int, list] = {}
    for tp in tile_parts:
        parts_by_tile.setdefault(tp.tile_index, []).append(tp)
    if not parts_by_tile:
        raise dec.DecodeError("decode_sharded: codestream has no tile-parts")
    n_comps = header.num_components
    precision = header.components[0].precision
    signed = header.components[0].signed
    use_mct = bool(cs.mct) and n_comps >= 3
    kind = dwt.REV53 if cs.transform == 1 else dwt.IRR97

    tiles = _my_tiles(T, grid)
    leaves = None
    if not config.quality_layers:
        leaves = _device_ht_decode(header, parts_by_tile, codestream, tiles,
                                   th, tw, dev)
    if leaves is None:
        leaves = _host_decode(header, parts_by_tile, codestream, tiles, th,
                              tw, dev, config)
    if grid.sp > 1:
        s, sp = grid.sp_rank, grid.sp
        leaves = [{k: v[:, :, s * v.shape[2] // sp:(s + 1) * v.shape[2] // sp]
                   for k, v in e.items()} for e in leaves]
    pix = tile_inverse_step(leaves, use_mct, precision, signed, kind, grid)
    del leaves
    rows = th // grid.sp
    per = -(-T // grid.dp)
    dt = dec.image_dtype(precision, signed)
    if grid.size > 1:
        # every rank's row shards of its tiles, padded to ceil(T / dp)
        # tiles, gathered as bytes (gloo has no int16)
        mine = torch.zeros((per,) + tuple(pix.shape[1:]), dtype=pix.dtype,
                           device=_comm_device(grid.group))
        mine[:pix.shape[0]] = pix
        mine = mine.view(torch.uint8)
        pieces = [torch.empty_like(mine) for _ in range(grid.size)]
        dist.all_gather(pieces, mine, group=grid.group)
        pieces = [p.cpu().numpy() for p in pieces]
    else:
        pieces = [pix.cpu().numpy()]
    planes = np.zeros((n_comps, header.height - header.y_offset,
                       header.width - header.x_offset), dt)
    for r, piece in enumerate(pieces):
        d, s = divmod(r, grid.sp)
        piece = piece.view(dt)
        for i, t in enumerate(range(d * per, min(T, (d + 1) * per))):
            if t not in parts_by_tile:
                continue    # an absent tile stays zero, as in decode
            tx0, ty0, _tx1, _ty1 = header.tile_bounds(t)
            y0 = ty0 - header.y_offset + s * rows
            x0 = tx0 - header.x_offset
            planes[:, y0:y0 + rows, x0:x0 + tw] = piece[i]
    counters.add("dec.bytes_in", len(data))
    counters.add("dec.pixels_out", int(planes.size))
    return planes[0] if n_comps == 1 else np.moveaxis(planes, 0, -1)
