"""The code-block slot layout of a block plan, as the two layout kernels
read it (csrc/block_layout.cuh): ht_extract_blocks (pyramid leaves -> block
slots, ops/ht_enc_cuda.py) and ht_blocks_to_pyramid (slots -> leaves,
ops/ht_dec_cuda.py).

A plan's leaves are the pyramid's [n, C, bh, bw] tensors, one per (level,
band); its slots are int32 [n, nb, cbh, cbw].  Everything here is per
frame and depends on the plan alone, so the wrappers build it once per
plan and keep it on the card:
- `slot_descriptors`: one row of LAYOUT_FIELDS int32 per slot (leaf, valid
  rows and columns, leaf row length, the slot's first sample in one frame
  of its leaf, the leaf's elements per frame, quantizer step);
- `row_descriptors`: one row per leaf row of a frame (leaf, row length,
  the row in one frame of its leaf, the leaf's elements per frame, the
  slot of its first grid cell, its row in that slot, the grid offset ox
  and log2 of the cell width, quantizer step).
First-row and first-column cells of an offset grid hold their samples from
the slot's top-left corner (fused_encode.extract_blocks' roll).

`layout_stress_cases`, `stress_inputs` and `stress_leaves` give the plans
and inputs that the CPU models of both kernels
(tests/test_torch_block_layout.py), the card tests and chip_smoke.py hold
them to.  `plan_cache` keeps per-plan state keyed so that a freed plan
cannot alias a new one.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

# LAYOUT_FIELDS and MAX_LEAVES of csrc/block_layout.cuh (the wrappers check
# them against the libraries)
LAYOUT_FIELDS = 8
MAX_LEAVES = 97


def plan_cache(cache: Dict, plan, rest: Tuple, build: Callable):
    """cache[(id(plan),) + rest], built by build() on a miss.  The entry
    holds the plan itself, so the plan lives as long as the entry and its
    id cannot be reused by another plan while the key is in the cache."""
    key = (id(plan),) + rest
    hit = cache.get(key)
    if hit is None or hit[0] is not plan:
        hit = cache[key] = (plan, build())
    return hit[1]


def leaf_level(lev: int, name: str, nl: int) -> int:
    """Pyramid list index of a plan band (LL sits with the top level)."""
    if name == "LL":
        return nl - 1 if nl > 0 else 0
    return lev - 1


def _log2(v: int) -> int:
    s = int(v).bit_length() - 1
    return s if v > 0 and 1 << s == v else -1


def leaves(plan, n_comps: int, nl: int):
    """The plan's distinct leaves: ([(pyramid level, band)], [(bh, bw)],
    leaf index of each band spec).  Raises ValueError where a spec does
    not fit its leaf or the slots, where a leaf lacks a component, or past
    MAX_LEAVES leaves."""
    where: Dict = {}
    shapes: List[Tuple[int, int]] = []
    comps: List[set] = []
    of_spec = []
    for spec in plan.band_specs:
        c, lev, band, gy, gx, eh, ew, bh, bw, oy, ox = spec
        key = (leaf_level(lev, band, nl), band)
        if key not in where:
            where[key] = len(shapes)
            shapes.append((bh, bw))
            comps.append(set())
        li = where[key]
        if (shapes[li] != (bh, bw) or not 0 <= c < n_comps
                or _log2(eh) < 0 or _log2(ew) < 0 or eh > plan.cbh
                or ew > plan.cbw or not (0 <= oy < eh and 0 <= ox < ew)
                or gy != -(-(bh + oy) // eh) or gx != -(-(bw + ox) // ew)
                or n_comps * bh * bw >= 1 << 31):
            raise ValueError(f"block layout: band {spec} does not fit its "
                             f"leaf {shapes[li]} or {plan.cbh}x{plan.cbw} "
                             f"slots")
        comps[li].add(c)
        of_spec.append(li)
    if any(len(s) != n_comps for s in comps):
        raise ValueError(f"block layout: the plan's bands do not cover "
                         f"{n_comps} components")
    if len(shapes) > MAX_LEAVES:
        raise ValueError(f"block layout: {len(shapes)} leaves, at most "
                         f"{MAX_LEAVES} a launch")
    if _log2(plan.cbh) < 2 or _log2(plan.cbw) < 2:
        raise ValueError(f"block layout: {plan.cbh}x{plan.cbw} slots")
    return list(where), shapes, of_spec


def _delta_bits(plan, bi: int, lossy: bool) -> int:
    return int(np.float32(plan.deltas[bi] if lossy else 1.0).view(np.int32))


def slot_descriptors(plan, n_comps: int, nl: int, lossy: bool):
    """([(level, band)] of the leaves, [(bh, bw)], int32 [nb,
    LAYOUT_FIELDS]): per slot its leaf, valid rows and columns, the leaf's
    bw, the element offset of its first sample in one frame of the leaf,
    the leaf's elements per frame and the quantizer step's float32 bits
    (lossy; else 1.0)."""
    keys, shapes, of_spec = leaves(plan, n_comps, nl)
    desc = np.zeros((plan.nb, LAYOUT_FIELDS), np.int64)
    slot = 0
    for bi, (spec, li) in enumerate(zip(plan.band_specs, of_spec)):
        c, _lev, _band, gy, gx, eh, ew, bh, bw, oy, ox = spec
        k = np.arange(gy * gx)
        yy, xx = k // gx, k % gx
        y0 = np.where(yy == 0, 0, yy * eh - oy)
        x0 = np.where(xx == 0, 0, xx * ew - ox)
        rows = np.minimum(np.where(yy == 0, eh - oy, eh), bh - y0)
        cols = np.minimum(np.where(xx == 0, ew - ox, ew), bw - x0)
        d = desc[slot:slot + gy * gx]
        d[:, 0] = li
        d[:, 1], d[:, 2], d[:, 3] = rows, cols, bw
        d[:, 4] = (c * bh + y0) * bw + x0
        d[:, 5] = n_comps * bh * bw
        d[:, 6] = _delta_bits(plan, bi, lossy)
        slot += gy * gx
    if slot != plan.nb:
        raise ValueError(f"block layout: {slot} slots for a plan of "
                         f"{plan.nb}")
    return keys, shapes, desc.astype(np.int32)


def row_descriptors(plan, n_comps: int, nl: int, dequant: bool):
    """([(level, band)] of the leaves, [(bh, bw)], int32 [rows,
    LAYOUT_FIELDS]): per leaf row of a frame (band specs in order, rows
    top down) its leaf, bw, the element offset of the row in one frame of
    the leaf, the leaf's elements per frame, the slot of the row's first
    grid cell within a frame, the row's word offset in that slot, ox |
    log2(ew) << 16, and the quantizer step's float32 bits (dequant; else
    1.0)."""
    keys, shapes, of_spec = leaves(plan, n_comps, nl)
    out = []
    slot = 0
    for bi, (spec, li) in enumerate(zip(plan.band_specs, of_spec)):
        c, _lev, _band, gy, gx, eh, ew, bh, bw, oy, ox = spec
        ys = np.arange(bh) + oy
        yy = ys // eh
        r = ys % eh - np.where(yy == 0, oy, 0)
        d = np.zeros((bh, LAYOUT_FIELDS), np.int64)
        d[:, 0], d[:, 1] = li, bw
        d[:, 2] = (c * bh + np.arange(bh)) * bw
        d[:, 3] = n_comps * bh * bw
        d[:, 4] = slot + yy * gx
        d[:, 5] = r * plan.cbw
        d[:, 6] = ox | _log2(ew) << 16
        d[:, 7] = _delta_bits(plan, bi, dequant)
        out.append(d)
        slot += gy * gx
    if slot != plan.nb:
        raise ValueError(f"block layout: {slot} slots for a plan of "
                         f"{plan.nb}")
    return keys, shapes, np.concatenate(out).astype(np.int32)


def leaf_offsets(shapes, n: int, n_comps: int) -> Tuple[np.ndarray, int]:
    """Element offsets of n-frame leaves [n, C, bh, bw] in one buffer, each
    on a 16-byte boundary (a multiple of 4 elements), and the buffer's
    length."""
    off = np.zeros(len(shapes), np.int64)
    total = 0
    for i, (bh, bw) in enumerate(shapes):
        off[i] = total
        total += -(-n * n_comps * bh * bw // 4) * 4
    return off, total


def layout_stress_cases() -> List[Tuple]:
    """Plans at the layout kernels' edges: [(name, plan, n, n_comps,
    levels)]: the HT gray plan of the smoke's main path (512x512, 64x64
    blocks, 5 levels); a lossy RGB plan with its deltas; multi-tile plans
    of a tile whose offset grids have oy and ox off multiples of 4 (and
    odd band widths), lossless gray and lossy RGB; a 1000-wide frame (bands
    500, 250, 125 and 63 wide); 32x32 blocks; a non-square 64x16 (height x
    width) block, lossy; n = 1 and n = 3."""
    from .. import options
    from ..models import encoder, fused_encode
    from ..tcd import geometry as geo

    def case(name, shape, lossless, res, n, tile=(0, 0), cb=(6, 6)):
        img = np.zeros(shape, np.uint8)
        opts = options.Options(
            format=options.Format.J2K, lossless=lossless, quality=85,
            num_resolutions=res, high_throughput=True, tile_size=tile,
            code_block_size=cb)
        header = encoder.build_header(img, opts)
        nc = header.num_components
        encoder._apply_comp_quants(header, opts, nc,
                                   header.components[0].precision)
        tile_ = geo.build_tile(header, header.num_tiles - 1)
        plan = fused_encode.plan_blocks(header, tile_,
                                        multi_tile=header.num_tiles > 1,
                                        lossy=not lossless)
        if plan is None:
            raise AssertionError(f"layout stress case {name}: no plan")
        return (name, plan, n, nc, res - 1)

    return [
        case("gray", (512, 512), True, 6, 3),
        case("lossy_rgb", (128, 160, 3), False, 6, 1),
        # the last tile sits at (300, 276): grid offsets (22, 10) at level
        # 1, (11, 5) at level 2; bands 130 and 65 wide
        case("tiles", (520, 560), True, 3, 3, tile=(300, 276)),
        case("tiles_lossy_rgb", (520, 560, 3), False, 3, 1,
             tile=(300, 276)),
        case("odd_width", (24, 1000), True, 5, 1),
        # code_block_size is log2 (width, height)
        case("cb32", (200, 136), True, 6, 3, cb=(5, 5)),
        case("cb64x16", (160, 120), False, 6, 3, cb=(4, 6)),
    ]


def stress_inputs(plan, n: int, n_comps: int, levels: int, seed: int = 0):
    """Inputs of both layout kernels for a plan, made from a seed: (pyramid
    [{band: leaf [n, C, bh, bw]}] of numpy leaves, float32 where the plan
    is lossy (values of both signs, zeros and -0.0) else int32, and int32
    slots [n * nb, cbh, cbw] (both signs, zeros))."""
    rng = np.random.RandomState(seed)
    keys, shapes, _ = leaves(plan, n_comps, levels)
    pyr: List[Dict[str, np.ndarray]] = [dict()
                                        for _ in range(max(1, levels))]
    for (lv, band), (bh, bw) in zip(keys, shapes):
        shape = (n, n_comps, bh, bw)
        if plan.deltas is not None:
            a = (rng.standard_normal(shape) * 300).astype(np.float32)
            a[rng.rand(*shape) < 0.1] = 0.0
            a[rng.rand(*shape) < 0.05] = -0.0
        else:
            a = rng.randint(-1 << 20, 1 << 20, shape).astype(np.int32)
            a[rng.rand(*shape) < 0.1] = 0
        pyr[lv][band] = a
    slots = rng.randint(-1 << 20, 1 << 20,
                        (n * plan.nb, plan.cbh, plan.cbw)).astype(np.int32)
    slots[rng.rand(*slots.shape) < 0.1] = 0
    return pyr, slots


def stress_leaves(pyr, dev, phase=0):
    """A numpy pyramid (stress_inputs) as torch leaves on `dev`, each
    `phase` words past the start of its own buffer (0, 1, 2 or 3: off a
    16-byte boundary where phase is not 0), or with phase "strided" each a
    strided view of a wider tensor (the extraction's wrapper copies it)."""
    import torch
    out = []
    for entry in pyr:
        tentry = {}
        for band, a in entry.items():
            host = torch.from_numpy(a)
            if phase == "strided":
                wide = torch.zeros(a.shape[:-1] + (a.shape[-1] + 3,),
                                   dtype=host.dtype, device=dev)
                leaf = wide[..., 1:1 + a.shape[-1]]
            else:
                buf = torch.empty(a.size + 4, dtype=host.dtype, device=dev)
                leaf = buf[phase:phase + a.size].view(a.shape)
            leaf.copy_(host)
            tentry[band] = leaf
        out.append(tentry)
    return out
