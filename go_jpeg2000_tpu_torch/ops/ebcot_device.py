"""Data-parallel EBCOT Tier-1 decisions: the plain torch version.

Port of go_jpeg2000_tpu/ops/ebcot_device.py.  For a batch of code-blocks it
computes every MQ decision (context, bit) of the EBCOT Tier-1 coder
(cb_style 0: no bypass, reset, termall, vertical causality or segmentation
symbols) as vector ops over whole [B, H, W] batches, with no serial walk:

* whether a neighbour was visited before a sample in the stripe scan is
  static given the row within the stripe r = y & 3, so a neighbour's state
  at visit time is its state entering the pass, or'ed with "became
  significant in this pass and visited before";
* significance-propagation (SPP) membership is the least fixpoint of a
  monotone map, iterated over the whole batch until nothing changes (the
  iteration count is the longest propagation chain);
* magnitude-refinement (MRP) membership and the cleanup (CUP) pass,
  run-length mode included, are closed-form.

The output is one uint8 slot per potential decision, 0xFF where there is
none and ctx | bit << 5 otherwise, in the serial coder's emission order:
plane (descending), then per plane [SPP: G x W x 4 x 2 | MRP: G x W x 4 |
CUP: G x W x 11] with G = H / 4 stripes, columns inside a stripe, rows
inside a column; a CUP column is [RL, UNI1, UNI2, (ZC, SC) x 4].
Dropping the 0xFF slots of a row gives the block's exact decision stream.

ops/ebcot_cuda.py `decision_slots` runs the CUDA kernel of the same
function (csrc/ebcot_enc.cu) for a tensor on the card.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import t1 as t1_py

EMPTY = 0xFF          # slot sentinel: no decision
CTX_RL = 17
CTX_UNI = 18
# slots per column of a stripe, per plane: SPP 4 x 2, MRP 4, CUP 11
SLOTS_PER_COLUMN = 23

# neighbour offsets (dy, dx)
_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def slots_per_plane(h: int, w: int) -> int:
    """Slots of one bitplane of an [h, w] block (h a multiple of 4)."""
    return (h // 4) * w * SLOTS_PER_COLUMN


def _shift_to(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """[..., H, W] -> same shape; out[y, x] = a[y+dy, x+dx], False/0 pad."""
    h, w = a.shape[-2], a.shape[-1]
    out = torch.zeros_like(a)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        a[..., max(0, dy):h + min(0, dy), max(0, dx):w + min(0, dx)]
    return out


def _before_sample(dy: int, dx: int, r: torch.Tensor) -> torch.Tensor:
    """Is the (dy, dx) neighbour visited before this sample?  r = y & 3."""
    if (dy, dx) in ((-1, -1), (-1, 0), (0, -1)):
        return torch.ones_like(r, dtype=torch.bool)
    if (dy, dx) == (-1, 1):
        return r == 0
    if (dy, dx) == (1, -1):
        return r < 3
    return torch.zeros_like(r, dtype=torch.bool)          # E, S, SE


def _before_column(dy: int, dx: int, r: torch.Tensor) -> torch.Tensor:
    """Is the (dy, dx) neighbour coded before this sample's run-length
    column is evaluated?  (Same-column neighbours N at r > 0 belong to the
    column itself and do not count.)"""
    if (dy, dx) in ((-1, -1), (0, -1)):
        return torch.ones_like(r, dtype=torch.bool)
    if (dy, dx) in ((-1, 0), (-1, 1)):
        return r == 0
    if (dy, dx) == (1, -1):
        return r < 3
    return torch.zeros_like(r, dtype=torch.bool)


def _neighbor_state(static_sig, new_sig, r, before_fn
                    ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Per offset: the neighbour's significance as seen at visit time."""
    return {(dy, dx): _shift_to(static_sig, dy, dx)
            | (_shift_to(new_sig, dy, dx) & before_fn(dy, dx, r))
            for (dy, dx) in _OFFS}


def _where(cond, a, b):
    return torch.where(cond, torch.as_tensor(a, dtype=torch.int32),
                       torch.as_tensor(b, dtype=torch.int32))


def _zc_primary(h, v, d):
    """Table D.1, LL/LH rule (horizontal primary)."""
    return _where(
        h == 2, 8,
        _where(h == 1, _where(v >= 1, 7, _where(d >= 1, 6, 5)),
               _where(v == 2, 4,
                      _where(v == 1, 3,
                             _where(d >= 2, 2, _where(d == 1, 1, 0))))))


def _zc_hh(h, v, d):
    hv = h + v
    return _where(
        d >= 3, 8,
        _where(d == 2, _where(hv >= 1, 7, 6),
               _where(d == 1, _where(hv >= 2, 5, _where(hv == 1, 4, 3)),
                      _where(hv >= 2, 2, _where(hv == 1, 1, 0)))))


def _zc_ctx(nb, band_class):
    """nb: per-offset bool visit state; band_class [B, 1, 1] int32."""
    def i32(a):
        return a.to(torch.int32)
    h = i32(nb[(0, -1)]) + i32(nb[(0, 1)])
    v = i32(nb[(-1, 0)]) + i32(nb[(1, 0)])
    d = (i32(nb[(-1, -1)]) + i32(nb[(-1, 1)])
         + i32(nb[(1, -1)]) + i32(nb[(1, 1)]))
    return torch.where(band_class == 0, _zc_primary(h, v, d),
                       torch.where(band_class == 1, _zc_primary(v, h, d),
                                   _zc_hh(h, v, d)))


def _sc_ctx(nb, signs):
    """Sign-coding context and coded bit (Table D.3 in closed form);
    signs: 1 = negative."""
    def contrib(dy, dx):
        s = _shift_to(signs, dy, dx)
        return torch.where(nb[(dy, dx)], 1 - 2 * s, torch.zeros_like(s))
    hc = torch.clamp(contrib(0, -1) + contrib(0, 1), -1, 1)
    vc = torch.clamp(contrib(-1, 0) + contrib(1, 0), -1, 1)
    ctx = torch.where(hc == 0, 9 + (vc != 0).to(torch.int32), 12 + hc * vc)
    xr = ((hc < 0) | ((hc == 0) & (vc < 0))).to(signs.dtype)
    return ctx, signs ^ xr


def _slot(emit, ctx, bit):
    v = (ctx | (bit.to(torch.int32) << 5)).to(torch.uint8)
    return torch.where(emit, v, torch.full_like(v, EMPTY))


def _plane_slots(mags, signs, valid, band_class, r, p: int, live):
    """All decision slots of one bitplane in serial emission order:
    (spp [B, G, W, 4, 2], mrp [B, G, W, 4], cup [B, G, W, 11])."""
    B, H, W = mags.shape
    G = H // 4
    s_in = ((mags >> (p + 1)) > 0) & valid & live
    bit = (((mags >> p) & 1) > 0) & valid & live

    # significance propagation: membership fixpoint
    nb_sin = torch.zeros_like(s_in)
    for (dy, dx) in _OFFS:
        nb_sin |= _shift_to(s_in, dy, dx)
    base = valid & live & ~s_in
    member = base & nb_sin
    while True:
        new = member & bit
        trig = torch.zeros_like(member)
        for (dy, dx) in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (1, -1)):
            trig |= _shift_to(new, dy, dx) & _before_sample(dy, dx, r)
        member2 = base & (nb_sin | trig)
        if torch.equal(member2, member):
            break
        member = member2
    new_spp = member & bit

    nbv = _neighbor_state(s_in, new_spp, r, _before_sample)
    zc = _zc_ctx(nbv, band_class)
    sc, sc_bit = _sc_ctx(nbv, signs)
    spp_a = _slot(member, zc, bit)
    spp_b = _slot(new_spp, sc, sc_bit)

    # magnitude refinement (membership closed-form)
    sig_after = s_in | new_spp
    eta = ((mags >> (p + 2)) > 0) & valid
    nb_any = torch.zeros_like(sig_after)
    for (dy, dx) in _OFFS:
        nb_any |= _shift_to(sig_after, dy, dx)
    mr = _where(eta, 16, _where(nb_any, 15, 14))
    mrp = _slot(s_in, mr, bit)

    # cleanup
    cand = valid & live & ~s_in & ~member
    bc = cand & bit                          # becomes significant in CUP
    nbc = _neighbor_state(sig_after, bc, r, _before_column)
    col_clear = cand.clone()
    for (dy, dx) in _OFFS:
        col_clear &= ~nbc[(dy, dx)]
    yy = torch.arange(H, dtype=torch.int32, device=mags.device).view(1, H, 1)
    hval = torch.where(valid, yy + 1, torch.zeros_like(yy)).amax(
        dim=(1, 2), keepdim=True)
    full_stripe = (yy - r + 4) <= hval       # stripe fully inside the block

    def stripes(a):                          # [B, H, W] -> [B, G, 4, W]
        return a.reshape(B, G, 4, W)

    rl = stripes(col_clear & full_stripe).all(dim=2)          # [B, G, W]
    colbit = stripes(bit)
    any_bit = colbit.any(dim=2)
    rr = torch.arange(4, dtype=torch.int32,
                      device=mags.device).view(1, 1, 4, 1)
    fs = torch.where(colbit, rr, torch.full_like(rr, 4)).amin(dim=2)

    ctx_rl = torch.full_like(fs, CTX_RL)
    ctx_uni = torch.full_like(fs, CTX_UNI)
    rl_slot = _slot(rl, ctx_rl, any_bit)
    u1 = _slot(rl & any_bit, ctx_uni, ((fs >> 1) & 1) > 0)
    u2 = _slot(rl & any_bit, ctx_uni, (fs & 1) > 0)

    in_rl = rl.repeat_interleave(4, dim=1).reshape(B, H, W)
    fs_full = fs.repeat_interleave(4, dim=1).reshape(B, H, W)
    zc_emit = cand & torch.where(in_rl, r > fs_full, torch.ones_like(in_rl))
    nbs = _neighbor_state(sig_after, bc, r, _before_sample)
    zc2 = _zc_ctx(nbs, band_class)
    sc2, sc2_bit = _sc_ctx(nbs, signs)
    cup_a = _slot(zc_emit, zc2, bit)
    sc_emit = (zc_emit & bit) | (in_rl & (r == fs_full) & (fs_full < 4))
    cup_b = _slot(sc_emit, sc2, sc2_bit)

    def col_major(a):                        # [B, H, W] -> [B, G, W, 4]
        return a.reshape(B, G, 4, W).permute(0, 1, 3, 2)

    spp = torch.stack([col_major(spp_a), col_major(spp_b)], dim=-1)
    cup = torch.cat([
        torch.stack([rl_slot, u1, u2], dim=-1),                # [B, G, W, 3]
        torch.stack([col_major(cup_a), col_major(cup_b)],
                    dim=-1).reshape(B, G, W, 8),
    ], dim=-1)                                                 # [B, G, W, 11]
    return spp, col_major(mrp), cup


def decision_slots(mags: torch.Tensor, signs: torch.Tensor,
                   band_class: torch.Tensor, valid: torch.Tensor,
                   max_planes: int) -> torch.Tensor:
    """Dense decision slots for a batch of code-blocks.

    mags, signs: [B, H, W] int32 (H a multiple of 4; signs 1 = negative);
    band_class: [B] int32 (0 = LL/LH, 1 = HL, 2 = HH); valid: [B, H, W] bool
    (True inside the block's true extent); max_planes: bitplanes coded (the
    band's Mb).  Returns uint8 [B, max_planes * slots_per_plane(H, W)] in
    the serial emission order; planes above a block's own bit count hold
    only 0xFF."""
    B, H, W = mags.shape
    if H % 4:
        raise ValueError(f"decision_slots: block height {H} is not a "
                         "multiple of 4")
    maxmag = torch.where(valid, mags, torch.zeros_like(mags)).amax(
        dim=(1, 2), keepdim=True) if mags.numel() else mags.new_zeros(B, 1, 1)
    yy = torch.arange(H, dtype=torch.int32, device=mags.device).view(1, H, 1)
    r = (yy & 3).expand(1, H, W)
    bc3 = band_class.to(torch.int32).view(B, 1, 1)
    out: List[torch.Tensor] = []
    for p in range(max_planes - 1, -1, -1):
        live = (maxmag >> p) > 0
        spp, mrp, cup = _plane_slots(mags, signs, valid, bc3, r, p, live)
        out.append(torch.cat([spp.reshape(B, -1), mrp.reshape(B, -1),
                              cup.reshape(B, -1)], dim=1))
    if not out:
        return torch.zeros((B, 0), dtype=torch.uint8, device=mags.device)
    return torch.cat(out, dim=1)


def snake_block(h: int = 64, w: int = 64, p: int = 3) -> np.ndarray:
    """Magnitudes of an [h, w] block whose plane-p SPP propagation chain
    runs as far as the visiting order lets it: a sample significant before
    the plane at (0, 0), then plane-p samples along row 0 to the right edge
    (each the W neighbour of the next), down the last column to row 3, and
    from each stripe's row 3 to the next stripe's row 0 one column to the
    left (NE, the only way a chain moves left) and down that column.  A
    whole-block Jacobi sweep moves the chain one sample, so the plain
    fixpoint takes about w + h sweeps; every other sample is 0."""
    m = np.zeros((h, w), np.int32)
    m[0, 0] = 1 << (p + 1)
    m[0, 1:] = 1 << p
    x = w - 1
    for g in range(h // 4):
        x = w - 1 - g
        if x < 0:
            break
        m[4 * g + (g == 0):4 * g + 4, x] = 1 << p
    return m


def stress_blocks(h: int = 64, w: int = 64, seed: int = 0) -> Dict:
    """Decision-slot inputs that stress a kernel of one CTA per (block,
    plane): name -> (mags, signs, band classes, valid, max_planes) as numpy
    int32 [B, h, w], int32 [B, h, w], int32 [B], bool [B, h, w], int.
    - "snake": snake_block in each band class, plus low-plane noise;
    - "comb": a chain along row 0 of every stripe, each seeded at its own
      left end, and a ragged valid mask;
    - "single_live": 0/1 magnitudes under 12 planes (11 planes of 0xFF
      only), an all-zero block and one single 1;
    - "all_planes": magnitudes up to 2^29 - 1 under MAX_PLANES = 29 planes,
      dense and sparse.
    The same seed gives the same blocks."""
    rng = np.random.RandomState(seed)
    out = {}

    def signs_of(shape):
        return rng.randint(0, 2, shape).astype(np.int32)

    snake = snake_block(h, w, 3)
    mags = np.stack([snake | (rng.rand(h, w) < 0.2).astype(np.int32)
                     * (snake == 0) for _ in range(3)])
    out["snake"] = (mags, signs_of(mags.shape),
                    np.arange(3, dtype=np.int32), np.ones(mags.shape, bool),
                    6)
    comb = np.zeros((2, h, w), np.int32)
    comb[:, 0::4, 0] = 1 << 6
    comb[:, 0::4, 1:] = 1 << 5
    valid = np.ones(comb.shape, bool)
    valid[1, h - 3:, :] = False
    valid[1, :, w - 5:] = False
    out["comb"] = (comb, signs_of(comb.shape), np.asarray([0, 2], np.int32),
                   valid, 8)
    live = np.stack([(rng.rand(h, w) < 0.3).astype(np.int32),
                     np.zeros((h, w), np.int32),
                     np.zeros((h, w), np.int32)])
    live[2, h // 2, w // 3] = 1
    out["single_live"] = (live, signs_of(live.shape),
                          np.asarray([1, 0, 2], np.int32),
                          np.ones(live.shape, bool), 12)
    top = (1 << 29) - 1
    dense = rng.randint(0, top + 1, (h, w)).astype(np.int32)
    sparse = np.where(rng.rand(h, w) < 0.05,
                      rng.randint(0, top + 1, (h, w)), 0).astype(np.int32)
    sparse[h - 1, w - 1] = top
    steps = (1 << rng.randint(0, 30, (h, w))).astype(np.int32) - 1
    mags = np.stack([dense, sparse, steps])
    out["all_planes"] = (mags, signs_of(mags.shape),
                         np.asarray([2, 1, 0], np.int32),
                         np.ones(mags.shape, bool), 29)
    return out


def compact_host(slots) -> list:
    """Host reference compaction: per block, the ordered (ctx, bit)
    decision list (drops the 0xFF slots)."""
    out = []
    for row in np.asarray(slots):
        sel = row[row != EMPTY]
        out.append([(int(v & 0x1F), int(v >> 5)) for v in sel])
    return out


def numbps_of(mags: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per block, the bit count of its largest valid magnitude."""
    m = np.where(valid, mags, 0).reshape(mags.shape[0], -1).max(axis=1)
    return np.asarray([int(x).bit_length() for x in m], np.int32)
