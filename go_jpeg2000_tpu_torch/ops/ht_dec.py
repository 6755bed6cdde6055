"""Device half of the HT cleanup decode, as plain torch.

Port of go_jpeg2000_tpu/ops/ht_tpu_decode.py.  The host (native
`ht_t2_parse_frames`) runs the sequentially coupled control phase: Tier-2,
MEL, CxtVLC and UVLC, which leave one word per quad, U | rho << 8 |
ek << 12 | e1 << 16, and the unstuffed MagSgn bits of every block as
LSB-first 32-bit words.  What is left is data-parallel: every sample's
MagSgn field length is known from its quad word, so its bit offset is one
prefix sum and its value a read from the word pool (`magsgn_decode_blocks`);
the block slots then become pyramid leaves (`blocks_to_pyramid`, with the
midpoint dequantization of lossy plans), and `fused_decode` chains both with
the inverse transform.

These are the plain versions of the CUDA kernels in csrc/ht_dec.cu; the
wrappers in ops/ht_dec_cuda.py pick the kernel for a CUDA tensor and these
for a CPU tensor.  Torch on the CPU has no uint32 shifts, so 32-bit words
ride in int64 and are masked, as in ops/ht_enc.py.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import quant
from .block_layout import leaf_level

_WORD = 0xFFFFFFFF


def magsgn_decode_blocks(qinfo: torch.Tensor, pool: torch.Tensor,
                         woff: torch.Tensor, cbh: int, cbw: int
                         ) -> torch.Tensor:
    """Per-sample MagSgn extraction.

    qinfo: [NB, QH, QW] quad words (int32 or int64 holding the uint32
    pattern; 0 for quads that carry no code); pool: [P] unstuffed MagSgn
    words (int32 bit patterns or int64); woff: [NB] each block's first word
    in pool.  Returns int32 [NB, cbh, cbw] signed coefficients,
    sign * ((v >> 1) + 1) (T.814 7.3.5), in raster order.

    A field of m = rho_n ? U - ek_n : 0 bits starts at woff * 32 plus the
    exclusive prefix sum of m over the block in quad order (n0..n3 =
    (0,0), (1,0), (0,1), (1,1) within a quad).  Bit offsets are int64, so
    the JAX package's gate on batches of 2^31 bits has no counterpart here.
    Word reads clamp to the pool, as jnp.take(mode="clip") does.
    """
    nb, qh, qw = qinfo.shape
    dev = qinfo.device
    q = qinfo.to(torch.int64) & _WORD
    u = q & 0xFF
    i4 = torch.arange(4, device=dev)
    sig = ((q >> 8)[..., None] >> i4) & 1                 # [NB, QH, QW, 4]
    ekn = ((q >> 12)[..., None] >> i4) & 1
    e1n = ((q >> 16)[..., None] >> i4) & 1
    m = torch.where(sig == 1, u[..., None] - ekn, 0).reshape(nb, -1)
    off = torch.cumsum(m, dim=1) - m                      # exclusive
    goff = (off + woff.to(torch.int64)[:, None] * 32).reshape(-1)
    words = pool.to(torch.int64) & _WORD
    last = words.numel() - 1
    wi = goff >> 5
    sh = goff & 31
    lo = words[wi.clamp(0, last)] >> sh
    hi = torch.where(sh > 0,
                     (words[(wi + 1).clamp(0, last)] << (32 - sh)) & _WORD,
                     0)
    mm = m.reshape(-1)
    v = (lo | hi) & ((1 << mm) - 1)
    # a 32-bit shift by 32 gives 0 (XLA's rule, and the kernel's guard)
    v = v | torch.where(mm < 32, e1n.reshape(-1) << mm, 0)
    mu = (v >> 1) + 1
    c = torch.where(sig.reshape(-1) == 1, torch.where((v & 1) == 1, -mu, mu),
                    0).to(torch.int32).reshape(nb, qh, qw, 4)
    top = torch.stack([c[..., 0], c[..., 2]], dim=-1).reshape(nb, qh, 2 * qw)
    bot = torch.stack([c[..., 1], c[..., 3]], dim=-1).reshape(nb, qh, 2 * qw)
    out = torch.stack([top, bot], dim=2).reshape(nb, 2 * qh, 2 * qw)
    return out[:, :cbh, :cbw].contiguous()


def _quad_words(u, rho, ek, e1) -> np.ndarray:
    """Quad words U | rho << 8 | ek << 12 | e1 << 16 as int32 bit
    patterns."""
    q = (np.asarray(u, np.int64) | np.asarray(rho, np.int64) << 8
         | np.asarray(ek, np.int64) << 12 | np.asarray(e1, np.int64) << 16)
    return q.astype(np.uint32).view(np.int32)


def _bits_of(qinfo: np.ndarray) -> np.ndarray:
    """Per block, the MagSgn bits its quad words ask for."""
    q = qinfo.astype(np.int64).reshape(qinfo.shape[0], -1, 1) & _WORD
    i4 = np.arange(4)
    sig = ((q >> 8) >> i4) & 1
    return (sig * ((q & 0xFF) - (((q >> 12) >> i4) & 1))).sum(axis=(1, 2))


def stress_cases(stage_words: int, seed: int = 0) -> List:
    """MagSgn inputs that stress a kernel which stages each block's words
    in a window of `stage_words` words: [(name, qinfo int32 [NB, QH, QW],
    pool int32 [P], woff int64 [NB], cbh, cbw, pool offset)], the pool
    offset the words to skip at the start of the buffer (a pool that
    starts off 16 bytes).  Blocks sit at word boundaries, one after
    another, as the parser lays them out, except where a case says.
    - "m32": U = 32 (fields of 31 and 32 bits) in the second and third
      blocks; the second one 31-bit field, then 32-bit fields across word
      boundaries, 4096 words from 2 words past a 16-byte boundary (its
      last 2 words past the window);
    - "uncoded": fully uncoded blocks between coded ones, and quads left
      uncoded at random;
    - "pool_end": the last block's fields run past the pool's last word
      (reads clamp to it);
    - "odd": 63 x 61 blocks (a quad row of 31), and 5 x 7 blocks;
    - "gaps": offsets with gaps, out of order, and a block far past the
      next one's window;
    - "wide": 64 x 64 and 62 x 64 blocks of random fields up to 24 bits,
      the pool starting 4 bytes past a 16-byte boundary.
    The same seed gives the same cases."""
    rng = np.random.RandomState(seed)

    def rand_quads(nb, qh, qw, umax, p_coded=0.8):
        u = rng.randint(1, umax + 1, (nb, qh, qw))
        rho = rng.randint(1, 16, (nb, qh, qw))
        coded = rng.rand(nb, qh, qw) < p_coded
        return (np.where(coded, u, 0), np.where(coded, rho, 0),
                rng.randint(0, 16, (nb, qh, qw)) * coded,
                rng.randint(0, 16, (nb, qh, qw)) * coded)

    def packed(parts, gaps=None):
        q = _quad_words(*parts)
        words = -(-_bits_of(q) // 32)
        woff = np.concatenate([[0], np.cumsum(words)[:-1]]).astype(np.int64)
        if gaps is not None:
            woff = woff + np.asarray(gaps, np.int64)
        total = int(max(woff + words).max()) + 1 if len(woff) else 1
        pool = rng.randint(0, 1 << 32, total, dtype=np.int64).astype(
            np.uint32).view(np.int32)
        return q, pool, woff

    cases = []
    u = np.full((3, 32, 32), 32)
    u[0] = rng.randint(1, 7, (32, 32))
    rho = rng.randint(1, 16, (3, 32, 32))
    rho[1] = 15
    ek = rng.randint(0, 16, (3, 32, 32))
    ek[1] = 0
    ek[1, 0, 0] = 1          # a 31-bit field first: the rest straddle words
    e1 = rng.randint(0, 16, (3, 32, 32))
    q = _quad_words(u, rho, ek, e1)
    first = -(-int(_bits_of(q)[0]) // 32)
    # the 4096-word block 2 words past a 16-byte boundary: its window, from
    # that boundary, ends 2 words short of it
    lift = (2 - first) % 4
    cases.append(("m32",) + packed((u, rho, ek, e1), gaps=[0, lift, lift])
                 + (64, 64, 0))
    parts = rand_quads(5, 32, 32, 18, p_coded=0.6)
    for i in (0, 2, 4):
        for a in parts:
            a[i] = 0
    cases.append(("uncoded",) + packed(parts) + (64, 64, 0))
    q, pool, woff = packed(rand_quads(3, 32, 32, 20))
    cases.append(("pool_end", q, pool[:int(woff[-1]) + 3], woff, 64, 64, 0))
    cases.append(("odd",) + packed(rand_quads(4, 32, 31, 16)) + (63, 61, 0))
    cases.append(("odd_small",) + packed(rand_quads(6, 3, 4, 12))
                 + (5, 7, 0))
    parts = rand_quads(4, 32, 32, 16)
    q, pool, woff = packed(parts, gaps=[37, 5, 2 * stage_words, 11])
    woff[[1, 3]] = woff[[3, 1]]
    cases.append(("gaps", q, pool, woff, 64, 64, 0))
    q, pool, woff = packed(rand_quads(4, 32, 32, 24, p_coded=0.9))
    cases.append(("wide", q, np.concatenate([pool[:1], pool]), woff, 64,
                  64, 1))
    q, pool, woff = packed(rand_quads(3, 31, 32, 24))
    cases.append(("wide_62", q, pool, woff, 62, 64, 0))
    return cases


def blocks_to_pyramid(coeffs: torch.Tensor, plan, n: int, n_comps: int,
                      nl: int, dequant: bool = False
                      ) -> List[Dict[str, torch.Tensor]]:
    """Block slots [N*nb, CBH, CBW] -> stacked pyramid leaves [N, C, bh, bw]
    on the slots' device: the inverse of fused_encode.extract_blocks, with
    the first-row/first-column rolls of offset grids.  dequant=True applies
    each band's midpoint dequantization (plan.deltas) and gives float32
    leaves; otherwise the leaves are the int32 slots' values."""
    coeffs = coeffs.reshape(n, plan.nb, plan.cbh, plan.cbw)
    stacked: List[Dict[str, torch.Tensor]] = [dict()
                                              for _ in range(max(1, nl))]
    per_band: Dict = {}
    base = 0
    for bi, (_c, lev, name, gy, gx, eh, ew, bh, bw, oy, ox) in \
            enumerate(plan.band_specs):
        blk = coeffs[:, base:base + gy * gx, :eh, :ew]
        base += gy * gx
        if dequant:
            # (|q| + 0.5) * delta in float32, then the (exact) sign: the
            # midpoint rule of E.1.1.2; 0 stays 0
            blk = quant.dequantize(blk, torch.tensor(
                plan.deltas[bi], dtype=torch.float32, device=blk.device))
        blk = blk.reshape(n, gy, gx, eh, ew)
        if oy:
            blk = torch.cat([torch.roll(blk[:, :1], oy, dims=-2), blk[:, 1:]],
                            dim=1)
        if ox:
            blk = torch.cat([torch.roll(blk[:, :, :1], ox, dims=-1),
                             blk[:, :, 1:]], dim=2)
        a = (blk.permute(0, 1, 3, 2, 4)
             .reshape(n, gy * eh, gx * ew)[:, oy:oy + bh, ox:ox + bw])
        per_band.setdefault((lev, name), []).append(a)
    for (lev, name), comps in per_band.items():
        stacked[leaf_level(lev, name, nl)][name] = torch.stack(comps, dim=1)
    return stacked


def fused_decode(qinfo: torch.Tensor, pool: torch.Tensor, woff: torch.Tensor,
                 plan, n: int, n_comps: int, nl: int, kind: str,
                 use_mct: bool, precision: int, signed: bool
                 ) -> torch.Tensor:
    """The decode's device program (the JAX package's fused_decode_fn): MagSgn
    extraction, block-to-pyramid assembly with the midpoint dequantization
    of 9/7 plans, the inverse DWT, inverse RCT/ICT, rounding, DC shift,
    clamp and narrowing, on the inputs' device.  Returns the narrow pixels
    flat, frame-major [N, C, H, W] (16-bit as the int16 pattern)."""
    from ..models import transforms
    from . import dwt, ht_dec_cuda
    blocks = ht_dec_cuda.magsgn_decode_blocks(qinfo, pool, woff, plan.cbh,
                                              plan.cbw)
    pyr = ht_dec_cuda.blocks_to_pyramid(blocks, plan, n, n_comps, nl,
                                        dequant=kind == dwt.IRR97)
    del blocks
    return transforms.inverse_pyramid(pyr, kind, use_mct, precision, signed,
                                      0, 0)
