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

import torch

from . import quant

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


def leaf_level(lev: int, name: str, nl: int) -> int:
    """Pyramid list index of a plan band (LL sits with the top level)."""
    if name == "LL":
        return nl - 1 if nl > 0 else 0
    return lev - 1


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
