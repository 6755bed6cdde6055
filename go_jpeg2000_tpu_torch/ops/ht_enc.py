"""HTJ2K cleanup-pass encoder fields, bit packing and pool compaction, as
plain torch ops.

Port of go_jpeg2000_tpu/ops/ht_tpu.py.  In the encoder every quantity the
T.814 cleanup pass codes (quad significance rho, the context from the
causal neighbourhood, kappa/U/u_off, the CxtVLC codeword, the EMB bits and
the MagSgn fields) is a pure function of the block's coefficients, so a
whole batch of blocks evaluates as element-wise tensor ops.  Only the
byte-oriented tails (MEL run-length coding, byte stuffing) stay on the host
(native serializer; Python twin `serialize_block` below).

These are the plain versions of the CUDA kernels in csrc/ht_enc.cu
(ops/ht_enc_cuda.py):

  cleanup_fields -> ht_cleanup_pack   (cleanup_values, the field values,
                                       lengths and meta, then pack_bits of
                                       each stream into words)
  assemble_pool  -> ht_compact_pool   (meta rows + the three dense pools)

and `cleanup_fields` / `cleanup_fields_compact` compose them as the JAX
functions of those names do.  What differs from the TPU form: packing adds
each field's low and spill words with one scatter (the fields cover
disjoint bit ranges, so a sum is an OR) instead of a segmented OR-scan and
a sort, and the pool is exactly as long as the streams it holds, so it has
no capacity and cannot overflow.  Torch on the CPU has no uint32 shifts or
compares: 32-bit words are computed in int64 and returned as int32 tensors
holding the uint32 bit patterns (view them as uint32 in numpy).

Stream layout per block (identical to ops/ht.py `encode_cleanup`):
MagSgn fields per quad row, quad pair, quad in the pair, sample n0..n3;
VLC per pair [cwd0, cwd1, s2, s3, s4, s5]; MEL events per pair
[azc0, azc1, big].  Quad columns are padded to even (the pair grid).
A field value is 0 wherever its length is 0.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from . import ht as ht_ref

# blocks per group in the plain versions: bounds their int64 temporaries
# (about 40 live [G, H, W] int64 tensors) to a few hundred MB at 64x64
GROUP_BLOCKS = 256
MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Direct-indexed encoder VLC table (exact copy of ht_tpu._direct_enc_table).
#
# ops/ht.py selects, per (ctx, rho, u_off), the candidate (e1, ek, cwd, len)
# maximizing (popcount(ek), -len) subject to EMB validity against the actual
# MSB pattern at bitplane U-1.  That choice is a pure function of
# (initial, ctx, rho, u_off, msb4) — flatten it into one gather table.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def direct_enc_table() -> np.ndarray:
    tbl = np.zeros(2 * 8 * 16 * 2 * 16, dtype=np.int32)
    for init, src in ((0, ht_ref.ENC_TBL0), (1, ht_ref.ENC_TBL1)):
        for (ctx, rho, uoff), cands in src.items():
            for msb in range(16):
                best = None
                for (e1, ek, cwd, ln) in cands:
                    ok = True
                    for i in range(4):
                        if (ek >> i) & 1:
                            if not ((rho >> i) & 1):
                                ok = False
                                break
                            if ((e1 >> i) & 1) != ((msb >> i) & 1):
                                ok = False
                                break
                        else:
                            if (e1 >> i) & 1:
                                ok = False
                                break
                    if not ok:
                        continue
                    score = bin(ek).count("1")
                    key = (score, -ln)
                    if best is None or key > best[0]:
                        best = (key, e1, ek, cwd, ln)
                if best is None:
                    continue
                _, e1, ek, cwd, ln = best
                idx = ((((init * 8 + ctx) * 16 + rho) * 2 + uoff) * 16 + msb)
                tbl[idx] = e1 | (ek << 4) | (cwd << 8) | (ln << 16)
    return tbl


def stream_words(h: int, w: int, max_mn: int) -> Tuple[int, int, int]:
    """Words per block row of the MagSgn, VLC and MEL streams of an [h, w]
    block: h*w*max_mn bits, one word per quad pair, 3 bits per pair."""
    qh, qw = h // 2, w // 2
    pairs = (qw + (qw & 1)) // 2
    return ((h * w * max_mn + 31) // 32, qh * pairs,
            (qh * pairs * 3 + 31) // 32)


def field_counts(h: int, w: int) -> Tuple[int, int, int]:
    """Fields per block of the MagSgn, VLC and MEL streams."""
    qh, qw = h // 2, w // 2
    n_pairs = qh * ((qw + (qw & 1)) // 2)
    return 8 * n_pairs, 6 * n_pairs, 3 * n_pairs


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative integers below 2^53 (0 -> 0): the
    exponent of frexp, exact in float64."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def _uvlc_fields(t: torch.Tensor):
    """UVLC prefix/suffix for biased value t >= 1 (ops/ht.py
    `_uvlc_encode_value`): (prefix, prefix_len, suffix, suffix_len)."""
    w = torch.where
    p = w(t == 1, 1, w(t == 2, 2, w(t <= 4, 4, 0)))
    pl = w(t == 1, 1, w(t == 2, 2, 3))
    s = w(t <= 2, 0, w(t <= 4, t - 3, t - 5))
    sl = w(t <= 2, 0, w(t <= 4, 1, 5))
    return p, pl, s, sl


def _pad_last(a: torch.Tensor, left: int, right: int) -> torch.Tensor:
    parts = []
    shape = a.shape[:-1]
    if left:
        parts.append(a.new_zeros(shape + (left,)))
    parts.append(a)
    if right:
        parts.append(a.new_zeros(shape + (right,)))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else a


def _values_group(c: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                  tbl: torch.Tensor) -> Dict[str, torch.Tensor]:
    nb, h, w = c.shape
    qh, qw = h // 2, w // 2
    qwp = qw + (qw & 1)
    pairs = qwp // 2
    dev = c.device
    where = torch.where

    hs = hs.to(device=dev, dtype=torch.int64).view(-1, 1, 1)
    ws = ws.to(device=dev, dtype=torch.int64).view(-1, 1, 1)
    yy = torch.arange(h, device=dev).view(1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w)
    valid = (yy < hs) & (xx < ws)

    c = c.to(torch.int64)
    mags = where(valid, c.abs(), 0)
    neg = ((c < 0) & valid).to(torch.int64)
    v = where(mags > 0, ((mags - 1) << 1) | neg, 0)
    e = _bitlen(v)
    sg = (mags > 0).to(torch.int64)
    numbps = _bitlen(mags.reshape(nb, -1).amax(dim=1))

    def quad(a):
        q = torch.stack([a[:, 0::2, 0::2], a[:, 1::2, 0::2],
                         a[:, 0::2, 1::2], a[:, 1::2, 1::2]], dim=-1)
        if qwp != qw:
            q = torch.cat([q, q.new_zeros((nb, qh, qwp - qw, 4))], dim=2)
        return q

    v4 = quad(v)                           # [nb, qh, qwp, 4]
    e4 = quad(e)
    s4 = quad(sg)
    rho = s4[..., 0] | (s4[..., 1] << 1) | (s4[..., 2] << 2) \
        | (s4[..., 3] << 3)
    emax = e4.amax(dim=-1)

    qy = torch.arange(qh, device=dev).view(1, qh, 1)
    qx = torch.arange(qwp, device=dev).view(1, 1, qwp)
    exists = (qx < ((ws + 1) >> 1)) & (qy < ((hs + 1) >> 1))
    is_init = qy == 0

    # line state from the quad row above (ops/ht.py `_update_ls`: entry q
    # <- n1 of quad q and n3 of quad q-1)
    sig_n1, sig_n3 = s4[..., 1], s4[..., 3]
    e_n1 = where(sig_n1 > 0, e4[..., 1], 0)
    e_n3 = where(sig_n3 > 0, e4[..., 3], 0)
    ls_sig = _pad_last(sig_n1, 0, 1) | _pad_last(sig_n3, 1, 0)
    ls_e = torch.maximum(_pad_last(e_n1, 0, 1), _pad_last(e_n3, 1, 0))
    zrow = ls_sig.new_zeros((nb, 1, qwp + 1))
    prev_sig = torch.cat([zrow, ls_sig[:, :-1]], dim=1)
    prev_e = torch.cat([zrow, ls_e[:, :-1]], dim=1)

    # context (uniform over both quads of a pair)
    rho_w = _pad_last(rho, 1, 0)[:, :, :-1]
    ctx_init = ((rho_w & 1) | (rho_w >> 1)) & 7
    w_bit = ((rho_w & 0xC) != 0).to(torch.int64)
    ctx_non = prev_sig[:, :, :qwp] | (w_bit << 1) \
        | (prev_sig[:, :, 1:] << 2)
    ctx = where(is_init, ctx_init, ctx_non)

    # kappa / U / u_off
    pc = (rho & 1) + ((rho >> 1) & 1) + ((rho >> 2) & 1) + ((rho >> 3) & 1)
    emax_n = torch.maximum(prev_e[:, :, :qwp], prev_e[:, :, 1:])
    kappa = where(is_init, 1,
                  where(pc > 1, torch.clamp(emax_n - 1, min=1), 1))
    coded = exists & ((ctx != 0) | (rho != 0))
    azc = exists & (ctx == 0)
    u = torch.maximum(kappa, emax)
    u_off = ((u - kappa) > 0) & coded
    u_max = torch.clamp(where(coded, u, 0).reshape(nb, -1).amax(dim=1),
                        min=1)

    # VLC codeword lookup
    ushift = torch.clamp(u - 1, min=0)
    msb = torch.zeros_like(rho)
    for i in range(4):
        msb = msb | (((v4[..., i] >> ushift) & 1) << i)
    init_i = where(is_init, 0, 1)
    idx = ((((init_i * 8 + ctx) * 16 + rho) * 2 + u_off.to(torch.int64))
           * 16 + msb)
    entry = tbl[idx]
    cwd = (entry >> 8) & 0xFF
    cwd_len = where(coded, (entry >> 16) & 0xF, 0)
    ek = (entry >> 4) & 0xF

    # MagSgn fields, in-quad order n0..n3
    bit_i = torch.arange(4, device=dev)
    m_n = torch.clamp(u[..., None] - ((ek[..., None] >> bit_i) & 1), 0, 31)
    ms_len = where((s4 > 0) & coded[..., None], m_n, 0)
    ms_val = v4 & ((1 << ms_len) - 1)

    # per-pair u coding and MEL events
    def pair_view(a):
        return a.reshape(nb, qh, pairs, 2)

    u_p = pair_view(u)
    kappa_p = pair_view(kappa)
    uoff_p = pair_view(u_off.to(torch.int64))
    init_row = torch.arange(qh, device=dev).view(1, qh, 1) == 0

    mode = uoff_p[..., 0] + 2 * uoff_p[..., 1]
    u0i = u_p[..., 0] - 1                  # initial-stripe biased u
    u1i = u_p[..., 1] - 1
    uq0 = u_p[..., 0] - kappa_p[..., 0]
    uq1 = u_p[..., 1] - kappa_p[..., 1]
    big = (u0i > 2) & (u1i > 2)

    pI0, plI0, sI0, slI0 = _uvlc_fields(torch.clamp(u0i, min=1))
    pI1, plI1, sI1, slI1 = _uvlc_fields(torch.clamp(u1i, min=1))
    pB0, plB0, sB0, slB0 = _uvlc_fields(torch.clamp(u0i - 2, min=1))
    pB1, plB1, sB1, slB1 = _uvlc_fields(torch.clamp(u1i - 2, min=1))
    pN0, plN0, sN0, slN0 = _uvlc_fields(torch.clamp(uq0, min=1))
    pN1, plN1, sN1, slN1 = _uvlc_fields(torch.clamp(uq1, min=1))

    m3, m1, m2 = mode == 3, mode == 1, mode == 2
    u0b = u0i > 2
    # initial-stripe slots
    i_s2v = where(m3, where(big, pB0, pI0), where(m1, pI0, where(m2, pI1, 0)))
    i_s2l = where(m3, where(big, plB0, plI0),
                  where(m1, plI0, where(m2, plI1, 0)))
    i_s3v = where(m3, where(big, pB1, where(u0b, u1i - 1, pI1)),
                  where(m1, sI0, where(m2, sI1, 0)))
    i_s3l = where(m3, where(big, plB1, where(u0b, 1, plI1)),
                  where(m1, slI0, where(m2, slI1, 0)))
    i_s4v = where(m3, where(big, sB0, sI0), 0)
    i_s4l = where(m3, where(big, slB0, slI0), 0)
    i_s5v = where(m3, where(big, sB1, where(u0b, 0, sI1)), 0)
    i_s5l = where(m3, where(big, slB1, where(u0b, 0, slI1)), 0)
    # non-initial slots
    n_s2v = where(m3 | m1, pN0, where(m2, pN1, 0))
    n_s2l = where(m3 | m1, plN0, where(m2, plN1, 0))
    n_s3v = where(m3, pN1, where(m1, sN0, where(m2, sN1, 0)))
    n_s3l = where(m3, plN1, where(m1, slN0, where(m2, slN1, 0)))
    n_s4v = where(m3, sN0, 0)
    n_s4l = where(m3, slN0, 0)
    n_s5v = where(m3, sN1, 0)
    n_s5l = where(m3, slN1, 0)

    cwd_p = pair_view(cwd)
    cwdl_p = pair_view(cwd_len)
    vlc_vals = torch.stack(
        [cwd_p[..., 0], cwd_p[..., 1], where(init_row, i_s2v, n_s2v),
         where(init_row, i_s3v, n_s3v), where(init_row, i_s4v, n_s4v),
         where(init_row, i_s5v, n_s5v)], dim=-1)
    vlc_lens = torch.stack(
        [cwdl_p[..., 0], cwdl_p[..., 1], where(init_row, i_s2l, n_s2l),
         where(init_row, i_s3l, n_s3l), where(init_row, i_s4l, n_s4l),
         where(init_row, i_s5l, n_s5l)], dim=-1)

    azc_p = pair_view(azc.to(torch.int64))
    rho_p = pair_view(rho)
    mel_vals = torch.stack([(rho_p[..., 0] != 0).to(torch.int64),
                            (rho_p[..., 1] != 0).to(torch.int64),
                            big.to(torch.int64)], dim=-1)
    mel_lens = torch.stack([azc_p[..., 0], azc_p[..., 1],
                            (init_row & m3).to(torch.int64)], dim=-1)

    out = {}
    for name, vals, lens in (("ms", ms_val, ms_len),
                             ("vlc", vlc_vals, vlc_lens),
                             ("mel", mel_vals, mel_lens)):
        lens = lens.reshape(nb, -1)
        out[f"{name}_vals"] = where(lens > 0, vals.reshape(nb, -1),
                                    0).to(torch.int32)
        out[f"{name}_lens"] = lens.to(torch.int32)
    out["numbps"] = numbps.to(torch.int32)
    out["u_max"] = u_max.to(torch.int32)
    # float32 squares summed in float64 and rounded once, as the kernel
    out["dist"] = (mags.to(torch.float32) ** 2).to(torch.float64).reshape(
        nb, -1).sum(dim=1).to(torch.float32)
    return out


_TABLES: Dict[torch.device, torch.Tensor] = {}


def enc_table(device, dtype=torch.int64) -> torch.Tensor:
    """direct_enc_table() on `device` (cached per device and dtype)."""
    key = (torch.device(device), dtype)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(direct_enc_table()).to(
            device=key[0], dtype=dtype)
    return _TABLES[key]


def cleanup_values(coeffs: torch.Tensor, hs, ws) -> Dict[str, torch.Tensor]:
    """Every HT cleanup field of a batch of code-blocks.

    coeffs: int32 [Nb, H, W], H and W even (zero-padded); hs, ws: the true
    block sizes [Nb].  Returns int32 tensors {ms,vlc,mel}_{vals,lens}
    [Nb, F] in stream order (`field_counts`), numbps and u_max [Nb] int32,
    and dist [Nb] float32 (the sum of squared magnitudes: float32 squares
    summed in float64, rounded once)."""
    nb, h, w = coeffs.shape
    assert h % 2 == 0 and w % 2 == 0
    dev = coeffs.device
    hs = torch.as_tensor(hs, device=dev)
    ws = torch.as_tensor(ws, device=dev)
    fm, fv, fe = field_counts(h, w)
    out = {}
    for name, f in (("ms", fm), ("vlc", fv), ("mel", fe)):
        out[f"{name}_vals"] = torch.empty((nb, f), dtype=torch.int32,
                                          device=dev)
        out[f"{name}_lens"] = torch.empty((nb, f), dtype=torch.int32,
                                          device=dev)
    out["numbps"] = torch.empty(nb, dtype=torch.int32, device=dev)
    out["u_max"] = torch.empty(nb, dtype=torch.int32, device=dev)
    out["dist"] = torch.empty(nb, dtype=torch.float32, device=dev)
    tbl = enc_table(dev)
    for s in range(0, nb, GROUP_BLOCKS):
        e = min(nb, s + GROUP_BLOCKS)
        part = _values_group(coeffs[s:e], hs[s:e], ws[s:e], tbl)
        for k, v in part.items():
            out[k][s:e] = v
    return out


def _to_u32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


def pack_bits(vals: torch.Tensor, lens: torch.Tensor, n_words: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack each row's LSB-first fields (0 to 31 bits; values are masked to
    their length) into 32-bit words.  vals, lens [Nb, F].  Returns (words
    int32 [Nb, n_words] holding uint32 bit patterns, zero past the stream,
    total bits int32 [Nb]).  Raises if a row needs more than n_words."""
    nb, f = vals.shape
    dev = vals.device
    words = torch.empty((nb, n_words), dtype=torch.int32, device=dev)
    total = torch.zeros(nb, dtype=torch.int32, device=dev)
    if f == 0:
        words.zero_()
        return words, total
    for s in range(0, nb, GROUP_BLOCKS):
        e = min(nb, s + GROUP_BLOCKS)
        ln = lens[s:e].to(torch.int64)
        v = vals[s:e].to(torch.int64) & ((1 << ln) - 1)
        off = torch.cumsum(ln, dim=1) - ln
        tot = off[:, -1] + ln[:, -1]
        if int(tot.max()) > 32 * n_words:
            raise ValueError(f"pack_bits: a row needs {int(tot.max())} bits, "
                             f"more than {n_words} words")
        bit = off & 31
        widx = torch.clamp(off >> 5, max=n_words)
        acc = torch.zeros((e - s, n_words + 2), dtype=torch.int64,
                          device=dev)
        # the fields cover disjoint bit ranges: adding is OR-ing
        acc.scatter_add_(1, widx, (v << bit) & MASK32)
        acc.scatter_add_(1, widx + 1, v >> (32 - bit))
        words[s:e] = _to_u32_bits(acc[:, :n_words])
        total[s:e] = tot.to(torch.int32)
    return words, total


def compact_pool(words: torch.Tensor, bits: torch.Tensor):
    """Concatenate each row's used words (ceil(bits/32) leading words) into
    one dense pool.  Returns (pool [sum nw], off [Nb] int64 word offsets,
    nw [Nb] int64 word counts)."""
    nw = (bits.to(torch.int64) + 31) >> 5
    off = torch.cumsum(nw, dim=0) - nw
    keep = torch.arange(words.shape[1], device=words.device)[None, :] \
        < nw[:, None]
    return words[keep], off, nw


def assemble_pool(ms_words, ms_bits, vlc_words, vlc_bits, mel_words,
                  mel_bits, numbps, u_max, dist):
    """One int32 array [6*Nb meta | MagSgn pool | VLC pool | MEL pool] and
    the pools' word totals int64 [3].  The meta rows are ms_bits, vlc_bits,
    mel_bits, numbps, u_max and dist's float32 bit pattern."""
    pools = [compact_pool(ms_words, ms_bits)[0],
             compact_pool(vlc_words, vlc_bits)[0],
             compact_pool(mel_words, mel_bits)[0]]
    meta = torch.stack([ms_bits, vlc_bits, mel_bits, numbps, u_max,
                        dist.to(torch.float32).view(torch.int32)])
    out = torch.cat([meta.reshape(-1).to(torch.int32)] + pools)
    totals = torch.tensor([p.numel() for p in pools], dtype=torch.int64,
                          device=out.device)
    return out, totals


def cleanup_fields(coeffs: torch.Tensor, hs, ws, max_mn: int
                   ) -> Dict[str, torch.Tensor]:
    """cleanup_values with each stream packed (ht_tpu.cleanup_fields):
    {ms,vlc,mel}_words [Nb, W] int32 (uint32 bit patterns) and _bits [Nb],
    numbps, u_max, dist.  max_mn bounds the MagSgn field bits (>= Mb + 2)."""
    h, w = coeffs.shape[1:]
    f = cleanup_values(coeffs, hs, ws)
    out = {k: f[k] for k in ("numbps", "u_max", "dist")}
    for name, n_words in zip(("ms", "vlc", "mel"),
                             stream_words(h, w, max_mn)):
        out[f"{name}_words"], out[f"{name}_bits"] = pack_bits(
            f[f"{name}_vals"], f[f"{name}_lens"], n_words)
    return out


def cleanup_fields_compact(coeffs: torch.Tensor, hs, ws, max_mn: int):
    """cleanup_fields then assemble_pool: (int32 [6*Nb + sum(totals)],
    totals int64 [3])."""
    f = cleanup_fields(coeffs, hs, ws, max_mn)
    return assemble_pool(f["ms_words"], f["ms_bits"], f["vlc_words"],
                         f["vlc_bits"], f["mel_words"], f["mel_bits"],
                         f["numbps"], f["u_max"], f["dist"])


def pool_offsets(bits: np.ndarray, base: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """Host twin of the pool placement: word offsets (plus `base`) and
    word counts, int64."""
    nw = (bits.astype(np.int64) + 31) >> 5
    return np.cumsum(nw) - nw + base, nw


# ---------------------------------------------------------------------------
# Host serializer (Python twin of the native one): streams -> segment bytes.
# ---------------------------------------------------------------------------

class _BitSrc:
    def __init__(self, words: np.ndarray, nbits: int):
        self.words = words
        self.nbits = int(nbits)
        self.pos = 0

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos += n
        w = p >> 5
        b = p & 31
        lo = int(self.words[w]) >> b
        if b + n > 32 and w + 1 < len(self.words):
            lo |= int(self.words[w + 1]) << (32 - b)
        return lo & ((1 << n) - 1)

    @property
    def remaining(self) -> int:
        return self.nbits - self.pos


def serialize_block(ms_words, ms_bits, vlc_words, vlc_bits,
                    mel_words, mel_bits, numbps) -> Tuple[bytes, int]:
    """Assemble one cleanup segment from a block's packed streams (uint32
    words).  Returns (segment_bytes, numbps); bit-identical to ops/ht.py
    `encode_cleanup`."""
    if numbps == 0:
        return b"", 0

    # MagSgn: LSB-first bytes, 7-bit cap after 0xFF
    src = _BitSrc(ms_words, ms_bits)
    magsgn = bytearray()
    last_ff = False
    while src.remaining > 0:
        cap = 7 if last_ff else 8
        take = min(cap, src.remaining)
        b = src.take(take)
        magsgn.append(b)
        last_ff = (b == 0xFF)

    # MEL: replay events through the adaptive coder
    mel = ht_ref.MELWriter()
    esrc = _BitSrc(mel_words, mel_bits)
    for _ in range(int(mel_bits)):
        mel.encode(esrc.take(1))
    mel.terminate()
    mel_bytes, mel_acc, mel_nb = mel.byte_stream()
    if mel_nb:
        cap = 7 if (mel_bytes and mel_bytes[-1] == 0xFF) else 8
        mel_bytes.append((mel_acc << (cap - mel_nb)) & 0xFF)
    if mel_bytes and mel_bytes[-1] == 0xFF:
        mel_bytes.append(0)

    # VLC: nibble + backward stuffed packing
    vsrc = _BitSrc(vlc_words, vlc_bits)
    nib = vsrc.take(min(3, vsrc.remaining))
    if (nib & 7) != 7 and vsrc.remaining > 0:
        nib |= vsrc.take(1) << 3
    packed = bytearray()
    prev_gt = ((nib << 4) | 0x0F) > 0x8F
    while vsrc.remaining > 0:
        save = vsrc.pos
        chunk7 = vsrc.take(min(7, vsrc.remaining))
        if prev_gt and chunk7 == 0x7F:
            packed.append(0x7F)
            prev_gt = False
        else:
            vsrc.pos = save
            b = vsrc.take(min(8, vsrc.remaining))
            packed.append(b)
            prev_gt = b > 0x8F

    melvlc = bytes(mel_bytes) + bytes(reversed(packed))
    scup = len(melvlc) + 2
    if scup > 4079:
        raise ValueError("cleanup segment too large")
    tail = bytes([(nib << 4) | (scup & 0xF), (scup >> 4) & 0xFF])
    return bytes(magsgn) + melvlc + tail, int(numbps)
