"""HTJ2K cleanup-pass block coder (ISO/IEC 15444-15, T.814 section 7).

A frozen copy of the cleanup encoder and decoder of
go_jpeg2000_tpu_torch/ops/ht.py (a from-scratch FBCOT coder validated
against OpenJPEG), cut to the cleanup pass.  The benchmark keeps its own
copy so that a later change to the program cannot move the yardstick.
Plain Python and NumPy; it imports nothing of the program.

Structure per T.814:
- samples map to 2x2 quads, column-major in-quad order (n0=TL, n1=BL,
  n2=TR, n3=BR); quads process in pairs along 2-row stripes
- three sub-bitstreams in one codeword segment:
  MagSgn (forward, LSB-first, stuff after 0xFF) | MEL (forward, MSB-first,
  stuff after 0xFF) | VLC (backward, LSB-first, stuffing keyed on >0x8F);
  last 2 bytes carry the 12-bit SCUP = len(MEL+VLC)
- CxtVLC tables code (rho, u_off, EMB e_1/e_k) per quad conditioned on a
  3-bit neighborhood context; MEL codes AZC-quad significance and the
  initial-stripe "both u > 2" event; UVLC codes u values
- MagSgn codes v_n = 2*(mu_n - 1) + sign over m_n = U_q - e_k(n) bits with
  the omitted MSB given by e_1(n)
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_TBL = np.load(os.path.join(os.path.dirname(__file__), "ht_tables.npz"))
DEC_TBL0 = _TBL["dec0"]        # initial stripe
DEC_TBL1 = _TBL["dec1"]        # non-initial stripes

# encoder maps: (ctx, rho, u_off) -> list of (e1, ek, cwd, len)
def _build_enc(keys, vals):
    out = {}
    for k, v in zip(keys, vals):
        ctx = (int(k) >> 13) & 0x7
        rho = (int(k) >> 9) & 0xF
        uoff = (int(k) >> 8) & 1
        e1 = (int(k) >> 4) & 0xF
        ek = int(k) & 0xF
        cwd = int(v) & 0xFF
        ln = (int(v) >> 8) & 0xF
        out.setdefault((ctx, rho, uoff), []).append((e1, ek, cwd, ln))
    return out

ENC_TBL0 = _build_enc(_TBL["enc0_keys"], _TBL["enc0_vals"])
ENC_TBL1 = _build_enc(_TBL["enc1_keys"], _TBL["enc1_vals"])

MEL_E = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5]

# Line-state semantics (T.814 §7.3.6-7.3.9, pinned and locked; formerly six
# empirically-probed HT_TUNE knobs, resolved r4 and inlined below):
#   - line-state entry i straddles quad boundaries, covering sample columns
#     (2i-1, 2i): quad q's bottom-left (n1, col 2q) writes entry q and its
#     bottom-right (n3, col 2q+1) writes entry q+1, so the two entries a
#     quad reads in the next stripe (q and q+1) together span its four
#     upper neighbors — _update_ls
#   - when two samples map to one entry (n3 of quad q and n1 of quad q+1,
#     cols 2q+1 and 2q+2), significance ORs and exponents MAX-merge
#   - stored exponent is E_n = bitlen(v_n) of the coded magnitude (no
#     minimum clamp for significant samples)
#   - non-initial context: bit0 = N (entry q), bit1 = W (right column of
#     the left quad's rho), bit2 = NE (entry q+1) — _ctx_noninit*
#   - kappa_q = max(1, E_max - 1) gated by gamma_q (popcount(rho_q) > 1),
#     with E_max taken over BOTH entries q and q+1 — _kappa2
# All six are jointly pinned by the OpenJPEG cross-decode batteries in
# tests/test_ht.py + tests/test_ht_refinement.py (any flip breaks them).

# ---------------------------------------------------------------------------
# bit-level writers
# ---------------------------------------------------------------------------

class MagSgnWriter:
    """Forward, LSB-first bit packing; 7-bit byte after an 0xFF."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0
        self.last_ff = False

    def put(self, value: int, nbits: int) -> None:
        self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits
        self._drain()

    def _cap(self) -> int:
        return 7 if self.last_ff else 8

    def _drain(self) -> None:
        while self.nbits >= self._cap():
            cap = self._cap()
            b = self.acc & ((1 << cap) - 1)
            self.acc >>= cap
            self.nbits -= cap
            self.buf.append(b)
            self.last_ff = (b == 0xFF)

    def flush(self) -> bytes:
        if self.nbits > 0:
            cap = self._cap()
            self.buf.append(self.acc & ((1 << cap) - 1))
            self.acc = 0
            self.nbits = 0
            # trailing partial byte padded with 0s; can't be 0xFF
        # drop trailing zero bytes?  No — decoder feeds 0xFF at end; trailing
        # zeros are significant.  Keep as-is.
        return bytes(self.buf)


class MELWriter:
    """MEL adaptive run-length coder; bits packed MSB-first, 7-bit byte
    after 0xFF."""

    def __init__(self):
        self.k = 0
        self.run = 0
        self.bits: List[int] = []

    def encode(self, event: int) -> None:
        thresh = 1 << MEL_E[self.k]
        if event == 0:
            self.run += 1
            if self.run == thresh:
                self.bits.append(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self.bits.append(0)
            for i in range(MEL_E[self.k] - 1, -1, -1):
                self.bits.append((self.run >> i) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)

    def terminate(self) -> None:
        if self.run > 0:
            # pretend the run completes (decoder reads surplus zero events)
            self.bits.append(1)
            self.run = 0

    def byte_stream(self) -> Tuple[bytearray, int]:
        """Pack bits to bytes; returns (bytes, used_bits_in_last_byte)."""
        out = bytearray()
        acc = 0
        n = 0
        last_ff = False
        for b in self.bits:
            cap = 7 if last_ff else 8
            acc = (acc << 1) | b
            n += 1
            if n == cap:
                out.append(acc)
                last_ff = (acc == 0xFF)
                acc = 0
                n = 0
        return out, acc, n


class VLCWriter:
    """Backward-growing VLC stream: collects bits (LSB-first read order);
    stuffing-aware byte packing happens once at segment assembly.  The T.814
    rule: a byte following one with value > 0x8F holds only 7 bits iff those
    7 bits are all ones (so 0xFF 0x7F-style sequences never alias markers)."""

    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, nbits: int) -> None:
        for i in range(nbits):
            self.bits.append((value >> i) & 1)


# ---------------------------------------------------------------------------
# bit-level readers (faithful to the T.814 procedures; layout matches the
# reference's ported readers, ht.go:153-560)
# ---------------------------------------------------------------------------

class MELReader:
    def __init__(self, data: bytes, start: int, size: int):
        self.data = data
        self.pos = start
        self.size = size          # scup - 1
        self.tmp = 0
        self.bits = 0
        self.unstuff = False
        self.k = 0
        self.runs: List[int] = []
        num = min(4, 4 - (self.pos & 3))
        for _ in range(num):
            if self.size <= 0:
                break
            b = self.data[self.pos] if self.pos < len(self.data) else 0xFF
            self.pos += 1
            self.size -= 1
            if self.size == 1:
                b |= 0x0F
            dbits = 7 if self.unstuff else 8
            self.tmp = (self.tmp << dbits) | b
            self.bits += dbits
            self.unstuff = (b == 0xFF)
        self.tmp <<= (64 - self.bits)

    def _read(self) -> None:
        if self.bits > 32:
            return
        for _ in range(4):
            if self.size <= 0:
                b = 0xFF
            else:
                b = self.data[self.pos] if self.pos < len(self.data) else 0xFF
                self.pos += 1
                self.size -= 1
                if self.size == 1:
                    b |= 0x0F
            dbits = 7 if self.unstuff else 8
            # a stuffed byte carries its data in the LOW 7 bits (bit7 = 0);
            # place its top data bit at the next free slot (63 - bits)
            self.tmp |= b << (56 - self.bits + (8 - dbits))
            self.bits += dbits
            self.unstuff = (b == 0xFF)

    def _decode(self) -> None:
        if self.bits < 6:
            self._read()
        while self.bits >= 6 and len(self.runs) < 8:
            eval_ = MEL_E[self.k]
            if self.tmp & (1 << 63):
                run = ((1 << eval_) - 1) << 1   # full run, not terminated
                self.k = min(12, self.k + 1)
                self.tmp = (self.tmp << 1) & ((1 << 64) - 1)
                self.bits -= 1
            else:
                run = (self.tmp >> (63 - eval_)) & ((1 << eval_) - 1)
                self.k = max(0, self.k - 1)
                self.tmp = (self.tmp << (eval_ + 1)) & ((1 << 64) - 1)
                self.bits -= eval_ + 1
                run = (run << 1) + 1            # terminated by a one
            self.runs.append(run)

    def get_run(self) -> int:
        if not self.runs:
            self._decode()
        return self.runs.pop(0)


class RevReader:
    """Backward bitstream (VLC / MRP)."""

    def __init__(self, data: bytes, pos: int, size: int, mrp: bool = False):
        self.data = data
        self.pos = pos
        self.size = size
        self.tmp = 0
        self.bits = 0
        # MRP streams start with unstuff=True (the byte "before" the segment
        # end is treated as stuffed; reference initMRP ht.go:527).
        self.unstuff = bool(mrp)
        if not mrp:
            # VLC: first half-byte from the byte at pos (below the SCUP nibble)
            b = data[self.pos] if 0 <= self.pos < len(data) else 0
            self.pos -= 1
            self.tmp = b >> 4
            # the nibble carries 4 bits unless its low 3 bits are all ones
            # (then only 3 count; bit3 is left 0 by the encoder)
            self.bits = 3 if (self.tmp & 7) == 7 else 4
            self.unstuff = (b | 0x0F) > 0x8F
        num = min(1 + (self.pos & 3), max(0, self.size))
        for _ in range(num):
            b = self.data[self.pos] if 0 <= self.pos < len(self.data) else 0
            self.pos -= 1
            dbits = 7 if (self.unstuff and (b & 0x7F) == 0x7F) else 8
            self.tmp |= b << self.bits
            self.bits += dbits
            self.unstuff = b > 0x8F
        self.size -= num
        self._read()

    def _read(self) -> None:
        if self.bits > 32:
            return
        # gather up to 4 bytes moving backward
        got = []
        take = min(4, max(0, self.size))
        for i in range(take):
            p = self.pos - i
            got.append(self.data[p] if 0 <= p < len(self.data) else 0)
        self.pos -= take
        self.size -= take
        while len(got) < 4:
            got.append(0)
        for b in got:
            dbits = 7 if (self.unstuff and (b & 0x7F) == 0x7F) else 8
            self.tmp |= b << self.bits
            self.bits += dbits
            self.unstuff = b > 0x8F

    def fetch(self) -> int:
        if self.bits < 32:
            self._read()
            if self.bits < 32:
                self._read()
        return self.tmp & 0xFFFFFFFF

    def advance(self, n: int) -> None:
        self.tmp >>= n
        self.bits -= n


class FwdReader:
    """Forward bitstream (MagSgn / SPP); feeds `fill` when exhausted."""

    def __init__(self, data: bytes, start: int, size: int, fill: int = 0xFF):
        self.data = data
        self.pos = start
        self.size = size
        self.tmp = 0
        self.bits = 0
        self.unstuff = False
        self.fill = fill
        num = 4 - (self.pos & 3)
        for _ in range(num):
            if self.size > 0 and self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
                self.size -= 1
            elif self.size > 0:
                b = self.fill
                self.size -= 1
            else:
                b = self.fill
            dbits = 7 if self.unstuff else 8
            self.tmp |= b << self.bits
            self.bits += dbits
            self.unstuff = (b == 0xFF)

    def _read(self) -> None:
        if self.bits > 32:
            return
        for _ in range(4):
            if self.size > 0 and self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
                self.size -= 1
            elif self.size > 0:
                b = self.fill
                self.size -= 1
            else:
                b = self.fill
            dbits = 7 if self.unstuff else 8
            self.tmp |= b << self.bits
            self.bits += dbits
            self.unstuff = (b == 0xFF)

    def fetch(self) -> int:
        if self.bits < 32:
            self._read()
            if self.bits < 32:
                self._read()
        return self.tmp & 0xFFFFFFFF

    def advance(self, n: int) -> None:
        self.tmp >>= n
        self.bits -= n


# ---------------------------------------------------------------------------
# UVLC (u-value) coding
# ---------------------------------------------------------------------------

# prefix code for the biased value t (>=1):
#   t=1: '1' (1 bit); t=2: '10'->? coded LSB-first as reader sees 3-bit window
# Decoder windows (3 LSBs): xx1 -> t=1; x10 -> t=2; 100 -> t=3+suffix(1);
# 000 -> t=5+suffix(5).
def _uvlc_encode_value(t: int) -> Tuple[int, int, int, int]:
    """Returns (prefix_bits, prefix_len, suffix_bits, suffix_len) for biased
    value t >= 1 (t = u_q for kappa-folded initial coding)."""
    if t == 1:
        return 1, 1, 0, 0
    if t == 2:
        return 2, 2, 0, 0       # bits '10' LSB-first => reader sees ..10
    if t in (3, 4):
        return 4, 3, t - 3, 1   # prefix '100' (LSB-first value 4)
    if 5 <= t <= 36:
        return 0, 3, t - 5, 5   # prefix '000'
    raise ValueError(f"u value {t} out of range")


def _uvlc_decode_prefix(window: int) -> Tuple[int, int, int]:
    """window = next 3 VLC bits (LSB = first).  Returns
    (prefix_len, suffix_len, base)."""
    if window & 1:
        return 1, 0, 1
    if (window & 3) == 2:
        return 2, 0, 2
    if window == 4:
        return 3, 1, 3
    return 3, 5, 5


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _exponent(v: int) -> int:
    return v.bit_length()


def encode_cleanup(coeffs: np.ndarray) -> Tuple[bytes, int, int]:
    """Encode one code-block's HT cleanup segment.

    Returns (segment_bytes, num_bitplanes, u_max) where u_max is the
    maximum U_q over all quads (the packet header's HT missing-MSB field
    signals U_max - 1 so decoders can bound U_q)."""
    coeffs = np.asarray(coeffs, dtype=np.int64)
    h, w = coeffs.shape
    mags = np.abs(coeffs)
    numbps = int(mags.max()).bit_length() if mags.size else 0
    if numbps == 0:
        return b"", 0, 0
    u_max = 1

    qw = (w + 1) // 2
    qh = (h + 1) // 2

    # per-sample v, sigma
    def sample(x, y):
        if x >= w or y >= h:
            return 0, 0, 0   # v, sig, E
        c = int(coeffs[y, x])
        if c == 0:
            return 0, 0, 0
        v = ((abs(c) - 1) << 1) | (1 if c < 0 else 0)
        return v, 1, _exponent(v)

    mel = MELWriter()
    vlc = VLCWriter()
    mag = MagSgnWriter()

    # line state: per quad column, from the previous stripe:
    #   sigma of the two bottom samples and their max E
    prev_sig = [0] * (qw + 1)      # 2-bit: bit0 = bottom-left, bit1 = bottom-right
    prev_E = [0] * (qw + 1)        # max E of the two bottom samples

    for qy in range(qh):
        initial = qy == 0
        enc_tbl = ENC_TBL0 if initial else ENC_TBL1
        y0 = qy * 2
        cur_sig = [0] * (qw + 1)
        cur_E = [0] * (qw + 1)
        # context of the first quad: 0 on the initial stripe; from the
        # previous stripe's line state otherwise
        c_q = 0 if initial else _ctx_noninit(0, prev_sig, 0)
        qx = 0
        while qx < qw:
            # gather the pair of quads
            pair = []
            for j in range(2):
                x0 = (qx + j) * 2
                if qx + j >= qw:
                    pair.append(None)
                    continue
                vs = []
                rho = 0
                Emax = 0
                for i, (dx, dy) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                    v, sig, E = sample(x0 + dx, y0 + dy)
                    vs.append((v, sig, E))
                    rho |= sig << i
                    Emax = max(Emax, E)
                pair.append((rho, vs, Emax))

            qinfos = []
            for j in range(2):
                if pair[j] is None:
                    qinfos.append(None)
                    continue
                rho, vs, Emax = pair[j]
                if j == 0:
                    ctx = c_q
                else:
                    ctx = _ctx_second(pair[0][0], qx, prev_sig, initial)
                # AZC quad: MEL codes significance
                if ctx == 0:
                    mel.encode(1 if rho else 0)
                    if rho == 0:
                        qinfos.append((rho, vs, Emax, 0, 0, 0, ctx, False))
                        continue
                else:
                    if rho == 0:
                        # non-AZC quads always emit a VLC codeword (rho=0 ok)
                        pass
                qinfos.append((rho, vs, Emax, None, None, None, ctx, True))

            # kappa per quad
            kappas = []
            for j in range(2):
                if pair[j] is None or qinfos[j] is None:
                    kappas.append(1)
                    continue
                rho = pair[j][0]
                if initial:
                    kappas.append(1)
                else:
                    kappas.append(_kappa2(rho, prev_E, qx + j))

            # U and u_off per quad
            us = []
            for j in range(2):
                if pair[j] is None or not qinfos[j][7]:
                    us.append((1, 0, 1))  # U, u_off, kappa (unused)
                    continue
                rho, vs, Emax = pair[j]
                kappa = kappas[j]
                U = max(kappa, Emax)
                u_q = U - kappa
                u_max = max(u_max, U)
                us.append((U, 1 if u_q > 0 else 0, kappa))

            # emit VLC codewords (quad 0 then quad 1), tracking eps patterns
            for j in range(2):
                if pair[j] is None or not qinfos[j][7]:
                    continue
                rho, vs, Emax = pair[j]
                U, u_off, kappa = us[j]
                ctx = qinfos[j][6]
                # eps pattern: which significant samples attain E == U
                eps = 0
                for i, (v, sig, E) in enumerate(vs):
                    if sig and E == U:
                        eps |= 1 << i
                cands = enc_tbl.get((ctx, rho, u_off))
                if not cands:
                    raise ValueError(f"no VLC entry for ctx={ctx} rho={rho:x} "
                                     f"u_off={u_off}")
                best = None
                for (e1, ek, cwd, ln) in cands:
                    # validity: for ek bits, e1 must equal the actual MSB
                    ok = True
                    for i in range(4):
                        if (ek >> i) & 1:
                            if not ((rho >> i) & 1):
                                ok = False
                                break
                            actual = (vs[i][0] >> (U - 1)) & 1 if U >= 1 else 0
                            if ((e1 >> i) & 1) != actual:
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
                    raise ValueError(f"no valid VLC entry ctx={ctx} rho={rho:x} "
                                     f"u_off={u_off} eps={eps:x}")
                _, e1, ek, cwd, ln = best
                vlc.put(cwd, ln)
                qinfos[j] = (rho, vs, Emax, e1, ek, U, ctx, True)

            # u coding
            active = [j for j in range(2)
                      if pair[j] is not None and qinfos[j][7]]
            uoffs = [us[j][1] if j in active else 0 for j in range(2)]
            mode = uoffs[0] | (uoffs[1] << 1)
            if initial:
                if mode == 3:
                    u0 = us[0][0] - 1   # u_q since kappa=1: biased t = u_q
                    u1 = us[1][0] - 1
                    both_big = u0 > 2 and u1 > 2
                    mel.encode(1 if both_big else 0)
                    if both_big:
                        # mode 4: t = u - 2
                        p0, pl0, s0, sl0 = _uvlc_encode_value(u0 - 2)
                        p1, pl1, s1, sl1 = _uvlc_encode_value(u1 - 2)
                        vlc.put(p0, pl0)
                        vlc.put(p1, pl1)
                        vlc.put(s0, sl0)
                        vlc.put(s1, sl1)
                    else:
                        if u0 > 2:
                            # prefix for u0 (len 3), then 1 bit u1-1 (u1 in 1,2)
                            p0, pl0, s0, sl0 = _uvlc_encode_value(u0)
                            assert pl0 == 3
                            vlc.put(p0, pl0)
                            vlc.put(u1 - 1, 1)
                            vlc.put(s0, sl0)
                        else:
                            p0, pl0, s0, sl0 = _uvlc_encode_value(u0)
                            p1, pl1, s1, sl1 = _uvlc_encode_value(u1)
                            vlc.put(p0, pl0)
                            vlc.put(p1, pl1)
                            vlc.put(s0, sl0)
                            vlc.put(s1, sl1)
                elif mode in (1, 2):
                    u = us[0][0] - 1 if mode == 1 else us[1][0] - 1
                    p, pl, s, sl = _uvlc_encode_value(u)
                    vlc.put(p, pl)
                    vlc.put(s, sl)
            else:
                if mode == 3:
                    u0 = us[0][0] - us[0][2]
                    u1 = us[1][0] - us[1][2]
                    p0, pl0, s0, sl0 = _uvlc_encode_value(u0)
                    p1, pl1, s1, sl1 = _uvlc_encode_value(u1)
                    vlc.put(p0, pl0)
                    vlc.put(p1, pl1)
                    vlc.put(s0, sl0)
                    vlc.put(s1, sl1)
                elif mode in (1, 2):
                    j = 0 if mode == 1 else 1
                    u = us[j][0] - us[j][2]
                    p, pl, s, sl = _uvlc_encode_value(u)
                    vlc.put(p, pl)
                    vlc.put(s, sl)

            # MagSgn
            for j in range(2):
                if pair[j] is None or not qinfos[j][7]:
                    continue
                rho, vs, Emax, e1, ek, U, ctx, _ = qinfos[j]
                if rho == 0:
                    continue
                for i in range(4):
                    if (rho >> i) & 1:
                        m_n = U - ((ek >> i) & 1)
                        v = vs[i][0]
                        mag.put(v & ((1 << m_n) - 1), m_n)

            # update per-column state + next context
            for j in range(2):
                if pair[j] is None:
                    continue
                rho = pair[j][0] if qinfos[j] is None else qinfos[j][0]
                vs = pair[j][1]
                _update_ls(cur_sig, cur_E, qx + j, rho, vs[1][2], vs[3][2])
            # context of the next pair's first quad
            last = qinfos[1] if pair[1] is not None else qinfos[0]
            last_rho = last[0] if last is not None else 0
            if initial:
                c_q = _ctx_initial_next(last_rho)
            else:
                c_q = _ctx_noninit(qx + 2, prev_sig, last_rho)
            qx += 2

        prev_sig = cur_sig
        prev_E = cur_E

    # --------------- assemble segment ---------------
    mel.terminate()
    mel_bytes, mel_acc, mel_nbits = mel.byte_stream()
    # flush partial MEL byte (pad with 1s? use 0s; decoder reads surplus)
    if mel_nbits:
        cap = 7 if (mel_bytes and mel_bytes[-1] == 0xFF) else 8
        mel_bytes.append((mel_acc << (cap - mel_nbits)) & 0xFF)
    if mel_bytes and mel_bytes[-1] == 0xFF:
        mel_bytes.append(0)

    # VLC packing.  The decoder's first access reads the top nibble of
    # data[-2] (4 bits, or 3 when the nibble's bit2 is 1); subsequent bytes
    # run backward with conditional stuffing: after a byte > 0x8F, the next
    # byte holds 7 bits iff its low 7 bits are all ones.
    bits = list(vlc.bits)
    nib = 0
    for i in range(3):
        if i < len(bits):
            nib |= bits[i] << i
    if (nib & 7) == 7:
        rest = bits[3:]        # 3-bit nibble (all-ones marker), bit3 stays 0
    else:
        if len(bits) >= 4:
            nib |= bits[3] << 3
        rest = bits[4:]
    packed = bytearray()
    prev_gt = ((nib << 4) | 0x0F) > 0x8F   # decoder unstuff state after nibble
    pos = 0
    while pos < len(rest):
        chunk7 = 0
        for i in range(7):
            if pos + i < len(rest):
                chunk7 |= rest[pos + i] << i
        if prev_gt and chunk7 == 0x7F:
            packed.append(0x7F)
            pos += 7
            prev_gt = False
        else:
            b = 0
            for i in range(8):
                if pos + i < len(rest):
                    b |= rest[pos + i] << i
            packed.append(b)
            pos += 8
            prev_gt = b > 0x8F

    melvlc = bytes(mel_bytes) + bytes(reversed(packed))
    scup = len(melvlc) + 2
    if scup > 4079:
        raise ValueError("cleanup segment too large")
    magsgn = mag.flush()
    tail = bytes([(nib << 4) | (scup & 0xF), (scup >> 4) & 0xFF])
    return magsgn + melvlc + tail, numbps, u_max


# context helpers (candidate formulas; validated/adjusted by oracle probing)

def _ctx_initial_next(rho_prev: int) -> int:
    """Initial stripe: context of a quad from its left neighbor's rho:
    bit0 = left column any-sig, bit1 = top-right, bit2 = bottom-right
    (T.814 eq. 1; OpenJPEG: ((qinf & 0x10) >> 4) | ((qinf & 0xE0) >> 5))."""
    return ((rho_prev & 1) | (rho_prev >> 1)) & 0x7


def _ctx_second(rho_first: int, qx: int, prev_sig, initial: bool) -> int:
    """Context of the second quad of a pair."""
    if initial:
        return _ctx_initial_next(rho_first)
    return _ctx_noninit_second(rho_first, qx, prev_sig)


def _ls_at(prev_sig, i):
    return prev_sig[i] if 0 <= i < len(prev_sig) else 0


def _ctx_noninit(qx: int, prev_sig, w_rho: int) -> int:
    """Non-initial stripe first-quad context: bit0 = N (line-state entry
    qx), bit1 = W (previous quad's right column, from its full rho),
    bit2 = NE (entry qx + 1).  Entry i covers columns (2i-1, 2i)."""
    w = 1 if (w_rho & 0xC) else 0
    n = 1 if _ls_at(prev_sig, qx) else 0
    ne = 1 if _ls_at(prev_sig, qx + 1) else 0
    return n | (w << 1) | (ne << 2)


def _ctx_noninit_second(rho_first: int, qx: int, prev_sig) -> int:
    """Second quad of a pair: same formula, entries qx+1 / qx+2."""
    w = 1 if (rho_first & 0xC) else 0    # right column of first quad
    n = 1 if _ls_at(prev_sig, qx + 1) else 0
    ne = 1 if _ls_at(prev_sig, qx + 2) else 0
    return n | (w << 1) | (ne << 2)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def decode_cleanup(data: bytes, w: int, h: int, numbps: int) -> np.ndarray:
    """Decode one HT cleanup segment to signed coefficients [h, w]."""
    out = np.zeros((h, w), dtype=np.int32)
    if numbps == 0 or len(data) < 2:
        return out
    lcup = len(data)
    scup = (data[lcup - 1] << 4) | (data[lcup - 2] & 0x0F)
    if scup < 2 or scup > lcup or scup > 4079:
        raise ValueError(f"invalid SCUP {scup}")

    mel = MELReader(data, lcup - scup, scup - 1)
    vlc = RevReader(data, lcup - 2, scup - 2)
    mag = FwdReader(data, 0, lcup - scup, fill=0xFF)

    qw = (w + 1) // 2
    qh = (h + 1) // 2
    prev_sig = [0] * (qw + 2)
    prev_E = [0] * (qw + 2)
    run = -1   # current MEL run state (-1 = none fetched)
    run_val = 0

    def mel_event() -> int:
        nonlocal run, run_val
        if run < 0:
            run_val = mel.get_run()
            run = run_val >> 1
        if run > 0:
            run -= 1
            if run == 0 and not (run_val & 1):
                run = -1
            return 0
        # run == 0
        sig = run_val & 1
        run = -1
        return sig

    # NOTE on MEL event semantics: get_run returns (zeros << 1) | terminated.
    # Each event consumes one "slot": `zeros` insignificant events, then (if
    # terminated) one significant event.
    def mel_event2() -> int:
        nonlocal run, run_val
        if run < 0:
            run_val = mel.get_run()
            run = run_val
        run -= 2
        if run < 0:
            sig = 1 if run == -1 else 0
            run = -1
            return sig
        return 0

    for qy in range(qh):
        initial = qy == 0
        dec_tbl = DEC_TBL0 if initial else DEC_TBL1
        y0 = qy * 2
        cur_sig = [0] * (qw + 2)
        cur_E = [0] * (qw + 2)
        c_q = 0 if initial else _ctx_noninit(0, prev_sig, 0)
        qx = 0
        while qx < qw:
            qinfos = [None, None]
            rhos = [0, 0]
            e1s = [0, 0]
            eks = [0, 0]
            uoffs = [0, 0]
            coded = [False, False]
            for j in range(2):
                if qx + j >= qw:
                    continue
                ctx = c_q if j == 0 else (
                    _ctx_second(rhos[0], qx, prev_sig, initial))
                sig = 1
                if ctx == 0:
                    sig = mel_event2()
                if not sig:
                    rhos[j] = 0
                    coded[j] = False
                else:
                    window = vlc.fetch() & 0x7F
                    e = int(dec_tbl[(ctx << 7) | window])
                    ln = e & 0x7
                    if ln == 0:
                        raise ValueError("invalid VLC codeword")
                    vlc.advance(ln)
                    rhos[j] = (e >> 4) & 0xF
                    uoffs[j] = (e >> 3) & 1
                    e1s[j] = (e >> 8) & 0xF
                    eks[j] = (e >> 12) & 0xF
                    coded[j] = True

            # u decode
            mode = (uoffs[0] | (uoffs[1] << 1))
            U = [1, 1]
            kappa = [1, 1]
            for j in range(2):
                if not initial and coded[j]:
                    kappa[j] = _kappa2(rhos[j], prev_E, qx + j)
            # Prefixes and suffixes interleave in a fixed stream order;
            # decode explicitly by mode:
            if mode == 0:
                pass
            elif mode in (1, 2):
                t = _uvlc_dec(vlc)
                j = 0 if mode == 1 else 1
                U[j] = t + kappa[j] if not initial else t + 1
            else:  # mode == 3
                if initial:
                    big = mel_event2()
                    if big:
                        pl0, sl0, base0 = _uvlc_dec_prefix(vlc)
                        pl1, sl1, base1 = _uvlc_dec_prefix(vlc)
                        s0 = _take(vlc, sl0)
                        s1 = _take(vlc, sl1)
                        U[0] = base0 + s0 + 2 + 1
                        U[1] = base1 + s1 + 2 + 1
                    else:
                        pl0, sl0, base0 = _uvlc_dec_prefix(vlc)
                        if pl0 > 2:
                            u1m = _take(vlc, 1)
                            s0 = _take(vlc, sl0)
                            U[0] = base0 + s0 + 1
                            U[1] = u1m + 1 + 1
                        else:
                            pl1, sl1, base1 = _uvlc_dec_prefix(vlc)
                            s0 = _take(vlc, sl0)
                            s1 = _take(vlc, sl1)
                            U[0] = base0 + s0 + 1
                            U[1] = base1 + s1 + 1
                else:
                    pl0, sl0, base0 = _uvlc_dec_prefix(vlc)
                    pl1, sl1, base1 = _uvlc_dec_prefix(vlc)
                    s0 = _take(vlc, sl0)
                    s1 = _take(vlc, sl1)
                    U[0] = base0 + s0 + kappa[0]
                    U[1] = base1 + s1 + kappa[1]
            # u_off == 0 quads: U = kappa
            for j in range(2):
                if coded[j] and not uoffs[j]:
                    U[j] = kappa[j] if not initial else 1

            # MagSgn decode
            for j in range(2):
                if qx + j >= qw or not coded[j] or rhos[j] == 0:
                    continue
                x0 = (qx + j) * 2
                Uq = U[j]
                Es = [0, 0, 0, 0]
                for i, (dx, dy) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                    if (rhos[j] >> i) & 1:
                        m_n = Uq - ((eks[j] >> i) & 1)
                        val = mag.fetch() & ((1 << m_n) - 1) if m_n else 0
                        if m_n:
                            mag.advance(m_n)
                        v = val | (((e1s[j] >> i) & 1) << m_n)
                        mu = (v >> 1) + 1
                        sgn = v & 1
                        xx, yy = x0 + dx, y0 + dy
                        if xx < w and yy < h:
                            out[yy, xx] = -mu if sgn else mu
                        Es[i] = _exponent(v)
                # line state update
                _update_ls(cur_sig, cur_E, qx + j, rhos[j], Es[1], Es[3])

            # next first-quad context
            last_rho = rhos[1] if qx + 1 < qw else rhos[0]
            if initial:
                c_q = _ctx_initial_next(last_rho)
            else:
                c_q = _ctx_noninit(qx + 2, prev_sig, last_rho)
            qx += 2

        prev_sig = cur_sig
        prev_E = cur_E

    return out


class _NeedStreamOrder(Exception):
    pass


def _take(vlc: RevReader, n: int) -> int:
    if n == 0:
        return 0
    v = vlc.fetch() & ((1 << n) - 1)
    vlc.advance(n)
    return v


def _uvlc_dec_prefix(vlc: RevReader) -> Tuple[int, int, int]:
    window = vlc.fetch() & 0x7
    pl, sl, base = _uvlc_decode_prefix(window)
    vlc.advance(pl)
    return pl, sl, base


def _uvlc_dec(vlc: RevReader) -> int:
    pl, sl, base = _uvlc_dec_prefix(vlc)
    return base + _take(vlc, sl)


def _update_ls(cur_sig, cur_E, q, rho, e_n1, e_n3):
    """Line-state update for quad q (T.814 §7.3.9 semantics, see the pinned
    block at the top of this file): entry i covers columns (2i-1, 2i), so
    n1 (col 2q) writes entry q and n3 (col 2q+1) writes entry q+1; when two
    samples share an entry, significance ORs and exponents MAX-merge."""
    if rho & 0x2:
        cur_sig[q] |= 1
        cur_E[q] = max(cur_E[q], e_n1)
    if rho & 0x8:
        cur_sig[q + 1] |= 1
        cur_E[q + 1] = max(cur_E[q + 1], e_n3)


def _kappa2(rho, prev_E, q):
    """kappa_q (T.814 §7.3.7): 1 unless gamma_q (more than one significant
    sample in the quad), else max(1, E_max - 1) with E_max over the two
    line-state entries (q, q+1) spanning the quad's upper neighbors."""
    gamma = 1 if (rho & (rho - 1)) else 0
    if not gamma:
        return 1
    ea = prev_E[q] if q < len(prev_E) else 0
    eb = prev_E[q + 1] if q + 1 < len(prev_E) else 0
    return max(1, max(ea, eb) - 1)
