"""A plain writer of the codestreams the benchmark's configurations state:
the counterpart of codestream.py, which reads what this writes.

From the header fields a configuration states (SIZ, CAP, COD, QCD and a
QCC for each component whose steps differ from the first's) and each
component's band values, it writes a J2K codestream of one tile at the
origin: one tile-part, one quality layer, one precinct a resolution, the
packets in LRCP order (ISO/IEC 15444-1 Annex A, B.9-B.10).  Each
code-block is one HT cleanup segment of the reference's own coder
(ht_block.py, ISO/IEC 15444-15), coded at bit-plane 0, so its zero
bit-planes are Mb - 1; a block of zeros is not included.

The controls use it to put the reference, computed in a lower precision,
in the program's place.  Written from the standard for the benchmark; it
imports nothing of the program.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import codestream, ht_block

ORDER_CODE = {v: k for k, v in codestream.ORDERS.items()}


class BitWriter:
    """Packet-header bits, MSB first; a byte after 0xFF carries 7 bits."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0
        self.limit = 8

    def bit(self, b: int) -> None:
        self.cur = (self.cur << 1) | b
        self.n += 1
        if self.n == self.limit:
            self._flush()

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def _flush(self) -> None:
        self.out.append(self.cur)
        self.limit = 7 if self.cur == 0xFF else 8
        self.cur = self.n = 0

    def end(self) -> bytes:
        """The header's bytes, padded with zeros; one stuffed byte after a
        final 0xFF, as the reader skips it."""
        if self.n:
            self.cur <<= self.limit - self.n
            self._flush()
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class TagTreeWriter:
    """Tag-tree encoder (B.10.2) of a ny x nx grid of leaf values."""

    def __init__(self, values: np.ndarray):
        ny, nx = values.shape
        self.dims = [(nx, ny)]
        self.value = [values.reshape(-1).astype(np.int64)]
        while self.dims[-1] != (1, 1):
            w, h = self.dims[-1]
            pw, ph = (w + 1) // 2, (h + 1) // 2
            child = self.value[-1].reshape(h, w)
            pad = np.full((2 * ph, 2 * pw), 1 << 30, np.int64)
            pad[:h, :w] = child
            self.value.append(pad.reshape(ph, 2, pw, 2).min(axis=(1, 3))
                              .reshape(-1))
            self.dims.append((pw, ph))
        self.low = [np.zeros(w * h, np.int64) for w, h in self.dims]
        self.known = [np.zeros(w * h, bool) for w, h in self.dims]

    def encode(self, bw: BitWriter, x: int, y: int, threshold: int) -> None:
        path = []
        for lev, (w, _h) in enumerate(self.dims):
            path.append((lev, y * w + x))
            x, y = x // 2, y // 2
        low = 0
        for lev, i in reversed(path):
            if low > self.low[lev][i]:
                self.low[lev][i] = low
            else:
                low = int(self.low[lev][i])
            while low < threshold:
                if low >= self.value[lev][i]:
                    if not self.known[lev][i]:
                        bw.bit(1)
                        self.known[lev][i] = True
                    break
                bw.bit(0)
                low += 1
            self.low[lev][i] = low


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def _quant_body(style: int, guard: int, steps: Sequence[Tuple[int, int]]
                ) -> bytes:
    if style == 0:
        return bytes([guard << 5]) + bytes(e << 3 for e, _mu in steps)
    return bytes([(guard << 5) | style]) + b"".join(
        struct.pack(">H", (e << 11) | mu) for e, mu in steps)


def main_header(want: Dict) -> bytes:
    """SOC and the main header's SIZ, CAP, COD, QCD and QCCs."""
    ncomp = len(want["precision"])
    ht = bool(want["pcap"])
    siz = struct.pack(">HIIIIIIIIH", 0x4000 if ht else 0, want["width"],
                      want["height"], 0, 0, want["width"], want["height"],
                      0, 0, ncomp)
    for p, s in zip(want["precision"], want["signed"]):
        siz += bytes([(p - 1) | (0x80 if s else 0), 1, 1])
    out = struct.pack(">H", codestream.SOC) + _marker(codestream.SIZ, siz)
    if ht:
        out += _marker(codestream.CAP, struct.pack(">IH", want["pcap"], 0))
    cbx, cby = want["cb_exp"]
    cod = struct.pack(">BBHBBBBBB", 0, ORDER_CODE[want["order"]],
                      want["layers"], want["mct"], want["levels"], cbx - 2,
                      cby - 2, want["cb_style"], want["transform"])
    out += _marker(codestream.COD, cod)
    first = (want["quant_style"][0], want["guard_bits"][0], want["steps"][0])
    out += _marker(codestream.QCD, _quant_body(*first))
    for c in range(1, ncomp):
        mine = (want["quant_style"][c], want["guard_bits"][c],
                want["steps"][c])
        if mine != first:
            out += _marker(codestream.QCC, bytes([c]) + _quant_body(*mine))
    return out


def _packet(bands: List[Tuple[np.ndarray, int]], cb: Tuple[int, int]
            ) -> bytes:
    """One packet of the only layer: header and body of the code-blocks of
    a resolution's bands, each given as (values [h, w], Mb)."""
    cbw, cbh = cb
    coded = []
    for values, mb in bands:
        h, w = values.shape
        if h == 0 or w == 0:
            continue
        ny, nx = -(-h // cbh), -(-w // cbw)
        segs = [[b"" for _x in range(nx)] for _y in range(ny)]
        for y in range(ny):
            for x in range(nx):
                blk = values[y * cbh:(y + 1) * cbh, x * cbw:(x + 1) * cbw]
                seg, numbps, _u = ht_block.encode_cleanup(blk)
                if numbps > mb:
                    raise ValueError(f"a block needs {numbps} bit-planes, "
                                     f"its band has {mb}")
                segs[y][x] = seg
        coded.append((segs, mb))
    if not any(s for segs, _mb in coded for row in segs for s in row):
        return b"\x00"
    bw = BitWriter()
    bw.bit(1)
    body = bytearray()
    for segs, mb in coded:
        ny, nx = len(segs), len(segs[0])
        incl = TagTreeWriter(np.array([[0 if s else 1 for s in row]
                                       for row in segs]))
        zbp = TagTreeWriter(np.full((ny, nx), mb - 1))
        for y in range(ny):
            for x in range(nx):
                seg = segs[y][x]
                incl.encode(bw, x, y, 1)
                if not seg:
                    continue
                zbp.encode(bw, x, y, mb)
                bw.bit(0)                       # one coding pass
                lblock, nbits = 3, max(1, len(seg).bit_length())
                while lblock < nbits:
                    bw.bit(1)
                    lblock += 1
                bw.bit(0)
                bw.bits(len(seg), lblock)
                body += seg
    return bw.end() + bytes(body)


def codestream_of(want: Dict, pyramids: List[Dict[Tuple[int, str],
                                                   np.ndarray]]) -> bytes:
    """The codestream of one frame: `want` the header fields (as
    benchmark.operation.expected_header gives them), `pyramids` each
    component's band values {(resolution, band): [h, w] integers}."""
    if want["layers"] != 1 or want["order"] not in ("LRCP", "RLCP"):
        raise ValueError("the writer makes one layer in LRCP order")
    levels = want["levels"]
    cb = (1 << want["cb_exp"][0], 1 << want["cb_exp"][1])
    order = [(0, "LL")] + [(r, b) for r in range(1, levels + 1)
                           for b in ("HL", "LH", "HH")]
    packets = bytearray()
    for r in range(levels + 1):
        for c, pyr in enumerate(pyramids):
            bands = []
            for name in (("LL",) if r == 0 else ("HL", "LH", "HH")):
                eps = want["steps"][c][order.index((r, name))][0]
                mb = want["guard_bits"][c] + eps - 1
                bands.append((np.asarray(pyr[(r, name)], np.int64), mb))
            packets += _packet(bands, cb)
    psot = 12 + 2 + len(packets)
    sot = struct.pack(">HHHIBB", codestream.SOT, 10, 0, psot, 0, 1)
    return (main_header(want) + sot + struct.pack(">H", codestream.SOD)
            + bytes(packets) + struct.pack(">H", codestream.EOC))
