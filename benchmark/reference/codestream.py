"""A plain reader of the codestreams the benchmark's configurations make.

It reads a J2K codestream of one tile at the origin (ISO/IEC 15444-1
Annex A markers, B.9-B.10 packet headers): the main header's SIZ, CAP,
COD, QCD and QCC, the one tile-part, and the packets of the one quality
layer in LRCP or RLCP order with one precinct a resolution.  It returns
every code-block's zero bit-planes, coding passes and codeword bytes, so
that the reference can decode them with its own HT block decoder.

Written from the standard for the benchmark; it imports nothing of the
program.  Anything outside that scope raises ValueError, which the
benchmark counts as a frame that does not parse.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

import numpy as np

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, CAP, COD, QCD, QCC = 0xFF51, 0xFF50, 0xFF52, 0xFF5C, 0xFF5D
ORDERS = {0: "LRCP", 1: "RLCP", 2: "RPCL", 3: "PCRL", 4: "CPRL"}


@dataclasses.dataclass
class Main:
    width: int
    height: int
    x_offset: int
    y_offset: int
    tile_width: int
    tile_height: int
    precision: List[int]
    signed: List[bool]
    scod: int
    order: str
    layers: int
    mct: int
    levels: int
    cb_exp: Tuple[int, int]          # (width, height) exponents
    cb_style: int
    transform: int                   # 1 reversible 5/3, 0 irreversible 9/7
    guard_bits: List[int]            # per component
    quant_style: List[int]           # per component: 0 none, 2 expounded
    steps: List[List[Tuple[int, int]]]   # per component: (exponent, mantissa)
    pcap: int
    other_markers: List[int]


@dataclasses.dataclass
class Block:
    comp: int
    res: int
    band: str
    x0: int                          # in band coordinates
    y0: int
    w: int
    h: int
    zero_bitplanes: int = 0
    passes: int = 0
    data: bytes = b""


class BitReader:
    """Packet-header bits, MSB first; a byte after 0xFF carries 7 bits."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.byte = 0
        self.left = 0

    def bit(self) -> int:
        if self.left == 0:
            stuffed = self.byte == 0xFF
            if self.pos >= len(self.data):
                raise ValueError("packet header runs past the tile data")
            self.byte = self.data[self.pos]
            self.pos += 1
            self.left = 7 if stuffed else 8
        self.left -= 1
        return (self.byte >> self.left) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def end(self) -> int:
        """Position of the packet body: a header that ends on 0xFF is
        followed by one stuffed byte."""
        if self.byte == 0xFF:
            self.pos += 1
        self.left = 0
        return self.pos


class TagTree:
    """Tag-tree decoder (B.10.2) over a w x h grid of leaves."""

    def __init__(self, w: int, h: int):
        self.dims = [(w, h)]
        while self.dims[-1] != (1, 1):
            w, h = self.dims[-1]
            self.dims.append(((w + 1) // 2, (h + 1) // 2))
        self.value = [np.full(w * h, 1 << 30, np.int64) for w, h in self.dims]
        self.low = [np.zeros(w * h, np.int64) for w, h in self.dims]

    def decode(self, br: BitReader, x: int, y: int, threshold: int) -> bool:
        """Reads bits until the leaf's value is known to be below
        `threshold` or not; returns value < threshold."""
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
            while low < threshold and low < self.value[lev][i]:
                if br.bit():
                    self.value[lev][i] = low
                else:
                    low += 1
            self.low[lev][i] = low
        lev, i = path[0]
        return bool(self.value[lev][i] < threshold)

    def leaf(self, x: int, y: int) -> int:
        return int(self.value[0][y * self.dims[0][0] + x])


def _segments(data: bytes, pos: int):
    """(marker, body) of each marker segment from pos up to SOD or EOC;
    returns them with the position after the last."""
    out = []
    while True:
        if pos + 2 > len(data):
            raise ValueError("codestream ends inside its headers")
        (marker,) = struct.unpack_from(">H", data, pos)
        if marker in (SOD, EOC):
            return out, pos
        (length,) = struct.unpack_from(">H", data, pos + 2)
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length


def _quant(body: bytes, ncomp_steps: int):
    sq = body[0]
    style, guard = sq & 0x1F, sq >> 5
    if style == 0:
        steps = [(b >> 3, 0) for b in body[1:]]
    elif style == 2:
        steps = [(v >> 11, v & 0x7FF) for v in
                 struct.unpack(f">{(len(body) - 1) // 2}H", body[1:])]
    else:
        raise ValueError(f"quantization style {style} is outside the "
                         "benchmark's configurations")
    if len(steps) != ncomp_steps:
        raise ValueError(f"{len(steps)} step sizes for {ncomp_steps} bands")
    return style, guard, steps


def read_main(data: bytes) -> Tuple[Main, int]:
    """The main header, and the position of the first SOT."""
    if struct.unpack_from(">H", data, 0)[0] != SOC:
        raise ValueError("no SOC")
    pos = 2
    segs = []
    while True:
        (marker,) = struct.unpack_from(">H", data, pos)
        if marker == SOT:
            break
        (length,) = struct.unpack_from(">H", data, pos + 2)
        segs.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
    by = {}
    for marker, body in segs:
        by.setdefault(marker, []).append(body)
    if SIZ not in by or COD not in by or QCD not in by:
        raise ValueError("main header lacks SIZ, COD or QCD")
    siz = by[SIZ][0]
    (_rsiz, xs, ys, xo, yo, xt, yt, _xto, _yto, csiz) = struct.unpack_from(
        ">HIIIIIIIIH", siz, 0)
    prec, sgn = [], []
    for c in range(csiz):
        ssiz, dx, dy = siz[36 + 3 * c:39 + 3 * c]
        if dx != 1 or dy != 1:
            raise ValueError("subsampled components are outside the "
                             "benchmark's configurations")
        prec.append((ssiz & 0x7F) + 1)
        sgn.append(bool(ssiz & 0x80))
    cod = by[COD][0]
    scod, order, layers, mct = cod[0], cod[1], struct.unpack_from(
        ">H", cod, 2)[0], cod[4]
    levels, xcb, ycb, cb_style, transform = cod[5:10]
    if scod & 1:
        raise ValueError("precinct partitions are outside the benchmark's "
                         "configurations")
    nbands = 3 * levels + 1
    style, guard, steps = _quant(by[QCD][0], nbands)
    quant = {c: (style, guard, steps) for c in range(csiz)}
    for body in by.get(QCC, []):
        c = body[0] if csiz < 257 else struct.unpack_from(">H", body, 0)[0]
        quant[c] = _quant(body[1 if csiz < 257 else 2:], nbands)
    pcap = struct.unpack_from(">I", by[CAP][0], 0)[0] if CAP in by else 0
    main = Main(width=xs - xo, height=ys - yo, x_offset=xo, y_offset=yo,
                tile_width=xt, tile_height=yt, precision=prec, signed=sgn,
                scod=scod, order=ORDERS.get(order, str(order)),
                layers=layers, mct=mct, levels=levels,
                cb_exp=(xcb + 2, ycb + 2), cb_style=cb_style,
                transform=transform,
                guard_bits=[quant[c][1] for c in range(csiz)],
                quant_style=[quant[c][0] for c in range(csiz)],
                steps=[quant[c][2] for c in range(csiz)], pcap=pcap,
                other_markers=sorted(m for m in by
                                     if m not in (SIZ, CAP, COD, QCD, QCC)))
    return main, pos


def band_sizes(w: int, h: int, levels: int) -> Dict[Tuple[int, str], Tuple[int, int]]:
    """(resolution, band) -> (width, height) of a component at the origin:
    each level splits n samples into ceil(n / 2) low and n // 2 high."""
    out = {}
    for lev in range(1, levels + 1):
        r = levels - lev + 1
        out[(r, "HL")] = (w // 2, (h + 1) // 2)
        out[(r, "LH")] = ((w + 1) // 2, h // 2)
        out[(r, "HH")] = (w // 2, h // 2)
        w, h = (w + 1) // 2, (h + 1) // 2
    out[(0, "LL")] = (w, h)
    return out


def _num_passes(br: BitReader) -> int:
    """Table B.4."""
    if br.bit() == 0:
        return 1
    if br.bit() == 0:
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    v = br.bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.bits(7)


def read(data: bytes) -> Tuple[Main, List[Block]]:
    """The main header and every code-block of the codestream, in packet
    order, each with its zero bit-planes, passes and codeword bytes."""
    main, pos = read_main(data)
    if main.x_offset or main.y_offset or main.layers != 1:
        raise ValueError("image offsets and layers are outside the "
                         "benchmark's configurations")
    if (main.tile_width, main.tile_height) != (main.width, main.height):
        raise ValueError("tiled codestreams are outside the benchmark's "
                         "configurations")
    if main.order not in ("LRCP", "RLCP"):
        raise ValueError(f"progression {main.order} is outside the "
                         "benchmark's configurations")
    (_lsot, isot, psot, tpsot, _tnsot) = struct.unpack_from(
        ">HHIBB", data, pos + 2)
    if isot != 0 or tpsot != 0:
        raise ValueError("one tile-part of tile 0 expected")
    tile_end = pos + psot if psot else len(data) - 2
    segs, pos = _segments(data, pos + 12)
    if segs:
        raise ValueError("markers in the tile-part header are outside the "
                         "benchmark's configurations")
    if struct.unpack_from(">H", data, pos)[0] != SOD:
        raise ValueError("no SOD")
    pos += 2
    if data[tile_end:] != b"\xff\xd9":
        raise ValueError("the tile-part is not followed by EOC")

    ncomp = len(main.precision)
    sizes = band_sizes(main.width, main.height, main.levels)
    cbw, cbh = 1 << main.cb_exp[0], 1 << main.cb_exp[1]
    blocks: List[Block] = []
    for r in range(main.levels + 1):
        for c in range(ncomp):
            br = BitReader(data, pos)
            present = br.bit()
            packet = []
            for name in (("LL",) if r == 0 else ("HL", "LH", "HH")):
                bw, bh = sizes[(r, name)]
                if bw == 0 or bh == 0:
                    continue
                nx, ny = -(-bw // cbw), -(-bh // cbh)
                incl, zbp = TagTree(nx, ny), TagTree(nx, ny)
                for y in range(ny):
                    for x in range(nx):
                        blk = Block(c, r, name, x * cbw, y * cbh,
                                    min(cbw, bw - x * cbw),
                                    min(cbh, bh - y * cbh))
                        blocks.append(blk)
                        if not present or not incl.decode(br, x, y, 1):
                            continue
                        t = 1
                        while not zbp.decode(br, x, y, t):
                            t += 1
                        blk.zero_bitplanes = zbp.leaf(x, y)
                        blk.passes = _num_passes(br)
                        if blk.passes != 1:
                            raise ValueError("HT refinement passes are "
                                             "outside the benchmark's "
                                             "configurations")
                        lblock = 3
                        while br.bit():
                            lblock += 1
                        packet.append((blk, br.bits(lblock)))
            pos = br.end()
            for blk, n in packet:
                if pos + n > tile_end:
                    raise ValueError("a code-block runs past the tile data")
                blk.data = data[pos:pos + n]
                pos += n
    if pos != tile_end:
        raise ValueError(f"{tile_end - pos} bytes of tile data left over")
    # LRCP and RLCP visit the same packets in the same order at one layer
    return main, blocks
