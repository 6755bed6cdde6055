"""JP2 container box layer (ISO/IEC 15444-1 Annex I), copied from the JAX
package (go_jpeg2000_tpu/utils/boxes.py; numpy-free, stdlib only).

Capability parity with the reference's box package
(go-jpeg2000 internal/box/box.go:94-520): box read/write incl. 64-bit
extended lengths, ihdr/bpcc/colr (enumerated + ICC)/ftyp/jp2h/jp2c parse and
build, 19 enumcs constants (mapped in options.ENUMCS_TO_COLORSPACE).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

from ..options import (COLORSPACE_TO_ENUMCS, ENUMCS_TO_COLORSPACE, ColorSpace,
                       Options)

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP \x20\x0d\x0a\x87\x0a"

TYPE_JP = b"jP \x20"
TYPE_FTYP = b"ftyp"
TYPE_JP2H = b"jp2h"
TYPE_IHDR = b"ihdr"
TYPE_BPCC = b"bpcc"
TYPE_COLR = b"colr"
TYPE_PCLR = b"pclr"
TYPE_CMAP = b"cmap"
TYPE_CDEF = b"cdef"
TYPE_RES = b"res "
TYPE_JP2C = b"jp2c"
TYPE_XML = b"xml "
TYPE_UUID = b"uuid"

BRAND_JP2 = b"jp2 "
BRAND_JPX = b"jpx "


class BoxError(ValueError):
    pass


def read_box(data: bytes, pos: int) -> Tuple[bytes, bytes, int]:
    """Returns (box_type, contents, next_pos).  Handles XLBox (64-bit) and
    length-0 (extends to EOF)."""
    if pos + 8 > len(data):
        raise BoxError("truncated box header")
    lbox = struct.unpack_from(">I", data, pos)[0]
    tbox = data[pos + 4:pos + 8]
    if lbox == 1:
        if pos + 16 > len(data):
            raise BoxError("truncated XLBox")
        xlbox = struct.unpack_from(">Q", data, pos + 8)[0]
        if xlbox < 16:
            raise BoxError("invalid XLBox length")
        end = pos + xlbox
        body = data[pos + 16:end]
    elif lbox == 0:
        end = len(data)
        body = data[pos + 8:]
    else:
        if lbox < 8:
            raise BoxError(f"invalid box length {lbox}")
        end = pos + lbox
        body = data[pos + 8:end]
    if end > len(data):
        raise BoxError("box extends past end of data")
    return tbox, body, end


def write_box(box_type: bytes, body: bytes) -> bytes:
    length = len(body) + 8
    if length <= 0xFFFFFFFF:
        return struct.pack(">I", length) + box_type + body
    return struct.pack(">I", 1) + box_type + struct.pack(">Q", length + 8) + body


@dataclasses.dataclass
class JP2Info:
    brand: bytes = BRAND_JP2
    width: int = 0
    height: int = 0
    num_components: int = 0
    bpc: int = 0                  # ihdr BPC field (prec-1 | sign<<7; 0xFF = bpcc)
    bpcc: List[int] = dataclasses.field(default_factory=list)
    color_space: ColorSpace = ColorSpace.UNSPECIFIED
    icc_profile: Optional[bytes] = None
    codestream: bytes = b""


def parse_jp2(data: bytes) -> JP2Info:
    if data[:12] != JP2_SIGNATURE:
        raise BoxError("missing JP2 signature box")
    info = JP2Info()
    pos = 12
    seen_ftyp = False
    while pos < len(data):
        tbox, body, pos = read_box(data, pos)
        if tbox == TYPE_FTYP:
            if len(body) < 8:
                raise BoxError("ftyp too short")
            info.brand = body[0:4]
            seen_ftyp = True
        elif tbox == TYPE_JP2H:
            _parse_jp2h(body, info)
        elif tbox == TYPE_JP2C:
            info.codestream = body
            break   # first codestream wins
    if not seen_ftyp:
        raise BoxError("missing ftyp box")
    if not info.codestream:
        raise BoxError("missing jp2c codestream box")
    return info


def _parse_jp2h(data: bytes, info: JP2Info) -> None:
    pos = 0
    while pos < len(data):
        tbox, body, pos = read_box(data, pos)
        if tbox == TYPE_IHDR:
            if len(body) < 14:
                raise BoxError("ihdr too short")
            info.height, info.width = struct.unpack_from(">II", body, 0)
            info.num_components = struct.unpack_from(">H", body, 8)[0]
            info.bpc = body[10]
        elif tbox == TYPE_BPCC:
            info.bpcc = list(body)
        elif tbox == TYPE_COLR:
            if len(body) < 3:
                raise BoxError("colr too short")
            meth = body[0]
            if meth == 1 and len(body) >= 7:
                enumcs = struct.unpack_from(">I", body, 3)[0]
                info.color_space = ENUMCS_TO_COLORSPACE.get(
                    enumcs, ColorSpace.UNKNOWN)
            elif meth == 2:
                info.icc_profile = body[3:]
                info.color_space = ColorSpace.UNSPECIFIED


def build_jp2h(width: int, height: int, num_components: int,
               precisions: List[int], signed: List[bool],
               color_space: ColorSpace, icc: Optional[bytes] = None) -> bytes:
    same = all(p == precisions[0] for p in precisions) and \
        all(s == signed[0] for s in signed)
    bpc = (precisions[0] - 1) | (0x80 if signed[0] else 0) if same else 0xFF
    ihdr = struct.pack(">IIHBBBB", height, width, num_components, bpc,
                       7,   # compression type: always 7
                       0 if color_space != ColorSpace.UNKNOWN else 1,  # UnkC
                       0)   # IPR
    body = write_box(TYPE_IHDR, ihdr)
    if not same:
        bpcc = bytes((p - 1) | (0x80 if s else 0)
                     for p, s in zip(precisions, signed))
        body += write_box(TYPE_BPCC, bpcc)
    if icc is not None:
        body += write_box(TYPE_COLR, struct.pack(">BBB", 2, 0, 0) + icc)
    else:
        enumcs = COLORSPACE_TO_ENUMCS.get(color_space, 16 if num_components >= 3 else 17)
        body += write_box(TYPE_COLR, struct.pack(">BBBI", 1, 0, 0, enumcs))
    return write_box(TYPE_JP2H, body)


def wrap_jp2(codestream: bytes, header, opts: Options) -> bytes:
    """Wrap a raw codestream in a JP2 (or JPX) container."""
    from ..options import Format
    brand = BRAND_JPX if opts.format == Format.JPX else BRAND_JP2
    ftyp = write_box(TYPE_FTYP, brand + struct.pack(">I", 0) + BRAND_JP2)
    precisions = [c.precision for c in header.components]
    signed = [c.signed for c in header.components]
    cs = opts.color_space
    if cs == ColorSpace.UNSPECIFIED:
        cs = ColorSpace.SRGB if header.num_components >= 3 else ColorSpace.GRAY
    jp2h = build_jp2h(header.width - header.x_offset,
                      header.height - header.y_offset,
                      header.num_components, precisions, signed,
                      cs, opts.icc_profile)
    jp2c = write_box(TYPE_JP2C, codestream)
    return JP2_SIGNATURE + ftyp + jp2h + jp2c
