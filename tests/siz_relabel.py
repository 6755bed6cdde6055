"""SIZ rewrites of one-component lossless J2K codestreams, for the decode
tests of sample types and subsampling (test_torch_decode_samples.py on the
CPU, test_torch_cuda.py on the card): the tile data stay valid, only the
header's sample type or component grid changes."""
import struct

import numpy as np


def relabel(data: bytes, ssiz=None, sub=None) -> bytes:
    """A one-component J2K codestream with its SIZ fields rewritten:
    Ssiz (sign and precision) and, with `sub`, Xsiz, Ysiz, XTsiz and YTsiz
    multiplied by it and XRsiz = YRsiz = sub (the component keeps its
    grid, so the tile data stay valid)."""
    b = bytearray(data)
    assert b[2:4] == b"\xff\x51" and b[40:42] == b"\x00\x01"
    if ssiz is not None:
        b[42] = ssiz
    if sub:
        for off in (8, 12, 24, 28):
            struct.pack_into(">I", b, off,
                             struct.unpack_from(">I", b, off)[0] * sub)
        b[43] = b[44] = sub
    return bytes(b)


def relabel_cases(x: np.ndarray):
    """(SIZ rewrite, exact expected decode) of an 8-bit lossless stream of
    x: signed 8-bit, 4-bit and 20-bit unsigned, 2x2 subsampled."""
    xi = x.astype(np.int32)
    return {
        "signed8": (dict(ssiz=0x87), (xi - 128).astype(np.int8)),
        "u4": (dict(ssiz=3), np.clip(xi - 120, 0, 15).astype(np.uint8)),
        "u20": (dict(ssiz=19), xi - 128 + (1 << 19)),
        "sub2": (dict(sub=2), np.repeat(np.repeat(x, 2, 0), 2, 1)),
    }
