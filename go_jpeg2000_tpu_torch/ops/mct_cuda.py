"""The colour and level-shift head and tail of the transform chains as two
hand-written CUDA kernels (csrc/mct.cu), bound with ctypes.

`mct_forward` takes the samples [N, C, H, W] as transforms.upload ships
them to the card (uint8, int8, int16, uint16, or int32, which also
carries a uint32 pattern below 2^31) and returns what
transforms.coefficients_plain returns: the DC shift, RCT (5/3, int32) or
ICT (9/7, float32) on components 0-2 when use_mct and C >= 3, the DC
shift alone on the others, contiguous [N, C, H, W].  `mct_inverse` takes
the last inverse level's output (int32 for 5/3, float32 for 9/7) and
returns what transforms.samples_plain returns: inverse RCT or ICT,
rounding half to even (9/7), DC shift, clamp and narrowing.  Both take a
tensor on the card only (transforms routes a CPU tensor to the plain
versions), in one pass and one launch each; the input's frame and
component strides go to the kernel, so a row shard's view is read in
place, and only an input whose planes are not contiguous is copied
first.  A failed build or launch raises.

LAUNCHES["mct_forward"] and LAUNCHES["mct_inverse"] go up by one each
time the kernel is launched, and only there.  The library is built by
ops/cuda_build.py on first use.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build, mct

LAUNCHES: Dict[str, int] = {"mct_forward": 0, "mct_inverse": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# csrc/mct.cu's dtype codes
_CODES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.uint16: 3,
          torch.int32: 4, torch.float32: 5}
_NONE, _RCT, _ICT = 0, 1, 2


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """Build (if needed) and bind csrc/mct.cu."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load("mct")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mct_forward.restype = i
        lib.mct_forward.argtypes = [p, ll, ll, i, p, i, i, i, ll, i,
                                    ctypes.c_uint, p]
        lib.mct_inverse.restype = i
        lib.mct_inverse.argtypes = [p, ll, ll, i, p, i, i, i, ll, i,
                                    ctypes.c_uint, i, i, p]
        _lib = lib
        return _lib


def _planes(x: torch.Tensor, name: str) -> Tuple[torch.Tensor, int, int]:
    """x [N, C, H, W] on the card -> (a tensor whose planes are contiguous,
    its frame stride, its component stride), in elements."""
    if x.dim() != 4:
        raise ValueError(f"{name}: samples [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: a CUDA tensor, got one on {x.device}")
    n, c, h, w = x.shape
    if not ((w <= 1 or x.stride(3) == 1) and (h <= 1 or x.stride(2) == w)):
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, call) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = call(stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def mct_forward(x: torch.Tensor, kind: str, use_mct: bool, precision: int,
                signed: bool) -> torch.Tensor:
    """Samples [N, C, H, W] on the card -> DC shift, RCT (kind "53") or ICT
    (kind "97", float32): the DWT's input, contiguous [N, C, H, W]."""
    name = "mct_forward"
    if x.dtype not in _CODES or x.dtype == torch.float32:
        raise ValueError(f"{name}: uint8, int8, int16, uint16 or int32 "
                         f"samples, got {x.dtype}")
    if not 1 <= precision <= 32:
        raise ValueError(f"{name}: precision {precision} outside 1..32")
    x, sn, sc = _planes(x, name)
    n, c, h, w = x.shape
    lossy = kind == "97"
    out = torch.empty((n, c, h, w), device=x.device,
                      dtype=torch.float32 if lossy else torch.int32)
    if out.numel() == 0:
        return out
    colour = (_ICT if lossy else _RCT) if use_mct and c >= 3 else _NONE
    lib = load()
    # x and out stay referenced here until the launch is queued
    _launch(name, x, out, lambda stream: lib.mct_forward(
        x.data_ptr(), sn, sc, _CODES[x.dtype], out.data_ptr(), int(lossy),
        n, c, h * w, colour, mct.dc_offset(precision, signed), stream))
    return out


def mct_inverse(x: torch.Tensor, kind: str, use_mct: bool, precision: int,
                signed: bool, narrow: bool = True) -> torch.Tensor:
    """The inverse DWT's output [N, C, H, W] on the card (int32 for kind
    "53", float32 for "97") -> inverse RCT or ICT, rounding half to even
    (9/7), DC shift, clamp and narrowing (mct.narrow_dtype), contiguous."""
    name = "mct_inverse"
    lossy = kind == "97"
    want = torch.float32 if lossy else torch.int32
    if x.dtype != want:
        raise ValueError(f"{name}: {want} coefficients for kind {kind}, got "
                         f"{x.dtype}")
    if not 1 <= precision <= 32:
        raise ValueError(f"{name}: precision {precision} outside 1..32")
    lo, hi = mct.sample_range(precision, signed)
    if hi >= 1 << 31:
        # torch.clamp refuses a bound past int32 in the plain version too
        raise RuntimeError(f"{name}: unsigned {precision}-bit samples do not "
                           "fit int32")
    x, sn, sc = _planes(x, name)
    n, c, h, w = x.shape
    dt = mct.narrow_dtype(precision, signed, narrow)
    out = torch.empty((n, c, h, w), device=x.device, dtype=dt)
    if out.numel() == 0:
        return out
    colour = (_ICT if lossy else _RCT) if use_mct and c >= 3 else _NONE
    lib = load()
    _launch(name, x, out, lambda stream: lib.mct_inverse(
        x.data_ptr(), sn, sc, _CODES[x.dtype], out.data_ptr(), _CODES[dt],
        n, c, h * w, colour, mct.dc_offset(precision, signed), lo, hi,
        stream))
    return out
