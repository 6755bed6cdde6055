"""JP2 colour spaces -> sRGB, as elementwise torch ops.

Port of go_jpeg2000_tpu/ops/colorspace.py: the 14 converters (sYCC,
BT.601 YCbCr, PhotoYCC, CMY, CMYK, YCCK, CIELab D50->D65, CIEJab, e-sRGB,
ROMM-RGB, YPbPr 60/50, e-sYCC) and their dispatch, get_color_conversion.
Each converter takes a list of int32 component tensors (full resolution,
unsigned range [0, 2^P - 1]) on any device and returns sRGB tensors in the
same range, int32, on that device.  The float32 operations run in the JAX
package's order, with IEEE divisions on every device (_div), so the
results match it exactly except where a `pow` rounds differently (the sRGB
gamma of CIELab, CIEJab and ROMM-RGB).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..options import ColorSpace

Planes = List[torch.Tensor]


def _maxval(precision: int) -> float:
    return float((1 << precision) - 1)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c (c taken as a float32), an IEEE division on every device.
    torch on CUDA divides a tensor by a host scalar as a product with the
    scalar's reciprocal, an ulp off at times; the CPU and XLA divide.  A
    divisor on x's device keeps the division."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def _clip(x: torch.Tensor, precision: int) -> torch.Tensor:
    """Round half to even (jnp.round), clip to the range, int32."""
    return torch.clamp(torch.round(x), 0, _maxval(precision)).to(torch.int32)


def _ycc_to_rgb(y, cb, cr, precision, kr, kb):
    """Generic YCbCr->RGB with BT matrix weights kr, kb (full range)."""
    mx = _maxval(precision)
    half = (mx + 1.0) / 2.0
    kg = 1.0 - kr - kb
    y = _f32(y)
    pb = _f32(cb) - half
    pr = _f32(cr) - half
    r = y + 2.0 * (1.0 - kr) * pr
    b = y + 2.0 * (1.0 - kb) * pb
    g = y - _div(2.0 * kb * (1.0 - kb) * pb + 2.0 * kr * (1.0 - kr) * pr, kg)
    return r, g, b


def convert_sycc(comps: Planes, precision: int) -> Planes:
    """sYCC (BT.601 matrix on sRGB primaries, enumcs 18)."""
    r, g, b = _ycc_to_rgb(comps[0], comps[1], comps[2], precision, 0.299,
                          0.114)
    return [_clip(r, precision), _clip(g, precision), _clip(b, precision)]


def convert_ycbcr601(comps: Planes, precision: int) -> Planes:
    """BT.601 YCbCr, studio-range expansion (enumcs 3 and 4)."""
    scale = _maxval(precision) / 255.0
    y = (_div(_f32(comps[0]), scale) - 16.0) * (255.0 / 219.0)
    cb = (_div(_f32(comps[1]), scale) - 128.0) * (255.0 / 224.0)
    cr = (_div(_f32(comps[2]), scale) - 128.0) * (255.0 / 224.0)
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return [_clip(v * scale, precision) for v in (r, g, b)]


def convert_ypbpr(kr: float, kb: float) -> Callable:
    def conv(comps: Planes, precision: int) -> Planes:
        r, g, b = _ycc_to_rgb(comps[0], comps[1], comps[2], precision, kr,
                              kb)
        return [_clip(r, precision), _clip(g, precision),
                _clip(b, precision)]
    return conv


def convert_photo_ycc(comps: Planes, precision: int) -> Planes:
    """Kodak PhotoYCC (enumcs 9)."""
    mx = _maxval(precision)
    scale = mx / 255.0
    y = _div(_f32(comps[0]), scale) * 1.3584
    c1 = (_div(_f32(comps[1]), scale) - 156.0) * 2.2179
    c2 = (_div(_f32(comps[2]), scale) - 137.0) * 1.8215
    r = y + c2
    g = y - 0.194 * c1 - 0.509 * c2
    b = y + c1
    return [_clip(_div(v, 255.0) * mx, precision) for v in (r, g, b)]


def convert_cmy(comps: Planes, precision: int) -> Planes:
    mx = _maxval(precision)
    return [_clip(mx - _f32(c), precision) for c in comps[:3]]


def convert_cmyk(comps: Planes, precision: int) -> Planes:
    mx = _maxval(precision)
    c, m, y, k = (_div(_f32(x), mx) for x in comps[:4])
    r = (1.0 - c) * (1.0 - k)
    g = (1.0 - m) * (1.0 - k)
    b = (1.0 - y) * (1.0 - k)
    return [_clip(v * mx, precision) for v in (r, g, b)]


def convert_ycck(comps: Planes, precision: int) -> Planes:
    """YCCK (enumcs 13): sYCC-decode Y/Cb/Cr, invert, then CMYK composite."""
    mx = _maxval(precision)
    r, g, b = _ycc_to_rgb(comps[0], comps[1], comps[2], precision, 0.299,
                          0.114)
    k = _div(_f32(comps[3]), mx)
    c = 1.0 - _div(torch.clamp(r, 0, mx), mx)
    m = 1.0 - _div(torch.clamp(g, 0, mx), mx)
    y = 1.0 - _div(torch.clamp(b, 0, mx), mx)
    rr = (1.0 - c) * (1.0 - k)
    gg = (1.0 - m) * (1.0 - k)
    bb = (1.0 - y) * (1.0 - k)
    return [_clip(v * mx, precision) for v in (rr, gg, bb)]


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 x ** e (e taken as a float32, as jnp takes a Python float),
    computed in float64 and rounded once.  XLA's float32 pow is almost
    always the rounded exact value: on 2^20 uniform samples with e = 1/2.4
    this differs from it on 0.07% of them, torch's float32 pow on 1.6%."""
    e32 = torch.tensor(e, dtype=torch.float32).item()
    return torch.pow(x.to(torch.float64), e32).to(torch.float32)


def srgb_gamma(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer function (IEC 61966-2-1)."""
    return torch.where(
        linear <= 0.0031308, 12.92 * linear,
        1.055 * _pow(torch.clamp(linear, min=1e-12), 1.0 / 2.4) - 0.055)


# XYZ (D65) -> linear sRGB
_XYZ_TO_SRGB = (
    (3.2406, -1.5372, -0.4986),
    (-0.9689, 1.8758, 0.0415),
    (0.0557, -0.2040, 1.0570),
)
# Bradford chromatic adaptation D50 -> D65
_D50_TO_D65 = (
    (0.9555766, -0.0230393, 0.0631636),
    (-0.0282895, 1.0099416, 0.0210077),
    (0.0122982, -0.0204830, 1.3299098),
)


def _mat3(m, x, y, z):
    """Rows of the 3x3 matrix m applied to (x, y, z), term by term."""
    return [m[i][0] * x + m[i][1] * y + m[i][2] * z for i in range(3)]


def convert_cielab(comps: Planes, precision: int) -> Planes:
    """CIELab (D50) -> sRGB with Bradford adaptation to D65 (enumcs 14):
    L = 100 v, a and b = 255 v - 128 (the JAX package's defaults)."""
    mx = _maxval(precision)
    L = _div(_f32(comps[0]), mx) * 100.0
    a = _div(_f32(comps[1]), mx) * 255.0 - 128.0
    bb = _div(_f32(comps[2]), mx) * 255.0 - 128.0
    # Lab -> XYZ (D50 white)
    fy = _div(L + 16.0, 116.0)
    fx = fy + _div(a, 500.0)
    fz = fy - _div(bb, 200.0)

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > 0.008856, t3, _div(t - 16.0 / 116.0, 7.787))

    xn, yn, zn = 0.9642, 1.0, 0.8249  # D50
    x = finv(fx) * xn
    y = torch.where(L > 7.9996, fy ** 3, _div(L, 903.3)) * yn
    z = finv(fz) * zn
    x65, y65, z65 = _mat3(_D50_TO_D65, x, y, z)
    out = [srgb_gamma(torch.clamp(v, 0.0, 1.0)) * mx
           for v in _mat3(_XYZ_TO_SRGB, x65, y65, z65)]
    return [_clip(v, precision) for v in out]


def convert_esrgb(comps: Planes, precision: int) -> Planes:
    """e-sRGB (enumcs 20): the [0.375, 0.625]-coded nominal range mapped
    back to sRGB and clipped."""
    mx = _maxval(precision)
    out = []
    for c in comps[:3]:
        v = _div(_f32(c), mx + 1.0)
        v = (v - 0.375) * 4.0  # nominal [0,1] range
        out.append(_clip(torch.clamp(v, 0.0, 1.0) * mx, precision))
    return out


def convert_romm(comps: Planes, precision: int) -> Planes:
    """ROMM-RGB / ProPhoto (enumcs 21) -> sRGB via XYZ D50->D65."""
    mx = _maxval(precision)

    def degamma(v):   # ROMM gamma 1.8 with a linear toe
        return torch.where(v < 16.0 * 0.001953, _div(v, 16.0),
                           _pow(v, 1.8))

    rgb = [degamma(_div(_f32(c), mx)) for c in comps[:3]]
    # ROMM -> XYZ (D50)
    m = ((0.7977, 0.1352, 0.0313),
         (0.2880, 0.7119, 0.0001),
         (0.0000, 0.0000, 0.8249))
    x, y, z = _mat3(m, *rgb)
    x65, y65, z65 = _mat3(_D50_TO_D65, x, y, z)
    return [_clip(srgb_gamma(torch.clamp(v, 0.0, 1.0)) * mx, precision)
            for v in _mat3(_XYZ_TO_SRGB, x65, y65, z65)]


def convert_eycc(comps: Planes, precision: int) -> Planes:
    """e-sYCC (enumcs 24): the sYCC matrix."""
    return convert_sycc(comps, precision)


def convert_ciejab(comps: Planes, precision: int) -> Planes:
    """CIEJab (enumcs 19), approximated by the Lab path, as in the JAX
    package."""
    return convert_cielab(comps, precision)


_TABLE = {
    ColorSpace.SYCC: convert_sycc,
    ColorSpace.EYCC: convert_eycc,
    ColorSpace.YCBCR2: convert_ycbcr601,
    ColorSpace.YCBCR3: convert_ycbcr601,
    ColorSpace.PHOTO_YCC: convert_photo_ycc,
    ColorSpace.CMY: convert_cmy,
    ColorSpace.CMYK: convert_cmyk,
    ColorSpace.YCCK: convert_ycck,
    ColorSpace.CIELAB: convert_cielab,
    ColorSpace.CIEJAB: convert_ciejab,
    ColorSpace.ESRGB: convert_esrgb,
    ColorSpace.ROMM_RGB: convert_romm,
    ColorSpace.YPBPR60: convert_ypbpr(0.2126, 0.0722),   # BT.709
    ColorSpace.YPBPR50: convert_ypbpr(0.2126, 0.0722),
}


def get_color_conversion(cs: ColorSpace) -> Optional[Callable]:
    """The converter of a JP2 colour space, or None for the spaces that are
    displayed as they are (sRGB, gray, unspecified)."""
    return _TABLE.get(cs)
