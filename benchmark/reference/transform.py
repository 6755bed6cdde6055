"""The reference's sample transforms, in plain PyTorch on the CPU.

Written from ISO/IEC 15444-1 for the benchmark; it imports nothing of
the program.  Forward: the DC level shift (G.1), the RCT or ICT (G.2,
G.3), the 5/3 or 9/7 lifting DWT (F.4.8, vertical then horizontal, whole-
sample symmetric extension, origin 0) and, for 9/7, the deadzone scalar
quantizer (E.1).  Inverse: the 5/3 and RCT reversed, for the lossless decode.

`dtype` sets the arithmetic: None is the configuration's own (exact
integers for 5/3 and the RCT, float32 for 9/7 and the ICT); a control
passes a lower one (float16 for 5/3, bfloat16 for 9/7), the step a later
change might be tempted by.

The step sizes follow the configuration's quantization rule, a frozen
copy of the program's (go_jpeg2000_tpu_torch/models/rate.py
base_delta_for_quality, ops/quant.py make_irreversible_quant,
codestream/header.py StepSize), because the rule that maps `quality` to
steps is the program's choice, not the standard's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001
ICT = ((0.299, 0.587, 0.114), (-0.168736, -0.331264, 0.5),
       (0.5, -0.418688, -0.081312))
BAND_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}
# 2-D synthesis-basis L2 norms of the 9/7 bands by decomposition level
# (ISO/IEC 15444-1 J.4; OpenJPEG's opj_dwt_norms_real): HL/LH/HH at level
# nb -> [nb - 1], LL at the top level nb -> [nb]
_N97_HL = [2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0]
NORMS_97 = {"LL": [1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3,
                   270.6, 540.9],
            "HL": _N97_HL, "LH": _N97_HL,
            "HH": [2.080, 3.865, 8.307, 17.18, 34.71, 69.59, 139.3, 278.6]}

Pyramid = Dict[Tuple[int, str], torch.Tensor]   # (resolution, band) -> [N, h, w]


# ------------------------------------------------------------ step sizes

def step_from_delta(delta: float, precision: int) -> Tuple[int, int]:
    """(exponent, mantissa) that codes delta (E-3), rounded to 11 bits."""
    e = math.floor(math.log2(delta))
    mu = int(round((delta / 2.0 ** e - 1.0) * 2048.0))
    if mu >= 2048:
        mu, e = 0, e + 1
    return max(0, min(31, precision - e)), mu


def band_order(levels: int) -> List[Tuple[int, str]]:
    """Signalled band order (A.6.4): LL, then HL, LH, HH from the coarsest
    resolution up."""
    return [(0, "LL")] + [(r, b) for r in range(1, levels + 1)
                          for b in ("HL", "LH", "HH")]


def steps(cfg: Dict, comp: int) -> List[Tuple[int, int]]:
    """The QCD/QCC steps of component `comp`, in band_order: exponents
    precision + gain under 5/3 (one more bit for the RCT's chroma); under
    9/7, base / norm with base = 2^(-1 + (100 - q) / 99 * (P - 2))."""
    codec = cfg["codec"]
    p = cfg["bits_stored"]
    levels = codec["num_resolutions"] - 1
    if codec["lossless"]:
        rct = cfg["samples_per_pixel"] >= 3 and comp in (1, 2)
        return [(p + int(rct) + BAND_GAIN[b], 0) for _r, b in band_order(levels)]
    q = min(100, max(1, codec["quality"]))
    base = 2.0 ** (-1.0 + (100 - q) / 99.0 * (p - 2.0))
    out = []
    for r, b in band_order(levels):
        nb = levels if r == 0 else levels - r + 1
        tab = NORMS_97[b]
        norm = tab[min(nb if b == "LL" else nb - 1, len(tab) - 1)]
        delta = min(max(base / norm, 2.0 ** -20), 2.0 ** 20)
        out.append(step_from_delta(delta, p))
    return out


def deltas(cfg: Dict) -> Dict[Tuple[int, str], float]:
    """Delta_b = 2^(R_b - eps_b) (1 + mu_b / 2^11), R_b = P + gain_b."""
    levels = cfg["codec"]["num_resolutions"] - 1
    p = cfg["bits_stored"]
    return {(r, b): 2.0 ** (p + BAND_GAIN[b] - e) * (1 + mu / 2048.0)
            for (r, b), (e, mu) in zip(band_order(levels), steps(cfg, 0))}


# ------------------------------------------------------------ lifting

def _right(a: torch.Tensor, n_other: int) -> torch.Tensor:
    """a[i + 1] for i < n_other, the last sample mirrored (F.3.7)."""
    if a.shape[-1] > n_other:
        return a[..., 1:n_other + 1]
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def _left(a: torch.Tensor, n_other: int) -> torch.Tensor:
    """a[i - 1] for i < n_other, a[-1] mirrored to a[0] (F.3.7)."""
    out = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    if n_other > a.shape[-1]:
        out = torch.cat([out, a[..., -1:]], dim=-1)
    return out


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return torch.floor(x / d)
    return torch.div(x, d, rounding_mode="floor")


def fwd_1d(x: torch.Tensor, wavelet: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward level along the last axis: (low, high)."""
    if x.shape[-1] == 1:
        return x, x[..., :0]
    lo, hi = x[..., 0::2], x[..., 1::2]
    n_hi = hi.shape[-1]
    if wavelet == "5/3":
        hi = hi - _floor_div(lo[..., :n_hi] + _right(lo, n_hi), 2)
        lo = lo + _floor_div(_left(hi, lo.shape[-1]) + _pad(hi, lo) + 2, 4)
        return lo, hi
    for coef, odd in ((ALPHA, True), (BETA, False), (GAMMA, True),
                      (DELTA, False)):
        if odd:
            hi = hi + coef * (lo[..., :n_hi] + _right(lo, n_hi))
        else:
            lo = lo + coef * (_left(hi, lo.shape[-1]) + _pad(hi, lo))
    return lo * (1.0 / K), hi * K


def inv_1d(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of fwd_1d's 5/3: the interleaved signal."""
    if hi.shape[-1] == 0:
        return lo
    n_hi = hi.shape[-1]
    lo = lo - _floor_div(_left(hi, lo.shape[-1]) + _pad(hi, lo) + 2, 4)
    hi = hi + _floor_div(lo[..., :n_hi] + _right(lo, n_hi), 2)
    out = torch.empty(lo.shape[:-1] + (lo.shape[-1] + n_hi,), dtype=lo.dtype)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


def _pad(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi[i] for i < len(lo): an odd-length signal mirrors its last high
    sample."""
    if lo.shape[-1] > hi.shape[-1]:
        return torch.cat([hi, hi[..., -1:]], dim=-1)
    return hi


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def decompose(x: torch.Tensor, levels: int, wavelet: str) -> Pyramid:
    """[N, H, W] -> {(r, band): [N, h, w]}, each level vertical then
    horizontal."""
    out = {}
    for lev in range(1, levels + 1):
        r = levels - lev + 1
        lo, hi = (_t(a) for a in fwd_1d(_t(x), wavelet))
        x, out[(r, "HL")] = fwd_1d(lo, wavelet)
        out[(r, "LH")], out[(r, "HH")] = fwd_1d(hi, wavelet)
    out[(0, "LL")] = x
    return out


def reconstruct(pyr: Pyramid, levels: int) -> torch.Tensor:
    """Inverse of decompose's 5/3: horizontal then vertical, coarsest level
    first."""
    x = pyr[(0, "LL")]
    for r in range(1, levels + 1):
        lo = inv_1d(x, pyr[(r, "HL")])
        hi = inv_1d(pyr[(r, "LH")], pyr[(r, "HH")])
        x = _t(inv_1d(_t(lo), _t(hi)))
    return x


# ------------------------------------------------------------ whole frames

def _planes(frames: np.ndarray) -> torch.Tensor:
    """[N, H, W] or [N, H, W, C] samples -> [C, N, H, W] int64."""
    x = torch.from_numpy(np.asarray(frames).astype(np.int64))
    return x[None] if x.ndim == 3 else x.permute(3, 0, 1, 2)


def forward(frames: np.ndarray, cfg: Dict,
            dtype: Optional[torch.dtype] = None) -> List[Pyramid]:
    """Quantization indices (9/7) or coefficients (5/3) of each component
    of `frames` under cfg, one pyramid a component, int64."""
    codec = cfg["codec"]
    levels = codec["num_resolutions"] - 1
    x = _planes(frames)
    if not cfg["signed"]:
        x = x - (1 << (cfg["bits_stored"] - 1))
    mct = x.shape[0] >= 3 and codec.get("mct", True) is not False
    if codec["lossless"]:
        if mct:
            r, g, b = x[0], x[1], x[2]
            x = torch.stack([_floor_div(r + 2 * g + b, 4), b - g, r - g])
        wavelet = "5/3"
        x = x if dtype is None else x.to(dtype)
    else:
        wavelet = "9/7"
        x = x.to(dtype or torch.float32)
        if mct:
            x = torch.stack([m[0] * x[0] + m[1] * x[1] + m[2] * x[2]
                             for m in ICT])
    out = []
    for comp in x:
        pyr = decompose(comp, levels, wavelet)
        if codec["lossless"]:
            pyr = {k: torch.round(v).to(torch.int64)
                   if v.dtype.is_floating_point else v for k, v in pyr.items()}
        else:
            d = deltas(cfg)
            pyr = {k: (torch.sign(v) * torch.floor(
                torch.abs(v) / torch.tensor(d[k], dtype=v.dtype))
            ).to(torch.int64) for k, v in pyr.items()}
        out.append(pyr)
    return out


def inverse(pyrs: List[Pyramid], cfg: Dict,
            dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """Samples [N, H, W] or [N, H, W, C] from the components' 5/3
    coefficient pyramids (the lossless configurations' decode)."""
    codec = cfg["codec"]
    if not codec["lossless"]:
        raise ValueError("the reference decodes the lossless configurations")
    levels = codec["num_resolutions"] - 1
    comps = []
    for pyr in pyrs:
        if dtype is not None:
            pyr = {k: v.to(dtype) for k, v in pyr.items()}
        x = reconstruct(pyr, levels)
        comps.append(torch.round(x).to(torch.int64)
                     if x.dtype.is_floating_point else x)
    x = torch.stack(comps)
    if x.shape[0] >= 3 and codec.get("mct", True) is not False:
        y, u, v = x[0], x[1], x[2]
        g = y - _floor_div(u + v, 4)
        x = torch.stack([v + g, g, u + g])
    if not cfg["signed"]:
        x = x + (1 << (cfg["bits_stored"] - 1))
    x = x.numpy().astype(cfg["dtype"])
    return x[0] if x.shape[0] == 1 else np.moveaxis(x, 0, -1)
