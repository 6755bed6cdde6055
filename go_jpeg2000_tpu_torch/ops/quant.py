"""Quantization / dequantization (ISO/IEC 15444-1 Annex E).

Port of go_jpeg2000_tpu/ops/quant.py: the step-size math is host code copied
as it is; `quantize` and `dequantize` are torch ops on the tensor's own
device.  Reference parity: dwt.Quantize/Dequantize (go-jpeg2000
internal/dwt/dwt.go:500-522), extended to the full standard semantics:
deadzone scalar quantizer in sign-magnitude form, per-subband step sizes
from (exponent, mantissa), derived vs expounded styles, and the reversible
ranging rule.
"""
from __future__ import annotations

from typing import List

import torch

from ..codestream.header import Quantization, StepSize
from ..utils import markers as mk

# Subband log2 gains for the 5/3 reversible ranging rule (Equation E-4):
# eps_b = R_b + gain_b,  gain = 0 (LL), 1 (HL/LH), 2 (HH).
BAND_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


def quantize(coeffs: torch.Tensor, delta) -> torch.Tensor:
    """Deadzone quantize: q = sign(c) * floor(|c| / delta) (Equation E-1),
    in float32, then int32.  `delta` (a float or a float32 tensor) divides
    as a tensor on the coefficients' device: ATen's CUDA division by a host
    scalar multiplies by its reciprocal instead, which rounds differently
    from the true division of the JAX package and of the CPU."""
    c = coeffs.to(torch.float32)
    d = torch.as_tensor(delta, dtype=torch.float32, device=c.device)
    return (torch.sign(c) * torch.floor(torch.abs(c) / d)).to(torch.int32)


def dequantize(q: torch.Tensor, delta, r: float = 0.5) -> torch.Tensor:
    """Midpoint reconstruction: c = sign(q) * (|q| + r) * delta for q != 0
    (E.1.1.2 decoder reconstruction with bias r), float32.  `delta` is a
    float or a float32 tensor that broadcasts against q."""
    qa = torch.abs(q).to(torch.float32)
    rec = (qa + r) * delta
    return torch.where(q == 0, torch.zeros_like(rec),
                       torch.sign(q).to(torch.float32) * rec)


def effective_step(quant: Quantization, res: int, band: str,
                   num_decomps: int, dynamic_range_bits: int) -> float:
    """Step size Delta_b for a band at resolution `res`.

    For derived quantization only the LL step is signalled; bands derive as
    Delta_b = Delta_LL * 2^(-n_b) ... per Equation E-5:
    eps_b = eps_0 - NL + n_b, with mantissa shared.
    """
    if quant.style == mk.QUANT_NONE:
        return 1.0
    band_idx = {"HL": 0, "LH": 1, "HH": 2}.get(band, 0)
    if quant.style == mk.QUANT_SCALAR_DERIVED:
        s0 = quant.step_sizes[0]
        # n_b = decomposition level of the band = NL - res + 1 for res>=1,
        # NL for the res-0 LL.
        nb = num_decomps - res + 1 if res >= 1 else num_decomps
        eps = s0.exponent - num_decomps + nb
        st = StepSize(mantissa=s0.mantissa, exponent=max(0, min(31, eps)))
    else:
        st = quant.step_for_band(res, band_idx)
    return st.value(dynamic_range_bits)


def band_eps(quant: Quantization, res: int, band: str, num_decomps: int) -> int:
    """Exponent eps_b for a band (used for Mb = guard + eps - 1)."""
    band_idx = {"HL": 0, "LH": 1, "HH": 2}.get(band, 0)
    if quant.style == mk.QUANT_SCALAR_DERIVED:
        s0 = quant.step_sizes[0]
        nb = num_decomps - res + 1 if res >= 1 else num_decomps
        return max(0, s0.exponent - num_decomps + nb)
    return quant.step_for_band(res, band_idx).exponent


def max_bitplanes(quant: Quantization, res: int, band: str,
                  num_decomps: int) -> int:
    """Mb = guard_bits + eps_b - 1 (Equation E-2)."""
    return quant.guard_bits + band_eps(quant, res, band, num_decomps) - 1


def make_reversible_quant(precision: int, num_decomps: int,
                          guard_bits: int = 2) -> Quantization:
    """Build the QCD for reversible (no-quantization) coding: one exponent
    per subband, eps_b = precision + gain_b."""
    steps: List[StepSize] = [StepSize(0, precision + BAND_GAIN["LL"])]
    for _ in range(num_decomps):
        for band in ("HL", "LH", "HH"):
            steps.append(StepSize(0, precision + BAND_GAIN[band]))
    # Signalled order is LL then per level coarsest-to-finest groups of
    # (HL, LH, HH); with uniform gains the order is immaterial.
    return Quantization(style=mk.QUANT_NONE, guard_bits=guard_bits, step_sizes=steps)


def make_irreversible_quant(precision: int, num_decomps: int, base_delta: float,
                            guard_bits: int = 2) -> Quantization:
    """Expounded scalar quantization with per-band steps scaled by the 9/7
    synthesis-basis L2 norms, so distortion is balanced across subbands.

    Signalling order (Table A.28 / step_for_band): LL first, then for each
    resolution level r = 1..NL (coarsest LL-adjacent first): HL, LH, HH of
    decomposition level NL - r + 1.
    """
    steps: List[StepSize] = []

    def step_for(nb: int, band: str) -> StepSize:
        # delta_b = base / ||synthesis basis||_2 — OpenJPEG's exact rule
        # (stepsize = (1 << gain) / opj_dwt_getnorm_real, gain 0 for 9/7),
        # balancing image-domain MSE across subbands
        delta = base_delta / band_norm(False, band, nb)
        delta = min(max(delta, 2.0 ** -20), 2.0 ** 20)
        return StepSize.from_delta(delta, precision)

    steps.append(step_for(num_decomps, "LL"))
    for r in range(1, num_decomps + 1):
        nb = num_decomps - r + 1
        for band in ("HL", "LH", "HH"):
            steps.append(step_for(nb, band))
    return Quantization(style=mk.QUANT_SCALAR_EXPOUNDED, guard_bits=guard_bits,
                       step_sizes=steps)


# 1-D L2 norms of the 9/7 synthesis lowpass/highpass basis functions by
# decomposition level (level 1 first); standard values used by OpenJPEG's
# rate allocation (opj_dwt_getnorm_real equivalents).
L2_LOW = [1.0, 1.0324569, 1.4956348, 2.0773770, 2.9254791, 4.1317438,
          5.8408704, 8.2569534, 11.6755671, 16.5101594, 23.3473483]
L2_HIGH = [1.0, 1.0458836, 1.2644064, 1.6719544, 2.2923089, 3.2137514,
           4.5307723, 6.3982064, 9.0442674, 12.7899275, 18.0867824]
K_L2 = 1.0

# 2-D synthesis-basis L2 norms per band and decomposition level — the
# standard MSE weights (identical to OpenJPEG's opj_dwt_norms /
# opj_dwt_norms_real tables; ISO 15444-1 Annex J.4 energy-gain factors).
# Index: HL/LH/HH at decomposition level nb -> tab[band][nb - 1];
# LL at top level nb -> tab["LL"][nb].
_N53_HL = [1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9]
_N97_HL = [2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0]
BAND_NORMS_53 = {
    "LL": [1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7,
           341.3],
    "HL": _N53_HL, "LH": _N53_HL,
    "HH": [.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93],
}
BAND_NORMS_97 = {
    "LL": [1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3, 270.6,
           540.9],
    "HL": _N97_HL, "LH": _N97_HL,
    "HH": [2.080, 3.865, 8.307, 17.18, 34.71, 69.59, 139.3, 278.6],
}


def band_norm(reversible: bool, band: str, dec_level: int) -> float:
    """Tabulated band norm (the OpenJPEG opj_dwt_norms convention), used as
    the step-size DIVISOR in make_irreversible_quant."""
    tab = BAND_NORMS_53 if reversible else BAND_NORMS_97
    lst = tab[band]
    idx = dec_level if band == "LL" else dec_level - 1
    idx = max(0, min(idx, len(lst) - 1))
    return lst[idx]


def band_norm_true(reversible: bool, band: str, dec_level: int) -> float:
    """TRUE synthesis L2 gain of one band coefficient under THIS pipeline's
    DWT normalization: a unit coefficient at (band, dec_level) synthesizes
    to an image patch of this L2 norm (distortion in coefficient units
    times norm^2 = image-domain MSE contribution) — the PCRD distortion
    weight the reference never computes (CodingPass.Slope unused,
    go-jpeg2000 internal/tcd/tcd.go:141).

    Measured by impulse synthesis (r5): the 5/3 tables match our DWT
    exactly, but the 9/7 tables assume a normalization 2^gain above ours —
    true norm = table / 2^gain (2x for HL/LH, 4x for HH).  Using the raw
    table as a PCRD weight over-favored HH passes 16x and cost ~0.5-0.7 dB
    vs OpenJPEG at 20:1 (the r4 gap).  The quantizer construction is
    unaffected: its table-divisor convention composes with the E-3
    2^gain dynamic-range factor so effective steps are already
    true-norm-proportional."""
    n = band_norm(reversible, band, dec_level)
    return n if reversible else n / (1 << BAND_GAIN[band])
