"""Multiple component transforms (ISO/IEC 15444-1 Annex G) as torch ops.

Port of go_jpeg2000_tpu/ops/mct.py: DC level shift, the exact integer RCT,
the float32 ICT and the clamp, element-wise on the tensor's own device.
Integer math is exact in int32; `>>` on a signed torch integer tensor is an
arithmetic shift (floor division by a power of two), as in jnp.  The ICT
uses the JAX package's float32 constants and its left-to-right sums, each
a separately rounded torch op, so it equals the JAX version bit for bit.
`CustomMCT` is the JAX package's stand-alone NxN matrix transform; no
option reaches it, in either package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# --- DC level shift (G.1.2) ------------------------------------------------

def dc_offset(precision: int, signed: bool) -> int:
    """The DC level shift: 2^(P-1) for unsigned samples, 0 for signed."""
    return 0 if signed else 1 << (precision - 1)


def dc_shift_forward(x: torch.Tensor, precision: int,
                     signed: bool) -> torch.Tensor:
    """Subtract 2^(P-1) from unsigned samples (no-op for signed)."""
    if signed:
        return x
    return x - dc_offset(precision, signed)


def dc_shift_inverse(x: torch.Tensor, precision: int,
                     signed: bool) -> torch.Tensor:
    if signed:
        return x
    return x + dc_offset(precision, signed)


def sample_range(precision: int, signed: bool) -> Tuple[int, int]:
    """The component's legal sample range (lo, hi)."""
    if signed:
        return -(1 << (precision - 1)), (1 << (precision - 1)) - 1
    return 0, (1 << precision) - 1


def clamp_to_precision(x: torch.Tensor, precision: int,
                       signed: bool) -> torch.Tensor:
    """Clamp reconstructed samples to the component's legal range."""
    return torch.clamp(x, *sample_range(precision, signed))


def narrow_dtype(precision: int, signed: bool,
                 narrow: bool = True) -> torch.dtype:
    """The dtype reconstructed samples narrow to: int8 or uint8 up to 8
    bits, int16 for 9 to 16 (an unsigned sample as its bit pattern, torch
    having little uint16 arithmetic), int32 above 16 bits and unnarrowed."""
    if narrow and precision <= 8:
        return torch.int8 if signed else torch.uint8
    if narrow and precision <= 16:
        return torch.int16
    return torch.int32


# --- Reversible color transform (G.2) --------------------------------------

def forward_rct(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Y = floor((R + 2G + B)/4); U = B - G; V = R - G.  Exact in int32."""
    r = r.to(torch.int32)
    g = g.to(torch.int32)
    b = b.to(torch.int32)
    y = (r + 2 * g + b) >> 2           # arithmetic shift == floor division
    u = b - g
    v = r - g
    return y, u, v


def inverse_rct(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact inverse: G = Y - floor((U+V)/4); R = V + G; B = U + G."""
    y = y.to(torch.int32)
    u = u.to(torch.int32)
    v = v.to(torch.int32)
    g = y - ((u + v) >> 2)
    r = v + g
    b = u + g
    return r, g, b


# --- Irreversible color transform (G.3, BT.601 weights) --------------------

_ICT_FWD = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float32).tolist()

_ICT_INV = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0],
], dtype=np.float32).tolist()


def forward_ict(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 (Y, Cb, Cr) from R, G, B (Equation G-5)."""
    r = r.to(torch.float32)
    g = g.to(torch.float32)
    b = b.to(torch.float32)
    m = _ICT_FWD
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b
    cb = m[1][0] * r + m[1][1] * g + m[1][2] * b
    cr = m[2][0] * r + m[2][1] * g + m[2][2] * b
    return y, cb, cr


def inverse_ict(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 R, G, B from (Y, Cb, Cr) (Equation G-6)."""
    y = y.to(torch.float32)
    cb = cb.to(torch.float32)
    cr = cr.to(torch.float32)
    m = _ICT_INV
    r = y + m[0][2] * cr
    g = y + m[1][1] * cb + m[1][2] * cr
    b = y + m[2][1] * cb
    return r, g, b


# --- Custom NxN MCT (Part 2 style) ------------------------------------------

class CustomMCT:
    """An arbitrary NxN decorrelation matrix applied across components.

    Forward multiplies the component vector by `matrix`, inverse by its
    inverse (numpy.linalg.inv, once, on the host); both contract in float32
    on the components' own device."""

    def __init__(self, matrix: np.ndarray):
        matrix = np.asarray(matrix, dtype=np.float64)
        if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
            raise ValueError("MCT matrix must be square")
        if abs(np.linalg.det(matrix)) < 1e-12:
            raise ValueError("MCT matrix is singular")
        self.matrix = matrix
        self.inverse = np.linalg.inv(matrix)

    @staticmethod
    def _apply(m: np.ndarray, comps) -> torch.Tensor:
        x = torch.as_tensor(comps).to(torch.float32)
        w = torch.as_tensor(m, dtype=torch.float32, device=x.device)
        return torch.einsum("ij,j...->i...", w, x)

    def forward(self, comps) -> torch.Tensor:
        """comps: [N, ...spatial] -> [N, ...spatial] float32."""
        return self._apply(self.matrix, comps)

    def backward(self, comps) -> torch.Tensor:
        return self._apply(self.inverse, comps)
