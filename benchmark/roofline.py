"""Bytes a kernel must move, counted from shapes: the benchmark's frozen
copy of chip_smoke.py's DWT bound (a level reads each sample once and
writes each band sample once, 4 bytes each), summed over the levels."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM data sheet, 700 W


def dwt_bytes(planes: int, rows: int, columns: int, levels: int,
              sample_bytes: int = 4) -> int:
    """Bytes of `levels` 2-D levels of `planes` planes of rows x columns:
    each level reads its input (the previous level's LL, ceil(n / 2) of
    each axis) and writes as many band samples."""
    total = 0
    h, w = rows, columns
    for _ in range(levels):
        total += 2 * sample_bytes * planes * h * w
        h, w = (h + 1) // 2, (w + 1) // 2
    return total
