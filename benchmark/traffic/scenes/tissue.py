"""Scene `tissue`: slide tiles in RGB: a white background, tissue whose
outline and texture come from smooth multi-scale noise, coloured by
Beer-Lambert absorption of two stains (eosin in the stroma, hematoxylin
in nuclei)."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.traffic.fields import smooth


def make(p: Dict, n: int, h: int, w: int, g, device) -> torch.Tensor:
    """RGB intensities [n, h, w, 3], float32 in [0, 255]."""
    outline = (smooth(g, n, h, w, p["outline_cells"], device)
               + 0.5 * smooth(g, n, h, w, 2 * p["outline_cells"], device))
    in_tissue = torch.sigmoid((outline - p["tissue_level"]) * p["edge"])
    texture = 0.6 * smooth(g, n, h, w, p["texture_cells"], device) \
        + 0.4 * smooth(g, n, h, w, 2 * p["texture_cells"], device)
    nuclei = torch.sigmoid(
        (smooth(g, n, h, w, p["nuclei_cells"], device) - p["nuclei_level"])
        * p["nuclei_edge"])
    eosin = in_tissue * (p["eosin"] * (1 + p["texture_amp"] * texture))
    hema = in_tissue * (p["hema_background"] + p["hema"] * nuclei)
    od = (eosin[..., None] * torch.tensor(p["eosin_od"], device=device)
          + hema[..., None] * torch.tensor(p["hema_od"], device=device))
    white = torch.tensor(p["background"], device=device)
    rgb = white * torch.exp(-od)
    noise = torch.randn((n, h, w, 3), generator=g, device=device)
    return rgb + p["noise"] * noise
