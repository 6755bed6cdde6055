"""Seeded fields the traffic scenes are made of: uniform draws, smooth
multi-scale noise and a [1, 2, 1] blur, on the device, drawn from one
torch.Generator."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def smooth(g, n: int, h: int, w: int, cells: int, device) -> torch.Tensor:
    """Smooth noise [n, h, w] in about [-1, 1]: a cells x cells grid of
    uniform values, upsampled bicubically."""
    coarse = torch.rand((n, 1, cells + 3, cells + 3), generator=g,
                        device=device) * 2 - 1
    big = F.interpolate(coarse, size=(h + 3 * h // cells, w + 3 * w // cells),
                        mode="bicubic", align_corners=False)
    return big[:, 0, h // cells:h // cells + h, w // cells:w // cells + w]


def blur121(x: torch.Tensor) -> torch.Tensor:
    """Separable [1, 2, 1] / 4 blur of [n, h, w], edges replicated."""
    k = torch.tensor([0.25, 0.5, 0.25], device=x.device).view(1, 1, 1, 3)
    y = F.conv2d(F.pad(x[:, None], (1, 1, 0, 0), mode="replicate"), k)
    y = F.conv2d(F.pad(y, (0, 0, 1, 1), mode="replicate"), k.transpose(2, 3))
    return y[:, 0]
