"""Scene `ct_phantom`: a series of axial CT slices through a Shepp-Logan-
like body of ellipsoids at Hounsfield values, the slices of one volume
at evenly spaced z, with noise correlated as a reconstruction kernel
makes it, air outside the body and the padding value outside the field
of view."""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.traffic.fields import blur121, uniform


def make(p: Dict, n: int, h: int, w: int, g, device) -> torch.Tensor:
    """HU values [n, h, w], float32: ellipsoids [cx, cy, cz, ax, ay, az,
    degrees, HU] painted in order over air, the first the body; slice i of
    n at z = -z_extent + 2 z_extent i / (n - 1)."""
    yy = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h * 2 - 1
    xx = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w * 2 - 1
    y, x = yy.view(1, h, 1), xx.view(1, 1, w)
    z = torch.linspace(-p["z_extent"], p["z_extent"], n,
                       device=device).view(n, 1, 1)
    hu = torch.full((n, h, w), float(p["air_hu"]), device=device)
    jit = p["jitter"]
    for cx, cy, cz, ax, ay, az, theta, val in p["ellipsoids"]:
        cx = cx + uniform(g, 1, -jit, jit, device)
        cy = cy + uniform(g, 1, -jit, jit, device)
        ax = ax * uniform(g, 1, 1 - jit, 1 + jit, device)
        ay = ay * uniform(g, 1, 1 - jit, 1 + jit, device)
        val = val * uniform(g, 1, 1 - p["hu_jitter"], 1 + p["hu_jitter"], device)
        c, s = math.cos(math.radians(theta)), math.sin(math.radians(theta))
        u = ((x - cx) * c + (y - cy) * s) / ax
        v = (-(x - cx) * s + (y - cy) * c) / ay
        hu = torch.where(u * u + v * v + ((z - cz) / az) ** 2 <= 1, val, hu)
    # [1, 2, 1] blurring leaves white noise 0.375 of its deviation
    noise = blur121(torch.randn((n, h, w), generator=g, device=device))
    hu = hu + (p["noise_hu"] / 0.375) * noise
    fov = x * x + y * y <= p["fov_radius"] ** 2
    return torch.where(fov, hu, float(p["padding_hu"]))
