"""The one generator of the benchmark's traffic: frames made from a seed.

A mix file (benchmark/traffic/<name>.json) names a `scene` and its
parameters; the scene is a file benchmark/traffic/scenes/<scene>.py whose
`make(params, n, h, w, generator, device)` gives n float frames [n, h, w]
or [n, h, w, C].  `frames(mix, cfg, seed, device)` makes the pool a run
cycles through, [pool_batches * frames_per_call, H, W(, C)], on `device`
with a torch.Generator seeded by `seed` and in a few whole-pool tensor
calls, then rounds and clamps it to the configuration's sample range and
dtype on the host.  The same seed on the same kind of device gives the
same frames.

The seed moves the content (positions, values, noise), never the shapes,
the number of frames or the mix of structures.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict

import numpy as np
import torch

SCENES = Path(__file__).resolve().parent / "scenes"


def _gen(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def scene(name: str):
    """The `make` of benchmark/traffic/scenes/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.traffic.scenes.{name}", SCENES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def frames(mix: Dict, cfg: Dict, seed: int, device) -> np.ndarray:
    """The run's pool of frames: pool_batches * frames_per_call frames of
    the configuration's shape and dtype, made from `seed`."""
    device = torch.device(device)
    n = mix["pool_batches"] * mix["frames_per_call"]
    h, w = cfg["rows"], cfg["columns"]
    x = scene(mix["scene"])(mix["scene_params"], n, h, w,
                            _gen(seed, device), device)
    bits = cfg["bits_stored"]
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if cfg["signed"]
              else (0, (1 << bits) - 1))
    x = torch.clamp(torch.round(x), lo, hi)
    # through int32: every stored sample fits it, and a cast from float
    # straight to uint16 is not on every device
    return x.to(torch.int32).cpu().numpy().astype(cfg["dtype"])
