"""What every operation shares, and how the harness finds one.

A mix's `operation` names a file benchmark/operations/<name>.py, which
defines OPERATION, a subclass of Operation.  An operation holds the pool
of inputs a run cycles through, makes each call into the port's entry
point (`call`), gives the control's answers in the program's place
(`control`: the reference one precision down), and, once the window has
closed, judges the answers it kept against the plain reference
(benchmark/reference/), which imports nothing of the program (`check`).
`check` returns {name: (reading, limit)}; a run is correct when no
reading passes its limit.

The port is reached through its module attributes at call time
(`encoder.encode_batch`), so the stage clock's wraps reach it.
"""
from __future__ import annotations

import importlib.util
import random
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .reference import codestream as ref_cs
from .reference import transform as ref_tf

Checks = Dict[str, Tuple[float, float]]
HERE = Path(__file__).resolve().parent


def options(cfg: Dict):
    """The port's Options for the configuration's `codec`."""
    import go_jpeg2000_tpu_torch as tp
    kw = dict(cfg["codec"])
    kw["format"] = tp.Format[kw["format"]]
    kw["progression_order"] = tp.ProgressionOrder[kw["progression_order"]]
    kw["code_block_size"] = tuple(kw["code_block_size"])
    return tp.Options(**kw)


def expected_header(cfg: Dict) -> Dict:
    """The main-header fields the configuration states."""
    codec = cfg["codec"]
    n = cfg["samples_per_pixel"]
    return {"width": cfg["columns"], "height": cfg["rows"],
            "precision": [cfg["bits_stored"]] * n,
            "signed": [cfg["signed"]] * n, "order": codec["progression_order"],
            "layers": codec["num_layers"],
            "mct": int(n >= 3 and codec.get("mct", True) is not False),
            "levels": codec["num_resolutions"] - 1,
            "cb_exp": tuple(codec["code_block_size"]),
            # the HT code-block style (Part 15), nothing else
            "cb_style": 0x40 if codec["high_throughput"] else 0,
            "transform": int(codec["lossless"]),
            "guard_bits": [3 if codec["high_throughput"] else 2] * n,
            "quant_style": [0 if codec["lossless"] else 2] * n,
            "steps": [ref_tf.steps(cfg, c) for c in range(n)],
            # Pcap bit 15: Part 15 capabilities are present
            "pcap": 1 << 17 if codec["high_throughput"] else 0,
            "other_markers": []}


def header_gaps(main: ref_cs.Main, want: Dict) -> List[str]:
    return [k for k, v in want.items() if getattr(main, k) != v]


class Operation:
    """The pool split into calls of frames_per_call frames."""

    def __init__(self, cfg: Dict, mix: Dict, pool: np.ndarray, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        f = self.frames = mix["frames_per_call"]
        self.inputs = [pool[i:i + f] for i in range(0, len(pool), f)]
        self.notes: List[str] = []

    @property
    def pixels_per_call(self) -> int:
        """Pixels a call codes, each once whatever its components."""
        return self.frames * self.cfg["rows"] * self.cfg["columns"]

    def setup(self) -> None:
        pass

    def short(self, answer) -> bool:
        """Whether a call's answer lacks some of its frames."""
        return len(answer) != self.frames

    def call(self, b: int):
        raise NotImplementedError

    def control(self, b: int):
        raise NotImplementedError

    def check(self, kept, rng: random.Random) -> Checks:
        raise NotImplementedError

    def note(self, text: str) -> None:
        if len(self.notes) < 5:
            self.notes.append(text)


def load(name: str, root: Path = HERE):
    """The Operation subclass benchmark/operations/<name>.py defines."""
    path = root / "operations" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.operations.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.OPERATION
