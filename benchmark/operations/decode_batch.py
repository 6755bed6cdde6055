"""`models.decoder.decode_batch` of frames_per_call codestreams a call,
which the port encodes from the pool at set-up (a lossless
configuration: the decode must give back the frames exactly).

The check, once the window has closed: every decoded sample of the kept
calls equals the frame its codestream was made from, which is what the
reference's decode works out from the inputs.  The control: the
reference decode, its inverse 5/3 in float16, on the same codestreams.
"""
from __future__ import annotations

import random
from typing import List

import numpy as np

from benchmark import judge
from benchmark.operation import Checks, Operation, options


class DecodeBatch(Operation):

    def __init__(self, cfg, mix, pool, device):
        if not cfg["codec"]["lossless"]:
            raise ValueError("the decode check holds a lossless "
                             "configuration to its input")
        super().__init__(cfg, mix, pool, device)
        self.originals = self.inputs

    def setup(self) -> None:
        from go_jpeg2000_tpu_torch.models import encoder
        opts = options(self.cfg)
        self.inputs = [encoder.encode_batch(list(x), opts, self.device)
                       for x in self.originals]

    def call(self, b: int) -> List[np.ndarray]:
        from go_jpeg2000_tpu_torch.models import decoder
        return decoder.decode_batch(self.inputs[b], None, self.device)

    def control(self, b: int) -> List[np.ndarray]:
        return judge.pmap(judge.control_decoded,
                          [(d, self.cfg, "float16") for d in self.inputs[b]],
                          self.originals[b].size)

    def check(self, kept, rng: random.Random) -> Checks:
        bad = 0
        for _n, b, out in kept:
            for i, (got, want) in enumerate(zip(out, self.originals[b])):
                if got.shape != want.shape or got.dtype != want.dtype:
                    bad += want.size
                    self.note(f"frame {i}: {got.shape} {got.dtype}, not "
                              f"{want.shape} {want.dtype}")
                else:
                    bad += int((got != want).sum())
        return {"sample_mismatch": (bad, 0)}


OPERATION = DecodeBatch
