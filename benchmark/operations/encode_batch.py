"""`models.encoder.encode_batch` of frames_per_call frames a call.

The check, once the window has closed: every frame of the kept calls
must parse with the plain reader and carry the header the configuration
states; every frame of `valued_calls` of them, drawn from the seed, must
hold in each code-block the values of the reference transform (equal
under a lossless configuration, within the configuration's `limits`
under a lossy one); in `segment_frames` frames of each of those calls
every block's bytes must be the reference HT coder's on those values.
The control: the reference's own codestreams, its transform one
precision down (5/3 in float16, 9/7 with the ICT and quantizer in
bfloat16), written by the reference writer with the stated header.
"""
from __future__ import annotations

import random
from typing import List

from benchmark import judge
from benchmark.operation import Checks, Operation, expected_header, options


class EncodeBatch(Operation):

    def __init__(self, cfg, mix, pool, device):
        super().__init__(cfg, mix, pool, device)
        self.opts = options(cfg)

    def call(self, b: int) -> List[bytes]:
        from go_jpeg2000_tpu_torch.models import encoder
        return encoder.encode_batch(list(self.inputs[b]), self.opts,
                                    self.device)

    def control(self, b: int) -> List[bytes]:
        dtype = "float16" if self.cfg["codec"]["lossless"] else "bfloat16"
        want = expected_header(self.cfg)
        frames = self.inputs[b]
        return judge.pmap(judge.control_codestream,
                          [(f, self.cfg, want, dtype) for f in frames],
                          frames.size)

    def check(self, kept, rng: random.Random) -> Checks:
        want = expected_header(self.cfg)
        valued = set(rng.sample(range(len(kept)),
                                min(self.mix["valued_calls"], len(kept))))
        jobs, where, pixels = [], [], 0
        for k, (_n, b, out) in enumerate(kept):
            segs = (set(rng.sample(range(len(out)), min(
                self.mix["segment_frames"], len(out)))) if k in valued
                else set())
            for i, (data, frame) in enumerate(zip(out, self.inputs[b])):
                jobs.append((data, frame, self.cfg, want, k in valued,
                             i in segs))
                where.append((b, i))
                pixels += frame.size if k in valued else 0
        res = judge.pmap(judge.encoded_frame, jobs, pixels)
        for (b, i), r in zip(where, res):
            if r["unparsed"]:
                self.note(f"frame {i} of pool batch {b} does not parse: "
                          f"{r['unparsed']}")
            elif r["header"]:
                self.note(f"frame {i} of pool batch {b}: header fields "
                          f"{r['header']} differ")
        out = {"unparsed_frames": (sum(bool(r["unparsed"]) for r in res), 0),
               "header_mismatch": (sum(bool(r["header"]) for r in res), 0),
               "segment_mismatch": (sum(r["segments"] for r in res), 0)}
        values = sum(r["values"] for r in res)
        if self.cfg["codec"]["lossless"]:
            out["coefficient_mismatch"] = (values, 0)
        else:
            total = sum(r["total"] for r in res)
            lim = self.cfg["limits"]
            out["index_mismatch_ppm"] = (1e6 * values / max(1, total),
                                         lim["index_mismatch_ppm"])
            out["max_index_gap"] = (max(r["gap"] for r in res),
                                    lim["max_index_gap"])
        return out


OPERATION = EncodeBatch
