"""The controls: the reference put in the program's place, computed one
precision below the configuration's, must come out not correct.

    python3 -m benchmark.control --workload NAME --seeds 11,12,13 [--device cuda]

For each seed the cell's pool is made and the operation set up as a run
makes them (the decode cell's codestreams are the port's, the inputs it
decodes).  The control's answers (the operation's `control`: the
reference one precision down, benchmark/operations/<name>.py says which)
take the place of the port's answers to the calls a run keeps, and the
run's own `check` judges them, with the same limits.  Each seed prints a
JSON line; the exit code is 0 only if every seed reads not correct.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from typing import Dict

import torch

from . import operation
from .traffic import generate


def control(cell: Dict, seed: int, device) -> Dict:
    cfg, mix = cell["config"], cell["mix"]
    dev = torch.device(device)
    pool = generate.frames(mix, cfg, seed, dev)
    op = operation.load(mix["operation"])(cfg, mix, pool, dev)
    op.setup()
    rng = random.Random(seed)
    n = len(op.inputs)
    kept = []
    for k in range(mix["kept_calls"]):
        out = op.control(k % n)
        if op.short(out):
            raise RuntimeError(f"the control answered {len(out)} frames "
                               f"of {op.frames}")
        kept.append((k, k % n, out))
    checks = op.check(kept, rng)
    return {"seed": seed, "correct": all(v <= lim for v, lim in
                                         checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()},
            "notes": op.notes}


def main(argv=None) -> int:
    from .run import load_cell
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = control(cell, seed, args.device)
        res["workload"] = args.workload
        print(json.dumps(res), flush=True)
        ok = ok and not res["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
