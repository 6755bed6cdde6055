"""The memos of models/fused_encode.py: the packet walk (t2_geom) is keyed
on the block plan and the progression order, and the block plan
(plan_for) on the code-block style among the rest.

A walk cached by the plan alone sent a PCRL encode that followed an LRCP
encode in one process down the LRCP packet order: bytes that a fresh
process does not write and the JAX package decodes to wrong pixels.  The
check encodes both in this process and holds the second stream against a
PCRL encode made in a fresh subprocess, which also decodes it with the JAX
package."""
import os
import subprocess
import sys

import numpy as np
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu_torch.models import encoder, fused_encode
from go_jpeg2000_tpu_torch.tcd import geometry as geo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRESH = """
import sys
import numpy as np
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models.decoder import decode as jax_decode
frame = np.load(sys.argv[1])
data = open(sys.argv[2], "rb").read()
opts = tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=4,
                  high_throughput=True,
                  progression_order=tp.options.ProgressionOrder.PCRL)
fresh = tp.encode_batch([frame], opts, device="cpu")[0]
print(int(fresh == data), int(np.array_equal(jax_decode(data), frame)))
"""


def _rgb():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, size=(64, 64, 3)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8)


def test_walk_follows_the_progression_order(tmp_path):
    frame = _rgb()
    order = tp.options.ProgressionOrder
    for po in (order.LRCP, order.PCRL):
        data = tp.encode_batch([frame], tp.Options(
            format=tp.Format.J2K, lossless=True, num_resolutions=4,
            high_throughput=True, progression_order=po), device="cpu")[0]
    np.save(tmp_path / "frame.npy", frame)
    (tmp_path / "pcrl.j2k").write_bytes(data)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-c", FRESH,
                          str(tmp_path / "frame.npy"),
                          str(tmp_path / "pcrl.j2k")], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.split()[-2:] == ["1", "1"], out.stdout + out.stderr


def test_plan_key_holds_the_code_block_style():
    """A style-0 Part-1 plan memoized first must not serve a header that
    differs only in its code-block style: plan_blocks refuses that style."""
    frame = _rgb()[:, :, 0]
    plans = []
    for style in (0, 0x02):                  # 0x02: RESET
        opts = tp.Options(format=tp.Format.J2K, lossless=True,
                          num_resolutions=4, code_block_style=style)
        header = encoder.build_header(frame, opts)
        plans.append(fused_encode.plan_for(header, geo.build_tile(header, 0),
                                           ht=False))
    assert plans[0] is not None and plans[1] is None
