"""One rank of the port's tile-sharded pipeline on a torch.distributed group,
for tests/test_torch_sharded_dist.py (gloo on the CPU) and
tests/test_torch_cuda.py (NCCL, one card a rank; or gloo with every rank
on one card).  Imports the port and torch only, never jax: the tests spawn
these ranks with torch.multiprocessing, and each encodes and decodes the
cases it is given and writes what it got, and the DWT kernels' launch
counts, to files of its own."""
import json
import pickle

import torch
import torch.distributed as dist


def run(rank: int, world: int, rdv: str, out_dir: str, dp: int, sp: int,
        cases, backend: str = "gloo", device: str = "cpu") -> None:
    from go_jpeg2000_tpu_torch.ops import dwt_cuda
    from go_jpeg2000_tpu_torch.parallel import (decode_sharded,
                                                encode_sharded, make_grid)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = "cuda"
    else:
        torch.set_num_threads(1)      # the ranks share the host's cores
    dwt_cuda.reset_counts()
    dist.init_process_group(backend, init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        grid = make_grid(dist.group.WORLD, dp=dp, sp=sp)
        got = []
        for image, opts, decode in cases:
            data = encode_sharded(image, opts, grid=grid, device=device)
            pix = (decode_sharded(data, grid=grid, device=device)
                   if decode else None)
            got.append((data, pix))
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
        with open(f"{out_dir}/rank{rank}_launches.json", "w") as f:
            json.dump(dict(dwt_cuda.LAUNCHES,
                           plain_levels=dwt_cuda.PLAIN_LEVELS), f)
    finally:
        dist.destroy_process_group()
