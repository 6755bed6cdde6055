"""The port's multi-host decomposition (go_jpeg2000_tpu_torch.parallel
.multihost, BASELINE config 5) on the CPU: separate OS processes, each
owning its tiles end to end, a pipe reduction server between them; and the
port's entry points (go_jpeg2000_tpu_torch.entry).

The JAX package's tests/test_multihost.py, case for case: every codestream
byte-identical to the port's single-process encode and, lossless, to the
JAX package's encode (lossy 9/7 too where the float32 lifting rounds
alike); decode_multihost equal to the port's decode; the gates raise as in
the JAX module.  entry's fused HT encode program runs on the CPU's
tensors; dryrun_multichip's four checks pass on a grid of one process and
on two gloo ranks."""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu_torch.entry import dryrun_multichip, entry
from go_jpeg2000_tpu_torch.models import rate
from go_jpeg2000_tpu_torch.ops import kernel_launches
from go_jpeg2000_tpu_torch.parallel import (decode_multihost,
                                            encode_multihost, multihost)


def _img(shape, seed=0, depth=8):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << depth, size=shape).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8 if depth <= 8 else np.uint16)


def _encode(img, opts):
    """(the port's encode, the JAX package's) of one image."""
    return (tp.encode(img, tp.options_from_reference(opts), device="cpu"),
            jp2k.encode(img, opts))


def test_inline_host_half_matches_encoder():
    img = _img((128, 128), 1)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                   tile_size=(64, 64))
    stats = {}
    data = encode_multihost(img, tp.options_from_reference(opts), n_hosts=1,
                            _stats=stats, device="cpu")
    assert (data, data) == _encode(img, opts)
    assert np.array_equal(tp.decode(data, device="cpu"), img)
    assert stats["compute_wall_s"] > 0 and stats["cpu_count"] >= 1
    # the CPU's tensors launch no kernel; the inline host reports its counts
    assert stats["host_launches"] == dict.fromkeys(kernel_launches(), 0)


def test_two_processes_byte_identical_ht():
    img = _img((128, 128, 3), 2)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                   tile_size=(64, 64), high_throughput=True)
    stats = {}
    data = encode_multihost(img, tp.options_from_reference(opts), n_hosts=2,
                            _stats=stats, device="cpu")
    assert (data, data) == _encode(img, opts)
    assert np.array_equal(tp.decode(data, device="cpu"), img)
    assert stats["gathered_bytes"] > 0
    assert stats["host_launches"] == dict.fromkeys(kernel_launches(), 0)


def test_four_processes_budgeted_pcrd():
    img = _img((128, 256), 3)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                   tile_size=(64, 64), num_layers=2, compression_ratio=6.0)
    stats = {}
    data = encode_multihost(img, tp.options_from_reference(opts), n_hosts=4,
                            _stats=stats, device="cpu")
    assert (data, data) == _encode(img, opts)
    # the bisection and the size probes crossed the process boundary
    assert stats["reduce_rounds"] >= 50
    assert tp.decode(data, device="cpu").shape == img.shape


def test_two_processes_byte_identical_lossy97():
    img = _img((128, 128, 3), 9)
    opts = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                      num_resolutions=3, tile_size=(64, 64),
                      high_throughput=True)
    data = encode_multihost(img, opts, n_hosts=2, device="cpu")
    assert data == tp.encode(img, opts, device="cpu")
    opts_b = tp.Options(format=tp.Format.J2K, lossless=False,
                        num_resolutions=3, tile_size=(64, 64), num_layers=2,
                        compression_ratio=12.0, high_throughput=True)
    data_b = encode_multihost(img, opts_b, n_hosts=2, device="cpu")
    assert data_b == tp.encode(img, opts_b, device="cpu")
    out = decode_multihost(data, n_hosts=2, device="cpu")
    assert np.array_equal(out, tp.decode(data, device="cpu"))


@pytest.mark.parametrize("n_hosts", [1, 4])
def test_hosts_lossy_budgeted_match_encode(n_hosts):
    img = _img((128, 128), 12)
    opts = tp.Options(format=tp.Format.J2K, lossless=False,
                      num_resolutions=3, tile_size=(64, 64), num_layers=2,
                      compression_ratio=12.0)
    data = encode_multihost(img, opts, n_hosts=n_hosts, device="cpu")
    assert data == tp.encode(img, opts, device="cpu")
    assert len(data) <= img.size / 12


def test_decode_multihost_pixel_identical():
    img = _img((128, 128, 3), 6)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                   tile_size=(64, 64), high_throughput=True)
    data = jp2k.encode(img, opts)
    out = decode_multihost(data, n_hosts=2, device="cpu")
    assert np.array_equal(out, tp.decode(data, device="cpu"))
    assert np.array_equal(out, img)
    assert np.array_equal(decode_multihost(data, n_hosts=1, device="cpu"),
                          img)


def test_multihost_gates():
    img = _img((64, 64), 5)
    for kw in (dict(enable_ppm=True), dict(enable_tlm=True)):
        with pytest.raises(ValueError):
            encode_multihost(img, tp.Options(lossless=True, **kw), n_hosts=2,
                             device="cpu")
    jp2 = tp.encode(img, tp.Options(lossless=True, num_resolutions=3),
                    device="cpu")
    with pytest.raises(ValueError):
        decode_multihost(jp2, n_hosts=2, device="cpu")
    j2k = tp.encode(img, tp.Options(format=tp.Format.J2K, lossless=True,
                                    num_resolutions=3), device="cpu")
    for cfg in (tp.Config(reduce_resolution=1),
                tp.Config(decode_area=(0, 0, 16, 16))):
        with pytest.raises(ValueError):
            decode_multihost(j2k, cfg, n_hosts=2, device="cpu")
    if not torch.cuda.is_available():
        # "cuda" without a card raises in the parent, before any spawn
        with pytest.raises(RuntimeError, match="CUDA"):
            encode_multihost(img, tp.Options(lossless=True), n_hosts=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            decode_multihost(j2k, n_hosts=2)


def test_host_halves_split_the_tiles():
    # the two hosts' halves own disjoint tiles whose union is every tile,
    # and their tile-parts gather into the single-process codestream
    img = _img((128, 192), 4)
    opts = tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=3,
                      tile_size=(64, 64), high_throughput=True)
    # one host's reducer stands in for both: without layers or a budget
    # no PCRD round runs
    parts = [multihost.host_encode_local(img, opts, h, 2,
                                         rate._np_allreduce, device="cpu")
             for h in range(2)]
    assert [t for t, _ in parts[0]] == [0, 2, 4]
    assert [t for t, _ in parts[1]] == [1, 3, 5]
    assert multihost._finalize(img, opts, parts[0] + parts[1], None) == \
        tp.encode(img, opts, device="cpu")
    pieces = multihost.host_decode_local(
        tp.encode(img, opts, device="cpu"), None, 1, 2, device="cpu")
    assert [t for t, _ in pieces] == [1, 3, 5]
    assert all(p.shape == (1, 64, 64) and p.dtype == np.uint8
               for _t, p in pieces)


def test_entry_runs_the_fused_encode_program():
    fn, args = entry(device="cpu")
    assert args[0].shape == (2, 1, 256, 256) and args[0].device.type == "cpu"
    pool, totals = fn(*args)
    assert pool.dtype == torch.int32 and totals.shape == (3,)
    assert int(totals.sum()) > 0


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip(n):
    dryrun_multichip(n, device="cpu")
