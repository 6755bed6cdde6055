#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (go_jpeg2000_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and g++; builds every kernel it runs from the
sources in this checkout.  Phases, each of which raises on failure:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
2. build: the CUDA 5/3 and 9/7 level kernels (one nvcc per source, run in
   parallel) and the native HT coder (g++);
3. each kernel against its plain torch version on the card: the 5/3 pair at
   every level shape of a [32, 512, 512] batch down to 16x16, the 9/7 pair
   at every level shape of [16, 512, 512] down to 16x16, both at
   [1, 2048, 2048], [3, 2, 2] and [2, 6, 10]: exact equality required, and
   for 9/7 inverse(forward(x)) within 1e-3 of x; kernel and plain times
   with CUDA events at [32, 512, 512] (5/3) and [16, 512, 512] (9/7);
4. the lossless main path, through the public entry points: encode_batch
   then decode_batch on 32 gray 8-bit 512x512 frames with the bench
   headline options (HTJ2K, lossless 5/3, 6 resolutions, J2K), then on 4
   RGB frames.  Pixels must round-trip exactly, the codestreams must equal
   the CPU run's byte for byte, and every level must have gone through the
   5/3 kernels (launch counts > 0, no plain levels).  Then encode and
   decode wall Mpix/s after that warm-up;
5. the lossy main path, the same way: the JAX bench's htlossy97_512
   options (HTJ2K, 9/7 + ICT, quality 85, 6 resolutions, one layer) on 16
   gray 8-bit 512x512 frames, then on 2 RGB 8-bit 2048x2048 frames.  Every
   level must have gone through the 9/7 kernels (launch counts > 0, no
   plain levels), the codestreams must equal the CPU run's byte for byte
   and the decodes the CPU decodes; PSNR against the input, and encode and
   decode wall Mpix/s after that warm-up.

Each main path runs with the launch counts set to 0 just before it and
read just after.  The line before the last is a JSON summary of the
kernels; the last line is {"ok": true, "device": {...}}.  Without a CUDA
device it exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

H = W = 512
N_GRAY = 32
N_RGB = 4
N_LOSSY_GRAY = 16
LOSSY_RGB = (2, 2048, 2048)      # frames, height, width
SRC = {"dwt53": "go_jpeg2000_tpu_torch/csrc/dwt53.cu",
       "dwt97": "go_jpeg2000_tpu_torch/csrc/dwt97.cu"}
REPLACES = {"dwt53_fwd_level": "go_jpeg2000_tpu/ops/dwt_pallas.py:101",
            "dwt53_inv_level": "go_jpeg2000_tpu/ops/dwt_pallas.py:108",
            "dwt97_fwd_level": "go_jpeg2000_tpu/ops/dwt_pallas.py:116",
            "dwt97_inv_level": "go_jpeg2000_tpu/ops/dwt_pallas.py:123"}


def natural_image(h, w, seed=0):
    """Smooth 8-bit noise (bench.py's natural_image)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(dwt, dwt_cuda, dev, card, kind):
    """Phase 3: one kernel pair against its plain version at every level
    shape of a [n, 512, 512] batch down to 16x16 and at the odd cases, exact
    (for 9/7, inverse(forward(x)) within 1e-3 of x, for 5/3 equal to x);
    times at [n, 512, 512].  5/3: n = 32, int32 samples of 16 bits; 9/7:
    n = 16, float32 DC-shifted 8-bit samples, as the first level sees
    them."""
    lib = "dwt53" if kind == dwt.REV53 else "dwt97"
    n = N_GRAY if kind == dwt.REV53 else N_LOSSY_GRAY
    fwd_kernel = getattr(dwt_cuda, f"forward_2d_{kind}")
    inv_kernel = getattr(dwt_cuda, f"inverse_2d_{kind}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def sample(shape):
        if kind == dwt.REV53:
            return torch.randint(-(1 << 15), 1 << 15, shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.rand(shape, generator=gen, device=dev) * 255 - 128

    shapes = [(n, s, s) for s in (512, 256, 128, 64, 32, 16)]
    shapes += [(1, 2048, 2048), (3, 2, 2), (2, 6, 10)]
    err = {f"{lib}_fwd_level": 0, f"{lib}_inv_level": 0}
    for shape in shapes:
        x = sample(shape)
        got = fwd_kernel(x)
        ref = {k: v.contiguous() for k, v in dwt.forward_2d(x, kind).items()}
        fwd = max((got[k] - ref[k]).abs().max().item() for k in ref)
        inv_got = inv_kernel(ref)
        inv = (inv_got - dwt.inverse_2d(ref, kind)).abs().max().item()
        rt = (inv_got - x).abs().max().item()
        torch.cuda.synchronize()
        print(f"kernel check {lib} {shape}: fwd max|diff| {fwd}, inv "
              f"max|diff| {inv}, max|inv(fwd(x)) - x| {rt:.3g}", flush=True)
        if fwd or inv or not rt <= (0 if kind == dwt.REV53 else 1e-3):
            raise AssertionError(f"{lib} kernel disagrees with plain at "
                                 f"{shape}")
        err[f"{lib}_fwd_level"] = max(err[f"{lib}_fwd_level"], fwd)
        err[f"{lib}_inv_level"] = max(err[f"{lib}_inv_level"], inv)

    x = sample((n, H, W))
    bands = {k: v.contiguous() for k, v in dwt.forward_2d(x, kind).items()}
    times = {
        f"{lib}_fwd_level": (cuda_ms(lambda: fwd_kernel(x)),
                             cuda_ms(lambda: dwt.forward_2d(x, kind))),
        f"{lib}_inv_level": (cuda_ms(lambda: inv_kernel(bands)),
                             cuda_ms(lambda: dwt.inverse_2d(bands, kind))),
    }
    for name, (ms, plain_ms) in times.items():
        gbs = 8 * x.numel() / (ms * 1e-3) / 1e9
        print(f"time {name} [{n},{H},{W}]: kernel {ms:.4f} ms "
              f"({gbs:.1f} GB/s at 8 B/sample), plain torch "
              f"{plain_ms:.4f} ms [{card}]", flush=True)
    return err, times


def run_main_path(tp, dev):
    """Phase 4a: the counted main-path run; returns the streams."""
    opts = tp.Options(format=tp.Format.J2K, lossless=True,
                      num_resolutions=6, high_throughput=True)
    gray = [natural_image(H, W, seed=i) for i in range(N_GRAY)]
    rgb = [np.stack([natural_image(H, W, seed=100 + 3 * i + c)
                     for c in range(3)], axis=-1) for i in range(N_RGB)]
    out = {}
    for label, frames in (("gray", gray), ("rgb", rgb)):
        streams = tp.encode_batch(frames, opts, device=dev)
        decoded = tp.decode_batch(streams, device=dev)
        for d, f in zip(decoded, frames):
            if d.shape != f.shape or d.dtype != f.dtype \
                    or not np.array_equal(d, f):
                raise AssertionError(f"{label}: round trip is not exact")
        out[label] = (frames, streams)
        print(f"main path {label}: {len(frames)} frames {frames[0].shape} "
              f"round-trip exact, {sum(map(len, streams))} bytes",
              flush=True)
    return opts, out


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def run_lossy_path(tp, dev):
    """Phase 5a: the counted lossy main-path run; returns the runs."""
    opts = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                      num_resolutions=6, high_throughput=True)
    gray = [natural_image(H, W, seed=200 + i) for i in range(N_LOSSY_GRAY)]
    n, h, w = LOSSY_RGB
    rgb = [np.stack([natural_image(h, w, seed=300 + 3 * i + c)
                     for c in range(3)], axis=-1) for i in range(n)]
    out = {}
    for label, frames in (("lossy gray", gray), ("lossy rgb", rgb)):
        streams = tp.encode_batch(frames, opts, device=dev)
        decoded = tp.decode_batch(streams, device=dev)
        for d, f in zip(decoded, frames):
            if d.shape != f.shape or d.dtype != f.dtype:
                raise AssertionError(f"{label}: decoded {d.shape} "
                                     f"{d.dtype}, expected {f.shape} "
                                     f"{f.dtype}")
        out[label] = (frames, streams, decoded)
        print(f"main path {label}: {len(frames)} frames {frames[0].shape}, "
              f"{sum(map(len, streams))} bytes, PSNR "
              f"{min(psnr(d, f) for d, f in zip(decoded, frames)):.3f} dB "
              f"(lowest frame)", flush=True)
    return opts, out


def wall_mpix(tp, opts, frames, streams, dev, card, label):
    """Encode and decode wall Mpix/s, median of 3, after a warm-up."""
    mpix = len(frames) * frames[0].shape[0] * frames[0].shape[1] / 1e6
    enc_s, dec_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        tp.encode_batch(frames, opts, device=dev)
        t1 = time.perf_counter()
        tp.decode_batch(streams, device=dev)
        t2 = time.perf_counter()
        enc_s.append(t1 - t0)
        dec_s.append(t2 - t1)
    enc, dec = float(np.median(enc_s)), float(np.median(dec_s))
    print(f"wall {label} {len(frames)}x{frames[0].shape} (median of 3): "
          f"encode {mpix / enc:.2f} Mpix/s ({enc * 1e3:.1f} ms), decode "
          f"{mpix / dec:.2f} Mpix/s ({dec * 1e3:.1f} ms) [{card}]",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import go_jpeg2000_tpu_torch as tp
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.native import loader
    from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    dwt_cuda.load()
    t1 = time.perf_counter()
    if not loader.available():
        raise RuntimeError("native library j2k_native.cpp did not build")
    t2 = time.perf_counter()
    print(f"build: dwt53.cu and dwt97.cu (nvcc, in parallel) {t1 - t0:.1f} "
          f"s, j2k_native.cpp (g++) {t2 - t1:.1f} s", flush=True)

    err, times = check_kernels(dwt, dwt_cuda, dev, card, dwt.REV53)
    err97, times97 = check_kernels(dwt, dwt_cuda, dev, card, dwt.IRR97)
    err.update(err97)
    times.update(times97)

    dwt_cuda.reset_counts()
    opts, runs = run_main_path(tp, dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in dwt_cuda.LAUNCHES.items()
                if k.startswith("dwt53")}
    plain = dwt_cuda.PLAIN_LEVELS
    print(f"launches {launches}, plain levels {plain}", flush=True)
    if min(launches.values()) <= 0 or plain != 0:
        raise AssertionError("the main path did not run every level "
                             "through the kernels")

    for label, (frames, streams) in runs.items():
        if tp.encode_batch(frames, opts, device="cpu") != streams:
            raise AssertionError(f"{label}: CUDA and CPU codestreams differ")
        print(f"{label}: CUDA and CPU codestreams byte-identical",
              flush=True)

    frames, streams = runs["gray"]
    mpix = N_GRAY * H * W / 1e6
    enc_s, dec_s, fwd_s = [], [], []
    batch = np.stack(frames)[:, None]
    for _ in range(3):
        t0 = time.perf_counter()
        tp.encode_batch(frames, opts, device=dev)
        t1 = time.perf_counter()
        tp.decode_batch(streams, device=dev)
        t2 = time.perf_counter()
        flat = transforms.dispatch_forward_batch(batch, 5, dwt.REV53, False,
                                                 8, False, 0, 0, dev)
        flat.cpu()
        t3 = time.perf_counter()
        enc_s.append(t1 - t0)
        dec_s.append(t2 - t1)
        fwd_s.append(t3 - t2)
    enc, dec, fwd = (float(np.median(v)) for v in (enc_s, dec_s, fwd_s))
    print(f"wall {N_GRAY}x{H}x{W} gray (median of 3): encode "
          f"{mpix / enc:.2f} Mpix/s ({enc * 1e3:.1f} ms), decode "
          f"{mpix / dec:.2f} Mpix/s ({dec * 1e3:.1f} ms); of encode, the "
          f"device transform with upload and fetch {fwd * 1e3:.1f} ms "
          f"[{card}]", flush=True)

    dwt_cuda.reset_counts()
    lossy_opts, lossy_runs = run_lossy_path(tp, dev)
    torch.cuda.synchronize()
    lossy_launches = {k: v for k, v in dwt_cuda.LAUNCHES.items()
                      if k.startswith("dwt97")}
    plain = dwt_cuda.PLAIN_LEVELS
    print(f"lossy launches {lossy_launches}, plain levels {plain}",
          flush=True)
    if min(lossy_launches.values()) <= 0 or plain != 0:
        raise AssertionError("the lossy main path did not run every level "
                             "through the 9/7 kernels")
    launches.update(lossy_launches)

    for label, (frames, streams, decoded) in lossy_runs.items():
        if tp.encode_batch(frames, lossy_opts, device="cpu") != streams:
            raise AssertionError(f"{label}: CUDA and CPU codestreams differ")
        on_cpu = tp.decode_batch(streams, device="cpu")
        if not all(np.array_equal(d, c) for d, c in zip(decoded, on_cpu)):
            raise AssertionError(f"{label}: CUDA and CPU decodes differ")
        print(f"{label}: CUDA and CPU codestreams byte-identical, decodes "
              f"equal", flush=True)
    for label, (frames, streams, _dec) in lossy_runs.items():
        wall_mpix(tp, lossy_opts, frames, streams, dev, card, label)

    kernels = [{"name": name, "route": "cuda", "source": SRC[name[:5]],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
