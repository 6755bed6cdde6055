#!/usr/bin/env python3
"""Times the Part-1 decision kernel (ebcot_decision_slots), the decision
compaction (ebcot_compact_rows), the MQ coder (ebcot_mq_encode), the
segment pool (ebcot_pool_rows), the HT block extraction
(ht_extract_blocks) and block-to-pyramid assembly (ht_blocks_to_pyramid),
cleanup-field kernel (ht_cleanup_fields), bit packer
(ht_pack_bits) and pool compaction (ht_compact_pool), the HT MagSgn decoder
(ht_magsgn_decode), the 5/3 levels (dwt53_fwd_level, dwt53_inv_level) and
the 9/7 levels (dwt97_fwd_level, dwt97_inv_level) of one checkout of the
PyTorch/CUDA port on one CUDA device, at the shapes of chip_smoke.py, and
prints one JSON line.

    python3 kernel_times.py [--tree DIR] [--ptxas] [--config4] [--dwt-only]
                            [--halo-only]

DIR is the root of a checkout of the repository (default: the directory of
this script).  Its go_jpeg2000_tpu_torch is imported and its CUDA sources
are built, so a parent and a change, each unpacked into its own directory,
can be timed in turns (parent, change, change, parent) on one card.  The
inputs are made by the checkout's own kernels from chip_smoke.py's frame
generators (this script's copy):
- decisions: the Part-1 gray batch (8 gray 512x512 frames, 560 blocks of
  64x64, 11 planes); compaction: its slots, the two kernels launched
  through the library's C entry points with the pool sized beforehand
  (the wrapper reads the total back, which a time alone cannot hold):
  ebcot_chunk_count and ebcot_chunk_write (a CTA per row and chunk of
  ebcot_cuda.COMPACT_CHUNK bytes) where the checkout has them, else
  ebcot_compact_count and ebcot_compact_write (a CTA per row);
- MQ: the decision pool of the same batch;
- segment pool: the MQ rows of the same batch, through the C entry point
  ebcot_pool_rows with the pool sized beforehand (the same arguments in
  every checkout);
- extraction: the pyramids of the HT lossless gray batch (32 gray 512x512
  frames, 2240 blocks) and of a config-4 tile-origin class, lossless (64
  tiles of 512x512 16-bit RGB, 12,864 blocks) and lossy (the image >> 8
  at quality 85), launched through the C entry point with its static half
  already on the card (the slot descriptors where the checkout has them,
  else a parent's band table, which its wrapper uploads on every call),
  and through the Python wrapper (by CUDA events, alone where it does not
  wait for the card, and its host time a call while the card is busy);
- assembly: the blocks of the same three batches (the lossy class's
  dequantized to float32 leaves), through the Python wrapper, by CUDA
  events, alone and its host time (on the gray batch also the host time
  of making its leaf views: one as_strided a leaf, or one split and a view
  a leaf); on the two lossless batches both
  layout kernels' library calls in the same run (torch.take over the
  flat pyramid, Tensor.index_copy_ into it, indices made beforehand);
- cleanup: the blocks of the same three batches;
- packing: the three streams' fields of the same three batches (made by
  the checkout's cleanup kernel), packed by pack_bits, one call a stream,
  which every checkout has, and, where the checkout has it, by
  pack_streams, one launch for the three;
- pool compaction: the packed streams of the same three batches, through
  the C entry point ht_compact_pool with the output sized beforehand;
- MagSgn decode: the native parse of the HT lossless gray batch's
  streams (2240 blocks) and of a config-4 class's lossless and lossy
  (the image >> 8 at quality 85) streams (12,864 blocks each), made by the
  checkout's encode_batch;
- 5/3: forward_2d_53 on int32 [32, 512, 512] (the HT lossless batch's
  level 1) and [768, 512, 512] (config 4's level 1), and inverse_2d_53 on
  the bands it returns;
- 9/7: forward_2d_97 on float32 [16, 512, 512] (the HT lossy batch's level
  1) and [768, 512, 512] (config 4's lossy level 1), and inverse_2d_97 on
  the bands it returns;
- even levels off the 32-row strip: the four levels through the
  wrappers on [24, 1080, 1920], [24, 540, 960], [24, 270, 480] (the 1080p
  batch's levels 1-3) and [768, 16, 16];
- odd geometry: both 5/3 and both 9/7 levels through
  transforms.forward_level and inverse_level on [1, 1079, 1919] at origin
  (1, 1) and [24, 135, 240] (the 1080p batch's level 4) at origin (0, 0):
  the kernels where the checkout's dwt_cuda.usable takes such a level,
  else (a parent's) the plain lifting, with the plain levels a call
  counts; and chip_smoke.py's S4 (750x1000 gray at odd image and tile
  offsets, 12 tiles) through encode and decode, its launches and plain
  levels, and the median of 5 walls of each on the host's clock.
Each kernel: mean of 20 calls by CUDA events after 3 warm-ups, and the
kernel's device time alone (chip_smoke.py device_ms: the calls queued
behind a spin kernel); the MQ coder's cycles per
decision of the longest block from the CUDA-event time at 1.98 GHz.  The
two pool compactions also by CUDA events around their Python wrappers,
and beside the time alone of one torch copy_ of their output's bytes;
and the launch floor, a one-element add_ alone.
- halo form: the four level kernels on sp = 2 and 4 row shards of config
  4's level 1 [768, 512, 512] (sharded.forward_level_split and
  inverse_level_split: every shard's edges, then its level launch), and,
  where the checkout has the edge packing kernel, its sp packing launches
  and its sp level launches (on edges packed beforehand), each alone.
--dwt-only times the launch floor, the DWT levels (even, odd and the halo
form) and S4 only; --halo-only the launch floor and the halo form only.
--config4 also times config 4's lossless encode (8192x8192 16-bit RGB,
512x512 tiles, 5 resolutions) in chip_smoke.py's stages, medians of 3
after a warm-up: the transform step (the level kernels and band_stats)
and the HT kernels (per tile-origin class: the gather, extraction,
cleanup, packing and compaction), each synchronised; and the lossy leg
(the image >> 8 at quality 85): the encode's transform step and the
decode's inverse step, where the level kernels' savings should show end to
end; then the same lossless steps, and the decode's MagSgn and assembly
step and inverse step, with every kernel wrapper swapped for its plain
torch version on the card (plain_kernels: the composite rows' "plain"
time), medians of 2 after a warm-up.
--ptxas also compiles the checkout's ht_enc.cu, ht_dec.cu, ebcot_enc.cu,
dwt53.cu and dwt97.cu with -Xptxas -v and reports the registers, spills
and static shared memory of the kernels KERNELS names, from cuobjdump
-sass their instructions, barriers, shared-memory accesses, reciprocals
(integer divisions), shuffles and FMAs, and for the decision and MagSgn
kernels the CTAs an SM holds for 64x64 blocks (by registers, threads and
shared memory, the checkout's own CTA size and dynamic shared memory).
--profiler-probe N, after everything else, traces five forward 9/7 levels
at [768, 512, 512] under torch.profiler N times, 30 s apart, and reports
how many of their kernel events the trace kept and their mean duration,
with no tail and a 50 ms tail after the synchronise, beside the time
alone by chip_smoke.py's device_ms (which the profiler no longer gives).
Without a CUDA device it exits 1 and prints nothing.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

T0 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
# the kernels whose ptxas figures --ptxas reports
KERNELS = ("extract_kernel", "to_pyramid_kernel", "fields_kernel",
           "mq_kernel", "pack_kernel", "dwt53_fwd_kernel", "dwt53_inv_kernel",
           "dwt97_fwd_kernel", "dwt97_inv_kernel",
           "decision_kernel", "block_stats_kernel", "magsgn_kernel",
           "count_kernel", "compact_write_kernel", "chunk_count_kernel",
           "chunk_write_kernel", "rows_scan_kernel", "compact_scan_kernel",
           "compact_copy_kernel", "lens_scan_kernel", "pool_copy_kernel",
           "ht_pool_scan_kernel", "ht_pool_copy_kernel", "seg_pool_kernel")
# H100 SM limits for the occupancy lines: registers, threads, CTAs, shared
# memory (each CTA also reserves 1 KB)
SM_REGS, SM_THREADS, SM_CTAS, SM_SMEM = 65536, 2048, 32, 233472


# SASS opcodes counted per kernel: barriers, shared-memory loads and
# stores, reciprocals (integer divisions), shuffles, fused multiply-adds
SASS_OPS = ("BAR", "LDS", "STS", "MUFU.RCP", "SHFL", "FFMA")


def ptxas(tree, cuda_build):
    """({kernel symbol: ptxas' resource line}, {kernel symbol: SASS opcode
    counts}) for the kernels KERNELS names, from the tree's sources, built
    with the tree's nvcc flags."""
    out, sass = {}, {}
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    for src in ("ht_enc.cu", "ht_dec.cu", "ebcot_enc.cu", "dwt53.cu",
                "dwt97.cu"):
        path = os.path.join(tree, "go_jpeg2000_tpu_torch", "csrc", src)
        build = os.path.join(tree, "go_jpeg2000_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            flags = [f for f in cuda_build.NVCC_FLAGS
                     if f not in ("-shared", "-Xcompiler", "-fPIC")]
            res = subprocess.run(
                [cuda_build.nvcc()] + flags
                + ["-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "k.o"), path],
                capture_output=True, text=True, check=True, timeout=600)
            dump = subprocess.run(
                [cuobjdump, "-sass", os.path.join(tmp, "k.o")],
                capture_output=True, text=True, check=True, timeout=600)
        out.update(ptxas_lines(res.stderr))
        sass.update(sass_counts(dump.stdout))
    return out, sass


def instance_name(m):
    """A kernel's name from a match of its mangled symbol, with the
    instance of a kernel templated on bools, e.g. <false, true> (the DWT
    levels' ODD, then SHARD: <false, ...> is the even-geometry instance,
    <..., true> a row shard's)."""
    if not m.group(2):
        return m.group(1)
    flags = re.findall(r"Lb([01])E", m.group(2))
    return m.group(1) + "<" + ", ".join(
        "true" if f == "1" else "false" for f in flags) + ">"


def sass_counts(text):
    """{kernel: {"instructions": n, opcode: n for SASS_OPS}} from
    cuobjdump -sass, for the kernels KERNELS names."""
    out = {}
    for part in text.split("Function : ")[1:]:
        m = re.match(r"_Z\d+(" + "|".join(KERNELS) + r")(I(?:Lb[01]E)+E)?",
                     part)
        if not m:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", part)
        out[instance_name(m)] = dict(
            instructions=len(ops),
            **{k: sum(o.startswith(k) for o in ops) for k in SASS_OPS})
    return out


def ptxas_lines(text):
    """{kernel: "stack, spills; registers, barriers, smem"} from nvcc's
    -Xptxas -v output, for the kernels KERNELS names."""
    out = {}
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '_Z\d+(" + "|".join(KERNELS)
                      + r")(I(?:Lb[01]E)+E)?", line)
        if m:
            props = [x.split("ptxas info    :")[-1].strip()
                     for x in lines[i + 1:i + 4]
                     if "stack frame" in x or "Used" in x]
            out[instance_name(m)] = "; ".join(props)
    return out


def ctas_per_sm(line, threads, dyn_smem):
    """CTAs of `threads` threads an H100 SM holds for a kernel with ptxas'
    resource line and `dyn_smem` bytes of dynamic shared memory: the least
    of the register, thread, CTA and shared-memory limits (registers are
    allocated per warp in units of 256)."""
    regs = int(re.search(r"Used (\d+) registers", line).group(1))
    m = re.search(r"(\d+) bytes smem", line)
    smem = (int(m.group(1)) if m else 0) + dyn_smem
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return {"threads": threads, "registers": regs, "smem_bytes": smem,
            "ctas_per_sm": min(SM_REGS // (per_warp * warps),
                               SM_THREADS // threads, SM_CTAS,
                               SM_SMEM // (smem + 1024))}


def occupancy(lines, ebcot_cuda, ht_dec_cuda):
    """ctas_per_sm of the decision and MagSgn kernels for 64x64 blocks,
    with the checkout's CTA sizes (the parent's: 512 decision threads and
    3 (h+2)(w+2) + h w / 4 bytes, a MagSgn thread per quad)."""
    if hasattr(ebcot_cuda, "decision_smem"):
        dec = (ebcot_cuda.DEC_THREADS, ebcot_cuda.decision_smem(64, 64))
    else:
        dec = (512, 3 * 66 * 66 + 16 * 64)
    ms = getattr(ht_dec_cuda, "MS_THREADS", 1024)
    out = {}
    for name, (threads, dyn) in (("decision_kernel", dec),
                                 ("magsgn_kernel", (ms, 0))):
        if name in lines:
            out[name] = ctas_per_sm(lines[name], threads, dyn)
    return out


def extract_call(ht_enc_cuda, pyr, plan, n, levels):
    """ht_extract_blocks through the library's C entry point with its
    static half already on the card: the slot descriptors and leaf pointers
    (ht_enc_cuda.extract_layout) where the checkout has them, else a
    parent's band table, built and uploaded once as its wrapper builds it
    (that wrapper uploads it on every call).  Returns (launch function,
    output)."""
    import ctypes
    import torch
    lib = ht_enc_cuda.load()
    lossy = plan.deltas is not None
    spec = plan.band_specs[0]
    dev = ht_enc_cuda.band_leaf(pyr, spec[1], spec[2], levels).device
    out = torch.empty((n * plan.nb, plan.cbh, plan.cbw), dtype=torch.int32,
                      device=dev)
    if hasattr(ht_enc_cuda, "extract_layout"):
        keys, _shapes, table_dev = ht_enc_cuda.extract_layout(
            plan, n, pyr[0]["HL"].shape[1], levels, dev)
        leaves = [pyr[lv][band].contiguous() for lv, band in keys]
        ptrs = (ctypes.c_void_p * len(leaves))(
            *[leaf.data_ptr() for leaf in leaves])
        args = (table_dev.data_ptr(), ptrs, len(leaves), n, plan.nb,
                plan.cbh, plan.cbw, int(lossy), out.data_ptr())
    else:
        leaves = [ht_enc_cuda.band_leaf(pyr, lev, name, levels).contiguous()
                  for (_c, lev, name, *_rest) in plan.band_specs]
        table = np.zeros((len(leaves), ht_enc_cuda.BAND_FIELDS), np.int64)
        slot = 0
        for bi, (leaf, spec) in enumerate(zip(leaves, plan.band_specs)):
            c, _lev, _name, gy, gx, eh, ew, bh, bw, oy, ox = spec
            delta = np.float32(plan.deltas[bi] if lossy else 1.0)
            table[bi] = (leaf.data_ptr(), c, bh, bw, gx, eh, ew, oy, ox,
                         slot, int(delta.view(np.int32)))
            slot += gy * gx
        table_dev = torch.from_numpy(table).to(dev)
        args = (table_dev.data_ptr(), len(leaves), leaves[0].shape[1], n,
                plan.nb, plan.cbh, plan.cbw, int(lossy), out.data_ptr())

    def fn():
        rc = lib.ht_extract_blocks(*args,
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ht_extract_blocks: CUDA error {rc}")
        # the table and the leaves live as long as fn
        return table_dev, leaves
    return fn, out


def layout_library(cs, ht_enc_cuda, ht_dec_cuda, pyr, blocks, plan, n,
                   levels):
    """The lossless layout kernels' library calls in this run: torch.take
    for the extraction and Tensor.index_copy_ for the assembly, each by
    CUDA events and alone (chip_smoke.py extract_library_ms,
    assemble_library_ms)."""
    take = cs.extract_library_ms(ht_enc_cuda, pyr, plan, n, levels)
    copy = cs.assemble_library_ms(ht_dec_cuda, blocks, plan, n,
                                  pyr[0]["HL"].shape[1], levels)
    return ({"what": "torch.take", "ms": take[0], "alone_ms": take[1]},
            {"what": "Tensor.index_copy_", "ms": copy[0],
             "alone_ms": copy[1]})


def compact_call(ebcot_cuda, slots, total):
    """ebcot_compact_rows' kernels through the library's C entry points
    with the decision pool allocated at its known total (no read-back):
    the chunked entries where the checkout has them, else the per-row
    ones.  Returns (launch function, pool, the entries' names)."""
    import torch
    nb, t = slots.shape
    dev = slots.device
    ndec = torch.zeros(nb, dtype=torch.int32, device=dev)
    off = torch.zeros(nb, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    pool = torch.empty(total, dtype=torch.uint8, device=dev)
    lib = ebcot_cuda.load()
    if hasattr(ebcot_cuda, "COMPACT_CHUNK"):
        chunk = ebcot_cuda.COMPACT_CHUNK
        counts = torch.empty(nb * -(-t // chunk), dtype=torch.int32,
                             device=dev)
        calls = (("ebcot_chunk_count",
                  (slots.data_ptr(), nb, t, chunk, counts.data_ptr(),
                   ndec.data_ptr(), off.data_ptr(), stats.data_ptr())),
                 ("ebcot_chunk_write",
                  (slots.data_ptr(), nb, t, chunk, counts.data_ptr(),
                   off.data_ptr(), pool.data_ptr())))
    else:
        calls = (("ebcot_compact_count",
                  (slots.data_ptr(), nb, t, ndec.data_ptr(), off.data_ptr(),
                   stats.data_ptr())),
                 ("ebcot_compact_write",
                  (slots.data_ptr(), nb, t, off.data_ptr(),
                   pool.data_ptr())))

    def fn():
        stream = torch.cuda.current_stream().cuda_stream
        for sym, args in calls:
            rc = getattr(lib, sym)(*args, stream)
            if rc:
                raise RuntimeError(f"{sym}: CUDA error {rc}")
        return pool
    return fn, pool, [sym for sym, _a in calls]


def pool_call(ht_enc_cuda, pool_args):
    """ht_compact_pool through the library's C entry point with its output,
    offsets and totals allocated beforehand, as ht_enc_cuda.assemble_pool
    allocates them: (launch function, output, totals)."""
    import torch
    ms_w, ms_b, vlc_w, vlc_b, mel_w, mel_b, numbps, u_max, dist = pool_args
    nb = ms_w.shape[0]
    widths = [int(w.shape[1]) for w in (ms_w, vlc_w, mel_w)]
    dev = ms_w.device
    out = torch.empty(nb * (6 + sum(widths)), dtype=torch.int32, device=dev)
    offs = torch.empty(3 * nb, dtype=torch.int64, device=dev)
    totals = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = ht_enc_cuda.load()

    def fn():
        rc = lib.ht_compact_pool(
            ms_w.data_ptr(), widths[0], ms_b.data_ptr(), vlc_w.data_ptr(),
            widths[1], vlc_b.data_ptr(), mel_w.data_ptr(), widths[2],
            mel_b.data_ptr(), numbps.data_ptr(), u_max.data_ptr(),
            dist.data_ptr(), nb, offs.data_ptr(), totals.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ht_compact_pool: CUDA error {rc}")
        return out
    return fn, out, totals


def seg_pool_call(ebcot_cuda, rows, off, lens, tree):
    """ebcot_pool_rows through the library's C entry point with the pool and
    total allocated beforehand (a parent's entry also takes an int64
    offset array, pool_off, before the total): (launch function, pool,
    total)."""
    import torch
    nb = lens.numel()
    dev = rows.device
    pool = torch.empty(rows.numel(), dtype=torch.uint8, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    with open(os.path.join(tree, "go_jpeg2000_tpu_torch", "csrc",
                           "ebcot_enc.cu")) as f:
        parent = "void* pool_off" in f.read()
    extra = [torch.empty(nb, dtype=torch.int64, device=dev)] if parent else []
    lib = ebcot_cuda.load()          # binds the tree's own argument types
    args = ([rows.data_ptr(), off.data_ptr(), lens.data_ptr(), nb]
            + [t.data_ptr() for t in extra] + [total.data_ptr(),
                                                pool.data_ptr()])

    def fn():
        rc = lib.ebcot_pool_rows(*args,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ebcot_pool_rows: CUDA error {rc}")
        return pool
    return fn, pool, total


def host_ms(fn, reps=20):
    """Host time of one call of fn while the card is busy: reps calls
    enqueued behind a spin kernel, by the host clock; None when a call
    waits for the card (the spin ended before the calls were enqueued)."""
    import torch
    fn()
    torch.cuda.synchronize()
    mark = torch.cuda.Event()
    torch.cuda._sleep(1 << 25)
    mark.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    busy = not mark.query()
    torch.cuda.synchronize()
    return ms if busy else None


def views_host_ms(ht_dec_cuda, plan, n, nc, levels, dev, reps=2000):
    """Host time of making ht_blocks_to_pyramid's leaves as views of one
    buffer, two ways: one as_strided a leaf (what the wrapper does), and
    one split of the buffer (the leaves and the padding between them) then
    one view a leaf.  None for a checkout without pyramid_layout."""
    import torch
    if not hasattr(ht_dec_cuda, "pyramid_layout"):
        return None
    _rows, _off, total, views = ht_dec_cuda.pyramid_layout(
        plan, n, nc, levels, False, dev)
    buf = torch.empty(total, dtype=torch.int32, device=dev)
    sizes, prev = [], 0
    for _lv, _band, shape, _strides, at in views:
        count = int(np.prod(shape))
        sizes += [at - prev, count]
        prev = at + count
    sizes.append(total - prev)
    shapes = [shape for _lv, _band, shape, _s, _a in views]

    def strided():
        return [buf.as_strided(shape, strides, at)
                for _lv, _band, shape, strides, at in views]

    def split():
        parts = buf.split(sizes)
        return [parts[2 * i + 1].view(shape)
                for i, shape in enumerate(shapes)]

    out = {"leaves": len(views)}
    for name, fn in (("as_strided", strided), ("split_view", split)):
        for _ in range(200):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[f"{name}_host_ms"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def copy_alone_ms(cs, nbytes):
    """The time alone of one contiguous torch copy_ of nbytes on the card:
    what moving a pool's bytes takes with no rows to place."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return cs.device_ms(lambda: dst.copy_(src))


def magsgn_timing(cs, tp, decoder, ht_dec_cuda, frames, opts, dev):
    """ht_magsgn_decode on the native parse of the frames' HT streams:
    shape, CUDA-event and alone times, bound."""
    batch = decoder.prepare_batch(tp.encode_batch(frames, opts, device=dev))
    if batch is None:
        raise AssertionError("decode_batch's branches refused the streams")
    qinfo, pool, woff = decoder.upload_parsed(
        *decoder.parse_chunk(batch, batch.bodies), dev)
    plan = batch.plan
    fn = lambda: ht_dec_cuda.magsgn_decode_blocks(  # noqa: E731
        qinfo, pool, woff, plan.cbh, plan.cbw)
    blocks = fn()
    return {"shape": f"{blocks.shape[0]} blocks of {plan.cbh}x{plan.cbw}, "
                     f"{cs.magsgn_bits(qinfo)} MagSgn bits",
            "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
            "bound_ms": cs.magsgn_bound(qinfo, blocks)[0]}


def dwt_levels(cs, dwt_cuda, dev):
    """The four level kernels at even origins: 5/3 on [32, 512, 512] and
    [768, 512, 512], 9/7 on [16, 512, 512] and [768, 512, 512]."""
    import torch
    result = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (cs.N_GRAY, 3 * (cs.C4_SIZE // cs.C4_TILE) ** 2):
        x = torch.randint(-(1 << 15), 1 << 15, (n, cs.H, cs.W),
                          generator=gen, device=dev, dtype=torch.int32)
        bands = dwt_cuda.forward_2d_53(x)
        for name, fn in (
                ("dwt53_fwd_level", lambda: dwt_cuda.forward_2d_53(x)),
                ("dwt53_inv_level", lambda: dwt_cuda.inverse_2d_53(bands))):
            result[f"{name} [{n},{cs.H},{cs.W}]"] = {
                "ms": cs.cuda_ms(fn),
                "alone_ms": cs.device_ms(fn),
                "bound_ms": cs.bound(8 * x.numel(), 0, 1)[0]}
        del x, bands
        torch.cuda.empty_cache()
    for n in (cs.N_LOSSY_GRAY, 3 * (cs.C4_SIZE // cs.C4_TILE) ** 2):
        x = torch.rand((n, cs.H, cs.W), generator=gen, device=dev) * 255 - 128
        bands = dwt_cuda.forward_2d_97(x)
        lim = cs.bound(8 * x.numel(), cs.OPS_PER_ELEMENT["dwt97"] * x.numel(),
                       cs.FP32_OPS_PER_S)[0]
        for name, fn in (
                ("dwt97_fwd_level", lambda: dwt_cuda.forward_2d_97(x)),
                ("dwt97_inv_level", lambda: dwt_cuda.inverse_2d_97(bands))):
            result[f"{name} [{n},{cs.H},{cs.W}]"] = {
                "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
                "bound_ms": lim}
        del x, bands
        torch.cuda.empty_cache()
    return result


def halo_levels(cs, dev):
    """The halo form of the four level kernels on sp = 2 and 4 row shards
    of config 4's level 1, [768, 512, 512], in one process
    (sharded.forward_level_split and inverse_level_split, as chip_smoke.py
    phase 10a: each shard's edges and its level launch; the same calls in
    every checkout), by CUDA events and alone, beside the bound."""
    import torch
    from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda
    from go_jpeg2000_tpu_torch.parallel import sharded as psh
    result = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 3 * (cs.C4_SIZE // cs.C4_TILE) ** 2
    for kind in (dwt.REV53, dwt.IRR97):
        lib = "dwt53" if kind == dwt.REV53 else "dwt97"
        x = torch.randint(-(1 << 15), 1 << 15, (n, cs.H, cs.W),
                          generator=gen, device=dev, dtype=torch.int32)
        if kind == dwt.IRR97:
            x = x.to(torch.float32) / 128
        bands = dwt.forward_2d(x, kind)
        lim = cs.bound(8 * x.numel(), 0, 1)[0]
        for sp in (2, 4):
            shards = [t.contiguous() for t in torch.chunk(x, sp, dim=-2)]
            split = [{k: v.contiguous() for k, v in zip(bands, parts)}
                     for parts in zip(*(torch.chunk(b, sp, dim=-2)
                                        for b in bands.values()))]
            for way, fn in (
                    ("fwd", lambda: psh.forward_level_split(shards, kind)),
                    ("inv", lambda: psh.inverse_level_split(split, kind))):
                result[f"{lib}_{way}_level halo sp={sp} [{n},{cs.H},"
                       f"{cs.W}]"] = {
                    "ms": cs.cuda_ms(fn, reps=10),
                    "alone_ms": cs.device_ms(fn, reps=10),
                    "bound_ms": lim}
            if hasattr(dwt_cuda, "pack_edges"):
                result.update(halo_parts(cs, dwt_cuda, psh, kind, shards,
                                         split, f"{lib} sp={sp}"))
            del shards, split
        del x, bands
        torch.cuda.empty_cache()
    return result


def halo_parts(cs, dwt_cuda, psh, kind, shards, split, label):
    """The halo form's two parts alone, where the checkout has the edge
    packing kernel: the sp packing launches into one edges tensor, and the
    sp level launches on edges packed beforehand, each direction."""
    out = {}
    fwd = getattr(dwt_cuda, f"forward_2d_{kind}")
    inv = getattr(dwt_cuda, f"inverse_2d_{kind}")
    for way, srcs, level in (("fwd", shards, fwd), ("inv", split, inv)):
        edges = psh._split_edges(srcs, dwt_cuda.pack_edges)

        def packs():
            for r, src in enumerate(srcs):
                dwt_cuda.pack_edges(src, out=edges[r])

        def levels():
            for r, src in enumerate(srcs):
                level(src, edges, r)

        for part, fn in (("packs", packs), ("levels", levels)):
            out[f"{label} {way} {part} alone"] = {
                "ms": cs.cuda_ms(fn, reps=10),
                "alone_ms": cs.device_ms(fn, reps=10),
                "edges": list(edges.shape)}
    return out


# even levels whose heights are no multiple of the kernels' 32-row strip:
# the 1080p batch's levels 1-3 (8 RGB frames) and 16x16 top levels
EVEN_LEVELS = ((24, 1080, 1920), (24, 540, 960), (24, 270, 480),
               (768, 16, 16))


def even_levels(cs, dwt_cuda, dev):
    """The four level kernels at EVEN_LEVELS, origin (0, 0), through the
    wrappers (every checkout takes them in its even instance), by CUDA
    events and alone, beside the bound."""
    import torch
    result = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for shape in EVEN_LEVELS:
        x = torch.randint(-(1 << 15), 1 << 15, shape, generator=gen,
                          device=dev, dtype=torch.int32)
        for lib, y in (("dwt53", x), ("dwt97", x.to(torch.float32) / 128)):
            kind = lib[3:]
            bands = getattr(dwt_cuda, f"forward_2d_{kind}")(y)
            rate = (cs.INT32_OPS_PER_S if lib == "dwt53"
                    else cs.FP32_OPS_PER_S)
            lim = cs.bound(8 * y.numel(),
                           cs.OPS_PER_ELEMENT[lib] * y.numel(), rate)[0]
            for name, fn in (
                    (f"{lib}_fwd_level",
                     lambda: getattr(dwt_cuda, f"forward_2d_{kind}")(y)),
                    (f"{lib}_inv_level",
                     lambda: getattr(dwt_cuda, f"inverse_2d_{kind}")(bands))):
                result[f"{name} {list(shape)}"] = {
                    "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
                    "bound_ms": lim}
            del bands
        del x
        torch.cuda.empty_cache()
    return result


# odd shapes [N, H, W] and level origins (u0, v0): an odd 1080p frame at
# origin (1, 1), and the 1080p batch's level 4 (135 rows)
ODD_LEVELS = (((1, 1079, 1919), (1, 1)), ((24, 135, 240), (0, 0)))


def odd_levels(cs, dev):
    """The four levels on ODD_LEVELS through transforms.forward_level and
    inverse_level: the level kernels where the checkout's dwt_cuda.usable
    takes the level, else the plain lifting (a parent's); each by CUDA
    events and alone, with the plain levels a call counts."""
    import torch
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda
    result = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for kind in (dwt.REV53, dwt.IRR97):
        lib = "dwt53" if kind == dwt.REV53 else "dwt97"
        rate = cs.INT32_OPS_PER_S if kind == dwt.REV53 else cs.FP32_OPS_PER_S
        for shape, (u0, v0) in ODD_LEVELS:
            if kind == dwt.REV53:
                x = torch.randint(-(1 << 15), 1 << 15, shape, generator=gen,
                                  device=dev, dtype=torch.int32)
            else:
                x = torch.rand(shape, generator=gen, device=dev) * 255 - 128
            bands = {k: v.contiguous() for k, v in
                     dwt.forward_2d(x, kind, u0=u0, v0=v0).items()}
            lim = cs.bound(8 * x.numel(), cs.OPS_PER_ELEMENT[lib] * x.numel(),
                           rate)[0]
            for name, fn in (
                    (f"{lib}_fwd_level",
                     lambda: transforms.forward_level(x, kind, u0, v0)),
                    (f"{lib}_inv_level",
                     lambda: transforms.inverse_level(bands, kind, u0, v0))):
                dwt_cuda.reset_counts()
                fn()
                torch.cuda.synchronize()
                result[f"{name} {list(shape)} at origin {(u0, v0)}"] = {
                    "plain_levels_a_call": dwt_cuda.PLAIN_LEVELS,
                    "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
                    "bound_ms": lim}
            del x, bands
            torch.cuda.empty_cache()
    return result


def s4_walls(cs, tp, dev, reps=5):
    """chip_smoke.py's S4 (750x1000 gray at odd offsets, 12 tiles) through
    encode and decode on the card: the plain levels and level launches of
    one encode and decode, then the median wall ms of `reps` of each after
    a warm-up, host clock, each ending in a synchronise."""
    import torch
    from go_jpeg2000_tpu_torch.ops import dwt_cuda
    label, image, opts, _lib = cs.s4_case(tp)
    dwt_cuda.reset_counts()
    data = tp.encode(image, opts, device=dev)
    tp.decode(data, device=dev)
    torch.cuda.synchronize()
    out = {"plain_levels": dwt_cuda.PLAIN_LEVELS,
           "launches": {k: v for k, v in dwt_cuda.LAUNCHES.items() if v}}

    def wall(fn):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)

    out["encode_ms"] = wall(lambda: tp.encode(image, opts, device=dev))
    out["decode_ms"] = wall(lambda: tp.decode(data, device=dev))
    out["encode_median_ms"] = out["encode_ms"][reps // 2]
    out["decode_median_ms"] = out["decode_ms"][reps // 2]
    return {label: out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--config4", action="store_true")
    ap.add_argument("--profiler-probe", type=int, default=0, metavar="N")
    ap.add_argument("--dwt-only", action="store_true")
    ap.add_argument("--halo-only", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    # this script's chip_smoke, whatever the tree holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import go_jpeg2000_tpu_torch as tp
    from go_jpeg2000_tpu_torch.models import decoder
    from go_jpeg2000_tpu_torch.ops import (cuda_build, dwt_cuda, ebcot_cuda,
                                           ht_dec_cuda, ht_enc, ht_enc_cuda)
    if not os.path.abspath(tp.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {tp.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    result = {"tree": tree, "card": cs.card_line(),
              "kind": torch.cuda.get_device_name(0)}
    cuda_build.build()
    if args.ptxas:
        result["ptxas"], result["sass"] = ptxas(tree, cuda_build)
        result["occupancy"] = occupancy(result["ptxas"], ebcot_cuda,
                                        ht_dec_cuda)

    tiny = torch.zeros(1, device=dev)
    result["launch floor"] = {
        "what": "a one-element add_, alone",
        "alone_ms": cs.device_ms(lambda: tiny.add_(1))}
    result.update(halo_levels(cs, dev))
    if args.halo_only:
        print(json.dumps(result), flush=True)
        return 0
    result.update(dwt_levels(cs, dwt_cuda, dev))
    result.update(even_levels(cs, dwt_cuda, dev))
    result.update(odd_levels(cs, dev))
    result.update(s4_walls(cs, tp, dev))
    if args.dwt_only:
        print(json.dumps(result), flush=True)
        return 0
    _plan, planes, inputs = cs.ebcot_inputs(tp, cs.ebcot_gray(), dev)
    fn = lambda: ebcot_cuda.decision_slots(*inputs, planes)  # noqa: E731
    slots = fn()
    result["ebcot_decision_slots"] = {
        "shape": f"{slots.shape[0]} blocks of 64x64, {planes} planes",
        "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
        "bound_ms": cs.decision_bound(inputs[0], inputs[3], planes,
                                      slots)[0]}
    pool, ndec, off, largest = ebcot_cuda.compact_rows(slots)
    fn, kpool, entries = compact_call(ebcot_cuda, slots, pool.numel())
    fn()
    if not torch.equal(kpool, pool):
        raise AssertionError("ebcot_compact_rows through its entry points "
                             "differs from the wrapper")
    result["ebcot_compact_rows"] = {
        "shape": f"{slots.numel()} slots, {pool.numel()} decisions",
        "entries": entries,
        "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
        "bound_ms": cs.compact_bound(slots, pool.numel())[0]}
    del slots, kpool
    fn = lambda: ebcot_cuda.mq_encode(pool, ndec, off, largest)  # noqa: E731
    ms = cs.cuda_ms(fn)
    result["ebcot_mq_encode"] = {
        "shape": f"{ndec.numel()} blocks, {pool.numel()} decisions, the "
                 f"longest {largest}",
        "ms": ms, "alone_ms": cs.device_ms(fn),
        "cycles_per_decision": ms * 1e-3 * cs.SM_CLOCK_HZ / largest}
    rows, lens = fn()
    segs, total = ebcot_cuda.pool_rows(rows, off, lens)
    used = int(total.item())
    fn, kpool, ktotal = seg_pool_call(ebcot_cuda, rows, off, lens, tree)
    fn()
    if not (torch.equal(kpool[:used], segs[:used])
            and int(ktotal.item()) == used):
        raise AssertionError("ebcot_pool_rows through its entry point "
                             "differs from the wrapper")
    nb = lens.numel()
    result["ebcot_pool_rows"] = {
        "shape": f"{nb} segments, {used} bytes",
        "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
        "bound_ms": cs.bound(2 * used + 12 * nb,
                             cs.OPS_PER_ELEMENT["ebcot_pool_rows"] * used,
                             cs.INT32_OPS_PER_S)[0],
        "wrapper_ms": cs.cuda_ms(
            lambda: ebcot_cuda.pool_rows(rows, off, lens)),
        "copy_alone_ms": copy_alone_ms(cs, used)}
    del rows, lens, segs, kpool

    lossless = tp.Options(format=tp.Format.J2K, lossless=True,
                          num_resolutions=6, high_throughput=True)
    for label, (frames, opts) in (
            ("gray", (cs.main_gray(), lossless)),
            ("config-4 class", cs.config4_class(tp)),
            ("config-4 lossy class", cs.config4_class(tp, lossless=False))):
        plan, blocks, hs, ws = cs.ht_blocks(tp, frames, opts, dev)
        shape = (f"{blocks.shape[0]} blocks of "
                 f"{blocks.shape[1]}x{blocks.shape[2]}")
        levels, pyr = cs.ht_pyramid(tp, frames, opts, dev)
        n = len(frames)
        fn, out = extract_call(ht_enc_cuda, pyr, plan, n, levels)
        fn()
        if not torch.equal(out, blocks):
            raise AssertionError("ht_extract_blocks through its entry "
                                 "point differs from the wrapper")
        wrapper = lambda: ht_enc_cuda.extract_blocks(  # noqa: E731
            pyr, plan, n, levels)
        result[f"ht_extract_blocks {label}"] = {
            "shape": shape, "ms": cs.cuda_ms(fn),
            "alone_ms": cs.device_ms(fn),
            "bound_ms": cs.extract_bound(pyr, blocks)[0],
            "wrapper_ms": cs.cuda_ms(wrapper),
            "wrapper_alone_ms": cs.device_ms(wrapper),
            "wrapper_host_ms": host_ms(wrapper)}
        lossy = plan.deltas is not None
        nc = pyr[0]["HL"].shape[1]
        wrapper = lambda: ht_dec_cuda.blocks_to_pyramid(  # noqa: E731
            blocks, plan, n, nc, levels, lossy)
        result[f"ht_blocks_to_pyramid {label}"] = {
            "shape": f"{shape}, {'float32' if lossy else 'int32'} leaves",
            "wrapper_ms": cs.cuda_ms(wrapper),
            "alone_ms": cs.device_ms(wrapper),
            "wrapper_host_ms": host_ms(wrapper),
            "bound_ms": cs.assemble_bound(wrapper())[0]}
        if label == "gray":
            result["ht_blocks_to_pyramid gray views"] = views_host_ms(
                ht_dec_cuda, plan, n, nc, levels, dev)
        if not lossy:
            take, copy = layout_library(cs, ht_enc_cuda, ht_dec_cuda, pyr,
                                        blocks, plan, n, levels)
            result[f"ht_extract_blocks {label}"]["library"] = take
            result[f"ht_blocks_to_pyramid {label}"]["library"] = copy
        del pyr, out, frames
        fn = lambda: ht_enc_cuda.cleanup_values(blocks, hs, ws)  # noqa
        result[f"ht_cleanup_fields {label}"] = {
            "shape": shape, "ms": cs.cuda_ms(fn),
            "alone_ms": cs.device_ms(fn)}
        f = fn()
        del blocks, hs, ws
        fields = [(f[f"{s}_vals"], f[f"{s}_lens"], nw) for s, nw in zip(
            ("ms", "vlc", "mel"), ht_enc.stream_words(plan.cbh, plan.cbw,
                                                      plan.max_mn))]
        f_meta = {k: f[k] for k in ("numbps", "u_max", "dist")}
        del f
        nb = fields[0][0].shape[0]
        fns = {"pack_bits, 3 calls":
               lambda: [ht_enc_cuda.pack_bits(*x) for x in fields]}
        if hasattr(ht_enc_cuda, "pack_streams"):
            fns["pack_streams, 1 call"] = \
                lambda: ht_enc_cuda.pack_streams(fields)
        for how, fn in fns.items():
            result[f"ht_pack_bits {label}, {how}"] = {
                "shape": f"{shape}, max_mn {plan.max_mn}",
                "ms": cs.cuda_ms(fn),
                "alone_ms": cs.device_ms(fn),
                "bound_ms": cs.pack_bound(fields, nb)[0]}
        pool_args = [x for vals, lens, nw in fields
                     for x in ht_enc_cuda.pack_bits(vals, lens, nw)] + [
            f_meta[k] for k in ("numbps", "u_max", "dist")]
        del fields
        want, wtot = ht_enc_cuda.assemble_pool(*pool_args)
        fn, kout, ktot = pool_call(ht_enc_cuda, pool_args)
        fn()
        used = int(wtot.sum().item())
        if not (torch.equal(ktot, wtot) and torch.equal(
                kout[:6 * nb + used], want[:6 * nb + used])):
            raise AssertionError("ht_compact_pool through its entry point "
                                 "differs from the wrapper")
        result[f"ht_compact_pool {label}"] = {
            "shape": f"{shape}, {used} pool words",
            "ms": cs.cuda_ms(fn), "alone_ms": cs.device_ms(fn),
            "bound_ms": cs.pool_bound(nb, used)[0],
            "wrapper_ms": cs.cuda_ms(
                lambda: ht_enc_cuda.assemble_pool(*pool_args)),
            "copy_alone_ms": copy_alone_ms(cs, 4 * (6 * nb + used))}
        del pool_args, want, kout, f_meta
        torch.cuda.empty_cache()

    for label, (frames, opts) in (
            ("gray", (cs.main_gray(), lossless)),
            ("config-4 class", cs.config4_class(tp)),
            ("config-4 lossy class", cs.config4_class(tp, lossless=False))):
        result[f"ht_magsgn_decode {label}"] = magsgn_timing(
            cs, tp, decoder, ht_dec_cuda, frames, opts, dev)
        del frames
        torch.cuda.empty_cache()

    if args.config4:
        img = cs.config4_image(cs.C4_SIZE)
        opts = cs.config4_opts(tp, True)
        runs = [cs.sharded_encode_stages(img, opts, dev) for _ in range(4)]
        for i, name in ((2, "transform step"), (3, "HT kernels")):
            ms = sorted(1e3 * r[i] for r in runs[1:])
            result[f"config-4 lossless encode stage {name}"] = {
                "median_ms": ms[1], "ms": ms}
        img8 = (img >> 8).astype(np.uint8)
        del img
        opts = cs.config4_opts(tp, False)
        runs = [cs.sharded_encode_stages(img8, opts, dev) for _ in range(4)]
        ms = sorted(1e3 * r[2] for r in runs[1:])
        result["config-4 lossy encode stage transform step"] = {
            "median_ms": ms[1], "ms": ms}
        from go_jpeg2000_tpu_torch.parallel import encode_sharded
        data = encode_sharded(img8, opts, device=dev)
        runs = [cs.sharded_decode_stages(data, dev) for _ in range(4)]
        ms = sorted(1e3 * r[3] for r in runs[1:])
        result["config-4 lossy decode stage inverse step"] = {
            "median_ms": ms[1], "ms": ms}
        del img8, data
        torch.cuda.empty_cache()
        result.update(plain_steps(cs, cs.config4_image(cs.C4_SIZE),
                                  cs.config4_opts(tp, True), dev))
    if args.profiler_probe:
        result["profiler probe"] = profiler_probe(cs, dwt_cuda, dev,
                                                  args.profiler_probe)
    print(json.dumps(result), flush=True)
    return 0


def plain_kernels():
    """(module, name, plain torch version) of every kernel wrapper of
    config 4's steps: the levels through dwt_cuda.usable answering no
    (transforms.forward_level and inverse_level then lift plain), the four
    HT encode kernels, the two HT decode kernels and band_stats; each
    plain version runs on the card's tensors."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    from go_jpeg2000_tpu_torch.ops import (band_stats, dwt_cuda, ht_dec,
                                           ht_dec_cuda, ht_enc, ht_enc_cuda)
    return ((dwt_cuda, "usable", lambda *a, **k: False),
            (ht_enc_cuda, "extract_blocks", fused_encode.extract_blocks),
            (ht_enc_cuda, "cleanup_values", ht_enc.cleanup_values),
            (ht_enc_cuda, "pack_streams",
             lambda streams: [ht_enc.pack_bits(v, ln, nw)
                              for v, ln, nw in streams]),
            (ht_enc_cuda, "assemble_pool", ht_enc.assemble_pool),
            (ht_dec_cuda, "magsgn_decode_blocks", ht_dec.magsgn_decode_blocks),
            (ht_dec_cuda, "blocks_to_pyramid", ht_dec.blocks_to_pyramid),
            (band_stats, "band_stats", band_stats.band_stats_plain))


def plain_steps(cs, img, opts, dev):
    """Config 4's lossless steps with plain_kernels swapped in, medians of
    2 after a warm-up (ms): transform step, HT kernels, MagSgn and
    assembly, inverse step; the codestream must equal the kernels'."""
    from go_jpeg2000_tpu_torch.parallel import encode_sharded
    data = encode_sharded(img, opts, device=dev)
    swaps = plain_kernels()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _f in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        if encode_sharded(img, opts, device=dev) != data:
            raise AssertionError("config 4: the plain steps' codestream "
                                 "differs from the kernels'")
        enc = [cs.sharded_encode_stages(img, opts, dev) for _ in range(3)]
        dec = [cs.sharded_decode_stages(data, dev) for _ in range(3)]
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    out = {}
    for runs, i, name in ((enc, 2, "transform step"), (enc, 3, "HT kernels"),
                          (dec, 2, "MagSgn and assembly"),
                          (dec, 3, "inverse step")):
        ms = sorted(1e3 * r[i] for r in runs[1:])
        out[f"config-4 lossless {name} plain"] = {
            "median_ms": (ms[0] + ms[1]) / 2, "ms": ms}
    return out


def profiler_probe(cs, dwt_cuda, dev, rounds):
    """How many kernel events torch.profiler keeps as the process ages (why
    chip_smoke.device_ms does not use it): every 30 s, five forward 9/7
    levels at [768, 512, 512] traced with no tail after the synchronise and
    with a 50 ms one, and the mean duration of the events kept beside the
    time alone by chip_smoke.device_ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand((768, 512, 512), device=dev) * 255 - 128
    out = []
    for _ in range(rounds):
        alone = cs.device_ms(lambda: dwt_cuda.forward_2d_97(x), reps=5)
        for tail in (0.0, 0.05):
            dwt_cuda.forward_2d_97(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    dwt_cuda.forward_2d_97(x)
                torch.cuda.synchronize()
                time.sleep(tail)
            kept = [e.time_range.elapsed_us() * 1e-3 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "dwt97_fwd_kernel" in e.name]
            out.append({"process_s": round(time.perf_counter() - T0),
                        "tail_s": tail, "launched": 5, "kept": len(kept),
                        "kept_mean_ms": sum(kept) / len(kept) if kept else
                        None, "alone_ms": alone})
        time.sleep(30)
    return out


if __name__ == "__main__":
    sys.exit(main())
