#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (go_jpeg2000_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and g++; builds every kernel it runs from the
sources in this checkout.  Phases, each of which raises on failure:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
2. build: the CUDA sources dwt53.cu, dwt97.cu, dwt_edges.cu, ht_enc.cu,
   ht_dec.cu, ebcot_enc.cu, band_stats.cu and mct.cu (one nvcc per source,
   run in parallel)
   and the native coder (g++, from the port's own copy of j2k_native.cpp);
3. each DWT kernel against its plain torch version on the card: the 5/3
   pair at every level shape of a [32, 512, 512] batch down to 16x16, the
   9/7 pair at every level shape of [16, 512, 512] down to 16x16, both at
   [1, 2048, 2048], [3, 2, 2] and [2, 6, 10]: exact equality required, and
   for 9/7 inverse(forward(x)) within 1e-3 of x; kernel and plain times
   with CUDA events and each kernel's device time alone (its calls queued
   behind a spin kernel, device_ms) at [32, 512, 512] (5/3) and [16, 512,
   512] (9/7); all four level kernels also on the first level of a
   4096x4096 and an 8192x8192 frame (every one keeps its strip in
   registers, so any even width takes it): exact, one launch each, no
   plain level, timed; then (3c) the colour head and tail of csrc/mct.cu:
   mct_forward and mct_inverse against coefficients_plain and
   samples_plain over tests/test_torch_cuda.py's grid (every upload dtype,
   precisions 1-31, signed and unsigned, 1, 3 and 4 components, with and
   without RCT/ICT, 5/3 and 9/7, narrowed and not, rows off 16 bytes and
   single pixels) and the tail on floats past int32 and NaN, bit for bit;
   each timed by CUDA events and alone beside its bound and its plain
   version at config 4's tile batch (256 x 3 x 512 x 512, 16-bit RCT and
   8-bit ICT) and the main paths' batches; config 4's transform and
   inverse steps by CUDA events beside their one-pass bound, each traced
   once by torch.profiler, where no device work but the step's own
   kernels may take 20 us or more;
4. each HT encode kernel (block extraction, the cleanup pass with its bit
   packing in one kernel, pool compaction) against its plain torch version
   on the card, on the block batches of the main paths (32 gray 512x512
   lossless, 2240 blocks; 2 RGB 2048x2048 lossy, 6144 blocks) and of
   16-bit RGB, pure noise, all-zero and ragged (96x80) frames, and of
   code-blocks of 32x32, 64x32, 32x128 and 128x32 (height x width): every
   output equal bit for bit (the distortion's float32 bits too); the
   cleanup kernel also on blocks with magnitudes near the 30-bit limit and
   on config-4 tile-origin classes (64 tiles of 512x512, 12,864 blocks),
   lossless 16-bit RGB and lossy, and so is the pool compaction on the
   lossless class; the compaction also on ht_enc_cuda.pool_stress_cases
   (row widths off 4 words, full and empty rows, 4.8 KB rows, one row, two
   rounds of its scan) with the word rows 0 and 1 words past a 16-byte
   boundary; kernel and plain times with CUDA events on the 2240 blocks,
   and each kernel's device time alone, the cleanup kernel's on both
   classes and the compaction's on the lossless one, and the compaction
   beside one PyTorch expression that computes its output
   (torch.masked_select per stream and torch.cat), the lossless extraction
   beside torch.take over the flat pyramid and a zero with the slot index
   made beforehand (no PyTorch call computes the cleanup pass);
5. each HT decode kernel (MagSgn extraction, block-to-pyramid assembly
   with the midpoint dequantization of lossy plans) against its plain
   torch version on the card, on the native parse of the same frames'
   streams: integer outputs equal, float32 leaves equal bit for bit; the
   MagSgn kernel also on ops/ht_dec.stress_cases (32-bit fields, uncoded
   blocks, fields past the pool's end, odd widths, offsets with gaps or
   out of order, a block past its staging window, a pool off 16 bytes)
   and on a config-4 tile-origin class, lossless and lossy (12,864
   blocks each, also timed); kernel and plain times with CUDA events on
   the 2240 blocks, and each kernel's device time alone; the lossless
   assembly beside Tensor.index_copy_ into the flat pyramid with the index
   made beforehand; then the two layout kernels (block extraction and
   assembly) on ops/block_layout.layout_stress_cases (offset grids off
   multiples of 4, odd band widths, 32x32 and 64x16 blocks, one and three
   frames; the extraction's leaves off 16 bytes and strided) and on a
   config-4 class, lossless and lossy (the lossy assembly dequantizing),
   equal to their plain versions, float32 leaves bit for bit, each timed
   on the class by CUDA events through its wrapper and alone, and,
   lossless, beside torch.take and Tensor.index_copy_;
6. the lossless main paths, through the public entry points: encode_batch
   then decode_batch on 32 gray 8-bit 512x512 frames with the bench
   headline options (HTJ2K, lossless 5/3, 6 resolutions, J2K), then on 4
   RGB frames.  Pixels must round-trip exactly, the codestreams must equal
   the CPU run's byte for byte and the decodes the CPU decodes, every
   encode must have taken the fused device HT encode (enc.fused_chunks > 0,
   enc.host_entropy_frames 0) and launched every HT encode kernel, every
   decode the device HT decode (dec.device_ht_chunks > 0,
   dec.host_ht_frames 0) and launched both HT decode kernels, and every
   level must have gone through the 5/3 kernels (launch counts > 0, no
   plain levels).  Then encode and decode wall Mpix/s after that warm-up,
   the encode's stages (device program, device-to-host copy, native
   Tier-2) and the decode's (native parse, upload, device program,
   download), each with its peak device bytes per sample, and the device's
   idle share during one encode and one decode (torch.profiler);
7. the lossy main paths, the same way: the JAX bench's htlossy97_512
   options (HTJ2K, 9/7 + ICT, quality 85, 6 resolutions, one layer) on 16
   gray 8-bit 512x512 frames, then on 2 RGB 8-bit 2048x2048 frames, with
   the same checks against the 9/7 and HT kernels; the decodes must equal
   the CPU decodes; PSNR against the input, encode and decode wall Mpix/s
   after that warm-up, and the RGB encode's and decode's stages and idle
   shares;
8. each EBCOT encode kernel (decision slots, decision compaction, MQ coder,
   segment pool) against its plain torch version on the card, on the block
   batches of the EBCOT main path (8 gray 512x512, 560 blocks) and of
   16-bit RGB, pure noise, all-zero and ragged (96x80) frames: slots,
   decision pools, segment pools and lengths equal; the compaction also
   on ebcot_cuda.compact_stress_slots (0xFF rows, decisions at both ends
   of every chunk, runs across 16-byte boundaries, rows off 16 bytes and
   off the chunk, 13-byte rows, 0xFF fill planes) with the slots 0 and 5
   bytes past a 16-byte boundary, and timed beside one library call that
   computes the same pool (torch.masked_select); the segment pool also
   on ebcot_cuda.pool_stress_rows (rows at every phase, empty rows, 9 KB
   rows, one row, runs of two rows a warp) with the row buffer 0 and 5
   bytes past a 16-byte boundary, and timed beside torch.masked_select of
   the row buffer; the decision kernel
   also on ops/ebcot_device.stress_blocks (an SPP chain snaking through
   64x64 blocks, stripe-long chains under a ragged mask, one live plane
   under eleven empty ones, 29 planes); the MQ segments also
   equal to the native mq_encode_streams on every block, and to the plain
   lockstep chain on a subset of blocks; the MQ kernel also on the stress
   streams of ops/mq_device.stress_streams (lengths around the kernel's
   staging chunk, pools whose base is off a 16-byte boundary, long MPS
   runs, carries and stuffing, one stream far longer than the rest)
   against the native coder on every stream and the plain chain on every
   stream of at most four chunks; kernel and plain times with CUDA events
   on the 560 blocks, each kernel's device time alone, and the MQ kernel's
   cycles per decision of the longest block beside its serial bound;
9. the Part-1 (EBCOT) lossless main paths: encode_batch then decode_batch
   on 8 gray 8-bit 512x512 frames with the JAX bench's ebcot53_512 options
   (Part 1, lossless 5/3, 6 resolutions, J2K), then on 4 RGB frames, with
   backend "device" (path A): round trip exact, every encode through the
   device EBCOT encode (enc.ebcot_device_chunks > 0, no host-entropy
   frame) and its four kernels, block extraction and the 5/3 kernels, no
   plain level, every decode through the EBCOT branch (dec.ebcot_frames)
   and the assembly kernel; then path B ("hybrid") and path C ("native")
   must give the same bytes.  Encode Mpix/s of A, B and C and decode
   Mpix/s, the stages of a path A encode and of a decode, and the idle
   shares;
10. the tile-sharded pipeline (go_jpeg2000_tpu_torch.parallel) at BASELINE
   config 4's full width on a grid of one: first the four DWT level
   kernels in their halo form on sp = 2 and 4 row shards of the level-1
   batch [768, 512, 512] and on batches whose shards have 2 rows, each
   shard on the edges the packing kernel writes (dwt_pack_edges, one slot
   a shard, as the gather would give them), equal bit for bit to the
   unsharded kernels, and the packing kernel equal to its plain version;
   the halo form at sp = 2 and 4 timed by events and alone beside the
   unsharded kernels (timed there with their device time alone) and the
   bound, and the packing kernel on one shard's slot; then
   encode_sharded and decode_sharded of an 8192x8192 16-bit RGB image
   (bench.py's smooth noise) in 512x512 tiles, 5 resolutions, HTJ2K
   lossless (round trip exact), and of the same image >> 8 lossy at
   quality 85 (PSNR), each through the device HT entropy and decode for
   all 256 tiles, the DWT kernels with no plain level and band_stats;
   band_stats against its plain version on the lossless pyramid (counts
   equal, sums within a relative 1e-5); wall Mpix/s, the encode's and the
   decode's stages (medians of 3) with peak device bytes per sample, and
   the idle shares; then at 2048x2048 (16 tiles, all four tile-origin
   classes) the card's codestreams equal the CPU run's for HT lossless, HT
   lossy (decodes equal too) and Part-1 with two layers and a 6:1 budget;
11. the single-image API (encode, decode) on four cases: S1 Options() (JP2,
   lossy Part-1 9/7, quality 75, one tile) on a 4096x4096 8-bit RGB image
   (PSNR printed); S2 HTJ2K lossless in 1024x1024 tiles (16) with 3 quality
   layers, J2K, on the same image (round trip exact); S3 Part-1 lossless
   on a 4096-row, 3328-column 12-bit gray frame (precision 12; its last
   tile column 256 wide) in 1024x1024 tiles, 2 layers and a 6:1 budget;
   S4 a 750x1000 gray image at image offset (7, 3) and tile offset (5, 1)
   in 256x256 tiles, HTJ2K lossless (odd level origins and sizes on every
   tile).  The level kernels first on the first level of S1-S3's tile
   shapes, exact; then each case's codestream and decode equal the CPU
   run's, each case launches both level kernels of its kind with no plain
   level (S4 both 5/3 kernels); wall Mpix/s and
   a second run's stages (device transform, host block coding, PCRD and
   Tier-2; Python Tier-2, native block decode, device inverse);
12. BASELINE config 2 at its specified scale: bench.py's 2048x2048 RGB
   image (noise smoothed twice by three taps, seed 0) through encode and
   decode with Options(JP2, lossy 9/7 + ICT, quality 98, 6 resolutions, 3
   layers, compression_ratio 20, backend "native"): the codestream inside
   its budget, bytes and decode equal to the CPU run's, PSNR beside
   OpenJPEG's at the same rate (Pillow, mct=1, where Pillow has OpenJPEG),
   wall ms and the stages as in phase 11;
13. quality layers and a byte budget through the fused HT batch encode:
   16 gray 512x512 frames, HTJ2K lossy quality 95, ht_refinement False, 2
   layers at 10:1, through encode_batch (enc.fused_chunks > 0, every HT
   encode kernel) and decode_batch; bytes and decodes equal the CPU run's;
14. BASELINE config 5, the multi-host decomposition (encode_multihost,
   decode_multihost), every host a process with its transforms on the
   card: a 4096x4096 RGB image in 512x512 tiles (64), HTJ2K lossless, 2
   layers at 6:1, at 1, 2 and 4 hosts after a warm-up, each codestream
   equal to the card's single-process encode and that to the CPU run's;
   compute wall, Mpix/s, reduction rounds, efficiency against one host
   and the host's cores; decode_multihost at 1, 2 and 4 hosts equal to the
   card's decode, and, of the stream without a budget, to the input; the
   time the gather of a 2-host decode's samples takes across the pipes,
   as one message against 1 MB pieces; then lossy 9/7 HT on a 2048x2048
   RGB image, 2 layers at 12:1, over 2 hosts, equal to the single-process
   encode and the CPU run's, and its decode over 2 hosts equal to the
   card's and the CPU's decode;
15. entry's fused HT encode program on the card, dryrun_multichip(1) (the
   four checks of the tile-sharded pipeline against the single-process
   encoder and decoder) and, with two or more cards, dryrun_multichip over
   every card (NCCL);
16. the decode options through decode (one case also decode_batch), each
   case with no level lifted plain: R1 a tile server's viewport (2900,
   3100, 3924, 4124) of phase 10's 8192x8192 16-bit RGB lossless stream
   (9 tiles decoded, 247 skipped), equal to the input's crop; R2 its
   thumbnail at reduce_resolution=3 (1024x1024), equal to the CPU run's,
   and the viewport of the thumbnail equal to the thumbnail's crop; R3
   the config-2 image as HTJ2K lossless in 128x128 precincts with PLT, a
   region (0, 0, 256, 256) decoded with packets skipped by PLT seek
   (parsed plus skipped equal to the whole decode's packets), equal to
   the input's crop; L1 phase 12's 3-layer JP2 from 1 and 2 layers and at
   reduce_resolution=2, equal to the CPU run's, PSNR at 1, 2, 3 layers
   not falling; C1 the config-2 image as HT lossless JP2 tagged sYCC and
   YCbCr, converted, equal to the CPU run's, and the 14 colour converters
   on 2048x2048 planes at 8 and 16 bits, card against CPU within one grey
   level (the samples that differ printed); P1 the config-2 image's first
   channel as an 8-bit HT lossless J2K with its SIZ marker rewritten to
   signed 8-bit, 4-bit, 20-bit and 2x2 subsampled, each decoded to its
   exact expected samples.  Wall ms of each case, the stages of a second
   R1, R2 and R3 decode, and the phase's time;
17. the encode options, each case with no level lifted plain, its wall
   ms, its host/device split (the device programs with the fetches that
   wait for them, against the rest) and its launches: M1 phase 10's
   8192x8192 16-bit RGB image through encode_sharded as JP2 with PLT,
   TLM, SOP and EPH (all 256 tiles through the device HT encode, then the
   Python Tier-2), its round trip through decode exact, R1's viewport of
   it (packets skipped by PLT seek printed), and at 2048x2048 the card's
   bytes equal to the CPU run's; M2 a CT series of 64 signed 16-bit
   512x512 slices through encode_batch and decode_batch, HTJ2K lossless
   (the fused kernels) and Part-1 lossless on paths A (with SOP and EPH),
   B and C, every round trip exact and 8 slices held to the CPU run's
   bytes; M3 a 4-band 16-bit 4096x4096 image in 1024x1024 tiles, Part-1
   lossy q85, 3 layers, TLM and PLT, and a 2-band 12-bit 2048x2048 image
   lossless, through encode and decode, held to the CPU run at 2048x2048;
   M4 every forward 5/3 level of extreme-valued 29-bit gray and 28-bit
   RGB (after the RCT) through the kernel against the plain lifting, bit
   for bit, then 20- and 29-bit gray 2048x2048 lossless, HTJ2K and
   Part-1, round trips exact and bytes equal to the CPU run's; M5
   2048x2048 RGB with code-block styles 0x3f and 0x15 at 2 layers,
   lossless and lossy, a POC of three segments, PPM, and PPT with SOP and
   EPH, each held to the CPU run and decoded; M6 backend "python" at
   128x128, bytes equal to the native backend's;
18. odd geometry, each case with no level lifted plain: all four level
   kernels at every origin parity on [3, 1, 1], [2, 1, 9], [2, 9, 1],
   [2, 3, 3], [2, 35, 63], [1, 1079, 1919] and [24, 135, 240], one launch
   each, bit for bit against the plain lifting (9/7 too), each timed alone
   beside its bound and the plain lifting's time; H1 8 RGB 8-bit 1920x1080
   frames (level 4's input has 135 rows), HTJ2K at 6 resolutions,
   lossless and lossy q85, through encode_batch and decode_batch (the
   fused encode, the device HT decode), lossless round trips exact, the
   first 2 frames' bytes and decodes equal to the CPU run's, wall ms; S4's
   stream decoded at reduce_resolution 1 and 2, equal to the CPU run's;
19. config 4 on row shards: phase 10's image through encode_sharded and
   decode_sharded, HTJ2K lossless and the image >> 8 lossy at q85, on
   (dp, sp) = (1, 4) and (2, 2) grids of gloo ranks, spawned processes
   that share the one card: every rank's codestream byte-identical to
   phase 10's, the lossless decode exact, the lossy decode equal to phase
   10's; per rank the halo levels' and the packing kernel's launches (all
   > 0), no plain level, the wall of the encode and of the decode, and
   the transform and inverse steps (medians of 3) with the edge round
   trip (packing, the gloo gather through the host, the upload) timed
   apart; with four cards also (2, 2) on NCCL, a rank a card;
20. the tools (go_jpeg2000_tpu_torch/tools, TOOL_RUNS): profile_stages on
   the HT 5/3 path and the Part-1 paths A, B and C (reps 1),
   profile_kernel_stages at 512 8 4, bench_config4_scale at 2048^2,
   multihost_scaling at 1 and 2 hosts, benchmark_compare at 64 and 128;
   each through its main on the card, asserting its own exactness.

Every device idle share printed is a bracket over one run
(tools/_clock.py idle_bracket): torch.profiler's share, an upper bound
where it lost device events, and the lower bound from CUDA events around
every device stage of the same run.

Each of the eight main paths, the sharded runs, the four single-image
cases, each run of phases 12-15, each case of phases 16-18 and each
rank's runs of phase 19 run with the
launch counts set to 0 just before it and read just after (a host process reports the launches
of its measured run, after its warm-ups, to the parent).  The line before
the last is a JSON summary of the
kernels, with each one's bound: the larger of its bytes over 3.35 TB/s
and its operations over the card's peak rate for their type, and the time
of one PyTorch call that computes the same function where there is one
(torch.masked_select for the decision compaction and the segment pool,
masked_select per stream and torch.cat for the HT pool, torch.take for
the block extraction, Tensor.index_copy_ for the assembly); the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""
import dataclasses
import hashlib
import json
import math
import multiprocessing as mp
import os
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
       "dwt97": "go_jpeg2000_tpu_torch/csrc/dwt97.cu",
       "dwt_edges": "go_jpeg2000_tpu_torch/csrc/dwt_edges.cu",
       "ht_enc": "go_jpeg2000_tpu_torch/csrc/ht_enc.cu",
       "ht_dec": "go_jpeg2000_tpu_torch/csrc/ht_dec.cu",
       "ebcot_enc": "go_jpeg2000_tpu_torch/csrc/ebcot_enc.cu",
       "band_stats": "go_jpeg2000_tpu_torch/csrc/band_stats.cu",
       "mct": "go_jpeg2000_tpu_torch/csrc/mct.cu"}
# kernel -> (the TPU kernel it replaces, its source's key in SRC)
REPLACES = {"dwt53_fwd_level": ("go_jpeg2000_tpu/ops/dwt_pallas.py:101",
                                "dwt53"),
            "dwt53_inv_level": ("go_jpeg2000_tpu/ops/dwt_pallas.py:108",
                                "dwt53"),
            "dwt97_fwd_level": ("go_jpeg2000_tpu/ops/dwt_pallas.py:116",
                                "dwt97"),
            "dwt97_inv_level": ("go_jpeg2000_tpu/ops/dwt_pallas.py:123",
                                "dwt97"),
            # the send side of the row-shard lifting's ppermute exchanges
            # (_odd_update_sharded, _even_update_sharded)
            "dwt_pack_edges": ("go_jpeg2000_tpu/parallel/sharded.py:27",
                               "dwt_edges"),
            "ht_extract_blocks":
                ("go_jpeg2000_tpu/models/fused_encode.py:191", "ht_enc"),
            # cleanup_fields with its packing, _pack_bits (ht_tpu.py:124)
            "ht_cleanup_pack": ("go_jpeg2000_tpu/ops/ht_tpu.py:286",
                                "ht_enc"),
            "ht_compact_pool": ("go_jpeg2000_tpu/ops/ht_tpu.py:498",
                                "ht_enc"),
            "ht_magsgn_decode": ("go_jpeg2000_tpu/ops/ht_tpu_decode.py:34",
                                 "ht_dec"),
            "ht_blocks_to_pyramid":
                ("go_jpeg2000_tpu/ops/ht_tpu_decode.py:80", "ht_dec"),
            "ebcot_decision_slots":
                ("go_jpeg2000_tpu/ops/ebcot_device.py:254", "ebcot_enc"),
            "ebcot_compact_rows": ("go_jpeg2000_tpu/ops/mq_device.py:207",
                                   "ebcot_enc"),
            "ebcot_mq_encode": ("go_jpeg2000_tpu/ops/mq_device.py:165",
                                "ebcot_enc"),
            "ebcot_pool_rows": ("go_jpeg2000_tpu/ops/mq_device.py:220",
                                "ebcot_enc"),
            "band_stats": ("go_jpeg2000_tpu/parallel/sharded.py:300",
                           "band_stats"),
            # the jnp heads and tails XLA fused into the device programs
            # (fused_encode._fused_fn, ht_tpu_decode.fused_decode_fn,
            # sharded.make_tile_transform_step and make_tile_inverse_step):
            # forward_rct / forward_ict with the DC shift, and inverse_rct /
            # inverse_ict with the rounding, DC shift and clamp
            "mct_forward": ("go_jpeg2000_tpu/ops/mct.py:46", "mct"),
            "mct_inverse": ("go_jpeg2000_tpu/ops/mct.py:58", "mct")}
HT_KERNELS = ("ht_extract_blocks", "ht_cleanup_pack", "ht_compact_pool")
HT_DEC_KERNELS = ("ht_magsgn_decode", "ht_blocks_to_pyramid")
EBCOT_KERNELS = ("ebcot_decision_slots", "ebcot_compact_rows",
                 "ebcot_mq_encode", "ebcot_pool_rows")
N_EBCOT_GRAY = 8
N_EBCOT_RGB = 4
# BASELINE config 4: an 8192x8192 16-bit RGB image in 512x512 tiles, 5
# resolutions; byte identity with the CPU run at 2048x2048
C4_SIZE = 8192
C4_TILE = 512
C4_RES = 5
C4_CHECK = 2048
# a config-4 tile-origin class: 64 tiles of 512x512 (8 x 8 of them)
C4_CLASS_SIDE = 8
# the single-image phase: S1 and S2 a SINGLE_SIDE^2 RGB image, S3 a
# mammography-sized 12-bit frame (rows, columns; 3328 = 3 x 1024 + 256),
# S4 a small gray image (rows, columns) at odd offsets
SINGLE_SIDE = 4096
SINGLE_TILE = 1024
MAMMO = (4096, 3328)
ODD = (750, 1000)
# BASELINE config 2: a C2_SIDE^2 RGB image, lossy 9/7 + ICT, 3 layers and
# PCRD at C2_RATIO:1, JP2
C2_SIDE = 2048
C2_RATIO = 20.0
# BASELINE config 5: a C5_SIDE^2 RGB image in C5_TILE^2 tiles (64) over
# C5_HOSTS host processes
C5_SIDE = 4096
C5_TILE = 512
C5_HOSTS = (1, 2, 4)
# phase 16, the decode options: R1's viewport of config 4's image (x0, y0,
# x1, y1: 3 x 3 of its 256 tiles), R2's thumbnail (reduce_resolution),
# R3's region of the config-2 image in 128^2 precincts, the converters'
# plane side
R1_AREA = (2900, 3100, 3924, 4124)
THUMB_REDUCE = 3
R3_AREA = (0, 0, 256, 256)
CONVERT_SIDE = 2048
# phase 17, the encode options: M2's CT series (slices, side, slices held
# to the CPU run), M3's multispectral image and tiles, the side of the
# cases held to the CPU run (M3-M5), M6's python-backend image
CT_SLICES, CT_SIDE, CT_CHECK = 64, 512, 8
MS_SIDE, MS_TILE = 4096, 1024
OPT_SIDE = 2048
PY_SIDE = 128
# frame sides whose first level is checked on every level kernel (each
# keeps its strip in registers, so any even width takes it)
WIDE_SIDES = (4096, 8192)
# phase 18, odd geometry: the level kernels' shapes [N, H, W] at every
# origin parity (as tests/test_torch_cuda.py's), the 1080p batch (frames,
# rows, columns; HD_CHECK of them held to the CPU run) and the reduced
# decodes of S4's stream
PARITY_SHAPES = ((3, 1, 1), (2, 1, 9), (2, 9, 1), (2, 3, 3), (2, 35, 63),
                 (1, 1079, 1919), (24, 135, 240))
HD = (8, 1080, 1920)
HD_CHECK = 2
S4_REDUCE = (1, 2)
# NVIDIA H100 SXM data-sheet peaks (700 W): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s (128 lanes an SM, an FMA
# counted as two); int32 64 lanes an SM, 132 SMs at 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 16.7e12
# operations per element, counted from the kernel sources: per sample for
# the DWT levels (float32 for 9/7, int32 for 5/3) and for block extraction
# and the cleanup pass (per code-block sample; its packing as below); per
# pool word for compaction; per block sample for MagSgn extraction;
# per leaf sample for assembly; for the EBCOT decisions per block sample
# and coded bitplane (five passes over the block with up to 8 neighbour
# reads a sample, and one fixpoint sweep); per slot for the decision
# compaction; per decision for the MQ coder; per segment byte for the pool;
# per sample for the colour head and tail (int32 for 5/3, float32 for 9/7)
OPS_PER_ELEMENT = {"dwt53": 10, "dwt97": 30, "ht_extract_blocks": 12,
                   "ht_cleanup_pack": 40,
                   "ht_compact_pool": 4, "ht_magsgn_decode": 20,
                   "ht_blocks_to_pyramid": 12, "ebcot_decision_slots": 200,
                   "ebcot_compact_rows": 4, "ebcot_mq_encode": 30,
                   "ebcot_pool_rows": 2, "mct_forward": 4,
                   "mct_inverse": 6}
# the cleanup kernel's packing, as these blocks need it: per field of
# non-zero length, the length's mask (shift, subtract, AND), the widened
# shift into the 64-bit gather and its OR (two each), the bit position's
# add and the word test; per stream word the fields fill, the zero test,
# the index test, the store, the gather's 64-bit shift down (two), the
# position's subtract and the index's increment; per quad pair, the scan
# of its three bit counts: five steps of a 64-bit shuffle (two), a lane
# test and a 64-bit add (two), and the counts packed into 64 bits (two)
OPS_PER_FIELD = 9
OPS_PER_WORD = 7
OPS_PER_PAIR = 27
# the MQ coder's serial bound: cycles of one decision's dependent chain
# (context state and Qe loads from shared memory, the interval update and
# compare), at the SM clock the int32 rate above assumes
MQ_DEPENDENT_CYCLES = 60
SM_CLOCK_HZ = 1.98e9


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
    # a level reads each sample once and writes each band sample once
    rate = INT32_OPS_PER_S if kind == dwt.REV53 else FP32_OPS_PER_S
    lim = bound(8 * x.numel(), OPS_PER_ELEMENT[lib] * x.numel(), rate)
    times = {
        f"{lib}_fwd_level": (cuda_ms(lambda: fwd_kernel(x)),
                             cuda_ms(lambda: dwt.forward_2d(x, kind)))
        + lim,
        f"{lib}_inv_level": (cuda_ms(lambda: inv_kernel(bands)),
                             cuda_ms(lambda: dwt.inverse_2d(bands, kind)))
        + lim,
    }
    fns = {f"{lib}_fwd_level": lambda: fwd_kernel(x),
           f"{lib}_inv_level": lambda: inv_kernel(bands)}
    for name, (ms, plain_ms, bound_ms, by) in times.items():
        gbs = 8 * x.numel() / (ms * 1e-3) / 1e9
        time_line(name, ms, plain_ms, bound_ms, by, device_ms(fns[name]),
                  f"[{n},{H},{W}], {gbs:.1f} GB/s at 8 B/sample", card)
    return err, times


def check_wide_levels(dwt, dwt_cuda, transforms, dev, card):
    """Phase 3b: every level kernel takes any even width: the first level
    of a 4096x4096 and an 8192x8192 frame through transforms.forward_level
    and transforms.inverse_level (5/3 and 9/7) launches each kernel once,
    counts no plain level and equals the plain lifting exactly; each timed
    beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"dwt53_fwd_level": 0, "dwt53_inv_level": 0, "dwt97_fwd_level": 0,
           "dwt97_inv_level": 0}
    for side in WIDE_SIDES:
        for kind in (dwt.REV53, dwt.IRR97):
            lib = "dwt53" if kind == dwt.REV53 else "dwt97"
            shape = (1, side, side)
            if kind == dwt.REV53:
                x = torch.randint(-(1 << 17), 1 << 17, shape, generator=gen,
                                  device=dev, dtype=torch.int32)
            else:
                x = torch.rand(shape, generator=gen, device=dev) * 255 - 128
            dwt_cuda.reset_counts()
            got = transforms.forward_level(x, kind, 0, 0)
            ref = {k: v.contiguous() for k, v in
                   dwt.forward_2d(x, kind).items()}
            diff = {f"{lib}_fwd_level":
                    max((got[k] - ref[k]).abs().max().item() for k in ref)}
            rec = transforms.inverse_level(ref, kind, 0, 0)
            diff[f"{lib}_inv_level"] = (
                rec - dwt.inverse_2d(ref, kind)).abs().max().item()
            del rec
            torch.cuda.synchronize()
            plain = dwt_cuda.PLAIN_LEVELS
            for name, d in diff.items():
                launched = dwt_cuda.LAUNCHES[name]
                print(f"kernel check {name} {shape}: max|diff| {d}, "
                      f"launches {launched}, plain levels {plain}",
                      flush=True)
                if d or plain or launched != 1:
                    raise AssertionError(f"{name} at {side}x{side}: not the "
                                         "kernel, or not exact")
                err[name] = max(err[name], d)
            del got
            rate = INT32_OPS_PER_S if kind == dwt.REV53 else FP32_OPS_PER_S
            lim = bound(8 * x.numel(), OPS_PER_ELEMENT[lib] * x.numel(), rate)
            fwd_kernel = getattr(dwt_cuda, f"forward_2d_{kind}")
            inv_kernel = getattr(dwt_cuda, f"inverse_2d_{kind}")
            fns = {f"{lib}_fwd_level": (lambda: fwd_kernel(x),
                                        lambda: dwt.forward_2d(x, kind)),
                   f"{lib}_inv_level": (lambda: inv_kernel(ref),
                                        lambda: dwt.inverse_2d(ref, kind))}
            for name, (fn, plain_fn) in fns.items():
                time_line(name, cuda_ms(fn),
                          cuda_ms(plain_fn, reps=3, warmup=1), *lim,
                          device_ms(fn), f"[1,{side},{side}]", card)
            del x, ref
    dwt_cuda.reset_counts()
    torch.cuda.empty_cache()
    return err


MCT_DTYPES = (np.uint8, np.int8, np.int16, np.uint16, np.int32)
MCT_PRECISIONS = (1, 8, 12, 16, 29, 30, 31)
# [N, H, W] of every grid case: rows off 16 bytes, one pixel, aligned rows
MCT_SHAPES = ((2, 3, 5), (1, 1, 1), (2, 16, 20))
# the kernels a traced config-4 step may launch (symbol substrings): the
# colour kernels, the level kernels, band_stats and its memsets; any other
# event must stay under MCT_SMALL_US (the statistics' [L, 2] output)
STEP_KERNELS = ("mct_fwd_kernel", "mct_inv_kernel", "dwt53_", "dwt97_",
                "stats_kernel", "Memset")
MCT_SMALL_US = 20.0


def mct_samples(dtype, shape, seed):
    """Samples over the dtype's whole range, its extremes included."""
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    a = rng.randint(info.min, int(info.max) + 1, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    flat[:2] = (info.min, info.max)[:flat.size]
    return a.astype(dtype)


def bits_diff(got, want):
    """(max |got - want| as float64, whether the bits differ); float32 by
    its bit pattern, NaN equal to NaN only bit for bit."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return float("inf"), True
    if got.dtype == torch.float32:
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        same = torch.equal(got, want)
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    d = d[~torch.isnan(d)]
    return (d.max().item() if d.numel() else 0.0), not same


def check_mct_grid(transforms, mct_cuda, dev):
    """Phase 3c: mct_forward and mct_inverse against coefficients_plain and
    samples_plain on the card over tests/test_torch_cuda.py's grid (every
    upload dtype, precisions 1-31, signed and unsigned, 1, 3 and 4
    components, with and without RCT/ICT, 5/3 and 9/7, narrowed and not)
    on MCT_SHAPES, and the tail on floats past int32, infinities and NaN:
    bit for bit.  Returns the largest |diff| of each."""
    err = {"mct_forward": 0.0, "mct_inverse": 0.0}
    bad = []
    cases = 0

    def held(name, got, want, what):
        nonlocal cases
        d, differ = bits_diff(got, want)
        err[name] = max(err[name], d)
        cases += 1
        if differ:
            bad.append(f"{name} {what}")

    t0 = time.perf_counter()
    for di, dtype in enumerate(MCT_DTYPES):
        for precision in MCT_PRECISIONS:
            for signed in (False, True):
                seed = precision * 7 + di * 2 + signed
                for n, h, w in MCT_SHAPES:
                    for c in (1, 3, 4):
                        x = transforms.upload(
                            mct_samples(dtype, (n, c, h, w), seed), dev)
                        for kind in ("53", "97"):
                            for mct in (False, True):
                                what = (f"{np.dtype(dtype).name} {precision}"
                                        f" bits signed {signed} {(n, c, h, w)}"
                                        f" {kind} mct {mct}")
                                ref = transforms.coefficients_plain(
                                    x, kind, mct, precision, signed)
                                held("mct_forward", mct_cuda.mct_forward(
                                    x, kind, mct, precision, signed), ref,
                                    what)
                                g = torch.Generator(device=dev).manual_seed(
                                    seed + c)
                                noise = torch.randint(-4, 5, ref.shape,
                                                      generator=g,
                                                      device=dev)
                                coef = (ref + noise.to(torch.int32)
                                        if kind == "53" else
                                        ref + noise.to(torch.float32) / 2)
                                for narrow in (True, False):
                                    held("mct_inverse", mct_cuda.mct_inverse(
                                        coef, kind, mct, precision, signed,
                                        narrow), transforms.samples_plain(
                                        coef, kind, mct, precision, signed,
                                        narrow), f"{what} narrow {narrow}")
    vals = torch.tensor([3e9, -3e9, float("nan"), 2.0 ** 31, -2.0 ** 31, 2.5,
                         -2.5, 0.5, float("inf"), -float("inf"), 1e38],
                        device=dev)
    x = vals[torch.arange(3 * 4 * 16, device=dev) % vals.numel()].reshape(
        1, 3, 4, 16)
    for precision in (8, 16, 31):
        for signed in (False, True):
            for mct in (False, True):
                for narrow in (True, False):
                    held("mct_inverse", mct_cuda.mct_inverse(
                        x, "97", mct, precision, signed, narrow),
                        transforms.samples_plain(x, "97", mct, precision,
                                                 signed, narrow),
                        f"floats past int32 {precision} {signed} {mct}")
    torch.cuda.synchronize()
    print(f"kernel check mct_forward, mct_inverse: {cases} cases against "
          f"the plain versions, {len(bad)} differ, max|diff| "
          f"{err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if bad:
        raise AssertionError(f"mct kernels differ from plain: {bad[:5]}")
    return err


def mct_inputs(dev, n, c, side, dtype):
    """Random samples [n, c, side, side] of dtype made on the card (uint16
    as the bit pattern of int16)."""
    g = torch.Generator(device=dev).manual_seed(n + c)
    if dtype == torch.uint16:
        return torch.randint(-32768, 32768, (n, c, side, side), generator=g,
                             device=dev, dtype=torch.int16).view(torch.uint16)
    return torch.randint(0, 256, (n, c, side, side), generator=g, device=dev,
                         dtype=torch.uint8)


def mct_times(transforms, mct_cuda, dev, card, err):
    """Phase 3c: each colour kernel by CUDA events and alone beside its
    bound and its plain version, at config 4's tile batch (256 tiles of
    512x512 RGB: 16-bit RCT, and 8-bit ICT as the lossy leg) and at the
    main paths' batches (32 gray and 4 RGB 8-bit 512x512).  At each of
    these shapes the kernel's output is held bit for bit against its plain
    version's first, and its largest |diff| folded into err.  Returns the
    JSON line's times (config 4 lossless)."""
    times = {}
    for label, n, c, dtype, kind, mct, prec in (
            ("config 4", 256, 3, torch.uint16, "53", True, 16),
            ("config 4 lossy", 256, 3, torch.uint8, "97", True, 8),
            ("gray main path", N_GRAY, 1, torch.uint8, "53", False, 8),
            ("rgb main path", N_RGB, 3, torch.uint8, "53", True, 8)):
        x = mct_inputs(dev, n, c, H, dtype)
        coef = mct_cuda.mct_forward(x, kind, mct, prec, False)
        out = mct_cuda.mct_inverse(coef, kind, mct, prec, False)
        rate = INT32_OPS_PER_S if kind == "53" else FP32_OPS_PER_S
        for name, fn, plain, nbytes in (
                ("mct_forward",
                 lambda: mct_cuda.mct_forward(x, kind, mct, prec, False),
                 lambda: transforms.coefficients_plain(x, kind, mct, prec,
                                                       False),
                 x.numel() * x.element_size() + 4 * coef.numel()),
                ("mct_inverse",
                 lambda: mct_cuda.mct_inverse(coef, kind, mct, prec, False),
                 lambda: transforms.samples_plain(coef, kind, mct, prec,
                                                  False),
                 4 * coef.numel() + out.numel() * out.element_size())):
            what = (f"{label} [{n},{c},{H},{W}] {str(x.dtype)[6:]} {kind}"
                    f" mct {mct}")
            d, differ = bits_diff(fn(), plain())
            if differ:
                raise AssertionError(f"{name} differs from its plain version"
                                     f" at {what}: max|diff| {d}")
            err[name] = max(err[name], d)
            lim = bound(nbytes, OPS_PER_ELEMENT[name] * coef.numel(), rate)
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            time_line(name, ms, plain_ms, lim[0], lim[1], device_ms(fn),
                      f"{what}, bit for bit, {nbytes / 1e6:.1f} MB", card)
            if label == "config 4":
                times[name] = (ms, plain_ms) + lim
        del x, coef, out
    torch.cuda.empty_cache()
    return times


def traced_kernels(fn):
    """{device event name: [count, total us]} of one run of fn under
    torch.profiler, after a run outside it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            entry = out.setdefault(e.name, [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    return out


def mct_config4_steps(transforms, psh, dev, card):
    """Phase 3c: config 4's transform step (mct_forward, the 4 forward
    levels, band_stats) and inverse step (the 4 inverse levels,
    mct_inverse) on the tile batch, lossless (16-bit RCT) and lossy (8-bit
    ICT), by CUDA events (mean of 5 after 2 warm-ups) beside the one-pass
    bound (the samples read once, the leaves written once, and back); each
    step traced once with torch.profiler: no kernel but the step's own may
    take MCT_SMALL_US or more (no whole-image torch op is left)."""
    for label, dtype, kind, prec in (("lossless", torch.uint16, "53", 16),
                                     ("lossy", torch.uint8, "97", 8)):
        x = mct_inputs(dev, 256, 3, C4_TILE, dtype)
        pyr, _stats = psh.tile_transform_step(x, C4_RES - 1, True, prec,
                                              False, kind)
        leaf_bytes = sum(4 * v.numel() for e in pyr for v in e.values())
        steps = (("transform step",
                  lambda: psh.tile_transform_step(x, C4_RES - 1, True, prec,
                                                  False, kind),
                  x.numel() * x.element_size() + leaf_bytes),
                 ("inverse step",
                  lambda: psh.tile_inverse_step(pyr, True, prec, False,
                                                kind),
                  leaf_bytes + x.numel() * x.element_size()))
        for what, fn, nbytes in steps:
            ms = cuda_ms(fn, reps=5, warmup=2)
            events = traced_kernels(fn)
            own = {k: v for k, v in events.items()
                   if any(p in k for p in STEP_KERNELS)}
            other = {k: v for k, v in events.items() if k not in own}
            big = {k: v for k, v in other.items()
                   if v[1] / v[0] >= MCT_SMALL_US}
            names = sorted({k.split("(")[0].split("<")[0].split()[-1]
                            for k in own})
            print(f"config-4 {label} {what}: {ms:.4f} ms by events, bound "
                  f"{bound(nbytes, 0, 1)[0]:.4f} ms ({nbytes / 1e6:.1f} MB); "
                  f"traced kernels {names}, other device events "
                  f"{ {k[:60]: (v[0], round(v[1], 1)) for k, v in other.items()} }"
                  f" [{card}]", flush=True)
            if big:
                raise AssertionError(f"config-4 {label} {what}: device work "
                                     f"outside its kernels: {big}")
        del x, pyr
        torch.cuda.empty_cache()


def device_ms(fn, reps=20):
    """Device time of fn's kernels alone per call: the card runs reps calls
    back to back behind a spin kernel (torch.cuda._sleep) that holds the
    stream while the host enqueues them, so the CUDA events around them
    hold no wait for the host (the wrapper's own host time is what the
    plain CUDA-event time of a short kernel mostly measures).  The spin is
    lengthened until the card had not started the calls when the host had
    enqueued them all; None when a call waits for the card itself (a
    wrapper that reads a result back).  torch.profiler, which this used
    before, loses and stretches kernel events in a process that has run
    for a while (kernel_times.py --profiler-probe)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    return None


def time_line(name, ms, plain_ms, bound_ms, by, dev_ms, what, card):
    alone = ("not measured (the wrapper waits for the card)"
             if dev_ms is None else f"{dev_ms:.4f} ms")
    print(f"time {name} ({what}): kernel {ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({by}, {100 * bound_ms / ms:.1f}% reached), device time of "
          f"the kernel alone {alone}, plain torch {plain_ms:.4f} ms "
          f"[{card}]", flush=True)


def bound(nbytes, ops, ops_per_s):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_setup(tp, frames, opts):
    """Header, tile, plan and stacked batch [N, C, H, W] of an encode."""
    from go_jpeg2000_tpu_torch.models import encoder, fused_encode
    from go_jpeg2000_tpu_torch.tcd import geometry as geo
    header = encoder.build_header(frames[0], opts)
    prec = header.components[0].precision
    encoder._apply_comp_quants(header, opts, header.num_components, prec)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile, lossy=not opts.lossless)
    if plan is None:
        raise AssertionError("the fused encode refused the configuration")
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    return header, tile, plan, batch


def decode_batch_of(streams):
    """decode_batch's Batch of the streams, which its branches must take."""
    from go_jpeg2000_tpu_torch.models import decoder
    batch = decoder.prepare_batch(streams)
    if batch is None:
        raise AssertionError("decode_batch's branches refused the streams")
    return batch


def fused_args(header, batch, opts, dev):
    """fused_encode_chunk's arguments after the plan: levels, kind, MCT,
    precision, signedness, device."""
    from go_jpeg2000_tpu_torch.ops import dwt
    return (header.coding_style.num_decompositions,
            dwt.REV53 if opts.lossless else dwt.IRR97,
            bool(header.coding_style.mct) and batch.shape[1] >= 3,
            header.components[0].precision, False, dev)


def ht_case(tp, frames, opts, dev):
    """The HT kernels and their plain versions on one frame batch: returns
    (max |diff| per kernel, inputs for timing).  Each plain stage takes the
    plain version's output of the stage before, so each kernel is held
    against its plain version on the same inputs."""
    from go_jpeg2000_tpu_torch.models import fused_encode, transforms
    from go_jpeg2000_tpu_torch.ops import ht_enc, ht_enc_cuda as K
    header, _tile, plan, batch = fused_setup(tp, frames, opts)
    levels, kind, use_mct, prec, signed, _ = fused_args(header, batch, opts,
                                                        dev)
    n = len(frames)
    pyr = transforms.forward_pyramid(transforms.upload(batch, dev), levels,
                                     kind, use_mct, prec, signed, 0, 0)
    err = {}
    blocks = fused_encode.extract_blocks(pyr, plan, n, levels)
    got = K.extract_blocks(pyr, plan, n, levels)
    err["ht_extract_blocks"] = (got - blocks).abs().max().item()
    hs, ws = fused_encode._block_dims(plan, n, dev)
    ref = ht_enc.cleanup_fields(blocks, hs, ws, plan.max_mn)
    err["ht_cleanup_pack"] = cleanup_diff(
        K.cleanup_fields(blocks, hs, ws, plan.max_mn), ref)
    pool_args = [ref[k] for k in POOL_ARGS]
    pool, totals = ht_enc.assemble_pool(*pool_args)
    kpool, ktotals = K.assemble_pool(*pool_args)
    err["ht_compact_pool"] = max(
        (ktotals - totals).abs().max().item(),
        (kpool[:pool.numel()].long() - pool.long()).abs().max().item())
    torch.cuda.synchronize()
    inputs = dict(pyr=pyr, plan=plan, n=n, levels=levels, blocks=blocks,
                  hs=hs, ws=ws, ref=ref, pool_args=pool_args, pool=pool)
    return err, inputs


# ht_enc.assemble_pool's arguments, as ht_enc.cleanup_fields names them
POOL_ARGS = ("ms_words", "ms_bits", "vlc_words", "vlc_bits", "mel_words",
             "mel_bits", "numbps", "u_max", "dist")


def cleanup_diff(got, ref):
    """The largest |diff| between two cleanup passes' outputs (words, bits
    and meta; the distortion by its float32 bit pattern)."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"cleanup outputs {sorted(got)}, plain "
                             f"{sorted(ref)}")
    return max((got[k].view(torch.int32).long()
                - ref[k].view(torch.int32).long()).abs().max().item()
               if ref[k].numel() else 0 for k in ref)


def ht_cases(tp):
    """The HT kernels' cases: (name, frames, options), the lossless gray
    main path first (the one timed)."""
    lossless = tp.Options(format=tp.Format.J2K, lossless=True,
                          num_resolutions=6, high_throughput=True)
    lossy = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                       num_resolutions=6, high_throughput=True)
    rng = np.random.RandomState(5)
    return [
        ("gray", main_gray(), lossless),
        ("rgb", lossy_rgb(), lossy),
        ("rgb16", [rng.randint(0, 1 << 16, (H, W, 3)).astype(np.uint16)
                   for _ in range(2)], lossless),
        ("rgb16", [rng.randint(0, 1 << 16, (256, 256, 3)).astype(np.uint16)
                   for _ in range(2)], lossy),
        ("noise", [rng.randint(0, 256, (H, W)).astype(np.uint8)
                   for _ in range(4)], lossless),
        ("zeros", [np.zeros((256, 256), np.uint8)] * 2, lossless),
        ("zeros", [np.zeros((256, 256), np.uint8)] * 2, lossy),
        ("ragged", [natural_image(96, 80, seed=400 + i) for i in range(4)],
         lossless),
        ("ragged", [np.stack([natural_image(96, 80, seed=410 + 3 * i + c)
                              for c in range(3)], axis=-1)
                    for i in range(4)], lossy),
    ] + [
        # code_block_size is log2 (width, height)
        (f"cb{1 << lh}x{1 << lw}",
         [natural_image(256, 256, seed=420 + 4 * lw + lh + i)
          for i in range(4)],
         tp.Options(format=tp.Format.J2K, lossless=lossless_cb,
                    quality=85, num_resolutions=5, high_throughput=True,
                    code_block_size=(lw, lh)))
        for lw, lh, lossless_cb in ((5, 5, True), (5, 6, True),
                                    (7, 5, False), (5, 7, True))
    ]


def ht_pyramid(tp, frames, opts, dev):
    """(levels, the frames' pyramid on the card) as the fused HT encode
    makes it."""
    from go_jpeg2000_tpu_torch.models import transforms
    header, _tile, _plan, batch = fused_setup(tp, frames, opts)
    levels, kind, use_mct, prec, signed, _ = fused_args(header, batch, opts,
                                                        dev)
    return levels, transforms.forward_pyramid(
        transforms.upload(batch, dev), levels, kind, use_mct, prec, signed,
        0, 0)


def ht_blocks(tp, frames, opts, dev):
    """(plan, blocks int32 [n * nb, cbh, cbw], hs, ws) of the frames' fused
    HT encode, made on the card by the main path's own steps."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    from go_jpeg2000_tpu_torch.ops import ht_enc_cuda as K
    plan = fused_setup(tp, frames, opts)[2]
    levels, pyr = ht_pyramid(tp, frames, opts, dev)
    n = len(frames)
    blocks = K.extract_blocks(pyr, plan, n, levels)
    hs, ws = fused_encode._block_dims(plan, n, dev)
    return plan, blocks, hs, ws


def extract_bound(pyr, blocks, share=1.0):
    """ht_extract_blocks' bound: it reads every leaf sample once (of a
    class read in place, the class's `share` of the leaves' frames) and
    writes the block slots."""
    leaf_bytes = sum(4 * v.numel() for e in pyr for v in e.values())
    return bound(leaf_bytes * share + 4 * blocks.numel(),
                 OPS_PER_ELEMENT["ht_extract_blocks"] * blocks.numel(),
                 INT32_OPS_PER_S)


def flat_leaves(pyr):
    """A pyramid's leaves end to end, in its own iteration order."""
    return torch.cat([v.reshape(-1) for e in pyr for v in e.values()])


def slot_index(pyr, plan, n, levels):
    """Each block slot's position in flat_leaves(pyr), or the sentinel one
    past the last leaf sample where the slot is padding: the plain block
    extraction of a pyramid that holds each sample's position + 1.  The
    gather and the scatter of the lossless HT block layout as index
    tensors, made beforehand for the library calls."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    pos, base = [], 1
    for e in pyr:
        entry = {}
        for k, v in e.items():
            entry[k] = torch.arange(base, base + v.numel(), dtype=torch.int32,
                                    device=v.device).reshape(v.shape)
            base += v.numel()
        pos.append(entry)
    idx = fused_encode.extract_blocks(pos, plan, n, levels).long() - 1
    return torch.where(idx < 0, base - 1, idx)


def extract_library_ms(K, pyr, plan, n, levels):
    """The time of one PyTorch call that computes lossless
    ht_extract_blocks: torch.take over the flat pyramid with one zero
    appended (the padding's sentinel), the index made beforehand."""
    flat = flat_leaves(pyr)
    flat = torch.cat([flat, flat.new_zeros(1)])
    idx = slot_index(pyr, plan, n, levels)
    fn = lambda: torch.take(flat, idx)   # noqa: E731
    if not torch.equal(fn(), K.extract_blocks(pyr, plan, n, levels)):
        raise AssertionError("torch.take's block slots differ")
    return cuda_ms(fn), device_ms(fn)


def assemble_library_ms(K, blocks, plan, n, n_comps, nl):
    """The time of one PyTorch call that computes lossless
    ht_blocks_to_pyramid: Tensor.index_copy_ of every slot sample into the
    flat pyramid buffer (padding into one sink past its end), the index
    made beforehand."""
    pyr = K.blocks_to_pyramid(blocks, plan, n, n_comps, nl)
    want = flat_leaves(pyr)
    idx = slot_index(pyr, plan, n, nl).reshape(-1)
    src = blocks.reshape(-1)
    buf = torch.empty(want.numel() + 1, dtype=src.dtype, device=src.device)
    fn = lambda: buf.index_copy_(0, idx, src)   # noqa: E731
    fn()
    if not torch.equal(buf[:-1], want):
        raise AssertionError("index_copy_'s pyramid differs")
    return cuda_ms(fn), device_ms(fn)


def config4_class(tp, lossless=True):
    """One tile-origin class of config 4 as a frame batch: the 64 tiles of
    a 4096x4096 16-bit RGB image of its smooth noise as 512x512 frames, with
    config 4's HT options (5 resolutions) and no tiling: 64 x 3 components
    x 67 code-blocks = 12,864 blocks of 64x64.  lossless=False: the lossy
    leg's class, the image >> 8 at quality 85."""
    side = C4_CLASS_SIDE * C4_TILE
    img = config4_image(side)
    if not lossless:
        img = (img >> 8).astype(np.uint8)
    frames = [img[y:y + C4_TILE, x:x + C4_TILE]
              for y in range(0, side, C4_TILE)
              for x in range(0, side, C4_TILE)]
    return frames, tp.Options(format=tp.Format.J2K, lossless=lossless,
                              num_resolutions=C4_RES, high_throughput=True,
                              **({} if lossless else {"quality": 85}))


def cleanup_check(K, ht_enc, blocks, hs, ws, max_mn, label):
    """The fused cleanup kernel against its plain version on one block
    batch: every output bit for bit (words, bits, numbps, u_max, the
    distortion's float32 bits).  Returns (the plain outputs, max|diff|)."""
    ref = ht_enc.cleanup_fields(blocks, hs, ws, max_mn)
    diff = cleanup_diff(K.cleanup_fields(blocks, hs, ws, max_mn), ref)
    print(f"kernel check ht_cleanup_pack {label} ({blocks.shape[0]} blocks "
          f"of {blocks.shape[1]}x{blocks.shape[2]}, max_mn {max_mn}): "
          f"max|diff| {diff}", flush=True)
    if diff:
        raise AssertionError(f"{label}: ht_cleanup_pack disagrees with its "
                             "plain version")
    return ref, diff


def extreme_blocks(dev, seed=11):
    """64 blocks of 64x64 with magnitudes up to 2^30 - 1, the 30-bit limit
    of the cleanup fields, 40% zeros, both signs, ragged true sizes."""
    rng = np.random.RandomState(seed)
    c = rng.randint(-(1 << 30) + 1, 1 << 30, size=(64, 64, 64))
    c[rng.rand(64, 64, 64) < 0.4] = 0
    hs = rng.randint(1, 65, size=64).astype(np.int32)
    ws = rng.randint(1, 65, size=64).astype(np.int32)
    return (torch.from_numpy(c.astype(np.int32)).to(dev),
            torch.from_numpy(hs).to(dev), torch.from_numpy(ws).to(dev))


def case_label(name, frames, opts):
    return (f"{name} {len(frames)}x{'x'.join(map(str, frames[0].shape))} "
            f"{'lossless' if opts.lossless else 'lossy'}")


def check_ht_kernels(tp, dev, card):
    """Phase 4: every HT encode kernel against its plain version on the
    main paths' block batches and on 16-bit, noise, all-zero and ragged
    frames; times and bounds on the lossless gray batch."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    from go_jpeg2000_tpu_torch.ops import ht_enc, ht_enc_cuda as K
    err = {k: 0 for k in HT_KERNELS}
    timing = None
    for name, frames, opts in ht_cases(tp):
        label = case_label(name, frames, opts)
        e, inputs = ht_case(tp, frames, opts, dev)
        print(f"kernel check {label} ({inputs['plan'].nb * inputs['n']} "
              f"blocks, max_mn {inputs['plan'].max_mn}): max|diff| {e}",
              flush=True)
        if any(e.values()):
            raise AssertionError(f"{label}: an HT kernel disagrees with its "
                                 "plain version")
        for k in err:
            err[k] = max(err[k], e[k])
        if timing is None:
            timing = inputs

    t = timing
    pyr, plan, n, levels = t["pyr"], t["plan"], t["n"], t["levels"]
    blocks, hs, ws, ref = t["blocks"], t["hs"], t["ws"], t["ref"]
    pool_args, pool = t["pool_args"], t["pool"]
    nb = blocks.shape[0]
    used = pool.numel() - 6 * nb
    mn = plan.max_mn
    times = {
        "ht_extract_blocks": (
            cuda_ms(lambda: K.extract_blocks(pyr, plan, n, levels)),
            cuda_ms(lambda: fused_encode.extract_blocks(pyr, plan, n,
                                                        levels), reps=5),
            extract_bound(pyr, blocks)),
        "ht_cleanup_pack": (
            cuda_ms(lambda: K.cleanup_fields(blocks, hs, ws, mn)),
            cuda_ms(lambda: ht_enc.cleanup_fields(blocks, hs, ws, mn),
                    reps=3, warmup=1),
            cleanup_bound(blocks, hs, ws, ref)),
        "ht_compact_pool": (
            cuda_ms(lambda: K.assemble_pool(*pool_args)),
            cuda_ms(lambda: ht_enc.assemble_pool(*pool_args), reps=5),
            pool_bound(nb, used)),
    }
    kernel_fns = {
        "ht_extract_blocks": lambda: K.extract_blocks(pyr, plan, n, levels),
        "ht_cleanup_pack": lambda: K.cleanup_fields(blocks, hs, ws, mn),
        "ht_compact_pool": lambda: K.assemble_pool(*pool_args)}
    for name, (ms, plain_ms, (bound_ms, by)) in times.items():
        time_line(name, ms, plain_ms, bound_ms, by,
                  device_ms(kernel_fns[name]),
                  f"{nb} blocks of {plan.cbh}x{plan.cbw}", card)
    take_ms, take_alone = extract_library_ms(K, pyr, plan, n, levels)
    library = {"ht_compact_pool": pool_library_ms(pool_args, pool),
               "ht_extract_blocks": take_ms}
    print(f"time ht_compact_pool: library call torch.masked_select per "
          f"stream and torch.cat with the meta rows (masks and meta made "
          f"beforehand) {library['ht_compact_pool']:.4f} ms, kernel "
          f"{times['ht_compact_pool'][0]:.4f} ms (both by CUDA events; the "
          f"library call reads three sizes back) [{card}]", flush=True)
    print(f"time ht_extract_blocks: library call torch.take over the flat "
          f"pyramid and a zero (index made beforehand) {take_ms:.4f} ms, "
          f"kernel {times['ht_extract_blocks'][0]:.4f} ms (both by CUDA "
          f"events); the library call alone {take_alone:.4f} ms "
          f"[{card}]", flush=True)
    print("time ht_cleanup_pack: library call none (no PyTorch call "
          "computes the cleanup pass or packs its streams)", flush=True)
    err["ht_cleanup_pack"] = max(err["ht_cleanup_pack"], cleanup_check(
        K, ht_enc, *extreme_blocks(dev), 31, "magnitudes up to 2^30-1")[1])
    cleanup_err, pool_err = class_timing(tp, dev, card)
    err["ht_cleanup_pack"] = max(err["ht_cleanup_pack"], cleanup_err)
    err["ht_compact_pool"] = max(err["ht_compact_pool"], pool_err,
                                 check_pool_stress(dev))
    return err, {k: (a, b) + c for k, (a, b, c) in times.items()}, library


def pool_library_ms(pool_args, pool):
    """The time of one PyTorch expression that computes ht_compact_pool's
    output: torch.masked_select of each stream's used words and torch.cat
    with the six meta rows, the masks and the meta made beforehand."""
    ms_w, ms_b, vlc_w, vlc_b, mel_w, mel_b, numbps, u_max, dist = pool_args
    meta = torch.stack([ms_b, vlc_b, mel_b, numbps, u_max,
                        dist.view(torch.int32)]).reshape(-1)
    parts = []
    for w, b in ((ms_w, ms_b), (vlc_w, vlc_b), (mel_w, mel_b)):
        cols = torch.arange(w.shape[1], device=w.device)
        parts.append((w, cols[None, :] < ((b.long() + 31) >> 5)[:, None]))
    fn = lambda: torch.cat(   # noqa: E731
        [meta] + [torch.masked_select(w, m) for w, m in parts])
    if not torch.equal(fn(), pool):
        raise AssertionError("masked_select's HT pool differs")
    return cuda_ms(fn)


def check_pool_stress(dev):
    """ht_compact_pool on ht_enc_cuda.pool_stress_cases with the word rows
    0 and 1 words past a 16-byte boundary: the used prefix and the totals
    against ht_enc.assemble_pool.  Returns 0 (raises on a difference)."""
    from go_jpeg2000_tpu_torch.ops import ht_enc, ht_enc_cuda as K
    for name, host in K.pool_stress_cases().items():
        for base in (0, 1):
            args = []
            for a in host:
                if a.ndim == 2:
                    buf = torch.empty(a.size + 4, dtype=torch.int32,
                                      device=dev)
                    t = buf[base:base + a.size].view(a.shape)
                    t.copy_(torch.from_numpy(a))
                else:
                    t = torch.from_numpy(a).to(dev)
                args.append(t)
            out, totals = K.assemble_pool(*args)
            want, wtot = ht_enc.assemble_pool(*args)
            bad = int((totals != wtot).sum().item()) + int(
                (out[:want.numel()] != want).sum().item())
            print(f"kernel check ht_compact_pool stress {name} (word rows "
                  f"base +{base} words, {host[1].size} rows, totals "
                  f"{wtot.tolist()}): differing {bad}", flush=True)
            if bad:
                raise AssertionError("ht_compact_pool disagrees on the "
                                     f"stress case {name}")
    return 0


def pool_bound(nb, used):
    """ht_compact_pool's least time for nb rows and `used` pool words: it
    reads the bit counts, the meta inputs and the used words, and writes
    the meta rows, the used words and the totals."""
    return bound(24 * nb + 4 * used + 24 * nb + 4 * used + 24,
                 OPS_PER_ELEMENT["ht_compact_pool"] * used, INT32_OPS_PER_S)


def cleanup_bound(blocks, hs, ws, out):
    """The fused cleanup kernel's least time: it reads the blocks, their
    sizes and the VLC table once and writes every output once (the three
    streams' word rows, their bit counts and the meta); it does the cleanup
    pass's operations for every block sample, the scan's for every quad
    pair, and the packing's for every field of non-zero length and every
    stream word, as these blocks need them (the plain version's field
    lengths; `out`'s bit totals)."""
    from go_jpeg2000_tpu_torch.ops import ht_enc
    nb, h, w = blocks.shape
    lens = ht_enc.cleanup_values(blocks, hs, ws)
    fields = sum(int((lens[f"{s}_lens"] > 0).sum().item())
                 for s in ("ms", "vlc", "mel"))
    del lens
    words = sum(int(((out[f"{s}_bits"].long() + 31) >> 5).sum().item())
                for s in ("ms", "vlc", "mel"))
    pairs = nb * ht_enc.field_counts(h, w)[0] // 8
    return bound(4 * blocks.numel() + 8 * nb + 4 * 8192
                 + sum(4 * v.numel() for v in out.values()),
                 OPS_PER_ELEMENT["ht_cleanup_pack"] * blocks.numel()
                 + OPS_PER_PAIR * pairs + OPS_PER_FIELD * fields
                 + OPS_PER_WORD * words, INT32_OPS_PER_S)


def class_timing(tp, dev, card):
    """The fused cleanup kernel on config-4 tile-origin classes (12,864
    blocks each), lossless (16-bit) and lossy, and the pool compaction on
    the lossless class (two rounds of its scan): each checked against its
    plain version on the class, then timed.  Returns the cleanup kernel's
    and the compaction's largest |diff|."""
    from go_jpeg2000_tpu_torch.ops import ht_enc, ht_enc_cuda as K
    cleanup_err = 0
    for lossless in (True, False):
        frames, opts = config4_class(tp, lossless)
        plan, blocks, hs, ws = ht_blocks(tp, frames, opts, dev)
        del frames
        mn = plan.max_mn
        kind = "lossless 16-bit RGB" if lossless else "lossy, the image >> 8"
        what = (f"config-4 class: {blocks.shape[0]} blocks of 64x64, "
                f"{kind}, max_mn {mn}")
        ref, diff = cleanup_check(K, ht_enc, blocks, hs, ws, mn,
                                  f"config-4 {kind} class")
        cleanup_err = max(cleanup_err, diff)
        t0 = time.perf_counter()
        ht_enc.cleanup_fields(blocks, hs, ws, mn)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        fn = lambda: K.cleanup_fields(blocks, hs, ws, mn)   # noqa: E731
        time_line("ht_cleanup_pack", cuda_ms(fn), plain_ms,
                  *cleanup_bound(blocks, hs, ws, ref), device_ms(fn), what,
                  card)
        nb = blocks.shape[0]
        del blocks
        if not lossless:
            del ref
            continue
        pool_args = [ref[k] for k in POOL_ARGS]
        del ref
        pool, totals = ht_enc.assemble_pool(*pool_args)
        t0 = time.perf_counter()
        ht_enc.assemble_pool(*pool_args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        kout, ktotals = K.assemble_pool(*pool_args)
        pool_diff = max(int((ktotals != totals).sum().item()), int(
            (kout[:pool.numel()] != pool).sum().item()))
        print(f"kernel check ht_compact_pool config-4 class ({nb} blocks, "
              f"{pool.numel() - 6 * nb} pool words): differing {pool_diff}",
              flush=True)
        if pool_diff:
            raise AssertionError("config-4 class: ht_compact_pool disagrees "
                                 "with its plain version")
        fn = lambda: K.assemble_pool(*pool_args)   # noqa: E731
        time_line("ht_compact_pool", cuda_ms(fn), plain_ms,
                  *pool_bound(nb, pool.numel() - 6 * nb), device_ms(fn),
                  what, card)
        del pool_args, pool, kout
        torch.cuda.empty_cache()
    return cleanup_err, pool_diff


def magsgn_bits(qinfo):
    """The MagSgn bits the quad words ask for: the sum over samples of
    m = rho_n ? U - ek_n : 0."""
    q = qinfo.long() & 0xFFFFFFFF
    i4 = torch.arange(4, device=q.device)
    sig = ((q >> 8)[..., None] >> i4) & 1
    ek = ((q >> 12)[..., None] >> i4) & 1
    return int((sig * ((q & 0xFF)[..., None] - ek)).sum().item())


def magsgn_bound(qinfo, blocks):
    """ht_magsgn_decode's bound: it reads the quad words, the pool words the
    fields need and the block offsets, and writes the slots."""
    return bound(4 * qinfo.numel() + 4 * -(-magsgn_bits(qinfo) // 32)
                 + 8 * blocks.shape[0] + 4 * blocks.numel(),
                 OPS_PER_ELEMENT["ht_magsgn_decode"] * blocks.numel(),
                 INT32_OPS_PER_S)


def check_ht_dec_kernels(tp, dev, card):
    """Phase 5: both HT decode kernels against their plain versions on the
    native parse of the HT kernel cases' streams, and MagSgn on
    ht_dec.stress_cases: equal, float32 leaves bit for bit; times and
    bounds on the lossless gray batch."""
    from go_jpeg2000_tpu_torch.models import decoder
    from go_jpeg2000_tpu_torch.ops import dwt, ht_dec, ht_dec_cuda as K
    err = {k: 0 for k in HT_DEC_KERNELS}
    timing = None
    for name, frames, opts in ht_cases(tp):
        label = case_label(name, frames, opts)
        streams = tp.encode_batch(frames, opts, device=dev)
        batch = decode_batch_of(streams)
        plan, n = batch.plan, len(frames)
        qinfo, pool, woff = decoder.upload_parsed(
            *decoder.parse_chunk(batch, batch.bodies), dev)
        blocks = ht_dec.magsgn_decode_blocks(qinfo, pool, woff, plan.cbh,
                                             plan.cbw)
        got = K.magsgn_decode_blocks(qinfo, pool, woff, plan.cbh, plan.cbw)
        e = {"ht_magsgn_decode": (got - blocks).abs().max().item()}
        diff = 0
        dequant = batch.kind == dwt.IRR97
        ref = ht_dec.blocks_to_pyramid(blocks, plan, n, batch.n_comps,
                                       batch.nl, dequant)
        kp = K.blocks_to_pyramid(blocks, plan, n, batch.n_comps, batch.nl,
                                 dequant)
        for r_lev, k_lev in zip(ref, kp):
            if sorted(r_lev) != sorted(k_lev):
                raise AssertionError(f"{label}: pyramid bands differ")
            for k in r_lev:
                # bit patterns: float32 leaves must agree bit for bit
                a = k_lev[k].view(torch.int32).long()
                b = r_lev[k].contiguous().view(torch.int32).long()
                diff = max(diff, (a - b).abs().max().item())
        e["ht_blocks_to_pyramid"] = diff
        torch.cuda.synchronize()
        print(f"kernel check decode {label} ({blocks.shape[0]} blocks, "
              f"{'float32' if dequant else 'int32'} leaves): max|diff| {e}",
              flush=True)
        if any(e.values()):
            raise AssertionError(f"{label}: an HT decode kernel disagrees "
                                 "with its plain version")
        for k in err:
            err[k] = max(err[k], e[k])
        if timing is None:
            timing = (batch, n, qinfo, pool, woff, blocks, ref)

    err["ht_magsgn_decode"] = max(err["ht_magsgn_decode"],
                                  check_magsgn_stress(dev),
                                  check_magsgn_classes(tp, dev, card))
    batch, n, qinfo, pool, woff, blocks, ref = timing
    plan = batch.plan
    leaf_samples = sum(v.numel() for e in ref for v in e.values())
    bits = magsgn_bits(qinfo)
    nb = blocks.shape[0]
    kernel_fns = {
        "ht_magsgn_decode": lambda: K.magsgn_decode_blocks(
            qinfo, pool, woff, plan.cbh, plan.cbw),
        "ht_blocks_to_pyramid": lambda: K.blocks_to_pyramid(
            blocks, plan, n, batch.n_comps, batch.nl)}
    times = {
        "ht_magsgn_decode": (
            cuda_ms(kernel_fns["ht_magsgn_decode"]),
            cuda_ms(lambda: ht_dec.magsgn_decode_blocks(
                qinfo, pool, woff, plan.cbh, plan.cbw), reps=5),
            magsgn_bound(qinfo, blocks)),
        "ht_blocks_to_pyramid": (
            cuda_ms(kernel_fns["ht_blocks_to_pyramid"]),
            cuda_ms(lambda: ht_dec.blocks_to_pyramid(
                blocks, plan, n, batch.n_comps, batch.nl), reps=5),
            assemble_bound(ref)),
    }
    for name, (ms, plain_ms, (bound_ms, by)) in times.items():
        time_line(name, ms, plain_ms, bound_ms, by,
                  device_ms(kernel_fns[name]),
                  f"{nb} blocks of {plan.cbh}x{plan.cbw}, {bits} MagSgn "
                  f"bits, {leaf_samples} leaf samples", card)
    copy_ms, copy_alone = assemble_library_ms(K, blocks, plan, n,
                                              batch.n_comps, batch.nl)
    library = {"ht_blocks_to_pyramid": copy_ms}
    print(f"time ht_blocks_to_pyramid: library call Tensor.index_copy_ into "
          f"the flat pyramid (index made beforehand) {copy_ms:.4f} ms, "
          f"kernel {times['ht_blocks_to_pyramid'][0]:.4f} ms (both by CUDA "
          f"events); the library call alone {copy_alone:.4f} ms [{card}]",
          flush=True)
    return err, {k: (a, b) + c for k, (a, b, c) in times.items()}, library


def leaves_diff(got, ref):
    """The largest |diff| of two pyramids' bit patterns (float32 leaves bit
    for bit); raises if their bands differ."""
    diff = 0
    for g_lev, r_lev in zip(got, ref):
        if sorted(g_lev) != sorted(r_lev):
            raise AssertionError("pyramid bands differ")
        for k in r_lev:
            a = g_lev[k].contiguous().view(torch.int32).long()
            b = r_lev[k].contiguous().view(torch.int32).long()
            diff = max(diff, (a - b).abs().max().item())
    return diff


def assemble_bound(leaves):
    """ht_blocks_to_pyramid's bound: it reads each leaf sample's slot value
    once and writes the leaf sample."""
    count = sum(v.numel() for e in leaves for v in e.values())
    return bound(8 * count,
                 OPS_PER_ELEMENT["ht_blocks_to_pyramid"] * count,
                 INT32_OPS_PER_S)


def check_layout_classes(tp, dev, card):
    """Both layout kernels on a config-4 tile-origin class (12,864 blocks of
    64 tiles), lossless and lossy: the extraction of the class's pyramid
    and the assembly (midpoint dequantization on the lossy class) of its
    blocks, each equal to its plain version, float32 leaves bit for bit,
    and timed beside its bound: by CUDA events through the wrapper, alone,
    and, lossless, beside its library call (torch.take, index_copy_).
    Returns the largest |diff| of each."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    from go_jpeg2000_tpu_torch.ops import ht_dec, ht_dec_cuda, \
        ht_enc_cuda as K
    err = {"ht_extract_blocks": 0, "ht_blocks_to_pyramid": 0}
    for lossless in (True, False):
        frames, opts = config4_class(tp, lossless)
        plan = fused_setup(tp, frames, opts)[2]
        levels, pyr = ht_pyramid(tp, frames, opts, dev)
        n = len(frames)
        nc = pyr[0]["HL"].shape[1]
        del frames
        what = (f"config-4 {'lossless' if lossless else 'lossy'} class: "
                f"{n * plan.nb} blocks of {plan.cbh}x{plan.cbw}")
        fn = lambda: K.extract_blocks(pyr, plan, n, levels)  # noqa: E731
        blocks = fn()
        plain = lambda: fused_encode.extract_blocks(  # noqa: E731
            pyr, plan, n, levels)
        diff = (blocks - plain()).abs().max().item()
        print(f"kernel check ht_extract_blocks {what}: max|diff| {diff}",
              flush=True)
        err["ht_extract_blocks"] = max(err["ht_extract_blocks"], diff)
        ms = cuda_ms(fn)
        time_line("ht_extract_blocks", ms, cuda_ms(plain, reps=3, warmup=1),
                  *extract_bound(pyr, blocks), device_ms(fn), what, card)
        if lossless:
            take_ms, take_alone = extract_library_ms(K, pyr, plan, n, levels)
            print(f"time ht_extract_blocks ({what}): library call "
                  f"torch.take {take_ms:.4f} ms, alone {take_alone:.4f} ms; "
                  f"kernel {ms:.4f} ms (both by CUDA events) [{card}]",
                  flush=True)
        del pyr
        torch.cuda.empty_cache()
        dequant = not lossless
        fn = lambda: ht_dec_cuda.blocks_to_pyramid(  # noqa: E731
            blocks, plan, n, nc, levels, dequant)
        plain = lambda: ht_dec.blocks_to_pyramid(  # noqa: E731
            blocks, plan, n, nc, levels, dequant)
        got = fn()
        diff = leaves_diff(got, plain())
        print(f"kernel check ht_blocks_to_pyramid {what}: max|diff| {diff}",
              flush=True)
        err["ht_blocks_to_pyramid"] = max(err["ht_blocks_to_pyramid"], diff)
        ms = cuda_ms(fn)
        time_line("ht_blocks_to_pyramid", ms,
                  cuda_ms(plain, reps=3, warmup=1), *assemble_bound(got),
                  device_ms(fn), what, card)
        if lossless:
            copy_ms, copy_alone = assemble_library_ms(
                ht_dec_cuda, blocks, plan, n, nc, levels)
            print(f"time ht_blocks_to_pyramid ({what}): library call "
                  f"Tensor.index_copy_ {copy_ms:.4f} ms, alone "
                  f"{copy_alone:.4f} ms; kernel {ms:.4f} ms (both by CUDA "
                  f"events) [{card}]", flush=True)
        del blocks, got
        torch.cuda.empty_cache()
    err["ht_extract_blocks"] = max(err["ht_extract_blocks"],
                                   check_extract_in_place(tp, dev, card))
    if any(err.values()):
        raise AssertionError(f"a layout kernel disagrees with its plain "
                             f"version on a config-4 class: {err}")
    return err


def check_extract_in_place(tp, dev, card):
    """ht_extract_blocks with a tile index, as config 4's encode calls it:
    every chunk of every tile-origin class of the whole tile batch's
    leaves (64 tiles of 256 frames), lossless and lossy, read in place and
    equal to the plain version (index_select, then the extraction); the
    first chunk of each timed.  Returns the largest |diff|."""
    from go_jpeg2000_tpu_torch.models import encoder, fused_encode, \
        transforms
    from go_jpeg2000_tpu_torch.ops import dwt, ht_enc_cuda as K
    from go_jpeg2000_tpu_torch.parallel import sharded as psh
    err = 0
    img = config4_image(C4_SIZE)
    for lossless in (True, False):
        if not lossless:
            img = (img >> 8).astype(np.uint8)
        opts = config4_opts(tp, lossless)
        header = encoder.build_header(img, opts)
        prec = header.components[0].precision
        comps = encoder._image_components(img)
        encoder._apply_comp_quants(header, opts, len(comps), prec)
        levels = header.coding_style.num_decompositions
        T, th, tw = psh._check_grid(header, levels, 1, "chip_smoke")
        tiles = list(range(T))
        pyr = psh.tile_transform_step(
            transforms.upload(psh.tile_batch(header, comps, tiles, th, 0),
                              dev), levels,
            bool(header.coding_style.mct) and len(comps) >= 3, prec, False,
            dwt.REV53 if lossless else dwt.IRR97)[0]
        per = psh.fused_chunk_tiles(len(comps), th, tw)
        del comps
        kind = "lossless" if lossless else "lossy"
        for c, (plan, _rep, pos) in enumerate(psh.ht_plans(header, tiles)):
            for s in range(0, len(pos), per):
                sub = pos[s:s + per]
                n = len(sub)
                fn = lambda: K.extract_blocks(  # noqa: E731
                    pyr, plan, n, levels, sub)
                plain = lambda: fused_encode.extract_blocks(  # noqa: E731
                    pyr, plan, n, levels, sub)
                got = fn()
                diff = (got - plain()).abs().max().item()
                what = (f"config-4 {kind} class {c}, tiles {sub[0]}..."
                        f"{sub[-1]}: {n} of {T} leaf frames read in place, "
                        f"{got.shape[0]} blocks")
                print(f"kernel check ht_extract_blocks {what}: max|diff| "
                      f"{diff}", flush=True)
                err = max(err, diff)
                if c == 0 and s == 0:
                    time_line("ht_extract_blocks", cuda_ms(fn),
                              cuda_ms(plain, reps=3, warmup=1),
                              *extract_bound(pyr, got, n / T),
                              device_ms(fn), what, card)
                del got
        del pyr
        torch.cuda.empty_cache()
    return err


def check_layout_stress(dev):
    """Both layout kernels on block_layout.layout_stress_cases (offset grids
    off multiples of 4, odd band widths, 32x32 and 64x16 blocks, one and
    three frames), the extraction's leaves 0, 1 and 3 words past a 16-byte
    boundary and strided: equal to their plain versions, float32 leaves
    bit for bit; raises otherwise.  Returns the largest |diff| of each."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    from go_jpeg2000_tpu_torch.ops import block_layout, ht_dec, \
        ht_dec_cuda, ht_enc_cuda
    err = {"ht_extract_blocks": 0, "ht_blocks_to_pyramid": 0}
    for name, plan, n, nc, levels in block_layout.layout_stress_cases():
        pyr, slots = block_layout.stress_inputs(plan, n, nc, levels, seed=7)
        slots = torch.from_numpy(slots).to(dev)
        for phase in (0, 1, 3, "strided"):
            tpyr = block_layout.stress_leaves(pyr, dev, phase)
            got = ht_enc_cuda.extract_blocks(tpyr, plan, n, levels)
            want = fused_encode.extract_blocks(tpyr, plan, n, levels)
            err["ht_extract_blocks"] = max(err["ht_extract_blocks"], (
                got - want).abs().max().item())
        diffs = []
        for dequant in ((False, True) if plan.deltas is not None
                        else (False,)):
            diffs.append(leaves_diff(
                ht_dec_cuda.blocks_to_pyramid(slots, plan, n, nc, levels,
                                              dequant),
                ht_dec.blocks_to_pyramid(slots, plan, n, nc, levels,
                                         dequant)))
        err["ht_blocks_to_pyramid"] = max([err["ht_blocks_to_pyramid"]]
                                          + diffs)
        print(f"kernel check layout stress {name} ({n} frames of {plan.nb} "
              f"{plan.cbh}x{plan.cbw} slots, {nc} components, "
              f"{'lossy' if plan.deltas is not None else 'lossless'}): "
              f"max|diff| {err}", flush=True)
        if any(err.values()):
            raise AssertionError(f"a layout kernel disagrees with its plain "
                                 f"version on the stress plan {name}")
    return err


def check_magsgn_classes(tp, dev, card):
    """The MagSgn kernel on the native parse of a config-4 tile-origin
    class's streams (12,864 blocks), lossless and lossy: equal to its
    plain version on the card, and timed beside its bound.  Returns the
    largest |diff| (0)."""
    from go_jpeg2000_tpu_torch.models import decoder
    from go_jpeg2000_tpu_torch.ops import ht_dec, ht_dec_cuda as K
    for lossless in (True, False):
        frames, opts = config4_class(tp, lossless)
        batch = decode_batch_of(tp.encode_batch(frames, opts,
                                                 device=dev))
        del frames
        qinfo, pool, woff = decoder.upload_parsed(
            *decoder.parse_chunk(batch, batch.bodies), dev)
        cbh, cbw = batch.plan.cbh, batch.plan.cbw
        fn = lambda: K.magsgn_decode_blocks(  # noqa: E731
            qinfo, pool, woff, cbh, cbw)
        got = fn()
        plain = lambda: ht_dec.magsgn_decode_blocks(  # noqa: E731
            qinfo, pool, woff, cbh, cbw)
        diff = (got.long() - plain().long()).abs().max().item()
        what = (f"config-4 {'lossless' if lossless else 'lossy'} class: "
                f"{got.shape[0]} blocks of {cbh}x{cbw}, "
                f"{magsgn_bits(qinfo)} MagSgn bits")
        print(f"kernel check ht_magsgn_decode {what}: max|diff| {diff}",
              flush=True)
        if diff:
            raise AssertionError("ht_magsgn_decode disagrees with its plain "
                                 "version on a config-4 class")
        time_line("ht_magsgn_decode", cuda_ms(fn),
                  cuda_ms(plain, reps=3, warmup=1),
                  *magsgn_bound(qinfo, got), device_ms(fn), what, card)
        del batch, qinfo, pool, woff, got
        torch.cuda.empty_cache()
    return 0


def check_magsgn_stress(dev):
    """The MagSgn kernel on ht_dec.stress_cases (32-bit fields, uncoded
    blocks, fields past the pool's end, odd widths, offsets with gaps and
    out of order, a block past the staging window, a pool 4 bytes off 16)
    against the plain version on the card: equal; raises otherwise.
    Returns the largest |diff| (0)."""
    from go_jpeg2000_tpu_torch.ops import ht_dec, ht_dec_cuda as K
    for name, q, buf, woff, cbh, cbw, off in ht_dec.stress_cases(
            K.STAGE_WORDS):
        qinfo = torch.from_numpy(q).to(dev)
        pool = torch.from_numpy(buf).to(dev)[off:]
        woff = torch.from_numpy(woff).to(dev)
        got = K.magsgn_decode_blocks(qinfo, pool, woff, cbh, cbw)
        ref = ht_dec.magsgn_decode_blocks(qinfo, pool, woff, cbh, cbw)
        diff = (got.long() - ref.long()).abs().max().item()
        print(f"kernel check ht_magsgn_decode stress {name} "
              f"({q.shape[0]} blocks of {cbh}x{cbw}, pool {pool.numel()} "
              f"words +{off}): max|diff| {diff}", flush=True)
        if diff:
            raise AssertionError("ht_magsgn_decode disagrees with its plain "
                                 f"version on the stress case {name}")
    return 0


def main_gray():
    return [natural_image(H, W, seed=i) for i in range(N_GRAY)]


def lossy_rgb():
    n, h, w = LOSSY_RGB
    return [np.stack([natural_image(h, w, seed=300 + 3 * i + c)
                      for c in range(3)], axis=-1) for i in range(n)]


def encode_stages(tp, frames, opts, dev):
    """One fused encode of frames in its stages, synchronised: (device
    program s, device-to-host copy s, native Tier-2 s, fetched bytes,
    peak device bytes per sample)."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    header, tile, plan, batch = fused_setup(tp, frames, opts)
    args = fused_args(header, batch, opts, dev)
    n = len(frames)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, totals = fused_encode.fused_encode_chunk(batch, plan, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    meta, pool, tot = fused_encode.fetch_pool(out, totals, n, plan)
    t2 = time.perf_counter()
    fused_encode.t2_bodies(meta, pool, tot, n, plan, header, tile)
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    return (t1 - t0, t2 - t1, t3 - t2, meta.nbytes + pool.nbytes,
            peak / batch.size)


def idle_line(label, fn, dev, card):
    """Print fn()'s device idle share under torch.profiler, an upper bound
    wherever the profiler kept fewer device events than launch and copy
    calls (kernel_times.py --profiler-probe), and beside it the lower
    bound of the same run from CUDA events: 1 - the outermost device
    stages' event spans over the wall (tools/_clock.py idle_bracket)."""
    from go_jpeg2000_tpu_torch.tools._clock import idle_bracket
    b = idle_bracket(fn, dev)
    lower = (f"; from CUDA events at least {b['lower']:.3f} (device stages' "
             f"spans {b['spans_ms']:.2f} ms of that wall)")
    if b["upper"] is None:
        print(f"device idle share {label}: not measured (the profiler "
              f"recorded no device event){lower} [{card}]", flush=True)
        return
    print(f"device idle share {label}: {b['upper']:.3f} (device busy "
          f"{b['profiler_ms']:.2f} ms of {b['wall_ms']:.2f} ms wall under "
          f"torch.profiler, {b['kept']} device events kept of {b['calls']} "
          f"launch and copy calls){lower} [{card}]", flush=True)


def decode_stages(tp, streams, dev):
    """One device HT decode of streams in its stages, synchronised: (native
    parse s, upload s, device program s, download s, uploaded bytes, peak
    device bytes per sample).  The smoke batches fit one chunk."""
    from go_jpeg2000_tpu_torch.models import decoder
    from go_jpeg2000_tpu_torch.ops import ht_dec
    batch = decode_batch_of(streams)
    n = len(streams)
    samples = n * batch.n_comps * batch.tile.comps[0].h * batch.tile.comps[0].w
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    parsed = decoder.parse_chunk(batch, batch.bodies)
    t1 = time.perf_counter()
    qinfo, pool, woff = decoder.upload_parsed(*parsed, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = ht_dec.fused_decode(qinfo, pool, woff, batch.plan, n,
                              batch.n_comps, batch.nl, batch.kind,
                              batch.use_mct, batch.precision, batch.signed)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out.cpu()
    t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    return (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
            sum(a.nbytes for a in parsed), peak / samples)


def stage_lines(tp, label, frames, opts, streams, dev, card, reps):
    """The encode's and the decode's stages (medians of reps), each device
    program beside its one-pass bound (the encode's: the samples read and
    the fetched pool written once; the decode's: the upload read and the
    samples written once), and the device idle share of one encode and one
    decode."""
    enc = [encode_stages(tp, frames, opts, dev) for _ in range(reps)]
    e = [float(np.median([st[i] for st in enc])) for i in range(3)]
    nbytes = sum(f.nbytes for f in frames)
    print(f"encode stages {label} {len(frames)}x{frames[0].shape} (median of "
          f"{reps}): device program {e[0] * 1e3:.2f} ms (its upload "
          f"included; bound {bound(nbytes + enc[0][3], 0, 1)[0]:.4f} ms), "
          f"device-to-host "
          f"copy of {enc[0][3]} bytes {e[1] * 1e3:.2f} ms, native Tier-2 "
          f"{e[2] * 1e3:.2f} ms; peak device memory {enc[0][4]:.1f} "
          f"bytes/sample [{card}]", flush=True)
    dec = [decode_stages(tp, streams, dev) for _ in range(reps)]
    d = [float(np.median([st[i] for st in dec])) for i in range(4)]
    print(f"decode stages {label} {len(frames)}x{frames[0].shape} (median of "
          f"{reps}): native parse {d[0] * 1e3:.2f} ms, upload of "
          f"{dec[0][4]} bytes {d[1] * 1e3:.2f} ms, device program "
          f"{d[2] * 1e3:.2f} ms (bound "
          f"{bound(dec[0][4] + nbytes, 0, 1)[0]:.4f} ms), download "
          f"{d[3] * 1e3:.2f} ms; peak device "
          f"memory {dec[0][5]:.1f} bytes/sample [{card}]", flush=True)
    for what, fn in (
            ("encode", lambda: tp.encode_batch(frames, opts, device=dev)),
            ("decode", lambda: tp.decode_batch(streams, device=dev))):
        idle_line(f"{label} {what}", fn, dev, card)


def counted_run(tp, kernels, run, label, dwt_lib):
    """Run one main path with every count set to 0 just before it; check
    that its encode went through the fused encode and every HT encode
    kernel, its decode through the device HT decode and both HT decode
    kernels, its levels through the DWT kernels of dwt_lib, with no plain
    levels, and its head and tail through the colour kernels.  Returns (result, launches of those kernels)."""
    from go_jpeg2000_tpu_torch.ops import mct_cuda
    dwt_cuda, ht_enc_cuda, ht_dec_cuda = kernels
    reset_all_counts(tp)
    result = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in dwt_cuda.LAUNCHES.items()
                if k.startswith(dwt_lib)}
    launches.update(ht_enc_cuda.LAUNCHES)
    launches.update(ht_dec_cuda.LAUNCHES)
    launches.update(mct_cuda.LAUNCHES)
    snap = tp.counters.snapshot()
    paths = {k: snap.get(k, 0) for k in (
        "enc.fused_chunks", "enc.host_entropy_frames",
        "dec.device_ht_chunks", "dec.host_ht_frames")}
    plain = dwt_cuda.PLAIN_LEVELS
    print(f"{label} launches {launches}, plain levels {plain}, {paths}",
          flush=True)
    if (min(launches.values()) <= 0 or plain != 0
            or paths["enc.fused_chunks"] <= 0
            or paths["enc.host_entropy_frames"]
            or paths["dec.device_ht_chunks"] <= 0
            or paths["dec.host_ht_frames"]):
        raise AssertionError(f"the {label} did not run every level and "
                             "every HT stage through the kernels")
    return result, launches


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def main_path(tp, dev, label, frames, opts):
    """encode_batch then decode_batch of frames on dev; a lossless decode
    must give the frames back.  Returns (streams, decoded)."""
    streams = tp.encode_batch(frames, opts, device=dev)
    decoded = tp.decode_batch(streams, device=dev)
    for d, f in zip(decoded, frames):
        if d.shape != f.shape or d.dtype != f.dtype:
            raise AssertionError(f"{label}: decoded {d.shape} {d.dtype}, "
                                 f"expected {f.shape} {f.dtype}")
        if opts.lossless and not np.array_equal(d, f):
            raise AssertionError(f"{label}: round trip is not exact")
    quality = ("round-trip exact" if opts.lossless else
               f"PSNR {min(psnr(d, f) for d, f in zip(decoded, frames)):.3f}"
               f" dB (lowest frame)")
    print(f"main path {label}: {len(frames)} frames {frames[0].shape}, "
          f"{sum(map(len, streams))} bytes, {quality}", flush=True)
    return streams, decoded


def main_paths(tp):
    """(label, frames, options, DWT library) of the four main paths."""
    lossless = tp.Options(format=tp.Format.J2K, lossless=True,
                          num_resolutions=6, high_throughput=True)
    lossy = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                       num_resolutions=6, high_throughput=True)
    rgb = [np.stack([natural_image(H, W, seed=100 + 3 * i + c)
                     for c in range(3)], axis=-1) for i in range(N_RGB)]
    gray = [natural_image(H, W, seed=200 + i) for i in range(N_LOSSY_GRAY)]
    return [("gray", main_gray(), lossless, "dwt53"),
            ("rgb", rgb, lossless, "dwt53"),
            ("lossy gray", gray, lossy, "dwt97"),
            ("lossy rgb", lossy_rgb(), lossy, "dwt97")]


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


def ebcot_opts(tp, backend="device"):
    """The JAX bench's ebcot53_512 options (bench.py:316-327)."""
    return tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=6,
                      high_throughput=False, backend=backend)


def ebcot_gray():
    return [natural_image(H, W, seed=500 + i) for i in range(N_EBCOT_GRAY)]


def ebcot_rgb():
    return [np.stack([natural_image(H, W, seed=600 + 3 * i + c)
                      for c in range(3)], axis=-1)
            for i in range(N_EBCOT_RGB)]


def ebcot_cases(tp):
    """The EBCOT kernels' cases: (name, frames), the main gray batch first
    (the one timed)."""
    rng = np.random.RandomState(7)
    return [
        ("gray", ebcot_gray()),
        ("rgb16", [rng.randint(0, 1 << 16, (256, 256, 3)).astype(np.uint16)
                   for _ in range(2)]),
        ("noise", [rng.randint(0, 256, (H, W)).astype(np.uint8)
                   for _ in range(4)]),
        ("zeros", [np.zeros((256, 256), np.uint8)] * 2),
        ("ragged", [natural_image(96, 80, seed=700 + i) for i in range(4)]),
    ]


def ebcot_inputs(tp, frames, dev):
    """(plan, planes, the decision kernel's inputs) of the frames' Part-1
    block batch, made on the card by the main path's own steps."""
    from go_jpeg2000_tpu_torch.models import (ebcot_fused, encoder,
                                              transforms)
    from go_jpeg2000_tpu_torch.ops import dwt, ht_enc_cuda
    from go_jpeg2000_tpu_torch.tcd import geometry as geo
    opts = ebcot_opts(tp)
    header = encoder.build_header(frames[0], opts)
    prec = header.components[0].precision
    encoder._apply_comp_quants(header, opts, header.num_components, prec)
    plan = ebcot_fused.plan_for(header, geo.build_tile(header, 0))
    if plan is None:
        raise AssertionError("the device EBCOT encode refused the frames")
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    levels = header.coding_style.num_decompositions
    pyr = transforms.forward_pyramid(
        transforms.upload(batch, dev), levels, dwt.REV53,
        bool(header.coding_style.mct) and batch.shape[1] >= 3, prec, False,
        0, 0)
    blocks = ht_enc_cuda.extract_blocks(pyr, plan, len(frames), levels)
    return plan, ebcot_fused.max_planes(plan), ebcot_fused.block_inputs(
        blocks, plan, len(frames))


def split_pool(pool, lens):
    """Host bytes of each row of a pool cut by lens."""
    n = lens.cpu().numpy().astype(np.int64)
    ends = np.cumsum(n)
    data = pool.cpu().numpy()
    return [data[e - k:e].tobytes() for e, k in zip(ends, n)]


def strip_ff(seg):
    return seg[:-1] if seg.endswith(b"\xff") else seg


def ebcot_case(tp, frames, dev):
    """The EBCOT kernels and their plain versions on one frame batch: each
    plain stage takes the plain output of the stage before.  Returns (max
    |diff| per kernel, number of blocks held against the plain lockstep
    chain, inputs for timing)."""
    from go_jpeg2000_tpu_torch.native import loader
    from go_jpeg2000_tpu_torch.ops import (ebcot_cuda as K, ebcot_device,
                                           mq_device)
    plan, planes, (mags, signs, classes, valid) = ebcot_inputs(tp, frames,
                                                               dev)
    err = {}
    slots = ebcot_device.decision_slots(mags, signs, classes, valid, planes)
    got = K.decision_slots(mags, signs, classes, valid, planes)
    err["ebcot_decision_slots"] = int((got != slots).sum().item())
    pool, ndec, off, largest = K.compact_rows_plain(slots)
    kp, kn, ko, kl = K.compact_rows(slots)
    err["ebcot_compact_rows"] = max(
        int((kn != ndec).sum().item()), int((ko != off).sum().item()),
        abs(kl - largest), abs(kp.numel() - pool.numel()),
        int((kp != pool).sum().item()) if kp.numel() == pool.numel() else 1)
    rows, lens = K.mq_encode(pool, ndec, off, largest)
    segs, total = K.pool_rows(rows, off, lens)
    psegs, ptotal = K.pool_rows_plain(rows, off, lens)
    used = int(ptotal.item())
    err["ebcot_pool_rows"] = max(abs(int(total.item()) - used), int(
        (segs[:used] != psegs[:used]).sum().item()))
    # the MQ coder: every block against the native coder, and the blocks
    # of a subset against the plain lockstep chain (tens of ops a step)
    mine = [strip_ff(x) for x in split_pool(segs[:used], lens)]
    streams = split_pool(pool, ndec)
    native = loader.mq_encode_streams(streams)
    counts = ndec.cpu().numpy()
    pick = [int(i) for i in np.argsort(np.where(counts <= 3000, counts, -1))
            [-4:] if counts[i] > 0]
    sub = mq_device.encode_streams([streams[i] for i in pick])
    err["ebcot_mq_encode"] = sum(a != b for a, b in zip(mine, native)) + sum(
        mine[i] != x for i, x in zip(pick, sub))
    torch.cuda.synchronize()
    inputs = dict(plan=plan, planes=planes, mags=mags, signs=signs,
                  classes=classes, valid=valid, slots=slots, pool=pool,
                  ndec=ndec, off=off, largest=largest, rows=rows, lens=lens,
                  used=used, nb=mags.shape[0])
    return err, len(pick), inputs


def row_segments(rows, off, lens):
    """Host bytes of each block's segment in the MQ row buffer (block b's
    row at 3 * off[b] + 3 * b), trailing 0xFF stripped."""
    data = rows.cpu().numpy()
    starts = 3 * off.cpu().numpy() + 3 * np.arange(off.numel())
    return [strip_ff(data[s:s + n].tobytes())
            for s, n in zip(starts, lens.cpu().numpy())]


def check_decision_stress(dev):
    """The decision kernel on ebcot_device.stress_blocks (an SPP chain
    snaking through 64x64 blocks, stripe-long chains with a ragged mask,
    one live plane under eleven empty ones, 29 planes of magnitudes up to
    2^29 - 1) against the plain version on the card: the slots equal;
    raises otherwise.  Returns the differing slots (0)."""
    from go_jpeg2000_tpu_torch.ops import ebcot_cuda as K, ebcot_device
    for name, arrays in ebcot_device.stress_blocks().items():
        mags, signs, classes, valid, planes = (
            torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
            for a in arrays)
        got = K.decision_slots(mags, signs, classes, valid, planes)
        ref = ebcot_device.decision_slots(mags, signs, classes, valid,
                                          planes)
        bad = int((got != ref).sum().item())
        print(f"kernel check ebcot_decision_slots stress {name} "
              f"({mags.shape[0]} blocks of {mags.shape[1]}x{mags.shape[2]}, "
              f"{planes} planes): differing slots {bad} of {ref.numel()}",
              flush=True)
        if bad:
            raise AssertionError(f"ebcot_decision_slots disagrees with its "
                                 f"plain version on the stress blocks "
                                 f"{name}")
    return 0


def check_mq_stress(dev):
    """The MQ kernel on ops/mq_device.stress_streams for three seeds, the
    pool's base 0, 5 and 11 bytes past a 16-byte boundary: segments equal
    to the native coder's on every stream, and to the plain lockstep
    chain's (on the card) on every stream of at most four staging chunks;
    raises on any difference."""
    from go_jpeg2000_tpu_torch.native import loader
    from go_jpeg2000_tpu_torch.ops import ebcot_cuda as K, mq_device
    for seed, base in ((0, 0), (1, 5), (2, 11)):
        streams = mq_device.stress_streams(K.MQ_CHUNK, seed)
        pool, ndec, off, largest = mq_device.pool_of(streams, dev, base)
        rows, lens = K.mq_encode(pool, ndec, off, largest)
        mine = row_segments(rows, off, lens)
        native = loader.mq_encode_streams(streams)
        bad_native = sum(a != b for a, b in zip(mine, native))
        short = [i for i, x in enumerate(streams)
                 if len(x) <= 4 * K.MQ_CHUNK]
        sp, sn, so, sl = mq_device.pool_of([streams[i] for i in short], dev)
        prows, plens = K.mq_encode_plain(sp, sn, so, sl)
        plain = row_segments(prows, so, plens)
        bad_plain = sum(mine[i] != x for i, x in zip(short, plain))
        print(f"kernel check MQ stress streams seed {seed} (pool base "
              f"+{base} bytes, {len(streams)} streams of "
              f"{[len(x) for x in streams]} decisions, chunk {K.MQ_CHUNK}): "
              f"segments differing from native {bad_native} of "
              f"{len(streams)}, from the plain chain {bad_plain} of "
              f"{len(short)}", flush=True)
        if bad_native or bad_plain:
            raise AssertionError("ebcot_mq_encode disagrees on the stress "
                                 f"streams of seed {seed}")


def check_compact_stress(dev):
    """The compaction kernels on ebcot_cuda.compact_stress_slots with the
    slots 0 and 5 bytes past a 16-byte boundary: pool, counts, offsets and
    largest count equal compact_rows_plain's; raises otherwise.  Returns
    the largest number of differing entries (0)."""
    from go_jpeg2000_tpu_torch.ops import ebcot_cuda as K
    for name, host in K.compact_stress_slots().items():
        for base in (0, 5):
            buf = torch.empty(host.size + 16, dtype=torch.uint8, device=dev)
            slots = buf[base:base + host.size].view(host.shape)
            slots.copy_(torch.from_numpy(host))
            got = K.compact_rows(slots)
            ref = K.compact_rows_plain(slots)
            bad = max([abs(got[3] - ref[3])] + [
                int((a != b).sum().item()) if a.shape == b.shape else
                max(a.numel(), b.numel()) for a, b in zip(got[:3], ref[:3])])
            print(f"kernel check ebcot_compact_rows stress {name} "
                  f"({host.shape[0]} rows of {host.shape[1]} slots, base "
                  f"+{base}, chunk {K.COMPACT_CHUNK}, {ref[0].numel()} "
                  f"decisions): differing entries {bad}", flush=True)
            if bad:
                raise AssertionError("ebcot_compact_rows disagrees with its "
                                     f"plain version on {name}")
    return 0


def check_segment_pool_stress(dev):
    """The segment-pool kernel on ebcot_cuda.pool_stress_rows with the row
    buffer 0 and 5 bytes past a 16-byte boundary: pool prefix and total
    against pool_rows_plain.  Returns the count of differing bytes (raises
    on any)."""
    from go_jpeg2000_tpu_torch.ops import ebcot_cuda as K
    for name, (ndec, lens, rows) in K.pool_stress_rows().items():
        for base in (0, 5):
            buf = torch.empty(rows.size + 16, dtype=torch.uint8, device=dev)
            rows_t = buf[base:base + rows.size]
            rows_t.copy_(torch.from_numpy(rows))
            off = torch.from_numpy(np.cumsum(ndec.astype(np.int64))
                                   - ndec).to(dev)
            lens_t = torch.from_numpy(lens).to(dev)
            pool, total = K.pool_rows(rows_t, off, lens_t)
            want, wtot = K.pool_rows_plain(rows_t, off, lens_t)
            used = int(wtot.item())
            bad = abs(int(total.item()) - used) + int(
                (pool[:used] != want[:used]).sum().item())
            print(f"kernel check ebcot_pool_rows stress {name} (rows base "
                  f"+{base} bytes, {lens.size} rows, {used} bytes): "
                  f"differing {bad}", flush=True)
            if bad:
                raise AssertionError(f"ebcot_pool_rows disagrees on the "
                                     f"stress rows {name}")
    return 0


def check_ebcot_kernels(tp, dev, card):
    """Phase 8: every EBCOT kernel against its plain version on the main
    gray batch and on 16-bit RGB, noise, all-zero and ragged frames, the
    decision kernel also on ebcot_device.stress_blocks; times and bounds
    on the main gray batch (the plain lockstep MQ chain once, on every
    block)."""
    from go_jpeg2000_tpu_torch.ops import ebcot_cuda as K, ebcot_device
    err = {k: 0 for k in EBCOT_KERNELS}
    err["ebcot_decision_slots"] = check_decision_stress(dev)
    err["ebcot_compact_rows"] = check_compact_stress(dev)
    err["ebcot_pool_rows"] = check_segment_pool_stress(dev)
    timing = None
    for name, frames in ebcot_cases(tp):
        label = f"{name} {len(frames)}x{'x'.join(map(str, frames[0].shape))}"
        e, n_sub, inputs = ebcot_case(tp, frames, dev)
        print(f"kernel check EBCOT {label} ({inputs['nb']} blocks, "
              f"{inputs['planes']} planes, {int(inputs['ndec'].sum())} "
              f"decisions, {inputs['used']} segment bytes): differing "
              f"entries {e} (MQ against native on every block, against the "
              f"plain chain on {n_sub})", flush=True)
        if any(e.values()):
            raise AssertionError(f"{label}: an EBCOT kernel disagrees with "
                                 "its plain version")
        for k in err:
            err[k] = max(err[k], e[k])
        if timing is None:
            timing = inputs
    check_mq_stress(dev)

    t = timing
    mags, signs, classes, valid = (t["mags"], t["signs"], t["classes"],
                                   t["valid"])
    planes, slots, pool = t["planes"], t["slots"], t["pool"]
    ndec, off, largest, rows, lens = (t["ndec"], t["off"], t["largest"],
                                      t["rows"], t["lens"])
    nb, used = t["nb"], t["used"]
    decisions = pool.numel()
    kernel_fns = {
        "ebcot_decision_slots": lambda: K.decision_slots(
            mags, signs, classes, valid, planes),
        "ebcot_compact_rows": lambda: K.compact_rows(slots),
        "ebcot_mq_encode": lambda: K.mq_encode(pool, ndec, off, largest),
        "ebcot_pool_rows": lambda: K.pool_rows(rows, off, lens)}
    times = {
        "ebcot_decision_slots": (
            cuda_ms(kernel_fns["ebcot_decision_slots"]),
            cuda_ms(lambda: ebcot_device.decision_slots(
                mags, signs, classes, valid, planes), reps=3, warmup=1),
            decision_bound(mags, valid, planes, slots)),
        "ebcot_compact_rows": (
            cuda_ms(kernel_fns["ebcot_compact_rows"]),
            cuda_ms(lambda: K.compact_rows_plain(slots), reps=3, warmup=1),
            compact_bound(slots, decisions)),
        "ebcot_mq_encode": (
            cuda_ms(kernel_fns["ebcot_mq_encode"]),
            cuda_ms(lambda: K.mq_encode_plain(pool, ndec, off, largest),
                    reps=1, warmup=0),
            # reads the decisions, counts and offsets; writes the segments
            # and their lengths
            bound(decisions + 12 * nb + used + 4 * nb,
                  OPS_PER_ELEMENT["ebcot_mq_encode"] * decisions,
                  INT32_OPS_PER_S)),
        "ebcot_pool_rows": (
            cuda_ms(kernel_fns["ebcot_pool_rows"]),
            cuda_ms(lambda: K.pool_rows_plain(rows, off, lens), reps=5),
            # reads each segment byte and the lengths and offsets once,
            # writes the pool
            bound(2 * used + 12 * nb,
                  OPS_PER_ELEMENT["ebcot_pool_rows"] * used,
                  INT32_OPS_PER_S)),
    }
    serial_ms = (largest * MQ_DEPENDENT_CYCLES / SM_CLOCK_HZ * 1e3)
    for name, (ms, plain_ms, (bound_ms, by)) in times.items():
        time_line(name, ms, plain_ms, bound_ms, by,
                  device_ms(kernel_fns[name]),
                  f"{nb} blocks of 64x64, {planes} planes, {decisions} "
                  f"decisions, {used} segment bytes", card)
    # one library call that computes the decision pool: masked_select with
    # the mask made beforehand (it also reads the pool's size back)
    mask = slots != ebcot_device.EMPTY
    library = {"ebcot_compact_rows": cuda_ms(
        lambda: torch.masked_select(slots, mask))}
    print(f"time ebcot_compact_rows: library call torch.masked_select "
          f"(mask made beforehand) {library['ebcot_compact_rows']:.4f} ms, "
          f"kernel {times['ebcot_compact_rows'][0]:.4f} ms (both by CUDA "
          f"events, both read a size back) [{card}]", flush=True)
    del mask
    # the segment pool: masked_select of the row buffer with the mask of
    # the segments' bytes made beforehand
    seg_mask = torch.zeros(rows.numel(), dtype=torch.bool, device=rows.device)
    starts = 3 * off + 3 * torch.arange(nb, device=off.device)
    cols = torch.arange(int(lens.max().item()), device=off.device)
    inside = cols[None, :] < lens.long()[:, None]
    seg_mask[(starts[:, None] + cols[None, :])[inside]] = True
    lib_pool = torch.masked_select(rows, seg_mask)
    if not torch.equal(lib_pool, K.pool_rows(rows, off, lens)[0][:used]):
        raise AssertionError("masked_select's segment pool differs")
    library["ebcot_pool_rows"] = cuda_ms(
        lambda: torch.masked_select(rows, seg_mask))
    print(f"time ebcot_pool_rows: library call torch.masked_select (mask "
          f"made beforehand) {library['ebcot_pool_rows']:.4f} ms, kernel "
          f"{times['ebcot_pool_rows'][0]:.4f} ms (both by CUDA events; the "
          f"library call reads its size back) [{card}]", flush=True)
    del seg_mask, lib_pool, inside
    print(f"time ebcot_mq_encode: serial bound {serial_ms:.4f} ms (the "
          f"longest block's {largest} decisions x {MQ_DEPENDENT_CYCLES} "
          f"dependent cycles at {SM_CLOCK_HZ / 1e9:.2f} GHz), "
          f"{100 * serial_ms / times['ebcot_mq_encode'][0]:.1f}% of it "
          f"reached [{card}]", flush=True)
    # by CUDA events: a launch of milliseconds hides the wrapper's host
    # time
    mq_ms = times["ebcot_mq_encode"][0]
    print(f"time ebcot_mq_encode: "
          f"{mq_ms * 1e-3 * SM_CLOCK_HZ / largest:.1f} cycles a decision of "
          f"the longest block ({mq_ms:.4f} ms by CUDA events over {largest} "
          f"decisions at {SM_CLOCK_HZ / 1e9:.2f} GHz), against the serial "
          f"bound's {MQ_DEPENDENT_CYCLES} [{card}]", flush=True)
    return (err, {k: (a, b) + c for k, (a, b, c) in times.items()},
            library)


def decision_bound(mags, valid, planes, slots):
    """ebcot_decision_slots' bound: it reads mags, signs and the mask and
    writes every slot; OPS_PER_ELEMENT operations per sample of each plane
    at or below its block's bit count (the planes this run's data codes)."""
    from go_jpeg2000_tpu_torch.models import ebcot_fused
    nb = mags.shape[0]
    live = int(ebcot_fused.numbps(mags, valid, planes).sum().item()) \
        * (mags.numel() // nb)
    return bound(9 * mags.numel() + 4 * nb + slots.numel(),
                 OPS_PER_ELEMENT["ebcot_decision_slots"] * live,
                 INT32_OPS_PER_S)


def compact_bound(slots, decisions):
    """ebcot_compact_rows' bound: it reads the slots and writes the
    decisions, counts and offsets."""
    return bound(slots.numel() + decisions + 12 * slots.shape[0],
                 OPS_PER_ELEMENT["ebcot_compact_rows"] * slots.numel(),
                 INT32_OPS_PER_S)


def ebcot_counted_run(tp, kernels, run, label):
    """Run one Part-1 main path (path A) with every count set to 0 just
    before it; check that the encode went through the device EBCOT encode,
    its four kernels, block extraction and the 5/3 kernels with no plain
    level, and the decode through the EBCOT branch and the assembly
    kernel, and the head and tail through the colour kernels.  Returns
    (result, launches of those kernels)."""
    from go_jpeg2000_tpu_torch.ops import mct_cuda
    dwt_cuda, ht_enc_cuda, ht_dec_cuda, ebcot_cuda = kernels
    reset_all_counts(tp)
    result = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in dwt_cuda.LAUNCHES.items()
                if k.startswith("dwt53")}
    launches["ht_extract_blocks"] = ht_enc_cuda.LAUNCHES["ht_extract_blocks"]
    launches["ht_blocks_to_pyramid"] = \
        ht_dec_cuda.LAUNCHES["ht_blocks_to_pyramid"]
    launches.update(ebcot_cuda.LAUNCHES)
    launches.update(mct_cuda.LAUNCHES)
    snap = tp.counters.snapshot()
    paths = {k: snap.get(k, 0) for k in (
        "enc.ebcot_device_chunks", "enc.ebcot_hybrid_chunks",
        "enc.host_entropy_frames", "dec.ebcot_frames",
        "dec.device_ht_chunks")}
    plain = dwt_cuda.PLAIN_LEVELS
    print(f"{label} launches {launches}, plain levels {plain}, {paths}",
          flush=True)
    if (min(launches.values()) <= 0 or plain != 0
            or paths["enc.ebcot_device_chunks"] <= 0
            or paths["enc.ebcot_hybrid_chunks"]
            or paths["enc.host_entropy_frames"]
            or paths["dec.ebcot_frames"] <= 0
            or paths["dec.device_ht_chunks"]):
        raise AssertionError(f"the {label} did not run every level and "
                             "every EBCOT stage through the kernels")
    return result, launches


def ebcot_other_paths(tp, frames, streams, dev, label):
    """Paths B and C on the same frames must give path A's bytes, each
    through its own branch."""
    for backend, counter in (("hybrid", "enc.ebcot_hybrid_chunks"),
                             ("native", "enc.host_entropy_frames")):
        tp.counters.reset()
        got = tp.encode_batch(frames, ebcot_opts(tp, backend), device=dev)
        if tp.counters.snapshot().get(counter, 0) <= 0:
            raise AssertionError(f"{label}: backend {backend} did not take "
                                 "its branch")
        if got != streams:
            raise AssertionError(f"{label}: backend {backend} bytes differ "
                                 "from path A")
    print(f"{label}: paths A, B and C codestreams byte-identical",
          flush=True)


def ebcot_stages(tp, frames, streams, dev, card, reps=3):
    """Path A encode in its stages (device program, fetch, host results and
    Python Tier-2) and a decode in its stages (host Tier-2 and native T1,
    upload, device program, download), medians of reps, with peak device
    bytes per sample; then the device idle share of one encode and one
    decode."""
    from go_jpeg2000_tpu_torch.models import (decoder, ebcot_fused, encoder,
                                              transforms)
    from go_jpeg2000_tpu_torch.ops import ht_dec_cuda
    from go_jpeg2000_tpu_torch.tcd import geometry as geo
    opts = ebcot_opts(tp)
    header = encoder.build_header(frames[0], opts)
    prec = header.components[0].precision
    n_comps = header.num_components
    encoder._apply_comp_quants(header, opts, n_comps, prec)
    tile = geo.build_tile(header, 0)
    plan = ebcot_fused.plan_for(header, tile)
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    levels = header.coding_style.num_decompositions
    use_mct = bool(header.coding_style.mct) and n_comps >= 3
    n, samples = len(frames), batch.size
    enc, dec = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = ebcot_fused.ebcot_encode_chunk(batch, plan, levels, use_mct,
                                             prec, False, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fetched = ebcot_fused.fetch(out)
        t2 = time.perf_counter()
        results = [ebcot_fused._single_segment_result(s, int(b), float(x))
                   for s, b, x in zip(ebcot_fused._split(fetched[0],
                                                         fetched[1]),
                                      fetched[2], fetched[3])]
        for i in range(n):
            es, js = encoder._walk_geometry(tile)
            encoder._assemble_packets(header, tile, es, js,
                                      results[i * plan.nb:(i + 1) * plan.nb],
                                      0, opts)
        t3 = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated() - base) / samples
        enc.append((t1 - t0, t2 - t1, t3 - t2, peak))
        del out
        batch_d = decode_batch_of(streams)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        slots = decoder.ebcot_slots(batch_d, batch_d.bodies)
        t1 = time.perf_counter()
        sl = torch.from_numpy(slots).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pix = transforms.inverse_pyramid(
            ht_dec_cuda.blocks_to_pyramid(sl, batch_d.plan, n, n_comps,
                                          batch_d.nl),
            batch_d.kind, batch_d.use_mct, prec, False, 0, 0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pix.cpu()
        t4 = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated() - base) / samples
        dec.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, peak, slots.nbytes))
    e = [float(np.median([x[i] for x in enc])) for i in range(4)]
    d = [float(np.median([x[i] for x in dec])) for i in range(5)]
    shape = frames[0].shape
    print(f"EBCOT encode stages path A {n}x{shape} (median of {reps}): "
          f"device program {e[0] * 1e3:.2f} ms, fetch {e[1] * 1e3:.2f} ms, "
          f"results and Python Tier-2 {e[2] * 1e3:.2f} ms; peak device "
          f"memory {e[3]:.1f} bytes/sample [{card}]", flush=True)
    print(f"EBCOT decode stages {n}x{shape} (median of {reps}): Python "
          f"Tier-2 and native T1 {d[0] * 1e3:.2f} ms, upload of "
          f"{dec[0][5]} bytes {d[1] * 1e3:.2f} ms, device program "
          f"{d[2] * 1e3:.2f} ms, download {d[3] * 1e3:.2f} ms; peak device "
          f"memory {d[4]:.1f} bytes/sample [{card}]", flush=True)
    for what, fn in (
            ("encode", lambda: tp.encode_batch(frames, opts, device=dev)),
            ("decode", lambda: tp.decode_batch(streams, device=dev))):
        idle_line(f"EBCOT {n}x{shape} {what} (path A)", fn, dev, card)


def ebcot_wall(tp, frames, streams, dev, card, label):
    """Encode Mpix/s of paths A, B and C and decode Mpix/s, medians of 3
    after a warm-up."""
    mpix = len(frames) * frames[0].shape[0] * frames[0].shape[1] / 1e6
    parts = []
    for backend, path in (("device", "A"), ("hybrid", "B"), ("native", "C")):
        opts = ebcot_opts(tp, backend)
        tp.encode_batch(frames, opts, device=dev)
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            tp.encode_batch(frames, opts, device=dev)
            t.append(time.perf_counter() - t0)
        med = float(np.median(t))
        parts.append(f"encode path {path} ({backend}) {mpix / med:.2f} "
                     f"Mpix/s ({med * 1e3:.1f} ms)")
    t = []
    for _ in range(3):
        t0 = time.perf_counter()
        tp.decode_batch(streams, device=dev)
        t.append(time.perf_counter() - t0)
    med = float(np.median(t))
    parts.append(f"decode {mpix / med:.2f} Mpix/s ({med * 1e3:.1f} ms)")
    print(f"wall {label} {len(frames)}x{frames[0].shape} (median of "
          f"3): {', '.join(parts)} [{card}]", flush=True)


def config4_image(size, seed=1):
    """bench.py's sharded_config4 image at `size`: smooth 16-bit RGB
    noise."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << 16, size=(size, size, 3)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint16)


def config4_opts(tp, lossless, **kw):
    """BASELINE config 4's options: J2K, HTJ2K, 5 resolutions, 512x512
    tiles; quality 85 when lossy."""
    kw.setdefault("high_throughput", True)
    return tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      num_resolutions=C4_RES, tile_size=(C4_TILE, C4_TILE),
                      **kw)


def check_halo_kernels(dwt, dwt_cuda, psh, dev, card):
    """Phase 10a: the four level kernels in their halo form on sp = 2 and 4
    row shards of the config-4 level-1 batch [768, 512, 512], and on
    batches whose shards have 2 rows, each shard on the edges the packing
    kernel writes into its slot (as the gather would give them), against
    the unsharded kernels bit for bit, and the packing kernel against its
    plain version on every shard; the halo form's time at sp = 2 and 4 by
    events and alone beside the unsharded kernel's and the bound, and the
    packing kernel's on one shard of the sp = 4 split.  Returns (errors,
    the packing kernel's times, its library call's ms)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    err, times, alone, halo = {}, {}, {}, {}
    n = 3 * (C4_SIZE // C4_TILE) ** 2
    for kind in (dwt.REV53, dwt.IRR97):
        lib = "dwt53" if kind == dwt.REV53 else "dwt97"
        fwd = getattr(dwt_cuda, f"forward_2d_{kind}")
        inv = getattr(dwt_cuda, f"inverse_2d_{kind}")
        for shape, sps in (((n, C4_TILE, C4_TILE), (2, 4)),
                           ((n, 8, C4_TILE), (4,)), ((n, 4, C4_TILE), (2,))):
            x = torch.randint(-(1 << 17), 1 << 17, shape, generator=gen,
                              device=dev, dtype=torch.int32)
            if kind == dwt.IRR97:
                x = x.to(torch.float32) / 256
            ref = fwd(x)
            ref_inv = inv(ref)
            for sp in sps:
                shards = [t.contiguous() for t in torch.chunk(x, sp, dim=-2)]
                got = psh.forward_level_split(shards, kind)
                e_f = max((torch.cat([g[k] for g in got], dim=-2) - ref[k])
                          .abs().max().item() for k in ref)
                split = [{k: v.contiguous() for k, v in zip(ref, parts)}
                         for parts in zip(*(torch.chunk(b, sp, dim=-2)
                                            for b in ref.values()))]
                back = torch.cat(psh.inverse_level_split(split, kind), dim=-2)
                e_i = (back - ref_inv).abs().max().item()
                e_p = max(max_diff(dwt_cuda.pack_edges(src),
                                   dwt.pack_edges(src))
                          for src in shards + split)
                torch.cuda.synchronize()
                print(f"halo check {lib} {shape} sp={sp} (shards of "
                      f"{shape[1] // sp} rows): fwd max|diff| {e_f}, inv "
                      f"max|diff| {e_i} against the unsharded kernels; "
                      f"dwt_pack_edges max|diff| {e_p} against its plain "
                      f"version", flush=True)
                if e_f or e_i or e_p:
                    raise AssertionError(f"{lib} halo kernels disagree with "
                                         f"the unsharded ones, or the "
                                         f"packing kernel with its plain "
                                         f"version, at {shape}, sp={sp}")
                for k, e in ((f"{lib}_fwd_level", e_f),
                             (f"{lib}_inv_level", e_i),
                             ("dwt_pack_edges", e_p)):
                    err[k] = max(err.get(k, 0), e)
                if shape[1] != C4_TILE:
                    continue
                halo[(lib, sp)] = tuple(
                    f(g, reps=5) for g in (
                        lambda: psh.forward_level_split(shards, kind),
                        lambda: psh.inverse_level_split(split, kind))
                    for f in (cuda_ms, device_ms))
                if sp == 4:
                    times[lib] = (
                        cuda_ms(lambda: fwd(x), reps=5),
                        cuda_ms(lambda: psh.forward_level_split(
                            shards, kind, dwt.forward_2d_halo,
                            dwt.pack_edges), reps=2, warmup=1),
                        cuda_ms(lambda: inv(ref), reps=5),
                        cuda_ms(lambda: psh.inverse_level_split(
                            split, kind, dwt.inverse_2d_halo,
                            dwt.pack_edges), reps=2, warmup=1),
                        # a level reads and writes each 4-byte sample once
                        bound(8 * x.numel(), 0, 1)[0])
                    alone[lib] = (
                        device_ms(lambda: fwd(x), reps=5),
                        device_ms(lambda: inv(ref), reps=5))
                    if kind == dwt.REV53:
                        pack = pack_times(dwt, dwt_cuda, shards[0], card)
            del x, ref, ref_inv
    for (lib, sp), (fe, fa, ie, ia) in halo.items():
        uf, _pf, ui, _pi, lim = times[lib]
        af, ai = alone[lib]
        print(f"time {lib} halo form, {sp} row shards of [{n},{C4_TILE},"
              f"{C4_TILE}] ({sp} packing launches, {sp} level launches): "
              f"forward ev {fe:.4f} ms, alone {fa:.4f} ms "
              f"({100 * lim / fa:.1f}% of the bound; unsharded kernel ev "
              f"{uf:.4f}, alone "
              f"{af:.4f}); inverse ev {ie:.4f} ms, alone {ia:.4f} ms "
              f"({100 * lim / ia:.1f}% of the bound; unsharded ev {ui:.4f}, "
              f"alone {ai:.4f}); bound {lim:.4f} ms (bytes) [{card}]",
              flush=True)
    for lib, (uf, pf, ui, pi, lim) in times.items():
        for name, ms, plain_ms, dev_ms in (
                (f"{lib}_fwd_level", uf, pf, alone[lib][0]),
                (f"{lib}_inv_level", ui, pi, alone[lib][1])):
            time_line(name, ms, plain_ms, lim, "bytes", dev_ms,
                      f"config-4 level 1, [{n},{C4_TILE},{C4_TILE}] "
                      "unsharded (plain: the halo lifting of 4 shards)",
                      card)
    torch.cuda.empty_cache()
    ms, plain_ms, lim, library_ms = pack
    return (err, {"dwt_pack_edges": (ms, plain_ms) + lim},
            {"dwt_pack_edges": library_ms})


def pack_times(dwt, dwt_cuda, rows, card):
    """The packing kernel on one row shard's slot: (ms by events, the plain
    version's ms, its bound, the ms of one torch index_select of the same
    rows)."""
    out = dwt_cuda.pack_edges(rows)
    idx = torch.tensor([r if r < out.shape[1] // 2
                        else r + rows.shape[1] - out.shape[1]
                        for r in range(out.shape[1])], device=rows.device)
    if not torch.equal(rows.index_select(1, idx), out):
        raise AssertionError("the library call packs other rows")
    # reads and writes each slot word once
    lim = bound(8 * out.numel(), 0, 1)
    ms = cuda_ms(lambda: dwt_cuda.pack_edges(rows))
    plain_ms = cuda_ms(lambda: dwt.pack_edges(rows))
    library_ms = cuda_ms(lambda: rows.index_select(1, idx))
    time_line("dwt_pack_edges", ms, plain_ms, lim[0], lim[1],
              device_ms(lambda: dwt_cuda.pack_edges(rows)),
              f"one shard {tuple(rows.shape)} -> its slot "
              f"{tuple(out.shape)}; torch index_select {library_ms:.4f} ms",
              card)
    return ms, plain_ms, lim, library_ms


def check_band_stats(band_stats, leaves, card):
    """Phase 10b: band_stats against its plain version on the config-4
    lossless pyramid (counts exact, sums within a relative 1e-5) and its
    time beside its bound."""
    sums, counts = band_stats.band_stats(leaves)
    ref_sums, ref_counts = band_stats.band_stats_plain(leaves)
    torch.cuda.synchronize()
    if not torch.equal(counts, ref_counts):
        raise AssertionError("band_stats counts disagree with the plain "
                             "version")
    diff = (sums - ref_sums).abs()
    rel = (diff / ref_sums.abs().clamp(min=1)).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"band_stats sums off by a relative {rel}")
    samples = sum(leaf.numel() for leaf in leaves)
    # reads each coefficient once, writes a sum and a count per leaf; a
    # float64 multiply-add and a compare per coefficient
    lim = bound(4 * samples + 16 * len(leaves), 3 * samples, FP64_OPS_PER_S)
    ms = cuda_ms(lambda: band_stats.band_stats(leaves))
    plain_ms = cuda_ms(lambda: band_stats.band_stats_plain(leaves), reps=3,
                       warmup=1)
    time_line("band_stats", ms, plain_ms, lim[0], lim[1],
              device_ms(lambda: band_stats.band_stats(leaves)),
              f"{len(leaves)} leaves, {samples} coefficients", card)
    print(f"kernel check band_stats ({len(leaves)} leaves): counts equal, "
          f"sums within a relative {rel:.3g} (max |diff| "
          f"{diff.max().item():.6g})", flush=True)
    return ({"band_stats": diff.max().item()},
            {"band_stats": (ms, plain_ms) + lim})


def sharded_counted_run(tp, kernels, run, label, dwt_lib, n_tiles):
    """Run one config-4 path with every count set to 0 just before it; the
    encode must take the device HT entropy and the decode the device HT
    decode for every tile, every level the DWT kernels of dwt_lib, and the
    band statistics their kernel, the head and tail the colour kernels.
    Returns (result, launches)."""
    from go_jpeg2000_tpu_torch.ops import mct_cuda
    dwt_cuda, ht_enc_cuda, ht_dec_cuda, band_stats = kernels
    reset_all_counts(tp)
    result = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in dwt_cuda.LAUNCHES.items()
                if k.startswith(dwt_lib)}
    for k in (ht_enc_cuda, ht_dec_cuda, band_stats, mct_cuda):
        launches.update(k.LAUNCHES)
    snap = tp.counters.snapshot()
    paths = {k: snap.get(k, 0) for k in (
        "enc.sharded_device_ht_tiles", "enc.sharded_host_entropy_tiles",
        "dec.sharded_device_ht_tiles")}
    plain = dwt_cuda.PLAIN_LEVELS
    print(f"{label} launches {launches}, plain levels {plain}, {paths}",
          flush=True)
    if (min(launches.values()) <= 0 or plain != 0
            or paths["enc.sharded_device_ht_tiles"] != n_tiles
            or paths["enc.sharded_host_entropy_tiles"]
            or paths["dec.sharded_device_ht_tiles"] != n_tiles):
        raise AssertionError(f"the {label} did not run every tile, level "
                             "and HT stage through the kernels")
    return result, launches


def sharded_path(tp, dev, label, img, opts):
    """encode_sharded then decode_sharded of img on dev (a grid of one);
    lossless must round-trip exactly.  Returns (codestream, decoded)."""
    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    data = encode_sharded(img, opts, device=dev)
    out = decode_sharded(data, device=dev)
    if out.shape != img.shape or out.dtype != img.dtype:
        raise AssertionError(f"{label}: decoded {out.shape} {out.dtype}")
    if opts.lossless and not np.array_equal(out, img):
        raise AssertionError(f"{label}: round trip is not exact")
    quality = ("round-trip exact" if opts.lossless else
               f"PSNR {psnr(out, img):.3f} dB")
    print(f"main path {label}: {img.shape} {img.dtype}, {len(data)} bytes "
          f"({img.nbytes / len(data):.2f}:1), {quality}", flush=True)
    return data, out


def class_encode(pyr, plan, sub, levels):
    """The HT kernels of one chunk of a tile-origin class, as the sharded
    encode calls them: (pool, totals)."""
    from go_jpeg2000_tpu_torch.models import fused_encode
    return fused_encode.encode_pyramid(pyr, plan, len(sub), levels,
                                       tiles=sub)


def sharded_encode_stages(img, opts, dev, encode=class_encode):
    """One config-4 encode in its stages, synchronised: (tile batch on the
    host, upload, transform step, HT kernels (`encode` of each chunk of
    each class), fetch and native Tier-2 s, codestream bytes of the tiles,
    peak device bytes per sample)."""
    from go_jpeg2000_tpu_torch.models import encoder, fused_encode, transforms
    from go_jpeg2000_tpu_torch.ops import dwt
    from go_jpeg2000_tpu_torch.parallel import sharded as psh
    header = encoder.build_header(img, opts)
    prec = header.components[0].precision
    comps = encoder._image_components(img)
    encoder._apply_comp_quants(header, opts, len(comps), prec)
    levels = header.coding_style.num_decompositions
    T, th, tw = psh._check_grid(header, levels, 1, "chip_smoke")
    tiles = list(range(T))
    kind = dwt.REV53 if opts.lossless else dwt.IRR97
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = psh.tile_batch(header, comps, tiles, th, 0)
    t1 = time.perf_counter()
    x = transforms.upload(batch, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    use_mct = bool(header.coding_style.mct) and len(comps) >= 3
    pyr, _stats = psh.tile_transform_step(x, levels, use_mct, prec, False,
                                          kind)
    del x
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dev_s = host_s = 0.0
    nbytes = 0
    per = psh.fused_chunk_tiles(len(comps), th, tw)
    for plan, rep, pos in psh.ht_plans(header, tiles):
        for s in range(0, len(pos), per):
            sub = pos[s:s + per]
            a = time.perf_counter()
            out, totals = encode(pyr, plan, sub, levels)
            torch.cuda.synchronize()
            b = time.perf_counter()
            bodies = fused_encode.fetch_bodies(out, totals, len(sub), plan,
                                               header, rep)
            del out
            dev_s += b - a
            host_s += time.perf_counter() - b
            nbytes += sum(map(len, bodies))
    peak = torch.cuda.max_memory_allocated() - base
    # least bytes of the device stages: the step reads the uploaded samples
    # and writes the leaves; the HT kernels read the leaves and write the
    # codestream's bytes
    leaf_bytes = sum(4 * v.numel() for e in pyr for v in e.values())
    bounds = (bound(batch.nbytes + leaf_bytes, 0, 1)[0],
              bound(leaf_bytes + nbytes, 0, 1)[0])
    return (t1 - t0, t2 - t1, t3 - t2, dev_s, host_s, nbytes,
            peak / batch.size, bounds)


def sharded_decode_stages(data, dev):
    """One config-4 decode in its stages, synchronised: (native parse,
    upload, MagSgn and assembly kernels with the scatter, inverse step,
    download s, peak device bytes per sample)."""
    from go_jpeg2000_tpu_torch.codestream.parser import Parser
    from go_jpeg2000_tpu_torch.models import decoder, fused_encode
    from go_jpeg2000_tpu_torch.ops import dwt
    from go_jpeg2000_tpu_torch.parallel import sharded as psh
    parser = Parser(data)
    header = parser.read_header()
    parts = {}
    for tp_ in parser.read_all_tile_parts(header):
        parts.setdefault(tp_.tile_index, []).append(tp_)
    cs = header.coding_style
    levels, n_comps = cs.num_decompositions, header.num_components
    lossy = cs.transform == 0
    prec = header.components[0].precision
    T, th, tw = psh._check_grid(header, levels, 1, "chip_smoke")
    tiles = list(range(T))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = psh.empty_leaves(T, n_comps, th, tw, levels, lossy, dev)
    parse_s = up_s = dev_s = 0.0
    parsed_bytes = 0
    per = psh.decode_chunk_tiles(n_comps, th, tw)
    for plan, rep, pos in psh.ht_plans(header, tiles):
        geom = fused_encode.t2_geom(header, rep, plan)
        for s in range(0, len(pos), per):
            sub = pos[s:s + per]
            a = time.perf_counter()
            parsed = psh.parse_tiles(header, parts, data, plan, geom,
                                     [tiles[i] for i in sub])
            b = time.perf_counter()
            parsed_bytes += sum(a_.nbytes for a_ in parsed)
            up = decoder.upload_parsed(*parsed, dev)
            torch.cuda.synchronize()
            c = time.perf_counter()
            psh.place_tiles(leaves, up, plan, sub, n_comps, levels, lossy)
            del up
            torch.cuda.synchronize()
            parse_s += b - a
            up_s += c - b
            dev_s += time.perf_counter() - c
    leaf_bytes = sum(4 * v.numel() for e in leaves for v in e.values())
    a = time.perf_counter()
    pix = psh.tile_inverse_step(leaves, bool(cs.mct) and n_comps >= 3, prec,
                                False, dwt.IRR97 if lossy else dwt.REV53)
    del leaves
    torch.cuda.synchronize()
    b = time.perf_counter()
    pix.cpu()
    c = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    # least bytes: the kernels read the parse and write the leaves; the
    # inverse step reads the leaves and writes the pixels
    bounds = (bound(parsed_bytes + leaf_bytes, 0, 1)[0],
              bound(leaf_bytes + pix.numel() * pix.element_size(), 0, 1)[0])
    return (parse_s, up_s, dev_s, b - a, c - b, peak / pix.numel(), bounds)


def sharded_timing(tp, label, img, opts, data, dev, card, reps=3):
    """Wall Mpix/s of encode_sharded and decode_sharded, the stages of
    each (medians of reps) and the device idle share of one of each."""
    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    mpix = img.shape[0] * img.shape[1] / 1e6
    enc_s, dec_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        encode_sharded(img, opts, device=dev)
        t1 = time.perf_counter()
        decode_sharded(data, device=dev)
        enc_s.append(t1 - t0)
        dec_s.append(time.perf_counter() - t1)
    enc, dec = float(np.median(enc_s)), float(np.median(dec_s))
    print(f"wall {label} {img.shape} (median of {reps}): encode "
          f"{mpix / enc:.2f} Mpix/s ({enc * 1e3:.1f} ms), decode "
          f"{mpix / dec:.2f} Mpix/s ({dec * 1e3:.1f} ms) [{card}]",
          flush=True)
    st = [sharded_encode_stages(img, opts, dev) for _ in range(reps)]
    e = [float(np.median([x[i] for x in st])) * 1e3 for i in range(5)]
    print(f"encode stages {label} (median of {reps}): tile batch on the host "
          f"{e[0]:.2f} ms, upload {e[1]:.2f} ms, transform step (DWT "
          f"kernels, band_stats) {e[2]:.2f} ms, HT kernels {e[3]:.2f} ms, "
          f"fetch and native Tier-2 {e[4]:.2f} ms, {st[0][5]} tile bytes; "
          f"peak device memory {st[0][6]:.1f} bytes/sample; bounds: "
          f"transform step {st[0][7][0]:.4f} ms, HT kernels "
          f"{st[0][7][1]:.4f} ms (bytes) [{card}]", flush=True)
    st = [sharded_decode_stages(data, dev) for _ in range(reps)]
    d = [float(np.median([x[i] for x in st])) * 1e3 for i in range(5)]
    print(f"decode stages {label} (median of {reps}): native parse "
          f"{d[0]:.2f} ms, upload {d[1]:.2f} ms, MagSgn and assembly "
          f"kernels {d[2]:.2f} ms, inverse step {d[3]:.2f} ms, download "
          f"{d[4]:.2f} ms; peak device memory {st[0][5]:.1f} bytes/sample; "
          f"bounds: MagSgn and assembly {st[0][6][0]:.4f} ms, inverse step "
          f"{st[0][6][1]:.4f} ms (bytes) [{card}]", flush=True)
    for what, fn in (
            ("encode", lambda: encode_sharded(img, opts, device=dev)),
            ("decode", lambda: decode_sharded(data, device=dev))):
        idle_line(f"{label} {what}", fn, dev, card)


def sharded_cpu_checks(tp, dev):
    """Phase 10e: at C4_CHECK^2 (16 tiles, all four tile-origin classes)
    the card's codestreams equal the port's CPU run for HT lossless, HT
    lossy (and the decodes) and Part-1 with two layers and a 6:1 budget
    (the distributed PCRD's path)."""
    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    img = config4_image(C4_CHECK, seed=2)
    cases = [("HT lossless", img, config4_opts(tp, True)),
             ("HT lossy", (img >> 8).astype(np.uint8),
              config4_opts(tp, False)),
             ("Part-1 2 layers 6:1", img,
              config4_opts(tp, True, high_throughput=False, num_layers=2,
                           compression_ratio=6.0))]
    for label, im, opts in cases:
        t0 = time.perf_counter()
        on_card = encode_sharded(im, opts, device=dev)
        t1 = time.perf_counter()
        on_cpu = encode_sharded(im, opts, device="cpu")
        t2 = time.perf_counter()
        if on_card != on_cpu:
            raise AssertionError(f"sharded {label}: CUDA and CPU codestreams "
                                 "differ")
        what = "codestreams byte-identical"
        if opts.high_throughput:
            if not np.array_equal(decode_sharded(on_card, device=dev),
                                  decode_sharded(on_card, device="cpu")):
                raise AssertionError(f"sharded {label}: CUDA and CPU decodes "
                                     "differ")
            what += ", decodes equal"
        print(f"sharded {label} {im.shape}: CUDA and CPU {what} "
              f"({len(on_card)} bytes; card encode {t1 - t0:.1f} s, "
              f"CPU encode {t2 - t1:.1f} s)", flush=True)


def sharded_phase(tp, dev, card, launches):
    """Phase 10: config 4 at full width on a grid of one.  Returns (kernel
    errors, kernel times, library ms, (the lossless image, its
    codestream), phase 19's references: {label: sha256 of the codestream
    and of the decode})."""
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.ops import (band_stats, dwt, dwt_cuda,
                                           ht_dec_cuda, ht_enc_cuda)
    from go_jpeg2000_tpu_torch.parallel import sharded as psh
    err, times, library = check_halo_kernels(dwt, dwt_cuda, psh, dev, card)
    t0 = time.perf_counter()
    img = config4_image(C4_SIZE)
    img8 = (img >> 8).astype(np.uint8)
    print(f"config-4 images made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kernels = (dwt_cuda, ht_enc_cuda, ht_dec_cuda, band_stats)
    n_tiles = (C4_SIZE // C4_TILE) ** 2
    runs, refs = {}, {}
    for label, im, opts, lib in (
            ("config-4 lossless", img, config4_opts(tp, True), "dwt53"),
            ("config-4 lossy", img8, config4_opts(tp, False), "dwt97")):
        (data, out), counts = sharded_counted_run(
            tp, kernels, lambda: sharded_path(tp, dev, label, im, opts),
            f"{label} main path", lib, n_tiles)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        runs[label] = (im, opts, data)
        refs[label] = (sha256(data), sha256(out))
    # band_stats on the lossless pyramid of the main path's tile batch
    from go_jpeg2000_tpu_torch.models import encoder
    header = encoder.build_header(img, runs["config-4 lossless"][1])
    comps = encoder._image_components(img)
    x = transforms.upload(psh.tile_batch(header, comps, range(n_tiles),
                                         C4_TILE, 0), dev)
    pyr, _stats = psh.tile_transform_step(x, C4_RES - 1, True, 16, False,
                                          dwt.REV53)
    del x
    e, t = check_band_stats(band_stats, band_stats.leaves_of(pyr), card)
    err.update(e)
    times.update(t)
    del pyr
    torch.cuda.empty_cache()
    for label, (im, opts, data) in runs.items():
        sharded_timing(tp, label, im, opts, data, dev, card)
    lossless = (img, runs["config-4 lossless"][2])
    del img8, runs
    sharded_cpu_checks(tp, dev)
    return err, times, library, lossless, refs


def sha256(a) -> str:
    """The SHA-256 of a codestream's bytes or of an array's samples."""
    return hashlib.sha256(a if isinstance(a, bytes)
                          else np.ascontiguousarray(a).tobytes()).hexdigest()


def natural_image_bits(h, w, bits, seed=0):
    """Smooth noise of `bits`-bit samples, uint16."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << bits, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint16)


def single_image_cases(tp):
    """(label, image, options, DWT library whose kernels must take every
    level) of the single-image phase."""
    rgb = np.stack([natural_image(SINGLE_SIDE, SINGLE_SIDE, seed=500 + c)
                    for c in range(3)], axis=-1)
    tiles = (SINGLE_TILE, SINGLE_TILE)
    return [
        ("S1 defaults", rgb, tp.Options(), "dwt97"),
        ("S2 HT tiles layers", rgb, tp.Options(
            format=tp.Format.J2K, lossless=True, high_throughput=True,
            tile_size=tiles, num_layers=3), "dwt53"),
        ("S3 Part-1 tiles budget", natural_image_bits(*MAMMO, 12, seed=510),
         tp.Options(format=tp.Format.J2K, lossless=True, tile_size=tiles,
                    num_layers=2, compression_ratio=6.0, precision=12),
         "dwt53"),
        s4_case(tp),
    ]


def s4_case(tp):
    """S4 of the single-image phase: a small gray image at odd image and
    tile offsets, so every tile's levels have odd origins and sizes."""
    return ("S4 odd offsets", natural_image(*ODD, seed=520), tp.Options(
        format=tp.Format.J2K, lossless=True, high_throughput=True,
        image_offset=(7, 3), tile_offset=(5, 1), tile_size=(256, 256)),
        "dwt53")


def check_single_levels(dwt, dwt_cuda, transforms, dev):
    """The level kernels on the first level of the single-image phase's
    tiles (S1's one [3, 4096, 4096] tile of 9/7 coefficients, S2's
    [3, 1024, 1024] and S3's [1, 1024, 1024] and [1, 1024, 256] 5/3 tiles)
    through transforms.forward_level and inverse_level, against the plain
    lifting: exact, one launch each, no plain level."""
    gen = torch.Generator(device=dev).manual_seed(5)
    err = {}
    for kind, shape in ((dwt.IRR97, (3, SINGLE_SIDE, SINGLE_SIDE)),
                        (dwt.REV53, (3, SINGLE_TILE, SINGLE_TILE)),
                        (dwt.REV53, (1, SINGLE_TILE, SINGLE_TILE)),
                        (dwt.REV53, (1, SINGLE_TILE, MAMMO[1] % SINGLE_TILE))):
        lib = "dwt53" if kind == dwt.REV53 else "dwt97"
        if kind == dwt.REV53:
            x = torch.randint(-(1 << 13), 1 << 13, shape, generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            x = torch.rand(shape, generator=gen, device=dev) * 255 - 128
        dwt_cuda.reset_counts()
        got = transforms.forward_level(x, kind, 0, 0)
        ref = {k: v.contiguous() for k, v in dwt.forward_2d(x, kind).items()}
        diff = {f"{lib}_fwd_level":
                max((got[k] - ref[k]).abs().max().item() for k in ref),
                f"{lib}_inv_level": (transforms.inverse_level(ref, kind, 0, 0)
                                     - dwt.inverse_2d(ref, kind)
                                     ).abs().max().item()}
        torch.cuda.synchronize()
        for name, d in diff.items():
            print(f"kernel check {name} {shape} (single-image tile): "
                  f"max|diff| {d}, launches {dwt_cuda.LAUNCHES[name]}, plain "
                  f"levels {dwt_cuda.PLAIN_LEVELS}", flush=True)
            if d or dwt_cuda.PLAIN_LEVELS or dwt_cuda.LAUNCHES[name] != 1:
                raise AssertionError(f"{name} at {shape}: not the kernel, "
                                     "or not exact")
            err[name] = max(err.get(name, 0), d)
        del x, got, ref
    dwt_cuda.reset_counts()
    torch.cuda.empty_cache()
    return err


def stage_clock(wraps):
    """A tools/_clock.py StageClock over (module, function name, stage
    label) wraps, host clock only, not strict (a phase-16 case may skip a
    stage); its `seconds` are each label's host seconds, a stage called
    inside another counted in the inner one only."""
    from go_jpeg2000_tpu_torch.tools._clock import Stage, StageClock
    return StageClock([Stage(m, n, label) for m, n, label in wraps],
                      strict=False)


def single_image_stages(tp, label, image, opts, data, dev, card):
    """One encode and one decode of the case on the card, timed in their
    stages: encode device transform (upload, DC shift, colour transform,
    DWT levels, quantization, fetch: transforms.run_forward), host block
    coding (the native coder), PCRD and Tier-2 (_assemble_with_budget);
    decode Python Tier-2 with the dequantization in numpy
    (decoder.tile_pyramids less the block decode), native block decode,
    and the device inverse (upload, inverse levels, inverse colour
    transform, download: transforms.run_inverse)."""
    from go_jpeg2000_tpu_torch.models import decoder, encoder, transforms
    mpix = image.shape[0] * image.shape[1] / 1e6
    with stage_clock([(transforms, "run_forward", "device transform"),
                     (encoder, "_code_blocks", "host block coding"),
                     (encoder, "_assemble_with_budget", "PCRD and Tier-2")]
                    ) as enc:
        t0 = time.perf_counter()
        again = tp.encode(image, opts, device=dev)
        enc_s = time.perf_counter() - t0
    if again != data:
        raise AssertionError(f"{label}: a second encode differs")
    with stage_clock([(decoder, "tile_pyramids", "tier2"),
                     (decoder, "decode_blocks_batch", "block decode"),
                     (transforms, "run_inverse", "device inverse")]) as dec:
        t0 = time.perf_counter()
        tp.decode(data, device=dev)
        dec_s = time.perf_counter() - t0
    e = enc.seconds
    d = dict(dec.seconds)
    print(f"stages {label} encode {enc_s * 1e3:.1f} ms ({mpix / enc_s:.2f} "
          f"Mpix/s): device transform {e['device transform'] * 1e3:.1f} ms, "
          f"host block coding {e['host block coding'] * 1e3:.1f} ms, PCRD "
          f"and Tier-2 {e['PCRD and Tier-2'] * 1e3:.1f} ms; decode "
          f"{dec_s * 1e3:.1f} ms ({mpix / dec_s:.2f} Mpix/s): Python Tier-2 "
          f"{d['tier2'] * 1e3:.1f} ms, native block decode "
          f"{d['block decode'] * 1e3:.1f} ms, device inverse "
          f"{d['device inverse'] * 1e3:.1f} ms [{card}]", flush=True)


def single_image_phase(tp, dev, card, launches):
    """Phase 11: the single-image API (encode, decode) on S1-S4 (the cases
    of single_image_cases), each with the DWT counts and tp.counters reset
    just before its encode and decode and read just after: each must
    launch both level kernels of its kind and lift no level plain (S4's
    at odd origins and sizes).  Bytes and decodes equal the port's CPU run;
    S2 round-trips exactly, S1 prints its PSNR.  Then wall Mpix/s and the
    stages of a second run, with the card's name and power limit.  Adds
    the phase's launches to `launches`; returns the level kernels' largest
    difference from the plain lifting on the phase's tile shapes."""
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda
    err = check_single_levels(dwt, dwt_cuda, transforms, dev)
    for label, image, opts, lib in single_image_cases(tp):
        mpix = image.shape[0] * image.shape[1] / 1e6
        reset_all_counts(tp)
        t0 = time.perf_counter()
        data = tp.encode(image, opts, device=dev)
        t1 = time.perf_counter()
        decoded = tp.decode(data, device=dev)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        counts = dict(dwt_cuda.LAUNCHES)
        plain = dwt_cuda.PLAIN_LEVELS
        snap = tp.counters.snapshot()
        mine = {k: v for k, v in counts.items() if k.startswith(lib)}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"{label} {image.shape} {image.dtype}: launches "
              f"{ {k: v for k, v in counts.items() if v} }, plain levels "
              f"{plain}, tiles decoded {snap.get('dec.tiles_decoded', 0)}",
              flush=True)
        if min(mine.values()) <= 0 or plain:
            raise AssertionError(f"{label}: a level did not run through the "
                                 f"{lib} kernels")
        if decoded.shape != image.shape or decoded.dtype != image.dtype:
            raise AssertionError(f"{label}: decoded {decoded.shape} "
                                 f"{decoded.dtype}")
        exact = opts.lossless and opts.compression_ratio <= 1.0
        if exact and not np.array_equal(decoded, image):
            raise AssertionError(f"{label}: round trip is not exact")
        peak = 255.0 if image.dtype == np.uint8 else float((1 << 12) - 1)
        mse = np.mean((decoded.astype(np.float64) - image) ** 2)
        quality = ("round-trip exact" if exact else
                   f"PSNR {10 * np.log10(peak ** 2 / mse):.3f} dB")
        print(f"{label}: {len(data)} bytes ({image.nbytes / len(data):.2f}:1 "
              f"of the {image.dtype} samples), {quality}; wall encode "
              f"{mpix / (t1 - t0):.2f} Mpix/s ({(t1 - t0) * 1e3:.1f} ms), "
              f"decode {mpix / (t2 - t1):.2f} Mpix/s "
              f"({(t2 - t1) * 1e3:.1f} ms) [{card}]", flush=True)
        t0 = time.perf_counter()
        if tp.encode(image, opts, device="cpu") != data:
            raise AssertionError(f"{label}: CUDA and CPU codestreams differ")
        t1 = time.perf_counter()
        if not np.array_equal(tp.decode(data, device="cpu"), decoded):
            raise AssertionError(f"{label}: CUDA and CPU decodes differ")
        print(f"{label}: CUDA and CPU codestreams byte-identical, decodes "
              f"equal (CPU encode {t1 - t0:.1f} s, CPU decode "
              f"{time.perf_counter() - t1:.1f} s)", flush=True)
        single_image_stages(tp, label, image, opts, data, dev, card)
        torch.cuda.empty_cache()
    return err


def reset_all_counts(tp):
    """Every kernel's launch count, the plain levels and tp.counters to 0."""
    from go_jpeg2000_tpu_torch.ops import reset_launches
    reset_launches()
    tp.counters.reset()


def all_launches():
    """Every kernel's launch count in this process."""
    from go_jpeg2000_tpu_torch.ops import kernel_launches
    return kernel_launches()


def add_launches(launches, counts, label, need):
    """Add `counts` to `launches`; every kernel of `need` must have been
    launched."""
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"{label} launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    missing = [k for k in need if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched")


def config2_image():
    """bench.py's lossy_psnr image: C2_SIDE^2 RGB noise smoothed twice by
    three taps, seed 0."""
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, size=(C2_SIDE, C2_SIDE, 3)).astype(np.float32)
    for ax in (0, 1):
        for _ in range(2):
            a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def openjpeg_psnr(img, ratio, nres):
    """PSNR of OpenJPEG's irreversible encode with the MCT at `ratio`
    through Pillow, or None where Pillow has no OpenJPEG."""
    import io
    from PIL import Image, features
    if not features.check("jpg_2000"):
        return None
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG2000", irreversible=True,
                              quality_mode="rates", quality_layers=[ratio],
                              num_resolutions=nres, mct=1)
    return psnr(np.asarray(Image.open(io.BytesIO(b.getvalue()))), img)


def config2_phase(tp, dev, card, launches):
    """Phase 12: BASELINE config 2 at its specified scale through encode
    and decode on the card: bytes and decode equal the CPU run's, the
    codestream inside its budget, PSNR beside OpenJPEG's at the same rate,
    wall ms and the stages.  Returns (image, JP2 file, its decode)."""
    from go_jpeg2000_tpu_torch.models.decoder import sniff_format
    img = config2_image()
    opts = tp.Options(format=tp.Format.JP2, lossless=False, quality=98,
                      num_resolutions=6, num_layers=3,
                      compression_ratio=C2_RATIO, backend="native")
    reset_all_counts(tp)
    t0 = time.perf_counter()
    data = tp.encode(img, opts, device=dev)
    t1 = time.perf_counter()
    decoded = tp.decode(data, device=dev)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    add_launches(launches, all_launches(), "config 2",
                 ("dwt97_fwd_level", "dwt97_inv_level"))
    budget = img.size // int(C2_RATIO)
    stream = len(sniff_format(data)[1])
    if stream > budget:
        raise AssertionError(f"config 2: codestream {stream} bytes over the "
                             f"budget {budget}")
    p_opj = openjpeg_psnr(img, C2_RATIO, 6)
    print(f"config 2 {img.shape}: JP2 {len(data)} bytes, codestream {stream} "
          f"of the {budget}-byte budget, PSNR {psnr(decoded, img):.3f} dB, "
          "OpenJPEG at the same rate (Pillow, mct=1) "
          + (f"{p_opj:.3f} dB" if p_opj is not None else "not available")
          + f"; wall encode {(t1 - t0) * 1e3:.1f} ms, decode "
          f"{(t2 - t1) * 1e3:.1f} ms [{card}]", flush=True)
    if tp.encode(img, opts, device="cpu") != data:
        raise AssertionError("config 2: CUDA and CPU codestreams differ")
    if not np.array_equal(tp.decode(data, device="cpu"), decoded):
        raise AssertionError("config 2: CUDA and CPU decodes differ")
    print("config 2: CUDA and CPU codestreams byte-identical, decodes equal",
          flush=True)
    single_image_stages(tp, "config 2", img, opts, data, dev, card)
    torch.cuda.empty_cache()
    return img, data, decoded


def fused_layers_phase(tp, dev, card, launches):
    """Phase 13: quality layers and a byte budget through the fused HT
    batch encode (ht_refinement=False): every frame through the device
    program (enc.fused_chunks) and its HT kernels, then per-frame PCRD;
    bytes and decodes equal the CPU run's."""
    frames = [natural_image(H, W, seed=700 + i) for i in range(N_LOSSY_GRAY)]
    opts = tp.Options(format=tp.Format.J2K, lossless=False, quality=95,
                      num_resolutions=6, high_throughput=True,
                      ht_refinement=False, num_layers=2,
                      compression_ratio=10.0)
    reset_all_counts(tp)
    streams = tp.encode_batch(frames, opts, device=dev)
    decoded = tp.decode_batch(streams, device=dev)
    torch.cuda.synchronize()
    snap = tp.counters.snapshot()
    add_launches(launches, all_launches(), "fused layers",
                 HT_KERNELS + ("dwt97_fwd_level", "dwt97_inv_level"))
    if snap.get("enc.fused_chunks", 0) <= 0 or \
            snap.get("enc.host_entropy_frames", 0):
        raise AssertionError(f"fused layers: not the fused encode {snap}")
    budget = H * W // 10
    print(f"fused layers: {len(frames)} frames, {sum(map(len, streams))} "
          f"bytes, largest {max(map(len, streams))} of a {budget}-byte "
          f"budget, PSNR {min(psnr(d, f) for d, f in zip(decoded, frames)):.3f}"
          f" dB (lowest frame), {snap.get('enc.fused_chunks')} fused chunks",
          flush=True)
    if tp.encode_batch(frames, opts, device="cpu") != streams:
        raise AssertionError("fused layers: CUDA and CPU codestreams differ")
    if not all(np.array_equal(d, c) for d, c in
               zip(decoded, tp.decode_batch(streams, device="cpu"))):
        raise AssertionError("fused layers: CUDA and CPU decodes differ")
    print("fused layers: CUDA and CPU codestreams byte-identical, decodes "
          "equal", flush=True)


def multihost_run(tp, fn, label, launches, need, **kw):
    """One encode_multihost or decode_multihost call on "cuda" with every
    count reset just before it; the launches of its measured run, which
    the hosts report after their warm-ups, are added to `launches`.
    Returns (result, stats)."""
    reset_all_counts(tp)
    stats = {}
    out = fn(_stats=stats, device="cuda", **kw)
    torch.cuda.synchronize()
    add_launches(launches, stats["host_launches"], label, need)
    return out, stats


def _transport_host(conn, shape, n_tiles):
    """One host of gather_ms: n_tiles tiles of `shape`, as uint8 and then
    as int32 samples, each sent to the parent once as one pipe message and
    once through multihost._send_large (PIPE_CHUNK pieces)."""
    from go_jpeg2000_tpu_torch.parallel import multihost
    conn.send("ready")
    for dt in (np.uint8, np.int32):
        parts = [(t, np.full(shape, t, dt)) for t in range(n_tiles)]
        for send in (conn.send, lambda o: multihost._send_large(conn, o)):
            assert conn.recv() == "go"
            send(parts)
    conn.close()


def gather_ms(n_hosts, shape, n_tiles):
    """ms the parent takes to receive n_tiles tiles of `shape` from each of
    n_hosts spawned processes: {(dtype, "one message" or "1 MB pieces"):
    ms}, the hosts started before the clock."""
    from go_jpeg2000_tpu_torch.parallel import multihost
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    try:
        for _ in range(n_hosts):
            a, b = ctx.Pipe()
            procs.append(ctx.Process(target=_transport_host,
                                     args=(b, shape, n_tiles), daemon=True))
            procs[-1].start()
            b.close()
            conns.append(a)
        for c in conns:
            assert c.recv() == "ready"
        out = {}
        for dt in ("uint8", "int32"):
            for how, recv in (("one message", lambda c: c.recv()),
                              ("1 MB pieces", multihost._recv_large)):
                for c in conns:
                    c.send("go")
                t0 = time.perf_counter()
                for c in conns:
                    recv(c)
                out[(dt, how)] = (time.perf_counter() - t0) * 1e3
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return out


def config5_phase(tp, dev, card, launches):
    """Phase 14: BASELINE config 5, the multi-host decomposition, each host
    a process with its tiles' transforms on the card: a C5_SIDE^2 RGB image
    in C5_TILE^2 tiles, HTJ2K lossless, 2 layers at 6:1, at 1, 2 and 4
    hosts after a warm-up, bytes equal to the card's single-process encode,
    and that to the CPU run's; compute wall, Mpix/s, reduction rounds,
    efficiency against one host and the host's cores.  decode_multihost at
    1, 2 and 4 hosts equals the card's decode, and, of the stream without
    a budget, the input.  The gather of a 2-host decode's samples, timed
    as one pipe message and in 1 MB pieces.  Then lossy 9/7 HT at
    C2_SIDE^2, 2 layers at 12:1, over 2 hosts: bytes equal to the card's
    and the CPU's single-process encode, the decode of 2 hosts to the
    card's and the CPU's decode."""
    from go_jpeg2000_tpu_torch.parallel import (decode_multihost,
                                                encode_multihost)
    img = np.stack([natural_image(C5_SIDE, C5_SIDE, seed=800 + c)
                    for c in range(3)], axis=-1)
    mpix = C5_SIDE * C5_SIDE / 1e6
    base = dict(format=tp.Format.J2K, lossless=True, high_throughput=True,
                tile_size=(C5_TILE, C5_TILE), num_layers=2)
    opts = tp.Options(compression_ratio=6.0, **base)
    single = tp.encode(img, opts, device=dev)
    t0 = time.perf_counter()
    if tp.encode(img, opts, device="cpu") != single:
        raise AssertionError("config 5: CUDA and CPU codestreams differ")
    print(f"config 5: CUDA and CPU single-process codestreams byte-identical "
          f"(CPU encode {time.perf_counter() - t0:.1f} s)", flush=True)
    fwd = ("dwt53_fwd_level",)
    inv = ("dwt53_inv_level",)
    walls = {}
    for n in C5_HOSTS:
        data, st = multihost_run(
            tp, lambda **kw: encode_multihost(img, opts, n_hosts=n,
                                              warmups=1, **kw),
            f"config 5 encode, {n} hosts", launches, fwd)
        if data != single:
            raise AssertionError(f"config 5: {n} hosts' codestream differs "
                                 "from the single-process encode")
        walls[n] = st["compute_wall_s"]
        print(f"config 5 encode {n} hosts: compute wall "
              f"{walls[n] * 1e3:.1f} ms ({mpix / walls[n]:.2f} Mpix/s), "
              f"{st['reduce_rounds']} reduction rounds, efficiency "
              f"{walls[C5_HOSTS[0]] / (n * walls[n]):.3f} against 1 host, "
              f"{len(data)} bytes, byte-identical; host cores "
              f"{os.cpu_count()} [{card}]", flush=True)
    exact = tp.encode(img, tp.Options(**base), device=dev)
    for stream, want, what in ((single, tp.decode(single, device=dev),
                                "the card's decode"),
                               (exact, img, "the input")):
        for n in C5_HOSTS:
            out, st = multihost_run(
                tp, lambda **kw: decode_multihost(stream, n_hosts=n,
                                                  warmups=1, **kw),
                f"config 5 decode, {n} hosts", launches, inv)
            if not np.array_equal(out, want):
                raise AssertionError(f"config 5: the decode of {n} hosts "
                                     f"differs from {what}")
            walls[("dec", what, n)] = st["compute_wall_s"]
            print(f"config 5 decode {n} hosts: compute wall "
                  f"{st['compute_wall_s'] * 1e3:.1f} ms "
                  f"({mpix / st['compute_wall_s']:.2f} Mpix/s), efficiency "
                  f"{walls[('dec', what, 1)] / (n * walls[('dec', what, n)]):.3f}"
                  f" against 1 host, equal to {what} [{card}]", flush=True)
    n_tiles = (C5_SIDE // C5_TILE) ** 2 // 2
    shape = (3, C5_TILE, C5_TILE)
    mb = {dt: 2 * n_tiles * np.dtype(dt).itemsize * math.prod(shape) / 1e6
          for dt in ("uint8", "int32")}
    ms = gather_ms(2, shape, n_tiles)
    print(f"config 5 gather of a 2-host decode's samples, {n_tiles} tiles "
          f"{shape} a host: "
          + "; ".join(f"{dt} ({mb[dt]:.1f} MB) {how} {t:.1f} ms"
                      for (dt, how), t in ms.items())
          + f"; host cores {os.cpu_count()} [{card}]", flush=True)
    lossy_img = np.stack([natural_image(C2_SIDE, C2_SIDE, seed=810 + c)
                          for c in range(3)], axis=-1)
    lossy = tp.Options(format=tp.Format.J2K, lossless=False,
                       high_throughput=True, tile_size=(C5_TILE, C5_TILE),
                       num_layers=2, compression_ratio=12.0)
    data, st = multihost_run(
        tp, lambda **kw: encode_multihost(lossy_img, lossy, n_hosts=2, **kw),
        "config 5 lossy encode, 2 hosts", launches, ("dwt97_fwd_level",))
    for where in (dev, "cpu"):
        if data != tp.encode(lossy_img, lossy, device=where):
            raise AssertionError("config 5 lossy: 2 hosts' codestream "
                                 f"differs from the {where} encode")
    out, _st = multihost_run(
        tp, lambda **kw: decode_multihost(data, n_hosts=2, **kw),
        "config 5 lossy decode, 2 hosts", launches, ("dwt97_inv_level",))
    for where in (dev, "cpu"):
        if not np.array_equal(out, tp.decode(data, device=where)):
            raise AssertionError("config 5 lossy: the decode of 2 hosts "
                                 f"differs from the {where} decode")
    print(f"config 5 lossy {lossy_img.shape}: 2 hosts byte-identical to the "
          f"card's and the CPU's encode ({len(data)} bytes), decode equal to "
          "the card's and the CPU's, PSNR "
          f"{psnr(out, lossy_img):.3f} dB [{card}]", flush=True)
    torch.cuda.empty_cache()


def dryrun_phase(tp, card, launches):
    """Phase 15: entry's fused HT encode program and dryrun_multichip's
    four checks on the card: a grid of one in this process, and, with two
    or more cards, a rank a card."""
    from go_jpeg2000_tpu_torch.entry import dryrun_multichip, entry
    reset_all_counts(tp)
    fn, args = entry(device="cuda")
    _pool, totals = fn(*args)
    dryrun_multichip(1, device="cuda")
    torch.cuda.synchronize()
    add_launches(launches, all_launches(), "entry and dryrun_multichip(1)",
                 HT_KERNELS + ("dwt53_fwd_level", "band_stats"))
    print(f"entry: fused HT encode of 2 x 256^2, pool words "
          f"{totals.tolist()}; dryrun_multichip(1): four checks passed "
          f"[{card}]", flush=True)
    n = torch.cuda.device_count()
    if n >= 2:
        dryrun_multichip(n, device="cuda")
        print(f"dryrun_multichip({n}): four checks passed, NCCL", flush=True)


def relabel_siz(data, ssiz=None, sub=None):
    """A one-component J2K codestream with its SIZ fields rewritten: Ssiz
    (sign and precision) and, with `sub`, Xsiz, Ysiz, XTsiz and YTsiz
    multiplied by it and XRsiz = YRsiz = sub (the component keeps its
    grid, so the tile data stay valid)."""
    import struct
    b = bytearray(data)
    if b[2:4] != b"\xff\x51" or b[40:42] != b"\x00\x01":
        raise ValueError("not a one-component J2K codestream")
    if ssiz is not None:
        b[42] = ssiz
    if sub:
        for off in (8, 12, 24, 28):
            struct.pack_into(">I", b, off,
                             struct.unpack_from(">I", b, off)[0] * sub)
        b[43] = b[44] = sub
    return bytes(b)


def options_run(tp, label, fn, launches, need):
    """fn() with every launch count, the plain levels and tp.counters set
    to 0 just before it: its launches added to `launches` (every kernel of
    `need` launched), no level lifted plain.  Returns (result, wall ms,
    counters)."""
    from go_jpeg2000_tpu_torch.ops import dwt_cuda
    reset_all_counts(tp)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    add_launches(launches, all_launches(), label, need)
    if dwt_cuda.PLAIN_LEVELS:
        raise AssertionError(f"{label}: {dwt_cuda.PLAIN_LEVELS} plain levels")
    return out, ms, tp.counters.snapshot()


def same(label, got, want):
    """got must equal want: shape, dtype and every sample."""
    if (got.shape != want.shape or got.dtype != want.dtype
            or not np.array_equal(got, want)):
        raise AssertionError(f"{label}: {got.shape} {got.dtype} differs from "
                             f"the expected {want.shape} {want.dtype}")


def timed(fn):
    """(fn(), its wall ms on the host's clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def decode_stage_line(tp, label, data, cfg, dev, card):
    """A second decode of a phase-16 case, timed in its stages: Python
    Tier-2 (decoder.tile_pyramids less the block decode), native block
    decode, device inverse (transforms.run_inverse), and the rest by
    difference (the parse, the planes' assembly, stacking and narrowing,
    the colour conversion and the crop)."""
    from go_jpeg2000_tpu_torch.models import decoder, transforms
    with stage_clock([(decoder, "tile_pyramids", "tier2"),
                     (decoder, "decode_blocks_batch", "block decode"),
                     (transforms, "run_inverse", "device inverse")]) as clk:
        t0 = time.perf_counter()
        tp.decode(data, cfg, device=dev)
        wall = time.perf_counter() - t0
    d = dict(clk.seconds)
    print(f"stages {label}: wall {wall * 1e3:.1f} ms: Python Tier-2 "
          f"{d['tier2'] * 1e3:.1f} ms, native block decode "
          f"{d.get('block decode', 0.0) * 1e3:.1f} ms, device inverse "
          f"{d['device inverse'] * 1e3:.1f} ms, the rest (parse, planes, "
          f"stacking, narrowing, crop) {(wall - sum(d.values())) * 1e3:.1f} "
          f"ms [{card}]", flush=True)


def viewport_cases(tp, dev, card, launches, img, data):
    """R1, a tile server's viewport of config 4's stream (tiles outside it
    skipped), and R2, its thumbnail (reduce_resolution) and the viewport
    of the thumbnail."""
    need = ("dwt53_inv_level",)
    x0, y0, x1, y1 = R1_AREA
    h, w = img.shape[:2]
    cols = -(-min(x1, w) // C4_TILE) - x0 // C4_TILE
    rows = -(-min(y1, h) // C4_TILE) - y0 // C4_TILE
    n_tiles = -(-h // C4_TILE) * -(-w // C4_TILE)
    cfg = tp.Config(decode_area=R1_AREA)
    out, ms, snap = options_run(tp, "R1 viewport",
                                lambda: tp.decode(data, cfg, device=dev),
                                launches, need)
    same("R1 viewport", out, img[y0:y1, x0:x1])
    tiles = (snap.get("dec.tiles_decoded", 0),
             snap.get("dec.tiles_skipped", 0))
    if tiles != (rows * cols, n_tiles - rows * cols):
        raise AssertionError(f"R1 viewport: tiles decoded, skipped {tiles}")
    print(f"R1 viewport {R1_AREA} of config 4's {img.shape} {img.dtype}: "
          f"{tiles[0]} tiles decoded, {tiles[1]} skipped, equal to the "
          f"input's crop; wall {ms:.1f} ms, plain levels 0 [{card}]",
          flush=True)
    decode_stage_line(tp, "R1 viewport", data, cfg, dev, card)
    cfg = tp.Config(reduce_resolution=THUMB_REDUCE)
    thumb, ms, _ = options_run(tp, "R2 thumbnail",
                               lambda: tp.decode(data, cfg, device=dev),
                               launches, need)
    s = 1 << THUMB_REDUCE
    if thumb.shape != (-(-h // s), -(-w // s), img.shape[2]):
        raise AssertionError(f"R2 thumbnail: shape {thumb.shape}")
    on_cpu, cpu_ms = timed(lambda: tp.decode(data, cfg, device="cpu"))
    same("R2 thumbnail, CPU run", thumb, on_cpu)
    cfg = tp.Config(decode_area=R1_AREA, reduce_resolution=THUMB_REDUCE)
    crop, ms2, _ = options_run(tp, "R2 viewport of the thumbnail",
                               lambda: tp.decode(data, cfg, device=dev),
                               launches, need)
    same("R2 viewport of the thumbnail", crop,
         thumb[y0 // s:-(-y1 // s), x0 // s:-(-x1 // s)])
    print(f"R2 thumbnail reduce_resolution={THUMB_REDUCE}: {thumb.shape}, "
          f"equal to the CPU run's (CPU {cpu_ms:.1f} ms); its viewport "
          f"{crop.shape} equal to the thumbnail's crop; wall {ms:.1f} ms, "
          f"viewport {ms2:.1f} ms, plain levels 0 [{card}]", flush=True)
    decode_stage_line(tp, "R2 thumbnail", data,
                      tp.Config(reduce_resolution=THUMB_REDUCE), dev, card)


def precinct_case(tp, dev, card, launches, img):
    """R3: the config-2 image as HTJ2K lossless in one tile of 128^2
    precincts with PLT; a region's packets skipped by PLT seek."""
    need = ("dwt53_inv_level",)
    opts = tp.Options(format=tp.Format.J2K, lossless=True,
                      high_throughput=True, num_resolutions=6,
                      precinct_size=[(7, 7)] * 6, enable_plt=True)
    data, enc_ms = timed(lambda: tp.encode(img, opts, device=dev))
    full, full_ms, snap = options_run(tp, "R3 whole decode",
                                      lambda: tp.decode(data, device=dev),
                                      launches, need)
    same("R3 whole decode", full, img)
    total = snap.get("dec.packets_parsed", 0)
    cfg = tp.Config(decode_area=R3_AREA)
    crop, ms, snap = options_run(tp, "R3 precinct seek",
                                 lambda: tp.decode(data, cfg, device=dev),
                                 launches, need)
    x0, y0, x1, y1 = R3_AREA
    same("R3 precinct seek", crop, img[y0:y1, x0:x1])
    skipped = snap.get("dec.packets_skipped", 0)
    parsed = snap.get("dec.packets_parsed", 0)
    if skipped <= 0 or parsed + skipped != total:
        raise AssertionError(f"R3: {parsed} packets parsed, {skipped} "
                             f"skipped, {total} in the whole decode")
    print(f"R3 precinct seek {R3_AREA} of {img.shape} in 128^2 precincts "
          f"with PLT: {parsed} packets parsed, {skipped} skipped "
          f"({snap.get('dec.packet_bytes_skipped', 0)} bytes) of {total}, "
          f"equal to the input's crop; wall {ms:.1f} ms (whole decode "
          f"{full_ms:.1f} ms, encode {enc_ms:.1f} ms), plain levels 0 "
          f"[{card}]", flush=True)
    decode_stage_line(tp, "R3 precinct seek", data, cfg, dev, card)


def layers_case(tp, dev, card, launches, img, data, decoded):
    """L1: config 2's 3-layer JP2 decoded from 1 and 2 layers and at
    reduce_resolution=2, each equal to the CPU run's; PSNR must not fall
    as layers are added."""
    need = ("dwt97_inv_level",)
    psnrs = []
    for q in (1, 2):
        cfg = tp.Config(quality_layers=q)
        out, ms, _ = options_run(tp, f"L1 {q} layers",
                                 lambda: tp.decode(data, cfg, device=dev),
                                 launches, need)
        same(f"L1 {q} layers, CPU run", out,
             tp.decode(data, cfg, device="cpu"))
        psnrs.append(psnr(out, img))
        print(f"L1 config 2 from {q} of 3 layers: PSNR {psnrs[-1]:.3f} dB, "
              f"equal to the CPU run's; wall {ms:.1f} ms, plain levels 0 "
              f"[{card}]", flush=True)
    psnrs.append(psnr(decoded, img))
    if not psnrs[0] <= psnrs[1] <= psnrs[2]:
        raise AssertionError(f"L1: PSNR falls as layers are added {psnrs}")
    cfg = tp.Config(reduce_resolution=2)
    out, ms, _ = options_run(tp, "L1 reduce_resolution=2",
                             lambda: tp.decode(data, cfg, device=dev),
                             launches, need)
    same("L1 reduce_resolution=2, CPU run", out,
         tp.decode(data, cfg, device="cpu"))
    print(f"L1 PSNR at 1, 2, 3 layers: "
          + ", ".join(f"{p:.3f}" for p in psnrs)
          + f" dB; reduce_resolution=2 {out.shape}, equal to the CPU run's; "
          f"wall {ms:.1f} ms, plain levels 0 [{card}]", flush=True)


def converters_on_card(tp, dev, card):
    """Each of the 14 colour converters on CONVERT_SIDE^2 planes (four;
    CMYK and YCCK read the fourth) at 8 and 16 bits, card against CPU:
    within one grey level; the samples that differ counted."""
    from go_jpeg2000_tpu_torch.ops import colorspace
    rng = np.random.RandomState(16)
    spaces = [c for c in tp.ColorSpace
              if colorspace.get_color_conversion(c) is not None]
    if len(spaces) != 14:
        raise AssertionError(f"{len(spaces)} converters, not 14")
    for bits in (8, 16):
        on_cpu = [torch.from_numpy(rng.randint(
            0, 1 << bits, size=(CONVERT_SIDE, CONVERT_SIDE)).astype(
                np.int32)) for _ in range(4)]
        on_card = [t.to(dev) for t in on_cpu]
        counts = []
        t0 = time.perf_counter()
        for space in spaces:
            conv = colorspace.get_color_conversion(space)
            got = torch.stack(conv(on_card, bits)).cpu()
            diff = (got - torch.stack(conv(on_cpu, bits))).abs()
            if int(diff.max()) > 1:
                raise AssertionError(f"C1 {space.name} at {bits} bits: "
                                     f"off by {int(diff.max())}")
            counts.append(f"{space.name} {int((diff > 0).sum())}")
        print(f"C1 converters, {CONVERT_SIDE}^2 planes at {bits} bits, card "
              f"against CPU, all within 1, samples differing: "
              + ", ".join(counts)
              + f" ({(time.perf_counter() - t0) * 1e3:.1f} ms for both) "
              f"[{card}]", flush=True)


def colour_cases(tp, dev, card, launches, img):
    """C1: the config-2 image as HT lossless JP2 tagged sYCC and YCbCr,
    decoded (converted) on the card equal to the CPU run's; then the 14
    converters, card against CPU."""
    for space in ("SYCC", "YCBCR2"):
        opts = tp.Options(format=tp.Format.JP2, lossless=True,
                          high_throughput=True, num_resolutions=6,
                          color_space=tp.ColorSpace[space])
        data = tp.encode(img, opts, device=dev)
        out, ms, _ = options_run(tp, f"C1 {space}",
                                 lambda: tp.decode(data, device=dev),
                                 launches, ("dwt53_inv_level",))
        same(f"C1 {space}, CPU run", out, tp.decode(data, device="cpu"))
        print(f"C1 JP2 tagged {space}: {out.shape} {out.dtype} converted, "
              f"equal to the CPU run's; wall {ms:.1f} ms, plain levels 0 "
              f"[{card}]", flush=True)
    converters_on_card(tp, dev, card)


def sample_cases(tp, dev, card, launches, img):
    """P1: the config-2 image's first channel as an 8-bit HT lossless J2K
    with only its SIZ fields rewritten: signed 8-bit, 4- and 20-bit
    unsigned, 2x2 subsampled, each decoded to its exact expected result;
    the signed one through decode_batch too."""
    need = ("dwt53_inv_level",)
    x = np.ascontiguousarray(img[:, :, 0])
    data = tp.encode(x, tp.Options(format=tp.Format.J2K, lossless=True,
                                   high_throughput=True, num_resolutions=6),
                     device=dev)
    xi = x.astype(np.int32)
    cases = (("signed 8-bit", dict(ssiz=0x87), (xi - 128).astype(np.int8)),
             ("4-bit", dict(ssiz=3),
              np.clip(xi - 120, 0, 15).astype(np.uint8)),
             ("20-bit", dict(ssiz=19), xi - 128 + (1 << 19)),
             ("2x2 subsampled", dict(sub=2),
              np.repeat(np.repeat(x, 2, 0), 2, 1)))
    for label, kw, want in cases:
        stream = relabel_siz(data, **kw)
        out, ms, _ = options_run(tp, f"P1 {label}",
                                 lambda: tp.decode(stream, device=dev),
                                 launches, need)
        same(f"P1 {label}", out, want)
        print(f"P1 {label}: {out.shape} {out.dtype} as expected; wall "
              f"{ms:.1f} ms, plain levels 0 [{card}]", flush=True)
    stream = relabel_siz(data, **cases[0][1])
    outs, ms, _ = options_run(tp, "P1 signed 8-bit, decode_batch",
                              lambda: tp.decode_batch([stream, stream],
                                                      device=dev),
                              launches, need)
    for out in outs:
        same("P1 signed 8-bit, decode_batch", out, cases[0][2])
    print(f"P1 signed 8-bit through decode_batch (2 frames): as expected; "
          f"wall {ms:.1f} ms [{card}]", flush=True)


def decode_options_phase(tp, dev, card, launches, c4, c2):
    """Phase 16: the decode options through decode (and decode_batch) on
    the card, on config 4's lossless stream (phase 10) and config 2's image
    and JP2 (phase 12): R1-R3, L1, C1, P1."""
    t0 = time.perf_counter()
    img2, data2, decoded2 = c2
    viewport_cases(tp, dev, card, launches, *c4)
    precinct_case(tp, dev, card, launches, img2)
    layers_case(tp, dev, card, launches, img2, data2, decoded2)
    colour_cases(tp, dev, card, launches, img2)
    sample_cases(tp, dev, card, launches, img2)
    torch.cuda.empty_cache()
    print(f"phase 16, decode options: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)


# ------------------------------------------------ phase 17: encode options

def signed_image(h, w, lo, hi, seed):
    """Smooth noise in [lo, hi), int16 (a CT slice's Hounsfield units)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(lo, hi, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return np.round(a).astype(np.int16)


def wide_image(shape, bits, seed):
    """Smooth noise of `bits`-bit samples, uint32."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << bits, size=shape, dtype=np.int64).astype(
        np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return np.round(a).astype(np.uint32)


def extremes_image(shape, bits, seed):
    """Each sample 0 or 2^bits - 1 at random, uint32: the largest detail
    coefficients the 5/3 lifting makes of `bits`-bit samples."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2, size=shape) * ((1 << bits) - 1)).astype(
        np.uint32)


def case_run(tp, label, fn, launches, need, card):
    """options_run with the case's host/device split printed: its wall ms,
    the device stages' share against the rest, and its plain
    levels (0, or options_run raises).  Returns (result, counters).  The
    device stages are tools/_clock.py DEVICE_STAGES: the device programs
    (their uploads and launches) and the fetches and downloads that wait
    for them; everything else is the host's."""
    from go_jpeg2000_tpu_torch.tools._clock import DEVICE_STAGES, StageClock
    with StageClock(DEVICE_STAGES, strict=False) as clock:
        out, ms, snap = options_run(tp, label, fn, launches, need)
    dev_ms = clock.attributed_s * 1e3
    print(f"{label}: wall {ms:.1f} ms, device programs and their fetches "
          f"{dev_ms:.1f} ms, host {ms - dev_ms:.1f} ms "
          f"({100 * (ms - dev_ms) / ms:.0f}%), plain levels 0 [{card}]",
          flush=True)
    return out, snap


def held_to_cpu(label, on_card, on_cpu):
    """The card's codestreams must equal the CPU run's."""
    if on_card != on_cpu:
        raise AssertionError(f"{label}: CUDA and CPU codestreams differ")
    print(f"{label}: CUDA and CPU codestreams byte-identical", flush=True)


HT_ENC = HT_KERNELS
EBCOT_ENC = ("ebcot_decision_slots", "ebcot_compact_rows", "ebcot_mq_encode",
             "ebcot_pool_rows")


def m1_tile_server(tp, dev, card, launches, c4):
    """M1: config 4's 8192^2 16-bit RGB through encode_sharded as JP2 with
    PLT, TLM, SOP and EPH (the device HT encode for every tile, then the
    Python Tier-2 on its segments), the round trip through decode exact,
    phase 16's R1 viewport read by PLT seek; at C4_CHECK^2 the card's bytes
    equal the CPU run's."""
    from go_jpeg2000_tpu_torch.parallel import encode_sharded
    img = c4[0]
    opts = dataclasses.replace(
        config4_opts(tp, True, enable_plt=True, enable_tlm=True,
                     enable_sop=True, enable_eph=True), format=tp.Format.JP2)
    n_tiles = (C4_SIZE // C4_TILE) ** 2
    data, snap = case_run(
        tp, "M1 tile server encode_sharded, JP2 + PLT/TLM/SOP/EPH",
        lambda: encode_sharded(img, opts, device=dev), launches,
        ("dwt53_fwd_level", "band_stats") + HT_ENC, card)
    tiles = (snap.get("enc.sharded_device_ht_tiles", 0),
             snap.get("enc.sharded_host_entropy_tiles", 0))
    if tiles != (n_tiles, 0):
        raise AssertionError(f"M1: device HT tiles, host tiles {tiles}")
    for marker in (b"\xff\x55", b"\xff\x58", b"\xff\x91", b"\xff\x92"):
        if marker not in data:
            raise AssertionError(f"M1: marker {marker.hex()} missing")
    out, _ = case_run(tp, "M1 decode", lambda: tp.decode(data, device=dev),
                      launches, ("dwt53_inv_level",), card)
    same("M1 round trip", out, img)
    cfg = tp.Config(decode_area=R1_AREA)
    crop, snap = case_run(tp, "M1 R1 viewport",
                          lambda: tp.decode(data, cfg, device=dev),
                          launches, ("dwt53_inv_level",), card)
    x0, y0, x1, y1 = R1_AREA
    same("M1 R1 viewport", crop, img[y0:y1, x0:x1])
    print(f"M1 {img.shape} {img.dtype}: {len(data)} bytes, device HT tiles "
          f"{tiles[0]}, round trip exact; R1 viewport {R1_AREA}: tiles "
          f"decoded {snap.get('dec.tiles_decoded', 0)}, skipped "
          f"{snap.get('dec.tiles_skipped', 0)}, packets parsed "
          f"{snap.get('dec.packets_parsed', 0)}, skipped by PLT seek "
          f"{snap.get('dec.packets_skipped', 0)} [{card}]", flush=True)
    small = config4_image(C4_CHECK, seed=4)
    held_to_cpu(f"M1 at {C4_CHECK}^2",
                encode_sharded(small, opts, device=dev),
                encode_sharded(small, opts, device="cpu"))


def m2_ct_series(tp, dev, card, launches):
    """M2: a CT series, CT_SLICES signed 16-bit slices, through
    encode_batch: HTJ2K lossless (the fused kernels), Part-1 lossless on
    paths A (with SOP and EPH), B and C; every decode exact; CT_CHECK
    slices held to the CPU run's bytes (Part-1 against the CPU's path C,
    which gives the bytes of A and B)."""
    series = [signed_image(CT_SIDE, CT_SIDE, -1024, 3072, 900 + i)
              for i in range(CT_SLICES)]

    def opts(**kw):
        return tp.Options(format=tp.Format.J2K, lossless=True,
                          num_resolutions=6, **kw)
    cases = (("HTJ2K lossless (fused)", opts(high_throughput=True),
              ("dwt53_fwd_level",) + HT_ENC, "enc.fused_chunks",
              ("ht_magsgn_decode", "ht_blocks_to_pyramid",
               "dwt53_inv_level")),
             ("Part-1 path A + SOP/EPH", opts(backend="device",
                                              enable_sop=True,
                                              enable_eph=True),
              ("dwt53_fwd_level", "ht_extract_blocks") + EBCOT_ENC,
              "enc.ebcot_device_chunks", ("dwt53_inv_level",)),
             ("Part-1 path B", opts(backend="hybrid"),
              ("dwt53_fwd_level", "ht_extract_blocks",
               "ebcot_decision_slots", "ebcot_compact_rows"),
              "enc.ebcot_hybrid_chunks",
              ("ht_blocks_to_pyramid", "dwt53_inv_level")),
             ("Part-1 path C", opts(backend="native"), ("dwt53_fwd_level",),
              "enc.host_entropy_frames",
              ("ht_blocks_to_pyramid", "dwt53_inv_level")))
    for label, o, need, path, dec_need in cases:
        streams, snap = case_run(
            tp, f"M2 CT series {label} encode_batch",
            lambda: tp.encode_batch(series, o, device=dev), launches, need,
            card)
        if not snap.get(path, 0):
            raise AssertionError(f"M2 {label}: no {path}")
        frames, _ = case_run(tp, f"M2 CT series {label} decode_batch",
                             lambda: tp.decode_batch(streams, device=dev),
                             launches, dec_need, card)
        for got, want in zip(frames, series):
            same(f"M2 {label} round trip", got, want)
        ref = (o if o.high_throughput
               else dataclasses.replace(o, backend="native"))
        held_to_cpu(f"M2 {label}, {CT_CHECK} slices",
                    streams[:CT_CHECK],
                    tp.encode_batch(series[:CT_CHECK], ref, device="cpu"))
        print(f"M2 {label}: {CT_SLICES} x {series[0].shape} int16, "
              f"{sum(map(len, streams))} bytes, round trip exact [{card}]",
              flush=True)


def m3_multispectral(tp, dev, card, launches):
    """M3: a 4-band 16-bit MS_SIDE^2 image (RGB + NIR) in MS_TILE^2 tiles,
    lossy 9/7 quality 85, 3 layers, TLM and PLT, through encode; a 2-band
    12-bit (gray + alpha) OPT_SIDE^2 image, lossless; each at OPT_SIDE^2
    held to the CPU run's bytes."""
    def four_band(side, seed):
        return np.stack([natural_image_bits(side, side, 16, seed=seed + b)
                         for b in range(4)], axis=-1)
    lossy = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                       num_resolutions=6, num_layers=3,
                       tile_size=(MS_TILE, MS_TILE), enable_tlm=True,
                       enable_plt=True)
    img = four_band(MS_SIDE, 950)
    data, _ = case_run(tp, "M3 4-band 16-bit encode", lambda: tp.encode(
        img, lossy, device=dev), launches, ("dwt97_fwd_level",), card)
    out, _ = case_run(tp, "M3 4-band 16-bit decode",
                      lambda: tp.decode(data, device=dev), launches,
                      ("dwt97_inv_level",), card)
    mse = np.mean((out.astype(np.float64) - img) ** 2)
    print(f"M3 4-band {img.shape} {img.dtype}: {len(data)} bytes "
          f"({img.nbytes / len(data):.2f}:1), PSNR "
          f"{10 * np.log10(65535.0 ** 2 / mse):.3f} dB [{card}]", flush=True)
    small = four_band(OPT_SIDE, 960)
    held_to_cpu(f"M3 4-band at {OPT_SIDE}^2",
                tp.encode(small, lossy, device=dev),
                tp.encode(small, lossy, device="cpu"))
    ga = np.stack([natural_image_bits(OPT_SIDE, OPT_SIDE, 12, seed=970),
                   natural_image_bits(OPT_SIDE, OPT_SIDE, 12, seed=971)],
                  axis=-1)
    lossless = tp.Options(format=tp.Format.J2K, lossless=True, precision=12,
                          num_resolutions=6, high_throughput=True)
    data, _ = case_run(tp, "M3 gray + alpha 12-bit encode",
                       lambda: tp.encode(ga, lossless, device=dev),
                       launches, ("dwt53_fwd_level",), card)
    out, _ = case_run(tp, "M3 gray + alpha 12-bit decode",
                      lambda: tp.decode(data, device=dev), launches,
                      ("dwt53_inv_level",), card)
    same("M3 gray + alpha round trip", out, ga)
    held_to_cpu(f"M3 gray + alpha at {OPT_SIDE}^2", data,
                tp.encode(ga, lossless, device="cpu"))


def check_wide_forward_levels(tp, dev, card):
    """M4's overflow check: every forward 5/3 level of 29-bit gray and of
    28-bit RGB after the RCT (29-bit chroma), each sample at one extreme or
    the other at random (detail coefficients past 2^30, whose lifting sums
    come within a bit of int32's range), through the level kernel against
    the plain lifting on the same card tensors, bit for bit.  Returns the
    largest difference."""
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.ops import dwt
    worst = 0
    for label, img, bits, mct in (
            ("29-bit gray", extremes_image((OPT_SIDE, OPT_SIDE), 29, 980),
             29, False),
            ("28-bit RGB after the RCT",
             extremes_image((OPT_SIDE, OPT_SIDE, 3), 28, 981), 28, True)):
        x = transforms.upload(np.moveaxis(img.reshape(
            img.shape[0], img.shape[1], -1), -1, 0)[None], dev)
        cur = transforms.coefficients(x, dwt.REV53, mct, bits,
                                      False).reshape(-1, OPT_SIDE, OPT_SIDE)
        wrapped = 0
        for lev in range(5):
            got = transforms.forward_level(cur, dwt.REV53, 0, 0)
            want = dwt.forward_2d(cur, dwt.REV53)
            for k in ("LL", "HL", "LH", "HH"):
                worst = max(worst, int((got[k].to(torch.int64)
                                        - want[k]).abs().max()))
            wide = sum(int((want[k].to(torch.int64).abs() >= 1 << 30).sum())
                       for k in ("HL", "LH", "HH"))
            wrapped += wide
            cur = got["LL"].contiguous()
        if worst:
            raise AssertionError(f"M4 {label}: the 5/3 level kernel differs "
                                 f"from the plain lifting by {worst}")
        print(f"M4 {label}: 5 forward 5/3 levels through the kernel equal "
              f"the plain lifting bit for bit ({wrapped} detail samples of "
              f"magnitude >= 2^30) [{card}]", flush=True)
    return worst


def m4_wide_samples(tp, dev, card, launches):
    """M4: 20- and 29-bit gray OPT_SIDE^2 lossless through encode, HTJ2K and
    Part-1, round trips exact and bytes equal to the CPU run's; the level
    kernels held to the plain lifting on the overflow cases."""
    err = check_wide_forward_levels(tp, dev, card)
    for bits in (20, 29):
        img = wide_image((OPT_SIDE, OPT_SIDE), bits, 990 + bits)
        for ht in (True, False):
            opts = tp.Options(format=tp.Format.J2K, lossless=True,
                              precision=bits, num_resolutions=6,
                              high_throughput=ht)
            label = f"M4 {bits}-bit gray {'HTJ2K' if ht else 'Part-1'}"
            data, _ = case_run(tp, f"{label} encode",
                               lambda: tp.encode(img, opts, device=dev),
                               launches, ("dwt53_fwd_level",), card)
            out, _ = case_run(tp, f"{label} decode",
                              lambda: tp.decode(data, device=dev),
                              launches, ("dwt53_inv_level",), card)
            same(f"{label} round trip", out, img.astype(np.int32))
            held_to_cpu(label, data, tp.encode(img, opts, device="cpu"))
    return err


def m5_styles_progression(tp, dev, card, launches):
    """M5: OPT_SIDE^2 RGB with Part-1 code-block styles 0x3f and
    PTERM|TERMALL|LAZY at 2 layers, lossless and lossy; a POC of three
    segments; PPM and PPT streams; each held to the CPU run and decoded by
    the port (exactly where lossless)."""
    img = np.stack([natural_image(OPT_SIDE, OPT_SIDE, seed=1000 + c)
                    for c in range(3)], axis=-1)
    base = dict(format=tp.Format.J2K, num_resolutions=6)
    cases = []
    for style in (0x3f, 0x10 | 0x04 | 0x01):
        for lossless in (True, False):
            cases.append((f"style {style:#x} 2 layers "
                          f"{'lossless' if lossless else 'lossy q85'}",
                          tp.Options(lossless=lossless, quality=85,
                                     code_block_style=style, num_layers=2,
                                     **base)))
    cases += [("POC of three segments", tp.Options(
                   lossless=True, high_throughput=True, num_layers=1,
                   progression_changes=[(0, 0, 1, 2, 3, 0),
                                        (2, 0, 1, 4, 3, 2),
                                        (4, 0, 1, 6, 3, 4)], **base)),
              ("PPM", tp.Options(lossless=True, high_throughput=True,
                                 enable_ppm=True, **base)),
              ("PPT + SOP/EPH", tp.Options(lossless=True,
                                           high_throughput=True,
                                           enable_ppt=True, enable_sop=True,
                                           enable_eph=True, **base))]
    for label, opts in cases:
        kind = "dwt53" if opts.lossless else "dwt97"
        data, _ = case_run(tp, f"M5 {label} encode",
                           lambda: tp.encode(img, opts, device=dev),
                           launches, (f"{kind}_fwd_level",), card)
        out, _ = case_run(tp, f"M5 {label} decode",
                          lambda: tp.decode(data, device=dev), launches,
                          (f"{kind}_inv_level",), card)
        if opts.lossless:
            same(f"M5 {label} round trip", out, img)
        else:
            print(f"M5 {label}: PSNR {psnr(out, img):.3f} dB", flush=True)
        held_to_cpu(f"M5 {label}", data, tp.encode(img, opts, device="cpu"))


def m6_python_backend(tp, dev, card, launches):
    """M6: backend "python" (the Python block coders) at PY_SIDE^2, the
    transform on the card: bytes equal the native backend's, HTJ2K and
    Part-1."""
    img = np.stack([natural_image(PY_SIDE, PY_SIDE, seed=1100 + c)
                    for c in range(3)], axis=-1)
    for ht in (True, False):
        opts = tp.Options(format=tp.Format.J2K, lossless=True,
                          num_resolutions=4, high_throughput=ht,
                          backend="python")
        label = f"M6 python backend {'HTJ2K' if ht else 'Part-1'}"
        data, _ = case_run(tp, label, lambda: tp.encode(img, opts,
                                                        device=dev),
                           launches, ("dwt53_fwd_level",), card)
        native = tp.encode(img, dataclasses.replace(opts, backend="native"),
                           device=dev)
        if data != native:
            raise AssertionError(f"{label}: bytes differ from the native "
                                 "backend's")
        same(f"{label} round trip", tp.decode(data, device=dev), img)
        print(f"{label}: {img.shape}, bytes equal to the native backend's, "
              f"round trip exact [{card}]", flush=True)


def encode_options_phase(tp, dev, card, launches, c4):
    """Phase 17: the encode options on the card, M1-M6.  Returns the 5/3
    level kernel's largest difference from the plain lifting on M4's
    overflow cases."""
    t0 = time.perf_counter()
    m1_tile_server(tp, dev, card, launches, c4)
    m2_ct_series(tp, dev, card, launches)
    m3_multispectral(tp, dev, card, launches)
    err = m4_wide_samples(tp, dev, card, launches)
    m5_styles_progression(tp, dev, card, launches)
    m6_python_backend(tp, dev, card, launches)
    torch.cuda.empty_cache()
    print(f"phase 17, encode options: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return err


# --------------------------------------------------- phase 18: odd geometry


def max_diff(got, want):
    """The largest |got - want| of two tensors of one shape (0 when empty);
    raises when the shapes differ."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0
    return (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()


def parity_input(dwt, kind, shape, gen, dev):
    if kind == dwt.REV53:
        return torch.randint(-(1 << 20), 1 << 20, shape, generator=gen,
                             device=dev, dtype=torch.int32)
    return torch.rand(shape, generator=gen, device=dev) * 255 - 128


def check_parity_levels(dwt, dwt_cuda, transforms, dev, card):
    """Phase 18a: all four level kernels at origin (4 + pu, 2 + pv) for
    every parity (pu, pv) on PARITY_SHAPES (1-sample, 3-sample, tile- and
    strip-crossing odd sizes, an odd 1080p frame, the 1080p batch's level
    4), through transforms.forward_level and inverse_level: one launch
    each, no plain level, bands at dwt.subband_shapes' sizes, equal to the
    plain lifting bit for bit (9/7 too); each timed alone beside its bound
    and the plain lifting's time.  These comparison launches are not the
    main path's.  Returns the largest differences."""
    gen = torch.Generator(device=dev).manual_seed(18)
    err = {f"{lib}_{d}_level": 0 for lib in ("dwt53", "dwt97")
           for d in ("fwd", "inv")}
    for shape in PARITY_SHAPES:
        for kind in (dwt.REV53, dwt.IRR97):
            lib = "dwt53" if kind == dwt.REV53 else "dwt97"
            x = parity_input(dwt, kind, shape, gen, dev)
            rate = INT32_OPS_PER_S if kind == dwt.REV53 else FP32_OPS_PER_S
            lim = bound(8 * x.numel(), OPS_PER_ELEMENT[lib] * x.numel(), rate)
            for pu, pv in ((0, 0), (1, 0), (0, 1), (1, 1)):
                u0, v0 = 4 + pu, 2 + pv
                dwt_cuda.reset_counts()
                got = transforms.forward_level(x, kind, u0, v0)
                ref = {k: v.contiguous() for k, v in
                       dwt.forward_2d(x, kind, u0=u0, v0=v0).items()}
                diff = {f"{lib}_fwd_level":
                        max(max_diff(got[k], ref[k]) for k in ref)}
                rec = transforms.inverse_level(ref, kind, u0, v0)
                diff[f"{lib}_inv_level"] = max_diff(
                    rec, dwt.inverse_2d(ref, kind, u0=u0, v0=v0))
                torch.cuda.synchronize()
                launched = {k: dwt_cuda.LAUNCHES[k] for k in diff}
                plain = dwt_cuda.PLAIN_LEVELS
                print(f"kernel check {lib} {shape} at origin {(u0, v0)}: "
                      f"max|diff| {diff}, launches {launched}, plain levels "
                      f"{plain}", flush=True)
                if (any(diff.values()) or plain
                        or set(launched.values()) != {1}):
                    raise AssertionError(f"{lib} at {shape}, origin "
                                         f"{(u0, v0)}: not the kernels, or "
                                         "not exact")
                for k, d in diff.items():
                    err[k] = max(err[k], d)
                fns = {f"{lib}_fwd_level": (
                    lambda: transforms.forward_level(x, kind, u0, v0),
                    lambda: dwt.forward_2d(x, kind, u0=u0, v0=v0)),
                    f"{lib}_inv_level": (
                    lambda: transforms.inverse_level(ref, kind, u0, v0),
                    lambda: dwt.inverse_2d(ref, kind, u0=u0, v0=v0))}
                for name, (fn, plain_fn) in fns.items():
                    time_line(name, cuda_ms(fn, reps=10),
                              cuda_ms(plain_fn, reps=3, warmup=1), *lim,
                              device_ms(fn, reps=10),
                              f"{list(shape)} at origin {(u0, v0)}", card)
                del got, ref, rec
    dwt_cuda.reset_counts()
    torch.cuda.empty_cache()
    return err


def hd_frames():
    """HD's 8-bit RGB frames (smooth noise, seeds 600 on)."""
    n, h, w = HD
    return [np.stack([natural_image(h, w, seed=600 + 3 * i + c)
                      for c in range(3)], axis=-1) for i in range(n)]


def hd_batch(tp, dev, card, launches):
    """Phase 18b: the 1080p batch (HD), HTJ2K at 6 resolutions, lossless
    and lossy q85, through encode_batch and decode_batch: the fused encode
    and the device HT decode, the level kernels at every level (level 4's
    input has 135 rows), no plain level; lossless round trips exact; the
    first HD_CHECK frames' bytes and decodes equal to the CPU run's; wall
    ms of the counted run and the median of three more."""
    frames = hd_frames()
    mpix = HD[0] * HD[1] * HD[2] / 1e6
    for lossless in (True, False):
        lib = "dwt53" if lossless else "dwt97"
        opts = tp.Options(format=tp.Format.J2K, lossless=lossless,
                          quality=85, num_resolutions=6,
                          high_throughput=True)
        label = f"H1 1080p {'lossless' if lossless else 'lossy q85'}"
        streams, snap = case_run(
            tp, f"{label} encode_batch",
            lambda: tp.encode_batch(frames, opts, device=dev), launches,
            (f"{lib}_fwd_level",) + HT_ENC, card)
        if snap.get("enc.fused_chunks", 0) <= 0:
            raise AssertionError(f"{label}: not the fused encode")
        decoded, snap = case_run(
            tp, f"{label} decode_batch",
            lambda: tp.decode_batch(streams, device=dev), launches,
            (f"{lib}_inv_level",) + HT_DEC_KERNELS, card)
        if snap.get("dec.device_ht_chunks", 0) <= 0:
            raise AssertionError(f"{label}: not the device HT decode")
        if lossless and not all(np.array_equal(d, f)
                                for d, f in zip(decoded, frames)):
            raise AssertionError(f"{label}: round trip is not exact")
        enc_ms = sorted(timed(lambda: tp.encode_batch(frames, opts,
                                                      device=dev))[1]
                        for _ in range(3))
        dec_ms = sorted(timed(lambda: tp.decode_batch(streams,
                                                      device=dev))[1]
                        for _ in range(3))
        quality = ("round trips exact" if lossless else "PSNR " + ", ".join(
            f"{psnr(d, f):.3f}" for d, f in zip(decoded[:2], frames)) +
            " dB (first two)")
        print(f"{label} {HD[0]}x{HD[1:]} RGB: {sum(map(len, streams))} "
              f"bytes, {quality}; wall (median of 3) encode {enc_ms[1]:.1f} "
              f"ms ({mpix / enc_ms[1] * 1e3:.2f} Mpix/s), decode "
              f"{dec_ms[1]:.1f} ms ({mpix / dec_ms[1] * 1e3:.2f} Mpix/s) "
              f"[{card}]", flush=True)
        held_to_cpu(f"{label} first {HD_CHECK} frames", streams[:HD_CHECK],
                    tp.encode_batch(frames[:HD_CHECK], opts, device="cpu"))
        on_cpu = tp.decode_batch(streams[:HD_CHECK], device="cpu")
        for i, (d, c) in enumerate(zip(decoded, on_cpu)):
            same(f"{label} frame {i} decode against the CPU's", d, c)
        del streams, decoded
        torch.cuda.empty_cache()


def s4_reduced(tp, dev, card, launches):
    """Phase 18c: S4's stream (odd origins and sizes on every tile)
    decoded at reduce_resolution S4_REDUCE on the card: the inverse 5/3
    kernel at every level, no plain level, equal to the CPU run's."""
    label, image, opts, _lib = s4_case(tp)
    data = tp.encode(image, opts, device=dev)
    for r in S4_REDUCE:
        cfg = tp.Config(reduce_resolution=r)
        out, _snap = case_run(tp, f"{label} reduce_resolution={r}",
                              lambda: tp.decode(data, cfg, device=dev),
                              launches, ("dwt53_inv_level",), card)
        same(f"{label} reduce_resolution={r} against the CPU's", out,
             tp.decode(data, cfg, device="cpu"))
        print(f"{label} reduce_resolution={r}: {out.shape}, equal to the "
              f"CPU run's [{card}]", flush=True)


def odd_geometry_phase(tp, dev, card, launches):
    """Phase 18: odd geometry, 18a-18c.  Returns the level kernels' largest
    differences from the plain lifting."""
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda
    t0 = time.perf_counter()
    err = check_parity_levels(dwt, dwt_cuda, transforms, dev, card)
    hd_batch(tp, dev, card, launches)
    s4_reduced(tp, dev, card, launches)
    print(f"phase 18, odd geometry: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return err


# ------------------------------------------ phase 19: config 4 on row shards

# the (dp, sp) grids of gloo ranks that share the one card, and the grid of
# NCCL ranks, a card each, where there are four cards
ROW_SHARD_GRIDS = ((1, 4), (2, 2))
NCCL_GRID = (2, 2)
STEP_REPS = 3


def grid_steps(tp, im, opts, grid, dev):
    """This rank's transform step on the row shard of its tiles and the
    inverse step on the pyramid it gives, each synchronised with every rank
    starting together, medians of STEP_REPS ms, and in each the edge round
    trip (sharded.level_edges: the packing launch, the gather and, on gloo,
    the download and the upload), synchronised around each call."""
    import torch.distributed as dist
    from go_jpeg2000_tpu_torch.models import encoder, transforms
    from go_jpeg2000_tpu_torch.ops import dwt
    from go_jpeg2000_tpu_torch.parallel import sharded as psh
    header = encoder.build_header(im, opts)
    comps = encoder._image_components(im)
    levels = header.coding_style.num_decompositions
    T, th, _tw = psh._check_grid(header, levels, grid.sp, "chip_smoke")
    rows = th // grid.sp
    x = transforms.upload(psh.tile_batch(
        header, comps, psh._my_tiles(T, grid), rows, grid.sp_rank * rows),
        dev)
    kind = dwt.REV53 if opts.lossless else dwt.IRR97
    mct = bool(header.coding_style.mct) and len(comps) >= 3
    prec = header.components[0].precision
    level_edges = psh.level_edges
    edge_s = [0.0]

    def timed(src, g):
        torch.cuda.synchronize()
        a = time.perf_counter()
        edges = level_edges(src, g)
        torch.cuda.synchronize()
        edge_s[0] += time.perf_counter() - a
        return edges

    out = {k: [] for k in ("transform", "transform edges", "inverse",
                           "inverse edges")}
    psh.level_edges = timed
    try:
        for _ in range(STEP_REPS):
            for what in ("transform", "inverse"):
                dist.barrier()
                torch.cuda.synchronize()
                edge_s[0] = 0.0
                a = time.perf_counter()
                if what == "transform":
                    pyr, _stats = psh.tile_transform_step(
                        x, levels, mct, prec, False, kind, grid)
                else:
                    psh.tile_inverse_step(pyr, mct, prec, False, kind, grid)
                torch.cuda.synchronize()
                out[what].append((time.perf_counter() - a) * 1e3)
                out[f"{what} edges"].append(edge_s[0] * 1e3)
    finally:
        psh.level_edges = level_edges
    return {k: float(np.median(v)) for k, v in out.items()}


def _grid_rank(rank, world, port, dp, sp, backend, img_path, refs, queue,
               device="cuda"):
    """One rank of phase 19: config 4 lossless, then the image >> 8 lossy
    at q85, through encode_sharded and decode_sharded on the (dp, sp) grid,
    every count reset just before each encode and read after its decode;
    then grid_steps.  Puts (rank, {label: results}) on the queue, or
    (rank, the error).  `device` "cpu" rehearses the phase without a card
    (torch.cuda.synchronize stubbed by the caller)."""
    import torch.distributed as dist
    try:
        import go_jpeg2000_tpu_torch as tp
        from go_jpeg2000_tpu_torch.ops import (dwt_cuda, kernel_launches,
                                               reset_launches)
        from go_jpeg2000_tpu_torch.parallel import (decode_sharded,
                                                    encode_sharded, make_grid)
        from go_jpeg2000_tpu_torch.parallel import sharded as psh
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
            dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    except BaseException as exc:
        queue.put((rank, f"{type(exc).__name__}: {exc}"))
        raise
    try:
        grid = make_grid(dist.group.WORLD, dp=dp, sp=sp)
        img = np.load(img_path)
        n_tiles = len(psh._my_tiles((C4_SIZE // C4_TILE) ** 2, grid))
        out = {}
        for label, im, opts in (
                ("config-4 lossless", img, config4_opts(tp, True)),
                ("config-4 lossy", (img >> 8).astype(np.uint8),
                 config4_opts(tp, False))):
            dist.barrier()
            reset_launches()
            tp.counters.reset()
            t0 = time.perf_counter()
            data = encode_sharded(im, opts, grid=grid, device=dev)
            t1 = time.perf_counter()
            pix = decode_sharded(data, grid=grid, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            snap = tp.counters.snapshot()
            stream, decode = refs[label]
            out[label] = {
                "launches": {k: v for k, v in kernel_launches().items() if v},
                "plain": dwt_cuda.PLAIN_LEVELS,
                "tiles": (snap.get("enc.sharded_device_ht_tiles", 0),
                          snap.get("dec.sharded_device_ht_tiles", 0)),
                "my_tiles": n_tiles,
                "same_stream": sha256(data) == stream,
                "decode_ok": (np.array_equal(pix, im) if opts.lossless
                              else sha256(pix) == decode),
                "bytes": len(data),
                "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                "steps": grid_steps(tp, im, opts, grid, dev)}
            del data, pix
        queue.put((rank, out))
    except BaseException as exc:
        queue.put((rank, f"{type(exc).__name__}: {exc}"))
        raise
    finally:
        dist.destroy_process_group()


def run_grid(dp, sp, backend, img_path, refs, timeout=600):
    """Spawn the dp * sp ranks of one phase-19 grid and collect each rank's
    results (tools/bench_config4_scale.py spawn_ranks); raises if a rank
    fails or the grid outlasts `timeout` s, and stops every rank it
    started."""
    from go_jpeg2000_tpu_torch.tools.bench_config4_scale import spawn_ranks
    return spawn_ranks(_grid_rank, dp * sp, (dp, sp, backend, img_path, refs),
                       timeout, what=f"phase 19 {backend} {(dp, sp)}")


def row_shard_phase(tp, card, launches, img, refs):
    """Phase 19: config 4 (phase 10's image) on the ROW_SHARD_GRIDS of
    gloo ranks sharing the one card, and on NCCL_GRID with a card a rank
    where there are four: every rank's codestreams byte-identical to phase
    10's (refs: sha256 of its streams and of its lossy decode), lossless
    decodes exact, lossy decodes equal to phase 10's; the halo levels and
    the packing kernel launched, no plain level, every tile through the
    device HT encode and decode; walls and steps printed per rank, the
    ranks' launches added to `launches`."""
    import tempfile
    t0 = time.perf_counter()
    grids = [(dp, sp, "gloo") for dp, sp in ROW_SHARD_GRIDS]
    cards = torch.cuda.device_count()
    if cards >= 4:
        grids.append(NCCL_GRID + ("nccl",))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config4.npy")
        np.save(path, img)
        for dp, sp, backend in grids:
            t1 = time.perf_counter()
            results = run_grid(dp, sp, backend, path, refs)
            where = ("one card" if backend == "gloo"
                     else f"{dp * sp} cards")
            for rank in sorted(results):
                for label, r in results[rank].items():
                    lib = "dwt53" if "lossless" in label else "dwt97"
                    need = (f"{lib}_fwd_level", f"{lib}_inv_level",
                            "dwt_pack_edges", "mct_forward", "mct_inverse")
                    st = r["steps"]
                    same = ("byte-identical to" if r["same_stream"]
                            else "DIFFERS FROM")
                    want = "the input" if lib == "dwt53" else "phase 10's"
                    print(f"phase 19 {backend} (dp, sp) = {(dp, sp)} on "
                          f"{where}, rank {rank}, {label}: codestream "
                          f"{same} phase 10's ({r['bytes']} bytes), decode "
                          f"{'equal to' if r['decode_ok'] else 'NOT EQUAL TO'}"
                          f" {want}; launches {r['launches']}, plain levels "
                          f"{r['plain']}, device HT tiles encode, decode "
                          f"{r['tiles']} of {r['my_tiles']}; wall encode "
                          f"{r['encode_ms']:.1f} ms, decode "
                          f"{r['decode_ms']:.1f} ms (first run); transform "
                          f"step {st['transform']:.2f} ms, of it the edge "
                          f"round trip {st['transform edges']:.2f} ms; "
                          f"inverse step {st['inverse']:.2f} ms, of it the "
                          f"edge round trip {st['inverse edges']:.2f} ms "
                          f"(medians of {STEP_REPS}) [{card}]", flush=True)
                    if not (r["same_stream"] and r["decode_ok"]):
                        raise AssertionError(f"phase 19 {backend} "
                                             f"{(dp, sp)} rank {rank}: "
                                             f"{label} differs from phase 10")
                    if (r["plain"] or r["tiles"] != (r["my_tiles"],) * 2
                            or any(r["launches"].get(k, 0) <= 0
                                   for k in need)):
                        raise AssertionError(f"phase 19 {backend} "
                                             f"{(dp, sp)} rank {rank}: "
                                             f"{label} did not run every "
                                             "level, tile and the packing "
                                             "through the kernels")
                    for k, v in r["launches"].items():
                        launches[k] = launches.get(k, 0) + v
            print(f"phase 19 {backend} {(dp, sp)}: "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
    if cards < 4:
        print(f"phase 19 NCCL (dp, sp) = {NCCL_GRID} over four cards: not "
              f"run ({cards} card{'' if cards == 1 else 's'})", flush=True)
    print(f"phase 19, config 4 on row shards: "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# ------------------------------------------------------ phase 20: the tools

# each tool of go_jpeg2000_tpu_torch/tools and its arguments at a smoke size
TOOL_RUNS = (("profile_stages", ["--path", "ht53", "--reps", "1"]),
             ("profile_stages", ["--path", "ebcot", "--reps", "1"]),
             ("profile_kernel_stages", ["512", "8", "4"]),
             ("bench_config4_scale", ["2048"]),
             ("multihost_scaling", ["--hosts", "1,2"]),
             ("benchmark_compare", ["--sizes", "64,128"]))


def tools_phase(card):
    """Phase 20: every tool's main on the card at TOOL_RUNS' sizes, as a
    user runs `python -m go_jpeg2000_tpu_torch.tools.<name>`; each asserts
    its own exactness, and a tool that raises or returns non-zero fails the
    smoke."""
    import importlib
    t0 = time.perf_counter()
    for name, argv in TOOL_RUNS:
        tool = importlib.import_module(f"go_jpeg2000_tpu_torch.tools.{name}")
        t1 = time.perf_counter()
        if tool.main(argv + ["--device", "cuda"]) != 0:
            raise AssertionError(f"phase 20: {name} {argv} failed")
        print(f"phase 20 {name} {' '.join(argv)}: "
              f"{time.perf_counter() - t1:.1f} s [{card}]", flush=True)
    print(f"phase 20, the tools: {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import go_jpeg2000_tpu_torch as tp
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.native import loader
    from go_jpeg2000_tpu_torch.ops import (band_stats, cuda_build, dwt,
                                           dwt_cuda, ebcot_cuda, ht_dec_cuda,
                                           ht_enc_cuda, mct_cuda)
    from go_jpeg2000_tpu_torch.parallel import sharded as psh

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    cuda_build.build()
    dwt_cuda.load()
    ht_enc_cuda.load()
    ht_dec_cuda.load()
    ebcot_cuda.load()
    band_stats.load()
    mct_cuda.load()
    t1 = time.perf_counter()
    if not loader.available():
        raise RuntimeError("native library j2k_native.cpp did not build")
    t2 = time.perf_counter()
    print(f"build: dwt53.cu, dwt97.cu, dwt_edges.cu, ht_enc.cu, ht_dec.cu, "
          f"ebcot_enc.cu, band_stats.cu and mct.cu (nvcc, in parallel) "
          f"{t1 - t0:.1f} s, "
          f"j2k_native.cpp (g++) {t2 - t1:.1f} s", flush=True)

    err, times = check_kernels(dwt, dwt_cuda, dev, card, dwt.REV53)
    err97, times97 = check_kernels(dwt, dwt_cuda, dev, card, dwt.IRR97)
    err.update(err97)
    times.update(times97)
    for k, e in check_wide_levels(dwt, dwt_cuda, transforms, dev,
                                  card).items():
        err[k] = max(err[k], e)
    err.update(check_mct_grid(transforms, mct_cuda, dev))
    times.update(mct_times(transforms, mct_cuda, dev, card, err))
    mct_config4_steps(transforms, psh, dev, card)
    e, t, library = check_ht_kernels(tp, dev, card)
    err.update(e)
    times.update(t)
    e, t, lib_ms = check_ht_dec_kernels(tp, dev, card)
    err.update(e)
    times.update(t)
    library.update(lib_ms)
    for e in (check_layout_stress(dev), check_layout_classes(tp, dev, card)):
        for k, v in e.items():
            err[k] = max(err[k], v)
    torch.cuda.empty_cache()

    kernels = (dwt_cuda, ht_enc_cuda, ht_dec_cuda)
    launches = {}
    runs = {}
    for label, frames, opts, lib in main_paths(tp):
        (streams, decoded), counts = counted_run(
            tp, kernels, lambda: main_path(tp, dev, label, frames, opts),
            f"{label} main path", lib)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        runs[label] = (frames, opts, streams, decoded)

    for label, (frames, opts, streams, decoded) in runs.items():
        t0 = time.perf_counter()
        if tp.encode_batch(frames, opts, device="cpu") != streams:
            raise AssertionError(f"{label}: CUDA and CPU codestreams differ")
        t1 = time.perf_counter()
        on_cpu = tp.decode_batch(streams, device="cpu")
        if not all(np.array_equal(d, c) for d, c in zip(decoded, on_cpu)):
            raise AssertionError(f"{label}: CUDA and CPU decodes differ")
        print(f"{label}: CUDA and CPU codestreams byte-identical, decodes "
              f"equal (CPU encode {t1 - t0:.1f} s, CPU decode "
              f"{time.perf_counter() - t1:.1f} s)", flush=True)

    for label, (frames, opts, streams, _dec) in runs.items():
        if label != "rgb":
            wall_mpix(tp, opts, frames, streams, dev, card, label)
    for label, reps in (("gray", 3), ("rgb", 3), ("lossy rgb", 1)):
        frames, opts, streams, _dec = runs[label]
        stage_lines(tp, label, frames, opts, streams, dev, card, reps)

    e, t, lib_ms = check_ebcot_kernels(tp, dev, card)
    err.update(e)
    times.update(t)
    library.update(lib_ms)
    torch.cuda.empty_cache()
    ebcot_kernels = (dwt_cuda, ht_enc_cuda, ht_dec_cuda, ebcot_cuda)
    ebcot_runs = {}
    for label, frames in (("EBCOT gray", ebcot_gray()),
                          ("EBCOT rgb", ebcot_rgb())):
        (streams, _decoded), counts = ebcot_counted_run(
            tp, ebcot_kernels,
            lambda: main_path(tp, dev, label, frames, ebcot_opts(tp)),
            f"{label} main path")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ebcot_other_paths(tp, frames, streams, dev, label)
        ebcot_runs[label] = (frames, streams)
    for label, (frames, streams) in ebcot_runs.items():
        ebcot_wall(tp, frames, streams, dev, card, label)
    ebcot_stages(tp, *ebcot_runs["EBCOT gray"], dev, card)
    torch.cuda.empty_cache()

    e, t, lib_ms, c4, refs = sharded_phase(tp, dev, card, launches)
    for k, v in e.items():
        err[k] = max(err.get(k, 0), v)
    times.update(t)
    library.update(lib_ms)

    for k, v in single_image_phase(tp, dev, card, launches).items():
        err[k] = max(err[k], v)

    c2 = config2_phase(tp, dev, card, launches)
    fused_layers_phase(tp, dev, card, launches)
    config5_phase(tp, dev, card, launches)
    dryrun_phase(tp, card, launches)
    decode_options_phase(tp, dev, card, launches, c4, c2)
    err["dwt53_fwd_level"] = max(err["dwt53_fwd_level"], encode_options_phase(
        tp, dev, card, launches, c4))
    for k, v in odd_geometry_phase(tp, dev, card, launches).items():
        err[k] = max(err[k], v)
    row_shard_phase(tp, card, launches, c4[0], refs)
    torch.cuda.empty_cache()
    tools_phase(card)

    out = []
    for name, (replaces, src) in REPLACES.items():
        ms, plain_ms, bound_ms, bound_by = times[name]
        out.append({
            "name": name, "route": "cuda", "source": SRC[src],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(name)})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
