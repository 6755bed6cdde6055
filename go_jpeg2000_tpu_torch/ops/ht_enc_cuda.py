"""Hand-written CUDA kernels of the fused HT encode (csrc/ht_enc.cu).

The port's counterpart of the JAX package's device HT encode program:

  extract_blocks -> ht_extract_blocks, replaces fused_encode._extract_blocks
                    (its slot descriptors, ops/block_layout.py, are kept on
                    the card per plan; the leaves' pointers go by value;
                    with `tiles`, the jnp.take of a class's tiles before it)
  cleanup_fields -> ht_cleanup_pack, replaces ht_tpu.cleanup_fields with
                    its packing (_pack_bits): the fields never leave the
                    kernel, only the three streams' word rows do
  assemble_pool  -> ht_compact_pool, replaces ht_tpu.compact_pool and
                    cleanup_fields_compact

A CPU tensor goes to the plain torch version (models/fused_encode.py
extract_blocks, ops/ht_enc.py).  A CUDA tensor goes to the kernel, or the
call raises: there is no fallback, and a failed build or launch is an
error.  The library is built by ops/cuda_build.py on first use, with the
port's other CUDA sources.

Counts: LAUNCHES[name] goes up by one each time a wrapper launches its
kernel, and only there.  Every launch goes to the device's current stream
(`run`); the extraction uploads its slot descriptors once per plan, so its
wrapper does not wait for the card after a plan's first call.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import block_layout, cuda_build, ht_enc

LAUNCHES: Dict[str, int] = {"ht_extract_blocks": 0, "ht_cleanup_pack": 0,
                            "ht_compact_pool": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """Build (if needed) and bind csrc/ht_enc.cu."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load("ht_enc")
        if (lib.ht_enc_layout_fields() != block_layout.LAYOUT_FIELDS
                or lib.ht_enc_max_leaves() != block_layout.MAX_LEAVES
                or lib.ht_enc_table_size() != ht_enc.direct_enc_table().size):
            raise RuntimeError("csrc/ht_enc.cu and ops/ht_enc_cuda.py "
                               "disagree on the slot layout or VLC table")
        p, i = ctypes.c_void_p, ctypes.c_int
        sigs = {"ht_extract_blocks": [p, p, i, i, i, i, i, i, p, p, p],
                "ht_cleanup_pack": [p, p, p, i, i, i, p] + [p, i, p] * 3
                + [p] * 4,
                "ht_compact_pool": [p, i, p, p, i, p, p, i, p,
                                    p, p, p, i, p, p, p, p]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
        return _lib


def run(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """lib.name(*args, stream) on the current stream of `device`, a CUDA
    device; raises on a CUDA error.  It enters a device context only when
    `device` is not the current device, and takes the raw stream handle
    (torch._C._cuda_getCurrentRawStream, what torch's own compiled kernels
    launch on) rather than a Stream object."""
    index = torch.cuda.current_device()
    if device.index is None or device.index == index:
        rc = getattr(lib, name)(*args,
                                torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device.index):
            rc = getattr(lib, name)(
                *args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _launch(name: str, device: torch.device, *args) -> None:
    run(load(), name, device, *args)
    LAUNCHES[name] += 1


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def band_leaf(pyr, lev: int, name: str, levels: int) -> torch.Tensor:
    """The pyramid leaf [N, C, bh, bw] of one band spec (LL of the top
    level for `name` "LL")."""
    return pyr[block_layout.leaf_level(lev, name, levels)][name]


_LAYOUTS: Dict = {}


def extract_layout(plan, n: int, n_comps: int, levels: int,
                   dev: torch.device):
    """ht_extract_blocks' static half for a plan, cached per (plan, frames,
    components, levels, device): ([(level, band)] of the leaves in launch
    order, [(n, C, bh, bw)] of each leaf, the slot descriptors int32 [nb,
    LAYOUT_FIELDS] on `dev`).  Raises ValueError for a plan the kernel
    cannot take (block_layout.leaves)."""
    def build():
        keys, shapes, desc = block_layout.slot_descriptors(
            plan, n_comps, levels, plan.deltas is not None)
        return (keys, [(n, n_comps, bh, bw) for bh, bw in shapes],
                torch.from_numpy(desc).to(dev))
    return block_layout.plan_cache(_LAYOUTS, plan,
                                   (n, n_comps, levels, dev), build)


def check_tiles(name: str, tiles: Sequence[int], n: int,
                frames: Sequence[int]) -> None:
    """Raise ValueError unless every leaf holds the same number of frames
    (`frames`, one count a leaf) and `tiles` is n frames below it."""
    f = frames[0]
    if (any(x != f for x in frames) or len(tiles) != n
            or any(not 0 <= t < f for t in tiles)):
        raise ValueError(f"{name}: tiles {list(tiles)} for {n} frames of "
                         f"leaves of {sorted(set(frames))} frames")


_TILES: Dict[Tuple, torch.Tensor] = {}


def _tile_index(tiles: Sequence[int], dev: torch.device) -> torch.Tensor:
    """The leaf frames of a batch, int32 [n] on `dev`, made once per
    positions and device."""
    key = (tuple(int(t) for t in tiles), dev)
    index = _TILES.get(key)
    if index is None:
        index = _TILES[key] = torch.tensor(key[0], dtype=torch.int32,
                                           device=dev)
    return index


def extract_blocks(pyr, plan, n: int, levels: int,
                   tiles: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Pyramid leaves -> the block batch int32 [n*nb, cbh, cbw] in canonical
    job order, zero-padded; lossy plans (plan.deltas) quantize on the way.
    Leaves are int32 (5/3) or float32 (9/7) [n, C, bh, bw]; with `tiles`,
    n host positions, the leaves hold any equal number of frames and frame
    f of the batch is leaf frame tiles[f] (check_tiles: ValueError unless
    each lies below it).  On the card nothing is copied to or from the host
    after a plan's first call: the slot descriptors and the tile index stay
    there, and the leaves' pointers go to the kernel by value."""
    spec = plan.band_specs[0]
    first = band_leaf(pyr, spec[1], spec[2], levels)
    dev = first.device
    if dev.type == "cpu":
        from ..models import fused_encode
        return fused_encode.extract_blocks(pyr, plan, n, levels, tiles)
    name = "ht_extract_blocks"
    keys, shapes, desc = extract_layout(plan, n, first.shape[1], levels, dev)
    dtype = torch.float32 if plan.deltas is not None else torch.int32
    if tiles is not None:
        check_tiles(name, tiles, n, [pyr[lv][band].shape[0]
                                     for lv, band in keys])
    # the leaves (a strided one copied) stay referenced until the launch
    leaves, ptrs = [], []
    for (lv, band), shape in zip(keys, shapes):
        leaf = pyr[lv][band]
        if not leaf.is_contiguous():
            leaf = leaf.contiguous()
        if ((tiles is None and leaf.shape[0] != n)
                or leaf.shape[1:] != shape[1:]
                or leaf.dtype != dtype or leaf.get_device() != dev.index):
            raise ValueError(f"{name}: leaf {band} of level {lv + 1} is "
                             f"{leaf.dtype} {tuple(leaf.shape)} on "
                             f"{leaf.device}, the plan wants {dtype} "
                             f"{shape} on {dev}")
        leaves.append(leaf)
        ptrs.append(leaf.data_ptr())
    index = None if tiles is None else _tile_index(tiles, dev)
    out = torch.empty((n * plan.nb, plan.cbh, plan.cbw), dtype=torch.int32,
                      device=dev)
    if n:
        _launch(name, dev, desc.data_ptr(), (ctypes.c_void_p * len(ptrs))(
            *ptrs), len(ptrs), n, plan.nb, plan.cbh, plan.cbw,
            int(dtype == torch.float32),
            None if index is None else index.data_ptr(), out.data_ptr())
    return out


def cleanup_shape_supported(h: int, w: int) -> bool:
    """Whether ht_cleanup_pack takes h x w blocks: every padded code-block
    shape, even h and w of at most 1024 each with h * w <= 4096 (the block,
    its quad words and the three stream rows fit in shared memory)."""
    return (h > 0 and w > 0 and h % 2 == 0 and w % 2 == 0 and h <= 1024
            and w <= 1024 and h * w <= 4096)


def cleanup_fields(blocks: torch.Tensor, hs, ws, max_mn: int
                   ) -> Dict[str, torch.Tensor]:
    """The HT cleanup pass of int32 blocks [Nb, H, W] (H, W even) with true
    sizes hs, ws [Nb], its three streams packed, as ht_enc.cleanup_fields
    gives it: {ms,vlc,mel}_words int32 [Nb, W] (uint32 bit patterns, zero
    past the stream; W from ht_enc.stream_words with max_mn) and _bits
    [Nb], numbps, u_max, dist.  max_mn (1 to 32) bounds the MagSgn field
    bits; a row's bits past its words are dropped on the card (the plain
    version raises)."""
    if blocks.device.type == "cpu":
        return ht_enc.cleanup_fields(blocks, hs, ws, max_mn)
    name = "ht_cleanup_pack"
    dev = blocks.device
    _check(blocks, name, torch.int32, 3, dev)
    nb, h, w = blocks.shape
    if (not cleanup_shape_supported(h, w) or blocks.data_ptr() % 16
            or not 1 <= max_mn <= 32):
        raise ValueError(f"{name}: blocks {tuple(blocks.shape)} with max_mn "
                         f"{max_mn} not supported (even sizes of at most "
                         "1024, at most 4096 samples, 16-byte aligned; "
                         "max_mn 1 to 32)")
    hs = torch.as_tensor(hs, dtype=torch.int32, device=dev).contiguous()
    ws = torch.as_tensor(ws, dtype=torch.int32, device=dev).contiguous()
    if hs.shape != (nb,) or ws.shape != (nb,):
        raise ValueError(f"{name}: hs, ws must be [{nb}]")
    out, args = {}, []
    for stream, n_words in zip(("ms", "vlc", "mel"),
                               ht_enc.stream_words(h, w, max_mn)):
        words = out[f"{stream}_words"] = torch.empty(
            (nb, n_words), dtype=torch.int32, device=dev)
        bits = out[f"{stream}_bits"] = torch.empty(nb, dtype=torch.int32,
                                                   device=dev)
        args += [words.data_ptr(), n_words, bits.data_ptr()]
    out["numbps"] = torch.empty(nb, dtype=torch.int32, device=dev)
    out["u_max"] = torch.empty(nb, dtype=torch.int32, device=dev)
    out["dist"] = torch.empty(nb, dtype=torch.float32, device=dev)
    if nb:
        tbl = ht_enc.enc_table(dev, torch.int32)
        _launch(name, dev, blocks.data_ptr(), hs.data_ptr(), ws.data_ptr(),
                nb, h, w, tbl.data_ptr(), *args,
                *(out[k].data_ptr() for k in ("numbps", "u_max", "dist")))
    return out


def assemble_pool(ms_words, ms_bits, vlc_words, vlc_bits, mel_words,
                  mel_bits, numbps, u_max, dist):
    """One int32 array [6*Nb meta | MagSgn | VLC | MEL] and the pools' word
    totals int64 [3] (ht_enc.assemble_pool).  On the card the array is
    allocated at its bound, Nb * (6 + the three row widths); only its
    first 6*Nb + sum(totals) entries are written."""
    if ms_words.device.type == "cpu":
        return ht_enc.assemble_pool(ms_words, ms_bits, vlc_words, vlc_bits,
                                    mel_words, mel_bits, numbps, u_max, dist)
    name = "ht_compact_pool"
    dev = ms_words.device
    nb = ms_words.shape[0]
    for w in (ms_words, vlc_words, mel_words):
        _check(w, name, torch.int32, 2, dev)
        if w.shape[0] != nb:
            raise ValueError(f"{name}: word rows disagree")
    for t in (ms_bits, vlc_bits, mel_bits, numbps, u_max):
        _check(t, name, torch.int32, 1, dev)
    _check(dist, name, torch.float32, 1, dev)
    widths = [int(w.shape[1]) for w in (ms_words, vlc_words, mel_words)]
    out = torch.empty(nb * (6 + sum(widths)), dtype=torch.int32, device=dev)
    offs = torch.empty(3 * nb, dtype=torch.int64, device=dev)
    # the scan writes the totals; zeros only where no kernel runs
    totals = (torch.empty if nb else torch.zeros)(3, dtype=torch.int64,
                                                  device=dev)
    if nb:
        _launch(name, dev, ms_words.data_ptr(), widths[0],
                ms_bits.data_ptr(), vlc_words.data_ptr(), widths[1],
                vlc_bits.data_ptr(), mel_words.data_ptr(), widths[2],
                mel_bits.data_ptr(), numbps.data_ptr(), u_max.data_ptr(),
                dist.data_ptr(), nb, offs.data_ptr(), totals.data_ptr(),
                out.data_ptr())
    return out, totals


def pool_stress_cases() -> Dict[str, Tuple[np.ndarray, ...]]:
    """assemble_pool's inputs at the pool kernels' edges, as numpy arrays in
    its argument order (ms_words, ms_bits, vlc_words, vlc_bits, mel_words,
    mel_bits, numbps, u_max, dist): row widths off 4 words and multiples of
    4; rows whose bits fill them exactly; rows of 0 bits, and a batch
    where every row is empty; MagSgn rows far longer than one step of a
    warp's copy (2 KB); a single row; and more rows than the scan stages at
    a time (8192), a multiple of neither a round nor a copy CTA's rows."""
    rng = np.random.RandomState(2)

    def case(nb, widths, fill=None, empty=0.2):
        out = []
        for w in widths:
            words = rng.randint(-2 ** 31, 2 ** 31, (nb, w), dtype=np.int64)
            bits = (rng.randint(0, 32 * w + 1, nb) if fill is None
                    else np.full(nb, 32 * w))
            bits[rng.rand(nb) < empty] = 0
            out += [words.astype(np.int32), bits.astype(np.int32)]
        return tuple(out) + (rng.randint(0, 30, nb).astype(np.int32),
                             rng.randint(0, 99, nb).astype(np.int32),
                             rng.rand(nb).astype(np.float32))

    return {"odd_widths": case(37, (7, 3, 1)),
            "aligned_widths": case(45, (8, 4, 4)),
            "full_rows": case(19, (13, 6, 2), fill=True, empty=0.0),
            "all_empty": case(11, (9, 3, 2), empty=1.0),
            "long_rows": case(9, (1200, 40, 5), fill=True, empty=0.1),
            "single": case(1, (5, 2, 1)),
            "two_rounds": case(8192 + 8 * 3 + 5, (2, 1, 1))}
