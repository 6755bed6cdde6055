"""Hand-written CUDA kernels for one 2-D DWT level (csrc/dwt53.cu, dwt97.cu).

The port's counterpart of go_jpeg2000_tpu/ops/dwt_pallas.py:

  forward_2d_53 -> dwt53_fwd_level, replaces _dwt53_level_kernel
  inverse_2d_53 -> dwt53_inv_level, replaces _idwt53_level_kernel
  forward_2d_97 -> dwt97_fwd_level, replaces _dwt97_level_kernel
  inverse_2d_97 -> dwt97_inv_level, replaces _idwt97_level_kernel

Each takes a level at any origin (u0, v0) and of any size: the kernels
work in a pair frame anchored at even global coordinates, so the origin's
parity only moves the level's first column and row within it, and band
sizes are those of dwt.subband_shapes (an empty level launches nothing).
Each also takes a row shard (`edges`, `rank`: shard `rank` of sp =
edges.shape[0] shards of one signal, edges [sp, N, E, W] every shard's
edge slot), the form that stands for the JAX package's row-shard lifting
(go_jpeg2000_tpu/parallel/sharded.py, _vlift53_sharded, _vlift97_sharded
and their inverses), at an even origin and an even height, any width:
parallel/sharded.py calls at origin 0.  The kernels read the rows beyond
the shard from `edges` themselves (csrc/dwt_edges.cuh).  pack_edges fills
a shard's slot, one launch (csrc/dwt_edges.cu, dwt_pack_edges; it stands
for the send side of the JAX package's ppermute exchanges,
_odd_update_sharded and _even_update_sharded).

A CPU tensor goes to the plain torch lifting in ops/dwt.py.  A CUDA tensor
goes to the kernel, or the call raises: there is no fallback, and a failed
build or launch is an error.

Each source is compiled with nvcc on first use into
go_jpeg2000_tpu_torch/_build/ by ops/cuda_build.py (keyed by a hash of the
source and flags; every source of the port builds in parallel, one nvcc
each) and bound with ctypes; nothing is built when this module is
imported.

Counts: LAUNCHES[name] goes up by one each time a kernel is launched, and
only there; PLAIN_LEVELS counts levels of CUDA tensors that took the plain
version because `usable` refused them (models/transforms.py).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from . import cuda_build, dwt

# output rows per strip of each kernel, by (kind, inverse), and halo rows
# per kind: must equal FWD_STRIP, INV_STRIP and HALO in csrc/dwt53.cu and
# csrc/dwt97.cu (checked when the library loads)
STRIP_ROWS = {(dwt.REV53, False): 32, (dwt.REV53, True): 32,
              (dwt.IRR97, False): 32, (dwt.IRR97, True): 32}
HALO_ROWS = {dwt.REV53: 3, dwt.IRR97: 7}

LAUNCHES: Dict[str, int] = {"dwt53_fwd_level": 0, "dwt53_inv_level": 0,
                            "dwt97_fwd_level": 0, "dwt97_inv_level": 0,
                            "dwt_pack_edges": 0}
PLAIN_LEVELS = 0

BUILD_DIR = cuda_build.BUILD_DIR
# the edge packing kernel's library (csrc/dwt_edges.cu)
_EDGES_LIB = "dwt_edges"
NVCC_FLAGS = cuda_build.NVCC_FLAGS
# library name -> (source, kind, sample dtype)
_LIBS = {"dwt53": ("dwt53.cu", dwt.REV53, torch.int32),
         "dwt97": ("dwt97.cu", dwt.IRR97, torch.float32)}
_LIB_OF_KIND = {kind: name for name, (_s, kind, _t) in _LIBS.items()}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    global PLAIN_LEVELS
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_LEVELS = 0


def count_plain_level() -> None:
    global PLAIN_LEVELS
    PLAIN_LEVELS += 1


def usable(h: int, w: int, u0: int, v0: int, kind: str = dwt.REV53,
           inverse: bool = False, halo: bool = False) -> bool:
    """Kernel eligibility for one level.  Outside a row shard every level
    takes the kernels: any origin parity, any size (a 1-sample axis takes
    Annex F's rule, an empty one launches nothing).  A level of a row shard
    (`halo`: edges given, parallel/sharded.py, which calls only at origin
    0) takes them at an even origin and an even height of at least 2, any
    width: the geometry the halo form is defined for, the plain one
    (dwt.forward_2d_halo) too, and which parallel/sharded.py's grid gate
    gives every level.  `kind` and `inverse` name the kernel and are kept
    for the callers."""
    if not halo:
        return True
    return not ((u0 & 1) or (v0 & 1) or (h & 1) or h < 2)


def build() -> Dict[str, str]:
    """Compile every csrc/*.cu library that _build/ lacks (ops/cuda_build.py:
    one nvcc per source, all started together); returns {library name:
    path} for the DWT libraries."""
    paths = cuda_build.build()
    return {name: paths[name] for name in tuple(_LIBS) + (_EDGES_LIB,)}


def load() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and bind every DWT kernel library."""
    with _lock:
        if _libs:
            return _libs
        libs = {}
        for name in _LIBS:
            lib = cuda_build.load(name)
            kind = _LIBS[name][1]
            strips = (getattr(lib, f"{name}_fwd_strip_rows")(),
                      getattr(lib, f"{name}_inv_strip_rows")())
            if (strips != (STRIP_ROWS[(kind, False)],
                           STRIP_ROWS[(kind, True)])
                    or getattr(lib, f"{name}_halo_rows")()
                    != HALO_ROWS[kind]
                    or getattr(lib, f"{name}_fwd_above")()
                    != dwt.HALO_DEPTH[(kind, False)][0]
                    or getattr(lib, f"{name}_inv_above")()
                    != dwt.HALO_DEPTH[(kind, True)][0]):
                raise RuntimeError(f"csrc/{_LIBS[name][0]} and "
                                   f"ops/dwt_cuda.py disagree on STRIP/HALO")
            p = ctypes.c_void_p
            i = ctypes.c_int
            getattr(lib, f"{name}_fwd_level").argtypes = (
                [p, p] + [i] * 3 + [p] * 4 + [i] * 5 + [p])
            getattr(lib, f"{name}_inv_level").argtypes = (
                [p] * 5 + [i] * 3 + [p] + [i] * 5 + [p])
            for fn in (f"{name}_fwd_level", f"{name}_inv_level"):
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        lib = cuda_build.load(_EDGES_LIB)
        if lib.dwt_edge_rows() != dwt.EDGE_ROWS:
            raise RuntimeError("csrc/dwt_edges.cuh and ops/dwt.py disagree "
                               "on EDGE_ROWS")
        lib.dwt_pack_edges.restype = ctypes.c_int
        lib.dwt_pack_edges.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        libs[_EDGES_LIB] = lib
        _libs.update(libs)
        return _libs


def _check_cuda(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dtype} [N, H, W] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _launch(lib_name: str, name: str, device: torch.device, *args) -> None:
    lib = load()[lib_name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_halo(name: str, h: int, w: int, u0: int, v0: int) -> None:
    """A row shard's level needs the geometry the halo form is defined for
    (usable), on the card and on the CPU alike."""
    if not usable(h, w, u0, v0, halo=True):
        raise ValueError(f"{name}: halo rows need an even origin and an "
                         f"even height of at least 2, got {(h, w)} at "
                         f"{(u0, v0)}")


def _edges_args(edges, rank, name: str, dtype: torch.dtype, n: int, h: int,
                w: int, device):
    """(pointer, sp, rank, E) of a row shard's edges for a level kernel
    (NULL, 1, 0, 0 outside a row shard): one slot of dwt.edge_count(h) rows
    per shard, and 0 <= rank < sp."""
    if edges is None:
        return None, 1, 0, 0
    e = dwt.edge_count(h)
    if (edges.device.type != "cuda" or edges.dtype != dtype
            or not edges.is_contiguous() or edges.dim() != 4
            or tuple(edges.shape[1:]) != (n, e, w) or edges.device != device
            or not 0 <= rank < edges.shape[0]):
        raise ValueError(f"{name}: edges {edges.dtype} "
                         f"{tuple(edges.shape)} on {edges.device} for shard "
                         f"{rank}, expected a contiguous {dtype} [sp, {n}, "
                         f"{e}, {w}] on {device}")
    return edges.data_ptr(), edges.shape[0], rank, e


def _forward(x: torch.Tensor, kind: str, edges=None, rank: int = 0,
             u0: int = 0, v0: int = 0) -> Dict[str, torch.Tensor]:
    lib = _LIB_OF_KIND[kind]
    name = f"{lib}_fwd_level"
    h, w = x.shape[-2:]
    if edges is not None:
        _check_halo(name, h, w, u0, v0)
    if x.device.type == "cpu":
        if edges is None:
            return dwt.forward_2d(x, kind, u0=u0, v0=v0)
        return dwt.forward_2d_halo(x, kind, edges, rank)
    dtype = _LIBS[lib][2]
    n = x.shape[0]
    shard = _edges_args(edges, rank, name, dtype, n, h, w, x.device)
    _check_cuda(x, name, dtype)
    shapes = dwt.subband_shapes(h, w, 1, u0, v0)[0]
    bands = {k: torch.empty((n,) + shapes[k], dtype=x.dtype, device=x.device)
             for k in ("LL", "HL", "LH", "HH")}
    if n and h and w:
        _launch(lib, name, x.device, x.data_ptr(), *shard,
                bands["LL"].data_ptr(), bands["HL"].data_ptr(),
                bands["LH"].data_ptr(), bands["HH"].data_ptr(), n, h, w,
                u0 & 1, v0 & 1)
    return bands


def _inverse(bands: Dict[str, torch.Tensor], kind: str, edges=None,
             rank: int = 0, u0: int = 0, v0: int = 0) -> torch.Tensor:
    lib = _LIB_OF_KIND[kind]
    name = f"{lib}_inv_level"
    ll = bands["LL"]
    h = ll.shape[-2] + bands["LH"].shape[-2]
    w = ll.shape[-1] + bands["HL"].shape[-1]
    if edges is not None:
        _check_halo(name, h, w, u0, v0)
    if ll.device.type == "cpu":
        if edges is None:
            return dwt.inverse_2d(bands, kind, u0=u0, v0=v0)
        return dwt.inverse_2d_halo(bands, kind, edges, rank)
    dtype = _LIBS[lib][2]
    n = ll.shape[0]
    shard = _edges_args(edges, rank, name, dtype, n, h, w, ll.device)
    _check_bands(bands, name, dtype, n, h, w, u0, v0)
    out = torch.empty((n, h, w), dtype=ll.dtype, device=ll.device)
    if n and h and w:
        _launch(lib, name, ll.device, ll.data_ptr(),
                bands["HL"].data_ptr(), bands["LH"].data_ptr(),
                bands["HH"].data_ptr(), *shard, out.data_ptr(), n, h, w,
                u0 & 1, v0 & 1)
    return out


def _check_bands(bands, name: str, dtype: torch.dtype, n: int, h: int,
                 w: int, u0: int, v0: int) -> None:
    """The four bands of a level of [n, h, w] at origin (u0, v0): CUDA
    tensors of `dtype` at dwt.subband_shapes' sizes on one device."""
    shapes = dwt.subband_shapes(h, w, 1, u0, v0)[0]
    dev = bands["LL"].device
    for k in ("LL", "HL", "LH", "HH"):
        _check_cuda(bands[k], name, dtype)
        if tuple(bands[k].shape) != (n,) + shapes[k] or bands[k].device != dev:
            raise ValueError(f"{name}: band {k} {tuple(bands[k].shape)} on "
                             f"{bands[k].device} is not one of a level of "
                             f"{(n, h, w)} at origin parity "
                             f"{(u0 & 1, v0 & 1)} on {dev}")


def pack_edges(src, out=None) -> torch.Tensor:
    """A row shard's edge slot [N, E, W] (dwt.pack_edges): a forward level's
    rows [N, h, W] (a tensor) -> their first and last dwt.EDGE_ROWS rows,
    or all when h <= 2 * EDGE_ROWS; an inverse level's bands {LL, HL, LH,
    HH} (a dict; LL and LH ceil(W/2) wide, HL and HH floor(W/2)) -> the
    same rows of the interleaved level in dwt.pair_rows' layout.  h even,
    W any.  Written into `out` (a slot of an [sp, N, E, W]
    tensor) when given.  One launch of dwt_pack_edges on the card; the
    plain version on the CPU."""
    pairs = isinstance(src, dict)
    first = src["LL"] if pairs else src
    if first.device.type == "cpu":
        return dwt.pack_edges(src, out)
    name = "dwt_pack_edges"
    if pairs:
        n, h2, _ = first.shape
        h, w = 2 * h2, first.shape[-1] + src["HL"].shape[-1]
        _check_bands(src, name, first.dtype, n, h, w, 0, 0)
        ptrs = [src[k].data_ptr() for k in ("LL", "HL", "LH", "HH")]
    else:
        _check_cuda(first, name, first.dtype)
        n, h, w = first.shape
        ptrs = [first.data_ptr(), None, None, None]
    if first.element_size() != 4 or not usable(h, w, 0, 0, halo=True):
        raise ValueError(f"{name}: a halo level of 4-byte samples and an "
                         f"even height of at least 2, got {first.dtype} "
                         f"{(h, w)}")
    e = dwt.edge_count(h)
    if out is None:
        out = torch.empty((n, e, w), dtype=first.dtype, device=first.device)
    elif (tuple(out.shape) != (n, e, w) or out.dtype != first.dtype
          or out.device != first.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}, expected a contiguous "
                         f"{first.dtype} {(n, e, w)} on {first.device}")
    if n:
        _launch(_EDGES_LIB, name, first.device, *ptrs, out.data_ptr(), n, h,
                w, e, int(pairs))
    return out


def forward_2d_53(x: torch.Tensor, edges=None, rank: int = 0, u0: int = 0,
                  v0: int = 0) -> Dict[str, torch.Tensor]:
    """One 2-D forward 5/3 level of x [N, H, W] int32 at origin (u0, v0).
    Returns {LL, HL, LH, HH} at the sizes of dwt.subband_shapes (each
    [N, H/2, W/2] at an even origin and size).  For row shard `rank` of a
    signal (even origin and height), `edges` [sp, N, E, W] holds every
    shard's pack_edges (dwt.forward_2d_halo)."""
    return _forward(x, dwt.REV53, edges, rank, u0, v0)


def inverse_2d_53(bands: Dict[str, torch.Tensor], edges=None, rank: int = 0,
                  u0: int = 0, v0: int = 0) -> torch.Tensor:
    """One 2-D inverse 5/3 level at origin (u0, v0): {LL, HL, LH, HH} int32
    at the sizes of dwt.subband_shapes -> [N, H, W].  For row shard `rank`,
    `edges` [sp, N, E, W] holds every shard's pack_edges of its bands
    (dwt.inverse_2d_halo)."""
    return _inverse(bands, dwt.REV53, edges, rank, u0, v0)


def forward_2d_97(x: torch.Tensor, edges=None, rank: int = 0, u0: int = 0,
                  v0: int = 0) -> Dict[str, torch.Tensor]:
    """One 2-D forward 9/7 level of x [N, H, W] float32 at origin (u0, v0).
    Returns {LL, HL, LH, HH} at the sizes of dwt.subband_shapes.  For row
    shard `rank`, `edges` as forward_2d_53's."""
    return _forward(x, dwt.IRR97, edges, rank, u0, v0)


def inverse_2d_97(bands: Dict[str, torch.Tensor], edges=None, rank: int = 0,
                  u0: int = 0, v0: int = 0) -> torch.Tensor:
    """One 2-D inverse 9/7 level at origin (u0, v0): {LL, HL, LH, HH}
    float32 at the sizes of dwt.subband_shapes -> [N, H, W].  For row shard
    `rank`, `edges` as inverse_2d_53's."""
    return _inverse(bands, dwt.IRR97, edges, rank, u0, v0)
