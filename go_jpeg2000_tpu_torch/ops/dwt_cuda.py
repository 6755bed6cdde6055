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
Each also takes the halo rows of a row shard (`above`, `below`: the rows
of the globally extended signal just outside it, built by
parallel/sharded.py), the form that stands for the JAX package's row-shard
lifting (go_jpeg2000_tpu/parallel/sharded.py, _vlift53_sharded,
_vlift97_sharded and their inverses), at an even origin and even sizes
only: parallel/sharded.py calls at origin 0.

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
                            "dwt97_fwd_level": 0, "dwt97_inv_level": 0}
PLAIN_LEVELS = 0

BUILD_DIR = cuda_build.BUILD_DIR
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
    """Kernel eligibility for one level.  Without halo rows every level
    takes the kernels: any origin parity, any size (a 1-sample axis takes
    Annex F's rule, an empty one launches nothing).  A level of a row shard
    (`halo`: rows above or below, parallel/sharded.py, which calls only at
    origin 0) keeps the even rule: even origin and even sizes of at least
    2; other halo levels take the plain halo lifting.  `kind` and `inverse`
    name the kernel and are kept for the callers."""
    if not halo:
        return True
    return not ((u0 & 1) or (v0 & 1) or (h & 1) or (w & 1) or h < 2
                or w < 2)


def build() -> Dict[str, str]:
    """Compile every csrc/*.cu library that _build/ lacks (ops/cuda_build.py:
    one nvcc per source, all started together); returns {library name:
    path} for the DWT libraries."""
    paths = cuda_build.build()
    return {name: paths[name] for name in _LIBS}


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
            for fn in (f"{name}_fwd_level", f"{name}_inv_level"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = [p] * 7 + [i] * 5 + [p]
            libs[name] = lib
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


def _halo_ptr(t, name: str, dtype: torch.dtype, shape, device) -> int:
    """The device pointer of a halo input (None: a global edge, NULL)."""
    if t is None:
        return None
    _check_cuda(t, name, dtype)
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: halo {tuple(t.shape)} on {t.device}, "
                         f"expected {shape} on {device}")
    return t.data_ptr()


def _halo_level(name: str, above, below, h: int, w: int, u0: int,
                v0: int) -> None:
    """A level with halo rows must have the even geometry its kernels take
    in that form (usable)."""
    if (above is not None or below is not None) and not usable(
            h, w, u0, v0, halo=True):
        raise ValueError(f"{name}: halo rows need an even origin and even "
                         f"sizes of at least 2, got {(h, w)} at {(u0, v0)}")


def _forward(x: torch.Tensor, kind: str, above=None, below=None, u0: int = 0,
             v0: int = 0) -> Dict[str, torch.Tensor]:
    lib = _LIB_OF_KIND[kind]
    name = f"{lib}_fwd_level"
    h, w = x.shape[-2:]
    if x.device.type == "cpu":
        if above is None and below is None:
            return dwt.forward_2d(x, kind, u0=u0, v0=v0)
        return dwt.forward_2d_halo(x, kind, above, below)
    _halo_level(name, above, below, h, w, u0, v0)
    dtype = _LIBS[lib][2]
    _check_cuda(x, name, dtype)
    n = x.shape[0]
    a, b = dwt.HALO_DEPTH[(kind, False)]
    halos = (_halo_ptr(above, name, dtype, (n, a, w), x.device),
             _halo_ptr(below, name, dtype, (n, b, w), x.device))
    shapes = dwt.subband_shapes(h, w, 1, u0, v0)[0]
    bands = {k: torch.empty((n,) + shapes[k], dtype=x.dtype, device=x.device)
             for k in ("LL", "HL", "LH", "HH")}
    if n and h and w:
        _launch(lib, name, x.device, x.data_ptr(), *halos,
                bands["LL"].data_ptr(), bands["HL"].data_ptr(),
                bands["LH"].data_ptr(), bands["HH"].data_ptr(), n, h, w,
                u0 & 1, v0 & 1)
    return bands


def _inverse(bands: Dict[str, torch.Tensor], kind: str, above=None,
             below=None, u0: int = 0, v0: int = 0) -> torch.Tensor:
    lib = _LIB_OF_KIND[kind]
    name = f"{lib}_inv_level"
    ll = bands["LL"]
    h = ll.shape[-2] + bands["LH"].shape[-2]
    w = ll.shape[-1] + bands["HL"].shape[-1]
    if ll.device.type == "cpu":
        if above is None and below is None:
            return dwt.inverse_2d(bands, kind, u0=u0, v0=v0)
        return dwt.inverse_2d_halo(bands, kind, above, below)
    _halo_level(name, above, below, h, w, u0, v0)
    dtype = _LIBS[lib][2]
    n = ll.shape[0]
    shapes = dwt.subband_shapes(h, w, 1, u0, v0)[0]
    for k in ("LL", "HL", "LH", "HH"):
        _check_cuda(bands[k], name, dtype)
        if (tuple(bands[k].shape) != (n,) + shapes[k]
                or bands[k].device != ll.device):
            raise ValueError(f"{name}: band {k} {tuple(bands[k].shape)} on "
                             f"{bands[k].device} is not one of a level of "
                             f"{(n, h, w)} at origin parity "
                             f"{(u0 & 1, v0 & 1)} on {ll.device}")
    a, b = dwt.HALO_DEPTH[(kind, True)]
    halos = (_halo_ptr(above, name, dtype, (n, a, w), ll.device),
             _halo_ptr(below, name, dtype, (n, b, w), ll.device))
    out = torch.empty((n, h, w), dtype=ll.dtype, device=ll.device)
    if n and h and w:
        _launch(lib, name, ll.device, ll.data_ptr(),
                bands["HL"].data_ptr(), bands["LH"].data_ptr(),
                bands["HH"].data_ptr(), *halos, out.data_ptr(), n, h, w,
                u0 & 1, v0 & 1)
    return out


def forward_2d_53(x: torch.Tensor, above=None, below=None, u0: int = 0,
                  v0: int = 0) -> Dict[str, torch.Tensor]:
    """One 2-D forward 5/3 level of x [N, H, W] int32 at origin (u0, v0).
    Returns {LL, HL, LH, HH} at the sizes of dwt.subband_shapes (each
    [N, H/2, W/2] at an even origin and size).  For a row shard (even
    origin and sizes), `above` [N, 2, W] and `below` [N, 1, W] are its halo
    rows (dwt.forward_2d_halo); None at a global edge."""
    return _forward(x, dwt.REV53, above, below, u0, v0)


def inverse_2d_53(bands: Dict[str, torch.Tensor], above=None, below=None,
                  u0: int = 0, v0: int = 0) -> torch.Tensor:
    """One 2-D inverse 5/3 level at origin (u0, v0): {LL, HL, LH, HH} int32
    at the sizes of dwt.subband_shapes -> [N, H, W].  For a row shard,
    `above` [N, 1, W] and `below` [N, 2, W] are its halo rows in
    dwt.pair_rows' layout."""
    return _inverse(bands, dwt.REV53, above, below, u0, v0)


def forward_2d_97(x: torch.Tensor, above=None, below=None, u0: int = 0,
                  v0: int = 0) -> Dict[str, torch.Tensor]:
    """One 2-D forward 9/7 level of x [N, H, W] float32 at origin (u0, v0).
    Returns {LL, HL, LH, HH} at the sizes of dwt.subband_shapes.  For a row
    shard, `above` [N, 4, W] and `below` [N, 3, W] are its halo rows."""
    return _forward(x, dwt.IRR97, above, below, u0, v0)


def inverse_2d_97(bands: Dict[str, torch.Tensor], above=None, below=None,
                  u0: int = 0, v0: int = 0) -> torch.Tensor:
    """One 2-D inverse 9/7 level at origin (u0, v0): {LL, HL, LH, HH}
    float32 at the sizes of dwt.subband_shapes -> [N, H, W].  For a row
    shard, `above` [N, 3, W] and `below` [N, 4, W] are its halo rows in
    dwt.pair_rows' layout."""
    return _inverse(bands, dwt.IRR97, above, below, u0, v0)
