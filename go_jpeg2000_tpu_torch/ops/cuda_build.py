"""nvcc builds of the port's CUDA sources (go_jpeg2000_tpu_torch/csrc/*.cu).

Each source compiles into a shared library with a plain C interface, bound
with ctypes by its wrapper module (ops/dwt_cuda.py, ops/ht_enc_cuda.py,
ops/ht_dec_cuda.py, ops/ebcot_cuda.py, ops/band_stats.py,
ops/mct_cuda.py).
The libraries go into go_jpeg2000_tpu_torch/_build/, named by a hash of the
source, the headers of csrc/ and the flags, so a library built from the
same source is reused.
The first `load` builds every source that _build/ lacks, one nvcc process
per source, all started together.  Nothing is built when this module is
imported, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
# library name -> source file under csrc/
SOURCES = {"dwt53": "dwt53.cu", "dwt97": "dwt97.cu",
           "dwt_edges": "dwt_edges.cu", "ht_enc": "ht_enc.cu",
           "ht_dec": "ht_dec.cu", "ebcot_enc": "ebcot_enc.cu",
           "band_stats": "band_stats.cu", "mct": "mct.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def so_path(name: str) -> str:
    h = hashlib.sha256()
    # the source and every header of csrc/ (row_copy.cuh and dwt_edges.cuh
    # are shared)
    for path in [os.path.join(CSRC, SOURCES[name])] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def build() -> Dict[str, str]:
    """Compile every library that _build/ lacks, one nvcc per source, all
    started together; returns {library name: path}."""
    paths = {name: so_path(name) for name in SOURCES}
    procs = []
    for name, so in paths.items():
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        src = os.path.join(CSRC, SOURCES[name])
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((src, so, tmp, subprocess.Popen(
            [nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, so, tmp, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{err}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library `name`; the first call builds every source."""
    with _lock:
        if not _libs:
            for lib, so in build().items():
                _libs[lib] = ctypes.CDLL(so)
        return _libs[name]
