"""Build both native libraries once, before any test module is collected.

Both packages compile their C++ entropy coder (j2k_native.cpp) on first
use: go_jpeg2000_tpu/native/loader.py into go_jpeg2000_tpu/native/, and
go_jpeg2000_tpu_torch/native/loader.py into go_jpeg2000_tpu_torch/_build/.
Under pytest-xdist every worker collects every module, and
tests/test_native.py asks for the library at collection time, so on a
fresh checkout all workers would start the same build at once.  The JAX
package's loader compiles into one shared temporary file; a worker that
loses that race marks its library unavailable for the rest of its life,
and its native tests fail or skip.

This directory's name sorts before every tests/test_*.py, so each worker
imports this conftest before the test modules.  Under an exclusive lock on
a file in the system's temporary directory, named after this checkout,
the first worker builds each library and the others wait, then load the
finished one.  A failed build is reported as a warning; the tests then
fail or skip as they would without this file.
"""
import fcntl
import hashlib
import os
import tempfile
import warnings

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LOCK = os.path.join(tempfile.gettempdir(), "j2k_native_build_%s.lock"
                     % hashlib.sha256(_ROOT.encode()).hexdigest()[:16])


def _build_both():
    from go_jpeg2000_tpu.native import loader as jax_loader
    from go_jpeg2000_tpu_torch.native import loader as torch_loader
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for name, loader in (("go_jpeg2000_tpu", jax_loader),
                                 ("go_jpeg2000_tpu_torch", torch_loader)):
                if not loader.available():
                    warnings.warn(f"{name}: the native library did not "
                                  "build or load; its tests will fail or "
                                  "skip")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_build_both()
