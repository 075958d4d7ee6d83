"""ctypes binding for the native LIBSVM parser (builds on demand).

The shared object is compiled lazily with the system C compiler the first
time it's needed (it is not tracked in git); the pure-Python parser in
data/libsvm.py remains the fallback when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "libsvm_parser.c"
_SO = _HERE / "_libsvm_parser.so"
_lock = threading.Lock()
_lib = None


def _build() -> None:
    """Compile to a private temporary file, then rename it into place:
    concurrent builders (test workers, processes of one checkout) each
    produce a whole library and the last rename wins atomically."""
    cc = os.environ.get("CC", "cc")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    try:
        cmd = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
        lib.libsvm_count.restype = ctypes.c_int
        lib.libsvm_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.libsvm_fill.restype = ctypes.c_int
        lib.libsvm_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return lib


def parse(data: bytes):
    """-> (labels f64, rows i64, cols i64, vals f64); raises on error."""
    lib = _load()
    if not data.endswith(b"\n"):
        data = data + b"\n"
    n_rows = ctypes.c_int64()
    n_nnz = ctypes.c_int64()
    rc = lib.libsvm_count(data, len(data), ctypes.byref(n_rows),
                          ctypes.byref(n_nnz))
    if rc != 0:
        raise ValueError(f"libsvm_count failed: {rc}")
    labels = np.empty(n_rows.value, np.float64)
    rows = np.empty(n_nnz.value, np.int64)
    cols = np.empty(n_nnz.value, np.int64)
    vals = np.empty(n_nnz.value, np.float64)
    rc = lib.libsvm_fill(data, len(data), labels, rows, cols, vals)
    if rc != 0:
        raise ValueError(f"libsvm_fill failed: malformed input ({rc})")
    return labels, rows, cols, vals
