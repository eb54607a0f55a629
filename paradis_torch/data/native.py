"""ctypes bindings for the port's native host-ops library (``csrc/host_ops.cpp``).

The port's own copy of ``paradis_tpu/data/native.py`` over its own copy of
the source (``paradis_torch/csrc/host_ops.cpp``, which opens libzstd at run
time).  ``g++`` builds it on first use into
``paradis_torch/_build/libparadis_host-<hash>.so``, the hash covering the
source and the flags as ``paradis_torch/_build.py`` names the CUDA libraries;
it compiles to a temporary name and renames it into place, so processes that
build at once never load half a file.  Nothing builds at import.

Where no compiler or zlib is found, ``get_lib()`` returns None and every
caller degrades to the pure-Python / numpy implementations (hosts without a
toolchain still read stores, slowly: Blosc-LZ4 through the pure-Python LZ4
decoder).  ``require()`` asks for the library strictly and raises with the
compiler's output: a training host should call it, since without the
library the decoder, not the card, would set the loop's pace.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("paradis_torch")

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = _PKG_DIR / "csrc" / "host_ops.cpp"
_BUILD_DIR = _PKG_DIR / "_build"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LINK = ("-lz", "-ldl", "-pthread")

_lib = None
_error: Exception | None = None
_lock = threading.Lock()

U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_CXX_FLAGS + _LINK).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libparadis_host-{digest}.so"


def build(force: bool = False) -> Path:
    """Compile the shared library unless it is built; returns its path.

    Raises ``RuntimeError`` with the compiler's output when the build fails
    (``FileNotFoundError`` without ``g++``).
    """
    path = _lib_path()
    if path.is_file() and not force:
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp), *_LINK]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native host library failed (rc "
                           f"{res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a reader never sees half a file
    return path


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.zlib_decode_many.restype = ctypes.c_int
    lib.zlib_decode_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.zscore_normalize_inplace.restype = None
    lib.zscore_normalize_inplace.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
    ]
    lib.bitround_inplace.restype = None
    lib.bitround_inplace.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int,
    ]
    lib.blosc_decode_frame.restype = ctypes.c_int
    lib.blosc_decode_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, U8P, ctypes.c_int64,
    ]
    lib.blosc_encode_frame.restype = ctypes.c_int64
    lib.blosc_encode_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, U8P, ctypes.c_int64,
    ]
    lib.blosc_decode_many.restype = ctypes.c_int
    lib.blosc_decode_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def get_lib():
    """The ctypes library, building it on first use; None where it cannot be
    built or loaded (the reason is kept for ``require``)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = e
                log.debug("native host-ops unavailable: %s", e)
    return _lib


def require():
    """The library, or ``RuntimeError`` with why it could not be built."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native host library is required and unavailable: "
                           f"{_error}") from _error
    return lib


def default_threads() -> int:
    return max(1, (os.cpu_count() or 1))


def zlib_decode_many(blobs: list[bytes | None], chunk_bytes: int,
                     out: np.ndarray | None = None,
                     n_threads: int | None = None) -> np.ndarray | None:
    """Decode N zlib blobs into a contiguous [N * chunk_bytes] uint8 buffer.

    Missing blobs (None) leave their slot as-is (caller pre-fills with the
    fill value).  Returns None if the native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(blobs)
    if out is None:
        out = np.zeros(n * chunk_bytes, np.uint8)
    keepalive = [b if b is not None else b"" for b in blobs]
    srcs = (ctypes.c_char_p * n)(*[
        ctypes.cast(ctypes.c_char_p(b), ctypes.c_char_p) if blobs[i] is not None else None
        for i, b in enumerate(keepalive)
    ])
    lens = (ctypes.c_int64 * n)(*[len(b) if b else 0 for b in keepalive])
    rc = lib.zlib_decode_many(
        srcs, lens, out.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(chunk_bytes), ctypes.c_int(n),
        ctypes.c_int(n_threads or default_threads()),
    )
    if rc != 0:
        raise ValueError(f"zlib decode failed for chunk {rc - 1}")
    return out


def blosc_decode_many(blobs: list[bytes | None], chunk_bytes: int,
                      out: np.ndarray | None = None,
                      n_threads: int | None = None) -> np.ndarray | None:
    """Decode N Blosc-1 frames into a contiguous [N * chunk_bytes] buffer.

    Same contract as ``zlib_decode_many``; returns None when the native lib
    is unavailable (caller falls back to per-chunk python decode).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(blobs)
    if out is None:
        out = np.zeros(n * chunk_bytes, np.uint8)
    keepalive = [b if b is not None else b"" for b in blobs]
    srcs = (ctypes.c_char_p * n)(*[
        ctypes.cast(ctypes.c_char_p(b), ctypes.c_char_p)
        if blobs[i] is not None else None
        for i, b in enumerate(keepalive)
    ])
    lens = (ctypes.c_int64 * n)(*[len(b) if b else 0 for b in keepalive])
    rc = lib.blosc_decode_many(
        srcs, lens, out.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(chunk_bytes), ctypes.c_int(n),
        ctypes.c_int(n_threads or default_threads()),
    )
    if rc != 0:
        raise ValueError(f"blosc decode failed for chunk {rc - 1}")
    return out


def zscore_normalize_inplace(data: np.ndarray, chan_idx: np.ndarray,
                             mean: np.ndarray, std: np.ndarray,
                             n_threads: int | None = None) -> bool:
    """Fused in-place (x-mean)/std over selected trailing channels.

    ``data`` is C-contiguous float32 [..., C].  Returns False when the native
    lib is unavailable (caller falls back to numpy).
    """
    lib = get_lib()
    if lib is None:
        return False
    if data.dtype != np.float32 or not data.flags.c_contiguous:
        return False
    channels = data.shape[-1]
    n_px = data.size // channels
    idx = np.ascontiguousarray(chan_idx, np.int64)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.zscore_normalize_inplace(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_px), ctypes.c_int64(channels),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(idx)), ctypes.c_int(n_threads or default_threads()),
    )
    return True


def bitround_inplace(data: np.ndarray, keepbits: int) -> bool:
    lib = get_lib()
    if lib is None or data.dtype != np.float32 or not data.flags.c_contiguous:
        return False
    bits = data.view(np.uint32)
    lib.bitround_inplace(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(bits.size), ctypes.c_int(keepbits),
    )
    return True


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Build the native host-ops library.")
    p.add_argument("--force", action="store_true")
    args = p.parse_args()
    print(f"native host-ops: {build(force=args.force)}")
