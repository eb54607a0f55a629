"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``_build/lib<name>-<hash>.so`` beside this file (a
directory ``.gitignore`` lists).  The hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header rebuilds
and an unchanged one is reused.  ``build``
starts one ``nvcc`` per source, all at once, and waits for every one.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    """Names of the CUDA sources in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    nvcc = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME: the CUDA toolkit "
                       "is needed to build paradis_torch's kernels")


def _lib_path(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet.

    Returns ``{name: {"seconds": s, "log": compiler output}}`` for each source
    it compiled.  Raises with the compiler's output if any build fails.
    """
    names = sources() if names is None else names
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _lib_path(name))  # atomic: a reader never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(_lib_path(name)))
