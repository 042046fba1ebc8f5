"""Build a CUDA source into a plain-C shared library and load it with ctypes.

Each source is compiled at first use with
  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v
into cutie_tpu_torch/_build/, named by a hash of the source and the flags, so
a warm run loads the existing library and a changed source rebuilds. The
sources include no PyTorch header: a cold build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last load_library call of each source did: {"seconds", "cold",
# "library", "ptxas"}; "ptxas" holds ptxas's register and shared-memory
# report of a cold build (empty for a warm one)
BUILD_LOG: Dict[str, Dict[str, object]] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and at "
                       "/usr/local/cuda/bin/nvcc)")


def library_path(source: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{src.stem}-{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; raises on any failure."""
    if source in _LOADED:
        return _LOADED[source]
    src, so = library_path(source)
    t0 = time.perf_counter()
    cold = not so.exists()
    ptxas = []
    if cold:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if any(w in ln for w in ("entry function", "Used", "spill"))]
    lib = ctypes.CDLL(str(so))
    BUILD_LOG[source] = {"seconds": time.perf_counter() - t0, "cold": cold,
                         "library": so.name, "ptxas": ptxas}
    _LOADED[source] = lib
    return lib
