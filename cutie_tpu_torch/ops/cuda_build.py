"""Build CUDA sources into plain-C shared libraries and load them with ctypes.

Each source is compiled at first use with
  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v
into cutie_tpu_torch/_build/, named by a hash of every file under csrc/ and
the flags: a warm run loads the existing library, and a change to any source
or to a header they share rebuilds them. The sources include no PyTorch
header: a cold build takes seconds. load_libraries starts one nvcc per cold
source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last load of each source did: {"seconds", "cold", "library",
# "ptxas"}; "ptxas" holds ptxas's register and shared-memory report of a
# cold build (empty for a warm one)
BUILD_LOG: Dict[str, Dict[str, object]] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and at "
                       "/usr/local/cuda/bin/nvcc)")


def csrc_digest() -> str:
    """Hash of every file under csrc/ (names and contents) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC_DIR)).encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{csrc_digest()}.so"


def load_libraries(sources: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (where needed, one nvcc per source, in parallel) and load
    csrc/<source> for each source; raises on any failure."""
    t0 = time.perf_counter()
    todo = [s for s in dict.fromkeys(sources) if s not in _LOADED]
    procs = {}
    for source in todo:
        so = library_path(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        procs[source] = (cmd, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ptxas = {}
    failed = []
    for source, (cmd, tmp, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        ptxas[source] = [ln.strip() for ln in out.splitlines()
                         if any(w in ln for w in ("entry function", "Used", "spill"))]
    if failed:
        raise RuntimeError("\n".join(failed))
    for source in todo:
        so = library_path(source)
        _LOADED[source] = ctypes.CDLL(str(so))
        BUILD_LOG[source] = {"seconds": time.perf_counter() - t0,
                             "cold": source in procs, "library": so.name,
                             "ptxas": ptxas.get(source, [])}
    return {s: _LOADED[s] for s in sources}


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; raises on any failure."""
    return load_libraries([source])[source]
