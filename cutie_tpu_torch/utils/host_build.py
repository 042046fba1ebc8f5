"""Build host C++ sources (csrc_host/) into shared libraries and load them
with ctypes.

A source is compiled at first use with g++ -O3 -std=c++17 -shared -fPIC
into cutie_tpu_torch/_build/<stem>-<hash>.so, named by a hash of the
source and the flags: a warm run loads the existing library, a changed
source or flag set builds a new one. A failed build or load raises; there
is no fallback. Nothing is written beside the source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_HOST_DIR = PACKAGE_DIR / "csrc_host"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[Path, ctypes.CDLL] = {}


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                            + source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def host_library(source: Path) -> ctypes.CDLL:
    """The shared library of `source`, built with g++ where it is missing
    and loaded once a process; raises if g++ fails or the load fails. The
    caller declares argtypes and restype."""
    with _LOCK:
        if source in _LOADED:
            return _LOADED[source]
        so = library_path(source)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(source)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}): "
                                   f"{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(so))
        _LOADED[source] = lib
        return lib
