"""Builds the port's CUDA sources into shared libraries and loads them with
ctypes.

Each `.cu` file under `kdip_tpu_torch/csrc/` has a plain C interface and is
compiled alone by `nvcc` for Hopper (sm_90a) into `kdip_tpu_torch/_build/`
(listed in .gitignore), at its first use or all at once by `build_all`. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a library built from the same source is reused.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per source built in this process: (seconds, nvcc's stderr, which holds
# ptxas's register and spill report)
build_log: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _compile(sources: Iterable[str]) -> None:
    """Runs one nvcc per source whose library is missing, all at once."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    t0 = time.perf_counter()
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        procs.append((s, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for s, tmp, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {s}:\n{err}")
            continue
        os.replace(tmp, library_path(s))  # atomic for concurrent builds
        build_log[s] = (time.perf_counter() - t0, err)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all() -> Dict[str, Tuple[float, str]]:
    """Builds every source under csrc/ in parallel; returns `build_log`."""
    with _lock:
        _compile(sorted(p.name for p in CSRC.glob("*.cu")))
    return build_log


def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built at first use."""
    with _lock:
        if source not in _libs:
            _compile([source])
            _libs[source] = ctypes.CDLL(str(library_path(source)))
        return _libs[source]
