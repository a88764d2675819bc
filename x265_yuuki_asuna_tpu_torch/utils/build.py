"""Build and load the port's native libraries from `csrc/`.

Three libraries, each with a plain C interface loaded through ctypes:
  * `me_sad`       — the K1 SAD-sweep CUDA kernel, nvcc for sm_90a;
  * `intra_commit` — the quadtree intra commit CUDA kernel, nvcc for sm_90a;
  * `asuna_native` — the host CABAC / slice-syntax writer, g++.
Each is built on first use into `build/` (listed in .gitignore). A build
failure raises: there is no fallback. `build()` starts one compiler per
library, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

LIBS = {"me_sad": "me_sad.cu", "intra_commit": "intra_commit.cu",
        "asuna_native": "asuna_native.cpp"}

_loaded = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else (shutil.which("nvcc") or "nvcc")


def _command(src: str, out: str):
    if src.endswith(".cu"):
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", out, src]
    return ["g++", "-O2", "-shared", "-fPIC", "-o", out, src]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(names=None) -> dict:
    """Compile the named libraries (default: all) in parallel. Returns
    {name: compiler output} (nvcc's includes the -Xptxas -v summary);
    raises RuntimeError naming any that failed."""
    names = list(LIBS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(CSRC, LIBS[name])
        # per-process temp name + atomic rename: concurrent test workers
        # may build the same library at once
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            _command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, p) in procs.items():
        logs[name], _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library, built first if missing or older than its
    source."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        so = lib_path(name)
        src = os.path.join(CSRC, LIBS[name])
        if not os.path.exists(so) or \
                os.path.getmtime(so) < os.path.getmtime(src):
            build([name])
        _loaded[name] = ctypes.CDLL(so)
        return _loaded[name]
