"""Builds the port's native libraries (g++ host helpers, nvcc kernels) at
first use, from the sources in the package, into a git-ignored directory
beside the package: `<checkout>/build/radargnn_tpu_torch/`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.path.join(os.path.dirname(_PKG_DIR), "build", "radargnn_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def source_path(*parts: str) -> str:
    return os.path.join(_PKG_DIR, *parts)


def compile_shared(cmd: List[str], src: str, name: str,
                   deps: Sequence[str] = ()) -> Tuple[str, str]:
    """Compiles `src` with `cmd + [src, "-o", out]` into `build_dir()/name`
    unless a library newer than `src` and its `deps` (headers) is there;
    returns (path, compiler output).

    The compiler writes to a per-process file that is then renamed into
    place, so concurrent builds (test workers) never load a half-written
    library. Raises RuntimeError with the compiler's output when the build
    fails."""
    out = os.path.join(build_dir(), name)
    newest = max(os.path.getmtime(f) for f in (src, *deps))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out, ""
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + [src, "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed: {' '.join(proc.args)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def nvcc_shared(src_name: str) -> Tuple[str, str]:
    """Builds `csrc/<src_name>` with nvcc for sm_90a into a shared library
    with a plain C interface (loaded with ctypes); returns (path, the
    compiler's output, which includes ptxas's register/spill report)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    stem = os.path.splitext(src_name)[0]
    return compile_shared(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        source_path("csrc", src_name), f"lib{stem}.so",
        deps=glob.glob(source_path("csrc", "*.cuh")))


def nvcc_all(src_names: Sequence[str]) -> Dict[str, Tuple[str, str]]:
    """Builds several kernel sources at once, one nvcc process each, all
    started together; returns {source: (path, compiler output)}."""
    with ThreadPoolExecutor(max_workers=len(src_names)) as pool:
        results = list(pool.map(nvcc_shared, src_names))
    return dict(zip(src_names, results))


_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def load_library(src_name: str,
                 bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Builds `csrc/<src_name>` (nvcc_shared) and loads it with ctypes once
    per process; `bind` declares its functions' argtypes and restypes."""
    with _LIBS_LOCK:
        if src_name not in _LIBS:
            path, _ = nvcc_shared(src_name)
            lib = ctypes.CDLL(path)
            bind(lib)
            _LIBS[src_name] = lib
        return _LIBS[src_name]
