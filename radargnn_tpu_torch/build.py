"""Builds the port's native libraries (g++ host helpers, nvcc kernels) at
first use, from the sources in the package, into a git-ignored directory
beside the package: `<checkout>/build/radargnn_tpu_torch/`.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.path.join(os.path.dirname(_PKG_DIR), "build", "radargnn_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def source_path(*parts: str) -> str:
    return os.path.join(_PKG_DIR, *parts)


def compile_shared(cmd: List[str], src: str, name: str) -> Tuple[str, str]:
    """Compiles `src` with `cmd + [src, "-o", out]` into `build_dir()/name`
    unless an up-to-date library is there; returns (path, compiler output).

    The compiler writes to a per-process file that is then renamed into
    place, so concurrent builds (test workers) never load a half-written
    library. Raises RuntimeError with the compiler's output when the build
    fails."""
    out = os.path.join(build_dir(), name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
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
        source_path("csrc", src_name), f"lib{stem}.so")
