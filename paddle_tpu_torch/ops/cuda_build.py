"""Build and load the port's CUDA kernels.

Each kernel source `paddle_tpu_torch/csrc/<name>.cu` exposes a plain C
interface and is compiled by `nvcc` for Hopper (sm_90a) into a shared
library under `paddle_tpu_torch/_build/` (listed in .gitignore), then
loaded with ctypes.  The build runs at first use and again only when the
source or the flags change: the library's file name carries their hash.
Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelLibrary:
    """A built and loaded kernel library, with how its build went."""

    def __init__(self, path: Path, lib: ctypes.CDLL, build_seconds: float,
                 build_log: str):
        self.path = path
        self.lib = lib
        self.build_seconds = build_seconds    # 0.0 when it was already built
        self.build_log = build_log            # nvcc's stderr (ptxas report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def build(name: str) -> KernelLibrary:
    """Compile `csrc/<name>.cu` unless a library of the same source hash
    exists, and load it.  Raises RuntimeError carrying nvcc's stderr when
    the build fails."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return KernelLibrary(out, ctypes.CDLL(str(out)), seconds, log)
