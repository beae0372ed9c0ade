"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/*.cu`` file holds plain ``extern "C"`` entry points and no
PyTorch headers, so it compiles in seconds. It is compiled for Hopper
(``sm_90a``) into ``build/kernels/<stem>-<hash>.so`` at the root of the
checkout; the hash covers the source and the flags, so an edited source
rebuilds and an unchanged one is loaded from the cache. A failed build
raises with ``nvcc``'s own error output. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def load(source: Path) -> ctypes.CDLL:
    """The shared library built from ``source``, compiling it first if the
    cache does not hold it yet."""
    source = Path(source).resolve()
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)     # atomic: a reader never sees half a file
    return ctypes.CDLL(str(lib))
