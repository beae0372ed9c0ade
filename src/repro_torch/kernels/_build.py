"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/*.cu`` file holds plain ``extern "C"`` entry points and no
PyTorch headers, so it compiles in seconds. It is compiled for Hopper
(``sm_90a``) into ``build/kernels/<stem>-<hash>.so`` at the root of the
checkout; the hash covers every file under the source's ``csrc/``
directory (the source and any header beside it), every file of the
headers shared by all sources (``kernels/csrc/``, which a source includes
as ``"../../csrc/hopper.cuh"``) and the flags, so an edited source,
header or flag rebuilds and an unchanged one is loaded from the cache. A
failed build raises with ``nvcc``'s own error output. Nothing here runs at
import.

Loading is safe under concurrent first calls (the stage workers of a
pipelined server launch kernels from several threads): one lock per
library serialises its build and load, so one thread builds while the
others wait and then load the finished file, and each build writes a
temporary file of its own (process and thread) before the atomic rename.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, TypeVar

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
SHARED_DIR = Path(__file__).resolve().parent / "csrc"
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


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: named by a hash of
    every file under the source's directory and under ``SHARED_DIR``, and
    of the flags."""
    source = Path(source).resolve()
    h = hashlib.sha256()
    for tag, root in ((b"", source.parent), (b"shared/", SHARED_DIR)):
        for f in sorted(p for p in root.rglob("*") if p.is_file()):
            h.update(tag + f.relative_to(root).as_posix().encode() + b"\0")
            h.update(f.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


_LOCKS_LOCK = threading.Lock()
_LOCKS: dict[Path, threading.Lock] = {}
_LOADED: dict[Path, ctypes.CDLL] = {}


def _lock_for(lib: Path) -> threading.Lock:
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(lib, threading.Lock())


def load(source: Path) -> ctypes.CDLL:
    """The shared library built from ``source``, compiling it first if the
    cache does not hold it yet. Concurrent callers get one ``CDLL``."""
    source = Path(source).resolve()
    lib = library_path(source)
    with _lock_for(lib):
        if lib in _LOADED:
            return _LOADED[lib]
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(source)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} (exit "
                                   f"{proc.returncode}):\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
        _LOADED[lib] = ctypes.CDLL(str(lib))
        return _LOADED[lib]


T = TypeVar("T")


def once(fn: Callable[[], T]) -> Callable[[], T]:
    """``fn()`` computed by the first caller and returned to every caller
    after it, concurrent first callers included (``functools.cache`` may
    run ``fn`` once per racing thread): a kernel module binds its entry
    points' argument types once."""
    lock = threading.Lock()
    done: list = []

    def wrapper() -> T:
        if not done:
            with lock:
                if not done:
                    done.append(fn())
        return done[0]

    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


# Stage workers launch from several threads at once, and ``+= 1`` is a
# read-modify-write: every wrapper's counts are updated under one lock.
_COUNT_LOCK = threading.Lock()


def count(fn, path: str | None = None) -> None:
    """Count one launch of the kernel wrapper ``fn``: ``fn.launches`` and,
    where ``path`` is given, ``fn.launches_by_path[path]``."""
    with _COUNT_LOCK:
        fn.launches += 1
        if path is not None:
            fn.launches_by_path[path] += 1


def reset_count(fn, paths=None) -> None:
    """Set ``fn.launches`` to 0 and, where ``paths`` is given,
    ``fn.launches_by_path`` to 0 on each of them."""
    with _COUNT_LOCK:
        fn.launches = 0
        if paths is not None:
            fn.launches_by_path = dict.fromkeys(paths, 0)
