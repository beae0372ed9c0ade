"""The port's kernel build cache (``repro_torch/kernels/_build.py``): the
library's name is a hash of everything that is compiled, so an edited
header beside a source, a new file there, or another flag rebuilds. No
``nvcc`` needed: only the name is computed."""

import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rglru_scan import kernel as scan_kernel


def _csrc(tmp_path: Path) -> Path:
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\nextern "C" int f();\n')
    (csrc / "k.cuh").write_text("#define TILE 64\n")
    return csrc / "k.cu"


def test_editing_a_header_beside_the_source_renames_the_library(tmp_path):
    src = _csrc(tmp_path)
    before = _build.library_path(src)
    assert before == _build.library_path(src)          # stable
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith("k-") and before.suffix == ".so"
    (src.parent / "k.cuh").write_text("#define TILE 128\n")
    assert _build.library_path(src) != before


def test_a_new_file_or_another_flag_renames_the_library(tmp_path,
                                                        monkeypatch):
    src = _csrc(tmp_path)
    before = _build.library_path(src)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-G"))
    assert _build.library_path(src) != before
    monkeypatch.undo()
    assert _build.library_path(src) == before
    (src.parent / "util.cuh").write_text("// shared\n")
    assert _build.library_path(src) != before


@pytest.mark.parametrize("kernel", [gemm_kernel, flash_kernel, scan_kernel],
                         ids=["gemm_int8", "flash_attention", "linear_scan"])
def test_a_port_source_rebuilds_when_a_file_beside_it_changes(tmp_path,
                                                              kernel):
    """Each of the port's sources, copied with its ``csrc/`` directory:
    the copy hashes like the original, and a header dropped beside it
    changes the name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(Path(kernel.SOURCE).parent, csrc)
    copy = csrc / Path(kernel.SOURCE).name
    assert _build.library_path(copy) == _build.library_path(kernel.SOURCE)
    (csrc / "tile.cuh").write_text("#define TILE 128\n")
    assert _build.library_path(copy) != _build.library_path(kernel.SOURCE)


@pytest.mark.parametrize("kernel", [gemm_kernel, flash_kernel, scan_kernel],
                         ids=["gemm_int8", "flash_attention", "linear_scan"])
def test_a_port_source_rebuilds_when_a_shared_header_changes(tmp_path,
                                                             monkeypatch,
                                                             kernel):
    """The headers every source may include (``kernels/csrc/``, e.g.
    ``hopper.cuh``) are part of each library's name: a copy of them hashes
    like the original, and an edit there renames every library."""
    assert (_build.SHARED_DIR / "hopper.cuh").is_file()
    shared = tmp_path / "shared"
    shutil.copytree(_build.SHARED_DIR, shared)
    before = _build.library_path(kernel.SOURCE)
    monkeypatch.setattr(_build, "SHARED_DIR", shared)
    assert _build.library_path(kernel.SOURCE) == before
    (shared / "hopper.cuh").write_text(
        (shared / "hopper.cuh").read_text() + "// edited\n")
    assert _build.library_path(kernel.SOURCE) != before


def test_the_tma_sources_include_the_shared_header():
    """gemm_int8 and flash_attention take their mbarrier, wgmma and tensor
    map plumbing from ``kernels/csrc/hopper.cuh`` rather than their own
    copies."""
    for kernel in (gemm_kernel, flash_kernel):
        text = Path(kernel.SOURCE).read_text()
        assert '#include "../../csrc/hopper.cuh"' in text
        assert (Path(kernel.SOURCE).parent / "../../csrc/hopper.cuh"
                ).resolve() == (_build.SHARED_DIR / "hopper.cuh").resolve()
        for helper in ("void mbar_wait(", "EncodeTiled encoder()",
                       "void wgmma_fence()", "void fence_regs("):
            assert helper not in text, (kernel.SOURCE, helper)


# ---------------------------------------------------------------------------
# Concurrent first use: pipeline stage workers launch from several threads
# ---------------------------------------------------------------------------


FAKE_NVCC = r'''#!{python}
"""A stand-in for nvcc: logs its call, then writes a real shared library
to the -o path slowly, in small pieces, as a compiler writing its output
would (a reader of the path mid-write would find half a file)."""
import shutil, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\n")
with open({lib!r}, "rb") as src, open(out, "wb") as dst:
    while chunk := src.read(4096):
        dst.write(chunk)
        dst.flush()
        time.sleep(0.0005)
'''


def test_concurrent_first_loads_build_once_and_load_a_whole_file(
        tmp_path, monkeypatch):
    """Eight threads asking for one library at once: ``nvcc`` runs once,
    every thread gets the same ``CDLL``, and the library on disk is the
    whole file the compiler wrote."""
    import ctypes
    import os
    import stat
    import sys
    import threading
    import _ctypes

    real_lib = Path(_ctypes.__file__)      # any loadable shared object
    log = tmp_path / "nvcc.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     lib=str(real_lib)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = _csrc(tmp_path)

    got, errors = [None] * 8, []
    barrier = threading.Barrier(8)

    def first_use(i):
        try:
            barrier.wait(timeout=30)
            got[i] = _build.load(src)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=first_use, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(log.read_text().splitlines()) == 1       # built once
    assert all(lib is got[0] for lib in got)            # one binding
    assert isinstance(got[0], ctypes.CDLL)
    built = _build.library_path(src)
    assert built.read_bytes() == real_lib.read_bytes()  # a whole file
    assert not list(built.parent.glob("*.tmp"))         # no leftovers
    assert _build.load(src) is got[0]                   # cached after


def test_once_binds_one_value_under_concurrent_first_calls():
    import threading
    import time

    calls = []

    @_build.once
    def bind():
        calls.append(1)
        time.sleep(0.01)        # a slow first call: the others arrive
        return object()

    got = [None] * 8
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(
        i, bind())) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(calls) == 1 and all(g is got[0] for g in got)


class _SwitchyDict(dict):
    """A dict read and written through Python calls, so the interpreter
    may switch threads between the read and the write of ``d[k] += 1``."""

    def __getitem__(self, key):
        return dict.__getitem__(self, key)

    def __setitem__(self, key, value):
        dict.__setitem__(self, key, value)


class _SwitchyCounts:
    """Stands in for a kernel wrapper's count attributes, read and written
    through a property (Python calls) for the same reason."""

    def __init__(self, *paths):
        self._launches = 0
        self.launches_by_path = _SwitchyDict.fromkeys(paths, 0)

    @property
    def launches(self):
        return self._launches

    @launches.setter
    def launches(self, value):
        self._launches = value


@pytest.mark.parametrize("kernel", [gemm_kernel, flash_kernel, scan_kernel],
                         ids=["gemm_int8", "flash_attention", "linear_scan"])
def test_launch_counts_stay_exact_under_eight_threads(kernel):
    """Eight threads counting launches at once through ``_build.count``,
    as each wrapper counts its own (with a path for ``gemm_int8``, and the
    direction, forward or backward, for ``linear_scan``, counted where its
    one launch site ``_scan`` launches), the interpreter switching threads
    every microsecond and able to switch inside each ``+= 1`` (the counts
    are read and written through Python calls here): no count is lost."""
    import inspect
    import sys
    import threading

    fn = {gemm_kernel: "gemm_int8", flash_kernel: "flash_attention",
          scan_kernel: "linear_scan"}[kernel]
    site = "_scan" if kernel is scan_kernel else fn
    args = ("path",) if kernel in (gemm_kernel, scan_kernel) else ()
    assert f"_build.count({', '.join((fn, *args))})" in inspect.getsource(
        getattr(kernel, site))
    paths = {gemm_kernel: ("large_n", "small_n", "dp4a"),
             scan_kernel: ("forward", "backward")}.get(kernel, ())
    counts = _SwitchyCounts(*paths)
    args = paths[:1]
    n = 3000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(counts, *args) for _ in range(n)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts.launches == 8 * n
    if paths:
        assert dict(counts.launches_by_path) == {
            p: 8 * n if p == paths[0] else 0 for p in paths}
