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
