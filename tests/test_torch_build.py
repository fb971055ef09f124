"""The kernel build's library name: it changes with the source, with any
header of the source directory and with nothing else, so an edited
kernel or header is rebuilt and a stale library is never loaded. Runs
on the CPU (no nvcc needed: only the names are computed)."""

import pathlib

import pytest

from f2nerf_tpu_torch.kernels import build

PACKAGE_CSRC = build.CSRC


@pytest.fixture
def csrc(tmp_path: pathlib.Path, monkeypatch) -> pathlib.Path:
    """A temporary source directory in place of the package's own."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("constexpr int kTile = 32;\n")
    monkeypatch.setattr(build, "CSRC", src)
    return src


def test_edited_header_changes_the_library_path(csrc):
    before = build.library_path("k")
    assert before == build.library_path("k")
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"
    (csrc / "common.cuh").write_text("constexpr int kTile = 64;\n")
    after = build.library_path("k")
    assert after != before
    # a new header counts too: any source may include it
    (csrc / "more.cuh").write_text("\n")
    assert build.library_path("k") != after


def test_library_path_follows_the_source_only(csrc):
    before = build.library_path("k")
    (csrc / "notes.txt").write_text("not compiled\n")
    assert build.library_path("k") == before
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("k") != before
    # the package's own kernels share a header, which enters their names
    assert list(PACKAGE_CSRC.glob("*.cuh"))
