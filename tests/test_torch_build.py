"""The kernel build's cache key: the library's directory follows every
source and every shared header in ``csrc/``, so an edit to a header that
the kernels include rebuilds them (nothing is compiled here)."""

import shutil

import pytest

from audian_torch.ops.cuda import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    return copy


@pytest.mark.parametrize("suffix", [".cuh", ".cu"])
def test_build_dir_follows_sources_and_headers(csrc, suffix):
    files = sorted(csrc.glob("*" + suffix))
    assert files, f"no {suffix} file in csrc"
    before = _build.build_dir()
    assert _build.build_dir() == before
    files[0].write_text(files[0].read_text() + "\n// edited\n")
    assert _build.build_dir() != before


def test_headers_are_included_not_compiled(csrc):
    assert all(src.suffix == ".cu" for src in _build._sources())
    assert {p.name for p in csrc.glob("*.cuh")} >= {"hopper.cuh",
                                                    "wgmma_conv.cuh"}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    before = _build.build_dir()
    (csrc / "extra.cuh").unlink()
    assert _build.build_dir() != before
