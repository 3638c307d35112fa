"""The CUDA build's cache key: ``build.library_path`` names a library by a
hash of every file under ``csrc/``, so an edit to a shared header (the
attention tile body ``attn_tile.cuh`` that two kernels include, the Hopper
helpers ``hopper.cuh`` that four include, the decode bodies, the common
helpers) rebuilds every library and no stale one is loaded.  Runs on a
temporary copy of ``csrc/``; nothing is compiled."""

import shutil

import pytest

from repro_torch.kernels import build


@pytest.mark.parametrize("header", ["attn_tile.cuh", "hopper.cuh", "decode_body.cuh",
                                    "decode_split.cuh", "common.cuh"])
def test_editing_a_header_changes_the_source_hash(header, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._source_hash()
    paths = {name: build.library_path(name) for name in build.KERNELS}
    assert build._source_hash() == before  # the key is stable
    path = csrc / header
    path.write_text(path.read_text() + "\n// an edit\n")
    assert build._source_hash() != before
    for name, old in paths.items():
        assert build.library_path(name) != old, name
