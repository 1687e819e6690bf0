"""The kernels' build cache: a library is named by a hash of everything
that goes into it, so an edit to a source, to a header it may include or
to the flags gives a new library and never loads a stale one. Runs on the
CPU: naming a library needs no ``nvcc``."""

import shutil

import pytest

from ps_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` with one header, in place of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    (copy / "common.cuh").write_text("// shared helpers, first version\n")
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_is_stable_and_named_by_kernel(csrc, name):
    path = _build._library_path(name)
    assert path == _build._library_path(name)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "new_header", "nested_header",
                                  "source", "flags"])
@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_changes_with_what_goes_into_it(csrc, monkeypatch, name,
                                                     edit):
    before = _build._library_path(name)
    if edit == "header":
        (csrc / "common.cuh").write_text("// shared helpers, second version\n")
    elif edit == "new_header":
        (csrc / "extra.h").write_text("#pragma once\n")
    elif edit == "nested_header":
        (csrc / "detail").mkdir()
        (csrc / "detail" / "tiles.cuh").write_text("#pragma once\n")
    elif edit == "source":
        src = csrc / f"{name}.cu"
        src.write_text(src.read_text() + "\n// edited\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-G"))
    assert _build._library_path(name) != before


def test_another_kernels_source_does_not_rename_a_library(csrc):
    before = {name: _build._library_path(name) for name in _build.KERNELS}
    src = csrc / "sparse_apply.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._library_path("flash_attention") == before["flash_attention"]
    assert _build._library_path("sparse_apply") != before["sparse_apply"]
