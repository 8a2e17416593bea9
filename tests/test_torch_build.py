"""The kernel build's staleness rule, without a compiler: a library is
rebuilt when it is missing or older than any of its translation units or
any file of ``csrc/`` they include (followed recursively)."""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import os

from k8s1m_tpu_torch.ops import _build


def _touch(path, t):
    path.write_text(path.read_text() if path.exists() else "")
    os.utime(path, (t, t))


def _tree(tmp_path):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n#include <cuda_runtime.h>\n')
    (csrc / "k_a.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text('#pragma once\n#include "util.cuh"\n')
    (csrc / "util.cuh").write_text("// helpers\n")
    (csrc / "other.cu").write_text("")
    (csrc / "unused.cuh").write_text("")
    for p in csrc.iterdir():
        os.utime(p, (1000, 1000))
    return csrc, build


def test_sources_and_inputs(tmp_path):
    csrc, _build_dir = _tree(tmp_path)
    assert [p.name for p in _build.sources("k", csrc)] == ["k.cu", "k_a.cu"]
    names = sorted(p.name for p in _build.inputs("k", csrc))
    assert names == ["k.cu", "k.cuh", "k_a.cu", "util.cuh"]


def test_rebuild_when_any_input_is_newer(tmp_path):
    csrc, build = _tree(tmp_path)
    lib = _build.library_path("k", build)
    assert _build.is_stale("k", csrc, build)             # missing
    _touch(lib, 2000)
    assert not _build.is_stale("k", csrc, build)
    _touch(csrc / "unused.cuh", 3000)                     # not included: no rebuild
    _touch(csrc / "other.cu", 3000)
    assert not _build.is_stale("k", csrc, build)
    for name in ("util.cuh", "k.cuh", "k_a.cu", "k.cu"):  # each input alone
        _touch(csrc / name, 3000)
        assert _build.is_stale("k", csrc, build), name
        _touch(csrc / name, 1000)
    assert not _build.is_stale("k", csrc, build)


def test_package_library_inputs():
    names = {p.name for p in _build.inputs("fused_topk")}
    units = {f"fused_topk_{stage}_{layout}.cu" for stage in ("base", "aff", "cons", "affcons")
             for layout in ("plain", "packed")}
    assert {"fused_topk.cu", "fused_topk.cuh", "topk_common.cuh", *units} == names
    assert {p.name for p in _build.inputs("delta_topk")} == {"delta_topk.cu", "topk_common.cuh"}
    assert set(_build.LIBRARIES) == {"fused_topk", "delta_topk"}


def test_shared_header_marks_both_libraries_stale(tmp_path):
    """Touching the shared header rebuilds both kernels' libraries."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    names = [p.name for p in _build.CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh")]
    for name in names:
        (csrc / name).write_text((_build.CSRC_DIR / name).read_text())
        os.utime(csrc / name, (1000, 1000))
    for lib in _build.LIBRARIES:
        _touch(_build.library_path(lib, build), 2000)
        assert not _build.is_stale(lib, csrc, build), lib
    _touch(csrc / "topk_common.cuh", 3000)
    assert all(_build.is_stale(lib, csrc, build) for lib in _build.LIBRARIES)
    _touch(csrc / "topk_common.cuh", 1000)
    _touch(csrc / "delta_topk.cu", 3000)                  # one library only
    assert _build.is_stale("delta_topk", csrc, build)
    assert not _build.is_stale("fused_topk", csrc, build)
