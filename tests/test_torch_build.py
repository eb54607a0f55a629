"""The kernel build helper: library naming, and a clear failure without nvcc."""

import pytest

torch = pytest.importorskip("torch")

from paradis_torch import _build  # noqa: E402


def test_every_source_is_found_and_named_by_its_content(tmp_path, monkeypatch):
    assert "interp_fwd" in _build.sources()
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build._lib_path("k")
    assert first.parent == tmp_path / "_build" and first.name.startswith("libk-")
    assert _build._lib_path("k") == first
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build._lib_path("k")
    assert second != first  # an edited source builds anew
    (tmp_path / "taps.cuh").write_text("// shared\n")
    assert _build._lib_path("k") != second  # and so does an edited shared header


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["interp_fwd"])
    assert not (tmp_path / "_build").exists()


def test_build_is_a_no_op_when_every_library_exists(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build._lib_path("interp_fwd").write_bytes(b"")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)  # nvcc never asked for
    assert _build.build(["interp_fwd"]) == {}
