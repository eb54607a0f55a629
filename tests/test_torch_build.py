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


def test_the_signature_table_matches_every_c_entry_point():
    """``interp_cuda._SIGNATURES`` counts, for each ``paradis_<name>`` entry
    point, the pointers, 64-bit integers and ints before the stream; each is
    read here from the ``extern "C"`` declaration in its source, and every
    entry point of ``csrc/`` has a row."""
    import re

    from paradis_torch.ops.interp_cuda import _SIGNATURES

    decl = re.compile(r'extern "C" int paradis_(\w+)\(([^)]*)\)')
    found = {}
    for name in _build.sources():
        for entry, args in decl.findall((_build.CSRC_DIR / f"{name}.cu").read_text()):
            types = [" ".join(a.split()[:-1]) for a in args.split(",")]
            assert types[-1] == "void*", (entry, types)  # the stream
            kinds = ["ptr" if t.endswith("*") else t for t in types[:-1]]
            n_ptr, n_long = kinds.count("ptr"), kinds.count("long long")
            assert kinds == ["ptr"] * n_ptr + ["long long"] * n_long + ["int"] * (
                len(kinds) - n_ptr - n_long), (entry, types)
            found[entry] = (name, n_ptr, n_long, len(kinds) - n_ptr - n_long)
    assert found == _SIGNATURES
