"""The port's interpolation microbenchmark (``paradis_torch.tools.bench_interp``)
on the CPU: ``--device cpu`` runs every variant through the plain versions at
a tiny shape; without a card and without it, the tool raises.  On the card it
runs as ``python3 -m paradis_torch.tools.bench_interp`` (chip_smoke.py's
``[bench-interp]`` phase)."""

import json

import pytest

torch = pytest.importorskip("torch")

from paradis_torch.tools import bench_interp  # noqa: E402
from torch_parity import TINY  # noqa: E402

KEYS = {"ms_per_op", "launches_per_op", "launches_per_run", "device", "card", "shape", "pad",
        "mode", "field_dtype", "chunk_rows", "iters", "repeats"}


def _argv(*more):
    argv = ["--device", "cpu", "--shape", "1,4,8,8", "--iters", "1", "--repeats", "1",
            "--warmup", "0", *more]
    for override in TINY:
        argv += ["--override", override]
    return argv


def test_bench_runs_every_variant_through_the_plain_versions_on_the_cpu(capsys):
    res = bench_interp.main(_argv())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res and set(res) == KEYS
    assert list(res["ms_per_op"]) == list(bench_interp.VARIANTS)
    assert [line.split()[0] for line in lines[:-1]] == list(bench_interp.VARIANTS)
    assert all(ms > 0 for ms in res["ms_per_op"].values())
    # the plain versions launch no kernel
    assert res["launches_per_op"] == {name: {} for name in bench_interp.VARIANTS}
    assert res["launches_per_run"] == res["launches_per_op"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu"} and res["card"] is None
    assert res["shape"] == [1, 4, 8, 8] and res["chunk_rows"] == 8 and res["mode"] == "bicubic"


def test_bench_runs_a_subset_and_refuses_unknown_variants(capsys):
    res = bench_interp.main(_argv("--variants", "genonly,chunked_fwdbwd"))
    assert list(res["ms_per_op"]) == ["genonly", "chunked_fwdbwd"]
    with pytest.raises(ValueError, match="unknown variants"):
        bench_interp.main(_argv("--variants", "no_such_variant"))


def test_bench_inputs_are_those_of_the_tpu_benchmark():
    """The field and positions of scripts/bench_interp.py:_inputs, drawn in
    the same order from default_rng(0), at the port's channels-last layout."""
    field, py, px = bench_interp.inputs((1, 4, 8, 3), "cpu")
    assert field.dtype == torch.bfloat16 and field.shape == (1, 8, 12, 3)
    assert py.shape == px.shape == (1, 4, 8, 3) and py.dtype == torch.float32
    assert 2.0 <= float(py.min()) and float(py.max()) <= 5.0
    assert 2.0 <= float(px.min()) and float(px.max()) <= 9.0


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_interp.main(["--variants", "genonly"])


def test_bench_mm_operands_are_drawn_as_the_tpu_benchmark_draws_them():
    """wx (wxT) then f from a fresh default_rng(1), float32: mm's and mmT's f
    are the same draws (wx and wxT have as many elements), and wxT is the
    same stream in the [C, P] layout, not the transpose of wx."""
    import numpy as np

    shape = (1, 2, 4, 3)                       # P 8, R 6, C 8
    wx, f = bench_interp.mm_operands(shape, "cpu", transposed=False)
    wxT, fT = bench_interp.mm_operands(shape, "cpu", transposed=True)
    assert wx.shape == (1, 3, 8, 8) and wxT.shape == (1, 3, 8, 8) and f.shape == (1, 3, 6, 8)
    assert wx.dtype == f.dtype == torch.float32
    torch.testing.assert_close(fT, f, rtol=0, atol=0)
    torch.testing.assert_close(wxT, wx, rtol=0, atol=0)   # one stream, read as [C, P]
    assert not torch.equal(wxT, wx.transpose(-1, -2))
    ref = np.random.default_rng(1).normal(size=(1, 3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(wx.numpy(), ref)
