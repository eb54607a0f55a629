"""The harness on the CPU: its files, its names, its metric arithmetic, its
refusal without a card, and the imports it must never make."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import cell as cells
from port_bench import trace, yardstick
from port_bench.metrics import common
from port_bench.run import reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_agree(cell):
    wl = cells.load(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["cell"]["config"] == entry["config"]
    assert wl["cell"]["traffic"] == entry["traffic"]
    assert wl["cell"]["chips"] == entry["chips"] == 1
    assert wl["cell"]["why"] == entry["why"]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert wl["traffic"]["mode"] in ("train", "forecast")
    assert wl["cell"]["limits"], "every cell compares at least one number"


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(
        BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])


def test_every_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in e2e or w in e2e["workloads"], (m["name"], w)
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        e2e = [e for e in BENCH["end_to_end"]
               if "workloads" not in e or w["name"] in e["workloads"]]
        assert layer and len(e2e) >= 2 and any(e["name"] == "setup_s" for e in e2e)


def test_run_without_a_card_exits_nonzero():
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                           "train-1.40625deg-b1", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def test_no_jax_and_no_old_benchmark():
    forbidden = {"jax", "jaxlib", "flax", "paradis_tpu", "bench"}
    for path in (ROOT / "port_bench").rglob("*.py"):
        assert not _imports(path) & forbidden, path
        if path.parent.name != "tests":
            text = path.read_text()
            assert "BENCH_r0" not in text and "bench.py" not in text, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "port_bench" / "reference").rglob("*.py"):
        assert not _imports(path) & {"paradis_torch", "port_bench"} - {"port_bench"}, path
        assert "paradis_torch" not in _imports(path)


def test_union_and_ranges():
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)
    r = trace.Ranges()
    r.labels = ["+model", "+interpolation", "-interpolation", "-model", "+optimizer",
                "-optimizer"]
    spans = r.spans([(0, 1), (10, 11), (50, 51), (60, 61), (70, 71), (90, 91)])
    assert spans == [("interpolation", 11, 50), ("model", 1, 60), ("optimizer", 71, 90)]
    events = [("a", 2, 9), ("k", 12, 30), ("k", 31, 49), ("b", 52, 59), ("o", 72, 80)]
    assert [e[0] for e in trace.in_range(events, spans, "interpolation")] == ["k", "k"]
    assert len(trace.in_range(events, spans, "model")) == 4
    with pytest.raises(RuntimeError):
        r.spans([(0, 1)])


def _synthetic():
    tr = trace.Trace(events=[("gemm", 0, 400_000), ("interp_fwd", 500_000, 700_000),
                             ("Memset (Device)", 700_000, 710_000),
                             ("ns", 800_000, 900_000), ("loss", 910_000, 920_000)],
                     ranges=[("model", 0, 750_000), ("interpolation", 450_000, 705_000),
                             ("loss", 905_000, 925_000), ("optimizer", 790_000, 901_000)],
                     interp_calls=[{"kind": "fwd", "n_out": 1000, "field_bytes": 4000,
                                    "elem_bytes": 4, "mode": "bicubic"}],
                     steps=2, window_s=2e-3)
    tr.busy_s = trace.union_s((s, e) for _, s, e in tr.events)
    return tr


def test_metric_arithmetic():
    tr = _synthetic()
    ctx = {"trace": tr, "member_steps_per_s": 2.0, "steps_per_s": 1000.0,
           "flops": 67e12 / 4, "precision": "float32"}
    # busy 0.72 ms over 2 traced steps, at 1000 untraced steps a second
    assert common.idle_share(ctx) == pytest.approx(100 * (1 - 0.36e-3 * 1000.0))
    assert common.mfu(ctx) == pytest.approx(50.0)
    bound = yardstick.interp_fwd_bound_s(1000, 4000, 4, "bicubic")
    assert bound == pytest.approx(max((4000 + 8000 + 4000) / 3.35e12, 1000 * 88 / 67e12))
    assert common.interp_roofline(ctx) == pytest.approx(100 * bound * 1e3 / 0.2)
    assert reader("optim_ms.train")(ctx) == pytest.approx(0.1 / 2)
    assert reader("model_ms.train")(ctx) == pytest.approx((0.72 - 0.1 - 0.01) / 2)
    assert reader("model_ms.forecast")(ctx) == pytest.approx(0.61 / 2)
    assert reader("launches.forecast")(ctx) == pytest.approx(2.0)
    empty = dict(ctx, trace=trace.Trace(steps=2, window_s=1.0))
    for m in BENCH["per_layer"]:
        if not m["name"].startswith("mfu"):
            assert reader(m["name"])(empty) is None, m["name"]


def test_breakdown():
    out = trace.breakdown(_synthetic())
    assert out["device_ops"][0] == ["gemm", 4e-4]
    gaps = dict(out["idle_gaps"])
    assert gaps["model"] == pytest.approx(190e-6)
    assert gaps["optimizer"] == pytest.approx(10e-6)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_reference_flop_count_at_tiny_sizes():
    """``model_flops``: 2·in·out a position and member for each dense
    matrix, 2·k² a position, member and channel for each stencil, and the
    low-rank biases' maps once."""
    import math

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.modes.common import Context, model_flops
    from port_bench.tests.small import small

    ctx = Context(small("forecast-1.40625deg-b1"), 1, "cpu")
    ctx.build_program()
    positions = math.prod(ctx.grid)
    want = maps_flops = 0
    for name, shape in ctx.parameter_shapes().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 2:
            want += 2 * positions * shape[0] * shape[1]
        elif leaf == "weight" and len(shape) == 4:
            want += 2 * positions * shape[0] * shape[2] * shape[3]
        elif leaf == "A":
            prefix = name[: -len(".A")]
            shapes = ctx.parameter_shapes()
            c, k = shape
            with FlopCounterMode(display=False) as fc:
                maps = torch.einsum("ck,kh,kw->hwc", torch.zeros(c, k),
                                    torch.zeros(shapes[prefix + ".U"]),
                                    torch.zeros(shapes[prefix + ".V"]))
                if prefix + ".projection" in shapes:
                    maps @ torch.zeros(shapes[prefix + ".projection"]).t()
            maps_flops += fc.get_total_flops()
    assert model_flops(ctx, 1) == want + maps_flops
    # the fields' work scales with the members, the bias maps' does not
    assert model_flops(ctx, 3) == 3 * want + maps_flops
