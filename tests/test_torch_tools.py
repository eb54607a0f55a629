"""The measuring tools of ``paradis_torch/tools`` on the CPU, at toy size.

Each runs with ``--device cpu`` (the plain versions, host clock) on the
toy model of ``tools.flagship.TINY`` and prints the keys of its script in
``scripts/``: ``bench_forecast`` (the chain slope, its arguments),
``bench_highres``, ``bench_pipeline`` (the host path), ``profile_step``
(both buckets; the source buckets name the physics layer's parts, the loss,
the optimizer and the backward of each, and hold the step's whole host
time), ``roofline`` (the analytic ledger, ``--measure``, ``--cost`` with the
custom ops' FLOP formulas: ``FlopCounterMode`` reads them, not 0; the
interpolation bounds equal ``PERF.md``'s bound column) and
``profile_live``.  No JAX here; the scripts' own parity is in
``test_torch_tools_parity.py``, the soak and the rehearsal in
``test_torch_tools_cli.py``.  On the card the tools run in
``chip_smoke.py`` and ``test_torch_tools_gpu.py``.
"""

import json
import re

import pytest

torch = pytest.importorskip("torch")

from paradis_torch.tools import (bench_forecast, bench_highres, bench_pipeline,  # noqa: E402
                                 profile_live, profile_step, roofline)
from paradis_torch.tools.flagship import TINY  # noqa: E402

TOY = [a for o in TINY for a in ("--override", o)]


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_forecast_prints_the_scripts_keys_from_chain_slopes(capsys):
    res = bench_forecast.main(["--device", "cpu", "--nlat", "8", "--nlon", "16", "--steps", "2",
                               "--chain-short", "1", "--chain-long", "3", "--repeats", "2",
                               *TOY])
    assert _last_json(capsys) == json.loads(json.dumps(res))
    for key in ("forecast_steps_per_sec", "ms_per_model_step", "ten_day_forecast_sec",
                "simulated_days_per_sec"):
        assert res[key] > 0
    assert len(res["slopes_s"]) == 2 and res["ten_day_forecast_sec"] == min(res["slopes_s"])
    assert res["forecast_steps_per_sec"] == pytest.approx(2 / res["ten_day_forecast_sec"])
    assert res["simulated_days_per_sec"] == pytest.approx(0.5 / res["ten_day_forecast_sec"])
    assert res["finite"] and res["dtype"] == "float32" and res["grid"] == [8, 16]
    assert res["band_px"] is not None          # --nlat: the banded run, as the smoke serves it
    assert res["launches_per_rollout"] == {}   # the plain versions launch no kernel
    assert res["device"] == {"platform": "cpu", "kind": "cpu"} and res["card"] is None


def test_chain_slope_counts_each_call_and_refuses_empty_chains():
    calls = []
    res = bench_forecast.chain_slope(lambda: calls.append(1), "cpu", 0, 2, 3)
    assert len(calls) == 6 and len(res["slopes_s"]) == 3
    assert res["best_s"] == min(res["slopes_s"])
    with pytest.raises(ValueError, match="short < long"):
        bench_forecast.chain_slope(lambda: None, "cpu", 2, 2, 1)


def test_bench_highres_trains_the_checkpointed_banded_step(capsys):
    res = bench_highres.main(["--device", "cpu", "--nlat", "8", "--nlon", "16",
                              "--chain-short", "1", "--chain-long", "2", "--repeats", "1",
                              *TOY])
    assert _last_json(capsys) == json.loads(json.dumps(res))
    assert res["grid"] == "8x16" and res["step_ms"] > 0
    assert res["samples_per_sec_per_chip"] == pytest.approx(1e3 / res["step_ms"])
    assert res["gradient_checkpointing"] and res["band_px"] is not None
    assert res["dtype"] == "bfloat16" and res["optimizer"] == "normuon"
    assert len(res["losses"]) == 4 and all(map(lambda v: v == v, res["losses"]))
    off = bench_highres.main(["--device", "cpu", "--nlat", "8", "--nlon", "16",
                              "--chain-short", "0", "--chain-long", "1", "--repeats", "1",
                              "--override", "compute.gradient_checkpointing=false", *TOY])
    assert not off["gradient_checkpointing"]


def test_bench_pipeline_times_the_host_path(capsys):
    res = bench_pipeline.main(["--device", "cpu", "--nlat", "8", "--nlon", "16",
                               "--samples", "4", "--override",
                               "features.pressure_levels=[500,850,1000]"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"host pipeline: [\d.]+ samples/s \([\d.]+ ms/sample, 4 samples\)",
                        lines[-2])
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    assert res["host"]["samples"] == 4 and res["host"]["samples_per_sec"] > 0
    assert res["with_place"] is None and res["grid"] == [8, 16] and res["build_s"] > 0


@pytest.mark.parametrize("bucket", ["source", "op"])
def test_profile_step_buckets_the_step(bucket, capsys):
    res = profile_step.main(["--tiny", "--cpu", "--steps", "1", "--bucket", bucket,
                             "--override", "compute.gradient_checkpointing=true"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.match(r"host time: [\d.]+ ms/step \(batch 1, 8x16\)", lines[0])
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    assert res["grid"] == [8, 16] and res["gradient_checkpointing"]
    assert sum(res["by_source"].values()) == pytest.approx(res["ms_per_step"])
    assert sum(res["by_op"].values()) == pytest.approx(res["ms_per_step"])
    if bucket == "source":
        for part in ("velocity_net", "departure", "interpolation", "blend", "diffusion",
                     "reaction", "loss", "optimizer"):
            assert res["by_source"].get(part, 0) > 0, part
        for part in ("interpolation", "velocity_net", "reaction"):
            assert res["by_source"].get(f"backward: {part}", 0) > 0, part
            assert res["by_source"].get(f"replay: {part}", 0) > 0, part  # checkpointing
        # the step's own operators and the gradient accumulation: a small remainder
        assert res["unattributed_ms_per_step"] < 0.2 * res["ms_per_step"]
        assert "paradis::interp" in res["by_op"] and "paradis::interp_bwd" in res["by_op"]


def test_profile_step_leaves_nothing_installed():
    from paradis_torch.ops import advection
    from paradis_torch.train import WeightedLoss
    from paradis_torch.utils import tracing

    run = profile_step.build_step(1, (8, 16), "cpu", tiny=True)
    before = (advection.interpolate, advection.departure_pixel_coords, WeightedLoss.__call__)
    profile_step.source_profile(run["step"], 1, "cpu")
    assert (advection.interpolate, advection.departure_pixel_coords,
            WeightedLoss.__call__) == before
    assert "step" not in vars(run["optimizer"]) and "grad_norm" not in vars(run["optimizer"])
    assert not any(m._forward_hooks or m._forward_pre_hooks for m in run["model"].modules())
    assert not tracing.is_recording()


def test_roofline_bounds_are_perf_mds_bound_column():
    """#1 and #2 at 5.625° (field [1, 36, 68, 768]) and #5 and #6 at 1.40625°
    ([1, 132, 260, 768]), fp32 / bf16, ms to 3 significant figures."""
    expected = {(32, 64): ((0.00788, 0.00582), (0.0139, 0.0107)),
                (128, 256): ((0.122, 0.091), (0.213, 0.167))}
    for (h, w), (fwd, bwd) in expected.items():
        n_out = h * w * 768
        for size, f_ms, b_ms in zip((4, 2), fwd, bwd):
            field = (h + 4) * (w + 4) * 768 * size
            fwd_ms = roofline.interp_bound(n_out, field, size, "bicubic")[0]
            bwd_ms = roofline.interp_bwd_bound(n_out, field, size, "bicubic")[0]
            assert fwd_ms == pytest.approx(f_ms, rel=5e-3)
            assert bwd_ms == pytest.approx(b_ms, rel=5e-3)
    field = torch.empty(1, 36, 68, 768, dtype=torch.bfloat16, device="meta")
    py = torch.empty(1, 32, 64, 768, device="meta")
    assert roofline.bound(field, py, "bicubic") == roofline.interp_bound(
        py.numel(), field.numel() * 2, 2, "bicubic")
    assert roofline.bound_bwd(field, py, py, "bicubic")[1] == "bytes"


def test_flop_counter_counts_the_custom_ops():
    from torch.utils.flop_counter import FlopCounterMode

    from paradis_torch.ops.interp_cuda import interp
    from paradis_torch.ops.interp_dense import interp_dense

    field = torch.randn(1, 12, 20, 4, requires_grad=True)
    py = (torch.rand(1, 8, 16, 4) * 11).requires_grad_()
    px = (torch.rand(1, 8, 16, 4) * 19).requires_grad_()
    for fn, fwd, bwd in ((interp, "paradis.interp", "paradis.interp_bwd"),
                         (interp_dense, "paradis.interp_dense", "paradis.interp_dense_bwd")):
        with FlopCounterMode(display=False) as bare:
            fn(field, py, px, "bicubic").sum().backward()
        assert bare.get_total_flops() == 0       # opaque to the counter without a formula
        with FlopCounterMode(display=False, custom_mapping=roofline.flop_formulas()) as fc:
            fn(field, py, px, "bicubic").sum().backward()
        counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
        assert counts[fwd] > 0 and counts[bwd] > 0, counts
    assert counts["paradis.interp_dense"] == 2 * 512 * 12 * 20 + 2 * 512 * 20


def test_roofline_ledger_cost_and_measure_on_the_cpu(capsys):
    res = roofline.main(["--device", "cpu", "--nlat", "8", "--nlon", "16", "--cost",
                         "--measure", "--steps", "1", *TOY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "| component | measured | floor | ach. floor/meas | bound by | verdict |" in lines
    assert json.loads(lines[-1])["analytic_flops"] == res["analytic_flops"]
    comp = res["components"]
    assert list(comp) == ["interpolation fwd", "interpolation bwd", "NorMuon update",
                          "departure trig", "1x1 conv GEMMs"]
    assert comp["interpolation fwd"]["launches"] == 4        # 2 layers, checkpointing: the replay
    assert comp["interpolation bwd"]["launches"] == 2
    assert all(c["ms"] > 0 and c["flops"] > 0 for c in comp.values())
    # the whole step's count: the GEMMs, Newton–Schulz and the custom ops'
    # formulas; the analytic replay counts every GEMM of the layer, the
    # checkpoint's early stop replays fewer
    assert 0.9 * res["analytic_flops"] <= res["cost"]["flops"] <= res["analytic_flops"]
    assert res["cost"]["flops_by_op"]["paradis.interp"] == comp["interpolation fwd"]["flops"]
    assert res["cost"]["bytes"] > 0
    meas = res["measured"]["ms"]
    assert set(meas) == set(comp) | {"tail (everything else)"}
    assert all(v > 0 for k, v in meas.items() if k != "tail (everything else)")


def test_roofline_keeps_the_reference_numbers_apart():
    assert roofline.NORMUON_FLOP == 1.46e12 and roofline.V5E["hbm_bytes_per_s"] == 819e9
    assert (roofline.HBM_BW, roofline.FP32_FLOPS, roofline.BF16_FLOPS) == (3.35e12, 67e12,
                                                                          989e12)


def test_profile_live_splits_the_host_loop(tmp_path, capsys):
    from torch_toy import build_torch_toy_store

    store = build_torch_toy_store(tmp_path)
    toy = ["features.pressure_levels=[500,850,1000]", "model.latent_size=16",
           "model.velocity_vectors=4", "model.num_layers=1"]
    res = profile_live.main(["--store", str(store), "--device", "cpu", "--steps", "5",
                             "--batch", "2", "--sync", "2",
                             *[a for o in toy for a in ("--override", o)]])
    assert _last_json(capsys) == json.loads(json.dumps(res))
    assert res["steps"] == 4 and res["batch"] == 2 and res["samples_per_sec"] > 0
    assert set(res["main_loop_ms_per_step"]) == {"queue_wait", "dispatch", "metric_fetch",
                                                 "other"}
    assert sum(res["main_loop_ms_per_step"].values()) == pytest.approx(res["wall_ms_per_step"])
    assert set(res["overlapped_threads_ms"]) == {"assemble_per_sample", "assemble_per_step",
                                                 "device_put_per_step"}
    assert res["overlapped_threads_ms"]["assemble_per_sample"] > 0
