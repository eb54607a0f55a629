"""The serving-artifact benchmark (``paradis_torch.tools.bench_artifact``) on
the CPU: ``--device cpu`` at a tiny size (one physics layer, 2 steps) exports,
loads and runs the three ways through the plain versions, the artifact's
outputs bitwise the in-process rollout's; without ``rollout`` among the ways
the artifact has no rollout program; without a card and without
``--device cpu`` the tool raises.  On the card it runs in ``chip_smoke.py``'s
``[export]`` phase."""

import json

import pytest

torch = pytest.importorskip("torch")

from paradis_torch.tools import bench_artifact  # noqa: E402

TINY = ["model.latent_size=16", "model.velocity_vectors=4", "model.num_layers=1",
        "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
        "model.physblock.output_proj.hidden_dim=8", "model.bias_channels=2",
        "model.bias_rank=4"]
STEPS = 2


def _argv(*more):
    argv = ["--device", "cpu", "--grid", "8,16", "--steps", str(STEPS), "--repeats", "1", *more]
    for override in TINY:
        argv += ["--override", override]
    return argv


def test_bench_exports_loads_and_runs_every_way_on_the_cpu(capsys):
    res = bench_artifact.main(_argv())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    assert [line.split()[0] for line in lines[:-1]] == list(bench_artifact.WAYS)
    assert sorted(res["file_bytes"]) == ["forward.pt2", "manifest.json", "params.npz",
                                         "rollout.pt2"]
    assert all(n > 0 for n in res["file_bytes"].values())
    assert set(res["export_seconds"]) == {"forward", "rollout", "total"}
    assert res["load_seconds"] > 0 and all(s > 0 for s in res["steps_per_s"].values())
    assert [len(s) for s in res["call_seconds"].values()] == [1, 1, 1]
    # the plain versions launch no kernel; the artifact gives the model's bits
    assert res["launches_per_call"] == {way: {} for way in bench_artifact.WAYS}
    assert res["max_abs_gap"] == {"rollout": 0.0, "steploop": 0.0} and res["max_abs_out"] > 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu"} and res["card"] is None
    assert res["grid"] == [8, 16] and res["steps"] == STEPS and res["dtype"] == "float32"
    assert res["traced"]["interp_ops"][0]["count"] == 1


def test_bench_without_the_rollout_way_exports_the_forward_alone():
    res = bench_artifact.main(_argv("--ways", "steploop,inprocess", "--repeats", "0"))
    assert "rollout.pt2" not in res["file_bytes"] and set(res["export_seconds"]) == {
        "forward", "total"}
    assert list(res["steps_per_s"]) == ["steploop", "inprocess"]
    assert res["max_abs_gap"] == {"steploop": 0.0}
    with pytest.raises(ValueError, match="--ways"):
        bench_artifact.main(_argv("--ways", "rollout"))


def test_bench_draws_the_inputs_of_the_tpu_benchmark():
    """input, forcings, constants from default_rng(0) in that order, as
    scripts/bench_artifact.py draws them."""
    import numpy as np

    d = dict(n_common=3, n_time=2, n_forcings=1, n_const=2)
    b = bench_artifact.inputs(d, (2, 4), 3, "cpu")
    rng = np.random.default_rng(0)
    for key, shape in (("input", (1, 2, 4, 6)), ("forcings", (1, 3, 2, 4, 2)),
                       ("constants", (1, 2, 4, 2))):
        np.testing.assert_array_equal(b[key].numpy(),
                                      rng.normal(size=shape).astype(np.float32))


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_artifact.main(["--steps", "1"])


def test_bench_measures_an_artifact_exported_elsewhere(tmp_path):
    """``--artifact``: the grid, steps and config come from the artifact, the
    in-process model computes with its ``params.npz`` (here weights scaled
    after the seeded init, so a model left at its seed would not match)."""
    from paradis_torch.config import load_config
    from paradis_torch.forecast.export import save_artifact

    cfg = load_config(overrides=["compute.use_amp=false", "init.seed=3",
                                 "forecast.output_frequency=1",
                                 f"model.forecast_steps={STEPS}", *TINY])
    model, d = bench_artifact.flagship(cfg, (8, 16), "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    art = save_artifact(tmp_path / "art", model, cfg, batch_size=1, nlat=8, nlon=16,
                        input_dim=d["input_dim"], output_dim=d["output_dim"],
                        n_common=d["n_common"])
    res = bench_artifact.main(["--device", "cpu", "--repeats", "2", "--artifact", str(art)])
    assert res["artifact"] == str(art) and res["grid"] == [8, 16] and res["steps"] == STEPS
    assert res["max_abs_gap"] == {"rollout": 0.0, "steploop": 0.0} and res["max_abs_out"] > 0
    assert set(res["export_seconds"]) == {"forward", "rollout"}
    assert [len(s) for s in res["call_seconds"].values()] == [2, 2, 2]
