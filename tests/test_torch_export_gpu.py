"""The serving artifact on a card: export, load, the kernels' launches
through both loaded programs and their gap to the in-process rollout; and
``cli.export`` at its default ``--device cuda`` from a ``save_params``
checkpoint, served by ``load_artifact``.

Marked ``gpu``: the tests skip without a CUDA device.  The file imports
nothing of JAX, so it runs where the suite's ``conftest.py`` is skipped:

    python -m pytest --noconftest tests/test_torch_export_gpu.py -m gpu
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from paradis_torch.cli import export as export_cli  # noqa: E402
from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.forecast.export import load_artifact  # noqa: E402
from paradis_torch.model import Paradis  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.tools import bench_artifact  # noqa: E402
from paradis_torch.train.checkpoint import load_params, save_params  # noqa: E402
from torch_toy import TOY_LEVELS, build_torch_toy_store, torch_toy_config  # noqa: E402

TOY = ["model.latent_size=32", "model.velocity_vectors=8", "model.num_layers=2",
       "model.physblock.velocity_net.hidden_dim=16", "model.physblock.reaction.hidden_dim=16",
       "model.physblock.output_proj.hidden_dim=16", "model.bias_channels=2",
       "model.bias_rank=4"]
STEPS, LAYERS = 4, 2
# the tolerance of tests/test_export.py's rollout check: 1e-5 of the largest
# output (the programs run the model's kernels in its order: 0 is expected)
GAP_SHARE = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("grid,overrides,kernel", [
    ("32,64", [], "interp_fwd"),
    ("128,256", ["compute.interp_band_rad=0.3"], "interp_band_fwd"),
])
def test_artifact_on_the_card_launches_the_kernels_and_matches_the_rollout(grid, overrides,
                                                                          kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    argv = ["--grid", grid, "--steps", str(STEPS), "--repeats", "1"]
    for override in TOY + overrides:
        argv += ["--override", override]
    res = bench_artifact.main(argv)
    # one forward interpolation a layer and step, through the loaded programs too
    for way in bench_artifact.WAYS:
        assert res["launches_per_call"][way] == {kernel: LAYERS * STEPS}, way
    assert res["device"]["platform"] == "gpu" and res["card"]
    for way, gap in res["max_abs_gap"].items():
        assert gap <= GAP_SHARE * res["max_abs_out"], (way, gap)
    # the band plan, read at trace time, lives in the graph
    assert (res["traced"]["interp_ops"][0]["band_plan"] is not None) == bool(overrides)


@pytest.mark.gpu
def test_cli_export_at_its_default_device_serves_on_the_card(tmp_path):
    """``--device`` left at ``cuda`` (no index) traces on the current card;
    the loaded forward launches the kernel once a layer and gives the
    model's output with the checkpoint's weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = build_torch_toy_store(tmp_path)
    cfg = torch_toy_config(store)
    ds = ERA5Dataset(str(store), "2000-01-01", "2000-01-05", forecast_steps=1, cfg=cfg)
    dims = dict(input_dim=ds.num_in_features, output_dim=ds.num_out_features,
                lat_deg=ds.lat, lon_deg=ds.lon)
    save_params(tmp_path / "params.pt", Paradis.from_config(cfg, **dims, seed=11, device="cpu"))
    toy = [f"features.pressure_levels=[{','.join(map(str, TOY_LEVELS))}]",
           "model.latent_size=16", "model.velocity_vectors=4", f"model.num_layers={LAYERS}",
           "model.bias_channels=2", "model.bias_rank=4",
           "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
           "model.physblock.output_proj.hidden_dim=8", f"model.forecast_steps={STEPS}"]
    out = export_cli.main(["--checkpoint-path", str(tmp_path / "params.pt"), "--output-dir",
                           str(tmp_path / "art"), "--root-dir", str(store), *toy])
    serving = load_artifact(out)
    card = torch.device("cuda", torch.cuda.current_device())
    assert serving.device == card and serving.manifest["device"] == str(card)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=serving.manifest["input_shape"]).astype(np.float32)).to(card)
    before = interp_cuda.launches
    got = serving(x)
    assert interp_cuda.launches - before == LAYERS
    model = Paradis.from_config(cfg, **dims, dtype=torch.float32, device="cuda")
    load_params(tmp_path / "params.pt", model)
    with torch.no_grad():
        want = model(x)
    assert float((got - want).abs().max()) <= GAP_SHARE * float(want.abs().max())
