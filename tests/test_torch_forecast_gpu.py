"""The forecast CLI on a card against the same run on the CPU.

Marked ``gpu``: the test skips without a CUDA device.  The file imports
nothing of JAX (the toy store is the port's own, ``tests/torch_toy.py``), so
it runs where the suite's ``conftest.py`` is skipped:

    python -m pytest --noconftest tests/test_torch_forecast_gpu.py -m gpu
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from paradis_torch.cli import forecast as forecast_cli  # noqa: E402
from paradis_torch.data import zarrlite  # noqa: E402
from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.forecast.writer import chunk_codecs  # noqa: E402
from paradis_torch.model import Paradis  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.train.checkpoint import save_params  # noqa: E402
from torch_toy import TOY_LEVELS, build_torch_toy_store, torch_toy_config  # noqa: E402

STEPS = 4
# BitRound(16): two stores of values that agree land at most 2^-16 of their
# magnitude apart.  Beyond it, the card's rollout (the CUDA kernels, cuBLAS)
# and the CPU's (the plain versions) sum in other orders: float32 gaps of
# ~1e-6 of a normalized unit a step, which the limit bounds at 1e-4 of each
# variable's spread over the store.
BITROUND_STEP = 2.0 ** -16
SPREAD_SHARE = 1e-4


@pytest.mark.gpu
def test_cli_forecast_on_the_card_matches_the_cpu_run(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = build_torch_toy_store(tmp_path)
    cfg = torch_toy_config(store)
    ds = ERA5Dataset(str(store), "2000-01-03", "2000-01-04", forecast_steps=STEPS, cfg=cfg,
                     prediction_stage=True)
    model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                output_dim=ds.num_out_features, lat_deg=ds.lat,
                                lon_deg=ds.lon, device="cpu")
    save_params(tmp_path / "params.pt", model)
    toy = [f"features.pressure_levels=[{','.join(map(str, TOY_LEVELS))}]",
           "model.latent_size=16", "model.velocity_vectors=4", "model.num_layers=2",
           "model.bias_channels=2", "model.bias_rank=4",
           "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
           "model.physblock.output_proj.hidden_dim=8"]

    def run(device):
        out = tmp_path / f"fc_{device}.zarr"
        stats = forecast_cli.main(["--checkpoint-path", str(tmp_path / "params.pt"),
                                   "--output-file", str(out), "--root-dir", str(store),
                                   "--forecast-steps", str(STEPS), "--sampling-interval",
                                   "12h", "--start-date", "2000-01-03", "--end-date",
                                   "2000-01-04", "--write-every-n", "3", "--batch-size", "2",
                                   "--device", device, *toy])
        return zarrlite.open_store(out), stats, out

    before = interp_cuda.launches
    gpu, stats, out = run("cuda")
    batches = -(-stats["samples"] // 2)
    # the unbanded forward once a layer (2) and step in every batch
    assert stats["samples"] == 4 and interp_cuda.launches - before == 2 * STEPS * batches
    cpu, _, _ = run("cpu")
    assert set().union(*chunk_codecs(out).values()) == {"zstd"}
    names = [n for n in cpu.arrays() if cpu[n].ndim >= 4]
    assert "dewpoint_depression" in names and len(names) > 5
    for name in names:
        a, b = np.asarray(gpu[name][...], np.float64), np.asarray(cpu[name][...], np.float64)
        np.testing.assert_array_equal(a[:, 0], b[:, 0], err_msg=name)  # the initial state
        assert np.isfinite(a[:, 1:]).all(), name
        limit = BITROUND_STEP * np.abs(b[:, 1:]) + SPREAD_SHARE * np.nanstd(b[:, 1:])
        gap = np.abs(a[:, 1:] - b[:, 1:])
        assert (gap <= limit).all(), (name, float((gap - limit).max()))
