"""The measuring tools on a card, where they hold launch counts.

- ``bench_forecast``: one 40-step rollout launches #1 (``interp_fwd``) 320
  times at 5.625° and the banded #5 (``interp_band_fwd``) 320 times at
  1.40625°, no other interpolation kernel;
- ``bench_highres``: a 1.40625° train step launches #5 16 times (8, and 8
  in the backward's replay) and #6 (``interp_band_bwd``) 8 times;
- ``profile_step --bucket source`` at 5.625°: the kernels of the
  interpolation forward and backward and of the optimizer are found in
  their buckets, and what no bucket holds is a small share;
- ``bench_pipeline`` with the place stage to the card.

Marked ``gpu``: the tests skip without a CUDA device.  The file imports
nothing of JAX, so it runs where the suite's ``conftest.py`` is skipped:

    python -m pytest --noconftest tests/test_torch_tools_gpu.py -m gpu
"""

import pytest

torch = pytest.importorskip("torch")

from paradis_torch.tools import (bench_forecast, bench_highres, bench_pipeline,  # noqa: E402
                                 profile_step)

ONE = ["--chain-short", "0", "--chain-long", "1", "--repeats", "1"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("grid,kernel", [([], "interp_fwd"),
                                         (["--nlat", "128", "--nlon", "256"],
                                          "interp_band_fwd")])
def test_bench_forecast_launches_the_forward_320_times_a_rollout(grid, kernel):
    _card()
    res = bench_forecast.main([*grid, *ONE])
    assert res["launches_per_rollout"] == {kernel: 320}
    assert res["finite"] and res["forecast_steps_per_sec"] > 0


@pytest.mark.gpu
def test_bench_highres_launches_the_banded_pair_16_and_8_times_a_step():
    _card()
    res = bench_highres.main(ONE)
    assert res["launches_per_step"] == {"interp_band_fwd": 16, "interp_band_bwd": 8}
    assert res["grid"] == "128x256" and res["step_ms"] > 0


@pytest.mark.gpu
def test_profile_step_attributes_the_kernels_to_their_source():
    _card()
    res = profile_step.main(["--steps", "1", "--top", "5"])
    src = res["by_source"]
    for part in ("interpolation", "backward: interpolation", "optimizer", "velocity_net",
                 "backward: reaction"):
        assert src.get(part, 0) > 0, part
    assert res["unattributed_ms_per_step"] < 0.1 * res["ms_per_step"]
    assert sum(src.values()) == pytest.approx(res["ms_per_step"])


@pytest.mark.gpu
def test_bench_pipeline_places_batches_on_the_card():
    _card()
    res = bench_pipeline.main(["--samples", "8"])
    assert res["with_place"]["samples"] == 8 and res["host"]["samples"] == 8
