"""Forecast scoring of the port (``paradis_torch.forecast.evaluate``) against
the JAX package's, on the CPU.

One forecast store, written by the port's writer from the toy store's
normalized truth plus seeded noise, scored by both packages' ``evaluate_store``
against the preprocessed toy store (``TruthReader``) and a raw WB2-layout
archive of the same fields (``WB2TruthReader``), with and without the
preprocessor's climatology: the same keys, and values within ``RTOL``.
"""

import pytest

torch = pytest.importorskip("torch")

import warnings  # noqa: E402

import numpy as np  # noqa: E402

from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.data.synthetic import build_raw_store  # noqa: E402
from paradis_torch.forecast import ZarrForecastWriter  # noqa: E402
from paradis_torch.forecast.evaluate import (  # noqa: E402
    TruthReader,
    WB2TruthReader,
    evaluate_store,
    open_truth,
)
from paradis_tpu.forecast import evaluate as j_eval  # noqa: E402
from torch_parity import build_torch_toy_store, torch_toy_config  # noqa: E402
from torch_toy import TOY_LEVELS, TOY_NLAT, TOY_NLON, TOY_TIMES  # noqa: E402

# float64 on both sides; the port's grid means are torch's float64 sums, the
# JAX package's numpy's (pairwise), so the two may differ in the last bits of
# each mean: ~1e-16 relative, carried through a square root or a ratio.
RTOL = 1e-12
VARIABLES = [("geopotential", 500), ("temperature", 850), ("specific_humidity", 850),
             ("2m_temperature", None), ("mean_sea_level_pressure", None)]
LEADS = [6, 12, 18, 24]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_toy")
    store = build_torch_toy_store(base)
    raw_wb2 = base / "raw_wb2"
    build_raw_store(str(raw_wb2), nlat=TOY_NLAT, nlon=TOY_NLON, n_times=TOY_TIMES,
                    levels=TOY_LEVELS, start="2000-01-01T00:00:00", seed=7, wb2_layout=True)
    cfg = torch_toy_config(store, **{"forecast.enable": True, "model.forecast_steps": 4})
    window = ("2000-01-02", "2000-01-03")
    ds = ERA5Dataset(str(store), *window, forecast_steps=4, cfg=cfg, prediction_stage=True,
                     time_interval="12h")
    truth = ERA5Dataset(str(store), *window, forecast_steps=4, cfg=cfg, time_interval="12h")
    out = base / "fc.zarr"
    writer = ZarrForecastWriter(cfg, ds, output_file=str(out))
    writer.init_store(ds)
    rng = np.random.default_rng(5)
    for i in range(len(ds)):
        _, y, _, _ = truth[i]  # [S, H, W, C] normalized targets
        fc = np.moveaxis(y, -1, 1)[None] + 0.1 * rng.normal(size=(1, *y.shape[:1], y.shape[3],
                                                                    *y.shape[1:3]))
        writer.write_forecast_chunk(fc.astype(np.float32), np.asarray([i]), 0, ds)
    return {"store": store, "raw_wb2": raw_wb2, "forecast": out,
            "climatology": store / "climatology"}


@pytest.mark.parametrize("with_climatology", [False, True])
@pytest.mark.parametrize("truth", ["store", "raw_wb2"])
def test_evaluate_matches_jax(setup, truth, with_climatology):
    clim = str(setup["climatology"]) if with_climatology else None
    args = (str(setup["forecast"]), str(setup[truth]), VARIABLES, LEADS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the in-sample warning, tested below
        ref = j_eval.evaluate_store(*args, climatology=clim)
        got = evaluate_store(*args, climatology=clim, device="cpu")
    assert sorted(got) == sorted(ref)
    assert len(got) == len(VARIABLES) * len(LEADS) * 2  # RMSE and ACC at every lead
    for key, value in ref.items():
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], value, rtol=RTOL, atol=0, err_msg=key)
    # a forecast of the truth plus noise of 0.1 std: ACC high, not perfect
    assert 0.5 < got["geopotential_h500@6h:acc"] < 1.0


def test_in_sample_climatology_warns_and_an_external_one_does_not(setup):
    args = (str(setup["forecast"]), str(setup["store"]), VARIABLES[:1], LEADS[:1])
    with pytest.warns(UserWarning, match="NOT WB2-comparable"):
        in_sample = evaluate_store(*args, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        external = evaluate_store(*args, climatology=str(setup["climatology"]), device="cpu")
    key = "geopotential_h500@6h"
    assert in_sample[key] == external[key]
    assert in_sample[key + ":acc"] != external[key + ":acc"]


@pytest.mark.parametrize("truth", ["store", "raw_wb2"])
def test_truth_readers_match_jax_bitwise(setup, truth):
    got, ref = open_truth(str(setup[truth])), j_eval.open_truth(str(setup[truth]))
    assert isinstance(got, TruthReader if truth == "store" else WB2TruthReader)
    np.testing.assert_array_equal(got.times, ref.times)
    for name in ("geopotential_h500", "2m_temperature", "specific_humidity_h850"):
        for t in (got.times[3], got.times[-1]):
            np.testing.assert_array_equal(got.field(name, t), ref.field(name, t))
    missing = got.times[-1] + np.timedelta64(6, "h")
    assert got.field("geopotential_h500", missing) is None
