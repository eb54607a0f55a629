"""Spatial ``(lat, space)`` runs of the port on the CPU, ranks over gloo on
``127.0.0.1`` (``tests/torch_rank_worker.py``: each launch in its own
session, killed after ``TIMEOUT`` seconds), against one process.  No JAX
here (the JAX mesh case is ``tests/test_torch_spatial.py``).

* The layers on ``lat 2 × space 2`` and ``lat 2 × space 3`` (``space`` odd:
  the pole roll straddles ranks) grids of ranks (``torch_rank_worker.py
  ops``): the sharded ``geocyclic_pad`` bitwise the block of the whole pad
  for pads 1, 2 and 3, and its backward bitwise the one-process adjoint;
  ``enforce_pole_continuity``, a bicubic advection layer and the
  latitude-weighted loss, outputs and gradients within ``OPS_RTOL`` of one
  process (measured 4.8e-7: the pole means and the advected field's
  cotangent summed in another order); the split Newton–Schulz stack
  (distributed NorMuon) within ``tests/test_torch_optim.py``'s float32
  limit, 2e-6, of the redundant one.
* Train steps on ``lat 2 × space 2`` ranks (NorMuon, bicubic), on ``lat 2``
  with gradient checkpointing under ``advect_pos``, truncated
  backpropagation every step of 2 and the band bound (the unbanded kernels'
  plain versions on the clamped positions), and on ``space 2`` with the AMSE
  loss and checkpointing under ``none``, each against one process with the
  same weights and batches: losses and gradient norms within rtol 1e-5, the
  parameters within atol 3e-5 (``tests/test_sharding.py:160-165``).
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  paradis_torch.cli.train compute.lat_devices=2`` against one process with
  the global batch (``tests/test_torch_multirank.py``'s run): the same metric
  names at the same steps, each within ``RTOL``, only rank 0's files.
* ``cli.forecast`` on 2 ranks with ``compute.spatial_devices=2`` against one
  process: the same arrays, coordinates equal, each forecast value within
  one BitRound(16) step of the one-process store's plus ``SUM_RTOL`` of the
  variable's largest value (float32 sums in another order, which may move a
  value across a rounding boundary; measured 3.1e-8 at a value near zero).
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from paradis_torch.data import zarrlite  # noqa: E402
from paradis_torch.train.checkpoint import save_params  # noqa: E402
from test_torch_multirank import CLOCKS, RUN, TOY, _check, _launcher, _rows, _train_args  # noqa: E402
from torch_parity import TINY, build_torch_toy_store, torch_toy_config  # noqa: E402
from torch_rank_worker import ROOT, launch  # noqa: E402

RTOL = 1e-5
PARAM_ATOL = 3e-5
OPS_RTOL = 1e-5
NS_ATOL = 2e-6
TIMEOUT = 240
WORKER = str(ROOT / "tests" / "torch_rank_worker.py")
BITROUND_STEP = 2.0 ** -16
# float32 sums in another order, relative to the largest value of a variable
# (a value near zero carries the rounding of its larger addends)
SUM_RTOL = 1e-6
STEP_CASES = {
    "lat2_space2": ["compute.lat_devices=2", "compute.spatial_devices=2"],
    "lat2_remat_tbptt_band": ["compute.lat_devices=2", "compute.gradient_checkpointing=true",
                              "compute.remat_policy=advect_pos",
                              "training.optimizer.detach_gradient_every=1",
                              "compute.interp_band_rad=0.3"],
    "space2_amse": ["compute.spatial_devices=2", "training.loss_function.type=amse",
                    "compute.gradient_checkpointing=true", "compute.remat_policy=none"],
}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_torch_toy_store(tmp_path_factory.mktemp("spatial"))


def _inputs(path, overrides, steps: int):
    """The model's starting weights and ``steps`` global batches of 2 on the
    8 × 16 toy grid, as ``torch_rank_worker.py`` reads them."""
    from paradis_torch.config import load_config
    from paradis_torch.tools.bench_artifact import flagship

    cfg = load_config(overrides=overrides)
    model, d = flagship(cfg, (8, 16), "cpu")
    S = int(cfg.model.forecast_steps)
    rng = np.random.default_rng(3)
    shapes = {"input": (2, 8, 16, d["n_common"] * d["n_time"]),
              "target": (2, S, 8, 16, d["output_dim"]),
              "forcings": (2, S, 8, 16, d["n_forcings"] * d["n_time"]),
              "constants": (2, 8, 16, d["n_const"])}
    arrays = {f"param:{n}": p.detach().numpy() for n, p in model.named_parameters()}
    for k in range(steps):
        arrays.update({f"batch{k}:{key}": rng.normal(size=s).astype(np.float32)
                       for key, s in shapes.items()})
    np.savez(path, **arrays)


def _spatial(overrides) -> int:
    n = 1
    for o in overrides:
        if o.startswith(("compute.lat_devices=", "compute.spatial_devices=")):
            n *= int(o.split("=")[1])
    return n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the layer checks and the train steps, started
    together, and their results."""
    base = tmp_path_factory.mktemp("spatial_runs")
    waits = {}
    for lat, space, grid in ((2, 2, [8, 16]), (2, 3, [8, 12])):
        waits[f"ops{lat}{space}"] = launch(
            [sys.executable, WORKER, "ops", str(base / f"ops{lat}{space}"),
             json.dumps({"lat": lat, "space": space, "grid": grid})], lat * space, TIMEOUT)
    common = TINY + ["training.optimizer.ns_dtype=float32", "compute.use_amp=false"]
    for name, case in STEP_CASES.items():
        one = common + [o for o in case if not o.startswith(("compute.lat", "compute.spatial"))]
        if "detach_gradient_every=1" in " ".join(case):
            one = one + ["model.forecast_steps=2"]
        _inputs(base / f"{name}.npz", one, 2)
        for label, world, overrides in (("one", 0, one),
                                        ("ranks", _spatial(case), one + [
                                            o for o in case if o.startswith(
                                                ("compute.lat", "compute.spatial"))])):
            settings = {"overrides": overrides, "device": "cpu", "grid": [8, 16]}
            waits[f"{name}:{label}"] = launch(
                [sys.executable, WORKER, str(base / f"{name}.npz"),
                 str(base / f"{name}.{label}.npz"), json.dumps(settings)], world, TIMEOUT)
    for key, wait in waits.items():
        _check(wait())
    return base


@pytest.mark.parametrize("lat,space", [(2, 2), (2, 3)])
def test_the_layers_on_a_grid_of_ranks_match_one_process(runs, lat, space):
    found = [json.loads((runs / f"ops{lat}{space}.rank{r}.json").read_text())
             for r in range(lat * space)]
    for res in found:
        for pad, (fwd, bwd) in res["pad"].items():
            assert fwd and bwd, (res["rank"], pad)
        for key in ("pole", "advection", "loss"):
            assert res[key] <= OPS_RTOL, (res["rank"], key, res[key])
        assert res["ns"] <= NS_ATOL and res["ns_ways"] == lat * space


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_a_spatial_train_step_matches_one_process(runs, name):
    one, ranks = (np.load(runs / f"{name}.{label}.npz") for label in ("one", "ranks"))
    for key in ("loss", "grad_norm", "loss_per_step"):
        np.testing.assert_allclose(ranks[key], one[key], rtol=RTOL, err_msg=key)
    params = [k for k in one.files if k.startswith("param:")]
    assert params
    for k in params:
        np.testing.assert_allclose(ranks[k], one[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    if "detach_gradient_every=1" in " ".join(STEP_CASES[name]):
        assert ranks["loss_per_step"].shape == (2, 2)


def test_two_lat_ranks_train_as_one_process(store, tmp_path):
    """``compute.lat_devices=2`` on 2 ranks, each its 4 of the toy grid's 8
    latitudes of the global batch of 2, against one process with that
    batch."""
    waits = {
        "lat2": launch(_launcher(2, "paradis_torch.cli.train") + _train_args(
            store, tmp_path / "lat2", **{"compute.lat_devices": 2, "compute.batch_size": 2}),
            0, TIMEOUT),
        "one": launch([sys.executable, "-m", "paradis_torch.cli.train"] + _train_args(
            store, tmp_path / "one", **{"compute.batch_size": 2}), 0, TIMEOUT),
    }
    for wait in waits.values():
        _check(wait())
    lat2, one = _rows(tmp_path / "lat2"), _rows(tmp_path / "one")
    assert {k: len(v) for k, v in lat2.items()} == {k: len(v) for k, v in one.items()}
    assert {n for _, n in lat2} >= {"train_loss", "grad_norm", "val_loss", "lr", "grad/total"}
    for key, v in one.items():
        if key[1] not in CLOCKS:
            np.testing.assert_allclose(lat2[key], v, rtol=RTOL, err_msg=str(key))
    files = {str(p.relative_to(tmp_path / "one")) for p in (tmp_path / "one").rglob("*")
             if p.is_file()}
    assert {str(p.relative_to(tmp_path / "lat2")) for p in (tmp_path / "lat2").rglob("*")
            if p.is_file()} == files


def test_a_spatial_forecast_writes_the_one_process_store(store, tmp_path):
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.tools.bench_artifact import dims

    cfg = torch_toy_config(store)
    d = dims(cfg)
    lat, lon = equiangular_lat_lon(8, 16, include_poles=False)
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["output_dim"],
                                lat_deg=lat, lon_deg=lon, device="cpu")
    save_params(tmp_path / "params.pt", model)
    args = ["--checkpoint-path", str(tmp_path / "params.pt"), "--root-dir", str(store),
            "--forecast-steps", "4", "--sampling-interval", "12h", "--start-date",
            "2000-01-06", "--end-date", "2000-01-07", "--write-every-n", "2", "--device",
            "cpu", *[a for a in TOY if not a.startswith("training.")]]
    two = launch(_launcher(2, "paradis_torch.cli.forecast")
                 + ["--output-file", str(tmp_path / "two.zarr")] + args
                 + ["compute.spatial_devices=2"], 0, TIMEOUT)
    one = launch([sys.executable, "-m", "paradis_torch.cli.forecast"] + args
                 + ["--output-file", str(tmp_path / "one.zarr")], 0, TIMEOUT)
    outs = two() + one()
    _check(outs)
    assert sum("forecast written" in out for _, out in outs) == 2  # rank 0's, and one's
    a, b = zarrlite.open_store(tmp_path / "one.zarr"), zarrlite.open_store(tmp_path / "two.zarr")
    assert sorted(a.arrays()) == sorted(b.arrays())
    assert a["time"].shape == (3,)
    for name in a.arrays():
        x, y = a[name][...], b[name][...]
        assert x.shape == y.shape, name
        if x.dtype.kind != "f" or x.ndim < 3:
            np.testing.assert_array_equal(x, y, err_msg=name)
            continue
        assert np.isfinite(y).sum() == np.isfinite(x).sum(), name
        ok = np.isfinite(x)
        bound = BITROUND_STEP * np.abs(x[ok]) + SUM_RTOL * np.abs(x[ok]).max()
        np.testing.assert_array_less(np.abs(y[ok] - x[ok]), bound + 1e-30, err_msg=name)
