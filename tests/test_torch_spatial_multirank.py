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
* The whole model (``model.coarsening_factor`` 2 or 3) on splits that its
  blocks or its coarse grid do not fit (``MODEL_CASES``: a stride that does
  not start every block, a ``lat`` or ``space`` axis that does not divide
  the coarse grid and is collapsed, ``RankGrid.fit``; one under gradient
  checkpointing with ``advect_pos``), in the two layer launches: the
  output, the input's gradient and the parameters' within ``OPS_RTOL`` of
  one process (measured 4.2e-6), on the processor grid each split derives.
* Train steps on ``lat 2 × space 2`` ranks (NorMuon, bicubic), on ``lat 2``
  with gradient checkpointing under ``advect_pos``, truncated
  backpropagation every step of 2 and the band bound (the unbanded kernels'
  plain versions on the clamped positions), on ``space 2`` with the AMSE
  loss and checkpointing under ``none``, and FSDP on ``data 2 × lat 2``
  (4 steps), each against one process with the same weights and batches:
  losses and gradient norms within rtol 1e-5, the parameters within atol
  3e-5 (``tests/test_sharding.py:160-165``).  The FSDP run also holds: its
  gradient norm that of the replicated layout on the same averaged
  gradients within ``FSDP_RTOL``, the parameters of every data group's
  spatial positions bitwise equal after each step, its step-2 sharded
  checkpoint (one shard a data rank, written by the lead positions alone)
  restored bitwise into one process and, in the same ranks, resumed
  bitwise for steps 3–4.
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  paradis_torch.cli.train compute.lat_devices=2`` against one process with
  the global batch (``tests/test_torch_multirank.py``'s run): the same metric
  names at the same steps, each within ``RTOL``, only rank 0's files.
* ``cli.forecast`` on 2 ranks with ``compute.spatial_devices=2``, and on 4
  ranks with ``compute.spatial_devices=4`` and ``model.coarsening_factor=2``
  on an 8 × 12 store (a split the coarse grid does not fit), against one
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
FSDP_RTOL = 1e-6
STEP_CASES = {
    "lat2_space2": ["compute.lat_devices=2", "compute.spatial_devices=2"],
    "lat2_remat_tbptt_band": ["compute.lat_devices=2", "compute.gradient_checkpointing=true",
                              "compute.remat_policy=advect_pos",
                              "training.optimizer.detach_gradient_every=1",
                              "compute.interp_band_rad=0.3"],
    "space2_amse": ["compute.spatial_devices=2", "training.loss_function.type=amse",
                    "compute.gradient_checkpointing=true", "compute.remat_policy=none"],
    "data2_lat2_fsdp": ["compute.lat_devices=2"],
}
# the launches that differ from a step case's default (its spatial ranks, 2
# steps): world size, steps and the worker's settings
FSDP_STEPS, FSDP_RESUME = 4, 2
STEP_LAYOUTS = {"data2_lat2_fsdp": {"world": 4, "steps": FSDP_STEPS,
                                    "settings": {"fsdp": True, "resume": FSDP_RESUME}}}
# the model on splits its blocks or coarse grid do not fit, float32: (the
# layer launch of the grid, whose ranks it runs on), the grid, the overrides
# (its own lat / space), the processor grid's (lat, space) it derives
_MODEL = TINY + ["compute.use_amp=false"]
MODEL_CASES = {
    # the stride misaligned in lat (11-row blocks), coarse rows 8 -> 4 + 4
    "22x24_s3_lat2_space2": (22, [22, 24], _MODEL + [
        "model.coarsening_factor=3", "compute.lat_devices=2", "compute.spatial_devices=2"],
        [2, 2]),
    # coarse rows 3: lat collapsed, the space row kept; under advect_pos
    "8x12_s3_lat2_space2_remat": (22, [8, 12], _MODEL + [
        "model.coarsening_factor=3", "compute.lat_devices=2", "compute.spatial_devices=2",
        "compute.gradient_checkpointing=true", "compute.remat_policy=advect_pos"], [1, 2]),
    # coarse rows 3 on data 2 x lat 2: the processor whole on every rank
    "8x12_s3_lat2": (22, [8, 12], _MODEL + ["model.coarsening_factor=3",
                                            "compute.lat_devices=2"], [1, 1]),
    # misaligned and undivided in longitude (coarse 6 columns on 4 ranks)
    "8x12_s2_space4": (22, [8, 12], _MODEL + ["model.coarsening_factor=2",
                                              "compute.spatial_devices=4"], [1, 1]),
    # coarse columns 4 on space 3: space collapsed, the lat column kept
    "16x12_s3_lat2_space3": (23, [16, 12], _MODEL + [
        "model.coarsening_factor=3", "compute.lat_devices=2", "compute.spatial_devices=3"],
        [2, 1]),
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
        models = [{"grid": g, "overrides": o} for launch_of, g, o, _ in MODEL_CASES.values()
                  if launch_of == 10 * lat + space]
        waits[f"ops{lat}{space}"] = launch(
            [sys.executable, WORKER, "ops", str(base / f"ops{lat}{space}"),
             json.dumps({"lat": lat, "space": space, "grid": grid, "models": models})],
            lat * space, TIMEOUT)
    common = TINY + ["training.optimizer.ns_dtype=float32", "compute.use_amp=false"]
    for name, case in STEP_CASES.items():
        layout = STEP_LAYOUTS.get(name, {})
        one = common + [o for o in case if not o.startswith(("compute.lat", "compute.spatial"))]
        if "detach_gradient_every=1" in " ".join(case):
            one = one + ["model.forecast_steps=2"]
        _inputs(base / f"{name}.npz", one, layout.get("steps", 2))
        for label, world, overrides, more in (
                ("one", 0, one, {}),
                ("ranks", layout.get("world", _spatial(case)), one + [
                    o for o in case if o.startswith(("compute.lat", "compute.spatial"))],
                 layout.get("settings", {}))):
            settings = {"overrides": overrides, "device": "cpu", "grid": [8, 16], **more}
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


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_the_model_on_a_split_its_blocks_do_not_fit_matches_one_process(runs, name):
    """A downsample stride that does not start every block, or a coarse grid
    an axis does not divide (ROADMAP.md, Queue 1 item 8e), on every rank of
    the case's layer launch."""
    launch_of, *_, processor = MODEL_CASES[name]
    index = [k for k, case in MODEL_CASES.items() if case[0] == launch_of].index(name)
    lat, space = divmod(launch_of, 10)
    for r in range(lat * space):
        res = json.loads((runs / f"ops{launch_of}.rank{r}.json").read_text())["models"][index]
        assert res["processor"] == processor, (r, res)
        assert res["gap"] <= OPS_RTOL, (r, res)


def test_fsdp_over_a_data_lat_grid_holds_its_layout_and_resumes_bitwise(runs):
    """``compute.fsdp`` on ``data 2 × lat 2`` (the parametrized step test holds
    it against one process).  The sharded layout computes the replicated
    grid's function (only each parameter's update moves to its owners),
    which ``tests/test_torch_spatial.py`` holds against the JAX ``(1, 2, 2)``
    mesh step, so no JAX mesh is compiled here."""
    from paradis_torch.config import load_config
    from paradis_torch.tools.bench_artifact import flagship
    from paradis_torch.train import build_optimizer
    from paradis_torch.train.checkpoint import load_state_dict
    from paradis_torch.train.sharded_ckpt import read_sharded
    from paradis_torch.train.step import create_train_state

    got = np.load(runs / "data2_lat2_fsdp.ranks.npz")
    np.testing.assert_allclose(got["grad_norm"], got["grad_norm_replicated"][:FSDP_STEPS],
                               rtol=FSDP_RTOL)
    assert got["peers_equal"].tolist() == [True] * FSDP_STEPS
    # #1 and #2 are the plain versions here: no launch on the CPU
    assert got["launches"].shape == (4, 2)
    # the checkpoint: one shard a data rank, written by the lead positions
    # (ranks 0 and 2) alone, whole when read back
    assert got["writers"].tolist() == [0, 2]
    step = runs / "data2_lat2_fsdp.ranks.npz.ckpt" / "steps" / f"{FSDP_RESUME:08d}"
    assert sorted(p.name for p in (step / "state_sharded").iterdir()) == [
        "shard_p0.pt", "shard_p1.pt"]
    saved = read_sharded(step / "state_sharded")
    assert saved["grid"] == [2, 2, 1] and saved["step"] == FSDP_RESUME
    # restored into one process: parameters and optimizer state bitwise
    cfg = load_config(overrides=TINY + ["training.optimizer.ns_dtype=float32",
                                         "compute.use_amp=false"])
    model, _ = flagship(cfg, (8, 16), "cpu")
    state = create_train_state(model, build_optimizer(cfg, model))
    load_state_dict(state, saved)
    assert state.step == FSDP_RESUME
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), got[f"ckpt_param:{name}"]), name
    states = state.optimizer.param_states()["params"]
    assert sorted(states) == sorted(saved["optimizer"]["params"])
    for name, entry in saved["optimizer"]["params"].items():
        for key, v in entry.items():
            assert (v is None and states[name][key] is None) or torch.equal(
                states[name][key], v), (name, key)
    # resumed in the same ranks: steps 3-4 and the final parameters bitwise
    assert np.array_equal(np.float32(got["resumed_loss"]), got["loss"][FSDP_RESUME:])
    assert np.array_equal(np.float32(got["resumed_grad_norm"]),
                          got["grad_norm"][FSDP_RESUME:])
    for k in [k for k in got.files if k.startswith("param:")]:
        assert np.array_equal(got[f"resumed_{k}"], got[k]), k


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
    _same_store(tmp_path / "one.zarr", tmp_path / "two.zarr")


def test_a_split_the_coarse_grid_does_not_fit_forecasts_the_one_process_store(tmp_path):
    """``model.coarsening_factor=2`` on 4 ``space`` ranks of an 8 × 12 store:
    the stride does not start the 3-column blocks and the 6 coarse columns
    do not split 4 ways, so the downsample gathers and the physics layers
    run whole on every rank (ROADMAP.md, Queue 1 item 8e); the lead writes
    the one-process store."""
    from paradis_torch.data.preprocess import preprocess
    from paradis_torch.data.synthetic import build_raw_store
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.tools.bench_artifact import dims

    build_raw_store(str(tmp_path / "raw"), nlat=8, nlon=12, n_times=30,
                    levels=(500, 850, 1000), start="2000-01-01T00:00:00", seed=7)
    store = tmp_path / "store"
    preprocess(str(tmp_path / "raw"), str(store), toa_time_stride=6)
    cfg = torch_toy_config(store, **{"model.coarsening_factor": 2})
    d = dims(cfg)
    lat, lon = equiangular_lat_lon(8, 12, include_poles=False)
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["output_dim"],
                                lat_deg=lat, lon_deg=lon, device="cpu")
    save_params(tmp_path / "params.pt", model)
    args = ["--checkpoint-path", str(tmp_path / "params.pt"), "--root-dir", str(store),
            "--forecast-steps", "4", "--sampling-interval", "12h", "--start-date",
            "2000-01-06", "--end-date", "2000-01-07", "--write-every-n", "2", "--device",
            "cpu", *[a for a in TOY if not a.startswith("training.")],
            "model.coarsening_factor=2"]
    four = launch(_launcher(4, "paradis_torch.cli.forecast")
                  + ["--output-file", str(tmp_path / "four.zarr")] + args
                  + ["compute.spatial_devices=4"], 0, TIMEOUT)
    one = launch([sys.executable, "-m", "paradis_torch.cli.forecast"] + args
                 + ["--output-file", str(tmp_path / "one.zarr")], 0, TIMEOUT)
    outs = four() + one()
    _check(outs)
    assert sum("forecast written" in out for _, out in outs) == 2  # rank 0's, and one's
    _same_store(tmp_path / "one.zarr", tmp_path / "four.zarr")


def _same_store(one_path, ranks_path) -> None:
    """The ranks' store against the one process's: the same arrays,
    coordinates equal, each forecast value within a BitRound(16) step plus
    ``SUM_RTOL`` of the variable's largest value."""
    a, b = zarrlite.open_store(one_path), zarrlite.open_store(ranks_path)
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
