"""Forecast I/O of the port against the JAX package's, on the CPU.

``utils/thermo.py`` and ``utils/postprocessing.py`` bitwise against their
JAX originals; ``ZarrForecastWriter`` from both packages, given the same
normalized forecast array, writing the same bytes (Blosc-zstd on both
sides, through the native host library); ``run_forecast`` of the port
(``device="cpu"``, the JAX initial weights bridged in) against the JAX
``run_forecast`` on the toy store, the file's one JAX compile; the CLI in a
subprocess with ``--device cpu``, scored by ``forecast.evaluate``; the
refusals of a second device; and the ``compute.advection_impl`` values
(``pallas`` / ``auto_train`` bitwise ``auto``, ``gather`` against the JAX
gather formulation).
"""

import pytest

torch = pytest.importorskip("torch")

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fixtures import toy_config  # noqa: E402
from paradis_torch.data import native, zarrlite  # noqa: E402
from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.data.pipeline import BatchLoader  # noqa: E402
from paradis_torch.forecast import ZarrForecastWriter, run_forecast  # noqa: E402
from paradis_torch.forecast.evaluate import main as evaluate_main  # noqa: E402
from paradis_torch.forecast.writer import _renamed_vars, chunk_codecs  # noqa: E402
from paradis_torch.model import Paradis, load_flax_params  # noqa: E402
from paradis_torch.ops.interp import interp_gather  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon  # noqa: E402
from paradis_torch.train.checkpoint import save_params  # noqa: E402
from paradis_torch.utils import postprocessing as t_post  # noqa: E402
from paradis_torch.utils import thermo as t_thermo  # noqa: E402
from paradis_tpu.data.dataset import ERA5Dataset as JaxERA5Dataset  # noqa: E402
from paradis_tpu.data.pipeline import BatchLoader as JaxBatchLoader  # noqa: E402
from paradis_tpu.forecast.rollout import run_forecast as jax_run_forecast  # noqa: E402
from paradis_tpu.forecast.writer import ZarrForecastWriter as JaxZarrForecastWriter  # noqa: E402
from paradis_tpu.model.paradis import Paradis as JaxParadis  # noqa: E402
from paradis_tpu.ops.interp import grid_sample_interp  # noqa: E402
from paradis_tpu.utils import postprocessing as j_post  # noqa: E402
from paradis_tpu.utils import thermo as j_thermo  # noqa: E402
from torch_parity import build_pair, build_torch_toy_store, torch_toy_config  # noqa: E402
from torch_toy import TOY_LEVELS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WINDOW = ("2000-01-02", "2000-01-04")  # forecast init dates on the toy store
# BitRound(16) keeps 16 of float32's 23 mantissa bits: a stored value is within
# half a step, 2^-17 of its magnitude, of what was written, so two stores of
# values that agree land at most one step, 2^-16, apart.
BITROUND_STEP = 2.0 ** -16
# the rollout's own gap between the packages in normalized units (the limit
# of tests/test_torch_rollout.py, 10× its measured 5e-7)
ROLLOUT_ATOL = 5e-6


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_torch_toy_store(tmp_path_factory.mktemp("fc_toy"))


def _cfgs(store, **overrides):
    overrides = {"forecast.enable": True, **overrides}
    return toy_config(store, **overrides), torch_toy_config(store, **overrides)


def _datasets(store, cfgs, steps, window=WINDOW, interval=None):
    kw = dict(forecast_steps=steps, prediction_stage=True, time_interval=interval)
    return (JaxERA5Dataset(str(store), *window, cfg=cfgs[0], **kw),
            ERA5Dataset(str(store), *window, cfg=cfgs[1], **kw))


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


# -- thermo and postprocessing: bitwise ------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thermo_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(1)
    q = rng.uniform(-1e-4, 2e-2, size=(3, 4, 5)).astype(dtype)
    t = rng.uniform(200.0, 310.0, size=(3, 4, 5)).astype(dtype)
    p = np.asarray([500.0, 850.0, 1000.0], dtype)[:, None, None] * 100.0
    np.testing.assert_array_equal(t_thermo.vapor_pressure(q, p), j_thermo.vapor_pressure(q, p))
    got = t_thermo.dewpoint_depression(q, t, p)
    np.testing.assert_array_equal(got, j_thermo.dewpoint_depression(q, t, p))
    assert got.max() <= t_thermo.MAX_DEPRESSION


def test_winds_match_jax_bitwise():
    rng = np.random.default_rng(2)
    levels = list(TOY_LEVELS)
    features = ([f"{v}_h{lv}" for v in ("geopotential", "wind_x", "wind_y", "wind_z",
                                        "temperature") for lv in levels]
                + ["wind_x_10m", "wind_y_10m", "wind_z_10m", "2m_temperature"])
    lat, lon = np.linspace(-78.75, 78.75, 8), np.linspace(0.0, 337.5, 16)
    x = rng.normal(size=(2, 3, len(features), 8, 16)).astype(np.float32)
    x[:, :, [features.index(f"temperature_h{lv}") for lv in levels]] += 260.0
    for name in ("wind_x", "temperature", "wind_x_10m"):
        np.testing.assert_array_equal(t_post.feature_indices(name, features),
                                      j_post.feature_indices(name, features))
    a, b = x.copy(), x.copy()
    t_post.convert_cartesian_to_spherical_winds(lat, lon, levels, a, features)
    j_post.convert_cartesian_to_spherical_winds(lat, lon, levels, b, features)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, x)
    args = [x[0, 0, i] for i in range(3)]
    latr, lonr = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None]
    for u, v in zip(t_post.spherical_wind_10m(*args, latr, lonr),
                    j_post.spherical_wind_10m(*args, latr, lonr)):
        np.testing.assert_array_equal(u, v)
    for u, v in zip(t_post.spherical_wind_3d(*args, x[0, 0, 3] + 260.0, 5e4, latr, lonr),
                    j_post.spherical_wind_3d(*args, x[0, 0, 3] + 260.0, 5e4, latr, lonr)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("standard", [False, True])
def test_denormalize_forecast_matches_jax_bitwise(store, standard):
    """The numpy inverses take log(q_min) in float32, as the JAX package's."""
    cfgs = _cfgs(store, **{"normalization.standard": standard})
    jds, tds = _datasets(store, cfgs, 2)
    assert tds.custom_normalization is (not standard)
    assert len(tds.norm_humidity_out) == (0 if standard else len(TOY_LEVELS))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, tds.num_out_features, 8, 16)).astype(np.float32)
    a, b = x.copy(), x.copy()
    t_post.denormalize_forecast(a, tds)
    j_post.denormalize_forecast(b, jds)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


# -- the writer: the same bytes -------------------------------------------------

def test_writer_writes_the_same_bytes_as_jax(store, tmp_path):
    """``init_store`` and two region writes (``start_idx`` 0 with an unsorted
    ``sample_indices`` that splits into two contiguous groups, then
    ``start_idx`` 2), every chunk, ``.zarray``, ``.zattrs`` and the
    consolidated metadata byte for byte.  The codec is Blosc-zstd on both
    sides (the native library is present), read back from the chunks."""
    native.require()
    cfgs = _cfgs(store, **{"model.forecast_steps": 4})
    jds, tds = _datasets(store, cfgs, 4)
    rng = np.random.default_rng(4)
    idx = np.asarray([3, 0, 1])
    fc = (0.5 * rng.normal(size=(2, len(idx), 4, tds.num_out_features, 8, 16))
          ).astype(np.float32)
    for pkg, writer_cls, cfg, ds in (("jax", JaxZarrForecastWriter, cfgs[0], jds),
                                     ("torch", ZarrForecastWriter, cfgs[1], tds)):
        w = writer_cls(cfg, ds, output_file=str(tmp_path / pkg / "fc.zarr"))
        w.init_store(ds)
        w.write_forecast_chunk(fc[0, :, :2], idx, 0, ds)
        w.write_forecast_chunk(fc[1, :, 2:], idx[::-1], 2, ds)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert sorted(a) == sorted(b) and len(a) > 50
    assert [n for n in a if a[n] != b[n]] == []
    codecs = chunk_codecs(tmp_path / "torch" / "fc.zarr")
    assert "dewpoint_depression" in codecs
    assert set().union(*codecs.values()) == {"zstd"}
    g = zarrlite.open_store(tmp_path / "torch" / "fc.zarr")
    z = g["geopotential"][...]
    assert np.isfinite(z[[0, 1, 3]]).all()
    assert np.isnan(z[2]).all() and np.isnan(z[4:]).all()  # init times not written


# -- run_forecast: the port against the JAX package --------------------------------

def _capture(writer, store: list):
    """Keep the normalized arrays ``writer`` is given, in write order."""
    write = writer.write_forecast_chunk

    def recorded(forecast, sample_indices, start_idx, dataset):
        store.append((np.array(forecast), np.array(sample_indices), start_idx))
        return write(forecast=forecast, sample_indices=sample_indices,
                     start_idx=start_idx, dataset=dataset)

    writer.write_forecast_chunk = recorded


def _physical(x, ds, features, levels):
    """The writer's postprocessing of a normalized [B, T, F, H, W] array, in
    float64: the denormalized, wind-converted fields and the dewpoint
    depression."""
    y = x.astype(np.float64)
    t_post.denormalize_forecast(y, ds)
    t_post.convert_cartesian_to_spherical_winds(ds.lat, ds.lon, levels, y, features)
    q = y[:, :, t_post.feature_indices("specific_humidity", features)]
    t = y[:, :, t_post.feature_indices("temperature", features)]
    levels_pa = np.asarray(levels, np.float64)[:, None, None] * 100.0
    return y, t_thermo.dewpoint_depression(q, t, levels_pa)


def _sensitivity(x, ds, features, levels, h=1e-4):
    """Σ_c |∂ stored / ∂ x_c| at ``x`` (finite differences): a normalized gap
    of at most ε in every channel moves a stored value by at most ε times
    this, to first order."""
    base = _physical(x, ds, features, levels)
    sens = [np.zeros_like(a) for a in base]
    for c in range(x.shape[2]):
        xp = x.astype(np.float64).copy()
        xp[:, :, c] += h
        for s, a, b in zip(sens, base, _physical(xp, ds, features, levels)):
            s += np.abs(b - a) / h
    return sens


def test_run_forecast_matches_jax(store, tmp_path):
    """Two init times in one batch, 3 steps, written 2 stored steps at a
    time.  Bound on each stored value at td ≥ 1: one BitRound(16) step of
    its magnitude plus ROLLOUT_ATOL times Σ_c |∂ value / ∂ channel c| (the
    normalized rollout gap carried through denormalization, the wind
    conversion and the dewpoint depression; for a z-scored channel this is
    ROLLOUT_ATOL times its std).  td = 0, the initial state, is bitwise."""
    steps, over = 3, {"model.forecast_steps": 3, "forecast.write_every_n": 2}
    jcfg, tcfg = _cfgs(store, **over, **{"compute.advection_impl": "xla"})
    jds, tds = _datasets(store, (jcfg, tcfg), steps, ("2000-01-02", "2000-01-03"), "24h")
    assert len(jds) == len(tds) == 2
    jm = JaxParadis.from_config(jcfg, input_dim=jds.num_in_features,
                                output_dim=jds.num_out_features, lat_deg=jds.lat,
                                lon_deg=jds.lon, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16, jds.num_in_features)))
    tcfg.compute.advection_impl = "auto"
    model = Paradis.from_config(tcfg, input_dim=tds.num_in_features,
                                output_dim=tds.num_out_features, lat_deg=tds.lat,
                                lon_deg=tds.lon, dtype=torch.float32, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))

    seen = {"jax": [], "torch": []}
    jw = JaxZarrForecastWriter(jcfg, jds, output_file=str(tmp_path / "jax.zarr"))
    _capture(jw, seen["jax"])
    jax_run_forecast(jm, params, jds, jcfg, jw, JaxBatchLoader(jds, 2, drop_last=False))
    tw = ZarrForecastWriter(tcfg, tds, output_file=str(tmp_path / "torch.zarr"))
    _capture(tw, seen["torch"])
    stats = run_forecast(model, tds, tcfg, tw, BatchLoader(tds, 2, drop_last=False,
                                                           device="cpu"))
    assert stats["steps"] == 2 * steps and stats["samples"] == 2
    assert [(i.tolist(), s) for _, i, s in seen["torch"]] == [([0, 1], 0), ([0, 1], 2)]
    assert [(i.tolist(), s) for _, i, s in seen["jax"]] == [([0, 1], 0), ([0, 1], 2)]

    x_ref = np.concatenate([f for f, _, _ in seen["jax"]], axis=1)
    x_got = np.concatenate([f for f, _, _ in seen["torch"]], axis=1)
    np.testing.assert_allclose(x_got, x_ref, atol=ROLLOUT_ATOL, rtol=0)

    features, levels = list(tds.dyn_output_features), list(TOY_LEVELS)
    sens, sens_dd = _sensitivity(x_ref, tds, features, levels)
    atmo, surf = _renamed_vars(tcfg)
    bounds = {out: sens[:, :, t_post.feature_indices(name, features)] for name, out in atmo}
    bounds.update({out: sens[:, :, features.index(name)] for name, out in surf})
    bounds["dewpoint_depression"] = sens_dd
    gj = zarrlite.open_store(tmp_path / "jax.zarr")
    gt = zarrlite.open_store(tmp_path / "torch.zarr")
    for name, s in bounds.items():
        ref, got = np.asarray(gj[name][...]), np.asarray(gt[name][...])
        np.testing.assert_array_equal(got[:, 0], ref[:, 0], err_msg=name)
        assert np.isfinite(got[:, 1:]).all(), name
        limit = BITROUND_STEP * np.abs(ref[:, 1:]) + ROLLOUT_ATOL * s
        gap = np.abs(got[:, 1:].astype(np.float64) - ref[:, 1:])
        assert (gap <= limit).all(), (name, float((gap - limit).max()))
    assert np.isnan(np.asarray(gt["total_precipitation_6hr"][:, 0])).all()


# -- the CLI and its refusals ---------------------------------------------------

TOY_ARGS = [f"features.pressure_levels=[{','.join(map(str, TOY_LEVELS))}]",
            "model.latent_size=16", "model.velocity_vectors=4", "model.num_layers=2",
            "model.bias_channels=2", "model.bias_rank=4",
            "model.physblock.velocity_net.hidden_dim=8",
            "model.physblock.reaction.hidden_dim=8",
            "model.physblock.output_proj.hidden_dim=8"]


def _cli_args(store, params, out, *extra):
    return ["--checkpoint-path", str(params), "--output-file", str(out),
            "--root-dir", str(store), "--forecast-steps", "4", "--sampling-interval", "12h",
            "--start-date", WINDOW[0], "--end-date", WINDOW[1], "--write-every-n", "3",
            *extra, *TOY_ARGS]


@pytest.fixture(scope="module")
def params_file(store, tmp_path_factory):
    cfg = torch_toy_config(store)
    ds = ERA5Dataset(str(store), *WINDOW, forecast_steps=4, cfg=cfg, prediction_stage=True)
    model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                output_dim=ds.num_out_features, lat_deg=ds.lat,
                                lon_deg=ds.lon, device="cpu")
    path = tmp_path_factory.mktemp("fc_params") / "params.pt"
    save_params(path, model)
    return path


def test_cli_forecast_on_the_cpu_writes_a_store_evaluate_scores(store, params_file, tmp_path):
    out = tmp_path / "fc.zarr"
    res = subprocess.run([sys.executable, "-m", "paradis_torch.cli.forecast",
                          *_cli_args(store, params_file, out, "--device", "cpu")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"forecast written: {out}" in res.stdout
    g = zarrlite.open_store(out)
    z = g["geopotential"][...]
    assert z.shape == (6, 5, len(TOY_LEVELS), 8, 16) and np.isfinite(z).all()
    assert np.nanmax(g["dewpoint_depression"][...]) <= 30.0
    assert set().union(*chunk_codecs(out).values()) == {"zstd"}
    with pytest.warns(UserWarning, match="NOT WB2-comparable"):
        scores = evaluate_main(["--forecast", str(out), "--truth", str(store),
                                "--lead-hours", "12", "24", "--device", "cpu"])
    assert set(scores) == {f"{v}@{h}h{a}" for v in ("geopotential_h500", "temperature_h850")
                           for h in (12, 24) for a in ("", ":acc")}
    assert all(np.isfinite(list(scores.values())))


@pytest.mark.parametrize("how", ["num_devices_flag", "num_devices_config", "mesh"])
def test_a_second_device_raises_before_any_file_is_written(store, params_file, tmp_path, how):
    """Without the launcher one process runs: ``--num-devices 2``,
    ``compute.num_devices=2`` or a spatial mesh axis of 2 ranks does not fit
    the launched world and raises, the last in ``run_forecast`` (the
    two-rank forecasts: ``tests/test_torch_multirank.py``,
    ``tests/test_torch_spatial_multirank.py``)."""
    from paradis_torch.cli.forecast import main

    out = tmp_path / "fc.zarr"
    if how == "mesh":
        cfg = torch_toy_config(store, **{"forecast.enable": True, "model.forecast_steps": 4,
                                         "compute.lat_devices": 2})
        ds = ERA5Dataset(str(store), *WINDOW, forecast_steps=4, cfg=cfg, prediction_stage=True)
        model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                    output_dim=ds.num_out_features, lat_deg=ds.lat,
                                    lon_deg=ds.lon, device="cpu")
        with pytest.raises(ValueError, match="multi-GPU"):
            run_forecast(model, ds, cfg, ZarrForecastWriter(cfg, ds, str(out)),
                         BatchLoader(ds, 1, device="cpu"))
    else:
        extra = (["--num-devices", "2"] if how == "num_devices_flag"
                 else ["compute.num_devices=2"])
        with pytest.raises(ValueError, match="multi-GPU"):
            main(_cli_args(store, params_file, out, "--device", "cpu", *extra))
    assert not out.exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a machine without a card")
@pytest.mark.parametrize("entry", ["forecast", "evaluate"])
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(
        store, params_file, tmp_path, entry):
    from paradis_torch.cli.forecast import main

    out = tmp_path / "fc.zarr"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "forecast":
            main(_cli_args(store, params_file, out))
        else:
            evaluate_main(["--forecast", str(out), "--truth", str(store)])
    assert not out.exists()


# -- compute.advection_impl ---------------------------------------------------------

@pytest.fixture(scope="module")
def gather_pair():
    return build_pair("compute.advection_impl=gather")


def _model_input(pair, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, 8, 16, pair.input_dim)).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "auto_train"])
def test_kernel_path_aliases_are_auto_bitwise(gather_pair, impl):
    """``pallas`` and ``auto_train`` build the model ``auto`` builds and give
    its output bit for bit (on the CPU: the plain versions)."""
    from paradis_torch.config import load_config
    from torch_parity import TINY

    x = torch.from_numpy(_model_input(gather_pair))
    lat, lon = equiangular_lat_lon(8, 16, include_poles=False)
    out = {}
    for name in ("auto", impl):
        cfg = load_config(overrides=TINY + [f"compute.advection_impl={name}"])
        model = Paradis.from_config(cfg, input_dim=gather_pair.input_dim,
                                    output_dim=gather_pair.output_dim, lat_deg=lat,
                                    lon_deg=lon, device="cpu")
        assert {layer.advection.impl for layer in model.layers} == {"auto"}
        with torch.no_grad():
            out[name] = model(x)
    torch.testing.assert_close(out[impl], out["auto"], rtol=0, atol=0)


def test_from_config_names_every_value_when_it_refuses():
    from paradis_torch.config import load_config
    from torch_parity import TINY

    cfg = load_config(overrides=TINY + ["compute.advection_impl=dense"])
    with pytest.raises(ValueError, match="auto.*pallas.*auto_train.*xla.*gather"):
        Paradis.from_config(cfg, input_dim=8, output_dim=4, lat_deg=np.zeros(8),
                            lon_deg=np.zeros(16), device="cpu")


# float32: the same taps, weights and sums in the same order; measured ≤ 9.6e-7
# against jax.vjp on values up to 8 (the cubic weights' products rounded
# differently), within the plain path's limit (tests/test_torch_interp_bwd.py).
GATHER_ATOL = 2e-5


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_gather_matches_jax_forward_and_gradient(mode):
    """Positions up to 3 px past every edge (taps clamped onto it) and on
    integers (the bilinear kinks: autodiff's ∓1 on both sides)."""
    rng = np.random.default_rng(len(mode))
    B, R, C, V, H, W = 2, 12, 20, 6, 7, 10
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    py = rng.uniform(-3.0, R + 2.0, size=(B, H, W, V)).astype(np.float32)
    px = rng.uniform(-3.0, C + 2.0, size=(B, H, W, V)).astype(np.float32)
    py.reshape(-1)[:6] = np.arange(6)
    g = rng.normal(size=(B, H, W, V)).astype(np.float32)
    assert ((py < 0) | (py > R - 1)).any() and ((px < 0) | (px > C - 1)).any()
    ref, vjp = jax.vjp(lambda f, y, x: grid_sample_interp(f, y, x, mode, method="gather"),
                       jnp.asarray(field), jnp.asarray(py), jnp.asarray(px))
    refs = [np.asarray(a) for a in (ref, *vjp(jnp.asarray(g)))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (field, py, px)]
    out = interp_gather(*leaves, mode)
    out.backward(torch.from_numpy(g))
    for name, o, r in zip(("out", "d_field", "d_py", "d_px"),
                          (out, *(t.grad for t in leaves)), refs):
        np.testing.assert_allclose(o.detach().numpy(), r, atol=GATHER_ATOL, rtol=0,
                                   err_msg=name)


def test_gather_model_matches_jax(gather_pair):
    """The toy model under ``compute.advection_impl=gather`` on both sides."""
    x = _model_input(gather_pair, seed=1)
    ref = np.asarray(jax.jit(gather_pair.jax_model.apply)(gather_pair.params, jnp.asarray(x)))
    assert {layer.advection.impl for layer in gather_pair.model.layers} == {"gather"}
    with torch.no_grad():
        out = gather_pair.model(torch.from_numpy(x)).numpy()
    # the fp32 model limit of tests/test_torch_model.py's forward
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=0)
