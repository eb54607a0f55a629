"""The port's weighted losses and feature names against the JAX package.

Same seeded numpy predictions and targets through ``paradis_tpu.train.loss``
and ``paradis_torch.train.loss``.  Both sides compute in float32 from the
same weights; only the order of the means' float32 sums (over up to ~25,000
terms) differs, measured up to 1.6e-6 relative, so the limit is rtol 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.config import load_config as jax_load_config  # noqa: E402
from paradis_tpu.data.dataset import ERA5Dataset  # noqa: E402
from paradis_tpu.train import loss as jax_loss  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.data import dyn_output_features, num_common_features  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon  # noqa: E402
from paradis_torch.train import loss  # noqa: E402

RTOL = 1e-5


def _jax_features(features_cfg, n_time=2):
    """``ERA5Dataset._build_features`` on a bare dataset whose store holds
    every configured feature (only the name bookkeeping runs)."""
    ds = ERA5Dataset.__new__(ERA5Dataset)
    ds.n_time_inputs = n_time
    levels = features_cfg.pressure_levels
    names = [f"{v}_h{lev}" for grp in (features_cfg.input, features_cfg.output)
             for v in grp.atmospheric for lev in levels]
    names += list(features_cfg.input.surface) + list(features_cfg.output.surface)
    ds._feature_index = {f: i for i, f in enumerate(dict.fromkeys(names))}
    ds._build_features(features_cfg)
    return ds


@pytest.mark.parametrize("overrides", [[], ["features.output.surface=[2m_temperature]",
                                            "features.input.atmospheric=[temperature,wind_x]"]],
                         ids=["default", "input-only-and-output-only"])
def test_feature_names_match_the_dataset_order(overrides):
    ds = _jax_features(jax_load_config(overrides=overrides).features)
    feats = load_config(overrides=overrides).features
    assert dyn_output_features(feats) == ds.dyn_output_features
    assert num_common_features(feats) == ds.num_common_features


def _pair(*overrides, kind=None):
    jcfg = jax_load_config(overrides=list(overrides))
    tcfg = load_config(overrides=list(overrides))
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    names = dyn_output_features(tcfg.features)
    return (jax_loss.WeightedLoss.from_config(jcfg, lat, names, kind=kind),
            loss.WeightedLoss.from_config(tcfg, lat, names, kind=kind, device="cpu"), len(names))


def _fields(n_out, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(2, 8, 16, n_out)).astype(np.float32)
    target = (pred + rng.normal(scale=1.5, size=pred.shape)).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("kind", ["mse", "reversed_huber"])
@pytest.mark.parametrize("overrides", [
    [],
    ["training.loss_function.lat_weights=false"],
    ["training.loss_function.flip_geopotential_weights=true"],
    ["training.loss_function.apply_pressure_weights=false"],
    ["training.loss_function.delta_loss=0.5"],
], ids=["default", "no-lat", "flip-geo", "no-pressure", "delta-0.5"])
def test_weighted_loss_matches_jax(kind, overrides):
    jl, tl, n_out = _pair(*overrides, kind=kind)
    np.testing.assert_allclose(tl.feature_weights.numpy(), jl.feature_weights, rtol=0, atol=0)
    if jl.lat_weights is None:
        assert tl.lat_weights is None
    else:
        np.testing.assert_allclose(tl.lat_weights.numpy(), jl.lat_weights, rtol=0, atol=0)
    pred, target = _fields(n_out)
    for dtype in (np.float32, jnp.bfloat16):
        jp, jt = jnp.asarray(pred, dtype), jnp.asarray(target, dtype)
        tp = torch.tensor(np.asarray(jp, np.float32))
        tt = torch.tensor(np.asarray(jt, np.float32))
        if dtype is jnp.bfloat16:
            tp, tt = tp.bfloat16(), tt.bfloat16()
        np.testing.assert_allclose(float(tl(tp, tt)), float(jl(jp, jt)), rtol=RTOL)
        for weighted in (True, False):
            np.testing.assert_allclose(tl.per_channel(tp, tt, weighted=weighted).numpy(),
                                       np.asarray(jl.per_channel(jp, jt, weighted=weighted)),
                                       rtol=RTOL, atol=1e-7)


def test_loss_is_float32_and_differentiable():
    _, tl, n_out = _pair()
    pred, target = (torch.from_numpy(a) for a in _fields(n_out, seed=1))
    p = pred.bfloat16().requires_grad_()
    out = tl(p, target.bfloat16())
    assert out.dtype == torch.float32 and out.ndim == 0
    out.backward()
    assert p.grad.dtype == torch.bfloat16 and torch.isfinite(p.grad.float()).all()


def test_reversed_huber_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(scale=2.0, size=(2, 500)).astype(np.float32)
    for delta in (0.5, 1.0, 2.0):
        np.testing.assert_allclose(
            loss.reversed_huber(torch.from_numpy(a), torch.from_numpy(b), delta).numpy(),
            np.asarray(jax_loss.reversed_huber(jnp.asarray(a), jnp.asarray(b), delta)),
            rtol=RTOL, atol=1e-7)


def test_pressure_weights_and_strip_level():
    levels = [50, 100, 150, 200, 250, 500, 1000]
    np.testing.assert_array_equal(loss.pressure_weights(levels), jax_loss.pressure_weights(levels))
    for name in ("geopotential_h500", "2m_temperature", "wind_x_h50", "t_h1000x"):
        assert loss.strip_level(name) == jax_loss.strip_level(name)


def test_missing_variable_weight_raises():
    cfg = load_config(overrides=["features.output.surface=[2m_temperature,snow_depth]"])
    names = dyn_output_features(cfg.features)
    with pytest.raises(ValueError, match="snow_depth"):
        loss.build_variable_weights(cfg, names)
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    with pytest.raises(ValueError, match="snow_depth"):
        loss.WeightedLoss.from_config(cfg, lat, names, device="cpu")


def test_level_outside_the_configured_levels_raises():
    cfg = load_config()
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    with pytest.raises(ValueError, match="level"):
        loss.WeightedLoss.from_config(cfg, lat, ["temperature_h775", "2m_temperature"],
                                      device="cpu")


def test_unknown_loss_kind_raises():
    cfg = load_config()
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    with pytest.raises(ValueError, match="not supported"):
        loss.WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features), kind="l1",
                                      device="cpu")
