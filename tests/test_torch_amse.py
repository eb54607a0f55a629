"""The port's AMSE spectral loss against the JAX package's.

Same seeded numpy predictions and targets through
``paradis_tpu.train.amse.AMSELoss`` (value, and ``jax.grad``) and
``paradis_torch.train.amse.AMSELoss`` (value, and ``torch.autograd.grad``),
and through both packages' ``WeightedLoss.from_config(kind="amse")``.  The
transforms differ in their FFT and float32 sum order: the loss within rtol
1e-5 (measured ≤ 1.3e-7) and the gradient within 1e-5 of its largest entry
(measured ≤ 4.7e-7).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.config import load_config as jax_load_config  # noqa: E402
from paradis_tpu.train import loss as jax_loss  # noqa: E402
from paradis_tpu.train.amse import AMSELoss as JaxAMSELoss  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.data import dyn_output_features  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon  # noqa: E402
from paradis_torch.train import loss  # noqa: E402
from paradis_torch.train.amse import AMSELoss  # noqa: E402

RTOL = 1e-5
SHAPE = (2, 32, 64, 5)


def _fields(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=shape).astype(np.float32)
    target = (0.7 * pred + rng.normal(scale=0.8, size=shape)).astype(np.float32)
    weights = rng.uniform(0.2, 2.0, size=shape[-1]).astype(np.float32)
    return pred, target, weights


def _both(jl, tl, pred, target, weights=None):
    """(JAX value, JAX gradient, port value, port gradient) in pred."""
    jw = None if weights is None else jnp.asarray(weights)
    jv, jg = jax.value_and_grad(lambda p: jl(p, jnp.asarray(target), jw))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    tv = tl(p, torch.from_numpy(target), None if weights is None else torch.from_numpy(weights))
    (tg,) = torch.autograd.grad(tv, p)
    return float(jv), np.asarray(jg), float(tv.detach()), tg.numpy()


def _match(jv, jg, tv, tg):
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    assert tg.shape == jg.shape
    assert np.abs(tg - jg).max() <= RTOL * np.abs(jg).max()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("poles", [False, True], ids=["midpoint", "poles"])
def test_amse_value_and_gradient_match_jax(poles, weighted):
    pred, target, w = _fields(seed=int(poles))
    nlat, nlon = SHAPE[1:3]
    out = _both(JaxAMSELoss(nlat, nlon, poles), AMSELoss(nlat, nlon, poles), pred, target,
                w if weighted else None)
    assert out[0] > 0
    _match(*out)


def test_amse_exact_zero_cross_spectrum():
    """A single zonal mode (m = 16, exactly, from the samples 1, 0, −1, 0)
    against a single meridional one (no longitude dependence): both FFTs give
    exact zeros off their mode, so every cross-spectrum entry is exactly 0,
    where |z| has no derivative.  Both packages take it as 0 there."""
    nlat, nlon = 32, 64
    lat = np.deg2rad(np.linspace(-90 + 180 / (2 * nlat), 90 - 180 / (2 * nlat), nlat))
    zonal = np.tile(np.array([1.0, 0.0, -1.0, 0.0]), nlon // 4)
    p = zonal[None, :] * np.cos(lat)[:, None] ** 2
    t = np.sin(lat)[:, None] * np.ones(nlon)[None, :]
    pred = np.stack([p, 0.5 * p], -1)[None].repeat(2, 0).astype(np.float32)
    target = np.stack([t, 2.0 * t], -1)[None].repeat(2, 0).astype(np.float32)
    jl, tl = JaxAMSELoss(nlat, nlon), AMSELoss(nlat, nlon)
    _, _, j_cross = jl._psd_and_cross(jl.sht.analysis(jnp.asarray(pred)),
                                      jl.sht.analysis(jnp.asarray(target)))
    _, _, t_cross = tl._psd_and_cross(tl.sht.analysis(torch.from_numpy(pred)),
                                      tl.sht.analysis(torch.from_numpy(target)))
    assert not np.asarray(j_cross).any() and not t_cross.any()
    out = _both(jl, tl, pred, target)
    assert np.isfinite(out[1]).all() and np.isfinite(out[3]).all()
    _match(*out)


def test_amse_nan_falls_back_to_1e6():
    pred, target, w = _fields(shape=(1, 16, 32, 3), seed=4)
    pred[0, 3, 5, 1] = np.nan
    jv, jg, tv, tg = _both(JaxAMSELoss(16, 32), AMSELoss(16, 32), pred, target, w)
    assert jv == tv == 1e6
    np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
    fin = np.isfinite(jg)
    np.testing.assert_array_equal(tg[fin], jg[fin])


def test_amse_casts_a_bf16_prediction_to_float32():
    pred, target, _ = _fields(shape=(1, 16, 32, 2), seed=5)
    pb = jnp.asarray(pred, jnp.bfloat16)
    ref = float(JaxAMSELoss(16, 32)(pb, jnp.asarray(target)))
    p = torch.from_numpy(np.asarray(pb, np.float32)).bfloat16().requires_grad_()
    out = AMSELoss(16, 32)(p, torch.from_numpy(target))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out.detach()), ref, rtol=RTOL)
    out.backward()
    assert p.grad.dtype == torch.bfloat16 and torch.isfinite(p.grad.float()).all()


def test_amse_zero_for_identical_fields():
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 16, 32, 3)), dtype=torch.float32)
    assert float(AMSELoss(16, 32)(x, x)) < 1e-4


def test_amse_single_mode_phase_shift_is_free():
    """A pure single-mode displacement is not double-penalized."""
    lat = np.deg2rad(np.linspace(-90 + 180 / 32, 90 - 180 / 32, 16))
    latg, long_ = np.meshgrid(lat, np.deg2rad(np.arange(32) * 360.0 / 32), indexing="ij")
    base = torch.tensor(np.cos(4 * long_) * np.cos(latg) ** 4, dtype=torch.float32)
    shifted = torch.tensor(np.cos(4 * long_ + np.pi / 2) * np.cos(latg) ** 4,
                           dtype=torch.float32)
    assert float(AMSELoss(16, 32)(shifted[None, ..., None], base[None, ..., None])) < 1e-3


def test_amse_penalizes_decorrelation_and_weights_split_the_mean():
    rng = np.random.default_rng(5)
    base = torch.tensor(rng.normal(size=(1, 16, 32, 2)), dtype=torch.float32)
    loss_fn = AMSELoss(16, 32)
    assert float(loss_fn(torch.roll(base, 8, dims=2), base)) > float(loss_fn(0.5 * base, base))
    other = torch.tensor(rng.normal(size=(1, 16, 32, 2)), dtype=torch.float32)
    w0 = float(loss_fn(other, base, torch.tensor([1.0, 0.0])))
    w1 = float(loss_fn(other, base, torch.tensor([0.0, 1.0])))
    assert w0 + w1 == pytest.approx(float(loss_fn(other, base)), rel=1e-6)


def _pair(nlat, nlon, *overrides, nlon_arg="given"):
    jcfg = jax_load_config(overrides=list(overrides))
    tcfg = load_config(overrides=list(overrides))
    lat, _ = equiangular_lat_lon(nlat, nlon, include_poles=False)
    names = dyn_output_features(tcfg.features)
    n = nlon if nlon_arg == "given" else None
    return (jax_loss.WeightedLoss.from_config(jcfg, lat, names, kind="amse", nlon=n),
            loss.WeightedLoss.from_config(tcfg, lat, names, kind="amse", nlon=n, device="cpu"),
            len(names))


@pytest.mark.parametrize("nlon_arg", ["given", "fallback"])
@pytest.mark.parametrize("overrides", [[], ["training.loss_function.apply_pressure_weights=false"]],
                         ids=["default", "no-pressure"])
def test_weighted_amse_from_config_matches_jax(overrides, nlon_arg):
    """``nlon`` given, or the reference's ``2·(nlat − 1)`` where it is not;
    no latitude weights under amse; ``per_channel`` the pointwise reversed
    Huber, as in JAX."""
    jl, tl, n_out = _pair(16, 32, *overrides, nlon_arg=nlon_arg)
    assert tl.kind == "amse" and tl.lat_weights is None and jl.lat_weights is None
    assert (tl.amse.sht.nlon, tl.amse.sht.includes_poles) == (jl.amse.sht.nlon, False)
    np.testing.assert_array_equal(tl.feature_weights.numpy(), jl.feature_weights)
    pred, target, _ = _fields(shape=(2, 16, 32, n_out), seed=6)
    np.testing.assert_allclose(float(tl(torch.from_numpy(pred), torch.from_numpy(target))),
                               float(jl(jnp.asarray(pred), jnp.asarray(target))), rtol=RTOL)
    for weighted in (True, False):
        np.testing.assert_allclose(
            tl.per_channel(torch.from_numpy(pred), torch.from_numpy(target),
                           weighted=weighted).numpy(),
            np.asarray(jl.per_channel(jnp.asarray(pred), jnp.asarray(target),
                                      weighted=weighted)),
            rtol=RTOL, atol=1e-7)


def test_weighted_amse_detects_a_grid_with_poles():
    cfg = load_config()
    lat, _ = equiangular_lat_lon(17, 32, include_poles=True)
    tl = loss.WeightedLoss.from_config(cfg, lat, dyn_output_features(cfg.features),
                                       kind="amse", nlon=32, device="cpu")
    jl = jax_loss.WeightedLoss.from_config(jax_load_config(), lat,
                                           dyn_output_features(cfg.features), kind="amse",
                                           nlon=32)
    assert tl.amse.sht.includes_poles and jl.amse.sht.includes_poles


def test_from_config_runs_on_the_card_by_default(monkeypatch):
    """With no device given the loss's tensors go to ``cuda``, and with no
    card it raises rather than fall back to the CPU."""
    cfg = load_config()
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    names = dyn_output_features(cfg.features)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("amse", "reversed_huber"):
        with pytest.raises(RuntimeError, match="CUDA"):
            loss.WeightedLoss.from_config(cfg, lat, names, kind=kind, nlon=16)
