"""The port's spherical harmonic transform against the JAX package's.

Same seeded numpy fields through ``paradis_tpu.ops.sht.RealSHT`` and
``paradis_torch.ops.sht.RealSHT``.  The Legendre tables are built by the same
float64 numpy code and cast to float32: bitwise equal.  The transforms differ
in their FFT (pocketfft against ducc) and in the order of the float32 sums of
the Legendre product; measured ≤ 1.8e-7 of the largest coefficient, so the
limit is 1e-5 of it.  The behaviour of ``tests/test_sht.py`` is held on the
port, and scipy's spherical harmonics serve as an independent oracle of the
tables (the port itself does not import scipy).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.ops import sht as jax_sht  # noqa: E402
from paradis_torch.ops import sht  # noqa: E402

RTOL = 1e-5
GRIDS = [(16, 32), (32, 64)]


def _grid(nlat, nlon, poles=False):
    if poles:
        lat = np.deg2rad(np.linspace(-90.0, 90.0, nlat))
    else:
        lat = np.deg2rad(np.linspace(-90 + 180 / (2 * nlat), 90 - 180 / (2 * nlat), nlat))
    lon = np.deg2rad(np.arange(nlon) * 360.0 / nlon)
    return np.meshgrid(lat, lon, indexing="ij")


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("poles", [False, True], ids=["midpoint", "poles"])
@pytest.mark.parametrize("nlat,nlon", GRIDS + [(8, 16), (33, 64)])
def test_tables_are_bitwise_the_jax_packages(nlat, nlon, poles):
    mmax = min(nlat, nlon // 2 + 1)
    for fn in ("_analysis_matrix", "_synthesis_matrix"):
        got = getattr(sht, fn)(nlat, nlat, mmax, poles)
        ref = getattr(jax_sht, fn)(nlat, nlat, mmax, poles)
        assert got.dtype == np.float32 and np.array_equal(got, ref), fn


@pytest.mark.parametrize("poles", [False, True], ids=["midpoint", "poles"])
@pytest.mark.parametrize("nlat,nlon", GRIDS)
def test_analysis_and_synthesis_match_jax(nlat, nlon, poles):
    rng = np.random.default_rng(nlat + poles)
    x = rng.normal(size=(2, nlat, nlon, 5)).astype(np.float32)
    ref = jax_sht.RealSHT(nlat, nlon, includes_poles=poles)
    port = sht.RealSHT(nlat, nlon, includes_poles=poles)
    assert (port.lmax, port.mmax) == (ref.lmax, ref.mmax)
    c_ref = np.array(ref.analysis(jnp.asarray(x)))
    c = port.analysis(torch.from_numpy(x))
    assert c.dtype == torch.complex64
    _close(c.numpy(), c_ref)
    _close(port.synthesis(torch.from_numpy(c_ref)).numpy(),
           np.array(ref.synthesis(jnp.asarray(c_ref))))
    # a bf16 field is cast to float32 first, as in JAX
    xb = jnp.asarray(x, jnp.bfloat16)
    _close(port.analysis(torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()).numpy(),
           np.array(ref.analysis(xb)))


def test_analysis_over_leading_dims_and_its_gradient():
    """Any leading dims; the VJP of the Legendre product is the transposed
    product (against autograd through a float64 einsum)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(2, 3, 16, 32, 4)), dtype=torch.float32)
    port = sht.RealSHT(16, 32)
    c = port.analysis(x)
    assert c.shape == (2, 3, 16, 16, 4)
    np.testing.assert_array_equal(c[1, 2].numpy(), port.analysis(x[1, 2]).numpy())
    w = torch.tensor(rng.normal(size=c.shape), dtype=torch.float32)
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((port.analysis(xg).real * w).sum(), xg)
    x64 = x.double().requires_grad_()
    mat = torch.tensor(sht._analysis_matrix(16, 16, 16, False), dtype=torch.float64)
    fm = torch.fft.rfft(x64, dim=-2)[..., :16, :] * (2 * np.pi / 32)
    c64 = torch.einsum("lmh,...hmc->...lmc", mat.to(torch.complex128), fm)
    (g64,) = torch.autograd.grad((c64.real * w.double()).sum(), x64)
    assert (g.double() - g64).abs().max() <= RTOL * g64.abs().max()


def test_legendre_table_against_scipy():
    """|P̄_l^m(cos θ)| = |Y_l^m(θ, 0)| (scipy's includes the Condon–Shortley
    phase, which the table omits)."""
    special = pytest.importorskip("scipy.special")
    if not hasattr(special, "sph_harm_y"):
        pytest.skip("scipy.special.sph_harm_y needs scipy >= 1.15")
    theta = np.linspace(0.05, np.pi - 0.05, 23)
    table = sht._legendre_table(12, 9, np.cos(theta))
    for l in range(12):
        for m in range(min(l + 1, 9)):
            y = special.sph_harm_y(l, m, theta, 0.0).real
            np.testing.assert_allclose(table[l, m], (-1) ** m * y, rtol=1e-10, atol=1e-12)
    assert not table[np.triu_indices(9, 1)[0], np.triu_indices(9, 1)[1]].any()  # m > l


def test_constant_field_power_in_l0():
    c = sht.RealSHT(16, 32).analysis(torch.ones(1, 16, 32, 1)).numpy()
    # Y_0^0 = 1/sqrt(4π); coefficient of a unit field = sqrt(4π)
    assert abs(c[0, 0, 0, 0].real - np.sqrt(4 * np.pi)) < 1e-2
    rest = np.abs(c)
    rest[0, 0, 0, 0] = 0
    assert rest.max() < 1e-3


def test_y10_lands_in_l1_m0():
    latg, _ = _grid(16, 32)
    x = torch.tensor(np.sqrt(3.0 / (4 * np.pi)) * np.sin(latg), dtype=torch.float32)
    c = sht.RealSHT(16, 32).analysis(x[None, :, :, None]).numpy()
    assert abs(c[0, 1, 0, 0].real - 1.0) < 1e-2
    rest = np.abs(c)
    rest[0, 1, 0, 0] = 0
    assert rest.max() < 1e-2  # the top l aliases slightly on midpoint grids


@pytest.mark.parametrize("m", [1, 3, 7])
def test_zonal_wave_lands_in_its_m(m):
    latg, long_ = _grid(16, 32)
    x = torch.tensor(np.cos(m * long_) * np.cos(latg) ** m, dtype=torch.float32)
    c = np.abs(sht.RealSHT(16, 32).analysis(x[None, :, :, None]).numpy())[0, :, :, 0]
    m_power = c.sum(axis=0)
    assert m_power[m] > 100 * (m_power.sum() - m_power[m] + 1e-12)


@pytest.mark.parametrize("poles", [False, True], ids=["midpoint", "poles"])
def test_roundtrip_bandlimited(poles):
    nlat = 17 if poles else 16
    latg, long_ = _grid(nlat, 32, poles)
    x = (1.0 + 0.5 * np.sin(latg) + 0.3 * np.cos(2 * long_) * np.cos(latg) ** 2)
    x = torch.tensor(x, dtype=torch.float32)[None, :, :, None]
    port = sht.RealSHT(nlat, 32, includes_poles=poles)
    np.testing.assert_allclose(port.synthesis(port.analysis(x)).numpy(), x.numpy(), atol=5e-3)


def test_tables_are_cached_per_device():
    port = sht.RealSHT(16, 32)
    a = port._table("analysis", torch.device("cpu"))
    assert a is port._table("analysis", "cpu") and a.shape == (16, 16, 16)
    assert port._table("synthesis", "cpu").shape == (16, 16, 16)
    assert a.dtype == torch.float32 and a.is_contiguous()
