"""Whole forward pass: paradis_torch.Paradis against paradis_tpu's Paradis.

Same weights (bridged from the JAX tree), same inputs (numpy, seeded).  The
JAX model runs the XLA dense interpolation (``advection_impl=xla``); the port
runs its plain interpolation on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_parity import NLAT, NLON, as_f32, build_pair  # noqa: E402

# fp32: measured max |diff| ≈ 5e-7 on outputs of std ≈ 0.1 and max ≈ 0.7; the
# limit, 10× that, leaves room for fp32 reassociation (other sum orders in
# matmuls, einsums and the interpolation) through 2 layers.
# bf16: both sides round every activation to bf16 (8 significant bits), but
# at different places (flax adds a bf16 bias after a bf16-rounded matmul, torch
# adds it before rounding; activations round once in torch, per op in XLA).
# Measured max |diff| ≈ 1e-2, 2.5 bf16 ulps of outputs up to 0.7 (ulp 2^-8);
# the limit is 8 such ulps.
CASES = {
    "bicubic-fast-fp32": (["model.adv_interpolation=bicubic",
                           "compute.fast_departure_trig=true"], jnp.float32, 5e-6),
    "bilinear-fast-fp32": (["model.adv_interpolation=bilinear",
                            "compute.fast_departure_trig=true"], jnp.float32, 5e-6),
    "bicubic-exact-fp32": (["model.adv_interpolation=bicubic",
                            "compute.fast_departure_trig=false"], jnp.float32, 5e-6),
    "bilinear-exact-fp32-coarsen2": (["model.adv_interpolation=bilinear",
                                      "compute.fast_departure_trig=false",
                                      "model.coarsening_factor=2"], jnp.float32, 5e-6),
    "bicubic-fast-bf16": (["model.adv_interpolation=bicubic",
                           "compute.fast_departure_trig=true"], jnp.bfloat16, 3e-2),
    "bicubic-fast-fp32-coarsen3": (["model.adv_interpolation=bicubic",
                                    "compute.fast_departure_trig=true",
                                    "model.coarsening_factor=3"], jnp.float32, 5e-6),
}
# a case's grid where it is not the file's: 3 must divide the longitudes
# (both packages size the processor's GlobalBias W // s, the downsample
# gives (W - 1) // s + 1 columns)
GRIDS = {"bicubic-fast-fp32-coarsen3": (22, 24)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    overrides, dtype, atol = CASES[case]
    nlat, nlon = GRIDS.get(case, (NLAT, NLON))
    pair = build_pair(*overrides, dtype=dtype, nlat=nlat, nlon=nlon)
    # large enough inputs that departure points move by whole pixels
    x = np.random.default_rng(1).normal(
        scale=2.0, size=(2, nlat, nlon, pair.input_dim)).astype(np.float32)
    ref = as_f32(jax.jit(pair.jax_model.apply)(pair.params, jnp.asarray(x)))
    with torch.no_grad():
        out = pair.model(torch.from_numpy(x))
    assert out.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    out = as_f32(out)
    assert out.shape == ref.shape == (2, nlat, nlon, pair.output_dim)
    assert ref.std() > 1e-2  # a comparison of near-zero outputs would prove little
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
