"""The port's plain interpolation against the TPU kernel itself.

``paradis_tpu.ops.interp_pallas.grid_sample_interp_pallas`` runs in
interpret mode on the CPU, as tests/test_interp_pallas.py runs it.  Positions
reach up to 3 px outside the padded field, where the Pallas kernel gives
zero taps (the JAX gather path would clamp indices instead, so it is no
oracle there).  The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py and tests/test_torch_kernels_gpu.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.ops.advection import interpolate as jax_interpolate  # noqa: E402
from paradis_tpu.ops.interp_pallas import grid_sample_interp_pallas  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.advection import interpolate  # noqa: E402
from paradis_torch.ops.interp import interp_plain  # noqa: E402

# fp32: the Pallas kernel contracts dense weight matrices, the plain version
# sums 16 (4) taps; only the summation order differs.
# bf16: the Pallas kernel rounds the x-weights to bf16 before its matmul
# (interp_pallas.py:191), ≤ 2^-9 relative on Σ|w||f| ≈ 1.6·max|f|, and both
# sides round the fp32 result to bf16, which can differ by one bf16 ulp
# (2^-6 for outputs in [2, 4)) where they straddle a rounding boundary.
ATOL = {"float32": 3e-5, "bfloat16": 4e-2}


def _inputs(B, R, C, V, H, W, seed, outside=3.0):
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    py = rng.uniform(-outside, R - 1 + outside, size=(B, H, W, V)).astype(np.float32)
    px = rng.uniform(-outside, C - 1 + outside, size=(B, H, W, V)).astype(np.float32)
    return field, py, px


# V = 6 is not a multiple of the Pallas channel block (8); P = 6·10 = 60 and
# 5·25 = 125 are not multiples of 128.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", [(2, 12, 20, 6, 6, 10), (1, 9, 14, 3, 5, 25)],
                         ids=["V6-P60", "V3-P125"])
def test_plain_matches_pallas_kernel(mode, dtype, shape):
    field, py, px = _inputs(*shape, seed=11)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = grid_sample_interp_pallas(jnp.asarray(field, jdt), jnp.asarray(py),
                                    jnp.asarray(px), mode, interpret=True)
    out = interp_plain(torch.from_numpy(field).to(tdt), torch.from_numpy(py),
                       torch.from_numpy(px), mode)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=ATOL[dtype], rtol=0)


def test_outside_and_non_finite_positions_have_no_taps():
    """Far outside the field, and NaN/inf, the Pallas kernel returns zero."""
    field, py, px = _inputs(1, 8, 12, 4, 2, 8, seed=5)
    py[0, 0, :, 0] = [np.nan, np.inf, -np.inf, -4.0, 11.0, 1e30, 3.5, np.nan]
    px[0, 1, :, 1] = [2.0, np.nan, 5.0, -np.inf, -3.0, 14.5, 1e30, 4.25]
    ref = np.asarray(grid_sample_interp_pallas(jnp.asarray(field), jnp.asarray(py),
                                               jnp.asarray(px), "bicubic", interpret=True))
    out = interp_plain(torch.from_numpy(field), torch.from_numpy(py),
                       torch.from_numpy(px), "bicubic").numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("max_dy_pix", [None, 1.5])
def test_interpolate_dispatch_and_row_clamp(max_dy_pix):
    """``interpolate(impl="auto")`` on the CPU is the plain version, and the
    ``max_dy_pix`` clamp holds as in the JAX dispatch."""
    field, py, px = _inputs(1, 12, 20, 4, 8, 16, seed=7, outside=0.0)
    ref = jax_interpolate(jnp.asarray(field), jnp.asarray(py), jnp.asarray(px), "bicubic",
                          impl="xla", max_dy_pix=max_dy_pix)
    out = interpolate(torch.from_numpy(field), torch.from_numpy(py), torch.from_numpy(px),
                      "bicubic", impl="auto", max_dy_pix=max_dy_pix)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "dense", "gather", "cuda"])
def test_interpolate_rejects_unknown_impl(impl):
    field, py, px = (torch.from_numpy(a) for a in _inputs(1, 6, 8, 2, 2, 4, seed=0))
    with pytest.raises(ValueError, match="advection impl"):
        interpolate(field, py, px, "bicubic", impl=impl)


def test_bad_mode_raises():
    field, py, px = (torch.from_numpy(a) for a in _inputs(1, 6, 8, 2, 2, 4, seed=0))
    with pytest.raises(ValueError, match="mode"):
        interp_plain(field, py, px, "nearest")


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper raises on a CPU tensor, builds nothing and counts
    no launch; only the dispatching ``interpolate`` takes the plain version
    there."""
    field, py, px = (torch.from_numpy(a) for a in _inputs(1, 6, 8, 2, 2, 4, seed=0))
    before = interp_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.interp_fwd_cuda(field, py, px, "bicubic")
    out = interpolate(field, py, px, "bicubic")
    torch.testing.assert_close(out, interp_plain(field, py, px, "bicubic"), rtol=0, atol=0)
    assert interp_cuda.launches == before
