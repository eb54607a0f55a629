"""The port's interpolation backward against the TPU kernel's VJP.

``jax.vjp`` of ``paradis_tpu.ops.interp_pallas.grid_sample_interp_pallas``
runs the Pallas backward kernel in interpret mode on the CPU, as
tests/test_interp_pallas.py runs it.  The port's side is ``interp_bwd_plain``
and the autograd pairing of the custom ops ``paradis::interp`` and
``paradis::interp_bwd`` (``interp_cuda.interp``, through ``interpolate``),
which on CPU tensors runs the plain forward and the plain backward.  The
CUDA backward kernel is held against ``interp_bwd_plain`` on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.ops.interp_pallas import grid_sample_interp_pallas  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.advection import interpolate  # noqa: E402
from paradis_torch.ops.interp import interp_bwd_plain, interp_plain  # noqa: E402

# Limits on max |port − Pallas| over each gradient, for unit-spread field and
# cotangent.  fp32: the Pallas kernel contracts dense weight matrices, the
# plain version sums 16 (4) taps, so only the summation order differs
# (measured ≤ 5e-6 on gradients up to ~7).  bf16: the Pallas kernel rounds K,
# K′ and g·K to bf16 before its matmuls (interp_pallas.py:158-168), ≤ 2^-9
# relative on sums of up to ~7 (measured 1.4e-2 on d_py), and both sides round
# d_field to bf16, which can differ by one bf16 ulp (2^-6 for values in [2, 4)).
ATOL = {"float32": 2e-5, "bfloat16": 4e-2}


def _inputs(B, R, C, V, H, W, seed, outside=3.0, integer=False):
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    py = rng.uniform(-outside, R - 1 + outside, size=(B, H, W, V)).astype(np.float32)
    px = rng.uniform(-outside, C - 1 + outside, size=(B, H, W, V)).astype(np.float32)
    if integer:
        py, px = np.round(py), np.round(px)
    g = rng.normal(size=(B, H, W, V)).astype(np.float32)
    return field, py, px, g


def _pallas_vjp(field, py, px, g, mode, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def fn(f, y, x):
        return grid_sample_interp_pallas(f, y, x, mode, interpret=True)

    _, vjp = jax.vjp(fn, jnp.asarray(field, jdt), jnp.asarray(py), jnp.asarray(px))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in vjp(jnp.asarray(g, jdt))]


def _port_both(field, py, px, g, mode, dtype):
    """(interp_bwd_plain's gradients, autograd's gradients through the custom ops)."""
    tdt = getattr(torch, dtype)
    f, y, x = torch.from_numpy(field).to(tdt), torch.from_numpy(py), torch.from_numpy(px)
    gt = torch.from_numpy(g).to(tdt)
    plain = interp_bwd_plain(f, y, x, gt, mode)
    assert plain[0].dtype == tdt and plain[1].dtype == plain[2].dtype == torch.float32
    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    interpolate(*leaves, mode).backward(gt)
    return plain, [t.grad for t in leaves]


# V = 6 and 3 are no multiple of the Pallas channel block (8); P = 60 and 125
# no multiple of 128.  Positions reach 3 px outside the field.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", [(2, 12, 20, 6, 6, 10), (1, 9, 14, 3, 5, 25)],
                         ids=["V6-P60", "V3-P125"])
def test_backward_matches_pallas_vjp(mode, dtype, shape):
    field, py, px, g = _inputs(*shape, seed=11)
    ref = _pallas_vjp(field, py, px, g, mode, dtype)
    plain, auto = _port_both(field, py, px, g, mode, dtype)
    for name, r, p, a in zip(("d_field", "d_py", "d_px"), ref, plain, auto):
        assert tuple(p.shape) == r.shape, name
        np.testing.assert_allclose(p.float().numpy(), r, atol=ATOL[dtype], rtol=0, err_msg=name)
        torch.testing.assert_close(a, p, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_integer_positions_follow_the_jax_derivative_convention(mode):
    """At integer positions the bilinear K′ is zero at its kinks (autograd of
    ``1 − t, t`` would give ∓1 there and miss by up to ~7 on d_py, d_px)."""
    field, py, px, g = _inputs(2, 12, 20, 6, 6, 10, seed=4, integer=True)
    ref = _pallas_vjp(field, py, px, g, mode, "float32")
    plain, auto = _port_both(field, py, px, g, mode, "float32")
    if mode == "bilinear":
        assert not plain[1].any() and not plain[2].any()
    for name, r, p, a in zip(("d_field", "d_py", "d_px"), ref, plain, auto):
        np.testing.assert_allclose(p.numpy(), r, atol=ATOL["float32"], rtol=0, err_msg=name)
        torch.testing.assert_close(a, p, rtol=0, atol=0, msg=name)


def test_non_finite_positions_have_no_taps_in_the_backward():
    field, py, px, g = _inputs(1, 8, 12, 4, 2, 8, seed=5)
    py[0, 0, :, 0] = [np.nan, np.inf, -np.inf, -4.0, 11.0, 1e30, 3.5, np.nan]
    px[0, 1, :, 1] = [2.0, np.nan, 5.0, -np.inf, -3.0, 14.5, 1e30, 4.25]
    ref = _pallas_vjp(field, py, px, g, "bicubic", "float32")
    plain, _ = _port_both(field, py, px, g, "bicubic", "float32")
    for name, r, p in zip(("d_field", "d_py", "d_px"), ref, plain):
        assert torch.isfinite(p).all(), name
        np.testing.assert_allclose(p.numpy(), r, atol=ATOL["float32"], rtol=0, err_msg=name)
    # a position without taps gets no gradient
    assert not plain[1][0, 0, 0, 0] and not plain[2][0, 1, 1, 1]


def test_function_on_the_cpu_counts_no_kernel_launch():
    """On CPU tensors the autograd pairing runs the plain versions only, and
    forward values equal ``interp_plain``."""
    field, py, px, g = (torch.from_numpy(a) for a in _inputs(1, 6, 8, 2, 2, 4, seed=0))
    before = (interp_cuda.launches, interp_cuda.bwd_launches)
    f = field.clone().requires_grad_()
    out = interp_cuda.interp(f, py, px, "bicubic", False)
    torch.testing.assert_close(out, interp_plain(field, py, px, "bicubic"), rtol=0, atol=0)
    out.backward(g)
    assert (interp_cuda.launches, interp_cuda.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.interp_bwd_cuda(field, py, px, g, "bicubic")
