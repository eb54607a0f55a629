"""The port's dense interpolation path against the JAX package's.

``paradis_torch.ops.interp_dense.interp_dense`` (the custom op
``paradis::interp_dense``) against ``paradis_tpu.ops.interp.grid_sample_interp_dense`` and ``jax.vjp`` of it (its
custom VJP), on the CPU, where both packages contract float32 operands;
against the port's gather plain versions; through ``interpolate(...,
impl="xla")``; and the toy model with ``compute.advection_impl=xla`` on both
sides.  The path is plain PyTorch on every device, with no kernel of its own.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.ops.interp import grid_sample_interp_dense  # noqa: E402
from paradis_torch.ops.advection import interpolate  # noqa: E402
from paradis_torch.ops.interp import interp_bwd_plain, interp_plain  # noqa: E402
from paradis_torch.ops.interp_dense import interp_dense  # noqa: E402
from torch_parity import NLAT, NLON, as_f32, build_pair  # noqa: E402

# max |port − JAX| / max |JAX| over each output and gradient.  float32: the
# same dense rows (the same select tree on the same tap scalars) and the same
# contractions, in torch's and XLA's summation orders; measured ≤ 8.8e-8
# against JAX and ≤ 1.1e-7 against the gather plain versions.  bfloat16
# field: both compute in float32 on the CPU and round the output and d_field
# to bf16 once, so float32 sums on either side of a rounding boundary may land
# one bf16 ulp apart (at most 2^-8 of the largest value); measured 0 at these
# seeds.  d_py and d_px stay float32 (measured ≤ 8.3e-8).
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


def _inputs(B, R, C, V, H, W, seed):
    """A unit-spread field, positions up to 3 px past every edge with a NaN
    in each axis, and a cotangent."""
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    py = rng.uniform(-3.0, R + 2.0, size=(B, H, W, V)).astype(np.float32)
    px = rng.uniform(-3.0, C + 2.0, size=(B, H, W, V)).astype(np.float32)
    py.reshape(-1)[4] = np.nan
    px.reshape(-1)[9] = np.nan
    g = rng.normal(size=(B, H, W, V)).astype(np.float32)
    return field, py, px, g


def _rel(out, ref) -> float:
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_interp_dense_matches_jax_forward_and_vjp(mode, dtype):
    field, py, px, g = _inputs(2, 12, 20, 6, 7, 10, seed=len(mode))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    ref, vjp = jax.vjp(lambda f, y, x: grid_sample_interp_dense(f, y, x, mode),
                       jnp.asarray(field, jdt), jnp.asarray(py), jnp.asarray(px))
    refs = [as_f32(a) for a in (ref, *vjp(jnp.asarray(g, jdt)))]

    leaves = [torch.from_numpy(field).to(tdt).requires_grad_(),
              torch.from_numpy(py).requires_grad_(), torch.from_numpy(px).requires_grad_()]
    out = interp_dense(*leaves, mode)
    assert out.dtype == tdt and out.shape == py.shape
    out.backward(torch.from_numpy(g).to(tdt))
    grads = [t.grad for t in leaves]
    assert grads[0].dtype == tdt and grads[1].dtype == grads[2].dtype == torch.float32
    for name, o, r in zip(("out", "d_field", "d_py", "d_px"), (out, *grads), refs):
        tol = TOL[dtype] if name in ("out", "d_field") else TOL["float32"]
        assert np.isfinite(r).all() and _rel(o, r) <= tol, (name, _rel(o, r))
    # a NaN position has no taps: zero output and position gradients
    for t in (out.detach(), grads[1], grads[2]):
        assert float(t.reshape(-1)[4]) == 0.0 and float(t.reshape(-1)[9]) == 0.0


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_interp_dense_matches_the_gather_plain_versions(mode):
    """The dense contraction and the tap gather compute one function with
    the same semantics (taps outside the field dropped, NaN positions
    empty): within float order, in the forward and in all three gradients."""
    field, py, px, g = (torch.from_numpy(a) for a in _inputs(1, 13, 22, 5, 9, 15, seed=7))
    out = interp_dense(field, py, px, mode)
    ref = interp_plain(field, py, px, mode)
    assert _rel(out, ref.numpy()) <= TOL["float32"]
    leaves = [t.clone().requires_grad_() for t in (field, py, px)]
    interp_dense(*leaves, mode).backward(g)
    for name, a, r in zip(("d_field", "d_py", "d_px"), leaves,
                          interp_bwd_plain(field, py, px, g, mode)):
        assert _rel(a.grad, r.numpy()) <= TOL["float32"], name


def test_interpolate_xla_clamps_rows_and_takes_no_band_or_chunk():
    """``impl="xla"`` clamps departure rows to ±max_dy_pix as every backend
    does (d_py zero where the clamp binds), then runs the dense path whatever
    the band plan or chunk size would pick for the kernels."""
    B, H, W, V, pad = 1, 32, 15, 3, 2
    R, C = H + 2 * pad, W + 2 * pad
    field, py, px, g = (torch.from_numpy(a) for a in _inputs(B, R, C, V, H, W, seed=3))
    py = torch.nan_to_num(py)
    arr = torch.arange(H, dtype=torch.float32).view(1, H, 1, 1) + pad
    clamped = torch.clamp(py, arr - 1.5, arr + 1.5)
    ref = interp_dense(field, clamped, px, "bicubic")
    leaves = [t.clone().requires_grad_() for t in (field, py, px)]
    for chunk in (0, 8):
        out = interpolate(*leaves, "bicubic", impl="xla", max_dy_pix=1.5, chunk_rows=chunk)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out.backward(g)
    binds = (py < arr - 1.5) | (py > arr + 1.5)
    assert binds.any() and not leaves[1].grad[binds].any()
    assert leaves[1].grad[~binds].abs().max() > 0


def _toy_input(pair):
    # large enough inputs that departure points move by whole pixels
    return np.random.default_rng(1).normal(
        scale=2.0, size=(2, NLAT, NLON, pair.input_dim)).astype(np.float32)


# The toy model, JAX with advection_impl=xla against the port with xla and
# with its plain (gather) path, fp32 and bf16 activations.  Measured max |diff|
# over the outputs (max |output| ≈ 0.69): fp32 4.2e-7 (bilinear) and 3.9e-7
# (bicubic) through xla against 5.4e-7 and 4.8e-7 through the plain path;
# bf16 7.8e-3 and 9.8e-3 on both paths (2–2.5 bf16 ulps: the rounding places
# of the two frameworks, tests/test_torch_model.py).  The limits are those of
# tests/test_torch_model.py.
@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 5e-6), (jnp.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_toy_model_with_the_dense_path_matches_jax(mode, dtype, atol):
    overrides = [f"model.adv_interpolation={mode}", "compute.fast_departure_trig=true"]
    pair = build_pair(*overrides, "compute.advection_impl=xla", dtype=dtype)
    assert {layer.advection.impl for layer in pair.model.layers} == {"xla"}
    x = _toy_input(pair)
    ref = as_f32(jax.jit(pair.jax_model.apply)(pair.params, jnp.asarray(x)))
    with torch.no_grad():
        dense = as_f32(pair.model(torch.from_numpy(x)))
        pair.model.set_interp_impl("auto")
        gather = as_f32(pair.model(torch.from_numpy(x)))
    assert ref.std() > 1e-2 and dense.shape == ref.shape == (2, NLAT, NLON, pair.output_dim)
    np.testing.assert_allclose(dense, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(gather, ref, atol=atol, rtol=0)


def test_toy_model_gradients_through_the_dense_path_match_the_plain_path():
    """Parameter gradients of the fp32 toy model through ``interp_dense``'s
    backward against those through the gather plain backward: the same
    function and derivative convention, in other float orders (measured
    1.9e-7 of the largest gradient)."""
    pair = build_pair("compute.advection_impl=xla")
    x = torch.from_numpy(_toy_input(pair))
    grads = {}
    for impl in ("xla", "auto"):
        pair.model.set_interp_impl(impl)
        pair.model.zero_grad()
        pair.model(x).square().mean().backward()
        grads[impl] = torch.cat([p.grad.flatten() for p in pair.model.parameters()])
    scale = float(grads["auto"].abs().max())
    assert scale > 0 and float((grads["xla"] - grads["auto"]).abs().max()) <= 1e-5 * scale
