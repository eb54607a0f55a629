"""The interpolation as ``torch.library`` custom ops, on the CPU.

``paradis::interp`` / ``paradis::interp_bwd`` (``ops/interp_cuda.py``), the
dense path's ``paradis::interp_dense`` / ``paradis::interp_dense_bwd``
(``ops/interp_dense.py``) and ``paradis::departure_positions``
(``ops/advection.py``): ``torch.library.opcheck`` on each forward op with its
autograd, fake calls (shapes and dtypes, no launch), the plain versions' bits
on CPU tensors, and the gradients through the ops against the JAX package's
Pallas VJP in interpret mode (as tests/test_torch_interp_bwd.py holds them).
The kernels behind the ops are held on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from paradis_tpu.ops.interp_pallas import grid_sample_interp_pallas  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.advection import departure_positions  # noqa: E402
from paradis_torch.ops.interp import interp_bwd_plain, interp_plain  # noqa: E402
from paradis_torch.ops.interp_band import (band_spec, interp_band_bwd_plain,  # noqa: E402
                                           interp_band_plain)
from paradis_torch.ops.interp_chunk import interp_chunk_bwd_plain, interp_chunk_plain  # noqa: E402
from paradis_torch.ops.interp_dense import (_dense_impl, _dense_vjp_bwd,  # noqa: E402
                                            interp_dense, interp_dense_op)

# 32 position rows, so that the band gate is on at max_dy 1.4 (bands of 8
# arrival rows over 16 of the 36 padded rows); 3 channels, 8 columns
B, H, W, V, PAD = 1, 32, 8, 3, 2
R, C = H + 2 * PAD, W + 2 * PAD
MAX_DY = 1.4
CHUNK = 8
PAIRS = ("unbanded", "banded", "chunked")
# max |port − Pallas| of each gradient, tests/test_torch_interp_bwd.py's
# float32 limit (the Pallas kernels contract dense weights, the plain
# versions sum the taps: only the float order differs)
ATOL = 2e-5


def _inputs(seed=0, dtype=torch.float32):
    """Field, positions (rows within ``MAX_DY`` of their arrival row, so
    no clamp binds; columns up to 2 px outside), cotangent."""
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    arr = np.arange(H, dtype=np.float32).reshape(1, H, 1, 1) + PAD
    py = (arr + rng.uniform(-MAX_DY, MAX_DY, size=(B, H, W, V))).astype(np.float32)
    px = rng.uniform(-2.0, C + 1.0, size=(B, H, W, V)).astype(np.float32)
    g = rng.normal(size=(B, H, W, V)).astype(np.float32)
    return (torch.from_numpy(field).to(dtype), torch.from_numpy(py), torch.from_numpy(px),
            torch.from_numpy(g).to(dtype))


def _op_args(pair):
    """``(band, max_dy, chunk)`` of the forward op for a pair."""
    if pair == "banded":
        spec = band_spec(H, W, R, "bicubic", MAX_DY)
        assert spec is not None
        return list(spec[:4]), spec[4], 0
    return [], 0.0, CHUNK if pair == "chunked" else 0


def _plain(pair):
    """The plain forward and backward of a pair, as functions of (field,
    py, px[, g], mode)."""
    if pair == "banded":
        spec = band_spec(H, W, R, "bicubic", MAX_DY)
        return (lambda f, y, x, m: interp_band_plain(f, y, x, spec, m),
                lambda f, y, x, g, m: interp_band_bwd_plain(f, y, x, g, spec, m))
    if pair == "chunked":
        return (lambda f, y, x, m: interp_chunk_plain(f, y, x, CHUNK, m),
                lambda f, y, x, g, m: interp_chunk_bwd_plain(f, y, x, g, CHUNK, m))
    return interp_plain, interp_bwd_plain


@pytest.mark.parametrize("pair", PAIRS)
def test_opcheck_forward_op(pair):
    """Schema, autograd registration, fake implementation against the real
    one, and AOT dispatch with dynamic shapes: ``torch.library.opcheck``."""
    f, y, x, _ = _inputs(seed=1)
    args = (f.requires_grad_(), y.requires_grad_(), x.requires_grad_(), "bicubic", False,
            *_op_args(pair))
    torch.library.opcheck(interp_cuda.interp_op, args)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_opcheck_dense_op(mode):
    f, y, x, _ = _inputs(seed=2)
    torch.library.opcheck(interp_dense_op, (f.requires_grad_(), y.requires_grad_(),
                                            x.requires_grad_(), mode))


@pytest.mark.parametrize("max_dy", [None, 0.5], ids=["shift", "shift-and-clamp"])
def test_opcheck_positions_op(max_dy):
    _, y, x, _ = _inputs(seed=3)
    torch.library.opcheck(departure_positions, (y.requires_grad_(), x.requires_grad_(), PAD,
                                                PAD, max_dy))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_calls_give_shapes_and_dtypes_and_count_no_launch(dtype, monkeypatch):
    """Every op on fake CUDA tensors: the outputs' shapes, dtypes and
    device, and no build, no launch."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(interp_cuda._build, "load", no_build)
    monkeypatch.setattr(interp_cuda, "_fns", {})
    counts = lambda: (interp_cuda.launches, interp_cuda.bwd_launches,  # noqa: E731
                      interp_cuda.band_launches, interp_cuda.band_bwd_launches,
                      interp_cuda.chunk_launches, interp_cuda.chunk_bwd_launches)
    before = counts()
    tdt = getattr(torch, dtype)
    with FakeTensorMode():
        f = torch.empty(B, R, C, V, device="cuda", dtype=tdt)
        y = torch.empty(B, H, W, V, device="cuda")
        x = torch.empty(B, H, W, V, device="cuda")
        g = torch.empty(B, H, W, V, device="cuda", dtype=tdt)
        outs = []
        for pair in PAIRS:
            outs.append(torch.ops.paradis.interp(f, y, x, "bicubic", False, *_op_args(pair)))
            outs.extend(torch.ops.paradis.interp_bwd(f, y, x, g, "bicubic", False,
                                                     *_op_args(pair)))
        outs.append(torch.ops.paradis.interp_dense(f, y, x, "bicubic"))
        outs.extend(torch.ops.paradis.interp_dense_bwd(f, y, x, g, "bicubic"))
        outs.extend(torch.ops.paradis.departure_positions(y, x, PAD, PAD, MAX_DY))
    # each pair and the dense path: out, d_field, d_py, d_px; then the positions
    per_pair = [(y.shape, tdt), (f.shape, tdt), (y.shape, torch.float32),
                (y.shape, torch.float32)]
    expected = per_pair * 4 + [(y.shape, torch.float32)] * 2
    assert [(tuple(o.shape), o.dtype) for o in outs] == [(tuple(s), d) for s, d in expected]
    assert all(o.device.type == "cuda" for o in outs)
    assert counts() == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pair", PAIRS)
def test_ops_on_cpu_tensors_give_the_plain_versions_bits(pair, dtype):
    """Forward and backward ops on CPU tensors against the plain versions,
    bitwise, with ``plain`` false and true; and the gradients that autograd
    takes through the forward op equal the backward op's."""
    f, y, x, g = _inputs(seed=4, dtype=getattr(torch, dtype))
    fwd, bwd = _plain(pair)
    ref, ref_grads = fwd(f, y, x, "bicubic"), bwd(f, y, x, g, "bicubic")
    for plain in (False, True):
        out = torch.ops.paradis.interp(f, y, x, "bicubic", plain, *_op_args(pair))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        grads = torch.ops.paradis.interp_bwd(f, y, x, g, "bicubic", plain, *_op_args(pair))
        for a, r in zip(grads, ref_grads):
            torch.testing.assert_close(a, r, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    interp_cuda.interp_op(*leaves, "bicubic", False, *_op_args(pair)).backward(g)
    for leaf, r in zip(leaves, ref_grads):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_dense_ops_on_cpu_tensors_give_the_plain_versions_bits(mode):
    f, y, x, g = _inputs(seed=5)
    torch.testing.assert_close(interp_dense(f, y, x, mode), _dense_impl(f, y, x, mode),
                               rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    interp_dense(*leaves, mode).backward(g)
    for leaf, r in zip(leaves, _dense_vjp_bwd(f, y, x, g, mode)):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


@pytest.mark.parametrize("pair", PAIRS)
def test_gradients_through_the_ops_match_the_pallas_vjp(pair):
    """The gradients through ``interp_cuda.interp`` against ``jax.vjp`` of
    ``grid_sample_interp_pallas`` (interpret mode) with the same band bound
    or chunk size, whose Pallas kernels are the banded, chunked or unbanded
    pair."""
    f, y, x, g = _inputs(seed=6)
    band, max_dy, chunk = _op_args(pair)
    spec = (*band, max_dy) if band else None

    def fn(fj, yj, xj):
        return grid_sample_interp_pallas(fj, yj, xj, "bicubic", interpret=True,
                                         chunk_rows=chunk if chunk else 0,
                                         max_dy_pix=MAX_DY if spec else None)

    ref_out, vjp = jax.vjp(fn, *(jnp.asarray(t.numpy()) for t in (f, y, x)))
    refs = [np.asarray(a) for a in (ref_out, *vjp(jnp.asarray(g.numpy())))]
    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    out = interp_cuda.interp(*leaves, "bicubic", False, spec, chunk)
    out.backward(g)
    for name, a, r in zip(("out", "d_field", "d_py", "d_px"),
                          (out.detach(), *(t.grad for t in leaves)), refs):
        assert np.abs(r).max() > 0.1, name
        np.testing.assert_allclose(a.numpy(), r, atol=ATOL, rtol=0, err_msg=name)


def test_positions_op_shifts_clamps_and_zeroes_d_py_where_the_clamp_binds():
    """``departure_positions`` is ``pix + shift`` and ``torch.clamp`` of the
    rows, bitwise, with ``torch.clamp``'s gradient."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.uniform(-2.0, H + 1.0, size=(B, H, W, V)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-2.0, W + 1.0, size=(B, H, W, V)).astype(np.float32))
    g = [torch.from_numpy(rng.normal(size=(B, H, W, V)).astype(np.float32)) for _ in range(2)]
    arr = torch.arange(H, dtype=torch.float32).view(1, H, 1, 1) + PAD
    leaves = [t.clone().requires_grad_() for t in (y, x)]
    ref = (torch.clamp(leaves[0] + PAD, arr - MAX_DY, arr + MAX_DY), leaves[1] + PAD)
    torch.autograd.backward(ref, g)
    ref_grads = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    out = departure_positions(*leaves, PAD, PAD, MAX_DY)
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r.detach(), rtol=0, atol=0)
    torch.autograd.backward(out, g)
    for t, r in zip(leaves, ref_grads):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)
    binds = (y + PAD < arr - MAX_DY) | (y + PAD > arr + MAX_DY)
    assert binds.any() and not leaves[0].grad[binds].any()
