"""The port's contraction plain versions against the TPU microbenchmark.

``mm_kernel``, ``mmT_kernel`` and ``bwd_mm_kernel`` of scripts/bench_interp.py
are closures inside its ``make_variants()``, which also allocates 428 MB of
matmul operands, so they cannot be imported.  Their bodies are rebuilt here
and run through ``pl.pallas_call(..., interpret=True)`` on the CPU, in their
channel-major layouts, at B, V, P, R, C = 1, 16, 256, 12, 20 with a channel
block of 8 and position blocks of 64, so that the backward accumulates
d_field over 4 blocks as the bench's does over 2.  The port's side is
``ops/interp_mm.py``; the CUDA kernels (``csrc/interp_mm.cu``) are held
against the plain versions on the card by chip_smoke.py and
tests/test_torch_kernels_gpu.py.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from paradis_torch.ops import interp_mm  # noqa: E402

B, V, P, R, C = 1, 16, 256, 12, 20
VB, PB = 8, 64
CDT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# |port − Pallas| / max |Pallas output|: both round the same operands to cdt
# (identical bits) and sum the same float32 products, XLA's dot and torch's
# matmul in other orders.  Measured at most 2.0e-7 (mm, mmT) and 5.0e-7
# (bwd_mm's d_field, summed over 4 position blocks in the Pallas kernel and
# over all 256 positions at once in torch); the limit is 1e-5.
TOL = 1e-5


def mm_kernel(wx_ref, f_ref, out_ref, *, cdt):
    t = jax.lax.dot_general(
        wx_ref[0].astype(cdt), f_ref[0].astype(cdt),
        (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )                                                     # [vb, P, R]
    out_ref[0] = jnp.sum(t, axis=2)


def mmT_kernel(wxT_ref, f_ref, out_ref, *, cdt):
    t = jax.lax.dot_general(
        f_ref[0].astype(cdt), wxT_ref[0].astype(cdt),
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )                                                     # [vb, R, P]
    out_ref[0] = jnp.sum(t, axis=1)


def bwd_mm_kernel(field_ref, py_ref, px_ref, g_ref, dfield_ref, dpy_ref, dpx_ref, *, cdt):
    R_, C_ = field_ref.shape[-2], field_ref.shape[-1]
    P_ = py_ref.shape[-1]
    vb = py_ref.shape[1]
    py2 = py_ref[0]
    px2 = px_ref[0]
    g2 = g_ref[0]
    f = field_ref[0].astype(cdt)
    wy = py2[:, None, :] * jax.lax.broadcasted_iota(
        jnp.int32, (vb, R_, P_), 1).astype(jnp.float32)
    dwy = wy * 0.5
    wxa = px2[:, None, :] * jax.lax.broadcasted_iota(
        jnp.int32, (vb, C_, P_), 1).astype(jnp.float32)
    wx2 = jnp.concatenate([wxa, wxa * 0.5], axis=-1).astype(cdt)
    tt = jax.lax.dot_general(f, wx2, (((2,), (1,)), ((0,), (0,))),
                             preferred_element_type=jnp.float32)
    dpy_ref[0] = g2 * jnp.sum(dwy * tt[..., :P_], axis=1)
    dpx_ref[0] = g2 * jnp.sum(wy * tt[..., P_:], axis=1)
    wyg = (wy * g2[:, None, :]).astype(cdt)
    partial = jax.lax.dot_general(
        wyg, wx2[..., :P_], (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)

    @pl.when(pl.program_id(2) == 0)
    def _():
        dfield_ref[0] = partial

    @pl.when(pl.program_id(2) != 0)
    def _():
        dfield_ref[0] = dfield_ref[0] + partial


def _pallas_mm(kernel, w, f, cdt, transposed):
    w_block = (1, VB, C, PB) if transposed else (1, VB, PB, C)
    w_index = (lambda b, v, p: (b, v, 0, p)) if transposed else (lambda b, v, p: (b, v, p, 0))
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, cdt=cdt),
        out_shape=jax.ShapeDtypeStruct((B, V, P), jnp.float32),
        grid=(B, V // VB, P // PB),
        in_specs=[pl.BlockSpec(w_block, w_index),
                  pl.BlockSpec((1, VB, R, C), lambda b, v, p: (b, v, 0, 0))],
        out_specs=pl.BlockSpec((1, VB, PB), lambda b, v, p: (b, v, p)),
        interpret=True,
    )(jnp.asarray(w), jnp.asarray(f)))


def _pallas_bwd_mm(field_t, py, px, g, cdt):
    pos = pl.BlockSpec((1, VB, PB), lambda b, v, p: (b, v, p))
    plane = pl.BlockSpec((1, VB, R, C), lambda b, v, p: (b, v, 0, 0))
    outs = pl.pallas_call(
        functools.partial(bwd_mm_kernel, cdt=cdt),
        out_shape=(jax.ShapeDtypeStruct((B, V, R, C), jnp.float32),
                   jax.ShapeDtypeStruct((B, V, P), jnp.float32),
                   jax.ShapeDtypeStruct((B, V, P), jnp.float32)),
        grid=(B, V // VB, P // PB),
        in_specs=[plane, pos, pos, pos],
        out_specs=(plane, pos, pos),
        interpret=True,
    )(field_t, jnp.asarray(py), jnp.asarray(px), jnp.asarray(g))
    return [np.asarray(o) for o in outs]


def _assert_close(out, ref, name=""):
    scale = float(np.abs(ref).max())
    assert np.isfinite(ref).all() and scale > 0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= TOL, (name, err)


def _operands(seed):
    rng = np.random.default_rng(seed)
    wx = rng.normal(size=(B, V, P, C)).astype(np.float32)
    f = rng.normal(size=(B, V, R, C)).astype(np.float32)
    return wx, f


@pytest.mark.parametrize("cdt", list(CDT))
def test_mm_plain_matches_pallas_mm_kernel(cdt):
    jdt, tdt = CDT[cdt]
    wx, f = _operands(seed=1)
    ref = _pallas_mm(mm_kernel, wx, f, jdt, transposed=False)
    out = interp_mm.mm_plain(torch.from_numpy(wx), torch.from_numpy(f), tdt)
    assert out.dtype == torch.float32 and out.shape == (B, V, P)
    _assert_close(out.numpy(), ref)
    # the CPU dispatch takes the plain version
    torch.testing.assert_close(interp_mm.mm(torch.from_numpy(wx), torch.from_numpy(f), tdt),
                               out, rtol=0, atol=0)


@pytest.mark.parametrize("cdt", list(CDT))
def test_mmT_plain_matches_pallas_mmT_kernel(cdt):
    jdt, tdt = CDT[cdt]
    rng = np.random.default_rng(2)
    wxT = rng.normal(size=(B, V, C, P)).astype(np.float32)
    f = rng.normal(size=(B, V, R, C)).astype(np.float32)
    ref = _pallas_mm(mmT_kernel, wxT, f, jdt, transposed=True)
    out = interp_mm.mmT_plain(torch.from_numpy(wxT), torch.from_numpy(f), tdt)
    assert out.dtype == torch.float32 and out.shape == (B, V, P)
    _assert_close(out.numpy(), ref)
    torch.testing.assert_close(interp_mm.mmT(torch.from_numpy(wxT), torch.from_numpy(f), tdt),
                               out, rtol=0, atol=0)


@pytest.mark.parametrize("cdt", list(CDT))
def test_mmT_of_the_transpose_is_mm(cdt):
    """The two layouts compute one function: ``mmT_plain(wxᵀ) == mm_plain(wx)``
    within float order (the same products, summed over c in another order)."""
    tdt = CDT[cdt][1]
    wx, f = (torch.from_numpy(a) for a in _operands(seed=3))
    a = interp_mm.mm_plain(wx, f, tdt)
    b = interp_mm.mmT_plain(wx.transpose(-1, -2).contiguous(), f, tdt)
    assert float((a - b).abs().max()) <= TOL * float(a.abs().max())


def _bwd_inputs(seed, g_ones=False):
    """The bench's inputs at the test's size: a bf16 field of unit spread,
    positions in the padded grid's interior, and g = 1 or a seeded normal."""
    rng = np.random.default_rng(seed)
    field_t = jnp.asarray(rng.normal(size=(B, V, R, C)), jnp.bfloat16)
    py = rng.uniform(2.0, R - 3.0, size=(B, V, P)).astype(np.float32)
    px = rng.uniform(2.0, C - 3.0, size=(B, V, P)).astype(np.float32)
    g = np.ones((B, V, P), np.float32) if g_ones else rng.normal(size=(B, V, P)).astype(np.float32)
    field_torch = torch.from_numpy(np.array(field_t.astype(jnp.float32))).to(torch.bfloat16)
    return field_t, field_torch, py, px, g


@pytest.mark.parametrize("g_ones", [True, False], ids=["g1", "gnormal"])
@pytest.mark.parametrize("cdt", list(CDT))
def test_bwd_mm_plain_matches_pallas_bwd_mm_kernel(cdt, g_ones):
    jdt, tdt = CDT[cdt]
    field_t, field_torch, py, px, g = _bwd_inputs(seed=4 + g_ones, g_ones=g_ones)
    refs = _pallas_bwd_mm(field_t, py, px, g, jdt)
    outs = interp_mm.bwd_mm_plain(field_torch, torch.from_numpy(py), torch.from_numpy(px),
                                  torch.from_numpy(g), tdt)
    for name, o, r in zip(("d_field", "d_py", "d_px"), outs, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape
        _assert_close(o.numpy(), r, name)
    # with these stand-in weights the second half of wx2 is half the first
    # (exact in float32 and bf16), so d_px equals d_py up to float order
    d_py, d_px = outs[1], outs[2]
    assert float((d_py - d_px).abs().max()) <= TOL * float(d_py.abs().max())
    dispatched = interp_mm.bwd_mm(field_torch, torch.from_numpy(py), torch.from_numpy(px),
                                  torch.from_numpy(g), tdt)
    for o, d in zip(outs, dispatched):
        torch.testing.assert_close(d, o, rtol=0, atol=0)


def test_contraction_wrappers_refuse_cpu_tensors():
    wx, f = (torch.from_numpy(a) for a in _operands(seed=5))
    py = torch.zeros(B, V, P)
    before = (interp_mm.mm_launches, interp_mm.mmT_launches, interp_mm.bwd_mm_launches)
    with pytest.raises(ValueError, match="CUDA"):
        interp_mm.mm_cuda(wx, f)
    with pytest.raises(ValueError, match="CUDA"):
        interp_mm.mmT_cuda(wx.transpose(-1, -2).contiguous(), f)
    with pytest.raises(ValueError, match="CUDA"):
        interp_mm.bwd_mm_cuda(f, py, py, py)
    assert (interp_mm.mm_launches, interp_mm.mmT_launches, interp_mm.bwd_mm_launches) == before
