"""The port's row-chunked interpolation against the TPU's chunked kernels.

``paradis_tpu.ops.interp_pallas.grid_sample_interp_pallas(..., chunk_rows=rw)``
runs the Pallas kernels ``_fwd_kernel_chunked`` / ``_bwd_kernel_chunked`` in
interpret mode on the CPU, as tests/test_interp_pallas.py runs them.  The
port's side is its chunk-size rule (``ops/interp_chunk.chunk_rows``), the
chunked plain versions, and the dispatch ``interpolate``, which picks the
banded, chunked or unbanded pair in the priority of ``_fwd_tv`` /
``_bwd_tv``.  The CUDA kernels are held against the plain versions, and
bitwise against the unbanded kernels, on the card by chip_smoke.py and
tests/test_torch_kernels_gpu.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import paradis_tpu.ops.interp_pallas as pallas_mod  # noqa: E402
from paradis_tpu.ops.interp_pallas import _chunk_rows, grid_sample_interp_pallas  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.advection import interpolate  # noqa: E402
from paradis_torch.ops.interp_chunk import (chunk_rows, interp_chunk_bwd_plain,  # noqa: E402
                                            interp_chunk_plain)
from torch_parity import NLAT, NLON, as_f32, build_pair  # noqa: E402

# Limits on max |port − Pallas|, the ones tests/test_interp_pallas.py states
# for the chunked kernels' forward (3e-5) and tests/test_torch_interp_bwd.py
# for the backward (2e-5): the Pallas kernels contract dense weight matrices
# chunk by chunk, the plain versions sum 16 (4) taps; only the float order
# differs, on outputs up to ~4.  bf16: the Pallas kernels round the weights
# (and g·K) to bf16 before their matmuls, ≤ 2^-9 relative on sums up to ~7,
# and both sides round their results to bf16, one bf16 ulp apart where they
# straddle a rounding boundary.
FWD_ATOL = {"float32": 3e-5, "bfloat16": 4e-2}
BWD_ATOL = {"float32": 2e-5, "bfloat16": 4e-2}


@pytest.mark.parametrize("R,override,env", [
    (36, None, None), (132, None, None), (132, 0, None), (36, 8, None), (36, None, "16"),
    (36, 8, "16"), (36, 0, "16"), (132, None, "32"), (36, None, "0"),
])
def test_chunk_rows_matches_jax(monkeypatch, R, override, env):
    """Explicit size, then PARADIS_INTERP_CHUNK, then 0, read on every call."""
    if env is None:
        monkeypatch.delenv("PARADIS_INTERP_CHUNK", raising=False)
    else:
        monkeypatch.setenv("PARADIS_INTERP_CHUNK", env)
    assert chunk_rows(R, override) == _chunk_rows(R, override)


def _setup(mode, Hp, Wp, H, W, V, seed, narrow=False):
    """Field [1, Hp, Wp, V] and positions off the kernel's derivative kinks
    (as tests/test_interp_pallas.py:test_chunked_rows_parity): anywhere in
    the field, so a block's taps span every chunk, or, with ``narrow``,
    within 1.4 rows of the padded arrival row, so most chunks are skipped."""
    rng = np.random.default_rng(seed)
    pad = (Hp - H) // 2
    field = rng.normal(size=(1, Hp, Wp, V)).astype(np.float32)
    if narrow:
        arr = (np.arange(H, dtype=np.float32) + pad)[None, :, None, None]
        py = np.clip(arr + rng.uniform(-1.4, 1.4, size=(1, H, W, V)), 2.0, Hp - 3.0)
    else:
        py = rng.uniform(2.0, Hp - 3.0, size=(1, H, W, V))
    px = rng.uniform(2.0, Wp - 3.0, size=(1, H, W, V))
    py = (np.floor(py) + 0.37).astype(np.float32)
    px = (np.floor(px) + 0.61).astype(np.float32)
    g = rng.normal(size=(1, H, W, V)).astype(np.float32)
    return field, py, px, g


def _pallas(field, py, px, g, mode, dtype, rw):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def fn(f, y, x):
        return grid_sample_interp_pallas(f, y, x, mode, interpret=True, chunk_rows=rw)

    out, vjp = jax.vjp(fn, jnp.asarray(field, jdt), jnp.asarray(py), jnp.asarray(px))
    return as_f32(out), [as_f32(a) for a in vjp(jnp.asarray(g, jdt))]


# (mode, dtype, rw, Hp, Wp, H, W, V, narrow): Hp 22 is no multiple of 8 or 16
# (the Pallas kernels pad it to 24 / 32, the CUDA kernels stage a short last
# chunk), spread positions span every chunk; the narrow case has H 32, W 16
# over P = 512 positions in Pallas blocks of 128 (four blocks, most chunks
# skipped in each); rw 32 exceeds Hp (one chunk, padded to 32 rows in Pallas).
CASES = {
    "rw8-bilinear": ("bilinear", "float32", 8, 22, 20, 18, 16, 4, False),
    "rw8-bicubic": ("bicubic", "float32", 8, 22, 20, 18, 16, 4, False),
    "rw16-bilinear": ("bilinear", "float32", 16, 22, 20, 18, 16, 4, False),
    "rw16-bicubic": ("bicubic", "float32", 16, 22, 20, 18, 16, 4, False),
    "rw8-bicubic-bf16": ("bicubic", "bfloat16", 8, 22, 20, 18, 16, 4, False),
    "rw32-bilinear-bf16": ("bilinear", "bfloat16", 32, 22, 20, 18, 16, 4, False),
    "rw8-bicubic-narrow": ("bicubic", "float32", 8, 36, 20, 32, 16, 2, True),
    "rw16-bilinear-narrow": ("bilinear", "float32", 16, 34, 18, 32, 16, 2, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_plain_matches_pallas_chunked_kernels(monkeypatch, case):
    """Forward and VJP of the Pallas chunked kernels against the chunked
    plain versions and against the dispatch through the autograd pairing,
    which must take the chunked pair."""
    mode, dtype, rw, Hp, Wp, H, W, V, narrow = CASES[case]
    if narrow:
        monkeypatch.setattr(pallas_mod, "_VMEM_BUDGET", 64 * 1024)  # pb 128 < P 512
    field, py, px, g = _setup(mode, Hp, Wp, H, W, V, seed=rw + Hp + len(mode), narrow=narrow)
    ref_out, ref_grads = _pallas(field, py, px, g, mode, dtype, rw)
    tdt = getattr(torch, dtype)
    f, y, x = torch.from_numpy(field).to(tdt), torch.from_numpy(py), torch.from_numpy(px)
    gt = torch.from_numpy(g).to(tdt)

    out = interp_chunk_plain(f, y, x, rw, mode)
    assert out.dtype == tdt
    np.testing.assert_allclose(as_f32(out), ref_out, atol=FWD_ATOL[dtype], rtol=0)
    plain = interp_chunk_bwd_plain(f, y, x, gt, rw, mode)
    for name, r, p in zip(("d_field", "d_py", "d_px"), ref_grads, plain):
        np.testing.assert_allclose(as_f32(p), r, atol=BWD_ATOL[dtype], rtol=0, err_msg=name)

    calls = []
    monkeypatch.setattr(interp_cuda, "interp_chunk_plain",
                        lambda *a: calls.append("fwd") or interp_chunk_plain(*a))
    monkeypatch.setattr(interp_cuda, "interp_chunk_bwd_plain",
                        lambda *a: calls.append("bwd") or interp_chunk_bwd_plain(*a))
    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    res = interpolate(*leaves, mode, chunk_rows=rw)
    torch.testing.assert_close(res, out, rtol=0, atol=0)
    res.backward(gt)
    assert calls == ["fwd", "bwd"]
    for name, p, leaf in zip(("d_field", "d_py", "d_px"), plain, leaves):
        torch.testing.assert_close(leaf.grad, p, rtol=0, atol=0, msg=name)


def _spy(monkeypatch):
    """Record which plain pair the autograd pairing takes on the CPU."""
    calls = []
    for name in ("interp_plain", "interp_bwd_plain", "interp_band_plain",
                 "interp_band_bwd_plain", "interp_chunk_plain", "interp_chunk_bwd_plain"):
        fn = getattr(interp_cuda, name)
        monkeypatch.setattr(interp_cuda, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    return calls


@pytest.mark.parametrize("max_dy_pix,chunk,env,taken", [
    (2.0, 8, None, "band"),        # a band plan wins over chunking
    (2.0, None, "8", "band"),
    (None, 8, None, "chunk"),
    (None, None, "8", "chunk"),    # the environment, read at the call
    (None, 0, "8", "plain"),       # an explicit 0 wins over it
    (None, None, None, "plain"),
    (20.0, 8, None, "chunk"),      # bound given, band gate off: chunking
    (20.0, None, None, "plain"),
], ids=["band>chunk", "band>env", "chunk", "env", "explicit-0", "default", "gate-off-chunk",
        "gate-off"])
def test_dispatch_priority_band_then_chunk_then_unbanded(monkeypatch, max_dy_pix, chunk, env,
                                                         taken):
    if env is None:
        monkeypatch.delenv("PARADIS_INTERP_CHUNK", raising=False)
    else:
        monkeypatch.setenv("PARADIS_INTERP_CHUNK", env)
    field, py, px, g = (torch.from_numpy(a) for a in _setup("bicubic", 36, 20, 32, 16, 2,
                                                           seed=3, narrow=True))
    calls = _spy(monkeypatch)
    f = field.clone().requires_grad_()
    interpolate(f, py, px, "bicubic", max_dy_pix=max_dy_pix, chunk_rows=chunk).backward(g)
    prefix = {"band": "interp_band_", "chunk": "interp_chunk_", "plain": "interp_"}[taken]
    assert calls == [f"{prefix}plain", f"{prefix}bwd_plain"]


def test_chunk_wrappers_refuse_cpu_tensors_and_bad_sizes():
    """The chunked kernels' wrappers raise on CPU tensors and count nothing;
    the plain versions and the wrappers refuse a chunk of no rows."""
    field, py, px, g = (torch.from_numpy(a) for a in _setup("bicubic", 22, 20, 18, 16, 2, 0))
    before = (interp_cuda.chunk_launches, interp_cuda.chunk_bwd_launches)
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.interp_chunk_fwd_cuda(field, py, px, 8, "bicubic")
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.interp_chunk_bwd_cuda(field, py, px, g, 8, "bicubic")
    assert (interp_cuda.chunk_launches, interp_cuda.chunk_bwd_launches) == before
    for rw in (0, -8):
        with pytest.raises(ValueError, match="chunk rows"):
            interp_chunk_plain(field, py, px, rw)
        with pytest.raises(ValueError, match="chunk rows"):
            interp_chunk_bwd_plain(field, py, px, g, rw)


def test_a_nan_position_zeroes_the_pallas_block_but_only_itself_in_the_port():
    """A difference of the reference, kept out of the port: the Pallas
    chunked kernels take the min and max of the rows over their whole
    position block, so one NaN position makes the row range NaN, no chunk
    fires, and every output, d_py and d_px of the block is zero.  The
    unchunked Pallas kernel, and the port's chunked path, zero only that
    position (it has no taps)."""
    field, py, px, g = _setup("bicubic", 22, 20, 18, 16, 4, seed=5)
    py[0, 4, 7, 1] = np.nan
    chunked, chunked_grads = _pallas(field, py, px, g, "bicubic", "float32", 8)
    unchunked, unchunked_grads = _pallas(field, py, px, g, "bicubic", "float32", 0)
    assert not chunked.any() and not chunked_grads[1].any() and not chunked_grads[2].any()
    assert np.count_nonzero(unchunked == 0) == 1 and unchunked[0, 4, 7, 1] == 0

    f, y, x = torch.from_numpy(field), torch.from_numpy(py), torch.from_numpy(px)
    out = interp_chunk_plain(f, y, x, 8, "bicubic")
    np.testing.assert_allclose(out.numpy(), unchunked, atol=FWD_ATOL["float32"], rtol=0)
    grads = interp_chunk_bwd_plain(f, y, x, torch.from_numpy(g), 8, "bicubic")
    for name, p, r in zip(("d_field", "d_py", "d_px"), grads, unchunked_grads):
        np.testing.assert_allclose(p.numpy(), r, atol=BWD_ATOL["float32"], rtol=0, err_msg=name)
    assert grads[1][0, 4, 7, 1] == 0 and grads[2][0, 4, 7, 1] == 0


def test_toy_model_with_chunking_matches_jax(monkeypatch):
    """The toy model's forward with PARADIS_INTERP_CHUNK=8 goes through the
    chunked pair in every layer and matches the JAX toy model (whose XLA
    path has the same function) within the fp32 forward limit of
    tests/test_torch_model.py, 5e-6."""
    pair = build_pair()
    # large enough inputs that departure points move by whole pixels
    x = np.random.default_rng(4).normal(
        scale=2.0, size=(1, NLAT, NLON, pair.input_dim)).astype(np.float32)
    ref = as_f32(jax.jit(pair.jax_model.apply)(pair.params, jnp.asarray(x)))
    assert ref.std() > 1e-2
    monkeypatch.setenv("PARADIS_INTERP_CHUNK", "8")
    calls = _spy(monkeypatch)
    with torch.no_grad():
        out = pair.model(torch.from_numpy(x))
    assert calls == ["interp_chunk_plain"] * len(pair.model.layers)
    np.testing.assert_allclose(as_f32(out), ref, atol=5e-6, rtol=0)
