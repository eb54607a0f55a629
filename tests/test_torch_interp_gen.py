"""The port's weight-generation plain versions against the TPU microbenchmark.

``genonly_kernel`` and ``bwd_gen_kernel`` of scripts/bench_interp.py are
closures inside its ``make_variants()``, which also allocates 428 MB of
matmul operands, so they cannot be imported.  Their bodies are rebuilt here
from the same ``paradis_tpu.ops.interp_pallas._weights_T`` and run through
``pl.pallas_call(..., interpret=True)`` on the CPU, in their channel-major
layout [B, V, P], with the bench's channel block of 8.  The port's side,
``ops/interp_gen.py``, takes the channels-last positions [B, H, W, V].  The
CUDA kernels (``csrc/interp_gen.cu``) are held against the plain versions on
the card by chip_smoke.py and tests/test_torch_kernels_gpu.py.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from paradis_tpu.ops.interp_pallas import _weights_T  # noqa: E402
from paradis_torch.ops import interp_gen  # noqa: E402

# |port − Pallas|: both sum the same ≤ 4 non-zero weights per axis (the dense
# sums add zeros besides), but XLA on the CPU contracts the cubic polynomials'
# multiply-adds into FMAs (as the card does) where torch rounds op by op, in
# intermediates of magnitude up to 6 (8a, −4a; an ulp of 4.8e-7).  Measured
# 2.6e-6 (bicubic) on sums of magnitude ≤ 2.5.
TOL = 5e-6


def genonly_kernel(py_ref, px_ref, out_ref, *, R, C, mode):
    wx = _weights_T(px_ref[0], C, mode)
    wy = _weights_T(py_ref[0], R, mode)
    out_ref[0] = jnp.sum(wx, axis=1) + jnp.sum(wy, axis=1)


def bwd_gen_kernel(py_ref, px_ref, out_ref, *, R, C, mode):
    wx, dwx = _weights_T(px_ref[0], C, mode, derivative=True)
    wy, dwy = _weights_T(py_ref[0], R, mode, derivative=True)
    out_ref[0] = (jnp.sum(wx, axis=1) + jnp.sum(dwx, axis=1)
                  + jnp.sum(wy, axis=1) + jnp.sum(dwy, axis=1))


def _pallas(kernel, py_t, px_t, R, C, mode, vb=8):
    B, V, P = py_t.shape
    spec = pl.BlockSpec((1, vb, P), lambda b, v: (b, v, 0))
    return pl.pallas_call(
        functools.partial(kernel, R=R, C=C, mode=mode),
        out_shape=jax.ShapeDtypeStruct((B, V, P), jnp.float32),
        grid=(B, V // vb), in_specs=[spec, spec], out_specs=spec, interpret=True,
    )(py_t, px_t)


def _positions(shape, R, C, seed):
    """Positions over the padded grid and up to 3 px beyond it, with a NaN
    and an inf in each axis (no taps there)."""
    rng = np.random.default_rng(seed)
    py = rng.uniform(-3.0, R + 2.0, size=shape).astype(np.float32)
    px = rng.uniform(-3.0, C + 2.0, size=shape).astype(np.float32)
    py.reshape(-1)[[0, 5]] = (np.nan, np.inf)
    px.reshape(-1)[[1, 5]] = (-np.inf, np.nan)
    return py, px


@pytest.mark.parametrize("derivative", [False, True], ids=["gen", "bwd_gen"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_gen_plain_matches_pallas_bench_kernels(mode, derivative):
    B, H, W, V = 1, 8, 16, 16          # P = 128, two channel blocks of 8
    R, C = H + 4, W + 4
    py, px = _positions((B, H, W, V), R, C, seed=len(mode) + derivative)
    to_t = lambda a: jnp.moveaxis(jnp.asarray(a.reshape(B, H * W, V)), -1, 1)  # noqa: E731
    kernel = bwd_gen_kernel if derivative else genonly_kernel
    ref = np.asarray(_pallas(kernel, to_t(py), to_t(px), R, C, mode))
    ref = np.moveaxis(ref, 1, -1).reshape(B, H, W, V)
    plain = interp_gen.bwd_gen_plain if derivative else interp_gen.gen_plain
    out = plain(torch.from_numpy(py), torch.from_numpy(px), R, C, mode)
    assert out.dtype == torch.float32 and out.shape == (B, H, W, V)
    assert np.isfinite(ref).all() and ref.std() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    # the CPU dispatch takes the plain version
    dispatch = interp_gen.bwd_gen if derivative else interp_gen.gen
    torch.testing.assert_close(dispatch(torch.from_numpy(py), torch.from_numpy(px), R, C, mode),
                               out, rtol=0, atol=0)


def test_gen_sums_only_taps_inside_the_support():
    """In the interior the tap weights sum to 1 per axis (and K′ to 0); a
    position beyond the support by more than the taps reach has none."""
    py = torch.tensor([[[[5.25, -9.0, float("nan")]]]])
    px = torch.tensor([[[[7.5, 7.5, 30.0]]]])
    out = interp_gen.gen_plain(py, px, 12, 20, "bicubic")
    torch.testing.assert_close(out, torch.tensor([[[[2.0, 1.0, 0.0]]]]), rtol=0, atol=1e-6)
    out = interp_gen.bwd_gen_plain(py, px, 12, 20, "bicubic")
    torch.testing.assert_close(out, torch.tensor([[[[2.0, 1.0, 0.0]]]]), rtol=0, atol=1e-6)


def test_gen_wrappers_refuse_cpu_tensors():
    py = torch.zeros(1, 2, 2, 3)
    before = (interp_gen.gen_launches, interp_gen.bwd_gen_launches)
    with pytest.raises(ValueError, match="CUDA"):
        interp_gen.gen_cuda(py, py, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        interp_gen.bwd_gen_cuda(py, py, 8, 8)
    assert (interp_gen.gen_launches, interp_gen.bwd_gen_launches) == before
