"""The port's row-banded interpolation against the TPU's banded kernels.

``paradis_tpu.ops.interp_pallas.grid_sample_interp_pallas(..., max_dy_pix=m)``
clamps the departure rows and, where ``_band_spec`` engages, runs the Pallas
banded kernels ``_fwd_kernel_banded`` / ``_bwd_kernel_banded`` in interpret
mode on the CPU, as tests/test_interp_pallas.py runs them.  The port's side
is its band plan (``ops/interp_band.py``), the banded plain versions, and the
dispatch ``interpolate(..., max_dy_pix=m)``, which clamps and, on CPU tensors,
runs the banded plain forward and backward through the autograd pairing.
The CUDA kernels are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.ops import interp_pallas  # noqa: E402
from paradis_tpu.ops.interp_pallas import _band_spec, _band_starts  # noqa: E402
from paradis_tpu.ops.interp_pallas import grid_sample_interp_pallas  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.advection import interpolate  # noqa: E402
from paradis_torch.ops.interp import interp_bwd_plain, interp_plain  # noqa: E402
from paradis_torch.ops.interp_band import (band_rows_window, band_spec,  # noqa: E402
                                           band_starts, interp_band_bwd_plain,
                                           interp_band_plain)

# Limits on max |port − Pallas| (the ones tests/test_torch_interp.py and
# tests/test_torch_interp_bwd.py state).  fp32: the Pallas kernels contract
# dense weight matrices over the band, the plain versions sum 16 (4) taps;
# only the summation order differs (forward 3e-5 on outputs up to ~4,
# gradients 2e-5).  bf16: the Pallas kernels round the weights (and g·K in
# the backward) to bf16 before their matmuls, ≤ 2^-9 relative on sums of up
# to ~7, and both sides round their results to bf16, one bf16 ulp apart where
# they straddle a rounding boundary.
FWD_ATOL = {"float32": 3e-5, "bfloat16": 4e-2}
BWD_ATOL = {"float32": 2e-5, "bfloat16": 4e-2}

LAT_1P4 = np.deg2rad(180.0 / 128)   # 1.40625° row spacing, radians
LAT_5P6 = np.deg2rad(180.0 / 32)    # 5.625°


@pytest.mark.parametrize("H,W,R,mode,max_dy_pix,engaged", [
    (128, 256, 132, "bicubic", 0.3 / LAT_1P4, True),    # 1.40625°: 16 bands of 40 rows
    (128, 256, 130, "bilinear", 0.3 / LAT_1P4, True),
    (32, 64, 36, "bicubic", 0.3 / LAT_5P6, False),      # 5.625° at 0.3 rad: the gate is off
    (32, 64, 36, "bicubic", 0.15 / LAT_5P6, True),      # the toy grid: rpb 8, band_rows 16
    (32, 64, 36, "bicubic", 0.2 / LAT_5P6, False),      # band_rows 24 > 36 / 2
    (32, 64, 36, "bicubic", None, False),               # no bound
    (20, 16, 22, "bilinear", 0.5, True),                # rpb halved to 4 (20 % 8 ≠ 0)
], ids=["1p4-bicubic", "1p4-bilinear", "5p6-off", "toy-on", "toy-off", "no-bound", "rpb4"])
def test_band_plan_matches_jax(H, W, R, mode, max_dy_pix, engaged):
    spec = band_spec(H, W, R, mode, max_dy_pix)
    assert spec == _band_spec(H, W, R, mode, max_dy_pix)
    assert (spec is not None) == engaged
    if spec is not None:
        assert band_starts(spec, R) == _band_starts(spec, R)


@pytest.mark.parametrize("env", [None, "0", "1", "2"])
@pytest.mark.parametrize("H,W,R,mode,max_dy_pix", [
    (128, 256, 132, "bicubic", 0.3 / LAT_1P4),   # gate on
    (32, 64, 36, "bicubic", 0.2 / LAT_5P6),      # gate off: band_rows 24 > 36 / 2
    (32, 64, 36, "bicubic", 1.5 / LAT_5P6),      # band_rows 48 > R: off whatever the env
    (32, 64, 36, "bicubic", None),
], ids=["1p4", "toy-off", "too-wide", "no-bound"])
def test_band_env_knob_matches_jax(monkeypatch, env, H, W, R, mode, max_dy_pix):
    """PARADIS_INTERP_BAND, read on every call: ``0`` turns banding off, ``1``
    passes the profitability gate (not the band's fit in the rows), anything
    else changes nothing."""
    if env is None:
        monkeypatch.delenv("PARADIS_INTERP_BAND", raising=False)
    else:
        monkeypatch.setenv("PARADIS_INTERP_BAND", env)
    assert band_spec(H, W, R, mode, max_dy_pix) == _band_spec(H, W, R, mode, max_dy_pix)


def test_the_1p4_plan_clips_its_edge_bands():
    """The plan the 1.40625° flagship runs: bound 12.2 px → m 13, 8 rows a
    band, 40 band rows; the first two and the last three bands share clipped
    starts."""
    spec = band_spec(128, 256, 132, "bicubic", 0.3 / LAT_1P4)
    assert spec[:4] == (8, 40, 14, 2)
    assert band_starts(spec, 132) == [0, 0] + list(range(4, 93, 8)) + [92, 92]
    spec = band_spec(128, 256, 130, "bilinear", 0.3 / LAT_1P4)
    assert band_starts(spec, 130) == [0, 0] + list(range(4, 85, 8)) + [90, 90, 90]


@pytest.mark.parametrize("H,W,R,mode,max_dy_pix", [
    (128, 256, 132, "bicubic", 0.3 / LAT_1P4),   # the 1.40625° plan, its edge bands clipped
    (128, 256, 130, "bilinear", 0.3 / LAT_1P4),
    (32, 15, 36, "bicubic", 1.5),                # chip_smoke.py's band tail: 8 rows of 16
    (32, 15, 34, "bilinear", 1.5),
    (20, 16, 22, "bilinear", 0.5),               # rpb halved to 4
], ids=["1p4-bicubic", "1p4-bilinear", "tail-bicubic", "tail-bilinear", "rpb4"])
def test_each_positions_band_rows_match_pallas(monkeypatch, H, W, R, mode, max_dy_pix):
    """The rows each position's taps may use, which the CUDA band filter
    (``Band`` in ``csrc/interp_stage.cuh``) computes per position as band
    ``p // (W·rpb)``, rows ``[lo, lo + band_rows)`` with ``lo = clip(band·rpb
    + pad − halo_lo, 0, R − band_rows)``: ``band_rows_window`` and that
    formula against the start row the Pallas banded kernels trace for each
    band's blocks (``_band_r0`` at ``program_id(2) = band``, one block a
    band) and against ``_band_starts``.  Every band lies inside the field."""
    spec = band_spec(H, W, R, mode, max_dy_pix)
    assert spec is not None
    rpb, band_rows, halo_lo, pad, _ = spec
    pallas_r0 = []
    for band in range(H // rpb):
        monkeypatch.setattr(interp_pallas.pl, "program_id",
                            lambda axis, band=band: jnp.int32(band if axis == 2 else 0))
        pallas_r0.append(int(interp_pallas._band_r0(spec, R, 1)))
    assert pallas_r0 == _band_starts(spec, R)
    per_position = np.repeat(pallas_r0, rpb * W)
    lo, hi = band_rows_window(spec, R, H, W)
    np.testing.assert_array_equal(lo.reshape(-1).numpy(), per_position)
    np.testing.assert_array_equal((hi - lo).numpy(), band_rows)
    p = np.arange(H * W)
    np.testing.assert_array_equal(
        np.clip(p // (W * rpb) * rpb + pad - halo_lo, 0, R - band_rows), per_position)
    assert lo.min() >= 0 and hi.max() <= R


def _setup(mode, H, W, V, m, spread, seed, kinks=False):
    """Field [1, R, C, V] and positions whose rows lie up to ``spread`` px
    from the arrival row (as tests/test_interp_pallas.py:_banded_setup), with
    columns inside the field; ``kinks`` moves them off the integer grid (the
    JAX gradient tests' positions)."""
    pad = 2 if mode == "bicubic" else 1
    R, C = H + 2 * pad, W + 2 * pad
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(1, R, C, V)).astype(np.float32)
    arr = (np.arange(H, dtype=np.float32) + pad)[None, :, None, None]
    py = (arr + rng.uniform(-spread, spread, size=(1, H, W, V))).astype(np.float32)
    px = rng.uniform(1.0, C - 3.0, size=(1, H, W, V)).astype(np.float32)
    if kinks:
        py, px = np.floor(py) + 0.37, np.floor(px) + 0.61
    g = rng.normal(size=(1, H, W, V)).astype(np.float32)
    assert band_spec(H, W, R, mode, m) is not None
    return field, py, px, g


def _pallas(field, py, px, g, mode, dtype, m):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def fn(f, y, x):
        return grid_sample_interp_pallas(f, y, x, mode, interpret=True, max_dy_pix=m)

    out, vjp = jax.vjp(fn, jnp.asarray(field, jdt), jnp.asarray(py), jnp.asarray(px))
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return as_np(out), [as_np(a) for a in vjp(jnp.asarray(g, jdt))]


def _clamp(py, mode, m):
    pad = 2 if mode == "bicubic" else 1
    arr = (np.arange(py.shape[1], dtype=np.float32) + pad)[None, :, None, None]
    return np.clip(py, arr - m, arr + m).astype(np.float32)


# H 32 × W 16 as the JAX banding tests (bound 2 px, rows within it, 2 bands of
# 16 rows); H 128 × W 16 with the 1.40625° bound (12.2 px), so the real
# 16-band plan of 40 rows with its clipped edge bands runs at a small P.
CASES = {
    "H32-bilinear-fp32": ("bilinear", "float32", 32, 2.0, 1.9),
    "H32-bicubic-fp32": ("bicubic", "float32", 32, 2.0, 1.9),
    "H32-bilinear-bf16": ("bilinear", "bfloat16", 32, 2.0, 1.9),
    "H32-bicubic-bf16": ("bicubic", "bfloat16", 32, 2.0, 1.9),
    "H128-bilinear-fp32": ("bilinear", "float32", 128, 0.3 / LAT_1P4, 12.0),
    "H128-bicubic-fp32": ("bicubic", "float32", 128, 0.3 / LAT_1P4, 12.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_band_plain_matches_pallas_banded_kernels(case):
    """Forward and VJP of the Pallas banded kernels against the banded plain
    versions on the clamped positions and against the dispatch through the
    autograd pairing (positions off the bilinear kinks, as the JAX tests)."""
    mode, dtype, H, m, spread = CASES[case]
    field, py, px, g = _setup(mode, H, 16, 3, m, spread, seed=H + len(mode), kinks=True)
    ref_out, ref_grads = _pallas(field, py, px, g, mode, dtype, m)
    tdt = getattr(torch, dtype)
    f, x, gt = torch.from_numpy(field).to(tdt), torch.from_numpy(px), torch.from_numpy(g).to(tdt)
    y = torch.from_numpy(_clamp(py, mode, m))
    spec = band_spec(H, 16, field.shape[1], mode, m)

    out = interp_band_plain(f, y, x, spec, mode)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=FWD_ATOL[dtype], rtol=0)
    plain = interp_band_bwd_plain(f, y, x, gt, spec, mode)
    for name, r, p in zip(("d_field", "d_py", "d_px"), ref_grads, plain):
        np.testing.assert_allclose(p.float().numpy(), r, atol=BWD_ATOL[dtype], rtol=0,
                                   err_msg=name)

    leaves = [t.clone().requires_grad_() for t in (f, torch.from_numpy(py), x)]
    res = interpolate(*leaves, mode, max_dy_pix=m)
    torch.testing.assert_close(res, out, rtol=0, atol=0)
    res.backward(gt)
    for name, p, leaf in zip(("d_field", "d_py", "d_px"), plain, leaves):
        torch.testing.assert_close(leaf.grad, p, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_banded_clamps_out_of_bound_rows(mode):
    """Rows pushed far beyond the bound are clamped as in JAX, forward and
    backward (d_py is zero where the clamp binds), and the banded function
    equals the unbanded one on the clamped positions."""
    m = 2.0
    field, py, px, g = _setup(mode, 32, 16, 4, m, 1.0, seed=6)
    py[0, 3] += 20.0
    py[0, 20] -= 20.0
    ref_out, ref_grads = _pallas(field, py, px, g, mode, "float32", m)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (field, py, px)]
    out = interpolate(*leaves, mode, max_dy_pix=m)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=FWD_ATOL["float32"], rtol=0)
    out.backward(torch.from_numpy(g))
    for name, r, leaf in zip(("d_field", "d_py", "d_px"), ref_grads, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), r, atol=BWD_ATOL["float32"], rtol=0,
                                   err_msg=name)
    assert not leaves[1].grad[0, 3].any() and not leaves[1].grad[0, 20].any()

    f, x, gt = torch.from_numpy(field), torch.from_numpy(px), torch.from_numpy(g)
    y = torch.from_numpy(_clamp(py, mode, m))
    spec = band_spec(32, 16, field.shape[1], mode, m)
    torch.testing.assert_close(interp_band_plain(f, y, x, spec, mode),
                               interp_plain(f, y, x, mode), rtol=0, atol=0)
    for a, b in zip(interp_band_bwd_plain(f, y, x, gt, spec, mode),
                    interp_bwd_plain(f, y, x, gt, mode)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_band_drops_taps_outside_the_band():
    """Unclamped rows outside their band lose those taps: the banded plain
    version is not the unbanded one there (the plan is read from the arrival
    row, never from pix_y)."""
    field, py, px, _ = _setup("bicubic", 32, 16, 2, 2.0, 1.0, seed=8)
    py[0, 3] += 12.0  # rows 15-19 in padded rows: the band of arrival row 3 ends at 16
    f, y, x = torch.from_numpy(field), torch.from_numpy(py), torch.from_numpy(px)
    spec = band_spec(32, 16, field.shape[1], "bicubic", 2.0)
    banded, unbanded = interp_band_plain(f, y, x, spec), interp_plain(f, y, x)
    assert (banded[0, 3] - unbanded[0, 3]).abs().max() > 0.1
    torch.testing.assert_close(banded[0, 4:], unbanded[0, 4:], rtol=0, atol=0)


def test_banded_pairing_on_the_cpu_counts_no_launch():
    """On CPU tensors the banded pairing runs the plain versions; the banded
    kernels' wrappers raise on CPU tensors and count nothing."""
    field, py, px, g = (torch.from_numpy(a) for a in _setup("bicubic", 32, 16, 2, 2.0, 1.0,
                                                            seed=9))
    spec = band_spec(32, 16, field.shape[1], "bicubic", 2.0)
    counts = lambda: (interp_cuda.launches, interp_cuda.bwd_launches,  # noqa: E731
                      interp_cuda.band_launches, interp_cuda.band_bwd_launches)
    before = counts()
    f = field.clone().requires_grad_()
    out = interp_cuda.Interp.apply(f, py, px, "bicubic", False, spec)
    out.backward(g)
    assert counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.interp_band_fwd_cuda(field, py, px, spec, "bicubic")
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.interp_band_bwd_cuda(field, py, px, g, spec, "bicubic")
    assert counts() == before
