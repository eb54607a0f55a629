"""The bilinear route's host side, and the plain bilinear version on the
cases the route's card tests use.

The bilinear kernels (``csrc/interp_bilinear.cuh``) run only on a card, where
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold them against
the plain versions.  Here: the scratch each backward wrapper allocates for
its route, and the plain bilinear forward against the Pallas kernel
(interpret mode) on positions over the padded edge, on integer positions
(the bilinear kinks) and on positions that are not finite; and the cases
and bounds of ``tools/bench_bilinear``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.ops.interp_pallas import grid_sample_interp_pallas  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.interp import interp_plain  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_backward_scratch_follows_the_route(mode, dtype):
    """Bicubic's row-slab backward takes its span, int32 [B, ceil(V / 2),
    ceil(H·W / 32), 2]; the bilinear backward a float32 accumulator of a
    bf16 d_field, [B, R, C, V], and nothing for a float32 one.  d_field is
    in the field's dtype, d_py and d_px float32."""
    B, R, C, V, H, W = 2, 13, 22, 77, 9, 15
    field = torch.zeros(B, R, C, V, dtype=getattr(torch, dtype))
    d_field, d_py, d_px, scratch = interp_cuda._bwd_outputs(field, H, W, mode)
    assert d_field.shape == field.shape and d_field.dtype == field.dtype
    assert d_py.shape == d_px.shape == (B, H, W, V)
    assert d_py.dtype == d_px.dtype == torch.float32
    if mode == "bicubic":
        assert scratch.dtype == torch.int32
        assert tuple(scratch.shape) == (B, (V + 1) // 2, -(-H * W // 32), 2)
    elif dtype == "bfloat16":
        assert scratch.dtype == torch.float32 and scratch.shape == field.shape
    else:
        assert scratch.numel() == 0


def _positions(kind, R, C, shape, rng):
    """Positions of the card tests' bilinear cases: ``edge`` over the
    outermost cells and up to 1.5 px beyond; ``integer`` on cells;
    ``nonfinite`` a tenth each NaN, inf and -inf."""
    py = rng.uniform(-1.0, R, size=shape)
    px = rng.uniform(-1.0, C, size=shape)
    if kind == "edge":
        py = rng.choice([-1.5, -1.0, -0.5, 0.0, 0.25, R - 1.5, R - 1.0, R - 0.5, R + 0.5],
                        size=shape)
        px = np.where(rng.random(shape) < 0.5, px,
                      rng.choice([-1.5, -0.5, 0.0, C - 1.0, C - 0.5], size=shape))
    elif kind == "integer":
        py, px = np.round(py), np.round(px)
    elif kind == "nonfinite":
        pick = rng.random(shape)
        bad = np.select([pick < 0.1, pick < 0.2, pick < 0.3], [np.nan, np.inf, -np.inf], 0.0)
        axis = rng.random(shape) < 0.5
        py = np.where((pick < 0.3) & axis, bad, py)
        px = np.where((pick < 0.3) & ~axis, bad, px)
    return py.astype(np.float32), px.astype(np.float32)


@pytest.mark.parametrize("kind", ["edge", "integer", "nonfinite"])
def test_plain_bilinear_matches_pallas_on_the_route_cases(kind):
    """The plain bilinear forward, which the card tests hold the bilinear
    kernels against, equals the Pallas kernel in interpret mode to 3e-5 (the
    same float32 sums in another order: the Pallas kernel contracts dense
    weight matrices) on these positions, and is finite; a position that is
    not finite gives zero."""
    B, R, C, V, H, W = 1, 10, 18, 5, 8, 16
    rng = np.random.default_rng(len(kind))
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    py, px = _positions(kind, R, C, (B, H, W, V), rng)
    ref = np.asarray(grid_sample_interp_pallas(jnp.asarray(field), jnp.asarray(py),
                                               jnp.asarray(px), "bilinear", interpret=True))
    out = interp_plain(torch.from_numpy(field), torch.from_numpy(py), torch.from_numpy(px),
                       "bilinear").numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)
    if kind == "nonfinite":
        assert not out[~(np.isfinite(py) & np.isfinite(px))].any()


def test_bench_bilinear_needs_a_card(monkeypatch):
    """``tools.bench_bilinear`` times kernels on a card only: without one it
    exits before starting a turn."""
    from paradis_torch.tools import bench_bilinear

    def no_turn(*args, **kwargs):
        raise AssertionError("a turn started without a card")

    monkeypatch.setattr(bench_bilinear, "turn", no_turn)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_bilinear.main(["--other", "."])


def test_bench_bilinear_cases_and_bounds():
    """``tools.bench_bilinear``'s cases: one id each; the six entry points
    timed at 1.40625° on both dtypes; the spatial blocks inside the grid and
    off its centre; the bound of the 1.40625° float32 forward that of
    ``PERF.md`` (field, both positions and the output moved once at 3.35
    TB/s: 0.121 ms), a block's from its own positions and the whole field."""
    from paradis_torch.tools import bench_bilinear as bb

    cases = bb.cases()
    assert len({c["id"] for c in cases}) == len(cases)
    timed = {k for c in cases if c["grid"] == bb.HR and c["mode"] == "bilinear"
             for _, k in c["timed"]}
    assert timed == {"interp_fwd", "interp_chunk_fwd", "interp_band_fwd", "interp_bwd",
                     "interp_chunk_bwd", "interp_band_bwd"}
    blocks = [c for c in cases if c["block"] != (0, c["grid"][0], 0, c["grid"][1])]
    assert len(blocks) == 8
    for c in blocks:
        r0, r1, c0, c1 = c["block"]
        assert 0 < r0 < r1 <= c["grid"][0] and 0 <= c0 < c1 <= c["grid"][1]
    whole = next(c for c in cases if c["id"] == "fwd bilinear float32 128x256 clamped")
    ms, by = bb.bound(whole)
    assert by == "bytes" and ms == pytest.approx(0.1209, abs=1e-4)
    half = next(c for c in blocks if c["kind"] == "fwd" and c["dtype"] == "float32"
                and c["block"] == (64, 128, 0, 256))
    n_out = 64 * 256 * 768
    assert bb.bound(half)[0] == pytest.approx(
        (130 * 258 * 768 * 4 + 3 * 4 * n_out) / 3.35e12 * 1e3, rel=1e-3)
