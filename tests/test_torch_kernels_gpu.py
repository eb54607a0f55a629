"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test skips without a CUDA device.  The file imports
nothing of JAX, so it also runs on a machine without it, where the suite's
``conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.ops.interp import interp_bwd_plain, interp_plain  # noqa: E402


def _inputs(B, R, C, V, H, W, seed, outside=3.0):
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    py = rng.uniform(-outside, R - 1 + outside, size=(B, H, W, V)).astype(np.float32)
    px = rng.uniform(-outside, C - 1 + outside, size=(B, H, W, V)).astype(np.float32)
    return field, py, px


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_kernel_matches_plain_on_card(mode, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    field, py, px = _inputs(1, 36, 68, 77, 31, 63, seed=3)  # odd P·V tail
    tdt = getattr(torch, dtype)
    f = torch.from_numpy(field).cuda().to(tdt)
    y, x = torch.from_numpy(py).cuda(), torch.from_numpy(px).cuda()
    before = interp_cuda.launches
    out = interp_cuda.interp_fwd_cuda(f, y, x, mode)
    torch.cuda.synchronize()
    assert interp_cuda.launches == before + 1
    ref = interp_plain(f, y, x, mode)
    # the same fp32 sums in another FMA order (1e-5 for fields of unit
    # spread); a bf16 result may also round to the neighbouring bf16 value
    # (one ulp ≤ 2^-7 relative), the limits chip_smoke.py uses
    rel = 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7
    diff = (out.float() - ref.float()).abs()
    assert (diff <= 1e-5 + rel * ref.float().abs()).all(), float(diff.max())


def _within(out, ref, atol, rtol):
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all()), float(diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_backward_kernel_matches_plain_on_card(mode, dtype, integer):
    """The backward kernel against ``interp_bwd_plain`` (odd P·V tail), and
    ``torch.autograd.grad`` through the autograd pairing, which must launch
    the backward kernel once.  Limits as chip_smoke.py's ``BWD_TOL``: the same
    fp32 sums in another order (d_field also in the atomics' run-to-run
    order), plus one bf16 ulp for a bf16 d_field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    field, py, px = _inputs(1, 36, 68, 77, 31, 63, seed=5)
    if integer:
        py, px = np.round(py), np.round(px)
    g = np.random.default_rng(6).normal(size=py.shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    f = torch.from_numpy(field).cuda().to(tdt)
    y, x = torch.from_numpy(py).cuda(), torch.from_numpy(px).cuda()
    gt = torch.from_numpy(g).cuda().to(tdt)
    before = interp_cuda.bwd_launches
    out = interp_cuda.interp_bwd_cuda(f, y, x, gt, mode)
    torch.cuda.synchronize()
    assert interp_cuda.bwd_launches == before + 1
    ref = interp_bwd_plain(f, y, x, gt, mode)
    assert out[0].dtype == tdt and out[1].dtype == out[2].dtype == torch.float32
    tols = ((2e-5, 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7), (3e-5, 1e-5),
            (3e-5, 1e-5))
    for name, o, r, tol in zip(("d_field", "d_py", "d_px"), out, ref, tols):
        ok, err = _within(o, r, *tol)
        assert ok, (name, err)
    if integer and mode == "bilinear":
        assert not out[1].any() and not out[2].any()

    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    n_fwd, n_bwd = interp_cuda.launches, interp_cuda.bwd_launches
    res = interp_cuda.Interp.apply(*leaves, mode, False)
    grads = torch.autograd.grad(res, leaves, gt)
    torch.cuda.synchronize()
    assert (interp_cuda.launches, interp_cuda.bwd_launches) == (n_fwd + 1, n_bwd + 1)
    for name, o, r, tol in zip(("d_field", "d_py", "d_px"), grads, ref, tols):
        ok, err = _within(o, r, *tol)
        assert ok, (name, err)


def _band_inputs(mode, dtype, seed, H=32, W=15, V=77, bound=1.5):
    """An odd tail shape where the band gate is on (H 32, W 15, V 77,
    bound 1.5 px: bands of 8 rows over 16 padded rows): rows up to 3 px from
    the arrival row, two rows pushed 20 px beyond the bound, then clamped to
    it as ``interpolate`` clamps; columns up to 3 px outside the field."""
    from paradis_torch.ops.interp_band import band_spec

    pad = 2 if mode == "bicubic" else 1
    R, C = H + 2 * pad, W + 2 * pad
    rng = np.random.default_rng(seed)
    field = rng.normal(size=(1, R, C, V)).astype(np.float32)
    arr = (np.arange(H, dtype=np.float32) + pad)[None, :, None, None]
    py = arr + rng.uniform(-3.0, 3.0, size=(1, H, W, V)).astype(np.float32)
    py[0, 3] += 20.0
    py[0, 20] -= 20.0
    py = np.clip(py, arr - bound, arr + bound).astype(np.float32)
    px = rng.uniform(-3.0, C + 2.0, size=(1, H, W, V)).astype(np.float32)
    g = rng.normal(size=(1, H, W, V)).astype(np.float32)
    spec = band_spec(H, W, R, mode, bound)
    assert spec is not None
    tdt = getattr(torch, dtype)
    f = torch.from_numpy(field).cuda().to(tdt)
    return (f, torch.from_numpy(py).cuda(), torch.from_numpy(px).cuda(),
            torch.from_numpy(g).cuda().to(tdt), spec)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_band_kernels_match_plain_and_unbanded_on_card(mode, dtype):
    """The row-banded forward and backward kernels against their plain
    versions and against the unbanded kernels on the same clamped positions
    (limits as above: the same fp32 sums in another order, d_field in the
    atomics' order, one bf16 ulp for a bf16 result); under the clamp the band
    filter removes no tap, so the forward and d_py, d_px equal the unbanded
    kernels' bitwise.  The autograd pairing with a band plan launches each
    banded kernel once and no unbanded one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.ops.interp_band import interp_band_bwd_plain, interp_band_plain

    f, y, x, g, spec = _band_inputs(mode, dtype, seed=7)
    rel = 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7
    before = interp_cuda.band_launches
    out = interp_cuda.interp_band_fwd_cuda(f, y, x, spec, mode)
    torch.cuda.synchronize()
    assert interp_cuda.band_launches == before + 1 and out.dtype == f.dtype
    for ref in (interp_band_plain(f, y, x, spec, mode), interp_cuda.interp_fwd_cuda(f, y, x, mode)):
        ok, err = _within(out, ref, 1e-5, rel)
        assert ok, err
    assert torch.equal(out, interp_cuda.interp_fwd_cuda(f, y, x, mode))

    before = interp_cuda.band_bwd_launches
    grads = interp_cuda.interp_band_bwd_cuda(f, y, x, g, spec, mode)
    torch.cuda.synchronize()
    assert interp_cuda.band_bwd_launches == before + 1
    assert grads[0].dtype == f.dtype and grads[1].dtype == grads[2].dtype == torch.float32
    tols = ((2e-5, rel), (3e-5, 1e-5), (3e-5, 1e-5))
    unbanded = interp_cuda.interp_bwd_cuda(f, y, x, g, mode)
    for ref in (interp_band_bwd_plain(f, y, x, g, spec, mode), unbanded):
        for name, o, r, tol in zip(("d_field", "d_py", "d_px"), grads, ref, tols):
            ok, err = _within(o, r, *tol)
            assert ok, (name, err)
    assert torch.equal(grads[1], unbanded[1]) and torch.equal(grads[2], unbanded[2])

    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    counts = lambda: (interp_cuda.launches, interp_cuda.bwd_launches,  # noqa: E731
                      interp_cuda.band_launches, interp_cuda.band_bwd_launches)
    n0 = counts()
    res = interp_cuda.Interp.apply(*leaves, mode, False, spec)
    auto = torch.autograd.grad(res, leaves, g)
    torch.cuda.synchronize()
    assert counts() == (n0[0], n0[1], n0[2] + 1, n0[3] + 1)
    for name, o, r, tol in zip(("d_field", "d_py", "d_px"), auto, grads, tols):
        ok, err = _within(o, r, *tol)
        assert ok, (name, err)


# (B, V, H, W) and the row bound (px) of the unclamped banded cases; R and C
# are H and W plus the mode's pad.  The band tail (bands of 8 rows over 16
# padded rows; V 77, no multiple of a channel group), with B 2 and with a
# field view off its 16-byte boundary; W 250 at 1.40625° rows, whose bands
# of 2,000 positions the forward's tiles (256 positions fp32, 128 bf16 on a
# 132-SM H100, V 64) do not divide, so each band ends in a partial tile, and
# whose 32-position chunks of the backward's pre-pass straddle bands; and the
# 1.40625° shape, whose 2,048-position tiles are its bands.
BAND_OUTSIDE_CASES = {
    "tail": ((1, 77, 32, 15), 1.5),
    "tail-b2": ((2, 77, 32, 15), 1.5),
    "tail-unaligned": ((1, 77, 32, 15), 1.5),
    "two-bands": ((1, 64, 128, 250), 12.2),
    "1p4": ((1, 768, 128, 256), 12.2),
}


def _band_taps(py, spec, R, mode):
    """``(kept, cut)`` of each (position, channel): whether any of its tap
    rows lies in its band (and so in the field), and whether any lies in the
    field but outside its band.  A non-finite row has neither."""
    from paradis_torch.ops.interp_band import band_rows_window

    _, H, W, _ = py.shape
    lo, hi = (t.view(1, H, W, 1) for t in band_rows_window(spec, R, H, W, py.device))
    first, n = (-1, 4) if mode == "bicubic" else (0, 2)
    kept = torch.zeros_like(py, dtype=torch.bool)
    cut = torch.zeros_like(kept)
    for k in range(n):
        r = torch.floor(py) + (first + k)
        in_field = (r >= 0) & (r <= R - 1)
        in_band = (r >= lo) & (r < hi)
        kept |= in_band
        cut |= in_field & ~in_band
    return kept, cut


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BAND_OUTSIDE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_band_kernels_hold_taps_to_the_band_on_unclamped_rows_on_card(mode, dtype, case):
    """Rows not clamped: within the bound, then 30% pushed 5–20 px beyond it,
    so that taps leave their band (some inside the field, some beyond it);
    1% of the rows NaN, 1% inf, 1% of the columns -inf.  The banded forward
    and backward agree with the banded plain versions (limits as above);
    where a tap leaves its band they differ from the unbanded kernels, and
    where none does they equal them bitwise (the forward, d_py and d_px);
    an item with no tap row in its band gets exactly zero out, d_py and
    d_px."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.ops.interp_band import band_spec, interp_band_bwd_plain, interp_band_plain

    (B, V, H, W), bound = BAND_OUTSIDE_CASES[case]
    pad = 2 if mode == "bicubic" else 1
    R, C = H + 2 * pad, W + 2 * pad
    rng = np.random.default_rng(len(case) + 50)
    field = rng.normal(size=(B, R, C, V)).astype(np.float32)
    arr = (np.arange(H, dtype=np.float32) + pad)[None, :, None, None]
    dy = rng.uniform(-bound, bound, size=(B, H, W, V))
    push = rng.random(dy.shape) < 0.3
    dy = np.where(push, dy + np.sign(dy) * rng.uniform(5.0, 20.0, dy.shape), dy)
    py = (arr + dy).astype(np.float32)
    px = rng.uniform(-3.0, C + 2.0, size=py.shape).astype(np.float32)
    pick = rng.random(py.shape)
    py[pick < 0.01] = np.nan
    py[(pick >= 0.01) & (pick < 0.02)] = np.inf
    px[(pick >= 0.02) & (pick < 0.03)] = -np.inf
    tdt = getattr(torch, dtype)
    f = torch.from_numpy(field).cuda().to(tdt)
    if "unaligned" in case:
        buf = torch.empty(f.numel() + 1, dtype=tdt, device="cuda")
        f = buf[1:].view(f.shape).copy_(f)
        assert f.is_contiguous() and f.data_ptr() % 16
    y, x = torch.from_numpy(py).cuda(), torch.from_numpy(px).cuda()
    g = torch.from_numpy(rng.normal(size=py.shape).astype(np.float32)).cuda().to(tdt)
    spec = band_spec(H, W, R, mode, bound)
    assert spec is not None
    kept, cut = _band_taps(y, spec, R, mode)
    no_tap = ~kept | ~torch.isfinite(x)
    assert cut.any() and (~kept & cut).any() and (~cut).any()

    n0 = (interp_cuda.band_launches, interp_cuda.band_bwd_launches)
    out = interp_cuda.interp_band_fwd_cuda(f, y, x, spec, mode)
    grads = interp_cuda.interp_band_bwd_cuda(f, y, x, g, spec, mode)
    torch.cuda.synchronize()
    assert (interp_cuda.band_launches, interp_cuda.band_bwd_launches) == (n0[0] + 1, n0[1] + 1)
    assert out.dtype == f.dtype and grads[0].dtype == f.dtype
    rel = 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7
    ok, err = _within(out, interp_band_plain(f, y, x, spec, mode), 1e-5, rel)
    assert ok, err
    tols = ((2e-5, rel), (3e-5, 1e-5), (3e-5, 1e-5))
    for name, o, r, tol in zip(("d_field", "d_py", "d_px"), grads,
                               interp_band_bwd_plain(f, y, x, g, spec, mode), tols):
        ok, err = _within(o, r, *tol)
        assert ok, (name, err)
        assert torch.isfinite(o).all(), name

    unb_out = interp_cuda.interp_fwd_cuda(f, y, x, mode)
    unb = interp_cuda.interp_bwd_cuda(f, y, x, g, mode)
    assert (out != unb_out)[cut].any()
    assert (grads[1] != unb[1])[cut].any() or (grads[2] != unb[2])[cut].any()
    whole = ~cut
    assert torch.equal(out[whole], unb_out[whole])
    assert torch.equal(grads[1][whole], unb[1][whole])
    assert torch.equal(grads[2][whole], unb[2][whole])
    assert not out[no_tap].any() and not grads[1][no_tap].any() and not grads[2][no_tap].any()


def _chunk_inputs(shape, dtype, seed, depart_px=None):
    """Field, positions and cotangent at ``shape`` (B, R, C, V, H, W): random
    positions up to 3 px outside the field with a NaN and an inf among them,
    or, with ``depart_px``, departure-like rows within that many px of the
    padded arrival row."""
    B, R, C, V, H, W = shape
    field, py, px = _inputs(B, R, C, V, H, W, seed)
    if depart_px is not None:
        rng = np.random.default_rng(seed + 1)
        arr = (np.arange(H, dtype=np.float32) + (R - H) // 2)[None, :, None, None]
        py = (arr + rng.uniform(-depart_px, depart_px, size=py.shape)).astype(np.float32)
    py.reshape(-1)[5] = np.nan
    py.reshape(-1)[7] = np.inf
    px.reshape(-1)[9] = -np.inf
    g = np.random.default_rng(seed + 2).normal(size=py.shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(field).cuda().to(tdt), torch.from_numpy(py).cuda(),
            torch.from_numpy(px).cuda(), torch.from_numpy(g).cuda().to(tdt))


# (B, R, C, V, H, W) of the chunked cases: the 5.625° field with V no
# multiple of the channel group; a tail; the 1.40625° field (260 columns)
# with 64 channels, whose random positions' window (all 132 rows) is taller
# than the forward's shared-memory slab at any block size; a ragged last
# tile of positions with V a multiple of the channel group (16-byte copies);
# and V below one channel group (groups of one channel)
CHUNK_SHAPES = {"random": (1, 36, 68, 77, 32, 64), "departure": (1, 36, 68, 77, 32, 64),
                "tail": (1, 13, 22, 77, 9, 15), "tall": (1, 132, 260, 64, 64, 128),
                "ragged": (1, 36, 68, 24, 31, 63), "narrow": (1, 36, 68, 3, 31, 63)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random-rw8", "departure-rw8", "tail-rw8", "tail-rw32",
                                  "departure-rw16", "tall-rw32", "ragged-rw8", "narrow-rw8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_chunk_kernels_match_plain_and_unbanded_on_card(mode, dtype, case):
    """The row-chunked forward and backward kernels against their plain
    versions (limits as above) and against the unbanded kernels: the forward
    and d_py, d_px bitwise (the same float order per position), d_field in
    the atomics' order.  The tail shapes have a 5-row last chunk (rw 8) or a
    single chunk shorter than rw (rw 32).  The autograd pairing with a chunk
    size launches each chunked kernel once and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.ops.interp_chunk import interp_chunk_bwd_plain, interp_chunk_plain

    kind, rw = case.split("-rw")
    rw = int(rw)
    shape = CHUNK_SHAPES[kind]
    f, y, x, g = _chunk_inputs(shape, dtype, seed=11 + rw,
                               depart_px=3.0 if kind == "departure" else None)
    rel = 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7
    before = interp_cuda.chunk_launches
    out = interp_cuda.interp_chunk_fwd_cuda(f, y, x, rw, mode)
    torch.cuda.synchronize()
    assert interp_cuda.chunk_launches == before + 1 and out.dtype == f.dtype
    ok, err = _within(out, interp_chunk_plain(f, y, x, rw, mode), 1e-5, rel)
    assert ok, err
    assert torch.equal(out, interp_cuda.interp_fwd_cuda(f, y, x, mode))

    before = interp_cuda.chunk_bwd_launches
    grads = interp_cuda.interp_chunk_bwd_cuda(f, y, x, g, rw, mode)
    torch.cuda.synchronize()
    assert interp_cuda.chunk_bwd_launches == before + 1
    assert grads[0].dtype == f.dtype and grads[1].dtype == grads[2].dtype == torch.float32
    tols = ((2e-5, rel), (3e-5, 1e-5), (3e-5, 1e-5))
    for ref in (interp_chunk_bwd_plain(f, y, x, g, rw, mode),
                interp_cuda.interp_bwd_cuda(f, y, x, g, mode)):
        for name, o, r, tol in zip(("d_field", "d_py", "d_px"), grads, ref, tols):
            ok, err = _within(o, r, *tol)
            assert ok, (name, err)
    unbanded = interp_cuda.interp_bwd_cuda(f, y, x, g, mode)
    assert torch.equal(grads[1], unbanded[1]) and torch.equal(grads[2], unbanded[2])

    leaves = [t.clone().requires_grad_() for t in (f, y, x)]
    counts = lambda: (interp_cuda.launches, interp_cuda.bwd_launches,  # noqa: E731
                      interp_cuda.band_launches, interp_cuda.band_bwd_launches,
                      interp_cuda.chunk_launches, interp_cuda.chunk_bwd_launches)
    n0 = counts()
    res = interp_cuda.Interp.apply(*leaves, mode, False, None, rw)
    auto = torch.autograd.grad(res, leaves, g)
    torch.cuda.synchronize()
    assert counts() == (*n0[:4], n0[4] + 1, n0[5] + 1)
    for name, o, r, tol in zip(("d_field", "d_py", "d_px"), auto, grads, tols):
        ok, err = _within(o, r, *tol)
        assert ok, (name, err)


# (B, R, C, V, H, W), positions and route of the unbanded forward's cases:
# the 5.625° fields (bicubic and bilinear pads) and a tail take the resident
# route, the 1.40625° field (132 × 260 rows and columns) the window route,
# at full size with 1024-thread blocks and over 48 KB of shared memory a
# block (which the row-chunked kernel, a library of its own, launches with
# the same code right after), and with small V on smaller blocks; V 77 is no
# multiple of a channel group, and "unaligned" hands the kernel a field view
# 4 (fp32) or 2 (bf16) bytes past a 16-byte boundary
FWD_CASES = {
    "resident-wild": ((1, 36, 68, 768, 32, 64), "wild"),
    "resident-departure": ((1, 34, 66, 768, 32, 64), "departure"),
    "resident-outside": ((1, 36, 68, 64, 32, 64), "outside"),
    "resident-nonfinite": ((1, 36, 68, 64, 32, 64), "nonfinite"),
    "resident-v77-b2": ((2, 36, 68, 77, 32, 64), "departure"),
    "resident-unaligned": ((1, 36, 68, 64, 32, 64), "wild"),
    "resident-tail": ((1, 13, 22, 77, 9, 15), "wild"),
    "window-departure": ((1, 132, 260, 768, 128, 256), "departure"),
    "window-wild-v77-b2": ((2, 132, 260, 77, 32, 64), "wild"),
    "window-outside": ((1, 132, 260, 8, 32, 64), "outside"),
    "window-nonfinite-unaligned": ((1, 132, 260, 8, 64, 128), "nonfinite"),
}


def _fwd_inputs(shape, kind, dtype, seed, unaligned):
    """Field and positions at ``shape``: ``wild`` anywhere up to 3 px outside
    the field; ``departure`` within 3 px of the padded arrival point;
    ``outside`` every tap outside the field (rows above it or columns beyond
    it); ``nonfinite`` wild with a tenth each NaN, inf and -inf."""
    B, R, C, V, H, W = shape
    field, py, px = _inputs(B, R, C, V, H, W, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "departure":
        ay = (np.arange(H, dtype=np.float32) + (R - H) // 2)[None, :, None, None]
        ax = (np.arange(W, dtype=np.float32) + (C - W) // 2)[None, None, :, None]
        py = (ay + rng.uniform(-3.0, 3.0, size=py.shape)).astype(np.float32)
        px = (ax + rng.uniform(-3.0, 3.0, size=px.shape)).astype(np.float32)
    elif kind == "outside":
        above = rng.random(py.shape) < 0.5
        py = np.where(above, rng.uniform(-40.0, -2.01, py.shape), py).astype(np.float32)
        px = np.where(above, px, rng.uniform(C + 1.01, C + 40.0, px.shape)).astype(np.float32)
    elif kind == "nonfinite":
        pick = rng.random(py.shape)
        bad = np.select([pick < 0.1, pick < 0.2, pick < 0.3], [np.nan, np.inf, -np.inf], 0.0)
        axis = rng.random(py.shape) < 0.5
        py = np.where((pick < 0.3) & axis, bad, py).astype(np.float32)
        px = np.where((pick < 0.3) & ~axis, bad, px).astype(np.float32)
    tdt = getattr(torch, dtype)
    f = torch.from_numpy(field).cuda().to(tdt)
    if unaligned:
        buf = torch.empty(f.numel() + 1, dtype=tdt, device="cuda")
        f = buf[1:].view(f.shape).copy_(f)
        assert f.is_contiguous() and f.data_ptr() % 16
    return f, torch.from_numpy(py).cuda(), torch.from_numpy(px).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FWD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_fwd_kernel_matches_chunked_bitwise_and_plain_on_card(mode, dtype, case):
    """The unbanded forward kernel takes the route the case names, launches
    once, agrees with ``interp_plain`` (limits as above: the same fp32 sums in
    another FMA order, one bf16 ulp for a bf16 result) and equals the
    row-chunked kernel bitwise (the same float order per position); with
    every tap outside the field, it is zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, kind = FWD_CASES[case]
    f, y, x = _fwd_inputs(shape, kind, dtype, seed=len(case), unaligned="unaligned" in case)
    assert interp_cuda.interp_fwd_route(f, mode) == case.split("-")[0]
    before = interp_cuda.launches
    out = interp_cuda.interp_fwd_cuda(f, y, x, mode)
    torch.cuda.synchronize()
    assert interp_cuda.launches == before + 1 and out.dtype == f.dtype
    rel = 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7
    ok, err = _within(out, interp_plain(f, y, x, mode), 1e-5, rel)
    assert ok, err
    assert torch.equal(out, interp_cuda.interp_chunk_fwd_cuda(f, y, x, 8, mode))
    if kind == "outside":
        assert not out.any()


# The backward's cases, on the fields and positions of FWD_CASES' kinds
# (``_fwd_inputs``): the 5.625° field, whose slabs each hold the rows of
# every position of their channel group; a tall field (132 rows, the
# 1.40625° grid) with few channels, so a slab is a few rows and an item's
# taps often straddle two or three slabs; V 77 (no multiple of a channel
# group), B 2, and a field view off its 16-byte (and 8-byte) boundary
BWD_CASES = {
    "flagship-wild": ((1, 36, 68, 768, 32, 64), "wild"),
    "flagship-departure": ((1, 36, 68, 768, 32, 64), "departure"),
    "outside": ((1, 36, 68, 64, 32, 64), "outside"),
    "nonfinite": ((1, 36, 68, 64, 32, 64), "nonfinite"),
    "v77-b2": ((2, 36, 68, 77, 32, 64), "departure"),
    "unaligned": ((1, 36, 68, 64, 32, 64), "wild"),
    "tall-departure": ((1, 132, 260, 8, 128, 256), "departure"),
    "tall-wild-v77-b2": ((2, 132, 260, 77, 32, 64), "wild"),
    "tall-nonfinite-unaligned": ((1, 132, 260, 8, 64, 128), "nonfinite"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_bwd_kernels_match_each_other_bitwise_and_plain_on_card(mode, dtype, case):
    """The unbanded and the row-chunked backward (one kernel, two entry
    points) each launch once, agree with ``interp_bwd_plain`` within
    chip_smoke.py's ``BWD_TOL`` (the same fp32 sums in another order,
    d_field in the shared-memory atomics' order, one bf16 ulp for a bf16
    d_field) and with each other bitwise on d_py and d_px (one thread sums an
    item whole, in one order), whatever ``rw``; with every tap outside the
    field, all three outputs are zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, kind = BWD_CASES[case]
    f, y, x = _fwd_inputs(shape, kind, dtype, seed=len(case) + 40,
                          unaligned="unaligned" in case)
    g = torch.from_numpy(np.random.default_rng(len(case)).normal(size=tuple(y.shape))
                         .astype(np.float32)).cuda().to(f.dtype)
    n0 = (interp_cuda.bwd_launches, interp_cuda.chunk_bwd_launches)
    out = interp_cuda.interp_bwd_cuda(f, y, x, g, mode)
    chunked = [interp_cuda.interp_chunk_bwd_cuda(f, y, x, g, rw, mode) for rw in (8, 32)]
    torch.cuda.synchronize()
    assert (interp_cuda.bwd_launches, interp_cuda.chunk_bwd_launches) == (n0[0] + 1, n0[1] + 2)
    assert out[0].dtype == f.dtype and out[1].dtype == out[2].dtype == torch.float32
    rel = 1e-5 if dtype == "float32" else 1e-5 + 2.0 ** -7
    tols = ((2e-5, rel), (3e-5, 1e-5), (3e-5, 1e-5))
    ref = interp_bwd_plain(f, y, x, g, mode)
    for grads in (out, *chunked):
        for name, o, r, tol in zip(("d_field", "d_py", "d_px"), grads, ref, tols):
            ok, err = _within(o, r, *tol)
            assert ok, (name, err)
            assert torch.isfinite(o).all(), name
        assert torch.equal(grads[1], out[1]) and torch.equal(grads[2], out[2])
    if kind == "outside":
        assert not out[0].any() and not out[1].any() and not out[2].any()


@pytest.mark.gpu
def test_chunk_kernels_refuse_a_chunk_that_does_not_fit():
    """Neither chunked kernel refuses a chunk of one channel larger than the
    card's shared memory (64 rows x 4096 fp32 columns, 1 MB), whatever
    ``rw``: each takes that field and equals its unchunked kernel (the
    backward's d_py and d_px bitwise).  Each refuses only a field whose one
    row of one channel does not fit (65536 fp32 columns, 256 KB: for the
    backward, with its float32 accumulator and the taps' halo rows).  A
    refusal raises and counts no launch; it does not run the unchunked
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.randn(1, 64, 4096, 1, device="cuda")
    y = torch.full((1, 2, 2, 1), 3.5, device="cuda")
    n0 = (interp_cuda.launches, interp_cuda.chunk_launches)
    out = interp_cuda.interp_chunk_fwd_cuda(f, y, y, 64, "bicubic")
    torch.cuda.synchronize()
    assert (interp_cuda.launches, interp_cuda.chunk_launches) == (n0[0], n0[1] + 1)
    assert torch.equal(out, interp_cuda.interp_fwd_cuda(f, y, y, "bicubic"))
    n0 = (interp_cuda.bwd_launches, interp_cuda.chunk_bwd_launches)
    grads = interp_cuda.interp_chunk_bwd_cuda(f, y, y, y, 64, "bicubic")
    torch.cuda.synchronize()
    assert (interp_cuda.bwd_launches, interp_cuda.chunk_bwd_launches) == (n0[0], n0[1] + 1)
    unchunked = interp_cuda.interp_bwd_cuda(f, y, y, y, "bicubic")
    assert torch.equal(grads[1], unchunked[1]) and torch.equal(grads[2], unchunked[2])
    ok, err = _within(grads[0], unchunked[0], 2e-5, 1e-5)
    assert ok, err
    n0 = (interp_cuda.launches, interp_cuda.bwd_launches, interp_cuda.chunk_launches,
          interp_cuda.chunk_bwd_launches)
    wide = torch.zeros(1, 2, 65536, 1, device="cuda")
    with pytest.raises(RuntimeError, match="interp_chunk_fwd"):
        interp_cuda.interp_chunk_fwd_cuda(wide, y, y, 1, "bicubic")
    with pytest.raises(RuntimeError, match="interp_chunk_bwd"):
        interp_cuda.interp_chunk_bwd_cuda(wide, y, y, y, 1, "bicubic")
    with pytest.raises(RuntimeError, match="interp_bwd"):
        interp_cuda.interp_bwd_cuda(wide, y, y, y, "bicubic")
    assert (interp_cuda.launches, interp_cuda.bwd_launches, interp_cuda.chunk_launches,
            interp_cuda.chunk_bwd_launches) == n0


@pytest.mark.gpu
def test_band_kernels_refuse_a_row_that_does_not_fit():
    """The banded pair refuses what its shared kernels refuse, a field whose
    one row of one channel does not fit in shared memory (65536 fp32
    columns, 256 KB), and nothing else of the plan: it raises and counts no
    launch of any kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = 16, 65532
    spec = (8, 16, 2, 2, 0.5)  # rpb, band_rows, halo_lo, pad = (R - H) / 2, bound
    wide = torch.zeros(1, H + 4, W + 4, 1, device="cuda")
    y = torch.full((1, H, W, 1), 3.5, device="cuda")
    counts = lambda: (interp_cuda.launches, interp_cuda.bwd_launches,  # noqa: E731
                      interp_cuda.band_launches, interp_cuda.band_bwd_launches)
    n0 = counts()
    with pytest.raises(RuntimeError, match="interp_band_fwd"):
        interp_cuda.interp_band_fwd_cuda(wide, y, y, spec, "bicubic")
    with pytest.raises(RuntimeError, match="interp_band_bwd"):
        interp_cuda.interp_band_bwd_cuda(wide, y, y, y, spec, "bicubic")
    assert counts() == n0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 9, 15, 77), (1, 32, 64, 768)], ids=["tail", "bench"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_gen_kernels_match_plain_on_card(mode, shape):
    """The weight-generation kernels against their plain versions on
    positions over and beyond the padded grid, with a NaN and an inf
    (within chip_smoke.py's ``GEN_TOL``, 5e-6: the same ≤ 4 terms per axis,
    the cubic polynomials rounded with FMA on the card in intermediates up to
    6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.ops import interp_gen

    B, H, W, V = shape
    R, C = H + 4, W + 4
    rng = np.random.default_rng(21)
    py = rng.uniform(-3.0, R + 2.0, size=shape).astype(np.float32)
    px = rng.uniform(-3.0, C + 2.0, size=shape).astype(np.float32)
    py.reshape(-1)[0], px.reshape(-1)[1] = np.nan, np.inf
    y, x = torch.from_numpy(py).cuda(), torch.from_numpy(px).cuda()
    for kernel, plain, counter in ((interp_gen.gen_cuda, interp_gen.gen_plain, "gen_launches"),
                                   (interp_gen.bwd_gen_cuda, interp_gen.bwd_gen_plain,
                                    "bwd_gen_launches")):
        before = getattr(interp_gen, counter)
        out = kernel(y, x, R, C, mode)
        torch.cuda.synchronize()
        assert getattr(interp_gen, counter) == before + 1
        ref = plain(y, x, R, C, mode)
        assert torch.isfinite(out).all()
        assert float((out - ref).abs().max()) <= 5e-6


# |kernel − plain| / max |plain|, for unit-spread operands: the same float32
# products of identically rounded operands, summed in other orders (the
# kernels over (column, row) pairs, torch's matmul per row, then over rows),
# chip_smoke.py's ``MM_TOL``.
MM_TOL = 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(8, 1024), (32, 256), (128, 128), (5, 300)],
                         ids=["vb8", "vb32", "vb128", "vb5-pb300"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 77, 1000, 13, 22), (1, 16, 2048, 36, 68),
                                   (1, 133, 2048, 36, 68), (1, 16, 1000, 36, 68),
                                   (1, 16, 2047, 36, 68)],
                         ids=["tail", "bench-rows", "uneven-grid", "p-tail", "p-odd"])
def test_mm_kernels_match_plain_on_card(shape, cdt, blocks):
    """The contraction kernels (wx and its transposed layout) against their
    plain versions, where V is no multiple of the channel block and P no
    multiple of the position tile (the tail, mm's rows not 16-byte aligned),
    at the bench's R, C, P, with 133 planes (the persistent blocks get
    unequal counts of tiles), with P no multiple of the 128-position tile at
    the bench's C, and with P odd (mmT's rows of wxT not 16-byte aligned, so
    its tiles are copied by plain loads).  Both kernels run their own grid:
    each output is bitwise the same for every channel and position block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.ops import interp_mm

    B, V, P, R, C = shape
    vb, pb = blocks
    tdt = getattr(torch, cdt)
    rng = np.random.default_rng(31)
    wx = torch.from_numpy(rng.normal(size=(B, V, P, C)).astype(np.float32)).cuda()
    wxT = torch.from_numpy(rng.normal(size=(B, V, C, P)).astype(np.float32)).cuda()
    f = torch.from_numpy(rng.normal(size=(B, V, R, C)).astype(np.float32)).cuda()
    for kernel, plain, w, counter in ((interp_mm.mm_cuda, interp_mm.mm_plain, wx, "mm_launches"),
                                      (interp_mm.mmT_cuda, interp_mm.mmT_plain, wxT,
                                       "mmT_launches")):
        before = getattr(interp_mm, counter)
        out = kernel(w, f, tdt, vb, pb)
        torch.cuda.synchronize()
        assert getattr(interp_mm, counter) == before + 1
        ref = plain(w, f, tdt)
        assert out.shape == ref.shape == (B, V, P) and torch.isfinite(out).all()
        err = float((out - ref).abs().max()) / float(ref.abs().max())
        assert err <= MM_TOL, (kernel.__name__, err)
        assert torch.equal(out, kernel(w, f, tdt, 8, 1024)), kernel.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("field_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 77, 1000, 13, 22), (1, 16, 2048, 36, 68),
                                   (1, 133, 2048, 36, 68), (1, 16, 1000, 36, 68),
                                   (1, 16, 2047, 36, 68), (1, 8, 300, 45, 90)],
                         ids=["tail", "bench-rows", "uneven-grid", "p-tail", "p-odd", "groups"])
def test_bwd_mm_kernel_matches_plain_on_card(shape, field_dtype, cdt):
    """The dense-backward contraction kernel against its plain version
    (``MM_TOL`` of each output's largest value), run twice to the same bits
    (d_field is summed in one block a plane, in a fixed order, no atomics),
    and d_px equal to d_py up to float order (the stand-in weights' second
    half is half the first).  Also with 133 planes (no multiple of the
    blocks resident on the card), with P no multiple of the 16-position tile
    (1000, 2047) at the bench's R, C, and with R > 40 and C > 80 (the bf16
    kernel makes a pass over P for each group of d_field tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.ops import interp_mm

    B, V, P, R, C = shape
    rng = np.random.default_rng(32)
    field = torch.from_numpy(rng.normal(size=(B, V, R, C)).astype(np.float32)).cuda()
    field = field.to(getattr(torch, field_dtype))
    py, px, g = (torch.from_numpy(rng.uniform(lo, hi, size=(B, V, P)).astype(np.float32)).cuda()
                 for lo, hi in ((2.0, R - 3.0), (2.0, C - 3.0), (-1.0, 1.0)))
    tdt = getattr(torch, cdt)
    before = interp_mm.bwd_mm_launches
    outs = interp_mm.bwd_mm_cuda(field, py, px, g, tdt)
    again = interp_mm.bwd_mm_cuda(field, py, px, g, tdt)
    torch.cuda.synchronize()
    assert interp_mm.bwd_mm_launches == before + 2
    for name, o, a, r in zip(("d_field", "d_py", "d_px"), outs, again,
                             interp_mm.bwd_mm_plain(field, py, px, g, tdt)):
        assert o.dtype == torch.float32 and o.shape == r.shape and torch.isfinite(o).all()
        assert torch.equal(o, a), name
        err = float((o - r).abs().max()) / float(r.abs().max())
        assert err <= MM_TOL, (name, err)
    assert float((outs[1] - outs[2]).abs().max()) <= MM_TOL * float(outs[1].abs().max())
