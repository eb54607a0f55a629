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
    atomics' order, one bf16 ulp for a bf16 result), and the autograd pairing
    with a band plan launches each banded kernel once and no unbanded one."""
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

    before = interp_cuda.band_bwd_launches
    grads = interp_cuda.interp_band_bwd_cuda(f, y, x, g, spec, mode)
    torch.cuda.synchronize()
    assert interp_cuda.band_bwd_launches == before + 1
    assert grads[0].dtype == f.dtype and grads[1].dtype == grads[2].dtype == torch.float32
    tols = ((2e-5, rel), (3e-5, 1e-5), (3e-5, 1e-5))
    for ref in (interp_band_bwd_plain(f, y, x, g, spec, mode),
                interp_cuda.interp_bwd_cuda(f, y, x, g, mode)):
        for name, o, r, tol in zip(("d_field", "d_py", "d_px"), grads, ref, tols):
            ok, err = _within(o, r, *tol)
            assert ok, (name, err)

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


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random-rw8", "departure-rw8", "tail-rw8", "tail-rw32",
                                  "departure-rw16"])
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
    shape = (1, 13, 22, 77, 9, 15) if kind == "tail" else (1, 36, 68, 77, 32, 64)
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


@pytest.mark.gpu
def test_chunk_kernels_refuse_a_chunk_that_does_not_fit():
    """A chunk of one channel larger than the card's shared memory raises
    (and counts no launch); it does not run the unchunked kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.zeros(1, 64, 4096, 1, device="cuda")
    y = torch.full((1, 2, 2, 1), 3.5, device="cuda")
    n0 = (interp_cuda.launches, interp_cuda.chunk_launches, interp_cuda.chunk_bwd_launches)
    with pytest.raises(RuntimeError, match="interp_chunk_fwd"):
        interp_cuda.interp_chunk_fwd_cuda(f, y, y, 64, "bicubic")
    with pytest.raises(RuntimeError, match="interp_chunk_bwd"):
        interp_cuda.interp_chunk_bwd_cuda(f, y, y, y, 64, "bicubic")
    assert (interp_cuda.launches, interp_cuda.chunk_launches,
            interp_cuda.chunk_bwd_launches) == n0


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
@pytest.mark.parametrize("shape", [(1, 77, 1000, 13, 22), (1, 16, 2048, 36, 68)],
                         ids=["tail", "bench-rows"])
def test_mm_kernels_match_plain_on_card(shape, cdt, blocks):
    """The contraction kernels (wx and its transposed layout) against their
    plain versions, where V is no multiple of the channel block and P no
    multiple of the position tile (the tail), and at the bench's R, C, P."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("field_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 77, 1000, 13, 22), (1, 16, 2048, 36, 68)],
                         ids=["tail", "bench-rows"])
def test_bwd_mm_kernel_matches_plain_on_card(shape, field_dtype, cdt):
    """The dense-backward contraction kernel against its plain version
    (``MM_TOL`` of each output's largest value), run twice to the same bits
    (d_field is summed in one block's shared memory, no atomics), and d_px
    equal to d_py up to float order (the stand-in weights' second half is
    half the first)."""
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
