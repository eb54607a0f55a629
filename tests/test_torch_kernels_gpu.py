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
