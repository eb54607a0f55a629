"""Gather-interpolation at departure points: the plain PyTorch version.

Same function and channels-last contract as the TPU kernel's entry point
``paradis_tpu.ops.interp_pallas.grid_sample_interp_pallas``: field
``[B, R, C, V]``, positions ``[B, H, W, V]`` in pixel units of the field
(``align_corners`` semantics), output ``[B, H, W, V]`` in the field's dtype.

Semantics are the Pallas kernel's: a tap whose row or column lies outside
the field contributes zero (it is not index-clamped, as the JAX gather path
does), and a position that is not finite has no taps.  Bicubic is ATen's
cubic convolution with a = -0.75 (4×4 taps), bilinear has 2×2 taps.  Sums
run in float32: over the columns of a tap row first, then over the rows, the
order the CUDA kernel (``csrc/interp_fwd.cu``) uses.

``interp_bwd_plain`` is the backward: the gradients of the output with
respect to the field and to both positions, with the JAX package's derivative
convention (``paradis_tpu/ops/interp.py:_dense_kernel_derivative``): K′ is
zero at the bilinear kinks, where autograd of ``1 − t, t`` would give ∓1.

These versions serve the CPU (tests, CPU runs) and are what the CUDA kernels
(``csrc/interp_fwd.cu``, ``csrc/interp_bwd.cu``) are held against on the
card; the forecast and train paths on a card never call them.
"""

from __future__ import annotations

import torch

CUBIC_A = -0.75  # ATen's cubic convolution constant
MODES = ("bilinear", "bicubic")


def _cubic_weights(t: torch.Tensor):
    """Cubic convolution weights for taps at offsets (-1, 0, 1, 2) from floor."""
    a = CUBIC_A

    def near(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def far(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t)


def tap_weights(pos: torch.Tensor, mode: str):
    """``(floor(pos), offsets, weights)`` of the taps along one axis."""
    i0 = torch.floor(pos)
    t = pos - i0
    if mode == "bilinear":
        return i0, (0, 1), (1.0 - t, t)
    return i0, (-1, 0, 1, 2), _cubic_weights(t)


def kernel_derivative(dist: torch.Tensor, mode: str) -> torch.Tensor:
    """∂K(d)/∂d at signed pixel distances ``d = pos − tap``.

    ``sign(0) = 0`` and the open support ``|d| < 1`` make it zero at the
    bilinear kinks (d = 0 and |d| = 1), as in the JAX package; bicubic is C¹
    there, so the convention does not matter for it.
    """
    d = dist.abs()
    s = torch.sign(dist)
    if mode == "bilinear":
        return torch.where(d < 1.0, -s, 0.0)
    a = CUBIC_A
    near = (3.0 * (a + 2.0) * d - 2.0 * (a + 3.0)) * d
    far = (3.0 * a * d - 10.0 * a) * d + 8.0 * a
    return s * torch.where(d <= 1.0, near, torch.where(d < 2.0, far, 0.0))


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be bilinear|bicubic, got {mode!r}")


def _row_window(rows, R: int):
    """``(lo, hi)``: the rows a tap may lie in, ``[lo, hi)``, broadcastable to
    [B, H·W, V]; the whole field when ``rows`` is None."""
    return (0.0, float(R)) if rows is None else rows


def interp_plain(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                 mode: str = "bicubic", rows=None) -> torch.Tensor:
    """Sample ``field`` [B, R, C, V] at ``(pix_y, pix_x)`` [B, H, W, V].

    ``rows``, a pair of float tensors broadcastable to [B, H·W, V], restricts
    each position's taps to the rows ``[lo, hi)``; the row-banded version
    (``ops/interp_band.py``) passes its band there.
    """
    check_mode(mode)
    B, R, C, V = field.shape
    _, H, W, _ = pix_y.shape
    flat = field.float().reshape(B, R * C, V)
    py = pix_y.float().reshape(B, H * W, V)
    px = pix_x.float().reshape(B, H * W, V)
    y0, y_off, wy = tap_weights(py, mode)
    x0, x_off, wx = tap_weights(px, mode)
    lo, hi = _row_window(rows, R)

    acc = torch.zeros_like(py)
    for dy, w_row in zip(y_off, wy):
        r = y0 + dy
        r_ok = (r >= lo) & (r < hi)              # False for NaN positions too
        row = torch.zeros_like(py)
        for dx, w_col in zip(x_off, wx):
            c = x0 + dx
            ok = r_ok & (c >= 0) & (c <= C - 1)
            idx = torch.where(ok, r * C + c, 0.0).long()
            tap = torch.gather(flat, 1, idx)
            row = row + torch.where(ok, w_col * tap, 0.0)
        acc = acc + torch.where(r_ok, w_row * row, 0.0)
    return acc.reshape(B, H, W, V).to(field.dtype)


def interp_bwd_plain(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                     g: torch.Tensor, mode: str = "bicubic", rows=None):
    """Gradients of ``interp_plain`` for the output cotangent ``g`` [B, H, W, V].

    Returns ``(d_field, d_py, d_px)``:
    ``d_field[b,r,c,v] = Σ_p g·K(py−r)·K(px−c)`` in the field's dtype,
    ``d_py = g·Σ K′(py−r)·f·K(px−c)`` and ``d_px = g·Σ K(py−r)·f·K′(px−c)``
    in float32.  Written out tap by tap (not autograd of ``interp_plain``) so
    that K′ follows ``kernel_derivative``.  Taps outside the field and
    non-finite positions contribute to none of the three; sums are float32,
    over a tap row's columns first, then over rows.  ``rows`` as in
    ``interp_plain``.
    """
    check_mode(mode)
    B, R, C, V = field.shape
    _, H, W, _ = pix_y.shape
    flat = field.float().reshape(B, R * C, V)
    py = pix_y.float().reshape(B, H * W, V)
    px = pix_x.float().reshape(B, H * W, V)
    gf = g.float().reshape(B, H * W, V)
    y0, y_off, wy = tap_weights(py, mode)
    x0, x_off, wx = tap_weights(px, mode)
    ty, tx = py - y0, px - x0
    dwy = [kernel_derivative(ty - k, mode) for k in y_off]
    dwx = [kernel_derivative(tx - k, mode) for k in x_off]
    lo, hi = _row_window(rows, R)

    d_flat = torch.zeros_like(flat)
    acc_y = torch.zeros_like(py)
    acc_x = torch.zeros_like(py)
    for dy, w_row, dw_row in zip(y_off, wy, dwy):
        r = y0 + dy
        r_ok = (r >= lo) & (r < hi)              # False for NaN positions too
        row_w = torch.zeros_like(py)
        row_dw = torch.zeros_like(py)
        g_row = gf * w_row
        for dx, w_col, dw_col in zip(x_off, wx, dwx):
            c = x0 + dx
            ok = r_ok & (c >= 0) & (c <= C - 1)
            idx = torch.where(ok, r * C + c, 0.0).long()
            tap = torch.gather(flat, 1, idx)
            row_w = row_w + torch.where(ok, w_col * tap, 0.0)
            row_dw = row_dw + torch.where(ok, dw_col * tap, 0.0)
            d_flat.scatter_add_(1, idx, torch.where(ok, g_row * w_col, 0.0))
        acc_y = acc_y + torch.where(r_ok, dw_row * row_w, 0.0)
        acc_x = acc_x + torch.where(r_ok, w_row * row_dw, 0.0)
    d_field = d_flat.reshape(B, R, C, V).to(field.dtype)
    return (d_field, (gf * acc_y).reshape(B, H, W, V), (gf * acc_x).reshape(B, H, W, V))
