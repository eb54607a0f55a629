"""Row-banded gather-interpolation: the band plan and the plain versions.

Port of the banding arithmetic of ``paradis_tpu/ops/interp_pallas.py``
(``_band_spec``, ``_band_starts``) and of the function its banded kernels
(``_fwd_kernel_banded``, ``_bwd_kernel_banded``) compute.  When departure
rows are clamped to ±``max_dy_pix`` of their arrival row (``interpolate``
clamps), every tap of the positions of ``rpb`` consecutive arrival rows lies
in a static band of ``band_rows`` padded field rows.  A position's band is
fixed by its arrival row ``p // W``, never by ``pix_y``; taps outside the
band are dropped, as the Pallas kernels contract over the band's rows only.
Under the clamp no tap lies outside, so the banded function equals the
unbanded function of the clamped positions.

The plan is ``(rpb, band_rows, halo_lo, pad, m_pix)``: bands of ``rpb``
arrival rows, band ``b`` seeing the padded rows from
``clip(b·rpb + pad − halo_lo, 0, R − band_rows)`` on.  The CUDA entry points
(``csrc/interp_band_fwd.cu``, ``csrc/interp_band_bwd.cu``) take the unbanded
field and this plan, and launch the unbanded path's window forward and
row-slab backward with a per-position band filter, the same rows as
``band_rows_window``: they keep the banded function on any positions, and on
clamped ones equal the unbanded kernels (the forward, d_py and d_px
bitwise).  The plain versions here serve the CPU and are what the kernels
are held against on the card.
"""

from __future__ import annotations

import math
import os

import torch

from paradis_torch.ops.interp import interp_bwd_plain, interp_plain

BAND_RPB = 8  # arrival rows per band


def band_spec(H: int, W: int, R: int, mode: str, max_dy_pix: float | None):
    """The banding plan, or None where there is no bound, where
    ``PARADIS_INTERP_BAND`` is ``0``, or where banding does not pay (a band of
    more than half the padded rows; ``PARADIS_INTERP_BAND=1`` passes that
    gate, not the band's fit in the rows).  The environment is read on every
    call.  ``band_rows`` is rounded up to a multiple of 8, as the Pallas plan
    aligns it, and the gate reads the rounded value."""
    if max_dy_pix is None:
        return None
    env = os.environ.get("PARADIS_INTERP_BAND")
    if env == "0":
        return None
    rpb = BAND_RPB
    while rpb > 1 and H % rpb:
        rpb //= 2
    m = int(math.ceil(float(max_dy_pix)))
    lo, hi = (1, 2) if mode == "bicubic" else (0, 1)
    band_rows = -(-(rpb + 2 * m + lo + hi) // 8) * 8
    if (band_rows * 2 > R and env != "1") or band_rows > R:
        return None
    return (rpb, band_rows, m + lo, (R - H) // 2, float(max_dy_pix))


def band_starts(spec, R: int) -> list[int]:
    """First padded row of each band."""
    rpb, band_rows, halo_lo, pad, _ = spec
    H = R - 2 * pad
    return [min(max(b * rpb + pad - halo_lo, 0), R - band_rows) for b in range(-(-H // rpb))]


def band_rows_window(spec, R: int, H: int, W: int, device=None):
    """``(lo, hi)`` [1, H·W, 1] float: the rows of each position's band."""
    rpb, band_rows, _, _, _ = spec
    starts = torch.tensor(band_starts(spec, R), dtype=torch.float32, device=device)
    lo = starts.repeat_interleave(rpb * W)[: H * W].view(1, H * W, 1)
    return lo, lo + band_rows


def interp_band_plain(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                      spec, mode: str = "bicubic") -> torch.Tensor:
    """``interp_plain`` with each position's taps restricted to its band:
    field [B, R, C, V], clamped positions [B, H, W, V] → [B, H, W, V]."""
    _, R, _, _ = field.shape
    _, H, W, _ = pix_y.shape
    return interp_plain(field, pix_y, pix_x, mode,
                        rows=band_rows_window(spec, R, H, W, field.device))


def interp_band_bwd_plain(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                          g: torch.Tensor, spec, mode: str = "bicubic"):
    """``interp_bwd_plain`` with each position's taps restricted to its band:
    ``(d_field, d_py, d_px)`` as there."""
    _, R, _, _ = field.shape
    _, H, W, _ = pix_y.shape
    return interp_bwd_plain(field, pix_y, pix_x, g, mode,
                            rows=band_rows_window(spec, R, H, W, field.device))
