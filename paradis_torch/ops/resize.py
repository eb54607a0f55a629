"""Separable align-corners bilinear resize as two small matmuls.

Port of ``paradis_tpu/ops/resize.py``: the reference's
``F.interpolate(mode="bilinear", align_corners=True)`` as precomputed 1-D
interpolation matrices contracted over each spatial axis (channels-last).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from paradis_torch.sphere.partition import RankGrid, spatial_grid, spatial_rules


@lru_cache(maxsize=64)
def linear_interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic ``[n_out, n_in]`` matrix for align-corners linear interp."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / max(n_out - 1, 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    frac = pos - lo
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    mat[np.arange(n_out), lo] = 1.0 - frac
    mat[np.arange(n_out), lo + 1] = frac
    return mat.astype(np.float32)


def bilinear_resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize ``[..., H, W, C]`` to ``[..., out_h, out_w, C]``."""
    H, W = x.shape[-3], x.shape[-2]
    if H == out_h and W == out_w:
        return x
    wy = torch.tensor(linear_interp_matrix(H, out_h), dtype=x.dtype, device=x.device)
    wx = torch.tensor(linear_interp_matrix(W, out_w), dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,...hwc->...owc", wy, x)
    return torch.einsum("ow,...hwc->...hoc", wx, y)


def periodic_upsample(x: torch.Tensor, out_h: int, out_w: int,
                      source: RankGrid | None = None) -> torch.Tensor:
    """Longitude-periodic upsample: append the first longitude column so the
    interpolation sees the 0°/360° wrap, resize to ``(out_h, out_w + 1)`` and
    drop the duplicated endpoint.  The identity when the shapes already match.

    Inside ``sphere.partition.spatial_rules`` ``x`` is a rank's block of the
    coarse field on ``source`` (the grid that fits the coarse field,
    ``RankGrid.fit``; the enclosing grid when None) and the result its block
    of the ``(out_h, out_w)`` field on the enclosing grid: the identity where
    the whole fields' shapes match, else the coarse field gathered over
    ``source``'s group, resized whole and cut to the block.
    """
    grid = spatial_grid()
    if grid is not None:
        source = grid if source is None else source
        if (x.shape[-3] * source.lat, x.shape[-2] * source.space) == (out_h, out_w):
            return x
        with spatial_rules(None):
            whole = periodic_upsample(source.gather(x), out_h, out_w)
        return grid.block(whole)
    if x.shape[-3] == out_h and x.shape[-2] == out_w:
        return x
    x_ext = torch.cat([x, x[..., :, :1, :]], dim=-2)
    return bilinear_resize_align_corners(x_ext, out_h, out_w + 1)[..., :, :-1, :]
