"""Geocyclic padding for equiangular lat-lon grids (spherical boundary).

Port of ``paradis_tpu/sphere/padding.py``: rows adjacent to each pole are
rolled by 180° in longitude and mirrored across the pole, and the longitude
axis wraps periodically.  Fields are channels-last ``[..., lat, lon, channel]``.

Inside ``sphere.partition.spatial_rules`` a field is this rank's block of the
whole, and :func:`geocyclic_pad` returns the block of the whole field's pad
(what GSPMD's halo exchanges give the JAX package), bitwise: the latitude
halos come from the blocks above and below, the pole mirror from the polar
blocks' rows across the space row (the 180° roll moves columns between
ranks), and the longitude halos from the periodic ring of the row-padded
blocks, taken after the rows as below, so the corners come out right.
Along an axis that the grid has collapsed (``RankGrid.fit``: the grid has
one rank along it and the block its whole extent) the longitude wraps, or
the pole rows mirror, within the block.
"""

from __future__ import annotations

import torch

from paradis_torch.sphere.partition import RankGrid, spatial_grid


def geocyclic_pad_whole(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad a whole ``[..., H, W, C]`` field by ``pad`` on both spherical
    boundaries, whatever the enclosing grid.

    Requires an even number of longitudes.  Returns ``[..., H + 2*pad,
    W + 2*pad, C]``.
    """
    if pad == 0:
        return x
    if x.ndim < 3:
        raise ValueError(f"geocyclic_pad expects [..., lat, lon, channel], got {tuple(x.shape)}")
    H, W = x.shape[-3], x.shape[-2]
    if W % 2 != 0:
        raise ValueError(f"Number of longitudes must be even, got {W}")
    if pad + 1 > H:
        raise ValueError(f"pad={pad} too large for nlat={H}")

    half = W // 2
    # mirror rows across each pole with a 180° longitude roll
    top = torch.roll(x[..., 1 : pad + 1, :, :], half, dims=-2)
    bottom = torch.roll(x[..., -(pad + 1) : -1, :, :], half, dims=-2)
    x = torch.cat([torch.flip(top, dims=(-3,)), x, torch.flip(bottom, dims=(-3,))], dim=-3)
    # periodic longitude wrap
    return torch.cat([x[..., :, -pad:, :], x, x[..., :, :pad, :]], dim=-2)


def geocyclic_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad a ``[..., H, W, C]`` field by ``pad`` on both spherical boundaries
    (:func:`geocyclic_pad_whole`); inside ``spatial_rules``, ``x`` is this
    rank's block and the result is its block of the whole field's pad."""
    grid = spatial_grid()
    if grid is None or pad == 0:
        return geocyclic_pad_whole(x, pad)
    return _sharded_pad(x, pad, grid)


def _sharded_pad(x: torch.Tensor, pad: int, grid: RankGrid) -> torch.Tensor:
    """The block ``[..., h + 2·pad, w + 2·pad, C]`` of the whole field's pad,
    from two gathers: every block's first and last ``pad + 1`` rows over the
    spatial group, then the row-padded blocks' edge columns over the space
    row.  Needs ``pad + 1 ≤ h`` (a polar block holds the mirrored rows) and
    ``pad ≤ w``."""
    if x.ndim < 3:
        raise ValueError(f"geocyclic_pad expects [..., lat, lon, channel], got {tuple(x.shape)}")
    h, w = x.shape[-3], x.shape[-2]
    W = w * grid.space
    if W % 2 != 0:
        raise ValueError(f"Number of longitudes must be even, got {W}")
    if pad + 1 > h or pad > w:
        raise ValueError(
            f"pad={pad} does not fit a block of {h} latitudes and {w} longitudes: the "
            f"sharded geocyclic pad needs pad + 1 <= H/lat_devices and pad <= "
            f"W/spatial_devices")
    half = W // 2
    lat, l, s = grid.lat, grid.l, grid.s
    # [lat, space, 2, ..., pad + 1, w, C]: each block's first and last pad + 1 rows
    edges = grid.gather_blocks(torch.stack([x[..., : pad + 1, :, :],
                                            x[..., h - pad - 1 :, :, :]]))

    def mirror(side: int, rows: slice) -> torch.Tensor:
        """The polar strip's rows, whole in longitude, rolled by 180° and
        flipped across the pole; this rank's columns of it."""
        pole = 0 if side == 0 else lat - 1
        strip = torch.cat([edges[pole, j, side] for j in range(grid.space)], dim=-2)
        rolled = torch.roll(strip[..., rows, :, :], half, dims=-2)
        return torch.flip(rolled, dims=(-3,))[..., :, s * w : (s + 1) * w, :]

    top = edges[l - 1, s, 1][..., 1:, :, :] if l > 0 else mirror(0, slice(1, pad + 1))
    bottom = edges[l + 1, s, 0][..., :pad, :, :] if l < lat - 1 else mirror(1, slice(0, pad))
    x = torch.cat([top, x, bottom], dim=-3)
    # [space, 2, ..., h + 2·pad, pad, C]: each row-padded block's edge columns
    sides = grid.gather_row(torch.stack([x[..., :, :pad, :], x[..., :, w - pad :, :]]))
    left = sides[(s - 1) % grid.space, 1]
    right = sides[(s + 1) % grid.space, 0]
    return torch.cat([left, x, right], dim=-2)
