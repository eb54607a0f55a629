"""Neural semi-Lagrangian advection on the sphere (the PARADIS signature op).

Port of ``paradis_tpu/ops/advection.py``.  Per layer:
  1. down-project the latent state to ``num_vels`` channels,
  2. enforce pole continuity (pole rows become their longitudinal mean),
  3. compute departure points: the learned (u, v) are displacements in a
     per-point rotated spherical frame, mapped back to geographic lat/lon and
     then to pixel coordinates (float32),
  4. geocyclic-pad and gather-interpolate at the departure points,
  5. pole-fix again and up-project back to the latent width.
"""

from __future__ import annotations

import torch
from torch import nn

from paradis_torch.ops.blocks import GMBlock
from paradis_torch.ops.interp import check_mode
from paradis_torch.ops.interp_cuda import Interp
from paradis_torch.sphere.geometry import rotated_to_latlon
from paradis_torch.sphere.padding import geocyclic_pad

INTERP_IMPLS = ("auto", "plain")


def enforce_pole_continuity(x: torch.Tensor) -> torch.Tensor:
    """Replace each pole row with its longitudinal mean (one value per channel)."""
    W = x.shape[-2]
    south = x[..., :1, :, :].mean(dim=-2, keepdim=True).expand(*x.shape[:-3], 1, W, x.shape[-1])
    north = x[..., -1:, :, :].mean(dim=-2, keepdim=True).expand(*x.shape[:-3], 1, W, x.shape[-1])
    return torch.cat([south, x[..., 1:-1, :, :], north], dim=-3)


def departure_pixel_coords(u, v, dt: float, lat_grid: torch.Tensor, lon_grid: torch.Tensor,
                           fast_trig: bool = False):
    """Departure points in pixel units of the *unpadded* grid.

    ``u``/``v`` are ``[B, H, W, V]`` latent velocities, ``lat_grid``/``lon_grid``
    ``[H, W]`` radians.  Returns float32 ``(pix_y, pix_x)`` shaped like ``u``.
    """
    H, W = lat_grid.shape
    lat_g = lat_grid.float()[None, :, :, None]
    lon_g = lon_grid.float()[None, :, :, None]
    lon_prime = -u.float() * dt
    lat_prime = -v.float() * dt
    lat_dep, lon_dep = rotated_to_latlon(lat_prime, lon_prime, lat_g, lon_g,
                                         small_displacement=fast_trig)
    min_lat, max_lat = lat_grid.float().min(), lat_grid.float().max()
    min_lon, max_lon = lon_grid.float().min(), lon_grid.float().max()
    pix_x = (lon_dep - min_lon) / (max_lon - min_lon) * (W - 1.0)
    pix_y = (lat_dep - min_lat) / (max_lat - min_lat) * (H - 1.0)
    return pix_y, pix_x


def interpolate(field, pix_y, pix_x, mode: str, impl: str = "auto",
                max_dy_pix: float | None = None):
    """Backend dispatch for the gather-interpolation, forward and backward.

    Every backend goes through the autograd pairing ``interp_cuda.Interp``.
    ``auto`` sends a tensor on the CPU to the plain versions and any other
    tensor to the hand-written kernels, which launch or raise: there is no
    fallback.  ``plain`` forces the plain forward and the plain backward on
    any device (the reference the kernels are held against).

    ``max_dy_pix`` is part of the op's contract on every backend: when given,
    departure rows are clamped to ±``max_dy_pix`` of their arrival row.
    """
    check_mode(mode)
    if impl not in INTERP_IMPLS:
        raise ValueError(f"advection impl must be one of {INTERP_IMPLS}, got {impl!r}")
    if max_dy_pix is not None:
        H = pix_y.shape[1]
        pad = (field.shape[1] - H) // 2
        arr = torch.arange(H, dtype=torch.float32, device=pix_y.device).view(1, H, 1, 1) + pad
        pix_y = torch.clamp(pix_y.float(), arr - max_dy_pix, arr + max_dy_pix)
    return Interp.apply(field, pix_y, pix_x, mode, impl == "plain")


class NeuralSemiLagrangian(nn.Module):
    """Learned semi-Lagrangian transport of the latent state.

    ``impl`` is ``auto``; only ``Paradis.set_interp_impl`` switches it to
    ``plain``, to hold the kernel path against the plain one on a card.
    """

    def __init__(self, hidden_dim: int, num_vels: int, mesh_size: tuple[int, int], *,
                 down_layers=("SepConv",), down_hidden=0, up_layers=("CLinear",),
                 up_hidden=0, interpolation: str = "bicubic", fast_trig: bool = False,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator):
        super().__init__()
        check_mode(interpolation)
        self.interpolation = interpolation
        self.impl = "auto"
        self.fast_trig = fast_trig
        self.down_projection = GMBlock(down_layers, hidden_dim, num_vels, mesh_size,
                                       hidden_dim=down_hidden, dtype=dtype, generator=generator)
        self.up_projection = GMBlock(up_layers, num_vels, hidden_dim, mesh_size,
                                     hidden_dim=up_hidden, dtype=dtype, generator=generator)

    def forward(self, hidden, u, v, dt: float, lat_grid, lon_grid):
        pad = 2 if self.interpolation == "bicubic" else 1
        proj = enforce_pole_continuity(self.down_projection(hidden))
        pix_y, pix_x = departure_pixel_coords(u, v, dt, lat_grid, lon_grid,
                                              fast_trig=self.fast_trig)
        out = interpolate(geocyclic_pad(proj, pad), pix_y + pad, pix_x + pad,
                          self.interpolation, self.impl)
        return self.up_projection(enforce_pole_continuity(out))
