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
from paradis_torch.ops.interp_band import band_spec
from paradis_torch.ops.interp_chunk import chunk_rows as resolve_chunk_rows
from paradis_torch.ops.interp_cuda import interp
from paradis_torch.ops.interp_dense import interp_dense
from paradis_torch.sphere.geometry import rotated_to_latlon
from paradis_torch.sphere.padding import geocyclic_pad

INTERP_IMPLS = ("auto", "plain", "xla")


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


def _row_bounds(pix_y: torch.Tensor, row_pad: int, max_dy: float):
    """``(lo, hi)`` [1, H, 1, 1]: each arrival row in the padded field ±
    ``max_dy`` pixels."""
    H = pix_y.shape[1]
    arr = torch.arange(H, dtype=torch.float32, device=pix_y.device).view(1, H, 1, 1) + row_pad
    return arr - max_dy, arr + max_dy


def _clamp_rows(pix_y: torch.Tensor, row_pad: int, max_dy: float) -> torch.Tensor:
    return torch.clamp(pix_y, *_row_bounds(pix_y, row_pad, max_dy))


@torch.library.custom_op("paradis::departure_positions", mutates_args=())
def departure_positions(pix_y: torch.Tensor, pix_x: torch.Tensor, shift: int, row_pad: int,
                        max_dy: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The interpolation's positions, float32: both shifted by ``shift``
    pixels into the padded field, and with ``max_dy`` the rows clamped to
    their arrival row (``row_pad`` + its index) ± ``max_dy``.  Its own op so
    that ``remat_policy: advect_pos`` can save what the interpolation
    consumes."""
    pix_y = pix_y.float() + shift
    pix_x = pix_x.float() + shift
    if max_dy is not None:
        pix_y = _clamp_rows(pix_y, row_pad, max_dy)
    return pix_y, pix_x


@departure_positions.register_fake
def _positions_fake(pix_y, pix_x, shift, row_pad, max_dy):
    return (pix_y.new_empty(pix_y.shape, dtype=torch.float32),
            pix_x.new_empty(pix_x.shape, dtype=torch.float32))


def _positions_setup(ctx, inputs, output):
    pix_y, _, shift, row_pad, max_dy = inputs
    ctx.args = (shift, row_pad, max_dy)
    ctx.save_for_backward(pix_y if max_dy is not None else None)


def _positions_backward(ctx, d_py, d_px):
    """d_py zero where the clamp binds (``torch.clamp``'s gradient, on the
    shifted rows before the clamp), else passed through, as is d_px."""
    shift, row_pad, max_dy = ctx.args
    if max_dy is not None:
        (pix_y,) = ctx.saved_tensors
        pix_y = pix_y.float() + shift
        lo, hi = _row_bounds(pix_y, row_pad, max_dy)
        d_py = torch.where((pix_y >= lo) & (pix_y <= hi), d_py, 0.0)
    return d_py, d_px, None, None, None


departure_positions.register_autograd(_positions_backward, setup_context=_positions_setup)


def interpolate(field, pix_y, pix_x, mode: str, impl: str = "auto",
                max_dy_pix: float | None = None, chunk_rows: int | None = None,
                shift: int = 0):
    """Backend dispatch for the gather-interpolation, forward and backward.

    ``auto`` and ``plain`` go through the custom op ``paradis::interp``
    (``interp_cuda.interp``).  ``auto`` sends a tensor on the CPU to the plain
    versions and any other tensor to the hand-written kernels, which launch
    or raise: there is no fallback.  ``plain`` forces the plain forward and the plain backward on
    any device (the reference the kernels are held against).  ``xla`` is the
    JAX package's dense path (``compute.advection_impl: xla``): the dense
    contraction of ``paradis::interp_dense`` (``interp_dense.interp_dense``)
    on any device, which, as there, takes no band plan and no chunk size.

    ``shift`` moves the positions into the padded field (the model passes
    its pad).  ``max_dy_pix`` is part of the op's contract on every backend:
    when given, departure rows are clamped to ±``max_dy_pix`` of their
    arrival row (once, here; d_py is zero where the clamp binds).  Shift and
    clamp are the op ``paradis::departure_positions``, whose outputs are
    what the interpolation consumes.  Where the band plan
    (``interp_band.band_spec``) then finds banding worth it, the pairing runs
    the row-banded kernels (or their plain versions).  Without a band plan,
    a chunk size (``chunk_rows``, else ``PARADIS_INTERP_CHUNK``, read on every
    call as the JAX package reads it at each trace; ``interp_chunk.chunk_rows``)
    selects the row-chunked kernels, and 0 the unbanded ones.
    """
    check_mode(mode)
    if impl not in INTERP_IMPLS:
        raise ValueError(f"advection impl must be one of {INTERP_IMPLS}, got {impl!r}")
    _, H, W, _ = pix_y.shape
    R = field.shape[1]
    if shift or max_dy_pix is not None:
        pix_y, pix_x = departure_positions(pix_y, pix_x, shift, (R - H) // 2,
                                           None if max_dy_pix is None else float(max_dy_pix))
    if impl == "xla":
        return interp_dense(field, pix_y, pix_x, mode)
    spec = None if max_dy_pix is None else band_spec(H, W, R, mode, max_dy_pix)
    rw = 0 if spec is not None else resolve_chunk_rows(R, chunk_rows)
    return interp(field, pix_y, pix_x, mode, impl == "plain", spec, rw)


class NeuralSemiLagrangian(nn.Module):
    """Learned semi-Lagrangian transport of the latent state.

    ``impl`` is ``auto``; ``Paradis.set_interp_impl`` switches it to
    ``xla`` (``compute.advection_impl: xla``, set by ``Paradis.from_config``)
    or to ``plain``, to hold the kernel path against the plain one on a card.
    ``band_max_dy_pix`` bounds the departure rows in pixels
    (``compute.interp_band_rad``, converted by the model), which licenses the
    row-banded kernels; None leaves the rows free.
    """

    def __init__(self, hidden_dim: int, num_vels: int, mesh_size: tuple[int, int], *,
                 down_layers=("SepConv",), down_hidden=0, up_layers=("CLinear",),
                 up_hidden=0, interpolation: str = "bicubic", fast_trig: bool = False,
                 band_max_dy_pix: float | None = None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        check_mode(interpolation)
        self.interpolation = interpolation
        self.band_max_dy_pix = band_max_dy_pix
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
        out = interpolate(geocyclic_pad(proj, pad), pix_y, pix_x, self.interpolation,
                          self.impl, max_dy_pix=self.band_max_dy_pix, shift=pad)
        return self.up_projection(enforce_pole_continuity(out))
