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
from paradis_torch.ops.interp import check_mode, interp_gather
from paradis_torch.ops.interp_band import band_spec
from paradis_torch.ops.interp_chunk import chunk_rows as resolve_chunk_rows
from paradis_torch.ops.interp_cuda import interp
from paradis_torch.ops.interp_dense import interp_dense
from paradis_torch.sphere.geometry import rotated_to_latlon
from paradis_torch.sphere.padding import geocyclic_pad, geocyclic_pad_whole
from paradis_torch.sphere.partition import spatial_grid
from paradis_torch.utils.tracing import span

INTERP_IMPLS = ("auto", "plain", "xla", "gather")
# the JAX package's names of its kernel path: Paradis.set_interp_impl makes them auto
AUTO_ALIASES = ("pallas", "auto_train")


def enforce_pole_continuity(x: torch.Tensor) -> torch.Tensor:
    """Replace each pole row with its longitudinal mean (one value per channel).

    Inside ``sphere.partition.spatial_rules`` ``x`` is a rank's block: a polar
    block's pole row takes the mean of the whole row, its float32 sum over
    the space row over the whole width; other blocks are left as they are.
    """
    grid = spatial_grid()
    if grid is not None:
        return _pole_continuity_block(x, grid)
    W = x.shape[-2]
    south = x[..., :1, :, :].mean(dim=-2, keepdim=True).expand(*x.shape[:-3], 1, W, x.shape[-1])
    north = x[..., -1:, :, :].mean(dim=-2, keepdim=True).expand(*x.shape[:-3], 1, W, x.shape[-1])
    return torch.cat([south, x[..., 1:-1, :, :], north], dim=-3)


def _pole_continuity_block(x: torch.Tensor, grid) -> torch.Tensor:
    south, north = grid.l == 0, grid.l == grid.lat - 1
    if not (south or north):
        return x
    rows = ([x[..., :1, :, :]] if south else []) + ([x[..., -1:, :, :]] if north else [])
    width = x.shape[-2] * grid.space
    sums = grid.sum_row(torch.cat(rows, dim=-3).float().sum(dim=-2, keepdim=True))
    means = (sums / width).to(x.dtype).expand(*x.shape[:-3], len(rows), x.shape[-2],
                                             x.shape[-1])
    parts = [means[..., :1, :, :]] if south else []
    parts.append(x[..., int(south): x.shape[-3] - int(north), :, :])
    if north:
        parts.append(means[..., -1:, :, :])
    return torch.cat(parts, dim=-3)


def departure_pixel_coords(u, v, dt: float, lat_grid: torch.Tensor, lon_grid: torch.Tensor,
                           fast_trig: bool = False):
    """Departure points in pixel units of the *unpadded* grid.

    ``u``/``v`` are ``[B, H, W, V]`` latent velocities, ``lat_grid``/``lon_grid``
    ``[H, W]`` radians.  Returns float32 ``(pix_y, pix_x)`` shaped like ``u``.
    Inside ``sphere.partition.spatial_rules`` ``u``/``v`` are a rank's block and
    the grids whole: the points are the block's, in pixels of the whole grid
    (its extent and size).
    """
    H, W = lat_grid.shape
    lat_g, lon_g = lat_grid.float(), lon_grid.float()
    grid = spatial_grid()
    if grid is not None:  # the block's points; the extent and size stay the whole grid's
        rows, cols = grid.rows(H), grid.cols(W)
        lat_g, lon_g = lat_g[rows, cols], lon_g[rows, cols]
    lat_g = lat_g[None, :, :, None]
    lon_g = lon_g[None, :, :, None]
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
                shift: int = 0, row_pad: int | None = None):
    """Backend dispatch for the gather-interpolation, forward and backward.

    ``auto`` and ``plain`` go through the custom op ``paradis::interp``
    (``interp_cuda.interp``).  ``auto`` sends a tensor on the CPU to the plain
    versions and any other tensor to the hand-written kernels, which launch
    or raise: there is no fallback.  ``plain`` forces the plain forward and the plain backward on
    any device (the reference the kernels are held against).  ``xla`` is the
    JAX package's dense path (``compute.advection_impl: xla``): the dense
    contraction of ``paradis::interp_dense`` (``interp_dense.interp_dense``)
    on any device, which, as there, takes no band plan and no chunk size.
    ``gather`` is the JAX package's gather formulation
    (``interp.interp_gather``: taps index-clamped into the field, plain
    PyTorch with autograd on any device; there was no TPU kernel behind it),
    which takes no band plan and no chunk size either.

    ``shift`` moves the positions into the padded field (the model passes
    its pad).  ``max_dy_pix`` is part of the op's contract on every backend:
    when given, departure rows are clamped to ±``max_dy_pix`` of their
    arrival row (once, here; d_py is zero where the clamp binds).  Shift and
    clamp are the op ``paradis::departure_positions``, whose outputs are
    what the interpolation consumes.  The arrival rows are the positions'
    rows below the field's first ``row_pad`` rows (``(R - H) / 2`` unless
    given: a rank's block of the whole padded field passes its own, its
    first row's index in the field).  With ``row_pad`` given no band plan is
    made: the banded kernels find a position's band from its place in the
    positions, which a block's positions do not have; the unbanded (or
    chunked) kernels take the clamped positions, and on them give the
    banded pair's forward and ``d_py`` / ``d_px`` bitwise
    (``interp_band.py``).  Where the band plan
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
    banded = max_dy_pix is not None and row_pad is None
    if row_pad is None:
        row_pad = (R - H) // 2
    if shift or max_dy_pix is not None:
        pix_y, pix_x = departure_positions(pix_y, pix_x, shift, row_pad,
                                           None if max_dy_pix is None else float(max_dy_pix))
    if impl == "xla":
        return interp_dense(field, pix_y, pix_x, mode)
    if impl == "gather":
        return interp_gather(field, pix_y, pix_x, mode)
    spec = band_spec(H, W, R, mode, max_dy_pix) if banded else None
    rw = 0 if spec is not None else resolve_chunk_rows(R, chunk_rows)
    return interp(field, pix_y, pix_x, mode, impl == "plain", spec, rw)


class NeuralSemiLagrangian(nn.Module):
    """Learned semi-Lagrangian transport of the latent state.

    ``impl`` is ``auto``; ``Paradis.set_interp_impl`` switches it to
    ``xla`` or ``gather`` (``compute.advection_impl``, set by
    ``Paradis.from_config``) or to ``plain``, to hold the kernel path against
    the plain one on a card.
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
        """Inside ``sphere.partition.spatial_rules`` (``hidden``, ``u``, ``v`` a
        rank's block, the grids whole) departure points land anywhere, so
        the down-projected field is gathered over the spatial group, padded
        whole, and interpolated at the block's own points, as GSPMD does with
        the Pallas call, whose operands it replicates.  The gather's adjoint
        keeps the block of the field's cotangent summed over the ranks.  Along
        an axis that the grid has collapsed (``RankGrid.fit``) the block and
        the departure points span the whole extent, and the gather, the pole
        rows and the pad run over the other axis alone."""
        pad = 2 if self.interpolation == "bicubic" else 1
        with span("advection_proj"):
            proj = enforce_pole_continuity(self.down_projection(hidden))
        with span("departure"):
            pix_y, pix_x = departure_pixel_coords(u, v, dt, lat_grid, lon_grid,
                                                  fast_trig=self.fast_trig)
        grid = spatial_grid()
        if grid is None:
            field, row_pad = geocyclic_pad(proj, pad), None
        else:
            field = geocyclic_pad_whole(grid.gather(proj), pad)
            row_pad = pad + grid.rows(lat_grid.shape[0]).start
        with span("interpolation"):
            out = interpolate(field, pix_y, pix_x, self.interpolation, self.impl,
                              max_dy_pix=self.band_max_dy_pix, shift=pad, row_pad=row_pad)
        with span("advection_proj"):
            return self.up_projection(enforce_pole_continuity(out))
