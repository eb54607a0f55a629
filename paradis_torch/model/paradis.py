"""The PARADIS model: a latent advection–diffusion–reaction integrator.

Port of ``paradis_tpu/model/paradis.py``:
  input projection → static encoder → downsample → N × physics layer →
  periodic upsample + skip → output projection,
where each physics layer is velocity net → semi-Lagrangian advection (gated
by a learned per-channel ``alpha_adv``) → diffusion → reaction(hidden ⊕ static).

The physics layers are a plain Python loop over ``layers`` (an
``nn.ModuleList``); the JAX package's stacked ``[L, ...]`` parameter tree is
unstacked by the weight bridge (``model/weights.py``).  Mixed precision:
float32 parameters, compute in ``dtype``, float32 for ChannelNorm, GlobalBias
and the ``alpha_adv`` sigmoid.  The model serves the forecast path and
trains (``train/step.py``): gradients flow through every block, and through
the interpolation by its backward kernel on a card.  ``band_bound_rad``
(``compute.interp_band_rad``) bounds the departure rows and so licenses the
row-banded interpolation kernels.  ``gradient_checkpointing`` recomputes
each physics layer in the backward, all of it under ``remat_policy: none``;
``advect`` keeps the interpolation's output and ``advect_pos`` also its
departure positions (the JAX package's policies, as a selective-checkpoint
policy over the custom ops of ``ops/interp_cuda.py``, ``ops/interp_dense.py``
and ``ops/advection.py``).  Spatial sharding constraints are not ported.
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from paradis_torch import resolve_device
from paradis_torch.ops.advection import INTERP_IMPLS, NeuralSemiLagrangian
from paradis_torch.ops.blocks import GMBlock, PhysicalDownsample, SepConv, _Depthwise, get_activation
from paradis_torch.ops.resize import periodic_upsample
from paradis_torch.sphere.geometry import lonlat_grids
from paradis_torch.sphere.padding import geocyclic_pad

EARTH_ROTATION_RATE = 7.29212e-5  # rad/s
STATIC_DIM = 128  # static-encoder output width


def get_scaled_timestep(dt_seconds: float) -> float:
    """Nondimensionalize the data timestep by the Earth rotation rate."""
    return dt_seconds * EARTH_ROTATION_RATE


def check_remat_policy(name) -> None:
    """``compute.remat_policy`` under gradient checkpointing: ``none`` (full
    recomputation of each physics layer), ``advect`` or ``advect_pos``."""
    if name not in ("", "none", None, "advect", "advect_pos"):
        raise ValueError(f"compute.remat_policy must be none|advect|advect_pos, got {name!r}")


def _saved_ops(name) -> frozenset:
    """The ops whose outputs a policy keeps through the recomputation: under
    ``advect`` the interpolation's (the gather pair's forward, or the dense
    path's), under ``advect_pos`` also the departure positions that the
    interpolation consumes (the JAX package's names ``advect_interp`` and
    ``advect_pos``)."""
    ops = torch.ops.paradis
    if name == "advect":
        return frozenset((ops.interp.default, ops.interp_dense.default))
    if name == "advect_pos":
        return _saved_ops("advect") | {ops.departure_positions.default}
    return frozenset()


def _save_policy(saved: frozenset, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn(name):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for a
    ``compute.remat_policy``: none recomputes everything; ``advect`` and
    ``advect_pos`` save ``_saved_ops``' outputs and recompute the rest."""
    check_remat_policy(name)
    saved = _saved_ops(name)
    if not saved:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_policy, saved))


def band_bound_pixels(band_bound_rad, lat_deg, coarsening_factor: int = 1):
    """The departure-row bound in pixels of the (coarse) latitude spacing for
    a bound of ``band_bound_rad`` radians; None when unset or undefined."""
    if not band_bound_rad:
        return None
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))[::coarsening_factor]
    if len(lat) < 2:
        return None
    spacing = (lat.max() - lat.min()) / (len(lat) - 1)
    if spacing <= 0:
        return None
    return float(band_bound_rad) / float(spacing)


class PhysicsLayer(nn.Module):
    """One ADR step: transport → mixing → forcing."""

    def __init__(self, hidden_dim: int, num_vels: int, mesh_size: tuple[int, int],
                 dt: float, n_static_hidden: int, *, bias_channels: int = 8,
                 bias_rank: int = 128, activation: str = "SiLU",
                 interpolation: str = "bicubic", fast_trig: bool = False,
                 band_max_dy_pix: float | None = None,
                 velocity_layers=("CLinear", "SepConv"),
                 velocity_hidden=384, diffusion_layers=("SepConv",), diffusion_hidden=0,
                 reaction_layers=("CLinear",) * 4, reaction_hidden=896,
                 adv_down_layers=("SepConv",), adv_down_hidden=0,
                 adv_up_layers=("CLinear",), adv_up_hidden=0,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator):
        super().__init__()
        self.num_vels = num_vels
        self.dt = dt
        common = dict(mesh_size=mesh_size, bias_channels=bias_channels, bias_rank=bias_rank,
                      activation_fn=activation, pre_normalize=True, dtype=dtype,
                      generator=generator)
        # creation order follows the flax module's call order
        self.velocity_net = GMBlock(velocity_layers, hidden_dim, 2 * num_vels,
                                    hidden_dim=velocity_hidden, **common)
        self.alpha_adv = nn.Parameter(torch.full((hidden_dim,), -1.0))
        self.advection = NeuralSemiLagrangian(
            hidden_dim, num_vels, mesh_size, down_layers=adv_down_layers,
            down_hidden=adv_down_hidden, up_layers=adv_up_layers, up_hidden=adv_up_hidden,
            interpolation=interpolation, fast_trig=fast_trig, band_max_dy_pix=band_max_dy_pix,
            dtype=dtype, generator=generator)
        self.diffusion = GMBlock(diffusion_layers, hidden_dim, hidden_dim,
                                 hidden_dim=diffusion_hidden, **common)
        self.reaction = GMBlock(reaction_layers, hidden_dim + n_static_hidden, hidden_dim,
                                hidden_dim=reaction_hidden, **common)

    def forward(self, hidden, hidden_static, lat_grid, lon_grid):
        velocities = self.velocity_net(hidden)
        u = velocities[..., : self.num_vels]
        v = velocities[..., self.num_vels :]
        g_adv = torch.sigmoid(self.alpha_adv).to(hidden.dtype)
        advected = self.advection(hidden, u, v, self.dt, lat_grid, lon_grid)
        hidden = hidden + g_adv * (advected - hidden)
        hidden = hidden + self.diffusion(hidden)
        reac_in = torch.cat([hidden, hidden_static], dim=-1)
        return hidden + self.reaction(reac_in)


class Paradis(nn.Module):
    """Full PARADIS forward model over ``[B, nlat, nlon, C_in]`` fields."""

    def __init__(self, input_dim: int, output_dim: int, n_static: int, lat_deg, lon_deg, *,
                 hidden_dim: int = 1024, num_vels: int = 768, num_layers: int = 8,
                 base_dt: float = 21600.0, bias_channels: int = 8, bias_rank: int = 128,
                 activation: str = "SiLU", interpolation: str = "bicubic",
                 fast_trig: bool = False, band_bound_rad: float | None = None,
                 coarsening_factor: int = 1, gradient_checkpointing: bool = False,
                 remat_policy: str = "none", input_layers=("CLinear",), input_hidden=0,
                 output_layers=("CLinear",) * 3, output_hidden=768,
                 velocity_layers=("CLinear", "SepConv"), velocity_hidden=384,
                 diffusion_layers=("SepConv",), diffusion_hidden=0,
                 reaction_layers=("CLinear",) * 4, reaction_hidden=896,
                 adv_down_layers=("SepConv",), adv_down_hidden=0,
                 adv_up_layers=("CLinear",), adv_up_hidden=0,
                 dtype: torch.dtype = torch.float32, seed: int = 0, device=None):
        """Build and initialise from ``seed`` (a ``torch.Generator`` on the
        CPU, so a seed gives the same weights on every device), then move to
        ``device`` (``cuda`` unless given; raises when there is none)."""
        super().__init__()
        if gradient_checkpointing:
            check_remat_policy(remat_policy)
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.n_static = n_static
        self.dtype = dtype
        self.gradient_checkpointing = gradient_checkpointing
        self.remat_policy = remat_policy
        self._remat_override = remat_policy  # the last policy resolve_remat_policy saw
        self.band_max_dy_pix = band_bound_pixels(band_bound_rad, lat_deg, coarsening_factor)
        self.mesh_size = (len(lat_deg), len(lon_deg))
        H, W = self.mesh_size
        s = coarsening_factor
        self.mesh_size_coarse = ((H - 1) // s + 1, W // s)
        self.dt = get_scaled_timestep(base_dt) / num_layers

        lat = np.deg2rad(np.asarray(lat_deg, np.float64))[::s]
        lon = np.deg2rad(np.asarray(lon_deg, np.float64))[::s]
        lat_grid, lon_grid = lonlat_grids(lat, lon)
        self.register_buffer("lat_grid", torch.tensor(lat_grid, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("lon_grid", torch.tensor(lon_grid, dtype=torch.float32),
                             persistent=False)

        # creation order follows the flax module's call order
        self.input_proj = GMBlock(input_layers, input_dim, hidden_dim, (H, W),
                                  hidden_dim=input_hidden, activation=True,
                                  activation_fn=activation, dtype=dtype, generator=gen)
        self.static_sepconv1 = SepConv(n_static, 64, kernel_size=7, init_mode="torch_default",
                                       dtype=dtype, generator=gen)
        self.static_depthwise = _Depthwise(7, 64, bound=1.0 / 7.0, use_bias=True,
                                           dtype=dtype, generator=gen)
        self.static_sepconv2 = SepConv(64, STATIC_DIM, kernel_size=5, init_mode="torch_default",
                                       dtype=dtype, generator=gen)
        self.downsample = PhysicalDownsample(stride=coarsening_factor)
        self.layers = nn.ModuleList(
            PhysicsLayer(hidden_dim, num_vels, self.mesh_size_coarse, self.dt, STATIC_DIM,
                         bias_channels=bias_channels, bias_rank=bias_rank,
                         activation=activation, interpolation=interpolation,
                         fast_trig=fast_trig, band_max_dy_pix=self.band_max_dy_pix,
                         velocity_layers=velocity_layers, velocity_hidden=velocity_hidden,
                         diffusion_layers=diffusion_layers, diffusion_hidden=diffusion_hidden,
                         reaction_layers=reaction_layers, reaction_hidden=reaction_hidden,
                         adv_down_layers=adv_down_layers, adv_down_hidden=adv_down_hidden,
                         adv_up_layers=adv_up_layers, adv_up_hidden=adv_up_hidden,
                         dtype=dtype, generator=gen)
            for _ in range(max(1, num_layers)))
        self.output_proj = GMBlock(output_layers, hidden_dim, output_dim, (H, W),
                                   hidden_dim=output_hidden, activation=False,
                                   activation_fn=activation, pre_normalize=True,
                                   bias_channels=bias_channels, bias_rank=bias_rank,
                                   dtype=dtype, generator=gen)
        self.to(device)

    @classmethod
    def from_config(cls, cfg, *, input_dim: int, output_dim: int, lat_deg, lon_deg,
                    dtype: torch.dtype | None = None, seed: int | None = None,
                    device=None) -> "Paradis":
        """Build from a Config (the schema of ``configs/default.yaml``).

        ``dtype`` defaults to bfloat16 under ``compute.use_amp`` and float32
        otherwise; ``seed`` to ``init.seed``.  ``compute.advection_impl`` is
        ``auto`` (the kernels on a card, the plain versions on the CPU) or
        ``xla`` (the dense contraction of ``ops/interp_dense.py`` in every
        layer).  Raises on a setting the port cannot honour yet.
        """
        pb = cfg.model.physblock
        compute = cfg.compute
        impl = compute.get("advection_impl", "auto")
        if impl not in ("auto", "xla"):
            raise ValueError(f"compute.advection_impl={impl!r}: paradis_torch takes 'auto' "
                             f"(the kernel on a card, the plain version on the CPU) or 'xla' "
                             f"(the dense contraction)")
        if dtype is None:
            dtype = torch.bfloat16 if compute.use_amp else torch.float32
        if seed is None:
            seed = int(cfg.get_path("init.seed", 0) or 0)
        model = cls(
            input_dim=input_dim,
            output_dim=output_dim,
            n_static=len(cfg.features.input.constants),
            lat_deg=[float(v) for v in np.asarray(lat_deg)],
            lon_deg=[float(v) for v in np.asarray(lon_deg)],
            hidden_dim=cfg.model.latent_size,
            num_vels=cfg.model.velocity_vectors,
            num_layers=max(1, cfg.model.num_layers),
            base_dt=float(cfg.model.base_dt),
            bias_channels=cfg.model.get("bias_channels", 4),
            bias_rank=cfg.model.get("bias_rank", 128),
            activation=cfg.model.activation,
            interpolation=cfg.model.adv_interpolation,
            fast_trig=bool(compute.get("fast_departure_trig", False)),
            band_bound_rad=compute.get("interp_band_rad", None) or None,
            coarsening_factor=cfg.model.get("coarsening_factor", 1),
            gradient_checkpointing=bool(compute.get("gradient_checkpointing", False)),
            remat_policy=str(compute.get("remat_policy", "none") or "none"),
            input_layers=tuple(pb.input_proj.layers),
            input_hidden=pb.input_proj.hidden_dim,
            output_layers=tuple(pb.output_proj.layers),
            output_hidden=pb.output_proj.hidden_dim,
            velocity_layers=tuple(pb.velocity_net.layers),
            velocity_hidden=pb.velocity_net.hidden_dim,
            diffusion_layers=tuple(pb.diffusion.layers),
            diffusion_hidden=pb.diffusion.hidden_dim,
            reaction_layers=tuple(pb.reaction.layers),
            reaction_hidden=pb.reaction.hidden_dim,
            adv_down_layers=tuple(pb.advection.down_projection.layers),
            adv_down_hidden=pb.advection.down_projection.hidden_dim,
            adv_up_layers=tuple(pb.advection.up_projection.layers),
            adv_up_hidden=pb.advection.up_projection.hidden_dim,
            dtype=dtype,
            seed=seed,
            device=device,
        )
        model.set_interp_impl(impl)
        return model

    @property
    def device(self) -> torch.device:
        return self.lat_grid.device

    def set_interp_impl(self, impl: str) -> None:
        """Route every layer's interpolation through ``impl`` (auto | plain | xla)."""
        if impl not in INTERP_IMPLS:
            raise ValueError(f"advection impl must be one of {INTERP_IMPLS}, got {impl!r}")
        for layer in self.layers:
            layer.advection.impl = impl

    def resolve_remat_policy(self) -> str:
        """The policy in force: ``PARADIS_REMAT_POLICY`` where set, else
        ``compute.remat_policy``, read at every checkpointed forward as the
        JAX package reads it at every trace, with a logged warning where the
        environment overrides the config (once for each new override)."""
        name = os.environ.get("PARADIS_REMAT_POLICY", self.remat_policy)
        check_remat_policy(name)
        if name != self.remat_policy and name != self._remat_override:
            logging.getLogger(__name__).warning(
                "PARADIS_REMAT_POLICY=%s overrides compute.remat_policy=%s",
                name, self.remat_policy)
        self._remat_override = name
        return name

    def _static_encoder(self, x: torch.Tensor) -> torch.Tensor:
        """SepConv(64, k7) → SiLU → geo-pad(3) + depthwise 7×7 → SiLU →
        SepConv(STATIC_DIM, k5), all with torch-default init."""
        act = get_activation("SiLU")
        x = act(self.static_sepconv1(x))
        x = act(self.static_depthwise(geocyclic_pad(x, 3)))
        return self.static_sepconv2(x)

    def forward(self, fields: torch.Tensor) -> torch.Tensor:
        H, W = self.mesh_size
        if fields.shape[-3] != H or fields.shape[-2] != W:
            raise ValueError(f"expected spatial dims {(H, W)}, got {tuple(fields.shape[-3:-1])}")
        fields = fields.to(self.dtype)
        hidden = self.input_proj(fields)
        hidden_static = self._static_encoder(fields[..., -self.n_static :])
        skip = hidden
        hidden = self.downsample(hidden)
        hidden_static = self.downsample(hidden_static)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        if remat:
            context_fn = remat_context_fn(self.resolve_remat_policy())
        for layer in self.layers:
            if remat:
                hidden = checkpoint(layer, hidden, hidden_static, self.lat_grid, self.lon_grid,
                                    use_reentrant=False, context_fn=context_fn)
            else:
                hidden = layer(hidden, hidden_static, self.lat_grid, self.lon_grid)
        hidden = periodic_upsample(hidden, H, W) + skip
        return self.output_proj(hidden)
