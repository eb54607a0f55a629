"""Weighted forecast losses: MSE, reversed Huber, AMSE (spectral).

Port of ``paradis_tpu/train/loss.py``.  Weights per output channel are the
configured variable weight times, on atmospheric channels, the pressure
weight ``max(p/1000, 0.2)`` of the channel's ``_h{level}`` suffix (flipped for
geopotential under ``flip_geopotential_weights``); latitude area weights
(unit mean) multiply along the grid's rows, except under ``amse``, whose
spectral loss (``train/amse.py``) takes the feature weights alone.  The
per-channel diagnostic stays pointwise (reversed Huber under ``amse``).  All
loss math runs in float32.  Inside ``sphere.partition.spatial_rules`` the fields
are a rank's block: a mean is the block's sum over the whole field's count,
summed over the spatial group, and the latitude weights are the whole
grid's, cut to the block's rows (never the block's own, which
``latitude_weights`` would renormalise).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from paradis_torch import resolve_device
from paradis_torch.sphere.geometry import latitude_weights
from paradis_torch.sphere.partition import spatial_grid, spatial_mean
from paradis_torch.train.amse import AMSELoss

_LEVEL_RE = re.compile(r"_h\d+$")


def strip_level(name: str) -> str:
    """'geopotential_h500' → 'geopotential'."""
    return _LEVEL_RE.sub("", name)


def pressure_weights(levels_hpa) -> np.ndarray:
    """``max(p/1000, 0.2)`` per level."""
    p = np.asarray(levels_hpa, np.float32) / 1000.0
    return np.where(p > 0.2, p, 0.2).astype(np.float32)


def build_variable_weights(cfg, output_name_order: list[str]) -> np.ndarray:
    """Per-output-channel variable weights from the config, in output order.

    Raises if an output feature has no configured weight.
    """
    table = {}
    table.update(cfg.training.variable_loss_weights.atmospheric)
    table.update(cfg.training.variable_loss_weights.surface)
    out = np.zeros(len(output_name_order), np.float32)
    for i, feat in enumerate(output_name_order):
        base = strip_level(feat)
        if base not in table:
            raise ValueError(f"No loss weight configured for output feature {feat!r} "
                             f"(base variable {base!r}).")
        out[i] = float(table[base])
    return out


def reversed_huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Smooth reversed Huber: linear for small errors, quadratic for large,
    blended by ``sigmoid(2 (|e| − δ))``."""
    error = pred - target
    abs_error = error.abs()
    small = delta * abs_error
    large = (error * error + delta * delta) / (2.0 * delta)
    w = 1.0 / (1.0 + torch.exp(-2.0 * (abs_error - delta)))
    return (1.0 - w) * small + w * large


@dataclass(frozen=True)
class WeightedLoss:
    """Feature- and latitude-weighted pointwise loss over [B, H, W, C] fields."""

    kind: str                          # "mse" | "reversed_huber" | "amse"
    feature_weights: torch.Tensor      # [C] float32
    lat_weights: torch.Tensor | None = None  # [H] float32, or None
    delta: float = 1.0
    amse: AMSELoss | None = None       # the spectral loss when kind == "amse"

    @classmethod
    def from_config(cls, cfg, lat_deg, output_name_order: list[str], kind: str | None = None,
                    nlon: int | None = None, device=None) -> "WeightedLoss":
        """Weights from the config for the output channels ``output_name_order``
        on a grid with latitudes ``lat_deg`` (and ``nlon`` longitudes, which
        the AMSE loss needs: ``2·(nlat − 1)`` when not given, as in the
        reference); tensors on ``device`` (``cuda`` unless given; raises when
        there is none)."""
        kind = kind or cfg.training.loss_function.type
        if kind not in ("mse", "reversed_huber", "amse"):
            raise ValueError(f"{kind} not supported, choose between [reversed_huber, mse, amse]")
        lcfg = cfg.training.loss_function
        levels = [float(lev) for lev in cfg.features.pressure_levels]

        var_w = build_variable_weights(cfg, output_name_order)
        fw = var_w.copy()
        if bool(lcfg.get("apply_pressure_weights", True)):
            pw = pressure_weights(levels)
            flip_geo = bool(lcfg.get("flip_geopotential_weights", False))
            level_pos = {lev: i for i, lev in enumerate(levels)}
            for i, feat in enumerate(output_name_order):
                m = _LEVEL_RE.search(feat)
                if m is None:
                    continue  # surface variable: variable weight only
                lev = float(m.group()[2:])
                if lev not in level_pos:
                    raise ValueError(f"output feature {feat!r} has level {lev} not in "
                                     f"configured pressure_levels {levels}")
                table = pw[::-1] if flip_geo and strip_level(feat) == "geopotential" else pw
                fw[i] = var_w[i] * table[level_pos[lev]]

        device = resolve_device(device)
        lat_arr = np.asarray(lat_deg, np.float64)
        lat_w = amse = None
        if lcfg.lat_weights and kind != "amse":
            lat_w = torch.tensor(latitude_weights(lat_arr), dtype=torch.float32, device=device)
        if kind == "amse":
            # the reference derives nlon as 2*(nlat-1), which only matches
            # pole-inclusive grids; the true longitude count where given
            nlat = len(lat_arr)
            includes_poles = (abs(lat_arr.min() + 90) < 1e-6 and abs(lat_arr.max() - 90) < 1e-6)
            amse = AMSELoss(nlat=nlat, nlon=int(nlon) if nlon else 2 * (nlat - 1),
                            includes_poles=includes_poles)
        return cls(kind=kind, feature_weights=torch.tensor(fw, device=device),
                   lat_weights=lat_w, delta=float(lcfg.delta_loss), amse=amse)

    def _pointwise(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred, target = pred.float(), target.float()
        if self.kind == "mse":
            d = pred - target
            return d * d
        return reversed_huber(pred, target, self.delta)

    def _weighted(self, loss: torch.Tensor) -> torch.Tensor:
        loss = loss * self.feature_weights
        if self.lat_weights is not None:
            lat_w = self.lat_weights
            grid = spatial_grid()
            if grid is not None:  # the whole grid's unit-mean weights, this block's rows
                lat_w = lat_w[grid.rows(len(lat_w))]
            loss = loss * lat_w[:, None, None]
        return loss

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Scalar weighted loss over ``[B, H, W, C]`` prediction and target
        (inside ``sphere.partition.spatial_rules`` a rank's block of them, and the
        whole field's loss, the same on every rank of the spatial group)."""
        if self.kind == "amse":
            return self.amse(pred, target, weights=self.feature_weights)
        return spatial_mean(self._weighted(self._pointwise(pred, target)))

    def per_channel(self, pred: torch.Tensor, target: torch.Tensor,
                    weighted: bool = True) -> torch.Tensor:
        """Per-output-channel diagnostic loss ``[C]``."""
        loss = self._pointwise(pred, target)
        if weighted:
            loss = self._weighted(loss)
        return spatial_mean(loss, dim=(0, 1, 2))
