"""AMSE spectral loss (Subich et al. 2025).

Port of ``paradis_tpu/train/amse.py``.  Adjusted MSE decomposes the error in
spherical-harmonic space into an amplitude term ``(√PSD_p − √PSD_t)²`` and a
decorrelation term ``2·max(PSD)·(1 − coherence)``: the transform in float32
(a bf16 prediction is cast first), the per-wavenumber PSD with the 2× fold
for m > 0, the top wavenumber dropped, coherence clipped to [0, 1] as
``jnp.clip`` does (``maximum`` then ``minimum``, so a tie passes half the
gradient to each side, as in JAX), and a NaN loss replaced by 1e6 on the
device, with no host sync.

Inside ``sphere.partition.spatial_rules`` (a rank's block of the fields) the
counterpart of the JAX package's ``constrain_spectral``: the blocks are
gathered over the spatial group and each rank transforms its share of the
channels (``RankGrid.spectral_share``: split over the spatial axes whose
sizes divide them, else the whole field on every rank); the shares' sums
are added over the group, each share counted once, so the loss and its
gradient are the one-process ones.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from paradis_torch.ops.sht import RealSHT
from paradis_torch.sphere.partition import spatial_grid

_EPS = 1e-7


@lru_cache(maxsize=8)
def _fold(mmax: int, device: torch.device) -> torch.Tensor:
    """``[1, 1, mmax, 1]``: 1 for m = 0, 2 for m > 0 (the negative-m mirror)."""
    fold = torch.full((mmax,), 2.0, device=device)
    fold[0] = 1.0
    return fold[None, None, :, None]


class AMSELoss:
    """Callable loss over channels-last fields ``[B, H, W, C]``."""

    def __init__(self, nlat: int, nlon: int, includes_poles: bool = False):
        self.sht = RealSHT(nlat=nlat, nlon=nlon, includes_poles=includes_poles)

    def _psd_and_cross(self, p_coef: torch.Tensor, t_coef: torch.Tensor):
        """PSD of each input and |cross-spectrum| per total wavenumber l.

        Coefficients: ``[B, L, M, C]`` complex.  Returns float32 ``[B, C, L']``
        with ``L' = L − 1`` (the top wavenumber is dropped).
        """
        fold = _fold(self.sht.mmax, p_coef.device)
        p2 = (p_coef.real.square() + p_coef.imag.square()) * fold
        t2 = (t_coef.real.square() + t_coef.imag.square()) * fold
        xs = torch.conj(p_coef) * t_coef * fold

        psd_p = p2.sum(dim=2)  # [B, L, C]
        psd_t = t2.sum(dim=2)
        cross = xs.sum(dim=2).abs()

        def fmt(a):
            return a.movedim(1, 2)[..., :-1].float()

        return fmt(psd_p) + _EPS, fmt(psd_t) + _EPS, fmt(cross)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
        grid = spatial_grid()
        pred, target = pred.float(), target.float()
        channels, holders = pred.shape[-1], 1
        if grid is not None:
            # the transform needs whole rows and columns: the blocks gathered,
            # this rank's share of the channels kept (constrain_spectral)
            ways, index = grid.spectral_share(channels)
            share = slice(index * channels // ways, (index + 1) * channels // ways)
            pred, target = grid.gather(pred)[..., share], grid.gather(target)[..., share]
            weights = None if weights is None else weights[share]
            holders = grid.spatial // ways
        p_coef = self.sht.analysis(pred)
        t_coef = self.sht.analysis(target)

        psd_p, psd_t, cross = self._psd_and_cross(p_coef, t_coef)

        ratio = cross / (torch.sqrt(psd_p * psd_t + _EPS) + _EPS)
        coherence = torch.minimum(torch.maximum(ratio, ratio.new_zeros(())), ratio.new_ones(()))

        amplitude = (torch.sqrt(psd_p) - torch.sqrt(psd_t)).square()
        decorrelation = 2.0 * torch.maximum(psd_p, psd_t) * (1.0 - coherence)
        per_channel = (amplitude + decorrelation).mean(dim=-1)  # [B, C]

        if weights is not None:
            per_channel = per_channel * weights[None, :]
        if grid is None:
            loss = per_channel.mean()
        else:  # each share once: the group's sum counts it on each of its holders
            loss = grid.sum_replicated(
                per_channel.sum() / (per_channel.shape[0] * channels * holders))
        return torch.where(torch.isnan(loss), loss.new_full((), 1e6), loss)
