"""Real spherical harmonic transform on equiangular lat-lon grids.

Port of ``paradis_tpu/ops/sht.py`` (the AMSE loss's transform): an rFFT over
longitude, then a quadrature-weighted associated-Legendre product over
latitude.  The Legendre tables are built in float64 with numpy by the same
code as the JAX package's and cast to float32, so both packages hold the same
bits; each device keeps its own copy, made once.

The Legendre table is real, so the product over latitude is one real float32
batched matmul over ``m`` whose columns are the real and imaginary parts of
the Fourier coefficients (no complex table, no doubled work).  It runs in
true float32 (TF32 off for it, forward and backward), as the JAX package asks
for ``precision="highest"``.

Conventions: orthonormal spherical harmonics, Condon–Shortley phase omitted
(irrelevant for power spectra), coefficients ``[..., l, m]`` complex with
``l ∈ [0, lmax)``, ``m ∈ [0, mmax)``, and exact zeros for ``m > l``.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch


def _legendre_table(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre P̄_l^m(x) for all l<lmax, m<mmax.

    Stable l-recursion in float64.  Returns ``[lmax, mmax, len(x)]`` with
    zeros for m > l.  Normalization: ∫ (P̄_l^m)² dx · π-factor such that the
    corresponding Y_lm are orthonormal on the sphere.
    """
    nx = len(x)
    out = np.zeros((lmax, mmax, nx), dtype=np.float64)
    sx = np.sqrt(np.clip(1.0 - x * x, 0.0, None))  # sin(theta)

    pmm = np.full(nx, np.sqrt(1.0 / (4.0 * np.pi)))  # P̄_0^0
    for m in range(min(lmax, mmax)):
        if m > 0:
            pmm = pmm * sx * np.sqrt((2.0 * m + 1.0) / (2.0 * m))
        out[m, m] = pmm
        if m + 1 < lmax:
            p_prev, p_curr = pmm, np.sqrt(2.0 * m + 3.0) * x * pmm
            out[m + 1, m] = p_curr
            for l in range(m + 2, lmax):
                a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
                b = np.sqrt(
                    ((2.0 * l + 1.0) * (l - 1.0 - m) * (l - 1.0 + m))
                    / ((2.0 * l - 3.0) * (l * l - m * m))
                )
                p_next = a * x * p_curr - b * p_prev
                out[l, m] = p_next
                p_prev, p_curr = p_curr, p_next
    return out


def _colat_quadrature(nlat: int, includes_poles: bool) -> tuple[np.ndarray, np.ndarray]:
    """(cos θ_j, quadrature weights) for an equiangular latitude ladder.

    Endpoint grids (poles included) use Clenshaw–Curtis weights; midpoint
    grids use Fejér-1 weights.  Both are exact for trigonometric polynomials
    up to the grid's bandwidth.  Weights integrate ∫ f(θ) sinθ dθ over [0, π].
    """
    if includes_poles:
        # θ_j = j π / (n-1), CC weights via the standard cosine-series formula
        n = nlat
        theta = np.arange(n) * np.pi / (n - 1)
        w = np.zeros(n)
        for j in range(n):
            s = 0.0
            kmax = (n - 1) // 2
            for k in range(1, kmax + 1):
                term = np.cos(2.0 * k * theta[j]) / (4.0 * k * k - 1.0)
                if 2 * k == n - 1:
                    term *= 0.5
                s += term
            w[j] = (2.0 / (n - 1)) * (1.0 - 2.0 * s)
        w[0] *= 0.5
        w[-1] *= 0.5
    else:
        # θ_j = (j + 1/2) π / n, Fejér-1 weights
        n = nlat
        theta = (np.arange(n) + 0.5) * np.pi / n
        w = np.zeros(n)
        for j in range(n):
            s = 0.0
            for k in range(1, n // 2 + 1):
                s += np.cos(2.0 * k * theta[j]) / (4.0 * k * k - 1.0)
            w[j] = (2.0 / n) * (1.0 - 2.0 * s)
    # data rows are ordered by *ascending latitude* = descending colatitude
    return np.cos(theta)[::-1].copy(), w[::-1].copy()


@lru_cache(maxsize=8)
def _analysis_matrix(nlat: int, lmax: int, mmax: int, includes_poles: bool) -> np.ndarray:
    """Quadrature-weighted Legendre analysis matrix ``[lmax, mmax, nlat]``."""
    x, w = _colat_quadrature(nlat, includes_poles)
    plm = _legendre_table(lmax, mmax, x)
    return (plm * w[None, None, :]).astype(np.float32)


@lru_cache(maxsize=8)
def _synthesis_matrix(nlat: int, lmax: int, mmax: int, includes_poles: bool) -> np.ndarray:
    """Legendre synthesis matrix ``[lmax, mmax, nlat]`` (no weights)."""
    x, _ = _colat_quadrature(nlat, includes_poles)
    return _legendre_table(lmax, mmax, x).astype(np.float32)


@lru_cache(maxsize=16)
def _device_table(kind: str, device: torch.device, nlat: int, lmax: int, mmax: int,
                  includes_poles: bool) -> torch.Tensor:
    """The table on ``device``, laid out for the product over ``m``:
    analysis ``[mmax, lmax, nlat]``, synthesis ``[mmax, nlat, lmax]``."""
    if kind == "analysis":
        mat = _analysis_matrix(nlat, lmax, mmax, includes_poles).transpose(1, 0, 2)
    else:
        mat = _synthesis_matrix(nlat, lmax, mmax, includes_poles).transpose(1, 2, 0)
    return torch.tensor(np.ascontiguousarray(mat), device=device)


@contextlib.contextmanager
def _true_fp32():
    """TF32 off for the matmuls of the block, and restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _LegendreProduct(torch.autograd.Function):
    """``table [M, A, B] @ x [M, B, K]`` in true float32, and its VJP in x."""

    @staticmethod
    def forward(ctx, table, x):
        ctx.save_for_backward(table)
        with _true_fp32():
            return torch.bmm(table, x)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        with _true_fp32():
            return None, torch.bmm(table.transpose(1, 2), g)


def _over_m(table: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``out[..., a, m, c] = Σ_b table[m, a, b] · z[..., b, m, c]`` for complex
    ``z``: one real batched matmul over m on its real and imaginary parts."""
    lead, (B, M, C) = z.shape[:-3], z.shape[-3:]
    # [N, B, M, C] complex -> [M, B, N·C·2] real
    zr = torch.view_as_real(z.reshape(-1, B, M, C)).permute(2, 1, 0, 3, 4).reshape(M, B, -1)
    out = _LegendreProduct.apply(table, zr)               # [M, A, N·C·2]
    A = table.shape[1]
    out = out.reshape(M, A, -1, C, 2).permute(2, 1, 0, 3, 4).contiguous()
    return torch.view_as_complex(out).reshape(*lead, A, M, C)


class RealSHT:
    """Forward/inverse real SHT over ``[..., nlat, nlon, C]`` fields.

    Latitude axis must be ordered pole-to-pole (either direction works for
    power spectra); longitude equally spaced over [0, 2π).
    """

    def __init__(self, nlat: int, nlon: int, lmax: int | None = None,
                 mmax: int | None = None, includes_poles: bool = False):
        self.nlat = nlat
        self.nlon = nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or min(self.lmax, nlon // 2 + 1)
        self.includes_poles = includes_poles

    def _table(self, kind: str, device: torch.device) -> torch.Tensor:
        return _device_table(kind, torch.device(device), self.nlat, self.lmax, self.mmax,
                             self.includes_poles)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., H, W, C]`` → complex64 coefficients ``[..., L, M, C]``."""
        xf = x.float()
        # forward Fourier in longitude: F_m(θ) = (2π / nlon) Σ_k f e^{-imφ_k}
        fm = torch.fft.rfft(xf, dim=-2) * (2.0 * math.pi / self.nlon)
        fm = fm[..., : self.mmax, :]
        return _over_m(self._table("analysis", x.device), fm)

    def synthesis(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Inverse: ``[..., L, M, C]`` complex → real ``[..., H, W, C]``."""
        fm = _over_m(self._table("synthesis", coeffs.device), coeffs)
        # Σ_l c_lm P̄_lm = F_m / (2π); irfft wants DFT coeffs G_m = (N/2π) F_m
        fm = fm * self.nlon
        return torch.fft.irfft(fm, n=self.nlon, dim=-2)

    __call__ = analysis
