"""Spherical geometry: grids, rotated-coordinate transform, area weights.

Port of ``paradis_tpu/sphere/geometry.py``.  Grid construction and area
weights are numpy (float64, host-side); the departure-point transform works on
float32 tensors.  ``torch.remainder`` and ``torch.atan2`` follow the sign
conventions of ``jnp.remainder`` and ``jnp.arctan2``, so the 2π longitude
wrap lands on the same side in both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# displacement bound for the fast-trig path, radians: ≈6 grid cells at
# 5.625°, far beyond any physical semi-Lagrangian displacement
FAST_TRIG_MAX_RAD = 0.6
EARTH_RADIUS_KM = 6371.0


def lonlat_grids(lat_rad: np.ndarray, lon_rad: np.ndarray):
    """Return 2-D ``(lat_grid, lon_grid)`` meshes (ij indexing) in radians."""
    return np.meshgrid(np.asarray(lat_rad), np.asarray(lon_rad), indexing="ij")


def _sin_small(x: torch.Tensor) -> torch.Tensor:
    """sin(x) for |x| ≤ 0.6 rad: degree-7 Taylor, below fp32 roundoff."""
    x2 = x * x
    return x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0 - x2 / 5040.0)))


def _cos_small(x: torch.Tensor) -> torch.Tensor:
    """cos(x) for |x| ≤ 0.6 rad: degree-8 Taylor."""
    x2 = x * x
    return 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 + x2 * (-1.0 / 720.0 + x2 / 40320.0)))


def rotated_to_latlon(lat_prime, lon_prime, lat_p, lon_p,
                      small_displacement: bool = False):
    """Map local rotated coordinates back to geographic lat/lon (radians).

    ``(lat_prime, lon_prime)`` is the displacement in the rotated frame of the
    grid point ``(lat_p, lon_p)``.  ``small_displacement=True`` clamps the
    displacements to ±``FAST_TRIG_MAX_RAD`` and evaluates their sin/cos with
    short Taylor polynomials (the default, ``compute.fast_departure_trig``).
    """
    if small_displacement:
        m = FAST_TRIG_MAX_RAD
        lat_prime = torch.clamp(lat_prime, -m, m)
        lon_prime = torch.clamp(lon_prime, -m, m)
        sin_lat_t, cos_lat_t = _sin_small(lat_prime), _cos_small(lat_prime)
        sin_lon_t, cos_lon_t = _sin_small(lon_prime), _cos_small(lon_prime)
    else:
        sin_lat_t, cos_lat_t = torch.sin(lat_prime), torch.cos(lat_prime)
        sin_lon_t, cos_lon_t = torch.sin(lon_prime), torch.cos(lon_prime)
    sin_lat_0 = torch.sin(lat_p)
    cos_lat_0 = torch.cos(lat_p)

    sin_lat = sin_lat_t * cos_lat_0 + cos_lat_t * cos_lon_t * sin_lat_0
    lat = torch.asin(torch.clamp(sin_lat, -1.0 + 1e-7, 1.0 - 1e-7))

    num = cos_lat_t * sin_lon_t
    den = cos_lat_t * cos_lon_t * cos_lat_0 - sin_lat_t * sin_lat_0
    lon = lon_p + torch.atan2(num, den)
    lon = torch.remainder(lon + 2.0 * math.pi, 2.0 * math.pi)
    return lat, lon


def latitude_weights(lat_deg: np.ndarray) -> np.ndarray:
    """GraphCast-consistent unit-mean latitude area weights (float64 math).

    Uniform latitude vectors that include the poles (interior ∝
    cos(lat)·sin(Δ/2), poles ∝ sin²(Δ/4)) or exclude them (∝ cos(lat)).
    """
    lat = np.asarray(lat_deg, dtype=np.float64)
    if lat.ndim != 1:
        raise ValueError(f"latitude vector must be 1-D, got shape {lat.shape}")
    d = np.diff(lat)
    if not np.allclose(d, d[0], rtol=0.0, atol=1e-6):
        raise ValueError("Latitude grid is not uniformly spaced.")
    delta = abs(float(d[0]))
    lat_min, lat_max = float(lat.min()), float(lat.max())

    has_poles = abs(lat_min + 90.0) <= 1e-6 and abs(lat_max - 90.0) <= 1e-6
    if has_poles:
        lat_rad = np.deg2rad(lat)
        delta_rad = np.deg2rad(delta)
        w = np.cos(lat_rad) * np.sin(delta_rad / 2.0)
        pole_w = np.sin(delta_rad / 4.0) ** 2
        w[np.argmin(lat)] = pole_w
        w[np.argmax(lat)] = pole_w
    else:
        exp_max, exp_min = 90.0 - delta / 2.0, -90.0 + delta / 2.0
        if not (abs(lat_max - exp_max) <= 1e-6 and abs(lat_min - exp_min) <= 1e-6):
            raise ValueError(
                f"Latitude vector must end at ±(90 - Δ/2); got "
                f"min={lat_min}, max={lat_max}, Δ={delta}."
            )
        w = np.cos(np.deg2rad(lat))
    return (w / w.mean()).astype(np.asarray(lat_deg).dtype)


def normalized_inverse_lon_spacing(lat_rad: np.ndarray, lon_rad: np.ndarray) -> np.ndarray:
    """Z-scored inverse east-west grid spacing as a 2-D static feature.

    The dataset's ``lon_spacing`` constant, as
    ``paradis_tpu/sphere/geometry.py:124`` computes it (float64 numpy; the
    reference's cos² in the arcsin argument and its ``ddof=1`` std).
    """
    lat_grid, _ = lonlat_grids(lat_rad, lon_rad)
    dlon = float(np.diff(np.asarray(lon_rad))[0])
    inv = 1.0 / (
        2.0 * np.arcsin(np.cos(lat_grid) ** 2 * np.sin(dlon / 2.0)) * EARTH_RADIUS_KM
    )
    return (inv - inv.mean()) / inv.std(ddof=1)


def equiangular_lat_lon(nlat: int, nlon: int, include_poles: bool = True):
    """Equiangular grid in degrees (ascending lat, lon in [0, 360)).

    ``include_poles=False`` gives the WeatherBench-2 offset grid
    (-90 + Δ/2 … 90 - Δ/2), ``True`` the [-90, 90] inclusive ladder.
    """
    lon = np.arange(nlon) * (360.0 / nlon)
    if include_poles:
        lat = np.linspace(-90.0, 90.0, nlat)
    else:
        delta = 180.0 / nlat
        lat = -90.0 + delta / 2.0 + delta * np.arange(nlat)
    return lat, lon
