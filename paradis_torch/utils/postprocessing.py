"""Forecast postprocessing: Cartesian↔spherical winds, batch denormalization.

The port's own copy of ``paradis_tpu/utils/postprocessing.py``.  The model
state carries 3-D Cartesian wind components to avoid pole discontinuities;
forecasts convert back to spherical (u, v, ω) with the
hydrostatic ``ω = -w_r · p g / (R T)`` relation (reference
``utils/postprocessing.py:13-216``).  Host-side numpy.
"""

from __future__ import annotations

import re

import numpy as np

from paradis_torch.utils.normalization import (
    denormalize_humidity_np,
    denormalize_precipitation_np,
    denormalize_standard,
)

G0 = 9.80616
R_DRY = 287.05

_LEVEL_RE = re.compile(r"_h\d+$")


def spherical_wind_3d(wind_x, wind_y, wind_z, temperature, level_pa, lat_rad, lon_rad):
    """Cartesian (x, y, z) winds → spherical (u, v, ω) at one pressure level.

    ``level_pa`` is the pressure in Pa (scalar or broadcastable).  Matches
    reference ``compute_spherical_wind`` (utils/postprocessing.py:74-122).
    """
    sin_lat, cos_lat = np.sin(lat_rad), np.cos(lat_rad)
    sin_lon, cos_lon = np.sin(lon_rad), np.cos(lon_rad)
    u = -wind_x * sin_lon + wind_y * cos_lon
    v = -wind_x * sin_lat * cos_lon - wind_y * sin_lat * sin_lon + wind_z * cos_lat
    w = (
        -wind_x * cos_lat * cos_lon - wind_y * cos_lat * sin_lon - wind_z * sin_lat
    ) * (level_pa * G0 / (R_DRY * temperature))
    return u, v, w


def spherical_wind_10m(wind_x, wind_y, wind_z, lat_rad, lon_rad):
    """Surface Cartesian winds → (u10, v10); vertical motion assumed zero."""
    sin_lat, cos_lat = np.sin(lat_rad), np.cos(lat_rad)
    sin_lon, cos_lon = np.sin(lon_rad), np.cos(lon_rad)
    u = -wind_x * sin_lon + wind_y * cos_lon
    v = -wind_x * sin_lat * cos_lon - wind_y * sin_lat * sin_lon + wind_z * cos_lat
    return u, v


def feature_indices(base_name: str, features: list[str]) -> np.ndarray:
    """Indices of all levels of a variable in a feature list."""
    return np.asarray(
        [i for i, f in enumerate(features) if _LEVEL_RE.sub("", f) == base_name],
        np.int64,
    )


def convert_cartesian_to_spherical_winds(lat_deg, lon_deg, pressure_levels_hpa,
                                         array: np.ndarray, features: list[str]) -> None:
    """In-place wind conversion over ``array[..., F, H, W]``.

    Feature axis is third-from-last; spatial last two (the forecast-writer
    layout).  Mirrors reference utils/postprocessing.py:143-187.
    """
    latg, long_ = np.meshgrid(np.deg2rad(np.asarray(lat_deg)),
                              np.deg2rad(np.asarray(lon_deg)), indexing="ij")
    levels_pa = np.asarray(pressure_levels_hpa, np.float64) * 100.0

    t_idx = feature_indices("temperature", features)
    u_idx = feature_indices("wind_x", features)
    v_idx = feature_indices("wind_y", features)
    w_idx = feature_indices("wind_z", features)

    temperature = array[..., t_idx, :, :]
    u, v, w = spherical_wind_3d(
        array[..., u_idx, :, :], array[..., v_idx, :, :], array[..., w_idx, :, :],
        temperature, levels_pa[:, None, None], latg, long_,
    )
    array[..., u_idx, :, :] = u
    array[..., v_idx, :, :] = v
    array[..., w_idx, :, :] = w

    u10_idx = feature_indices("wind_x_10m", features)
    v10_idx = feature_indices("wind_y_10m", features)
    w10_idx = feature_indices("wind_z_10m", features)
    if len(u10_idx):
        u10, v10 = spherical_wind_10m(
            array[..., u10_idx, :, :], array[..., v10_idx, :, :],
            array[..., w10_idx, :, :], latg, long_,
        )
        array[..., u10_idx, :, :] = u10
        array[..., v10_idx, :, :] = v10


def denormalize_forecast(array: np.ndarray, dataset) -> np.ndarray:
    """Invert the training normalizations over ``array[..., F, H, W]``.

    ``dataset`` provides the normalization index groups and statistics
    (reference utils/postprocessing.py:190-216).
    """
    if dataset.custom_normalization:
        if len(dataset.norm_precip_out):
            array[..., dataset.norm_precip_out, :, :] = denormalize_precipitation_np(
                array[..., dataset.norm_precip_out, :, :])
        if len(dataset.norm_humidity_out):
            array[..., dataset.norm_humidity_out, :, :] = denormalize_humidity_np(
                array[..., dataset.norm_humidity_out, :, :],
                dataset.q_min, dataset.q_max)
    mean = dataset.output_mean.reshape(-1, 1, 1)
    std = dataset.output_std.reshape(-1, 1, 1)
    array[..., dataset.norm_zscore_out, :, :] = denormalize_standard(
        array[..., dataset.norm_zscore_out, :, :], mean, std)
    return array
