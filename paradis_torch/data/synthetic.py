"""Synthetic WB2-shaped raw store generator (test fixture + demo data).

The port's own copy of ``paradis_tpu/data/synthetic.py``: the same seed
writes the same store, byte for byte.

Builds a small ERA5-like zarr store with the variables/dims the preprocessor
expects (the shape of the WeatherBench-2 archive the reference downloads,
``scripts/download_dataset.sh:1-31``): smooth band-limited random fields with
plausible physical magnitudes, so normalization and wind conversion behave
like on real data.
"""

from __future__ import annotations

import argparse

import numpy as np

from paradis_torch.data import zarrlite

SURFACE_VARS = {
    "10m_u_component_of_wind": (0.0, 6.0),
    "10m_v_component_of_wind": (0.0, 5.0),
    "2m_temperature": (285.0, 15.0),
    "mean_sea_level_pressure": (101325.0, 1200.0),
    "total_precipitation_6hr": (5e-4, 5e-4),
}

ATMO_VARS = {
    "u_component_of_wind": (5.0, 12.0),
    "v_component_of_wind": (0.0, 8.0),
    "vertical_velocity": (0.0, 0.2),
    "temperature": (250.0, 25.0),
    "specific_humidity": (2e-3, 2e-3),
    "geopotential": (100000.0, 30000.0),
}

STATIC_VARS = {
    "geopotential_at_surface": (3000.0, 5000.0),
    "slope_of_sub_gridscale_orography": (5e-3, 5e-3),
    "standard_deviation_of_orography": (200.0, 300.0),
}


def _smooth_field(rng, shape_hw, mean, scale, t_phase=0.0):
    """Band-limited random field on (H, W) with a slow temporal phase drift."""
    H, W = shape_hw
    lat = np.linspace(-np.pi / 2, np.pi / 2, H)[:, None]
    lon = np.linspace(0, 2 * np.pi, W, endpoint=False)[None, :]
    field = np.zeros((H, W))
    for k in range(1, 4):
        for m in range(0, 4):
            a, b = rng.normal(size=2)
            field += (a * np.cos(m * lon + t_phase * k) + b * np.sin(m * lon - t_phase)) * (
                np.cos(lat) ** max(m, 1) * np.cos(k * lat)
            ) / (k + m + 1)
    field = field / (np.abs(field).max() + 1e-9)
    return (mean + scale * field).astype(np.float32)


def build_raw_store(out_dir: str, nlat: int = 8, nlon: int = 16, n_times: int = 24,
                    levels=(500, 850, 1000), start="2000-01-01T00:00:00",
                    dt_hours: int = 6, seed: int = 0,
                    compressor: dict | None = None,
                    wb2_layout: bool = False) -> None:
    """Write a raw WB2-shaped store under ``out_dir``.

    ``compressor`` overrides the chunk codec; pass
    ``{"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}`` to mirror a
    genuine WeatherBench-2 download byte-for-byte in layout and codec.

    ``wb2_layout=True`` mirrors the genuine archive's axis conventions
    instead of this package's canonical ones: atmospheric arrays stored as
    ``[time, level, lat, lon]``, coordinates named ``lat``/``lon``, latitude
    descending — exercising the reader's dimension canonicalization.
    """
    rng = np.random.default_rng(seed)
    g = zarrlite.create_group(out_dir, overwrite=True)

    lat = (-90 + 180.0 / (2 * nlat)) + (180.0 / nlat) * np.arange(nlat)
    lon = np.arange(nlon) * (360.0 / nlon)
    lat_name, lon_name = ("lat", "lon") if wb2_layout else ("latitude", "longitude")
    lat_out = lat[::-1].copy() if wb2_layout else lat
    lat_flip = (slice(None, None, -1) if wb2_layout else slice(None))
    times = np.datetime64(start, "s") + np.arange(n_times) * np.timedelta64(dt_hours, "h")
    levels = np.asarray(levels, np.int64)

    g.create_array("time", shape=(n_times,), dtype=times.dtype, data=times,
                   dims=("time",), overwrite=True)
    g.create_array(lat_name, shape=(nlat,), dtype=np.float64, data=lat_out,
                   dims=(lat_name,), overwrite=True)
    g.create_array(lon_name, shape=(nlon,), dtype=np.float64, data=lon,
                   dims=(lon_name,), overwrite=True)
    g.create_array("level", shape=(len(levels),), dtype=np.int64, data=levels,
                   dims=("level",), overwrite=True)

    comp = compressor if compressor is not None else {"id": "zlib", "level": 1}
    for name, (mean, scale) in ATMO_VARS.items():
        data = np.empty((n_times, nlat, nlon, len(levels)), np.float32)
        for t in range(n_times):
            for li, lv in enumerate(levels):
                lvl_scale = scale * (0.5 + lv / 1000.0)
                data[t, :, :, li] = _smooth_field(rng, (nlat, nlon), mean, lvl_scale,
                                                  t_phase=0.3 * t)
        if name == "specific_humidity":
            data = np.clip(data, 1e-6, None)
        if wb2_layout:
            out = data[:, lat_flip].transpose(0, 3, 1, 2)  # [T, L, H, W]
            g.create_array(name, shape=out.shape,
                           chunks=(1, len(levels), nlat, nlon),
                           dtype=np.float32, compressor=comp, data=out,
                           dims=("time", "level", lat_name, lon_name),
                           overwrite=True)
        else:
            g.create_array(name, shape=data.shape,
                           chunks=(1, nlat, nlon, len(levels)),
                           dtype=np.float32, compressor=comp, data=data,
                           dims=("time", lat_name, lon_name, "level"),
                           overwrite=True)

    for name, (mean, scale) in SURFACE_VARS.items():
        data = np.empty((n_times, nlat, nlon), np.float32)
        for t in range(n_times):
            data[t] = _smooth_field(rng, (nlat, nlon), mean, scale, t_phase=0.25 * t)
        if name == "total_precipitation_6hr":
            data = np.clip(data, 0.0, None)
        g.create_array(name, shape=data.shape, chunks=(1, nlat, nlon),
                       dtype=np.float32, compressor=comp, data=data[:, lat_flip],
                       dims=("time", lat_name, lon_name), overwrite=True)

    for name, (mean, scale) in STATIC_VARS.items():
        data = np.clip(_smooth_field(rng, (nlat, nlon), mean, scale), 0.0, None)
        g.create_array(name, shape=data.shape, dtype=np.float32,
                       data=data[lat_flip],
                       dims=(lat_name, lon_name), overwrite=True)
    lsm = (_smooth_field(rng, (nlat, nlon), 0.3, 0.5) > 0.3).astype(np.float32)
    g.create_array("land_sea_mask", shape=lsm.shape, dtype=np.float32,
                   data=lsm[lat_flip],
                   dims=(lat_name, lon_name), overwrite=True)
    g.consolidate()


def main():
    p = argparse.ArgumentParser(description="Generate a synthetic WB2-shaped store.")
    p.add_argument("--out", required=True)
    p.add_argument("--nlat", type=int, default=8)
    p.add_argument("--nlon", type=int, default=16)
    p.add_argument("--times", type=int, default=24)
    p.add_argument("--levels", type=int, nargs="+", default=[500, 850, 1000])
    p.add_argument("--start", default="2000-01-01T00:00:00")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    build_raw_store(args.out, args.nlat, args.nlon, args.times,
                    tuple(args.levels), args.start, seed=args.seed)
    print(f"wrote synthetic raw store: {args.out}")


if __name__ == "__main__":
    main()
