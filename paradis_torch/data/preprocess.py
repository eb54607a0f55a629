"""Offline preprocessing: raw WB2-shaped store → training-layout stores.

The port's own copy of ``paradis_tpu/data/preprocess.py``: the same raw
store and options give the same arrays, bit for bit.

Pipeline parity with reference ``scripts/preprocess_dataset.py:20-599``:
  1. select pressure levels (13/37 presets or explicit) and the kept variables,
  2. derive 3-D Cartesian winds (the model state carries Cartesian winds to
     avoid pole discontinuities; ``compute_cartesian_wind``,
     preprocess_dataset.py:42-105),
  3. stack everything into per-year ``data[time, features, lat, lon]`` arrays
     with ``var_h{level}`` feature names,
  4. write a ``constants`` group (static fields + trig features, mean/std
     attrs; land-sea mask as uint8),
  5. compute per-feature mean/std/min/max over the whole archive plus
     streaming TOA-radiation stats,
  6. compute N-hour tendency statistics.

Everything streams over time chunks (bounded memory on the 1-core host).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from paradis_torch.data import zarrlite
from paradis_torch.data.forcings import toa_radiation_stats

G0 = 9.80616        # gravitational acceleration m/s²
R_DRY = 287.05      # dry-air gas constant J/(kg·K)
R_EARTH = 6371000.0

LEVELS_13 = [50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000]
LEVELS_37 = [1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200,
             225, 250, 300, 350, 400, 450, 500, 550, 600, 650, 700, 750,
             775, 800, 825, 850, 875, 900, 925, 950, 975, 1000]

KEEP_3D = [
    "geopotential",
    "specific_humidity",
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
    "vertical_velocity",
    "wind_x",
    "wind_y",
    "wind_z",
]
KEEP_2D = [
    "10m_u_component_of_wind",
    "10m_v_component_of_wind",
    "2m_temperature",
    "mean_sea_level_pressure",
    "surface_pressure",
    "total_precipitation",
    "total_precipitation_6hr",
    "total_column_water",
    "wind_x_10m",
    "wind_y_10m",
    "wind_z_10m",
]
KEEP_STATIC = [
    "geopotential_at_surface",
    "land_sea_mask",
    "slope_of_sub_gridscale_orography",
    "standard_deviation_of_orography",
]

# Blosc-LZ4 with byte shuffle: ~5x faster chunk decode than zlib-1 (the
# training loop's dominant host cost — zlib decode measured 13 of the
# 19 ms/sample assembly at 5.625°) at similar float compression ratios;
# the same container format the genuine WB2 archives use.
COMPRESSOR = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}

# Training-store codec presets (--codec).  lq16/lq8 are the lossy per-layer
# quantizer (zarrlite `lq`) standing in for the reference's external
# LayerQuantizer (scripts/preprocess_dataset.py:11-15): each feature's
# spatial plane quantized against its own range, Blosc-zstd payload.
# Applied to the stacked `data` arrays only — stats/constants stay lossless
# (they feed normalization; quantizing them would bias every sample).
CODECS = {
    "lz4": COMPRESSOR,
    "zstd": {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 1},
    "zlib": {"id": "zlib", "level": 1},
    "lq16": {"id": "lq", "bits": 16, "cname": "zstd", "clevel": 5, "shuffle": 1},
    "lq8": {"id": "lq", "bits": 8, "cname": "zstd", "clevel": 5, "shuffle": 1},
}


def cartesian_wind_3d(u, v, w_omega, temperature, levels_pa, lat_rad, lon_rad):
    """(u, v, ω) → Cartesian (wind_x, wind_y, wind_z).

    ``dr/dt = -ω R T / (p g)`` hydrostatic vertical motion; formulas match
    reference preprocess_dataset.py:42-72.  Inputs are [..., H, W, L] with
    ``levels_pa [L]``; lat/lon are [H, W] (broadcast on the right).
    """
    sin_lat = np.sin(lat_rad)[..., None]
    cos_lat = np.cos(lat_rad)[..., None]
    sin_lon = np.sin(lon_rad)[..., None]
    cos_lon = np.cos(lon_rad)[..., None]
    dr_dt = -w_omega * R_DRY * temperature / (levels_pa * G0)
    wind_x = dr_dt * cos_lat * cos_lon - sin_lat * cos_lon * v - sin_lon * u
    wind_y = dr_dt * cos_lat * sin_lon - sin_lat * sin_lon * v + cos_lon * u
    wind_z = dr_dt * sin_lat + cos_lat * v
    return wind_x, wind_y, wind_z


def cartesian_wind_10m(u10, v10, lat_rad, lon_rad):
    """Surface winds (dr/dt = 0); reference preprocess_dataset.py:74-86."""
    sin_lat, cos_lat = np.sin(lat_rad), np.cos(lat_rad)
    sin_lon, cos_lon = np.sin(lon_rad), np.cos(lon_rad)
    dlon_dt = u10 / (R_EARTH * cos_lat)
    dlat_dt = v10 / R_EARTH
    wind_x = -R_EARTH * sin_lat * cos_lon * dlat_dt - R_EARTH * cos_lat * sin_lon * dlon_dt
    wind_y = -R_EARTH * sin_lat * sin_lon * dlat_dt + R_EARTH * cos_lat * cos_lon * dlon_dt
    wind_z = R_EARTH * cos_lat * dlat_dt
    return wind_x, wind_y, wind_z


class _RawReader:
    """Raw WB2-shaped store accessor with ascending-coordinate reordering,
    optional pole removal, and optional regridding (reference
    preprocess_dataset.py:218-230)."""

    #: accepted spellings of the spatial coordinate names (the WB2 catalogue
    #: uses both "latitude"/"longitude" and "lat"/"lon" across resolutions)
    _LAT_NAMES = ("latitude", "lat")
    _LON_NAMES = ("longitude", "lon")

    def __init__(self, path: str, remove_poles: bool = False,
                 interp_deg: float = 0.0):
        self.group = zarrlite.open_store(path)
        self.times = np.asarray(self.group["time"][...]).astype("datetime64[s]")
        self._lat_name = next(n for n in self._LAT_NAMES if n in self.group.arrays())
        self._lon_name = next(n for n in self._LON_NAMES if n in self.group.arrays())
        lat = np.asarray(self.group[self._lat_name][...], np.float64)
        lon = np.asarray(self.group[self._lon_name][...], np.float64)
        self.lat_order = np.argsort(lat)
        self.lon_order = np.argsort(lon)
        self.lat = lat[self.lat_order]
        self.lon = lon[self.lon_order]
        self.levels = np.asarray(self.group["level"][...], np.int64)

        self._lat_keep = slice(None)
        if remove_poles and interp_deg == 0:
            keep = ~np.isin(self.lat, (-90.0, 90.0))
            self._lat_keep = np.nonzero(keep)[0]
            self.lat = self.lat[self._lat_keep]

        self._regrid = None
        if interp_deg and interp_deg > 0:
            from paradis_torch.ops.resize import linear_interp_matrix

            new_lat = np.arange(-90.0, 90.0 + interp_deg / 2, interp_deg)
            new_lon = np.arange(0.0, 360.0, interp_deg)
            # align-corners matrices over the source grids; longitude uses a
            # periodic extension so the 0/360 wrap interpolates correctly
            wy = _regrid_matrix(self.lat, new_lat)
            wx = _regrid_matrix_periodic(self.lon, new_lon)
            self._regrid = (wy.astype(np.float32), wx.astype(np.float32))
            self.lat, self.lon = new_lat, new_lon

    def _apply_grid(self, arr: np.ndarray) -> np.ndarray:
        """arr [H, W] or [H, W, L] on the source grid → output grid."""
        if self._regrid is None:
            return arr[self._lat_keep]
        wy, wx = self._regrid
        out = np.einsum("oh,hw...->ow...", wy, arr)   # latitude
        return np.einsum("pw,ow...->op...", wx, out)  # longitude (periodic)

    def dims(self, name: str) -> tuple:
        return tuple(self.group[name].attrs.get("_ARRAY_DIMENSIONS", ()))

    def has(self, name: str) -> bool:
        return name in self.group.arrays()

    def _canonical(self, arr: np.ndarray, dims: tuple) -> np.ndarray:
        """Transpose to the canonical [lat, lon(, level)] axis order.

        Genuine WB2 archives store atmospheric variables as
        ``[time, level, lat, lon]`` while this preprocessor's internal
        convention is level-last; ``_ARRAY_DIMENSIONS`` (written by
        xarray/zarr for every WB2 array) drives the permutation.  Arrays
        without the attribute are assumed already canonical.
        """
        if not dims or len(dims) != arr.ndim:
            return arr
        order = [dims.index(self._lat_name), dims.index(self._lon_name)]
        if "level" in dims:
            order.append(dims.index("level"))
        return arr.transpose(order)

    def read_time(self, name: str, t: int) -> np.ndarray:
        """One timestep of a time-varying var → [H, W] or [H, W, L]."""
        dims = tuple(d for d in self.dims(name) if d != "time")
        arr = self._canonical(np.asarray(self.group[name][t]), dims)
        return self._apply_grid(arr[self.lat_order][:, self.lon_order])

    def read_static(self, name: str) -> np.ndarray:
        arr = self._canonical(np.asarray(self.group[name][...]), self.dims(name))
        return self._apply_grid(arr[self.lat_order][:, self.lon_order])


def _regrid_matrix(src_deg: np.ndarray, dst_deg: np.ndarray) -> np.ndarray:
    """[len(dst), len(src)] linear-interp matrix over arbitrary source points."""
    src, dst = np.asarray(src_deg, np.float64), np.asarray(dst_deg, np.float64)
    out = np.zeros((len(dst), len(src)))
    for i, x in enumerate(dst):
        j = np.clip(np.searchsorted(src, x) - 1, 0, len(src) - 2)
        t = np.clip((x - src[j]) / (src[j + 1] - src[j]), 0.0, 1.0)
        out[i, j], out[i, j + 1] = 1.0 - t, t
    return out


def _regrid_matrix_periodic(src_deg: np.ndarray, dst_deg: np.ndarray,
                            period: float = 360.0) -> np.ndarray:
    """Periodic (longitude) linear-interp matrix."""
    src = np.asarray(src_deg, np.float64)
    n = len(src)
    ext = np.concatenate([src, [src[0] + period]])
    out = np.zeros((len(dst_deg), n))
    for i, x in enumerate(np.mod(dst_deg, period)):
        j = np.clip(np.searchsorted(ext, x) - 1, 0, n - 1)
        t = np.clip((x - ext[j]) / (ext[j + 1] - ext[j]), 0.0, 1.0)
        out[i, j] += 1.0 - t
        out[i, (j + 1) % n] += t
    return out


def _feature_list(reader: _RawReader, levels: list[int]) -> list[str]:
    feats = []
    for var in KEEP_3D:
        if reader.has(var) or var in ("wind_x", "wind_y", "wind_z"):
            feats += [f"{var}_h{l}" for l in levels]
    for var in KEEP_2D:
        if reader.has(var) or var in ("wind_x_10m", "wind_y_10m", "wind_z_10m"):
            feats.append(var)
    return feats


def _assemble_timestep(reader: _RawReader, t: int, levels: list[int],
                       level_sel: np.ndarray, lat_rad, lon_rad) -> dict[str, np.ndarray]:
    """All kept fields at one timestep, keyed by feature base name."""
    out = {}
    atmo = {}
    for var in ("u_component_of_wind", "v_component_of_wind", "vertical_velocity",
                "temperature", "geopotential", "specific_humidity"):
        if reader.has(var):
            atmo[var] = reader.read_time(var, t)[..., level_sel]  # [H, W, L]

    levels_pa = np.asarray(levels, np.float64) * 100.0
    wx, wy, wz = cartesian_wind_3d(
        atmo["u_component_of_wind"], atmo["v_component_of_wind"],
        atmo["vertical_velocity"], atmo["temperature"], levels_pa, lat_rad, lon_rad,
    )
    atmo["wind_x"], atmo["wind_y"], atmo["wind_z"] = wx, wy, wz

    for var in KEEP_3D:
        if var in atmo:
            out[var] = atmo[var].astype(np.float32)

    surf = {}
    for var in KEEP_2D:
        if var in ("wind_x_10m", "wind_y_10m", "wind_z_10m"):
            continue
        if reader.has(var):
            surf[var] = reader.read_time(var, t)
    sx, sy, sz = cartesian_wind_10m(
        surf["10m_u_component_of_wind"], surf["10m_v_component_of_wind"],
        lat_rad, lon_rad,
    )
    surf["wind_x_10m"], surf["wind_y_10m"], surf["wind_z_10m"] = sx, sy, sz
    for var in KEEP_2D:
        if var in surf:
            out[var] = surf[var].astype(np.float32)
    return out


def stack_years(reader: _RawReader, out_dir: Path, levels: list[int],
                begin_year: int | None = None, end_year: int | None = None,
                codec: str = "lz4") -> list[str]:
    """Write per-year stacked stores; returns the ordered feature names."""
    level_sel = np.asarray([int(np.where(reader.levels == l)[0][0]) for l in levels])
    lat_rad = np.deg2rad(reader.lat)[:, None]
    lon_rad = np.deg2rad(reader.lon)[None, :]
    feats = _feature_list(reader, levels)
    f_index = {f: i for i, f in enumerate(feats)}
    H, W = len(reader.lat), len(reader.lon)

    years = np.asarray(reader.times, "datetime64[Y]").astype(int) + 1970
    for year in np.unique(years):
        if begin_year is not None and year < begin_year:
            continue
        if end_year is not None and year > end_year:
            continue
        t_idx = np.nonzero(years == year)[0]
        g = zarrlite.create_group(out_dir / str(year), overwrite=True)
        data = g.create_array(
            "data", shape=(len(t_idx), len(feats), H, W),
            chunks=(1, len(feats), H, W), dtype=np.float32,
            compressor=CODECS[codec],
            dims=("time", "features", "latitude", "longitude"), overwrite=True,
        )
        for row, t in enumerate(t_idx):
            fields = _assemble_timestep(reader, int(t), levels, level_sel,
                                        lat_rad, lon_rad)
            frame = np.empty((len(feats), H, W), np.float32)
            for var, arr in fields.items():
                if arr.ndim == 3:  # [H, W, L]
                    for li, lv in enumerate(levels):
                        frame[f_index[f"{var}_h{lv}"]] = arr[..., li]
                else:
                    frame[f_index[var]] = arr
            data[row] = frame

        g.create_array("time", shape=(len(t_idx),), dtype=reader.times.dtype,
                       data=reader.times[t_idx], dims=("time",), overwrite=True)
        g.create_array("features", shape=(len(feats),),
                       dtype=np.array(feats).dtype, data=np.array(feats),
                       dims=("features",), overwrite=True)
        g.create_array("latitude", shape=(H,), dtype=np.float64, data=reader.lat,
                       dims=("latitude",), overwrite=True)
        g.create_array("longitude", shape=(W,), dtype=np.float64, data=reader.lon,
                       dims=("longitude",), overwrite=True)
        g.consolidate()
        print(f"stacked year {year}: {len(t_idx)} steps, {len(feats)} features")
    return feats


def write_constants(reader: _RawReader, out_dir: Path) -> None:
    g = zarrlite.create_group(out_dir / "constants", overwrite=True)
    lat_rad = np.deg2rad(reader.lat)[:, None]
    lon_rad = np.deg2rad(reader.lon)[None, :]
    H, W = len(reader.lat), len(reader.lon)
    fields = {
        "cos_latitude": np.broadcast_to(np.cos(lat_rad), (H, W)),
        "cos_longitude": np.broadcast_to(np.cos(lon_rad), (H, W)),
        "sin_longitude": np.broadcast_to(np.sin(lon_rad), (H, W)),
    }
    for var in KEEP_STATIC:
        if reader.has(var):
            arr = reader.read_static(var)
            if np.isnan(arr).any():
                continue
            fields[var] = arr
    for name, arr in fields.items():
        arr32 = np.ascontiguousarray(arr, np.float32)
        dtype = np.uint8 if name == "land_sea_mask" else np.float32
        g.create_array(
            name, shape=arr32.shape, dtype=dtype,
            data=arr32.astype(dtype), compressor=COMPRESSOR,
            dims=("latitude", "longitude"),
            attrs={"mean": float(arr32.mean()), "std": float(arr32.std())},
            overwrite=True,
        )
    g.create_array("latitude", shape=(H,), dtype=np.float64, data=reader.lat,
                   dims=("latitude",), overwrite=True)
    g.create_array("longitude", shape=(W,), dtype=np.float64, data=reader.lon,
                   dims=("longitude",), overwrite=True)
    g.consolidate()


def compute_statistics(out_dir: Path, toa_time_stride: int = 1) -> None:
    """Per-feature mean/std/min/max over all years + TOA radiation stats.

    Also writes a ``climatology`` group: the per-feature per-gridpoint time
    mean over the processed years, ``mean [F, H, W]``.  This is the external
    climatology the forecast scorer's ACC uses (WB2 convention: anomalies
    against a training-period climatology, not the scored window itself —
    the reference defers scoring entirely to WB2 tooling, README.md).
    """
    years = sorted(p for p in Path(out_dir).iterdir() if p.name.isdigit())
    total = None
    count = 0
    n_frames = 0
    clim_sum = None
    all_times = []
    for ydir in years:
        g = zarrlite.open_store(ydir)
        data, t = g["data"], np.asarray(g["time"][...])
        all_times.append(t)
        feats = g["features"]
        for i in range(data.shape[0]):
            frame = np.asarray(data[i], np.float64)  # [F, H, W]
            s = frame.reshape(frame.shape[0], -1)
            if total is None:
                total = {
                    "sum": np.zeros(frame.shape[0]),
                    "sumsq": np.zeros(frame.shape[0]),
                    "min": np.full(frame.shape[0], np.inf),
                    "max": np.full(frame.shape[0], -np.inf),
                }
                clim_sum = np.zeros(frame.shape, np.float64)
            total["sum"] += s.sum(axis=1)
            total["sumsq"] += (s * s).sum(axis=1)
            total["min"] = np.minimum(total["min"], s.min(axis=1))
            total["max"] = np.maximum(total["max"], s.max(axis=1))
            count += s.shape[1]
            clim_sum += frame
            n_frames += 1

    mean = total["sum"] / count
    var = np.maximum(0.0, total["sumsq"] / count - mean**2)
    std = np.sqrt(var)

    g0 = zarrlite.open_store(years[0])
    lat = np.asarray(g0["latitude"][...])
    lon = np.asarray(g0["longitude"][...])
    times = np.concatenate(all_times)
    toa_mean, toa_std = toa_radiation_stats(times, lat, lon, time_stride=toa_time_stride)

    sg = zarrlite.create_group(Path(out_dir) / "stats", overwrite=True)
    feats = np.asarray(g0["features"][...])
    for name, arr in (("mean", mean), ("std", std), ("max", total["max"]),
                      ("min", total["min"])):
        sg.create_array(name, shape=arr.shape, dtype=np.float32,
                        data=arr.astype(np.float32), dims=("features",), overwrite=True)
    sg.create_array("features", shape=feats.shape, dtype=feats.dtype, data=feats,
                    dims=("features",), overwrite=True)
    sg.attrs["toa_radiation_mean"] = toa_mean
    sg.attrs["toa_radiation_std"] = toa_std
    sg.attrs.save()
    sg.consolidate()

    cg = zarrlite.create_group(Path(out_dir) / "climatology", overwrite=True)
    cg.create_array("mean", shape=clim_sum.shape, dtype=np.float32,
                    data=(clim_sum / max(n_frames, 1)).astype(np.float32),
                    dims=("features", "latitude", "longitude"), overwrite=True)
    cg.create_array("features", shape=feats.shape, dtype=feats.dtype, data=feats,
                    dims=("features",), overwrite=True)
    cg.create_array("latitude", shape=lat.shape, dtype=lat.dtype, data=lat,
                    dims=("latitude",), overwrite=True)
    cg.create_array("longitude", shape=lon.shape, dtype=lon.dtype, data=lon,
                    dims=("longitude",), overwrite=True)
    cg.attrs["n_frames"] = int(n_frames)
    cg.attrs.save()
    cg.consolidate()


def compute_tendency_statistics(out_dir: Path, delta_hours: int = 6) -> None:
    """Stats of y(t+Δ) − y(t) (reference preprocess_dataset.py:482-595)."""
    years = sorted(p for p in Path(out_dir).iterdir() if p.name.isdigit())
    groups = [zarrlite.open_store(p) for p in years]
    times = np.concatenate([np.asarray(g["time"][...]) for g in groups])
    if len(times) < 2:
        raise ValueError("Need at least two time steps to compute tendencies.")
    native = (times[1] - times[0]).astype("timedelta64[h]").astype(int)
    if delta_hours % native != 0:
        raise ValueError(
            f"Tendency delta ({delta_hours}h) not a multiple of resolution ({native}h)."
        )
    stride = delta_hours // native

    # flat accessor over years
    arrays = [(g["data"], g["data"].shape[0]) for g in groups]

    def frame(i):
        for arr, n in arrays:
            if i < n:
                return np.asarray(arr[i], np.float64)
            i -= n
        raise IndexError(i)

    total = None
    count = 0
    for i in range(len(times) - stride):
        d = frame(i + stride) - frame(i)
        s = d.reshape(d.shape[0], -1)
        if total is None:
            total = {
                "sum": np.zeros(d.shape[0]),
                "sumsq": np.zeros(d.shape[0]),
                "min": np.full(d.shape[0], np.inf),
                "max": np.full(d.shape[0], -np.inf),
            }
        total["sum"] += s.sum(axis=1)
        total["sumsq"] += (s * s).sum(axis=1)
        total["min"] = np.minimum(total["min"], s.min(axis=1))
        total["max"] = np.maximum(total["max"], s.max(axis=1))
        count += s.shape[1]

    mean = total["sum"] / count
    std = np.sqrt(np.maximum(0.0, total["sumsq"] / count - mean**2))

    tg = zarrlite.create_group(Path(out_dir) / f"tendency_stats_{delta_hours}h",
                               overwrite=True)
    for name, arr in (("tendency_mean", mean), ("tendency_std", std),
                      ("tendency_max", total["max"]), ("tendency_min", total["min"])):
        tg.create_array(name, shape=arr.shape, dtype=np.float32,
                        data=arr.astype(np.float32), dims=("features",), overwrite=True)
    tg.attrs.update({"delta_hours": int(delta_hours), "native_dt_hours": int(native),
                     "stride": int(stride), "n_samples": int(len(times) - stride)})
    tg.attrs.save()
    tg.consolidate()


def preprocess(input_dir: str, output_dir: str, levels=None,
               begin_year: int | None = None, end_year: int | None = None,
               skip_stats: bool = False, only_stats: bool = False,
               toa_time_stride: int = 1, remove_poles: bool = False,
               interp_deg: float = 0.0, codec: str = "lz4") -> None:
    reader = _RawReader(input_dir, remove_poles=remove_poles,
                        interp_deg=interp_deg)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if levels is None:
        levels = [int(l) for l in reader.levels]
    elif levels == 13:
        levels = LEVELS_13
    elif levels == 37:
        levels = LEVELS_37
    if not only_stats:
        stack_years(reader, out, list(levels), begin_year, end_year, codec=codec)
    if not skip_stats:
        write_constants(reader, out)
        compute_statistics(out, toa_time_stride=toa_time_stride)
        compute_tendency_statistics(out)


def main():
    p = argparse.ArgumentParser(description="Preprocess WB2-shaped data.")
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--levels", type=int, choices=[13, 37], default=None,
                   help="pressure-level preset; default: all levels in the store")
    p.add_argument("--begin_year", type=int, default=None)
    p.add_argument("--end_year", type=int, default=None)
    p.add_argument("--skip-stats", action="store_true")
    p.add_argument("--only-stats", action="store_true")
    p.add_argument("--toa-time-stride", type=int, default=1)
    p.add_argument("--remove-poles", action="store_true",
                   help="drop the ±90° latitude rows")
    p.add_argument("--interp_deg", type=float, default=0.0,
                   help="regrid to this resolution in degrees")
    p.add_argument("--codec", choices=sorted(CODECS), default="lz4",
                   help="training-store codec; lq16/lq8 are the lossy "
                        "per-layer quantizer (LayerQuantizer equivalent)")
    args = p.parse_args()
    if args.skip_stats and args.only_stats:
        p.error("--skip-stats and --only-stats cannot both be used")
    preprocess(args.input_dir, args.output_dir, args.levels, args.begin_year,
               args.end_year, args.skip_stats, args.only_stats,
               args.toa_time_stride, args.remove_poles, args.interp_deg,
               codec=args.codec)


if __name__ == "__main__":
    main()
