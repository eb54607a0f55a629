"""ERA5 dataset reader: preprocessed per-year stores → training samples.

The port's own copy of ``paradis_tpu/data/dataset.py``.  Samples stay numpy
(the loader, ``data/pipeline.py``, makes tensors of them).

Host-side equivalent of reference ``data/era5_dataset.py:39-641`` over
zarrlite (or zarr-compatible) stores with layout
``data[time, features, lat, lon]`` + ``stats``/``constants`` groups:

  * feature-name assembly ``var_h{level}`` and common-features-first ordering
    (era5_dataset.py:150-276),
  * constants stack: z-scored orography fields + land-sea mask + derived
    geometric features (era5_dataset.py:193-261,625-641),
  * per-sample time-window reads, custom/z-score normalization
    (era5_dataset.py:337-382,547-584) and on-the-fly forcings
    (era5_dataset.py:587-623),
  * prediction mode returning (sample_idx, input, forcings, constants).

Samples are channels-last numpy float32:
``x [H, W, n_time*C_dyn]``, ``y [S, H, W, C_out]``,
``forcings [S, H, W, n_forcings*n_time]``, ``constants [H, W, K]``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from paradis_torch.data import zarrlite
from paradis_torch.data.forcings import ToaRadiationCache, time_forcings
from paradis_torch.sphere.geometry import lonlat_grids, normalized_inverse_lon_spacing
from paradis_torch.utils.normalization import (
    normalize_humidity,
    normalize_precipitation,
    normalize_standard,
)

_LEVEL_RE = re.compile(r"_h\d+$")

# constants that are z-score normalized before stacking (era5_dataset.py:194-198)
_NORMALIZED_CONSTANTS = {
    "geopotential_at_surface",
    "slope_of_sub_gridscale_orography",
    "standard_deviation_of_orography",
}

_GEOMETRIC_CONSTANTS = (
    "lon_spacing",
    "cos_latitude",
    "cos_longitude",
    "sin_longitude",
    "latitude",
    "longitude",
)


def _parse_hours(text: str) -> int:
    return int(str(text).rstrip("h"))


def _to_dt(date: str | np.datetime64, end: bool = False) -> np.datetime64:
    if isinstance(date, np.datetime64):
        return date.astype("datetime64[s]")
    date = str(date)
    if "T" not in date:
        date += "T23:59:59" if end else "T00:00:00"
    return np.datetime64(date, "s")


class ERA5Dataset:
    """Sample provider over a preprocessed store directory."""

    def __init__(
        self,
        root_dir: str,
        start_date: str,
        end_date: str | None,
        forecast_steps: int,
        cfg,
        time_interval: str | None = None,
        prediction_stage: bool = False,
        preload: bool = False,
    ):
        self.cfg = cfg
        self.root_dir = Path(root_dir)
        self.forecast_steps = int(forecast_steps)
        self.prediction_stage = prediction_stage
        self.eps = 1e-12
        features_cfg = cfg.features

        self.n_time_inputs = max(1, int(cfg.dataset.n_time_inputs))
        self.custom_normalization = not cfg.normalization.standard
        self.forcing_inputs = list(features_cfg.input.forcings)

        self._open_stores()

        resolution = _parse_hours(cfg.dataset.time_resolution)
        interval = _parse_hours(time_interval) if time_interval else resolution
        self.time_resolution = resolution
        self.interval_steps = max(1, interval // resolution)
        self.prediction_shift = (
            _parse_hours(cfg.dataset.prediction_delta) // resolution - 1
        ) * self.interval_steps

        # sample 0's *last* input time is start_date; earlier lags reach back
        step = np.timedelta64(resolution, "h")
        start = _to_dt(start_date)
        adj_start = start - (self.n_time_inputs - 1) * step
        self._base = int(np.searchsorted(self.times, adj_start))
        end = _to_dt(end_date, end=True) if end_date is not None else self.times[-1]

        # number of initialization times within [start, end] at the interval,
        # capped so every sample's full window exists in the store
        n_in_range = int(
            np.sum(
                (self.times >= start)
                & (self.times <= end)
            )
        )
        n_candidates = (n_in_range + self.interval_steps - 1) // self.interval_steps
        span = (
            self.n_time_inputs
            + self.prediction_shift
            + self.forecast_steps
        )
        max_valid = (len(self.times) - self._base - span) // self.interval_steps + 1
        self.length = max(0, min(n_candidates, max_valid))

        # per-timestamp memo over the GL quadrature: every stamp is shared by
        # the S+n_time-1 sample windows covering it (reference pays this
        # per-sample in worker processes, era5_dataset.py:587-623; this host
        # has one core).  Shuffled epochs revisit stamps in random order, so
        # size the LRU to the training window when memory allows (≤ 1 GB of
        # [H, W] float32 fields; a 2-year 5.625° store is ~143 MB).
        entry_bytes = 4 * self.lat_size * self.lon_size
        n_stamps = self.length * self.interval_steps + self.n_time_inputs + span
        cap = max(512, min(n_stamps, (1 << 30) // entry_bytes))
        self._toa_cache = ToaRadiationCache(
            self.lat, self.lon, self.toa_rad_mean, self.toa_rad_std,
            capacity=cap)

        self._build_features(features_cfg)
        self._build_constants(features_cfg)
        self._prepare_normalization()

        self.num_dyn_inputs_single = len(self._dyn_input_single)
        self.num_in_dyn_features = (
            self.num_dyn_inputs_single * self.n_time_inputs
            + len(self.forcing_inputs) * self.n_time_inputs
        )
        self.num_in_static_features = self.constant_data.shape[-1]
        self.num_in_features = self.num_in_dyn_features + self.num_in_static_features
        self.num_out_features = len(self.dyn_output_features)

        self._run_dataset_checks()

        self.report_stats = None
        if not cfg.forecast.enable and cfg.training.reports.enable:
            feats = list(cfg.training.reports.features)
            idx = [self._feature_index[f] for f in feats]
            self.report_stats = {
                "mean": self._stats["mean"][idx],
                "std": self._stats["std"][idx],
            }

        self._preloaded = None
        if preload:
            lo, hi = self._base, self._base + (self.length - 1) * self.interval_steps + span
            self._preloaded = (lo, self._read_times_raw(lo, hi))

    # -- store discovery -------------------------------------------------------

    def _open_stores(self):
        year_dirs = sorted(
            [p for p in self.root_dir.iterdir() if p.name.isdigit()],
            key=lambda p: int(p.name),
        )
        if not year_dirs:
            raise FileNotFoundError(f"no per-year stores under {self.root_dir}")
        self._stores = []
        times = []
        features = None
        for p in year_dirs:
            g = zarrlite.open_store(p)
            t = np.asarray(g["time"][...]).astype("datetime64[s]")
            f = [str(v) for v in g["features"][...]]
            if features is None:
                features = f
            elif f != features:
                raise ValueError(f"feature mismatch between stores: {p}")
            self._stores.append((g["data"], len(t)))
            times.append(t)
        self.features = features
        self._feature_index = {name: i for i, name in enumerate(features)}
        self.times = np.concatenate(times)
        if not np.all(np.diff(self.times) > np.timedelta64(0, "s")):
            raise ValueError("store times are not strictly increasing")

        g0 = zarrlite.open_store(year_dirs[0])
        self.lat = np.asarray(g0["latitude"][...], np.float64)
        self.lon = np.asarray(g0["longitude"][...], np.float64)
        if self.lat[0] > self.lat[-1]:
            raise ValueError("latitudes must be ascending (preprocess sorts them)")
        self.lat_size, self.lon_size = len(self.lat), len(self.lon)
        self.grid_size = self.lat_size * self.lon_size
        self.lat_rad_grid, self.lon_rad_grid = lonlat_grids(
            np.deg2rad(self.lat), np.deg2rad(self.lon)
        )

        stats = zarrlite.open_store(self.root_dir / "stats")
        self._stats = {k: np.asarray(stats[k][...], np.float32)
                       for k in ("mean", "std", "max", "min")}
        self.toa_rad_mean = float(stats.attrs["toa_radiation_mean"])
        self.toa_rad_std = float(stats.attrs["toa_radiation_std"])
        self._constants_store = zarrlite.open_store(self.root_dir / "constants")

    # -- feature bookkeeping -----------------------------------------------------

    def _build_features(self, features_cfg):
        levels = list(features_cfg.pressure_levels)
        self.pressure_levels = levels
        input_atmo = [f"{v}_h{l}" for v in features_cfg.input.atmospheric for l in levels]
        output_atmo = [f"{v}_h{l}" for v in features_cfg.output.atmospheric for l in levels]
        input_feats = input_atmo + list(features_cfg.input.surface)
        output_feats = output_atmo + list(features_cfg.output.surface)

        common = [f for f in output_feats if f in input_feats]
        self.num_common_features = len(common)
        input_only = [f for f in input_feats if f not in output_feats]
        output_only = [f for f in output_feats if f not in input_feats]

        self._dyn_input_single = common + input_only
        self.dyn_output_features = common + output_only
        # replicated per time lag, like the reference (era5_dataset.py:294-296)
        self.dyn_input_features = self._dyn_input_single * self.n_time_inputs

        missing = [f for f in self._dyn_input_single + self.dyn_output_features
                   if f not in self._feature_index]
        if missing:
            raise ValueError(f"store lacks configured features: {missing[:5]} ...")

        self._in_idx = np.asarray(
            [self._feature_index[f] for f in self._dyn_input_single], np.int64
        )
        self._out_idx = np.asarray(
            [self._feature_index[f] for f in self.dyn_output_features], np.int64
        )

    def _build_constants(self, features_cfg):
        cst = self._constants_store
        pre = []
        for var in features_cfg.input.constants:
            if var in _NORMALIZED_CONSTANTS:
                arr = np.asarray(cst[var][...], np.float32)
                pre.append((arr - float(cst[var].attrs["mean"]))
                           / float(cst[var].attrs["std"]))
        if "land_sea_mask" in features_cfg.input.constants:
            pre.append(np.asarray(cst["land_sea_mask"][...], np.float32))

        latg, long_ = self.lat_rad_grid, self.lon_rad_grid
        geometric = {
            "lon_spacing": lambda: normalized_inverse_lon_spacing(
                np.deg2rad(self.lat), np.deg2rad(self.lon)).astype(np.float32),
            "latitude": lambda: latg.astype(np.float32),
            "longitude": lambda: long_.astype(np.float32),
            "cos_latitude": lambda: np.cos(latg).astype(np.float32),
            "cos_longitude": lambda: np.cos(long_).astype(np.float32),
            "sin_longitude": lambda: np.sin(long_).astype(np.float32),
        }
        post = [geometric[v]() for v in _GEOMETRIC_CONSTANTS
                if v in features_cfg.input.constants]

        total = len(pre) + len(post)
        expected = len(features_cfg.input.constants)
        if total != expected:
            raise ValueError(
                f"Constant count mismatch: expected {expected} from configuration, "
                f"found {total} (pre: {len(pre)}, post: {len(post)})."
            )
        self.constant_data = np.stack([*pre, *post], axis=-1).astype(np.float32)

    def _run_dataset_checks(self):
        consts = self.cfg.features.input.constants
        assert consts[-2] == "latitude", "Latitude must be second-to-last constant!"
        assert consts[-1] == "longitude", "Longitude must be the last constant!"

    # -- normalization ----------------------------------------------------------

    def _prepare_normalization(self):
        precip_idx, humid_idx, zscore_idx = [], [], []
        for i, feat in enumerate(self._dyn_input_single):
            base = _LEVEL_RE.sub("", feat)
            if base == "total_precipitation_6hr" and self.custom_normalization:
                precip_idx.append(i)
            elif base == "specific_humidity" and self.custom_normalization:
                humid_idx.append(i)
            else:
                zscore_idx.append(i)
        self.norm_precip_in = np.asarray(precip_idx, np.int64)
        self.norm_humidity_in = np.asarray(humid_idx, np.int64)
        self.norm_zscore_in = np.asarray(zscore_idx, np.int64)

        precip_o, humid_o, zscore_o = [], [], []
        for i, feat in enumerate(self.dyn_output_features):
            base = _LEVEL_RE.sub("", feat)
            if base == "total_precipitation_6hr" and self.custom_normalization:
                precip_o.append(i)
            elif base == "specific_humidity" and self.custom_normalization:
                humid_o.append(i)
            else:
                zscore_o.append(i)
        self.norm_precip_out = np.asarray(precip_o, np.int64)
        self.norm_humidity_out = np.asarray(humid_o, np.int64)
        self.norm_zscore_out = np.asarray(zscore_o, np.int64)

        mean, std = self._stats["mean"], self._stats["std"]
        self.input_mean = mean[self._in_idx[self.norm_zscore_in]]
        self.input_std = std[self._in_idx[self.norm_zscore_in]]
        self.output_mean = mean[self._out_idx[self.norm_zscore_out]]
        self.output_std = std[self._out_idx[self.norm_zscore_out]]

        if self.custom_normalization and len(self.norm_humidity_in) > 0:
            hidx = self._in_idx[self.norm_humidity_in]
            self.q_max = np.float32(self._stats["max"][hidx].max())
            self.q_min = np.float32(max(self._stats["min"][hidx].min(), self.eps))
        else:
            self.q_max = np.float32(0.0)
            self.q_min = np.float32(self.eps)

    def _normalize_input_block(self, block: np.ndarray) -> np.ndarray:
        """Normalize one time block, channels-last [H, W, C_single]."""
        if self.custom_normalization:
            if len(self.norm_precip_in):
                block[..., self.norm_precip_in] = normalize_precipitation(
                    block[..., self.norm_precip_in])
            if len(self.norm_humidity_in):
                block[..., self.norm_humidity_in] = normalize_humidity(
                    block[..., self.norm_humidity_in], self.q_min, self.q_max, self.eps)
        from paradis_torch.data import native

        if not native.zscore_normalize_inplace(
            block, self.norm_zscore_in, self.input_mean, self.input_std
        ):
            block[..., self.norm_zscore_in] = normalize_standard(
                block[..., self.norm_zscore_in], self.input_mean, self.input_std)
        return block

    def _normalize_output(self, y: np.ndarray) -> np.ndarray:
        if self.custom_normalization:
            if len(self.norm_precip_out):
                y[..., self.norm_precip_out] = normalize_precipitation(
                    y[..., self.norm_precip_out])
            if len(self.norm_humidity_out):
                y[..., self.norm_humidity_out] = normalize_humidity(
                    y[..., self.norm_humidity_out], self.q_min, self.q_max, self.eps)
        y[..., self.norm_zscore_out] = normalize_standard(
            y[..., self.norm_zscore_out], self.output_mean, self.output_std)
        return y

    # -- raw reads ---------------------------------------------------------------

    def _read_times_raw(self, lo: int, hi: int) -> np.ndarray:
        """Read raw [hi-lo, F, H, W] across the per-year stores."""
        out = np.empty((hi - lo, len(self.features), self.lat_size, self.lon_size),
                       np.float32)
        pos = 0
        offset = 0
        for arr, n in self._stores:
            s_lo, s_hi = max(lo, offset), min(hi, offset + n)
            if s_lo < s_hi:
                out[pos : pos + (s_hi - s_lo)] = arr.read_first_axis_batch(
                    s_lo - offset, s_hi - offset
                )
                pos += s_hi - s_lo
            offset += n
        return out

    def _window(self, lo: int, hi: int) -> np.ndarray:
        if self._preloaded is not None:
            base, buf = self._preloaded
            return buf[lo - base : hi - base]
        return self._read_times_raw(lo, hi)

    # -- samples -----------------------------------------------------------------

    def __len__(self) -> int:
        return self.length

    def _compute_forcings(self, times: np.ndarray) -> np.ndarray:
        """[S, H, W, n_forcings*n_time] for forcing timestamps [S+n-1]."""
        S = len(times) - self.n_time_inputs + 1
        n = self.n_time_inputs
        tf = time_forcings(times)
        blocks = []
        for var in self.forcing_inputs:
            if var == "toa_incident_solar_radiation":
                rad = self._toa_cache(times)  # normalized [T, H, W]
                # unfold: frame s gets lags [s, s+n)
                stack = np.stack([rad[s : s + n] for s in range(S)])  # [S,n,H,W]
                blocks.append(np.moveaxis(stack, 1, -1))  # [S,H,W,n]
            elif var in tf:
                v = tf[var].astype(np.float32)
                stack = np.stack([v[s : s + n] for s in range(S)])  # [S,n]
                blocks.append(
                    np.broadcast_to(
                        stack[:, None, None, :],
                        (S, self.lat_size, self.lon_size, n),
                    )
                )
        return np.concatenate(blocks, axis=-1).astype(np.float32)

    def _input_stack(self, raw: np.ndarray) -> np.ndarray:
        """[n, F, H, W] raw → normalized channels-last [H, W, n*C_single]."""
        blocks = []
        for j in range(self.n_time_inputs):
            blk = np.moveaxis(raw[j][self._in_idx], 0, -1).astype(np.float32).copy()
            blocks.append(self._normalize_input_block(blk))
        return np.concatenate(blocks, axis=-1)

    def __getitem__(self, ind: int):
        if self.prediction_stage:
            return self._getitem_prediction(ind)
        return self._getitem_standard(ind)

    def _getitem_standard(self, ind: int):
        base = self._base + ind * self.interval_steps
        n, S = self.n_time_inputs, self.forecast_steps

        raw_in = self._window(base, base + n)
        x = self._input_stack(raw_in)

        out_lo = base + n + self.prediction_shift
        raw_out = self._window(out_lo, out_lo + S)
        y = np.moveaxis(raw_out[:, self._out_idx], 1, -1).astype(np.float32).copy()
        y = self._normalize_output(y)

        forcing_times = self.times[base : base + S + n - 1]
        forcings = self._compute_forcings(forcing_times)

        return x, y, forcings, self.constant_data

    def _getitem_prediction(self, ind: int):
        base = self._base + ind * self.interval_steps
        n, S = self.n_time_inputs, self.forecast_steps
        raw_in = self._window(base, base + n)
        x = self._input_stack(raw_in)
        forcing_times_needed = base + S + n - 1
        avail = min(forcing_times_needed, len(self.times))
        times = self.times[base : avail]
        if avail < forcing_times_needed:
            # forecasting past the end of the archive: extend timestamps
            step = np.timedelta64(self.time_resolution, "h")
            extra = np.arange(1, forcing_times_needed - avail + 1) * step
            times = np.concatenate([times, times[-1] + extra])
        forcings = self._compute_forcings(times)
        return ind, x, forcings, self.constant_data

    # -- misc accessors -----------------------------------------------------------

    def sample_time(self, ind: int) -> np.datetime64:
        """Initialization time of a sample (its last input timestamp)."""
        base = self._base + ind * self.interval_steps
        return self.times[base + self.n_time_inputs - 1]

    def feature_stats(self, names: list[str]) -> dict:
        idx = [self._feature_index[f] for f in names]
        return {"mean": self._stats["mean"][idx], "std": self._stats["std"][idx]}
