"""WB2-layout forecast store: template creation + disjoint region writes.

The port's own copy of ``paradis_tpu/forecast/writer.py`` (the same bytes on
disk from the same forecast array), on the port's ``zarrlite`` and
``ERA5Dataset``.  Mirrors reference ``utils/file_output.py:178-377``:
  * a template zarr with ``(time, prediction_timedelta, level, lat, lon)``
    layout pre-allocated for every init time (td=0 holds the initial state),
  * WB2 variable renames (wind_x → u_component_of_wind, …),
  * derived ``dewpoint_depression`` field,
  * float32 + BitRound(16) + Blosc-zstd encoding (the reference codec),
  * region writes of sorted contiguous sample groups — disjoint by
    construction, so multi-device forecast writers never race.

Without the native host library ``blosc.encode`` writes a zlib frame in
place of zstd, as the JAX package's does; ``run_forecast`` on a card
requires the library, and ``chunk_codecs`` reads back what a store holds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from paradis_torch.data import zarrlite
from paradis_torch.data.blosc import _CODEC_IDS
from paradis_torch.utils.postprocessing import (
    convert_cartesian_to_spherical_winds,
    denormalize_forecast,
    feature_indices,
)
from paradis_torch.utils.thermo import dewpoint_depression

_RENAME_ATMO = {
    "wind_x": "u_component_of_wind",
    "wind_y": "v_component_of_wind",
    "wind_z": "vertical_velocity",
}
_RENAME_SURF = {
    "wind_x_10m": "10m_u_component_of_wind",
    "wind_y_10m": "10m_v_component_of_wind",
}

# the reference's forecast encoding exactly (file_output.py:14-28):
# float32 + BitRound(16) + Blosc-zstd-5 with byte shuffle
_ENC = {"compressor": {"id": "blosc", "cname": "zstd", "clevel": 5,
                       "shuffle": 1},
        "filters": [{"id": "bitround", "keepbits": 16}]}


_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items() if k not in ("lz4hc",)}


def chunk_codecs(path: str | Path) -> dict[str, set[str]]:
    """``{variable: codecs}`` of a store's forecast variables, read from the
    Blosc header (flag bits 5-7) of every chunk written."""
    g = zarrlite.open_store(path)
    out = {}
    for name in g.arrays():
        if (g[name].compressor or {}).get("id") != "blosc":
            continue
        out[name] = {_CODEC_NAMES[(f.read_bytes()[2] >> 5) & 7]
                     for f in g[name].path.iterdir() if not f.name.startswith(".")}
    return out


def _renamed_vars(cfg):
    atmo = [(v, _RENAME_ATMO.get(v, v)) for v in cfg.features.output.atmospheric]
    surf = [(v, _RENAME_SURF.get(v, v)) for v in cfg.features.output.surface
            if v != "wind_z_10m"]
    return atmo, surf


class ZarrForecastWriter:
    """Writer for autoregressive forecasts of one prediction dataset."""

    def __init__(self, cfg, dataset, output_file: str | None = None):
        self.cfg = cfg
        self.path = Path(output_file or cfg.forecast.output_file)
        self.store_initialized = False

        self.levels = [int(l) for l in cfg.features.pressure_levels]
        num_steps = int(cfg.model.forecast_steps)
        out_freq = int(cfg.forecast.output_frequency)
        self.stored_steps = (num_steps - 1) // out_freq + 1
        self.total_pred = self.stored_steps + 1  # + init state

        self.init_times = np.sort(
            np.asarray([dataset.sample_time(i) for i in range(len(dataset))])
        )
        self.features = list(dataset.dyn_output_features)

    # -- template ---------------------------------------------------------------

    def init_store(self, dataset) -> None:
        if self.store_initialized:
            return
        H, W = dataset.lat_size, dataset.lon_size
        L = len(self.levels)
        T = len(self.init_times)
        P = self.total_pred
        if T == 0:
            raise ValueError(
                "no forecast init times: the prediction window "
                "(forecast.start_date..end_date) yields zero dataset samples — "
                "check that the store covers the window plus "
                "n_time_inputs of history"
            )
        g = zarrlite.create_group(self.path, overwrite=True)

        g.create_array("time", shape=(T,), dtype=self.init_times.dtype,
                       data=self.init_times, dims=("time",), overwrite=True)
        td = np.arange(P) * np.timedelta64(dataset.time_resolution * 3600 * 10**9, "ns")
        g.create_array("prediction_timedelta", shape=(P,), dtype=td.dtype, data=td,
                       dims=("prediction_timedelta",), overwrite=True)
        g.create_array("level", shape=(L,), dtype=np.int64,
                       data=np.asarray(self.levels), dims=("level",), overwrite=True)
        g.create_array("latitude", shape=(H,), dtype=np.float64, data=dataset.lat,
                       dims=("latitude",), overwrite=True)
        g.create_array("longitude", shape=(W,), dtype=np.float64, data=dataset.lon,
                       dims=("longitude",), overwrite=True)

        atmo, surf = _renamed_vars(self.cfg)
        atm_dims = ("time", "prediction_timedelta", "level", "latitude", "longitude")
        sur_dims = ("time", "prediction_timedelta", "latitude", "longitude")
        pchunk = min(10, P)
        for _, out_name in atmo:
            g.create_array(out_name, shape=(T, P, L, H, W),
                           chunks=(1, pchunk, L, H, W), dtype=np.float32,
                           fill_value="NaN", dims=atm_dims, overwrite=True, **_ENC)
        for _, out_name in surf:
            g.create_array(out_name, shape=(T, P, H, W),
                           chunks=(1, pchunk, H, W), dtype=np.float32,
                           fill_value="NaN", dims=sur_dims, overwrite=True, **_ENC)
        g.create_array("dewpoint_depression", shape=(T, P, L, H, W),
                       chunks=(1, pchunk, L, H, W), dtype=np.float32,
                       fill_value="NaN", dims=atm_dims, overwrite=True, **_ENC)

        # constants copied once
        for name in dataset._constants_store.arrays():
            if name in ("latitude", "longitude"):
                continue
            arr = np.asarray(dataset._constants_store[name][...])
            g.create_array(name, shape=arr.shape, dtype=np.float32,
                           data=arr.astype(np.float32),
                           dims=("latitude", "longitude"), overwrite=True)
        g.consolidate()
        self.store_initialized = True

    # -- init state --------------------------------------------------------------

    def _initial_state(self, dataset, sample_indices: np.ndarray) -> np.ndarray:
        """Denormalized [B, F_out, H, W] initial fields (input features only;
        output-only channels stay NaN, like the reference)."""
        B = len(sample_indices)
        H, W = dataset.lat_size, dataset.lon_size
        out = np.full((B, len(self.features), H, W), np.nan, np.float32)
        n = dataset.n_time_inputs
        in_map = {f: i for i, f in enumerate(dataset._dyn_input_single)}
        for b, si in enumerate(sample_indices):
            base = dataset._base + int(si) * dataset.interval_steps
            raw = dataset._window(base + n - 1, base + n)[0]  # [F_store, H, W] raw
            for oi, feat in enumerate(self.features):
                if feat in in_map:
                    out[b, oi] = raw[dataset._feature_index[feat]]
        convert_cartesian_to_spherical_winds(
            dataset.lat, dataset.lon, self.levels, out, self.features)
        return out

    # -- region writes -------------------------------------------------------------

    def write_forecast_chunk(self, forecast: np.ndarray, sample_indices: np.ndarray,
                             start_idx: int, dataset) -> None:
        """Write ``forecast [B, T_chunk, F, H, W]`` (normalized model output).

        ``start_idx`` is the first stored-step index of this chunk; when 0 the
        initial state is also written at td=0.
        """
        forecast = np.asarray(forecast, np.float32).copy()
        denormalize_forecast(forecast, dataset)
        convert_cartesian_to_spherical_winds(
            dataset.lat, dataset.lon, self.levels, forecast, self.features)

        order = np.argsort(sample_indices)
        sample_indices = np.asarray(sample_indices)[order]
        forecast = forecast[order]

        init_times = np.asarray([dataset.sample_time(int(i)) for i in sample_indices])
        positions = np.searchsorted(self.init_times, init_times)

        g = zarrlite.open_store(self.path)
        atmo, surf = _renamed_vars(self.cfg)
        q_idx = feature_indices("specific_humidity", self.features)
        t_idx = feature_indices("temperature", self.features)
        levels_pa = np.asarray(self.levels, np.float64)[:, None, None] * 100.0

        include_init = start_idx == 0
        init_state = (
            self._initial_state(dataset, sample_indices) if include_init else None
        )

        # contiguous groups → one region write per group
        breaks = np.nonzero(np.diff(positions) != 1)[0] + 1
        for group in np.split(np.arange(len(positions)), breaks):
            pos_lo = int(positions[group[0]])
            pos_hi = int(positions[group[-1]]) + 1
            fc = forecast[group]          # [Bg, T, F, H, W]
            td_lo = 1 + start_idx
            td_hi = td_lo + fc.shape[1]

            def block(idx_list, data, init_block):
                """[Bg, P_written, len(idx), H, W] including optional init."""
                sel = data[:, :, idx_list]
                if init_block is not None:
                    return np.concatenate([init_block[group][:, None, idx_list], sel],
                                          axis=1)
                return sel

            lo = td_lo - 1 if include_init else td_lo

            for in_name, out_name in atmo:
                idx = feature_indices(in_name, self.features)
                data = block(idx, fc, init_state)
                g[out_name][pos_lo:pos_hi, lo:td_hi] = data
            for in_name, out_name in surf:
                idx = int(self.features.index(in_name))
                data = block([idx], fc, init_state)[:, :, 0]
                g[out_name][pos_lo:pos_hi, lo:td_hi] = data

            # derived dewpoint depression from converted q/T
            q = block(q_idx, fc, init_state)
            t = block(t_idx, fc, init_state)
            dd = dewpoint_depression(q, t, levels_pa).astype(np.float32)
            g["dewpoint_depression"][pos_lo:pos_hi, lo:td_hi] = dd
