"""Headline forecast scoring: latitude-weighted RMSE vs the truth archive.

The port's own copy of ``paradis_tpu/forecast/evaluate.py``.  Computes the
WB2-style deterministic headline metrics (Z500 / T850 RMSE at chosen lead
times) from a forecast store written by
:class:`paradis_torch.forecast.writer.ZarrForecastWriter` against a
preprocessed truth store or a raw WB2-layout archive.  This is the
measurement half of the project's north-star metric (BASELINE.md) — the
reference repo itself defers scoring to external WB2 tooling.

Fields are read on the host; the squared errors, anomalies and their
latitude-weighted means are float64 on ``device`` (``cuda`` by default,
raising without a card; ``--device cpu`` on the CPU), in the JAX package's
order: one mean over the grid a field, summed over init times in Python.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from paradis_torch import resolve_device
from paradis_torch.data import zarrlite
from paradis_torch.sphere.geometry import latitude_weights

# forecast-store variable → truth-store stacked feature name
_TRUTH_NAME = {
    "u_component_of_wind": "u_component_of_wind",
    "v_component_of_wind": "v_component_of_wind",
    "vertical_velocity": "vertical_velocity",
    "geopotential": "geopotential",
    "temperature": "temperature",
    "specific_humidity": "specific_humidity",
    "2m_temperature": "2m_temperature",
    "mean_sea_level_pressure": "mean_sea_level_pressure",
    "10m_u_component_of_wind": "10m_u_component_of_wind",
    "10m_v_component_of_wind": "10m_v_component_of_wind",
    "total_precipitation_6hr": "total_precipitation_6hr",
}


class WB2TruthReader:
    """Reads truth fields directly from a raw WB2-layout archive.

    Accepts a genuine WeatherBench-2 download (Blosc-compressed chunks,
    ``[time, level, lat, lon]`` atmospheric arrays, either coordinate-name
    spelling, any latitude order) via the preprocessor's ``_RawReader``
    canonicalization — so forecasts can be scored against the archive
    without preprocessing the truth window first (the reference defers this
    entirely to external WB2 tooling).
    """

    def __init__(self, root: str):
        from paradis_torch.data.preprocess import _RawReader

        self._r = _RawReader(str(root))
        self.times = self._r.times
        self.lat = self._r.lat
        self._levels = [int(l) for l in self._r.levels]

    def field(self, name: str, time: np.datetime64) -> np.ndarray | None:
        idx = int(np.searchsorted(self.times, time.astype("datetime64[s]")))
        if idx >= len(self.times) or self.times[idx] != time:
            return None
        var, _, suffix = name.rpartition("_h")
        if var and suffix.isdigit():
            level = int(suffix)
            if level not in self._levels or not self._r.has(var):
                return None
            arr = self._r.read_time(var, idx)          # [H, W, L]
            return arr[..., self._levels.index(level)]
        if not self._r.has(name):
            return None
        return self._r.read_time(name, idx)


class TruthReader:
    """Reads denormalized truth fields from a preprocessed store."""

    def __init__(self, root: str):
        self.root = Path(root)
        years = sorted(p for p in self.root.iterdir() if p.name.isdigit())
        self._groups = [zarrlite.open_store(p) for p in years]
        self.times = np.concatenate(
            [np.asarray(g["time"][...]).astype("datetime64[s]") for g in self._groups]
        )
        self._sizes = [g["data"].shape[0] for g in self._groups]
        self.features = [str(f) for f in self._groups[0]["features"][...]]
        self.lat = np.asarray(self._groups[0]["latitude"][...])

    def field(self, name: str, time: np.datetime64) -> np.ndarray | None:
        idx = int(np.searchsorted(self.times, time.astype("datetime64[s]")))
        if idx >= len(self.times) or self.times[idx] != time:
            return None
        fi = self.features.index(name)
        for g, n in zip(self._groups, self._sizes):
            if idx < n:
                return np.asarray(g["data"][idx, fi])
            idx -= n
        return None


def open_truth(truth_root: str):
    """Auto-detect the truth layout: preprocessed per-year store vs raw WB2.

    A preprocessed root contains per-year subdirectories holding a stacked
    ``data`` array; anything else is treated as a raw WB2-layout archive.
    """
    root = Path(truth_root)
    year_dirs = sorted(p for p in root.iterdir() if p.name.isdigit())
    if year_dirs:
        return TruthReader(truth_root)
    return WB2TruthReader(truth_root)


class ClimatologyReader:
    """Per-feature gridpoint climatology from the preprocessor's group.

    ``compute_statistics`` writes ``<store>/climatology`` with
    ``mean [F, H, W]`` over the processed (training) years — the external
    climatology WB2-convention ACC anomalies are taken against.
    """

    def __init__(self, path: str):
        g = zarrlite.open_store(path)
        self._mean = g["mean"]
        self.features = [str(f) for f in np.asarray(g["features"][...])]

    def field(self, name: str) -> np.ndarray | None:
        if name not in self.features:
            return None
        return np.asarray(self._mean[self.features.index(name)], np.float64)


def evaluate_store(forecast_path: str, truth_root: str,
                   variables: list[tuple[str, int | None]],
                   lead_hours: list[int], acc: bool = True,
                   climatology: str | None = None, device=None) -> dict:
    """RMSE (and ACC) per (variable, lead) over init times with truth.

    RMSE is the latitude-weighted WB2 headline deterministic metric.  ACC is
    the latitude-weighted anomaly correlation, with anomalies taken against
    an external per-variable climatology (``climatology`` = path to the
    preprocessor's ``climatology`` group, computed over the training years —
    the WB2 convention, which proper uses a 1990–2019 day-of-year
    climatology).  Without one, ACC falls back to the scored truth window's
    own time mean — an in-sample estimate that inflates short-window scores;
    a loud warning marks the results as not WB2-comparable.  The sums run in
    float64 on ``device`` (``cuda`` unless the caller passes another).
    """
    device = resolve_device(device)
    fc = zarrlite.open_store(forecast_path)
    truth = open_truth(truth_root)
    clim_reader = ClimatologyReader(climatology) if climatology else None
    if acc and clim_reader is None:
        import warnings

        warnings.warn(
            "evaluate_store: no --climatology given; ACC anomalies use the "
            "scored truth window's own mean (in-sample). Scores are NOT "
            "WB2-comparable — pass the preprocessor's climatology group.",
            stacklevel=2,
        )

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float64)).to(device)

    init_times = np.asarray(fc["time"][...]).astype("datetime64[s]")
    tds = np.asarray(fc["prediction_timedelta"][...]).astype("timedelta64[h]")
    levels = [int(l) for l in np.asarray(fc["level"][...])]
    lat_w = latitude_weights(np.asarray(fc["latitude"][...])).astype(np.float64)
    w2 = on_device(lat_w[:, None])

    results = {}
    for var, level in variables:
        arr = fc[var]
        lvl_idx = levels.index(level) if level is not None else None
        truth_name = _TRUTH_NAME[var] + (f"_h{level}" if level is not None else "")

        def read_pred(t_i: int, td_i: int) -> torch.Tensor:
            if lvl_idx is not None:
                return on_device(arr[t_i, td_i, lvl_idx])
            return on_device(arr[t_i, td_i])

        # pass 1 — streaming RMSE; cache one truth field per unique target
        # time (the only per-field state kept: ACC's climatology needs the
        # truth twice, predictions are re-read from the store in pass 2)
        truth_cache: dict[np.datetime64, torch.Tensor | None] = {}
        scored: dict[int, list[tuple[int, int, np.datetime64]]] = {}
        mse_sum: dict[int, float] = {}
        for lead in lead_hours:
            td_candidates = np.nonzero(tds == np.timedelta64(lead, "h"))[0]
            if len(td_candidates) == 0:
                continue
            td_i = int(td_candidates[0])
            for t_i, t0 in enumerate(init_times):
                target_time = t0 + np.timedelta64(lead, "h")
                if target_time not in truth_cache:
                    tr = truth.field(truth_name, target_time)
                    truth_cache[target_time] = None if tr is None else on_device(tr)
                tr = truth_cache[target_time]
                if tr is None:
                    continue
                pred = read_pred(t_i, td_i)
                if not bool(torch.isfinite(pred).all()):
                    continue
                se = (pred - tr) ** 2
                mse_sum[lead] = mse_sum.get(lead, 0.0) + float((se * w2).mean())
                scored.setdefault(lead, []).append((t_i, td_i, target_time))

        # per-variable climatology: external (training-years gridpoint mean,
        # WB2 convention) when available, else the scored window's time mean
        clim = clim_reader.field(truth_name) if clim_reader else None
        if clim is not None:
            clim = on_device(clim)
        else:
            truth_fields = [t for t in truth_cache.values() if t is not None]
            clim = torch.stack(truth_fields).mean(dim=0) if truth_fields else None

        key = f"{var}_h{level}" if level is not None else var
        for lead, items in scored.items():
            results[f"{key}@{lead}h"] = float(np.sqrt(mse_sum[lead] / len(items)))
            if acc and clim is not None:
                accs = []
                for t_i, td_i, target_time in items:  # pass 2 — anomalies
                    pa = read_pred(t_i, td_i) - clim
                    ta = truth_cache[target_time] - clim
                    num = float((pa * ta * w2).mean())
                    den = float(np.sqrt(float((pa * pa * w2).mean())
                                        * float((ta * ta * w2).mean())))
                    if den > 0:
                        accs.append(num / den)
                if accs:
                    results[f"{key}@{lead}h:acc"] = float(np.mean(accs))
    return results


def _parse_variable(text: str) -> tuple[str, int | None]:
    if ":" in text:
        name, lvl = text.split(":")
        return name, int(lvl)
    return text, None


def main(argv=None):
    p = argparse.ArgumentParser(description="Score a forecast store (lat-weighted RMSE).")
    p.add_argument("--forecast", required=True)
    p.add_argument("--truth", required=True,
                   help="preprocessed truth store root, or a raw WB2-layout archive")
    p.add_argument("--variables", nargs="+",
                   default=["geopotential:500", "temperature:850"])
    p.add_argument("--lead-hours", type=int, nargs="+", default=[24, 72, 120])
    p.add_argument("--climatology", default=None,
                   help="path to the preprocessor's climatology group; ACC "
                        "anomalies use it (WB2 convention) instead of the "
                        "scored window's own mean")
    p.add_argument("--device", default="cuda",
                   help="device of the float64 sums (cuda by default; raises "
                        "without a card unless 'cpu')")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for and no CUDA device is available; "
                           "pass --device cpu to score on the CPU")
    results = evaluate_store(args.forecast, args.truth,
                             [_parse_variable(v) for v in args.variables],
                             args.lead_hours, climatology=args.climatology, device=device)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
