"""Forecast rollout, WB2 store writer and scoring of the PyTorch port.

The names below load their module on first use, so that a serving process
importing ``paradis_torch.forecast.export`` loads neither the rollout nor
the writer (and its store codecs).
"""

import importlib

_MODULE_OF = {"ZarrForecastWriter": "writer", "autoregress_next_input": "rollout",
              "forecast_step": "rollout", "make_forecast_rollout": "rollout",
              "run_forecast": "rollout"}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
