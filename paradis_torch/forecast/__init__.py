"""Forecast rollout, WB2 store writer and scoring of the PyTorch port."""

from paradis_torch.forecast.rollout import (
    autoregress_next_input,
    make_forecast_rollout,
    run_forecast,
)
from paradis_torch.forecast.writer import ZarrForecastWriter

__all__ = ["ZarrForecastWriter", "autoregress_next_input", "make_forecast_rollout",
           "run_forecast"]
