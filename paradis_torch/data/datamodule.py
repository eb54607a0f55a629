"""Era5DataModule: the reference's datamodule API over our dataset/loaders.

The port's own copy of ``paradis_tpu/data/datamodule.py``; its loaders put
batches on ``device`` (``cuda`` unless the caller passes another).

A convenience wrapper mirroring ``data/datamodule.py:13-162`` so reference
users keep their mental model: ``setup("fit"/"predict")`` builds the
datasets, ``*_dataloader()`` return prefetching batch iterators, and the
summary attributes (``num_in_features``, ``output_name_order``, ``lat`` …)
hang off the module.
"""

from __future__ import annotations

import logging

from paradis_torch.data.dataset import ERA5Dataset
from paradis_torch.data.pipeline import BatchLoader

log = logging.getLogger("paradis_torch")


class Era5DataModule:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = device
        self.root_dir = cfg.dataset.root_dir
        self.batch_size = int(cfg.compute.batch_size)
        self.forecast_steps = int(cfg.model.forecast_steps)
        vs = cfg.model.get("val_forecast_steps") or self.forecast_steps
        self.val_forecast_steps = int(vs)
        self._setup_done = {"fit": False, "predict": False}

    def setup(self, stage: str = "fit") -> None:
        if self._setup_done.get(stage):
            return
        cfg = self.cfg
        if stage == "fit":
            self.dataset = ERA5Dataset(
                self.root_dir,
                cfg.training.dataset.start_date,
                cfg.training.dataset.end_date,
                forecast_steps=self.forecast_steps,
                cfg=cfg,
                time_interval=cfg.dataset.sampling_interval,
                preload=bool(cfg.training.dataset.preload),
            )
            self.val_dataset = ERA5Dataset(
                self.root_dir,
                cfg.training.validation_dataset.start_date,
                cfg.training.validation_dataset.end_date,
                forecast_steps=self.val_forecast_steps,
                cfg=cfg,
                time_interval=cfg.dataset.sampling_interval,
                preload=bool(cfg.training.validation_dataset.preload),
            )
        elif stage == "predict":
            self.dataset = ERA5Dataset(
                self.root_dir,
                cfg.forecast.start_date,
                cfg.forecast.get("end_date"),
                forecast_steps=self.forecast_steps,
                cfg=cfg,
                time_interval=cfg.dataset.sampling_interval,
                prediction_stage=True,
            )
        else:
            raise ValueError(f"unknown stage {stage!r}")

        ds = self.dataset
        self.num_common_features = ds.num_common_features
        self.num_in_features = ds.num_in_features
        self.num_out_features = ds.num_out_features
        self.output_name_order = ds.dyn_output_features
        self.lat, self.lon = ds.lat, ds.lon
        self.lat_size, self.lon_size = ds.lat_size, ds.lon_size
        self._setup_done[stage] = True
        log.info("dataset: %d input features, %d output features",
                 self.num_in_features, self.num_out_features)

    def train_dataloader(self) -> BatchLoader:
        return BatchLoader(self.dataset, self.batch_size, shuffle=True,
                           seed=int(self.cfg.init.get("seed") or 0), drop_last=True,
                           device=self.device)

    def val_dataloader(self) -> BatchLoader:
        return BatchLoader(self.val_dataset, self.batch_size, shuffle=False,
                           drop_last=True, device=self.device)

    def predict_dataloader(self) -> BatchLoader:
        return BatchLoader(self.dataset, self.batch_size, shuffle=False,
                           drop_last=False, device=self.device)
