"""Forecast CLI (reference ``forecast.py:13-118``), as the JAX package's
``cli/forecast.py``:

    python -m paradis_torch.cli.forecast --config cfg.yaml \
        --checkpoint-path ckpt_dir --output-file out.zarr \
        --forecast-steps 40 --sampling-interval 36h --start-date 2020-01-01

Forecasts in float32 on ``--device`` (``cuda`` by default, and raises
without a card); ``--device cpu`` or ``compute.platform=cpu`` forecasts on
the CPU.  The weights come from ``train.checkpoint.load_params`` (a params
file, a checkpoint directory or a checkpoints root).  One device only:
``--num-devices`` above 1 raises (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run forecasts with a trained model.")
    p.add_argument("--config", default=None, help="Path to config YAML")
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--output-file", required=True, help="Output zarr path")
    p.add_argument("--root-dir", default=None)
    p.add_argument("--forecast-steps", type=int, default=40)
    p.add_argument("--sampling-interval", type=str, default="36h")
    p.add_argument("--start-date", type=str, default=None)
    p.add_argument("--end-date", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-devices", type=int, default=1,
                   help="devices for the forecast rollout (one: multi-GPU is not ported)")
    p.add_argument("--write-every-n", type=int, default=10)
    p.add_argument("--device", default="cuda", help="device to forecast on")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the forecast; returns ``run_forecast``'s seconds and counts."""
    args = parse_args(argv)
    if args.num_devices > 1:
        raise NotImplementedError(
            f"--num-devices {args.num_devices}: paradis_torch forecasts on one device; "
            f"multi-GPU runs are not ported yet (ROADMAP.md, Queue 1 item 8)")

    import torch

    from paradis_torch import resolve_device
    from paradis_torch.config import load_config
    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import BatchLoader
    from paradis_torch.forecast.rollout import run_forecast
    from paradis_torch.forecast.writer import ZarrForecastWriter
    from paradis_torch.model.paradis import Paradis
    from paradis_torch.train.checkpoint import load_params
    from paradis_torch.utils.system import platform_device

    cfg = load_config(args.config, overrides=args.overrides)
    cfg.forecast.enable = True
    cfg.init.checkpoint_path = args.checkpoint_path
    cfg.forecast.output_file = args.output_file
    if args.root_dir:
        cfg.dataset.root_dir = args.root_dir
    cfg.model.forecast_steps = args.forecast_steps
    cfg.dataset.sampling_interval = args.sampling_interval
    if args.start_date:
        cfg.forecast.start_date = args.start_date
    if args.end_date:
        cfg.forecast.end_date = args.end_date
    cfg.forecast.write_every_n = args.write_every_n
    cfg.compute.batch_size = args.batch_size
    cfg.compute.use_amp = False  # forecast in fp32 (reference forecast.py:85)

    device = resolve_device(args.device)
    if platform_device(cfg).type == "cpu":
        device = torch.device("cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for and no CUDA device is available; "
                           "pass --device cpu (or compute.platform=cpu) to forecast on the CPU")
    # float32 matmuls and convolutions stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dataset = ERA5Dataset(
        cfg.dataset.root_dir,
        cfg.forecast.start_date,
        cfg.forecast.end_date,
        forecast_steps=int(cfg.model.forecast_steps),
        cfg=cfg,
        time_interval=cfg.dataset.sampling_interval,
        prediction_stage=True,
    )
    model = Paradis.from_config(
        cfg, input_dim=dataset.num_in_features, output_dim=dataset.num_out_features,
        lat_deg=dataset.lat, lon_deg=dataset.lon, dtype=torch.float32, device=device,
    )
    load_params(args.checkpoint_path, model)

    writer = ZarrForecastWriter(cfg, dataset)
    loader = BatchLoader(dataset, args.batch_size, shuffle=False, drop_last=False,
                         device=device)
    stats = run_forecast(model, dataset, cfg, writer, loader)
    print(f"forecast written: {args.output_file}")
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
