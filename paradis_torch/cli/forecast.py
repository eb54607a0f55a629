"""Forecast CLI (reference ``forecast.py:13-118``), as the JAX package's
``cli/forecast.py``:

    python -m paradis_torch.cli.forecast --config cfg.yaml \
        --checkpoint-path ckpt_dir --output-file out.zarr \
        --forecast-steps 40 --sampling-interval 36h --start-date 2020-01-01

Forecasts in float32 on ``--device`` (``cuda`` by default, and raises
without a card); ``--device cpu`` or ``compute.platform=cpu`` forecasts on
the CPU.  The weights come from ``train.checkpoint.load_params`` (a params
file, a checkpoint directory, a sharded checkpoint of an FSDP run, or a
checkpoints root).

Over several GPUs, one process each, under the launcher:

    python -m torch.distributed.run --nproc-per-node 2 -m paradis_torch.cli.forecast \
        --num-devices 2 --checkpoint-path ckpt_dir --output-file out.zarr ...

Each rank forecasts its contiguous share of the init times on
``cuda:LOCAL_RANK`` into the one store (``run_forecast``);
``--num-devices`` × ``compute.lat_devices`` × ``compute.spatial_devices``
must equal the launched world size.  Over the spatial axes each rank rolls
out its block of the grid, as the JAX mesh splits it:

    python -m torch.distributed.run --nproc-per-node 2 -m paradis_torch.cli.forecast \
        --num-devices 1 compute.lat_devices=2 --checkpoint-path ckpt_dir ...
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
                   help="data-parallel devices: the launched world size")
    p.add_argument("--write-every-n", type=int, default=10)
    p.add_argument("--device", default="cuda", help="device to forecast on")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the forecast; returns ``run_forecast``'s seconds and counts."""
    args = parse_args(argv)

    import torch

    from paradis_torch import resolve_device
    from paradis_torch.config import load_config
    from paradis_torch.distributed import initialize_distributed, rank_grid, shutdown_distributed
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

    ranks = initialize_distributed(cfg, device)
    try:
        # the launched world against --num-devices and the config, before any file
        spatial = int(cfg.compute.get("lat_devices", 1) or 1) * int(
            cfg.compute.get("spatial_devices", 1) or 1)
        if args.num_devices * spatial != ranks.world:
            raise ValueError(
                f"--num-devices {args.num_devices} × {spatial} spatial rank(s), but "
                f"{ranks.world} process(es) were launched: a multi-GPU forecast launches one "
                f"process per device (python -m torch.distributed.run --nproc-per-node N)")
        stats = _forecast(cfg, args, ranks, rank_grid(cfg))
    finally:
        shutdown_distributed()
    if ranks.rank == 0:
        print(f"forecast written: {args.output_file}")
    return stats


def _forecast(cfg, args, ranks, grid) -> dict:
    """This rank's share of the forecast (its data rank's init times, its
    block of the grid), on its device."""
    import torch

    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import BatchLoader
    from paradis_torch.distributed import contiguous_share
    from paradis_torch.forecast.rollout import DatasetShare, run_forecast
    from paradis_torch.forecast.writer import ZarrForecastWriter
    from paradis_torch.model.paradis import Paradis
    from paradis_torch.train.checkpoint import load_params

    device = ranks.device
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
    share = DatasetShare(dataset, *contiguous_share(len(dataset), grid.d, grid.data))
    block = (None if grid.spatial == 1 else
             (grid.rows(dataset.lat_size), grid.cols(dataset.lon_size)))
    loader = BatchLoader(share, args.batch_size, shuffle=False, drop_last=False,
                         device=device, block=block)
    return run_forecast(model, dataset, cfg, writer, loader)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
