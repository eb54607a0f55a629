"""Export CLI: trained checkpoint -> serving artifact, as the JAX package's
``cli/export.py``:

    python -m paradis_torch.cli.export --config cfg.yaml \
        --checkpoint-path ckpt_dir --output-dir artifact/ [--batch-size 1]

The artifact (``forward.pt2``, ``rollout.pt2``, ``params.npz``,
``manifest.json``; see ``paradis_torch.forecast.export``) runs forecasts
without the model code.  It is traced in float32 (no TF32) on ``--device``
(``cuda`` by default, and raises without a card; ``--device cpu`` or
``compute.platform=cpu`` exports for the CPU) and serves on that kind of
device only: the JAX package's ``--platforms`` (lowering targets) becomes
``--device``.  The weights come from ``train.checkpoint.load_params`` (a
params file, a checkpoint directory or a checkpoints root).
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a serving artifact.")
    p.add_argument("--config", default=None, help="Path to config YAML")
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--output-dir", required=True, help="Artifact directory")
    p.add_argument("--root-dir", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default="cuda", help="device to trace and serve on")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None):
    """Write the artifact; returns its directory."""
    args = parse_args(argv)

    import torch

    from paradis_torch import resolve_device
    from paradis_torch.config import load_config
    from paradis_torch.utils.system import platform_device

    cfg = load_config(args.config, overrides=args.overrides)
    cfg.init.checkpoint_path = args.checkpoint_path
    if args.root_dir:
        cfg.dataset.root_dir = args.root_dir
    cfg.compute.use_amp = False  # serve in fp32, like the forecast CLI

    device = resolve_device(args.device)
    if platform_device(cfg).type == "cpu":
        device = torch.device("cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for and no CUDA device is available; "
                           "pass --device cpu (or compute.platform=cpu) to export for the CPU")
    # float32 matmuls and convolutions stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.forecast.export import save_artifact
    from paradis_torch.model.paradis import Paradis
    from paradis_torch.train.checkpoint import load_params

    dataset = ERA5Dataset(
        cfg.dataset.root_dir,
        cfg.training.dataset.start_date,
        cfg.training.dataset.end_date,
        forecast_steps=1,
        cfg=cfg,
    )
    model = Paradis.from_config(
        cfg, input_dim=dataset.num_in_features, output_dim=dataset.num_out_features,
        lat_deg=dataset.lat, lon_deg=dataset.lon, dtype=torch.float32, device=device,
    )
    load_params(args.checkpoint_path, model)

    out = save_artifact(
        args.output_dir, model, cfg,
        batch_size=args.batch_size,
        nlat=dataset.lat_size, nlon=dataset.lon_size,
        input_dim=dataset.num_in_features,
        output_dim=dataset.num_out_features,
        n_common=dataset.num_common_features,
        feature_names=list(dataset.dyn_output_features),
        device=device,
    )
    print(f"serving artifact written: {out}")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
