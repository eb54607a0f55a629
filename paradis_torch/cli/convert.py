"""Checkpoint-migration CLI: reference torch ``.ckpt`` → the port's params file.

    python -m paradis_torch.cli.convert --ckpt ref.ckpt --out params.pt \
        --nlat 32 --nlon 64 [--config cfg.yaml] [--device cuda] [overrides...]

Builds the configured model on ``--device`` (``cuda`` by default; ``cpu``
runs it without a card), fills it from the reference checkpoint
(``train/convert.py``) and writes a params file that
``paradis_torch.train.checkpoint.load_params`` reads.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert a reference torch checkpoint.")
    p.add_argument("--ckpt", required=True, help="reference .ckpt / state_dict")
    p.add_argument("--out", required=True, help="output params file")
    p.add_argument("--config", default=None)
    p.add_argument("--nlat", type=int, required=True)
    p.add_argument("--nlon", type=int, required=True)
    p.add_argument("--input-dim", type=int, default=None,
                   help="model input channels (default: derived from config)")
    p.add_argument("--output-dim", type=int, default=None)
    p.add_argument("--device", default="cuda", help="device to build the model on")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    import torch

    from paradis_torch import resolve_device
    from paradis_torch.config import load_config
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon
    from paradis_torch.train.checkpoint import save_params
    from paradis_torch.train.convert import convert_torch_checkpoint

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for and no CUDA device is available; "
                           "pass --device cpu to convert on the CPU")
    cfg = load_config(args.config, overrides=args.overrides)
    n_levels = len(cfg.features.pressure_levels)
    n_common = (len(cfg.features.input.atmospheric) * n_levels
                + len(cfg.features.input.surface))
    n_time = int(cfg.dataset.n_time_inputs)
    input_dim = args.input_dim or (
        n_common * n_time
        + len(cfg.features.input.forcings) * n_time
        + len(cfg.features.input.constants)
    )
    output_dim = args.output_dim or (
        len(cfg.features.output.atmospheric) * n_levels
        + len(cfg.features.output.surface)
    )

    lat, lon = equiangular_lat_lon(args.nlat, args.nlon, include_poles=False)
    model = Paradis.from_config(cfg, input_dim=input_dim, output_dim=output_dim,
                                lat_deg=lat, lon_deg=lon, dtype=torch.float32, device=device)
    model.load_state_dict(convert_torch_checkpoint(args.ckpt, model))
    save_params(args.out, model)
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.ckpt} -> {args.out} ({n:,} parameters)")


if __name__ == "__main__":
    main()
