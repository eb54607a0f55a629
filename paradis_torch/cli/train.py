"""Training CLI: ``python -m paradis_torch.cli.train [--config X] [--device cuda] key.path=value ...``

Hydra-style dotted overrides over the built-in defaults (reference
``train.py:17-77``), as the JAX package's ``cli/train.py``.  Example:

    python -m paradis_torch.cli.train dataset.root_dir=/data/era5 \
        training.max_steps=1000 compute.batch_size=2

Trains on ``--device`` (``cuda`` by default, and raises without a card);
``--device cpu`` or ``compute.platform=cpu`` trains on the CPU.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the PARADIS model with PyTorch.")
    parser.add_argument("--config", default=None, help="optional YAML config")
    parser.add_argument("--device", default="cuda", help="device to train on")
    parser.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = parser.parse_args(argv)

    import torch

    from paradis_torch import resolve_device
    from paradis_torch.config import load_config
    from paradis_torch.train.loop import Trainer
    from paradis_torch.utils.system import platform_device, setup_system

    cfg = load_config(args.config, overrides=args.overrides)
    setup_system(cfg)
    device = resolve_device(args.device)
    if platform_device(cfg).type == "cpu":
        device = torch.device("cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for and no CUDA device is available; "
                           "pass --device cpu (or compute.platform=cpu) to train on the CPU")

    log_dir = cfg.training.log_dir
    if cfg.training.get("experiment_name"):
        log_dir = f"{log_dir}/{cfg.training.experiment_name}"
    trainer = Trainer(cfg, log_dir=log_dir, device=device)
    result = trainer.fit()
    print(f"training done: {result}")
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
