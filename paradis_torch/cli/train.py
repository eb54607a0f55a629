"""Training CLI: ``python -m paradis_torch.cli.train [--config X] [--device cuda] key.path=value ...``

Hydra-style dotted overrides over the built-in defaults (reference
``train.py:17-77``), as the JAX package's ``cli/train.py``.  Example:

    python -m paradis_torch.cli.train dataset.root_dir=/data/era5 \
        training.max_steps=1000 compute.batch_size=2

Trains on ``--device`` (``cuda`` by default, and raises without a card);
``--device cpu`` or ``compute.platform=cpu`` trains on the CPU.

Data parallel over several GPUs, one process each, under the launcher:

    python -m torch.distributed.run --nproc-per-node 2 -m paradis_torch.cli.train \
        compute.num_devices=2 dataset.root_dir=/data/era5 ...

Each rank trains on ``cuda:LOCAL_RANK``; ``compute.fsdp=true`` shards the
parameters and the optimizer state, ``compute.dist_backend`` picks the
backend (``auto``: NCCL on cards, gloo on the CPU; ranks sharing one card
need ``gloo``).  ``--device cpu`` runs the ranks on the CPU over gloo.

Over the spatial axes of the JAX mesh, each rank on a block of the grid
(``compute.num_devices × lat_devices × spatial_devices`` ranks, the data
size 1 here):

    python -m torch.distributed.run --nproc-per-node 4 -m paradis_torch.cli.train \
        compute.lat_devices=2 compute.spatial_devices=2 compute.dist_backend=gloo ...

and with ``compute.fsdp=true`` the parameters and the optimizer state
sharded over the data ranks of each spatial position (here ``data 2 × lat
2``; the sharded checkpoints written by the ``l = s = 0`` ranks):

    python -m torch.distributed.run --nproc-per-node 4 -m paradis_torch.cli.train \
        compute.fsdp=true compute.lat_devices=2 compute.dist_backend=gloo ...
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
    from paradis_torch.distributed import barrier, initialize_distributed, shutdown_distributed
    from paradis_torch.train.loop import Trainer
    from paradis_torch.utils.system import platform_device, setup_system

    cfg = load_config(args.config, overrides=args.overrides)
    device = resolve_device(args.device)
    if platform_device(cfg).type == "cpu":
        device = torch.device("cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for and no CUDA device is available; "
                           "pass --device cpu (or compute.platform=cpu) to train on the CPU")

    # the process group before the Trainer (reference multi-node DDP,
    # train.py:44-49): a no-op for one process started without the launcher
    ranks = initialize_distributed(cfg, device)
    try:
        setup_system(cfg)
        barrier()  # every rank has checked the experiment directory before any writes
        log_dir = cfg.training.log_dir
        if cfg.training.get("experiment_name"):
            log_dir = f"{log_dir}/{cfg.training.experiment_name}"
        trainer = Trainer(cfg, log_dir=log_dir, device=ranks.device)
        result = trainer.fit()
    finally:
        shutdown_distributed()
    print(f"training done: {result}" if ranks.world == 1
          else f"training done (rank {ranks.rank} of {ranks.world}): {result}")
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
