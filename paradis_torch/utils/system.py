"""System setup: seeding, precision policy, device choice, run-dir hygiene.

The port's counterpart of ``paradis_tpu/utils/system.py`` (reference
``utils/system.py:12-43``): reproducible host seeds, the precision policy,
``compute.platform`` mapped to a device (the JAX package pins a JAX platform
instead), and refusing to clobber an existing experiment directory.
"""

from __future__ import annotations

import logging
import random
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger("paradis_torch")

_PLATFORMS = {"auto": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def platform_device(cfg) -> torch.device:
    """The device ``compute.platform`` names: ``auto``, ``gpu`` and ``cuda``
    give ``cuda``, ``cpu`` gives ``cpu``; any other platform (``tpu``, a JAX
    plugin name) raises."""
    platform = str(cfg.compute.get("platform", "auto") or "auto").lower()
    if platform not in _PLATFORMS:
        raise ValueError(f"compute.platform={platform!r}: paradis_torch runs on "
                         f"{' | '.join(_PLATFORMS)}")
    return torch.device(_PLATFORMS[platform])


def setup_system(cfg) -> None:
    seed = cfg.init.get("seed", None)
    if seed is not None:
        random.seed(int(seed))
        np.random.seed(int(seed) % 2**32)
        log.info("seeded host RNGs with %s", seed)

    platform_device(cfg)  # an unknown platform fails here, before any work

    # precision: float32 matmuls and convolutions stay float32 (no TF32) with
    # and without AMP; under AMP the model computes in bfloat16 itself
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # sanitizer analogue (SURVEY.md §5): trap NaNs in the backward
    if cfg.compute.get("debug_nans", False):
        torch.autograd.set_detect_anomaly(True)

    # steps/epochs sanity (reference utils/system.py:25-28)
    if int(cfg.training.max_steps) <= 0 and int(cfg.training.max_epochs) <= 0:
        raise ValueError("one of training.max_steps / training.max_epochs must be set")

    name = cfg.training.get("experiment_name")
    if name:
        exp_dir = Path(cfg.training.log_dir) / name
        if exp_dir.exists() and any(exp_dir.iterdir()) and not cfg.init.restart:
            raise FileExistsError(
                f"experiment dir {exp_dir} already exists; pick a new name or "
                f"set init.restart=true"
            )
