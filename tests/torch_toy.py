"""The port's toy store and config, without JAX: the counterparts of
``tests/fixtures.py``'s ``build_toy_store`` and ``toy_config``, built with
``paradis_torch``'s own copies of the synthetic store and the preprocessor.

The same seed, grid, levels and times as the JAX fixture, so the store is
the same bytes on disk; the config is the port's (``paradis_torch.config``)
with the same toy overrides.  ``tests/torch_parity.py`` re-exports both;
the ``gpu`` tests import this module directly (it needs no JAX).
"""

from __future__ import annotations

from pathlib import Path

from paradis_torch.config import default_config
from paradis_torch.data.preprocess import preprocess
from paradis_torch.data.synthetic import build_raw_store

TOY_NLAT, TOY_NLON = 8, 16
TOY_LEVELS = (500, 850, 1000)
TOY_TIMES = 30  # 2000-01-01 .. 2000-01-08T06, 6-hourly


def build_torch_toy_store(base: Path) -> Path:
    """Raw + preprocessed synthetic stores under ``base``, built by the port;
    returns the preprocessed root."""
    raw = base / "raw"
    out = base / "store"
    if not (out / "stats").exists():
        build_raw_store(str(raw), nlat=TOY_NLAT, nlon=TOY_NLON, n_times=TOY_TIMES,
                        levels=TOY_LEVELS, start="2000-01-01T00:00:00", seed=7)
        preprocess(str(raw), str(out), toa_time_stride=6)
    return out


def torch_toy_config(root_dir: Path, **overrides):
    """The port's config matching the toy store (3 levels, small model), as
    ``fixtures.toy_config`` builds the JAX package's."""
    cfg = default_config()
    cfg.dataset.root_dir = str(root_dir)
    cfg.features.pressure_levels = list(TOY_LEVELS)
    cfg.model.latent_size = 16
    cfg.model.velocity_vectors = 4
    cfg.model.num_layers = 2
    cfg.model.bias_channels = 2
    cfg.model.bias_rank = 4
    cfg.model.physblock.velocity_net.hidden_dim = 8
    cfg.model.physblock.reaction.hidden_dim = 8
    cfg.model.physblock.output_proj.hidden_dim = 8
    cfg.training.dataset.start_date = "2000-01-01"
    cfg.training.dataset.end_date = "2000-01-05"
    cfg.training.validation_dataset.start_date = "2000-01-06"
    cfg.training.validation_dataset.end_date = "2000-01-07"
    cfg.training.max_steps = 4
    cfg.training.log_every_n_steps = 1
    cfg.training.scheduler.wsd.warmup = 1
    cfg.training.scheduler.wsd.decay = 1
    cfg.compute.use_amp = False
    for k, v in overrides.items():
        cfg.set_path(k, v)
    return cfg.resolved()
