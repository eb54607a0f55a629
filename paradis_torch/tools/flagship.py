"""The flagship model of ``configs/default.yaml``, built one way for every tool.

The port's counterpart of ``__graft_entry__._flagship``: the configuration's
model (with the caller's overrides) at full width and depth on an
equiangular grid without the poles, seeded from ``init.seed``, and the
seeded random inputs the JAX package's scripts draw for it.  The tools of
``paradis_torch/tools`` and ``chip_smoke.py`` build their config-built
models here.

- ``dims(cfg)``: the feature counts (``n_common``, ``output_dim``,
  ``n_time``, ``n_forcings``, ``n_const``, ``input_dim``);
- ``flagship(cfg, grid, device, dtype)``: the model and its dims;
- ``inputs`` / ``train_batch``: a forecast's or a train step's batch from
  ``default_rng(0)``, in the order the scripts draw it;
- ``TINY``: the overrides of ``_flagship(tiny=True)`` (8 × 16 grid).
"""

from __future__ import annotations

import numpy as np
import torch

GRID = (32, 64)            # 5.625°
HR_GRID = (128, 256)       # 1.40625°
# the 1.40625° runs band the interpolation as the smoke serves and trains them
HR_BAND = ["compute.interp_band_rad=0.3"]
TINY_GRID = (8, 16)
TINY = ["model.latent_size=32", "model.velocity_vectors=8", "model.num_layers=2",
        "model.physblock.velocity_net.hidden_dim=16", "model.physblock.reaction.hidden_dim=16",
        "model.physblock.output_proj.hidden_dim=16", "model.bias_channels=2",
        "model.bias_rank=4"]


def dims(cfg) -> dict:
    """The flagship's feature counts under ``cfg``."""
    f = cfg.features
    n_levels = len(f.pressure_levels)
    n_time = int(cfg.dataset.n_time_inputs)
    d = dict(n_common=len(f.input.atmospheric) * n_levels + len(f.input.surface),
             output_dim=len(f.output.atmospheric) * n_levels + len(f.output.surface),
             n_time=n_time, n_forcings=len(f.input.forcings), n_const=len(f.input.constants))
    d["input_dim"] = (d["n_common"] + d["n_forcings"]) * n_time + d["n_const"]
    return d


def flagship(cfg, grid, device, dtype: torch.dtype | None = torch.float32,
             seed: int | None = None):
    """The flagship of ``cfg`` on the equiangular ``grid`` (without the
    poles) on ``device``, seeded from ``seed`` (``init.seed`` when None), and
    its dims.  ``dtype`` None computes in bfloat16 under ``compute.use_amp``
    (float32 parameters), else float32."""
    from paradis_torch.model import Paradis
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    d = dims(cfg)
    lat, lon = equiangular_lat_lon(*grid, include_poles=False)
    model = Paradis.from_config(cfg, input_dim=d["input_dim"], output_dim=d["output_dim"],
                                lat_deg=lat, lon_deg=lon, dtype=dtype, seed=seed,
                                device=device)
    return model, d


def for_dataset(cfg, ds, device, dtype: torch.dtype | None = None, seed: int | None = None):
    """The flagship of ``cfg`` on the grid and features of the dataset
    ``ds`` (its latitudes and longitudes, as ``cli.train`` builds it)."""
    from paradis_torch.model import Paradis

    return Paradis.from_config(cfg, input_dim=ds.num_in_features,
                               output_dim=ds.num_out_features, lat_deg=ds.lat, lon_deg=ds.lon,
                               dtype=dtype, seed=seed, device=device)


def _draw(shapes: dict, device) -> dict:
    rng = np.random.default_rng(0)
    return {k: torch.tensor(rng.normal(size=s), dtype=torch.float32, device=device)
            for k, s in shapes.items()}


def inputs(d: dict, grid, steps: int, device, batch: int = 1) -> dict:
    """``input``, ``forcings``, ``constants`` drawn from ``default_rng(0)`` in
    that order, as ``scripts/bench_forecast.py`` and
    ``scripts/bench_artifact.py`` draw them."""
    H, W = grid
    return _draw({"input": (batch, H, W, d["n_common"] * d["n_time"]),
                  "forcings": (batch, steps, H, W, d["n_forcings"] * d["n_time"]),
                  "constants": (batch, H, W, d["n_const"])}, device)


def train_batch(d: dict, grid, S: int, device, batch: int = 1) -> dict:
    """``input``, ``target``, ``forcings``, ``constants`` drawn from
    ``default_rng(0)`` in that order, as ``scripts/bench_highres.py`` and
    ``scripts/profile_step.py`` draw them."""
    H, W = grid
    return _draw({"input": (batch, H, W, d["n_common"] * d["n_time"]),
                  "target": (batch, S, H, W, d["output_dim"]),
                  "forcings": (batch, S, H, W, d["n_forcings"] * d["n_time"]),
                  "constants": (batch, H, W, d["n_const"])}, device)


def plain_loss(n_out: int, device, kind: str = "reversed_huber"):
    """The scripts' loss: ``kind`` with every one of ``n_out`` channels
    weighted 1 and no latitude weights."""
    from paradis_torch.train import WeightedLoss

    return WeightedLoss(kind=kind, feature_weights=torch.ones(n_out, device=device),
                        lat_weights=None)


def device_of(name, tool: str) -> torch.device:
    """The device a tool runs on: ``cuda`` unless ``--device`` names another;
    raises where that is a card and none is available."""
    from paradis_torch import resolve_device

    device = resolve_device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool} runs on a CUDA device and none is available; "
                           "pass --device cpu to run on the CPU")
    if device.type == "cuda":
        # float32 matmuls and convolutions stay float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_record(device) -> dict:
    """``device`` and ``card`` keys of a tool's JSON line: the platform and
    kind, and the card's name and power limit (``nvidia-smi``)."""
    from paradis_torch.tools.bench_interp import card_line

    cuda = torch.device(device).type == "cuda"
    return {"device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu"},
            "card": card_line() if cuda else None, "torch_version": torch.__version__}
