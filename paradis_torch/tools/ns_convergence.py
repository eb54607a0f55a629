"""NorMuon Newton–Schulz step-count convergence A/B (5 against 3 iterations).

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.ns_convergence [--steps 300] [--seeds 2] [--device cpu]

The port's counterpart of ``scripts/ns_convergence.py``: a 3-step quintic
Newton–Schulz would cut ~2/5 of NorMuon's FLOPs but changes the optimizer
against the reference's 5, so it is convergence-gated: the same tiny model
(``toy_config``: 3 levels, latent 32, 8 velocity vectors, 2 layers, float32)
trains from the same seed on the same synthetic 8 × 16 store (80 six-hourly
times, ``build_store``) with both settings, and the loss trajectories are
compared.  On the card unless given ``--device cpu`` (the JAX script pins
the CPU); without a card and without ``--device cpu`` it raises.  Prints one
JSON line a seed with the JAX script's keys, then their mean gap.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from paradis_torch.tools.flagship import device_of, for_dataset, plain_loss

TOY_LEVELS = (500, 850, 1000)


def build_store(tmp: Path, codecs=("lz4",)) -> dict:
    """The scripts' synthetic raw store (8 × 16, 80 times, 3 levels) and a
    preprocessed store a codec (``toa_time_stride=20``): ``{codec: root}``."""
    from paradis_torch.data.preprocess import preprocess
    from paradis_torch.data.synthetic import build_raw_store

    build_raw_store(str(tmp / "raw"), nlat=8, nlon=16, n_times=80, levels=TOY_LEVELS)
    out = {}
    for codec in codecs:
        out[codec] = tmp / f"store_{codec}"
        preprocess(str(tmp / "raw"), str(out[codec]), toa_time_stride=20, codec=codec)
    return out


def toy_config(**optimizer):
    """The scripts' tiny model over ``configs/default.yaml``, with the
    optimizer settings ``optimizer`` (name, lr, ns_steps)."""
    from paradis_torch.config import default_config

    cfg = default_config().resolved()
    cfg.features.pressure_levels = list(TOY_LEVELS)
    cfg.model.latent_size = 32
    cfg.model.velocity_vectors = 8
    cfg.model.num_layers = 2
    cfg.model.physblock.velocity_net.hidden_dim = 16
    cfg.model.physblock.reaction.hidden_dim = 16
    cfg.model.physblock.output_proj.hidden_dim = 16
    cfg.model.bias_channels = 2
    cfg.model.bias_rank = 4
    for key, value in optimizer.items():
        cfg.training.optimizer[key] = value
    return cfg


def toy_train(store: Path, steps: int, cfg, seed: int = 0, device=None,
              init=None) -> np.ndarray:
    """``steps`` train steps of ``cfg``'s model (float32, seeded from
    ``seed``; ``init(model)`` then sets its weights where given) on the
    store's samples from 2000-01-01 in the loader's seeded order, batch 1,
    the MSE loss with every channel weighted 1, at the optimizer's constant
    learning rate (the scripts' step runs no schedule); each step's loss."""
    import torch

    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import BatchLoader
    from paradis_torch.train import build_optimizer, create_train_state, make_train_step

    ds = ERA5Dataset(str(store), "2000-01-01", None, forecast_steps=1, cfg=cfg)
    loader = BatchLoader(ds, batch_size=1, shuffle=True, seed=seed, device=device)
    model = for_dataset(cfg, ds, device, dtype=torch.float32, seed=seed)
    if init is not None:
        init(model)
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, plain_loss(ds.num_out_features, device, kind="mse"), cfg, opt)
    state = create_train_state(model, opt)

    losses = []
    it = iter(loader)
    for _ in range(steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        m = step(state, batch, ds.num_dyn_inputs_single)
        losses.append(m["loss"])
    return np.asarray([float(v) for v in losses])


def _train(store: Path, steps: int, ns_steps: int, seed: int = 0, device=None,
           init=None) -> np.ndarray:
    return toy_train(store, steps, toy_config(name="normuon", lr=5e-4, ns_steps=ns_steps),
                     seed, device, init)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_of(args.device, "ns_convergence")

    out = []
    with tempfile.TemporaryDirectory(prefix="ns_ab_") as tmp:
        store = build_store(Path(tmp))["lz4"]
        for seed in range(args.seeds):
            l5 = _train(store, args.steps, ns_steps=5, seed=seed, device=device)
            l3 = _train(store, args.steps, ns_steps=3, seed=seed, device=device)
            tail = slice(args.steps // 2, None)
            out.append({
                "seed": seed,
                "final_5": float(l5[-1]),
                "final_3": float(l3[-1]),
                "tail_mean_5": float(l5[tail].mean()),
                "tail_mean_3": float(l3[tail].mean()),
                "tail_rel_gap": float((l3[tail].mean() - l5[tail].mean())
                                      / max(abs(l5[tail].mean()), 1e-9)),
                "losses_5": l5.tolist(), "losses_3": l3.tolist(),
            })
            print(json.dumps(out[-1]), flush=True)
    gaps = [o["tail_rel_gap"] for o in out]
    print(json.dumps({"mean_tail_rel_gap": float(np.mean(gaps)), "steps": args.steps,
                      "device": str(device)}), flush=True)
    return out


if __name__ == "__main__":
    main()
