"""The full train step at 1.40625° (128 × 256) on the card.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.bench_highres [--device cpu]
        [--nlat 128 --nlon 256] [--chain-short 2] [--chain-long 8] [--repeats 3]
        [--override key=value ...]

The port's counterpart of ``scripts/bench_highres.py``: the complete
training step (forward, backward, NorMuon + AdamW) of the flagship of
``configs/default.yaml`` (``tools/flagship.py``) on the 1.40625° grid,
computing in bfloat16 with float32 parameters, with gradient checkpointing
of the physics layers as the JAX script sets it (``--override
compute.gradient_checkpointing=false`` turns it off) and the row-banded
kernels (``compute.interp_band_rad=0.3``, as the smoke trains this grid); the
reversed Huber loss with every channel weighted 1 and one seeded batch from
``default_rng(0)``, as there.  The first step is untimed (its seconds
printed, where JAX prints its compile); then the chain slope ``(t(long) -
t(short)) / (long - short)`` of chains of steps, each chain ending in
``torch.cuda.synchronize()``, the least of ``--repeats``.  Prints one JSON
line: the JAX keys ``grid``, ``step_ms`` and ``samples_per_sec_per_chip``,
the launches of every interpolation kernel a step (the banded forward #5 16
times: 8 and 8 in the backward's replay; the banded backward #6 8), the
slopes, the losses, the card.  Without a card and without ``--device cpu``
it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from paradis_torch.config import load_config
from paradis_torch.tools.bench_forecast import chain_slope
from paradis_torch.tools.flagship import (HR_BAND, HR_GRID, device_of, device_record, flagship,
                                          plain_loss, sync, train_batch)

CHAIN_SHORT, CHAIN_LONG = 2, 8
REPEATS = 3
DEFAULTS = ["training.optimizer.name=normuon", "compute.gradient_checkpointing=true",
            *HR_BAND]


def train_setup(cfg, grid, device, batch_size: int = 1):
    """The scripts' train step of ``cfg``'s flagship on ``grid``: the model
    (dtype from ``compute.use_amp``), its optimizer and state, the step and
    one seeded batch; ``step()`` takes one step at the optimizer's constant
    learning rate (the scripts' step runs no schedule) and returns its
    metrics (on the device)."""
    from paradis_torch.train import build_optimizer, create_train_state, make_train_step

    model, d = flagship(cfg, grid, device, dtype=None)
    loss_fn = plain_loss(d["output_dim"], device)
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, loss_fn, cfg, optimizer)
    batch = train_batch(d, grid, int(cfg.model.forecast_steps), device, batch_size)

    def step():
        return train_step(state, batch, d["n_common"])

    return {"model": model, "optimizer": optimizer, "state": state, "loss_fn": loss_fn,
            "batch": batch, "dims": d, "step": step}


def time_step(call, device, short: int = CHAIN_SHORT, long: int = CHAIN_LONG,
              repeats: int = REPEATS) -> dict:
    """The protocol on ``call`` (one train step): the JAX script's
    ``step_ms`` and ``samples_per_sec_per_chip`` (batch 1) from the least
    chain slope, and ``chain_slope``'s record (the launches a step in
    ``launches_per_call``)."""
    timed = chain_slope(call, device, short, long, repeats)
    return {"step_ms": timed["best_s"] * 1e3, "samples_per_sec_per_chip": 1.0 / timed["best_s"],
            **timed}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlat", type=int, default=HR_GRID[0])
    ap.add_argument("--nlon", type=int, default=HR_GRID[1])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--chain-short", type=int, default=CHAIN_SHORT)
    ap.add_argument("--chain-long", type=int, default=CHAIN_LONG)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)
    device = device_of(args.device, "bench_highres")
    grid = (args.nlat, args.nlon)
    cfg = load_config(overrides=DEFAULTS + args.override)
    run = train_setup(cfg, grid, device)
    losses = []

    def call():
        losses.append(run["step"]()["loss"])

    t0 = time.perf_counter()
    call()
    sync(device)
    first_s = time.perf_counter() - t0
    timed = time_step(call, device, args.chain_short, args.chain_long, args.repeats)
    model = run["model"]
    res = {"grid": f"{grid[0]}x{grid[1]}", "step_ms": timed["step_ms"],
           "samples_per_sec_per_chip": timed["samples_per_sec_per_chip"],
           "dtype": str(model.dtype).removeprefix("torch."), "batch": 1,
           "gradient_checkpointing": model.gradient_checkpointing,
           "band_px": model.band_max_dy_pix, "optimizer": run["optimizer"].name,
           "overrides": args.override, "first_step_s": first_s,
           "slopes_ms": [s * 1e3 for s in timed["slopes_s"]], "chain": timed["chain"],
           "repeats": args.repeats, "launches_per_step": timed["launches_per_call"],
           "losses": [float(v) for v in losses], **device_record(device)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
