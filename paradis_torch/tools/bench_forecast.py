"""Inference throughput: the flagship's 40-step forecast rollout on the card.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.bench_forecast [--nlat 128 --nlon 256]
        [--device cpu] [--dtype float32|bfloat16] [--steps 40]
        [--chain-short 2] [--chain-long 10] [--repeats 3] [--override key=value ...]

The port's counterpart of ``scripts/bench_forecast.py``: model steps/s (6 h
of simulated weather a step) of ``make_forecast_rollout`` at batch 1, the
flagship of ``configs/default.yaml`` (``tools/flagship.py``) on the 5.625°
grid, or with ``--nlat/--nlon`` on another (the 1.40625° run with
``compute.interp_band_rad=0.3``, the banded kernels, as the smoke serves
it), inputs drawn from ``default_rng(0)`` as there.  float32 by default, as
``cli/forecast.py`` serves; ``--dtype bfloat16`` computes in bfloat16.

The JAX script's protocol: one rollout untimed (its seconds printed, where
JAX prints its compile), then the chain slope ``(t(long) - t(short)) /
(long - short)`` of chains of rollouts, each chain ending in
``torch.cuda.synchronize()``, the least of ``--repeats``.  With
``--chain-short 0 --chain-long 1 --repeats 1`` one timed rollout.  Prints
one JSON line: the JAX keys ``forecast_steps_per_sec``,
``ms_per_model_step``, ``ten_day_forecast_sec``, ``simulated_days_per_sec``
(unrounded), the launches of every interpolation kernel a rollout (the
unbanded forward #1, 8 a step at 5.625°, or the banded #5 at 1.40625°), the
slopes, the first rollout's seconds, the card.  Without a card and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from paradis_torch.config import load_config
from paradis_torch.tools.bench_interp import launch_counts
from paradis_torch.tools.flagship import (GRID, HR_BAND, device_of, device_record, flagship,
                                          inputs, sync)

STEPS = 40       # the reference forecast protocol: 40 x 6 h = 10 days
CHAIN_SHORT, CHAIN_LONG = 2, 10
REPEATS = 3


def _chain(call, n: int, device) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    sync(device)
    return time.perf_counter() - t0


def chain_slope(call, device, short: int, long: int, repeats: int) -> dict:
    """The least chain slope of ``call`` over ``repeats`` (a chain of
    ``short`` calls, then one of ``long``, each ending in a synchronize):
    ``best_s``, every repeat's ``slopes_s``, and the launches of each
    interpolation kernel a call over them all (``launches_per_call``, the
    kernels that ran)."""
    if not 0 <= short < long or repeats < 1:
        raise ValueError(f"chains need 0 <= short < long and repeats >= 1; got {short}, "
                         f"{long}, {repeats}")
    before = launch_counts()
    slopes = []
    for _ in range(repeats):
        ts = _chain(call, short, device)
        tl = _chain(call, long, device)
        slopes.append((tl - ts) / (long - short))
    calls = repeats * (short + long)
    launched = {k: (n - before[k]) / calls for k, n in launch_counts().items() if n != before[k]}
    return {"best_s": min(slopes), "slopes_s": slopes, "launches_per_call": launched,
            "chain": [short, long], "repeats": repeats}


def time_rollout(call, device, steps: int, short: int = CHAIN_SHORT, long: int = CHAIN_LONG,
                 repeats: int = REPEATS) -> dict:
    """The protocol on ``call`` (one rollout of ``steps`` steps): the JAX
    script's keys from the least chain slope, and ``chain_slope``'s record
    (the launches a rollout in ``launches_per_call``)."""
    timed = chain_slope(call, device, short, long, repeats)
    seconds = timed["best_s"]
    return {"forecast_steps_per_sec": steps / seconds,
            "ms_per_model_step": seconds * 1e3 / steps,
            "ten_day_forecast_sec": seconds,
            "simulated_days_per_sec": steps * 0.25 / seconds, **timed}


def main(argv=None) -> dict:
    from paradis_torch.forecast.rollout import make_forecast_rollout

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlat", type=int, default=None)
    ap.add_argument("--nlon", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--chain-short", type=int, default=CHAIN_SHORT)
    ap.add_argument("--chain-long", type=int, default=CHAIN_LONG)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)
    device = device_of(args.device, "bench_forecast")
    grid = (args.nlat, args.nlon) if args.nlat else GRID
    cfg = load_config(overrides=(HR_BAND if args.nlat else []) + args.override)
    cfg.model.forecast_steps = args.steps
    cfg.forecast.output_frequency = 1
    model, d = flagship(cfg, grid, device, dtype=getattr(torch, args.dtype))
    batch = inputs(d, grid, args.steps, device)
    rollout = make_forecast_rollout(model, cfg)

    def call():
        return rollout(batch, d["n_common"])

    t0 = time.perf_counter()
    out = call()
    sync(device)
    first_s = time.perf_counter() - t0
    res = time_rollout(call, device, args.steps, args.chain_short, args.chain_long,
                       args.repeats)
    res["launches_per_rollout"] = res.pop("launches_per_call")
    del res["best_s"]
    res.update(grid=list(grid), dtype=args.dtype, steps=args.steps, batch=1,
               band_px=model.band_max_dy_pix, overrides=args.override,
               first_rollout_s=first_s, finite=bool(torch.isfinite(out).all()),
               **device_record(device))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
