"""Serving-artifact throughput: a 40-step forecast from the exported programs.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.bench_artifact [--device cpu] [--grid 32,64]
        [--steps 40] [--repeats 3] [--ways rollout,steploop,inprocess]
        [--override key=value ...] [--artifact DIR]

The port's counterpart of ``scripts/bench_artifact.py``: the flagship of
``configs/default.yaml`` (with ``--override``s) at full width and depth,
seeded from ``init.seed``, float32, batch 1, ``--steps`` forecast steps with
``output_frequency`` 1, inputs drawn from ``default_rng(0)`` as there
(input, forcings, constants).  ``save_artifact`` exports it into a
temporary directory and ``load_artifact`` loads it back.  With
``--artifact``, an artifact that ``cli.export`` wrote (``output_frequency``
1) is loaded instead, and the in-process model is built from its
manifest's config and grid (equiangular, without the poles) with its
``params.npz``; ``--grid``, ``--steps`` and ``--override`` are then the
artifact's.  Three ways of producing the forecast, each called once (its
kernel launches counted), then ``--repeats`` rounds of one call each, the
ways' order reversed every other round (the host's speed drifts over a
run, so only turns compare the ways), each call ending in
``torch.cuda.synchronize()``:

- ``rollout``: one call of the artifact's scanned rollout (``rollout.pt2``);
- ``steploop``: ``--steps`` calls of the artifact's forward (``forward.pt2``)
  with the lag shift (``autoregress_next_input``) between them;
- ``inprocess``: the model's own ``make_forecast_rollout``.

Prints one JSON line: export seconds (each program's trace, and all of it
with the files written), load seconds, each file's bytes, steps/s of each
way (its median call), the first call's seconds, the kernel launches of one
call, the largest |output| of the in-process rollout and each artifact
way's largest gap to it, the card and the versions.  Without
``rollout`` among ``--ways`` the artifact has no rollout program.  It runs
on the card unless given ``--device cpu`` (the plain versions, host clock,
for the CPU test); without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time
from pathlib import Path

import torch

from paradis_torch.config import load_config
from paradis_torch.tools.bench_interp import launch_counts
from paradis_torch.tools.flagship import (GRID, device_of, device_record, dims,  # noqa: F401
                                          flagship, inputs)

STEPS = 40         # the 10-day forecast protocol: 40 × 6 h
WAYS = ("rollout", "steploop", "inprocess")


def artifact_config(manifest: dict):
    """The config an artifact was exported with (its manifest's YAML)."""
    import yaml

    from paradis_torch.config import default_config

    return default_config().merged_with(yaml.safe_load(manifest["config_yaml"])).resolved()


def step_loop(serving, batch: dict) -> torch.Tensor:
    """The forecast through ``forward.pt2`` a step at a time: the model-free
    serving loop, with the manifest's ``n_common`` / ``n_time``; returns the
    outputs stacked [B, S, H, W, C_out]."""
    from paradis_torch.forecast.rollout import autoregress_next_input

    n_common, n_time = serving.manifest["n_common"], serving.manifest["n_time"]
    dyn, forcings, constants = batch["input"], batch["forcings"], batch["constants"]
    outs = []
    with torch.inference_mode():
        for t in range(forcings.shape[1]):
            out = serving(torch.cat([dyn, forcings[:, t], constants], dim=-1))
            dyn = autoregress_next_input(dyn, out, n_common, n_time)
            outs.append(out)
        return torch.stack(outs, dim=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--grid", default=",".join(map(str, GRID)), help="nlat,nlon")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--repeats", type=int, default=3, help="timed rounds, one call a way each")
    ap.add_argument("--ways", default=",".join(WAYS), help=f"subset of {','.join(WAYS)}")
    ap.add_argument("--override", action="append", default=[],
                    help="config override (repeatable)")
    ap.add_argument("--artifact", default=None,
                    help="measure this artifact (written by cli.export) instead of exporting")
    args = ap.parse_args(argv)
    device = device_of(args.device, "bench_artifact")
    ways = tuple(args.ways.split(","))
    unknown = sorted(set(ways) - set(WAYS))
    if unknown or "inprocess" not in ways:
        raise ValueError(f"--ways must name inprocess and others of {list(WAYS)}; "
                         f"got {list(ways)}")
    from paradis_torch.forecast.export import load_artifact, save_artifact
    from paradis_torch.forecast.rollout import make_forecast_rollout

    if args.artifact is None:
        grid = tuple(int(n) for n in args.grid.split(","))
        steps = args.steps
        cfg = load_config(overrides=["compute.use_amp=false", *args.override])
        cfg.model.forecast_steps = steps
        cfg.forecast.output_frequency = 1
        model, d = flagship(cfg, grid, device)
        with tempfile.TemporaryDirectory(prefix="paradis-artifact-") as tmp:
            t0 = time.perf_counter()
            art = save_artifact(Path(tmp) / "art", model, cfg, batch_size=1, nlat=grid[0],
                                nlon=grid[1], input_dim=d["input_dim"],
                                output_dim=d["output_dim"], n_common=d["n_common"],
                                include_rollout="rollout" in ways)
            export_s = time.perf_counter() - t0
            sizes = {p.name: p.stat().st_size for p in sorted(art.iterdir())}
            t0 = time.perf_counter()
            serving = load_artifact(art, device)
            load_s = time.perf_counter() - t0
        export_seconds = dict(serving.manifest["export_seconds"], total=export_s)
    else:
        art = Path(args.artifact)
        sizes = {p.name: p.stat().st_size for p in sorted(art.iterdir())}
        t0 = time.perf_counter()
        serving = load_artifact(art, device)
        load_s = time.perf_counter() - t0
        m = serving.manifest
        if "rollout" in ways and not serving.has_rollout:
            raise ValueError(f"{art} has no rollout.pt2; leave rollout out of --ways")
        cfg = artifact_config(m)
        if int(cfg.forecast.output_frequency) != 1:
            raise ValueError(f"{art} stores every {cfg.forecast.output_frequency}th step; "
                             "export it with forecast.output_frequency=1")
        grid, steps = tuple(m["input_shape"][1:3]), int(cfg.model.forecast_steps)
        model, d = flagship(cfg, grid, device)
        model.load_state_dict(serving.params)
        export_seconds = m["export_seconds"]
    batch = inputs(d, grid, steps, device)

    rollout = make_forecast_rollout(model, cfg)
    calls = {"rollout": lambda: serving.rollout(batch["input"], batch["forcings"],
                                                batch["constants"]),
             "steploop": lambda: step_loop(serving, batch),
             "inprocess": lambda: rollout(batch, d["n_common"])}
    first, launches, outs = {}, {}, {}
    for way in ways:
        before = launch_counts()
        first[way], outs[way] = _timed(calls[way], device)
        launches[way] = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    seconds = {way: [] for way in ways}
    for i in range(args.repeats):
        for way in (ways if i % 2 == 0 else ways[::-1]):
            seconds[way].append(_timed(calls[way], device)[0])
    steps_per_s = {way: steps / statistics.median(seconds[way] or [first[way]])
                   for way in ways}
    for way in ways:
        print(f"{way:10s} {steps_per_s[way]:10.3f} steps/s", flush=True)
    ref = outs["inprocess"]
    res = {
        "grid": list(grid), "steps": steps, "batch": 1, "dtype": "float32",
        "artifact": args.artifact, "overrides": args.override,
        "n_params": sum(p.numel() for p in model.parameters()),
        "export_seconds": export_seconds, "rounds": args.repeats,
        "load_seconds": load_s, "file_bytes": sizes, "traced": serving.manifest["traced"],
        "steps_per_s": steps_per_s, "first_call_s": first, "call_seconds": seconds,
        "launches_per_call": launches,
        "max_abs_out": float(ref.abs().max()),
        "max_abs_gap": {way: float((outs[way] - ref).abs().max())
                        for way in ways if way != "inprocess"},
        "cuda_version": torch.version.cuda, **device_record(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
