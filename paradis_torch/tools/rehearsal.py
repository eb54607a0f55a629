"""Full-dress rehearsal of the production loop on the card.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.rehearsal --workdir DIR [--steps 3000] [--times N]
        [--highres] [--skip-data] [--skip-train] [--device cpu] [--nlat N --nlon M]
        [--override key=value ...]

The port's counterpart of ``scripts/rehearsal.py``, the complete loop at
flagship size through the port's CLIs, each in its own process:

1. a synthetic WB2-shaped raw store (5.625°: 32 × 64, 13 levels, ~14 months
   of six-hourly states, the train year and a held-out window;
   ``--highres``: 128 × 256, 400 states, 100 days),
   ``python -m paradis_torch.data.synthetic``;
2. ``python -m paradis_torch.cli.preprocess`` to the training layout;
3. ``python -m paradis_torch.cli.train`` (NorMuon, WSD, bf16) in two
   segments, the second resumed with ``init.restart=true`` from the first's
   checkpoints (``--highres``: gradient checkpointing and the row-banded
   kernels, ``compute.interp_band_rad=0.3``);
4. ``python -m paradis_torch.cli.forecast``, the reference protocol (40
   steps of 6 h, an init every 36 h) over the held-out window, from the
   last checkpoint;
5. ``forecast.evaluate.evaluate_store``: Z500 and T850 latitude-weighted
   RMSE at 24, 72 and 120 h against the held-out truth.

Writes ``rehearsal_summary.json`` in ``--workdir`` (the seconds of each
step, train samples/s from ``metrics.csv``, the scores).  The
``--override``s go to ``cli.train`` and ``cli.forecast`` after the script's
own (a toy model for a test); the store's levels follow
``features.pressure_levels`` where an override sets them.  Every process
runs on ``--device`` (``cuda`` unless given); ``--nlat/--nlon`` set the
store's grid.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
LEVELS_13 = [50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000]


def sh(cmd: list, **kw) -> float:
    print("+", " ".join(map(str, cmd)), flush=True)
    t0 = time.perf_counter()
    subprocess.run([str(c) for c in cmd], check=True, cwd=REPO, **kw)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--times", type=int, default=None,
                    help="6-hourly states (default ~14 months; 400 highres)")
    ap.add_argument("--highres", action="store_true",
                    help="1.40625° (128x256) variant: shorter window, "
                    "gradient checkpointing, the row-banded kernels")
    ap.add_argument("--skip-data", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--nlat", type=int, default=None, help="store grid (default by --highres)")
    ap.add_argument("--nlon", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="device of every step")
    ap.add_argument("--override", action="append", default=[],
                    help="cli.train / cli.forecast override key=value (repeatable)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        from paradis_torch.tools.flagship import device_of

        device_of(args.device, "rehearsal")

    nlat, nlon = (128, 256) if args.highres else (32, 64)
    if args.nlat:
        nlat, nlon = args.nlat, args.nlon
    steps = args.steps if args.steps is not None else (300 if args.highres else 3000)
    times = args.times if args.times is not None else (400 if args.highres else 1700)
    if args.highres:
        # 400 states = 100 days: train Jan-Mar 20, hold out Mar 21-Apr 10
        train_end, val_start, val_end = "2000-03-20", "2000-03-21", "2000-04-10"
        fc_start, fc_end = "2000-03-21", "2000-03-31"
    else:
        train_end, val_start, val_end = "2000-12-31", "2001-01-01", "2001-01-15"
        fc_start, fc_end = "2001-01-01", "2001-02-20"
    levels = LEVELS_13
    for o in args.override:
        key, _, value = o.partition("=")
        if key == "features.pressure_levels":
            levels = [int(v) for v in value.strip("[]").split(",")]

    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    summary: dict = {"steps": steps, "grid": f"{nlat}x{nlon}", "device": args.device}
    py = sys.executable

    # -- 1+2: data ---------------------------------------------------------------
    if not args.skip_data:
        t = sh([py, "-m", "paradis_torch.data.synthetic", "--out", wd / "raw",
                "--nlat", nlat, "--nlon", nlon, "--times", times,
                "--levels", *levels, "--start", "2000-01-01T00:00:00"])
        summary["synthesize_s"] = round(t, 1)
        t = sh([py, "-m", "paradis_torch.cli.preprocess",
                "-i", wd / "raw", "-o", wd / "prep"])
        summary["preprocess_s"] = round(t, 1)

    common = [
        f"dataset.root_dir={wd / 'prep'}",
        "training.dataset.start_date=2000-01-01",
        f"training.dataset.end_date={train_end}",
        f"training.validation_dataset.start_date={val_start}",
        f"training.validation_dataset.end_date={val_end}",
        "training.validation_dataset.validation_batches=8",
        "training.scheduler.wsd.warmup=100",
        "training.scheduler.wsd.decay=0.1",
        "training.optimizer.name=normuon",
        "training.sync_every_n_steps=40",
        "training.log_every_n_steps=100",
        "training.validation_dataset.validation_every_n_steps=500",
        f"training.log_dir={wd / 'logs'}",
        "training.progress_bar=false",
        "training.max_epochs=1000",
    ]
    model_args = ["compute.interp_band_rad=0.3"] if args.highres else []
    if args.highres:
        common += ["compute.gradient_checkpointing=true",
                   "training.sync_every_n_steps=8",
                   "training.validation_dataset.validation_every_n_steps=150"]
    common += model_args + args.override

    # -- 3: two-segment training with restart ------------------------------------
    if not args.skip_train:
        half = steps // 2
        t = sh([py, "-m", "paradis_torch.cli.train", "--device", args.device, *common,
                f"training.max_steps={half}"])
        summary["train_seg1_s"] = round(t, 1)
        t = sh([py, "-m", "paradis_torch.cli.train", "--device", args.device, *common,
                f"training.max_steps={steps}",
                "init.restart=true",
                f"init.checkpoint_path={wd / 'logs' / 'checkpoints'}"])
        summary["train_seg2_s"] = round(t, 1)
        # throughput from the metrics CSV (long format: step,name,value)
        import csv

        with open(wd / "logs" / "metrics.csv") as f:
            sps = [float(r[2]) for r in csv.reader(f)
                   if len(r) == 3 and r[1] == "samples_per_sec"]
        if sps:
            summary["train_samples_per_sec"] = round(
                sum(sps[-10:]) / len(sps[-10:]), 2)

    # -- 4: forecast protocol ------------------------------------------------------
    ckpt = wd / "logs" / "checkpoints" / "last.json"
    ckpt_dir = json.loads(ckpt.read_text())["path"]
    t = sh([py, "-m", "paradis_torch.cli.forecast", "--device", args.device,
            "--checkpoint-path", ckpt_dir,
            "--output-file", wd / "forecast.zarr",
            "--forecast-steps", 40, "--sampling-interval", "36h",
            "--start-date", fc_start, "--end-date", fc_end,
            f"dataset.root_dir={wd / 'prep'}", *model_args, *args.override])
    summary["forecast_s"] = round(t, 1)

    # -- 5: score -------------------------------------------------------------------
    from paradis_torch.forecast.evaluate import evaluate_store

    results = evaluate_store(str(wd / "forecast.zarr"), str(wd / "prep"),
                             [("geopotential", 500), ("temperature", 850)],
                             [24, 72, 120], device=args.device)
    summary["rmse"] = results
    (wd / "rehearsal_summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
