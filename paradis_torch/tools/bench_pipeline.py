"""Host data-pipeline throughput: samples/s from a preprocessed store.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.bench_pipeline [--store DIR] [--samples 32]
        [--batch-size 1] [--nlat 32 --nlon 64] [--device cpu] [--override key=value ...]

The port's counterpart of ``scripts/bench_pipeline.py``: the full host path
(the native library's batched chunk decode, normalization, the forcings,
collation) through ``BatchLoader``'s two threads, as the training loop is
fed.  Without ``--store`` a synthetic WB2-shaped store (``--nlat`` ×
``--nlon``, the configuration's 13 levels, 60 six-hourly times) is built and
preprocessed in a temporary directory first, and the samples of
2000-01-01..2000-01-12 are read; with ``--store`` the dates of
``training.dataset`` (``--override`` sets them).  The timed pass starts
after one sample has warmed the caches and ends when ``--samples`` samples
(or one epoch) have come out.

- ``host pipeline``: the JAX protocol, the loader's host path alone
  (``device="cpu"``: the place stage wraps the arrays, as ``device_put=False``
  there);
- ``with place``: the same with the place stage to the card (pinned host
  buffers, ``non_blocking`` copies on the loader's stream; the batch waited
  for on the card), on the card only.

Prints the JAX script's line, the second line, then one JSON line.  Without
a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

from paradis_torch.tools.flagship import device_of, device_record, sync


def _rate(ds, batch_size: int, n: int, device) -> dict:
    from paradis_torch.data.pipeline import BatchLoader

    loader = BatchLoader(ds, batch_size, shuffle=True, device=device)
    t0 = time.perf_counter()
    seen = 0
    for batch in loader:
        seen += batch["input"].shape[0]
        if seen >= n:
            break
    sync(device)
    dt = time.perf_counter() - t0
    return {"samples": seen, "seconds": dt, "samples_per_sec": seen / dt,
            "ms_per_sample": dt / seen * 1e3}


def build_store(root: Path, nlat: int, nlon: int, levels) -> Path:
    """The JAX script's synthetic store: 60 six-hourly times, preprocessed
    with ``toa_time_stride=20``; returns the preprocessed root."""
    from paradis_torch.data.preprocess import preprocess
    from paradis_torch.data.synthetic import build_raw_store

    build_raw_store(str(root / "raw"), nlat=nlat, nlon=nlon, n_times=60, levels=tuple(levels))
    preprocess(str(root / "raw"), str(root / "store"), toa_time_stride=20)
    return root / "store"


def main(argv=None) -> dict:
    from paradis_torch.config import load_config
    from paradis_torch.data.dataset import ERA5Dataset

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--store", default=None)
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--nlat", type=int, default=32, help="synthetic store grid (128x256 = 1.40625°)")
    p.add_argument("--nlon", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--override", action="append", default=[],
                   help="config override key=value (repeatable)")
    args = p.parse_args(argv)
    device = device_of(args.device, "bench_pipeline")
    cfg = load_config(overrides=args.override)

    with tempfile.TemporaryDirectory(prefix="paradis_bench_") as tmp:
        build_s = None
        if args.store is None:
            print(f"building {args.nlat}x{args.nlon} synthetic store (one-time)...", flush=True)
            t0 = time.perf_counter()
            store = build_store(Path(tmp), args.nlat, args.nlon,
                                [int(v) for v in cfg.features.pressure_levels])
            build_s = time.perf_counter() - t0
            start, end = "2000-01-01", "2000-01-12"
        else:
            store = Path(args.store)
            start = cfg.training.dataset.start_date
            end = cfg.training.dataset.end_date
        ds = ERA5Dataset(str(store), start, end, forecast_steps=1, cfg=cfg)
        n = min(args.samples, len(ds))
        _ = ds[0]  # warm caches
        host = _rate(ds, args.batch_size, n, "cpu")
        placed = _rate(ds, args.batch_size, n, device) if device.type == "cuda" else None
        grid = [len(ds.lat), len(ds.lon)]
    print(f"host pipeline: {host['samples_per_sec']:.2f} samples/s "
          f"({host['ms_per_sample']:.1f} ms/sample, {host['samples']} samples)")
    if placed is not None:
        print(f"with place to {device}: {placed['samples_per_sec']:.2f} samples/s "
              f"({placed['ms_per_sample']:.1f} ms/sample, {placed['samples']} samples)")
    res = {"host": host, "with_place": placed, "grid": grid, "batch_size": args.batch_size,
           "store": args.store, "build_s": build_s, **device_record(device)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
