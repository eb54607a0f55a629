"""Host-timeline attribution of the live training loop.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.profile_live --store DIR [--steps 200] [--batch 4]
        [--sync 40] [--preload] [--device cpu] [--override key=value ...]

The port's counterpart of ``scripts/profile_live.py``: the loop's real parts
(``ERA5Dataset`` with ``preload``, ``BatchLoader``'s two threads, the train
step of the flagship of ``configs/default.yaml`` on the store's grid,
bf16 compute, NorMuon, reversed Huber with every channel weighted 1) for
``--steps`` steps, the samples of 2000-01-01..2000-12-31 in the store, each
host phase timed:

- assemble: a sample's assembly (the assemble thread, overlapped);
- place: a batch to the device (the place thread: pinned buffers and
  ``non_blocking`` copies enqueued, overlapped);
- queue wait: the main loop blocked on the batch queue;
- dispatch: the host issuing the step's operators (the device runs behind
  it; the optimizer's constant learning rate, as the script's step);
- metric fetch: ``float(loss)`` at the sync cadence (it waits for the
  device);
- other: the rest of the main loop's wall time.

The first step is untimed (it waits for the first batch and loads the
kernels).  Prints one JSON line with the JAX script's keys.  Without a card
and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from paradis_torch.tools.flagship import device_of, device_record, for_dataset, plain_loss, sync


class _TimedDataset:
    """Forwarding proxy that records per-sample assembly seconds."""

    def __init__(self, ds, sink: list):
        self._ds = ds
        self._sink = sink

    def __getitem__(self, i):
        t0 = time.perf_counter()
        out = self._ds[i]
        self._sink.append(time.perf_counter() - t0)
        return out

    def __len__(self):
        return len(self._ds)

    def __getattr__(self, name):
        return getattr(self._ds, name)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sync", type=int, default=40)
    ap.add_argument("--preload", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)
    device = device_of(args.device, "profile_live")

    from paradis_torch.config import load_config
    from paradis_torch.data.dataset import ERA5Dataset
    from paradis_torch.data.pipeline import BatchLoader
    from paradis_torch.train import build_optimizer, create_train_state, make_train_step

    cfg = load_config(overrides=args.override)
    cfg.dataset.root_dir = args.store
    cfg.training.dataset.preload = bool(args.preload)
    ds = ERA5Dataset(args.store, "2000-01-01", "2000-12-31", forecast_steps=1, cfg=cfg,
                     preload=bool(args.preload))
    model = for_dataset(cfg, ds, device)
    optimizer = build_optimizer(cfg, model)
    loss_fn = plain_loss(ds.num_out_features, device)
    train_step = make_train_step(model, loss_fn, cfg, optimizer)
    state = create_train_state(model, optimizer)

    assemble_times: list = []
    place_times: list = []
    loader = BatchLoader(_TimedDataset(ds, assemble_times), args.batch, shuffle=True,
                         prefetch=2, device=device)
    orig_place = loader._place

    def timed_place(batch):
        t0 = time.perf_counter()
        out = orig_place(batch)
        place_times.append(time.perf_counter() - t0)
        return out

    loader._place = timed_place

    wait = dispatch = fetch = 0.0
    n = 0
    m = None
    t_loop0 = None
    it = iter(loader)
    while n < args.steps:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            continue
        t1 = time.perf_counter()
        m = train_step(state, batch, ds.num_common_features)
        t2 = time.perf_counter()
        if n == 0:
            float(m["loss"])  # kernels loaded, first batch in; start the clock after
            t_loop0 = time.perf_counter()
            n += 1
            continue
        wait += t1 - t0
        dispatch += t2 - t1
        if n % args.sync == 0:
            t3 = time.perf_counter()
            float(m["loss"])
            fetch += time.perf_counter() - t3
        n += 1
    t4 = time.perf_counter()
    float(m["loss"])
    sync(device)
    fetch += time.perf_counter() - t4
    wall = time.perf_counter() - t_loop0
    steps = n - 1

    a = np.asarray(assemble_times[args.batch:])  # drop warmup batch
    p = np.asarray(place_times[1:])
    res = {
        "steps": steps, "batch": args.batch,
        "samples_per_sec": steps * args.batch / wall,
        "wall_ms_per_step": wall / steps * 1e3,
        "main_loop_ms_per_step": {
            "queue_wait": wait / steps * 1e3,
            "dispatch": dispatch / steps * 1e3,
            "metric_fetch": fetch / steps * 1e3,
            "other": (wall - wait - dispatch - fetch) / steps * 1e3,
        },
        "overlapped_threads_ms": {
            "assemble_per_sample": float(a.mean()) * 1e3 if len(a) else None,
            "assemble_per_step": float(a.mean()) * args.batch * 1e3 if len(a) else None,
            "device_put_per_step": float(p.mean()) * 1e3 if len(p) else None,
        },
        "grid": [len(ds.lat), len(ds.lon)], "samples_in_store": len(ds),
        "loss": float(m["loss"]), **device_record(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
