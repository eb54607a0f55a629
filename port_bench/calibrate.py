"""Readings for the limits of ``correct``: the numbers a cell compares, on
many seeds, for the program, its control and its faults.

Usage, from the root of a checkout, on the card:

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3
        [--variant program|control|half_batch] [--out FILE]

Each seed runs the cell's set-up (the train cells' followed steps) and, in
a forecast cell, the rollouts up to the one the check keeps, at the cell's
own sizes, then the check.  ``control`` is the program's precision's next
step down: a float32 cell runs the program with TF32 on; a bfloat16 cell
puts the reference, computed in float8, in the program's place.
``half_batch`` (a train cell with more than one row) takes the program's
loss over the first half of each batch.  The benchmark's own runs never
run these.  One JSON line a seed, then one with the largest and smallest of
each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from port_bench import cell as cells
from port_bench.modes.common import Context, sync


@contextlib.contextmanager
def half_batch():
    from paradis_torch.train.loss import WeightedLoss

    call = WeightedLoss.__call__

    def half(self, pred, target):
        n = max(1, pred.shape[0] // 2)
        return call(self, pred[:n], target[:n])

    WeightedLoss.__call__ = half
    try:
        yield
    finally:
        WeightedLoss.__call__ = call


def readings(wl: dict, seed: int, variant: str, model=None) -> tuple[dict, object]:
    """One seed's compared numbers; and the program's model, for reuse."""
    import importlib

    ctx = Context(wl, seed, "cuda", model=model)
    mode = importlib.import_module(f"port_bench.modes.{wl['traffic']['mode']}").Mode(ctx)
    tf32 = variant == "control" and wl["traffic"]["precision"] == "float32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    with half_batch() if variant == "half_batch" else contextlib.nullcontext():
        mode.setup()
        if wl["traffic"]["mode"] == "forecast":
            while mode.kept is None:
                mode.run_rollout()
        sync(ctx.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ctx.model
    for name in ("state", "step_fn", "optimizer", "loss_fn", "batches", "rollout", "data"):
        if hasattr(mode, name):
            setattr(mode, name, None)
    torch.cuda.empty_cache()
    control = variant == "control" and wl["traffic"]["precision"] != "float32"
    return mode.check("control" if control else "program"), model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program", choices=("program", "control", "half_batch"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = cells.load(args.workload)
    model, rows = None, []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res, model = readings(wl, seed, args.variant, model)
        row = {"workload": args.workload, "variant": args.variant, "seed": seed,
               "seconds": time.perf_counter() - t0, **res}
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = [k for k, v in rows[0].items() if isinstance(v, float) and k != "seconds"]
    summary = {"workload": args.workload, "variant": args.variant, "seeds": len(rows),
               "max": {k: max(r[k] for r in rows) for k in names},
               "min": {k: min(r[k] for r in rows) for k in names},
               "card": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
