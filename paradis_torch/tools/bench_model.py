"""Model-level forward and forward + backward times per advection backend.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.bench_model [--impls xla,pallas] [--what fwd,bwd]
        [--device cpu] [--grid 32,64] [--repeats 3] [--override key=value ...]

The port's counterpart of ``scripts/bench_model.py``: where the train step
spends its time, split into the model forward and forward + backward, each
with the advection interpolation forced to one ``compute.advection_impl``
(``pallas``: the port's kernels, ``xla``: the dense path of
``ops/interp_dense.py``; every value the port takes is accepted).  The
flagship of ``configs/default.yaml`` (with ``--override``s) at full width and
depth on the 5.625° grid, as ``__graft_entry__._flagship(tiny=False)``
builds it, seeded from ``init.seed``, computing in bfloat16 (float32
parameters) as ``bench_model.py:46-48``; batch 1, the input drawn from
``default_rng(0)``.

- ``fwd``: the forward, reduced to a float32 sum (no autograd);
- ``bwd``: ``torch.autograd.grad`` of that sum with respect to the
  parameters, the gradients reduced the same way.

Each call adds its predecessor's result times 1e-30 to the input, so a chain
of calls runs in order, and a chain ends in ``torch.cuda.synchronize()``
(the host clock then covers the device work).  A call's time is the chain
slope ``(t(N_LONG) - t(N_SHORT)) / (N_LONG - N_SHORT)``, the least of
``--repeats``, as there; the impls take turns within each repeat, their
order reversed every other repeat (the host's speed drifts over a run).
The first call's seconds stand where JAX reports its compile seconds, with
whether the kernels were built before it (``kernels_built``).  The launches
of the interpolation kernels #1 (``interp_fwd``) and #2 (``interp_bwd``) in
one call are counted.  Prints one line per row, then one JSON line with the
JAX keys ``{impl}_{what}`` in ms and the details.  It runs on the card
unless given ``--device cpu`` (the plain versions, host clock, for the CPU
test); without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from paradis_torch.config import load_config
from paradis_torch.tools.bench_interp import launch_counts
from paradis_torch.tools.flagship import device_of, device_record

GRID = (32, 64)   # 5.625°
N_SHORT, N_LONG = 4, 20
KERNELS = ("interp_fwd", "interp_bwd")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _calls(model, x: torch.Tensor):
    """``{"fwd": f, "bwd": g}``: each maps the carry to the next carry."""
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd(carry):
        with torch.no_grad():
            out = model(x + carry * 1e-30)
            return out.float().sum() * 1e-30

    def bwd(carry):
        loss = model(x + carry * 1e-30).float().sum()
        grads = torch.autograd.grad(loss, params)
        return torch.stack([g.float().sum() for g in grads]).sum().detach() * 1e-30

    return {"fwd": fwd, "bwd": bwd}


def _chain(fn, n: int, device) -> float:
    carry = torch.zeros((), device=device)
    t0 = time.perf_counter()
    for _ in range(n):
        carry = fn(carry)
    _sync(device)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    from paradis_torch import _build
    from paradis_torch.model.paradis import CONFIG_IMPLS
    from paradis_torch.tools.flagship import dims, flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impls", default="xla,pallas")
    ap.add_argument("--what", default="fwd,bwd")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--grid", default=f"{GRID[0]},{GRID[1]}")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--override", action="append", default=[],
                    help="a config override key=value (repeatable)")
    args = ap.parse_args(argv)
    impls, whats = args.impls.split(","), args.what.split(",")
    bad = [i for i in impls if i not in CONFIG_IMPLS] + [w for w in whats
                                                         if w not in ("fwd", "bwd")]
    if bad:
        raise ValueError(f"{bad}: --impls takes {CONFIG_IMPLS}, --what fwd and bwd")
    device = device_of(args.device, "bench_model")
    grid = tuple(int(v) for v in args.grid.split(","))
    cfg = load_config(overrides=args.override)
    d = dims(cfg)
    x = torch.tensor(np.random.default_rng(0).normal(size=(1, *grid, d["input_dim"])),
                     dtype=torch.float32, device=device)
    kernels_built = (all(_build._lib_path(n).is_file() for n in _build.sources())
                     if device.type == "cuda" else None)

    calls, rows = {}, {}
    for impl in impls:
        cfg.compute.advection_impl = impl
        model, _ = flagship(cfg, grid, device, dtype=torch.bfloat16)
        fns = _calls(model, x)
        for what in whats:
            key = f"{impl}_{what}"
            calls[key] = fns[what]
            before = launch_counts()
            t0 = time.perf_counter()
            _chain(fns[what], 1, device)
            first_s = time.perf_counter() - t0
            after = launch_counts()
            rows[key] = {"first_call_s": first_s,
                         "launches_per_call": {k: after[k] - before[k] for k in KERNELS},
                         "slopes_ms": []}
    for r in range(args.repeats):
        order = list(calls) if r % 2 == 0 else list(reversed(calls))
        for key in order:
            slope = (_chain(calls[key], N_LONG, device) - _chain(calls[key], N_SHORT, device)
                     ) / (N_LONG - N_SHORT)
            rows[key]["slopes_ms"].append(slope * 1e3)
    results = {key: min(row["slopes_ms"]) for key, row in rows.items()}
    for key, ms in results.items():
        print(f"{key:12s} {ms:9.3f} ms  (first call {rows[key]['first_call_s']:.1f} s, "
              f"launches {rows[key]['launches_per_call']})", flush=True)
    out = dict(results)
    out.update(rows=rows, kernels_built=kernels_built, grid=list(grid), dtype="bfloat16",
               batch=1, repeats=args.repeats, n_short=N_SHORT, n_long=N_LONG,
               **device_record(device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
