"""Profile the train step and print a per-op or per-source time table.

Usage (from the root of a checkout):

    python3 -m paradis_torch.tools.profile_step [--batch 1] [--nlat 128 --nlon 256]
        [--steps 4] [--top 30] [--bucket source|op] [--keep DIR] [--tiny]
        [--device cpu | --cpu] [--override key=value ...]

The port's counterpart of ``scripts/profile_step.py``: the train step of the
flagship of ``configs/default.yaml`` (``tools/flagship.py``; NorMuon, bf16
compute, reversed Huber with every channel weighted 1, ``--batch`` seeded
rows from ``default_rng(0)``; off the 5.625° grid with gradient
checkpointing, as there) runs 1 + 3 untraced steps, then ``--steps`` steps
under ``torch.profiler``, and the device time a step is bucketed:

- ``--bucket op`` (``device_profile``): the kernels by name, device activity
  alone (a trace of the host's operators costs several times the host time;
  this is the cheap mode ``chip_smoke.py`` runs);
- ``--bucket source`` (``source_profile``, the default, as there): each
  kernel by the part of the step that launched it.  For the traced steps
  the program records its spans (``paradis_torch.utils.tracing``, each a
  ``torch.profiler.record_function`` of its name: input projection, static
  encoder, downsample; in each physics layer the velocity net, the
  advection's projections, the departure points, the interpolation,
  diffusion and reaction, and the layer's own ops: the gated blend and the
  residual adds; the loss and the optimizer), and the profiler traces the
  host's operators too.  A kernel goes to the bucket of the innermost span
  of the operator that launched it (``BUCKETS``).  A kernel launched in
  autograd's backward goes to ``backward: <bucket>``, the bucket of the
  forward operator whose autograd node it runs (the node's sequence number
  is the forward operator's; the interpolation's backward has its own
  span); gradient checkpointing's replayed forward in the backward goes to
  ``replay: <bucket>``.  What no bucket holds is ``other`` (``backward:
  other`` in the backward: the step's own operators, the gradient
  accumulation).  The tool installs nothing in the program.

On the CPU (``--device cpu``, for the tests) the buckets hold the operators'
own host time.  ``--keep DIR`` exports the chrome trace there.  Prints the
JAX script's table, then one JSON line.  Without a card and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path

import torch

from paradis_torch.tools.flagship import (GRID, TINY, TINY_GRID, device_of, device_record, sync)

# the source bucket of each of the program's spans (``utils/tracing.py``)
# that is not a bucket of its own: a physics layer's own operators are its
# gated blend and residual adds, the advection's its pads and pole rows
BUCKETS = {"layer": "blend", "advection": "advection_proj", "grad_norm": "optimizer",
           "clip": "optimizer", "adamw": "optimizer", "normuon": "optimizer",
           "train_step": "other", "forward": "other", "zero_grad": "other", "backward": "other"}
BACKWARD = "autograd::engine::evaluate_function: "


def device_profile(run, n_steps: int, wall_per_step_s: float, top: int = 6) -> dict:
    """Device time per step, by kernel, from ``run()`` traced (it takes
    ``n_steps`` steps).

    The busy share divides it by the untraced wall time per step (the
    tracer slows the host, not the device's work).  Annotated ranges on the
    device timeline (the optimizers' ``record_function`` spans) are not
    kernels and are left out.  ``None`` where the profiler saw no device
    activity.  The device activity alone is traced: a trace with the host's
    operators too gives the same kernels and device time at several times
    the host-side cost (its events outnumber the kernels many times over).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        return {"device_ms_per_step": None, "busy_share": None}
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    per_step_ms = dev_us / 1e3 / n_steps
    return {
        "device_ms_per_step": per_step_ms,
        "device_launches_per_step": sum(e.count for e in kernels) / n_steps,
        "busy_share": per_step_ms / (wall_per_step_s * 1e3),
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / n_steps
                                    for e in ranked},
    }


def _bucket(event, seq_labels: dict, spans: set) -> str:
    """The source bucket of a host operator: its innermost span, or in the
    backward its autograd node's forward bucket."""
    e = event
    while e is not None:
        if e.name in spans:
            if e.name == "interpolation_bwd":
                return "backward: interpolation"
            label = BUCKETS.get(e.name, e.name)
            return label if not _in_backward(e) else f"replay: {label}"
        if e.name.startswith(BACKWARD):
            if "AccumulateGrad" in e.name:
                return "backward: other"
            return f"backward: {seq_labels.get(e.sequence_nr, 'other')}"
        e = e.cpu_parent
    return "other"


def _in_backward(event) -> bool:
    e = event.cpu_parent
    while e is not None:
        if e.name.startswith(BACKWARD):
            return True
        e = e.cpu_parent
    return False


def source_profile(run, n_steps: int, device, keep: str | None = None) -> dict:
    """Device time per step of ``run()`` (``n_steps`` steps) by source
    bucket, by kernel and by both (``pairs``) from one trace of the host's
    operators and the device (on the CPU: the operators' own host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paradis_torch.utils.tracing import recording

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof, recording(annotate=True) as recorded:
        run()
        sync(device)
    spans = {s.name for s in recorded}
    if keep:
        Path(keep).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(keep) / "trace.json"))
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    seq_labels = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD) and not _in_backward(e):
            label = _bucket(e, {}, spans)
            if label != "other":
                seq_labels.setdefault(e.sequence_nr, label)
    def timed():  # (operator, kernel or operator name, microseconds)
        for e in cpu:
            if cuda:  # the profiler hangs each kernel on the operator that launched it
                # (a span's annotation on the device has the span's name)
                yield from ((e, k.name, k.duration) for k in e.kernels if k.name != e.name)
            elif (not e.is_user_annotation and not e.name.startswith(BACKWARD)
                  and e.name.startswith(("aten::", "paradis::"))):
                yield e, e.name, e.self_cpu_time_total

    by_source: dict = collections.defaultdict(float)
    by_op: dict = collections.defaultdict(float)
    pairs: dict = collections.defaultdict(float)
    for e, name, us in timed():
        ms, source = us / 1e3 / n_steps, _bucket(e, seq_labels, spans)
        by_source[source] += ms
        by_op[name] += ms
        pairs[source, name] += ms
    total = sum(by_source.values())
    return {"ms_per_step": total, "by_source": dict(by_source), "by_op": dict(by_op),
            "pairs": dict(pairs), "unattributed_ms_per_step": by_source.get("other", 0.0)
            + by_source.get("backward: other", 0.0)}


def build_step(batch_size: int, grid, device, tiny: bool = False, overrides=()):
    """The JAX script's train step: ``bench_highres.train_setup`` of the
    flagship (gradient checkpointing off the 5.625° grid), ``batch_size``
    rows."""
    from paradis_torch.config import load_config
    from paradis_torch.tools.bench_highres import train_setup

    ckpt = [] if tiny or tuple(grid) == GRID else ["compute.gradient_checkpointing=true"]
    cfg = load_config(overrides=["training.optimizer.name=normuon", *ckpt,
                                 *(TINY if tiny else []), *overrides])
    return train_setup(cfg, TINY_GRID if tiny else grid, device, batch_size)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--nlat", type=int, default=GRID[0])
    ap.add_argument("--nlon", type=int, default=GRID[1])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--bucket", choices=["source", "op"], default="source")
    ap.add_argument("--keep", default=None, help="export the chrome trace into this dir")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model/grid (CPU smoke test of the tooling)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (as --device cpu)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)
    device = device_of("cpu" if args.cpu else args.device, "profile_step")
    run = build_step(args.batch, (args.nlat, args.nlon), device, args.tiny, args.override)
    grid = list(run["batch"]["input"].shape[1:3])
    step = run["step"]
    step()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    sync(device)
    wall_s = (time.perf_counter() - t0) / 3

    def traced():
        for _ in range(args.steps):
            step()

    if args.bucket == "op" and device.type == "cuda":
        prof = device_profile(traced, args.steps, wall_s, top=args.top)
        total, rows = prof["device_ms_per_step"], prof["top_kernels_ms_per_step"]
    else:  # on the CPU the op table comes from the operators' host time
        prof = source_profile(traced, args.steps, device, args.keep)
        total, rows = prof["ms_per_step"], prof["by_" + args.bucket]
    print(f"{'device' if device.type == 'cuda' else 'host'} time: {total:.2f} ms/step "
          f"(batch {args.batch}, {grid[0]}x{grid[1]}); trace: {args.keep}")
    for name, ms in sorted(rows.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {ms:8.3f} ms  {name}")
    prof.pop("pairs", None)
    res = dict(prof, bucket=args.bucket, grid=grid, batch=args.batch, steps=args.steps,
               wall_ms_per_step_untraced=wall_s * 1e3,
               dtype=str(run["model"].dtype).removeprefix("torch."),
               gradient_checkpointing=run["model"].gradient_checkpointing,
               **device_record(device))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
