"""Run one cell of the benchmark once and print its result line.

Usage, from the root of a checkout:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and a traffic (``traffic/<traffic>.json``) whose
``mode`` (``modes/<mode>.py``) drives ``paradis_torch`` on the card: set-up
(building the program, drawing weights and inputs from the seed, warming
every shape), then a window of ``--seconds`` untimed by nothing else.  With
``--trace 1`` a short traced window follows (``trace.py``) and the cell's
per-layer metrics are read from it by ``metrics/<metric>.py``.  Then the
program's state is freed and what the window produced is held against the
plain reference (``reference/``); the numbers compared and their limits are
printed as the last lines of standard error and, last, in the result line.

The result line is the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``checks``.  Without a CUDA card, the run exits non-zero
and prints no result.  It also does so where ``jax``, ``jaxlib``, ``flax``
or ``paradis_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "paradis_tpu")
ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def card() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def cell_metrics(workload: str, section: str) -> list:
    """The entries of ``BENCHMARK.json``'s ``section`` that this cell reports."""
    bench = json.loads(BENCHMARK.read_text())
    reported = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics._{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             workload_data: dict | None = None) -> dict:
    """One run of a cell; returns the result line (``print_result`` prints it).
    ``workload_data`` replaces the cell's files (the tests' small cells)."""
    import torch

    from port_bench import cell as cells
    from port_bench.modes.common import Context

    t_start = process_start()
    for var in ("PARADIS_INTERP_CHUNK", "PARADIS_REMAT_POLICY"):
        os.environ.pop(var, None)      # the configuration states the path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = workload_data or cells.load(workload)
    ctx = Context(wl, seed, device)
    ctx.phases["imported"] = time.time()
    mode = importlib.import_module(f"port_bench.modes.{wl['traffic']['mode']}").Mode(ctx)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mode.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    res = mode.window(seconds)
    metrics = dict(res["metrics"], setup_s=setup_s)
    breakdown = None
    extra = {}
    if trace:
        from port_bench import trace as tracing

        tr = mode.traced()
        ctx_m = {"trace": tr, "member_steps_per_s": res["member_steps_per_s"],
                 "steps_per_s": res["member_steps_per_s"] / ctx.batch,
                 "flops": mode.flops(), "precision": wl["traffic"]["precision"]}
        traced_rate = tr.steps * ctx.batch / tr.window_s
        print(json.dumps({"traced_member_steps_per_s": traced_rate,
                          "untraced_member_steps_per_s": res["member_steps_per_s"],
                          "traced_window_s": tr.window_s, "traced_steps": tr.steps}),
              flush=True)
        metrics = {}
        for m in cell_metrics(wl["name"], "per_layer"):
            value = reader(m["name"])(ctx_m)
            if value is not None:
                metrics[m["name"]] = value
        breakdown = tracing.breakdown(tr)
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    mode.release()
    gc.collect()
    checks = mode.check()
    limits = wl["cell"].get("limits", {})
    compared = {k: {"value": checks[k], "limit": limits.get(k)} for k in limits}
    correct = (res["failed"] == 0 and all(v["limit"] is not None and v["value"] <= v["limit"]
                                          for v in compared.values()) and bool(compared))
    units = {m["name"]: m["unit"] for m in cell_metrics(wl["name"], "end_to_end")
             + cell_metrics(wl["name"], "per_layer")}
    if not trace:
        metrics = {k: v for k, v in metrics.items() if k in units}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": {k: {"value": v, "unit": units.get(k, "")} for k, v in metrics.items()},
           "device": {"platform": "gpu" if cuda else ctx.device.type,
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": peak, **extra},
           "card": card() if cuda else None, "window_s": res["window_s"],
           "setup_phases_s": {k: v - t_start for k, v in ctx.phases.items()},
           "readings": {k: v for k, v in checks.items() if k not in limits}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return out


def print_result(out: dict) -> int:
    """Print the checks and the result line; or, where a forbidden module
    has been loaded by now (the window, the trace or the check), name it
    and print no result."""
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded once the window closed: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from port_bench import cell as cells

    chips = int(cells.load_json("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    return print_result(run_cell(args.workload, args.seed, args.seconds, bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
